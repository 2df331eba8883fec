"""Public solve API — the paper's technique as a composable module.

Counterpart of :mod:`repro.core.solver`.  ``solve_batch(A, b)`` takes
``A`` (B, n, n) and ``b`` (B, n) and dispatches:

* ``analog_2n`` — the proposed 2n design (Sec. IV): netlist build,
  batched assembly and float64 DC solve on the device, with
  ``compute_settling`` the settle analysis (exact eig, the forward-Euler
  sweep through the Hopper kernels K1-K4, the spectral estimate, or the
  nonlinear RK4 transient), and with ``refine`` graded recovery
  (mixed-precision refinement around the analog solve);
* ``analog_n`` — the preliminary n design (Sec. III);
* ``cholesky`` / ``cg`` / ``jacobi`` — batched digital baselines.

``solve`` is the B = 1 wrapper.  Every entry point runs on ``device``
(default ``"cuda"``; it raises without CUDA unless given
``device="cpu"``).  CUDA's asynchronous launches take the place of JAX
async dispatch: :func:`solve_batch_submit` returns once the DC solve is
enqueued, and :meth:`PendingBatchSolve.wait` is where the host copy
happens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import baselines, engine, refine as refine_mod
from repro_torch.core.network import Netlist, build_preliminary_batch, build_proposed_batch
from repro_torch.core.operating_point import (
    IDEAL,
    NonIdealities,
    operating_point_batch,
    operating_point_batch_submit,
)
from repro_torch.core.refine import RefineSpec  # noqa: F401  (re-export for callers)
from repro_torch.core.specs import OPAMPS, CircuitParams, DEFAULT_PARAMS, OpAmpSpec
from repro_torch.device import resolve_device, stage, to_device


@dataclasses.dataclass
class SolveResult:
    x: np.ndarray
    method: str
    stable: bool = True
    settle_time: float | None = None
    info: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BatchSolveResult:
    """Batched :class:`SolveResult`: every field is a (B, ...) array.

    ``info`` maps metric name -> (B,) array (or a scalar shared by the
    batch).  ``__getitem__`` recovers a per-system :class:`SolveResult`.
    """

    x: np.ndarray                     # (B, n)
    method: str
    stable: np.ndarray                # (B,) bool
    settle_time: np.ndarray | None    # (B,) or None
    info: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return self.x.shape[0]

    @staticmethod
    def _info_entry(v, b: int):
        """Per-system view of one ``info`` entry (numpy scalars become
        python scalars)."""
        if isinstance(v, np.ndarray) and v.ndim >= 1:
            v = v[b]
        if isinstance(v, np.ndarray) and v.ndim == 0:
            v = v[()]
        if isinstance(v, np.generic):
            v = v.item()
        return v

    def __getitem__(self, b: int) -> SolveResult:
        info = {k: self._info_entry(v, b) for k, v in self.info.items()}
        return SolveResult(
            x=self.x[b],
            method=self.method,
            stable=bool(self.stable[b]),
            settle_time=(
                None if self.settle_time is None else float(self.settle_time[b])
            ),
            info=info,
        )


ANALOG_METHODS = ("analog_2n", "analog_n")
DIGITAL_METHODS = ("cholesky", "cg", "jacobi")

# digital re-solve policies for degraded analog results ("none" disables)
FALLBACK_METHODS = ("cholesky", "cg", "none")
# relative-residual ceiling above which an *uncertified* analog result
# counts as degraded (non-finite results always do)
FALLBACK_RESIDUAL_TOL = 1e-6


def fallback_mask(x: np.ndarray, a: np.ndarray, b: np.ndarray, certified=None, *,
                  residual_tol: float = FALLBACK_RESIDUAL_TOL) -> np.ndarray:
    """Which systems of an analog batch need the digital fallback.

    A system is degraded when its solution carries NaN/Inf, or when its
    settling analysis did not certify *and* its relative residual
    ``||A x - b|| / ||b||`` exceeds ``residual_tol`` (the certificate
    comes from the spectral estimator; without it only non-finite rows
    fall back).
    """
    x = np.asarray(x, dtype=np.float64)
    bad = ~np.isfinite(x).all(axis=1)
    if certified is not None:
        cert = np.asarray(certified, dtype=bool).reshape(-1)
        check = (~cert) & (~bad)
        if check.any():
            r = np.einsum("bij,bj->bi", a[check], x[check]) - b[check]
            rel = np.linalg.norm(r, axis=1) / np.maximum(
                np.linalg.norm(b[check], axis=1), np.finfo(np.float64).tiny)
            bad[np.flatnonzero(check)[rel > residual_tol]] = True
    return bad


def _digital_resolve(a: np.ndarray, b: np.ndarray, *, method: str, tol: float,
                     max_iter: int, device: torch.device) -> np.ndarray:
    """Digital re-solve of a (sub)batch — the fallback workhorse."""
    at = torch.as_tensor(a, device=device)
    bt = torch.as_tensor(b, device=device)
    if method == "cholesky":
        return baselines.cholesky_solve_batch(at, bt).cpu().numpy()
    return baselines.cg_solve_batch(at, bt, tol=tol, max_iter=max_iter).x.cpu().numpy()


def _apply_digital_fallback(result: BatchSolveResult, a: np.ndarray, b: np.ndarray, *,
                            method: str, tol: float, max_iter: int,
                            residual_tol: float, device: torch.device
                            ) -> BatchSolveResult:
    """Re-solve degraded analog systems with a digital baseline, in place.

    The circuit metrics keep describing the analog attempt; only ``x``
    rows are replaced, and ``info["fallback"]`` records the per-system
    re-solve method ("" = the analog solution was delivered as is).
    """
    bad = fallback_mask(result.x, a, b, result.info.get("settle_certified"),
                        residual_tol=residual_tol)
    if not bad.any():
        return result
    x = np.array(result.x, dtype=np.float64, copy=True)
    x[bad] = _digital_resolve(a[bad], b[bad], method=method, tol=tol,
                              max_iter=max_iter, device=device)
    result.x = x
    result.info["fallback"] = np.where(bad, method, "")
    return result


# per-system delivery paths of the graded-recovery pipeline (recorded in
# info["precision_path"] when refine= is enabled):
#   "analog"    — the raw analog solve already met the refinement tol
#   "refined"   — iterative refinement converged to the tol
#   "fallback"  — refinement stalled / exhausted; digital re-solve delivered
#   "unrefined" — refinement failed and fallback="none": degraded result
PRECISION_PATHS = ("analog", "refined", "fallback", "unrefined")


def _apply_graded_recovery(result: BatchSolveResult, a: np.ndarray, b: np.ndarray, *,
                           refspec: refine_mod.RefineSpec, method: str, spec: OpAmpSpec,
                           ni: NonIdealities, params: CircuitParams, d_policy: str,
                           beta: float, alpha: float, pattern, mesh, device: torch.device,
                           fallback: str, tol: float, max_iter: int) -> BatchSolveResult:
    """Residual-verified graded recovery: verify -> refine -> fall back.

    Every analog solution is verified against its fp64 relative
    residual; rows above ``refspec.tol`` enter iterative refinement whose
    inner pass re-stamps and re-solves the *analog* circuit (the same
    error-model draws) for the residual, rescaled to the right-hand
    side's full scale, and only rows whose refinement stalls or runs out
    of budget escalate to the digital ``fallback``.  Records
    ``info["residual"]``, ``info["refine_iters"]`` and
    ``info["precision_path"]`` (see :data:`PRECISION_PATHS`).
    """
    b_count = a.shape[0]
    tiny = np.finfo(np.float64).tiny
    a_t = torch.as_tensor(a, device=device)
    rel = refine_mod.relative_residuals(a_t, b, result.x)
    refine_iters = np.zeros(b_count, dtype=np.int64)
    path = np.full(b_count, "analog", dtype="<U9")
    need = rel > refspec.tol
    if need.any():
        sel = np.flatnonzero(need)
        bscale = np.maximum(np.max(np.abs(b), axis=1), tiny)

        def inner_solve(idx: np.ndarray, rhs: np.ndarray) -> np.ndarray:
            # analog inner pass: re-stamp the circuit for (A, r * s) with
            # the same error model and DC-solve it; the residual is
            # rescaled to the RHS's full scale so the hardware's absolute
            # error floor stays relative to the update
            rows = sel[np.asarray(idx)]
            s = bscale[rows] / np.maximum(np.max(np.abs(rhs), axis=1), tiny)
            nets_r = _build_nets(a[rows], rhs * s[:, None], method, d_policy=d_policy,
                                 beta=beta, alpha=alpha, params=params, device=device)
            pat = (pattern if pattern is not None and engine.pattern_covers(pattern, nets_r)
                   else None)
            op = operating_point_batch(nets_r, spec, nonideal=ni, pattern=pat,
                                       mesh=mesh, device=device)
            return np.asarray(op.x, dtype=np.float64) / s[:, None]

        driver = refine_mod.refine_driver(refspec)
        rr = driver(a_t[sel], b[sel], result.x[sel], inner_solve, spec=refspec)
        x = np.array(result.x, dtype=np.float64, copy=True)
        x[sel] = rr.x
        rel[sel] = rr.residual
        refine_iters[sel] = rr.iters
        path[sel] = np.where(rr.converged, "refined", "unrefined")

        bad = sel[~rr.converged]
        if bad.size and fallback != "none":
            x[bad] = _digital_resolve(a[bad], b[bad], method=fallback, tol=tol,
                                      max_iter=max_iter, device=device)
            rel[bad] = refine_mod.relative_residuals(a_t[bad], b[bad], x[bad])
            path[bad] = "fallback"
        result.x = x
    result.info["residual"] = rel
    result.info["refine_iters"] = refine_iters
    result.info["precision_path"] = path
    # the binary-era field: per-system digital re-solve method, "" = none
    result.info["fallback"] = np.where(path == "fallback", fallback, "")
    return result


def _build_nets(a, b, method, *, d_policy, beta, alpha, params, device) -> list[Netlist]:
    if method == "analog_2n":
        return build_proposed_batch(a, b, d_policy=d_policy, beta=beta, alpha=alpha,
                                    params=params, device=device)
    if method == "analog_n":
        return build_preliminary_batch(a, b, params=params)
    raise ValueError(f"unknown analog method {method!r}")


@dataclasses.dataclass
class PendingBatchSolve:
    """Handle to an in-flight batched solve on one device.

    :func:`solve_batch_submit` did the host work (netlist build, error
    model) and enqueued assembly and the DC solve on the device.
    :meth:`wait` returns exactly what ``solve_batch`` returns, because
    ``solve_batch`` *is* submit + wait; it is idempotent.

    The analog handle is two-phase: :meth:`wait_dc` copies back only the
    DC operating point (the device phase), and :meth:`wait` then runs
    the finish phase — the settle analysis and the digital fallback.
    ``split`` tells a scheduler whether the finish phase can be deferred
    (digital handles are single-phase).
    """

    method: str
    _finalize: Callable[[], BatchSolveResult]
    _done: BatchSolveResult | None = None
    _finish: Callable[[BatchSolveResult], BatchSolveResult] | None = None
    _dc: BatchSolveResult | None = None

    @property
    def split(self) -> bool:
        return self._finish is not None

    def wait_dc(self) -> BatchSolveResult:
        """Block on the device phase only (DC solve harvest); idempotent."""
        if self._done is not None:
            return self._done
        if self._finish is None:
            return self.wait()
        if self._dc is None:
            self._dc = self._finalize()
        return self._dc

    def wait(self) -> BatchSolveResult:
        if self._done is None:
            if self._finish is not None:
                self._done = self._finish(self.wait_dc())
            else:
                self._done = self._finalize()
        return self._done


def _solve_batch_digital_submit(a, b, method, *, tol, max_iter, mesh=None,
                                device: torch.device) -> PendingBatchSolve:
    """Batched digital baselines; ``stable`` is all-True and the
    iterative methods report per-system ``iterations``/``residual_norm``.
    ``mesh`` splits the batch axis over a 1-d solver mesh: each part runs
    on its device and :meth:`PendingBatchSolve.wait` gathers them in order
    (the iterative methods freeze each system on its own, so a part's
    iterates do not depend on the split)."""
    if mesh is not None:
        from repro_torch.distributed.sharding import shard_system_batch

        a_parts, b_parts = shard_system_batch(a, b, mesh=mesh)
    else:
        a_parts = [to_device(a, device)]
        b_parts = [to_device(b, device)]
    n_systems = a.shape[0]

    def gather(parts) -> np.ndarray:
        return np.concatenate([p.cpu().numpy() for p in parts])

    if method == "cholesky":
        xs = [baselines.cholesky_solve_batch(at, bt) for at, bt in zip(a_parts, b_parts)]

        def finalize() -> BatchSolveResult:
            return BatchSolveResult(x=gather(xs), method=method,
                                    stable=np.ones(n_systems, dtype=bool),
                                    settle_time=None, info={})
    else:
        fn = baselines.cg_solve_batch if method == "cg" else baselines.jacobi_solve_batch

        def finalize() -> BatchSolveResult:
            # the iterations run here, at the harvest: each one's stopping
            # test copies a flag to the host, which at submit would make
            # the dispatch phase wait for the card
            res = [fn(at, bt, tol=tol, max_iter=max_iter) for at, bt in zip(a_parts, b_parts)]
            return BatchSolveResult(
                x=gather(r.x for r in res), method=method,
                stable=np.ones(n_systems, dtype=bool), settle_time=None,
                info={
                    "iterations": gather(r.iterations for r in res).astype(np.int64),
                    "residual_norm": gather(r.residual_norm for r in res).astype(np.float64),
                },
            )

    return PendingBatchSolve(method=method, _finalize=finalize)


def solve_batch_submit(
    a,
    b,
    *,
    method: str = "analog_2n",
    opamp: str | OpAmpSpec = "AD712",
    nonideal: NonIdealities | None = None,
    params: CircuitParams = DEFAULT_PARAMS,
    d_policy: str = "proposed",
    beta: float = 0.5,
    alpha: float = 1.0,
    compute_settling: bool = False,
    settle_method: str = "auto",
    settle_max_steps: int = 200_000,
    settle_dt_policy: str = "diag",
    settle_matrix_free: bool = False,
    x_ref: np.ndarray | None = None,
    tol: float = 1e-10,
    max_iter: int = 10000,
    fallback: str = "cholesky",
    fallback_residual_tol: float = FALLBACK_RESIDUAL_TOL,
    refine=None,
    sweep_dtype: str = "float32",
    settle_x0: np.ndarray | None = None,
    pattern: engine.StampPattern | None = None,
    mesh=None,
    device=None,
    nets: list[Netlist] | None = None,
    timings: dict | None = None,
) -> PendingBatchSolve:
    """Host phase + asynchronous device phase of :func:`solve_batch`.

    Validates, builds the netlists and applies the error model on the
    host, assembles on the device and enqueues the DC solve, then
    returns a :class:`PendingBatchSolve` without waiting.  Arguments as
    :func:`solve_batch`; ``solve_batch`` is ``solve_batch_submit(...).wait()``.

    The analog handle is two-phase: ``wait_dc()`` harvests the DC
    operating point and ``wait()`` adds the finish phase (settling,
    graded recovery, digital fallback), so a pipelined caller (the solve
    service) can release its stream at the DC harvest.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.ndim != 3 or b.ndim != 2 or a.shape[:2] != (b.shape[0], b.shape[1]):
        raise ValueError(f"expected (B, n, n) and (B, n); got {a.shape}, {b.shape}")
    if mesh is not None and device is not None:
        raise ValueError("pass either mesh= or device=, not both")
    # with a mesh, everything but the split DC solve runs on its first device
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    if method in DIGITAL_METHODS:
        return _solve_batch_digital_submit(a, b, method, tol=tol, max_iter=max_iter,
                                           mesh=mesh, device=dev)
    if method not in ANALOG_METHODS:
        raise ValueError(
            f"unknown method {method!r}: expected one of "
            f"{ANALOG_METHODS + DIGITAL_METHODS}")
    if fallback is None:
        fallback = "none"
    if fallback not in FALLBACK_METHODS:
        raise ValueError(
            f"unknown fallback {fallback!r}: expected one of {FALLBACK_METHODS}")
    refspec = refine_mod.as_refine_spec(refine)

    spec = OPAMPS[opamp] if isinstance(opamp, str) else opamp
    ni = IDEAL if nonideal is None else nonideal

    if nets is None:
        with stage(timings, "netlist_build", dev):
            nets = _build_nets(a, b, method, d_policy=d_policy, beta=beta,
                               alpha=alpha, params=params, device=dev)
    elif len(nets) != a.shape[0]:
        raise ValueError(f"got {len(nets)} nets for a batch of {a.shape[0]}")
    if pattern is None:
        pattern = engine.pattern_union(nets, spec)
    if compute_settling and settle_matrix_free and x_ref is None:
        raise ValueError("settle_matrix_free requires x_ref")
    # non-idealities perturb conductance values, never the cell pattern
    pending_op = operating_point_batch_submit(
        nets, spec, nonideal=ni, x_ref=x_ref, pattern=pattern, mesh=mesh, device=dev,
        timings=timings,
    )

    def finalize_dc() -> BatchSolveResult:
        op = pending_op.wait()
        info: dict[str, Any] = {
            "design": np.asarray([net.design for net in nets]),
            "n_nodes": nets[0].n_nodes,
            "n_amps": np.asarray([net.n_amps for net in nets]),
            "n_branches": np.asarray([net.n_branches for net in nets]),
            "is_passive": np.asarray([net.is_passive for net in nets]),
            "max_conductance": np.asarray([net.max_conductance() for net in nets]),
            "max_rel_error": op.max_rel_error,
            "max_abs_error": op.max_abs_error,
            "err_fullscale": op.err_fullscale,
        }
        return BatchSolveResult(x=op.x, method=method, stable=~op.amp_saturated,
                                settle_time=None, info=info)

    def finish(result: BatchSolveResult) -> BatchSolveResult:
        if compute_settling:
            # x_ref reaches the transient engine only on explicit opt-in (or
            # for the estimator-only spectral path, where it merely fills
            # x_converged): the default euler/auto path settles against the
            # DC fixed point
            settle_ref = (x_ref if (settle_matrix_free or settle_method == "spectral")
                          else None)
            tr = engine.transient_batch(
                nets, spec, method=settle_method, pattern=pattern,
                max_steps=settle_max_steps, x_ref=settle_ref,
                dt_policy=settle_dt_policy, x0=settle_x0, sweep_dtype=sweep_dtype,
                device=dev, timings=timings,
            )
            result.settle_time = tr.settle_time
            result.stable = result.stable & tr.stable
            result.info["max_re_eig"] = tr.max_re_eig
            result.info["dominant_tau"] = tr.dominant_tau
            result.info["mirror_residual"] = tr.mirror_residual
            result.info["settle_method"] = tr.method
            if tr.settle_steps is not None:
                result.info["settle_steps"] = np.asarray(tr.settle_steps, dtype=np.int64)
            if tr.certified is not None:
                # spectral estimator: converged rightmost mode + contracting
                # slow subspace (repro_torch.core.spectral.SpectralBounds)
                result.info["settle_certified"] = tr.certified
        if refspec is not None:
            # graded recovery: fp64 verify -> analog iterative refinement ->
            # digital fallback only for rows whose refinement stalls
            with stage(timings, "refine", dev):
                return _apply_graded_recovery(
                    result, a, b, refspec=refspec, method=method, spec=spec, ni=ni,
                    params=params, d_policy=d_policy, beta=beta, alpha=alpha,
                    pattern=pattern, mesh=mesh, device=dev, fallback=fallback, tol=tol,
                    max_iter=max_iter)
        if fallback != "none":
            result = _apply_digital_fallback(
                result, a, b, method=fallback, tol=tol, max_iter=max_iter,
                residual_tol=fallback_residual_tol, device=dev,
            )
        return result

    return PendingBatchSolve(method=method, _finalize=finalize_dc, _finish=finish)


def solve_batch(
    a,
    b,
    *,
    method: str = "analog_2n",
    opamp: str | OpAmpSpec = "AD712",
    nonideal: NonIdealities | None = None,
    params: CircuitParams = DEFAULT_PARAMS,
    d_policy: str = "proposed",
    beta: float = 0.5,
    alpha: float = 1.0,
    compute_settling: bool = False,
    settle_method: str = "auto",
    settle_max_steps: int = 200_000,
    settle_dt_policy: str = "diag",
    settle_matrix_free: bool = False,
    x_ref: np.ndarray | None = None,
    tol: float = 1e-10,
    max_iter: int = 10000,
    fallback: str = "cholesky",
    fallback_residual_tol: float = FALLBACK_RESIDUAL_TOL,
    refine=None,
    sweep_dtype: str = "float32",
    settle_x0: np.ndarray | None = None,
    pattern: engine.StampPattern | None = None,
    mesh=None,
    device=None,
    nets: list[Netlist] | None = None,
    timings: dict | None = None,
) -> BatchSolveResult:
    """Solve a batch of SPD systems ``A[k] x[k] = b[k]`` on ``device``.

    ``a`` is (B, n, n), ``b`` (B, n); all systems share one circuit
    design, so assembly, DC solve and settling run as batched device
    calls.  ``settle_method`` selects the transient path ("eig" — exact
    modal; "euler" — the forward-Euler sweep through the Hopper kernels;
    "spectral" — the settling *estimate*, no integration, with
    ``info["settle_certified"]``; "nonlinear" — the slew-clipped,
    rail-clamped RK4 transient; "auto" — by state count).
    ``settle_dt_policy`` picks the euler step rule ("diag" | "spectral" —
    the abscissa-aware rule, whose predicted settle steps also size the
    sweep's chunks).  ``settle_matrix_free=True`` opts the euler path
    into the ELL engine, settling against ``x_ref`` (required) instead of
    the circuit's DC fixed point; its ``mirror_residual`` is NaN.

    ``fallback`` re-solves systems whose analog solution is non-finite —
    or uncertified with a relative residual above
    ``fallback_residual_tol`` — with a digital baseline (``"cholesky"``
    default, ``"cg"``, or ``"none"``), recorded in ``info["fallback"]``.
    ``refine`` (``True``, ``"ir"``, ``"fcg"`` or a :class:`RefineSpec`)
    turns that into graded recovery: rows above the refinement tol run
    mixed-precision refinement with the analog circuit as the inner
    solve, and only stalled rows fall back; ``info`` then carries
    ``residual``, ``refine_iters`` and ``precision_path`` (one of
    :data:`PRECISION_PATHS`).  ``sweep_dtype`` ("float32" | "bfloat16")
    selects the sweep's weight precision; ``settle_x0`` ((B, n))
    warm-starts the sweep.  ``timings`` (a dict) collects per-stage wall
    seconds — ``netlist_build``, ``assembly``, ``dc_solve``,
    ``spectral``, ``sweep``, ``poll``, ``rk4``, ``refine`` —
    synchronizing the device at each stage boundary.

    ``mesh`` (a 1-d solver mesh,
    :func:`repro_torch.distributed.sharding.solver_mesh`) splits the DC
    solve's and the digital baselines' batch axis over its devices; the
    rest runs on the mesh's first device.  It excludes ``device``.
    """
    return solve_batch_submit(
        a, b, method=method, opamp=opamp, nonideal=nonideal, params=params,
        d_policy=d_policy, beta=beta, alpha=alpha,
        compute_settling=compute_settling, settle_method=settle_method,
        settle_max_steps=settle_max_steps, settle_dt_policy=settle_dt_policy,
        settle_matrix_free=settle_matrix_free, x_ref=x_ref, tol=tol,
        max_iter=max_iter, fallback=fallback,
        fallback_residual_tol=fallback_residual_tol, refine=refine,
        sweep_dtype=sweep_dtype, settle_x0=settle_x0, pattern=pattern,
        mesh=mesh, device=device, nets=nets, timings=timings,
    ).wait()


def solve(
    a,
    b,
    *,
    method: str = "analog_2n",
    opamp: str | OpAmpSpec = "AD712",
    nonideal: NonIdealities | None = None,
    params: CircuitParams = DEFAULT_PARAMS,
    d_policy: str = "proposed",
    beta: float = 0.5,
    alpha: float = 1.0,
    compute_settling: bool = False,
    settle_method: str = "auto",
    settle_max_steps: int = 200_000,
    settle_dt_policy: str = "diag",
    settle_matrix_free: bool = False,
    x_ref: np.ndarray | None = None,
    tol: float = 1e-10,
    max_iter: int = 10000,
    fallback: str = "cholesky",
    fallback_residual_tol: float = FALLBACK_RESIDUAL_TOL,
    refine=None,
    sweep_dtype: str = "float32",
    device=None,
) -> SolveResult:
    """Solve the SPD system ``A x = b``: :func:`solve_batch` with a batch of one.

    The digital baselines report ``iterations``/``residual_norm`` as
    python scalars, as the reference's single-system solvers do.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    batch = solve_batch(
        a[None, :, :], b[None, :], method=method, opamp=opamp, nonideal=nonideal,
        params=params, d_policy=d_policy, beta=beta, alpha=alpha,
        compute_settling=compute_settling, settle_method=settle_method,
        settle_max_steps=settle_max_steps, settle_dt_policy=settle_dt_policy,
        settle_matrix_free=settle_matrix_free,
        x_ref=None if x_ref is None else np.asarray(x_ref)[None, :],
        tol=tol, max_iter=max_iter, fallback=fallback,
        fallback_residual_tol=fallback_residual_tol, refine=refine,
        sweep_dtype=sweep_dtype, device=device,
    )
    return batch[0]
