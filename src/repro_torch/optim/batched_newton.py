"""Batched Newton / SQP on the analog solve engine.

Newton-type methods are the repeated-solve-with-fixed-sparsity workload
the paper's O(1) claim targets: every iteration linearizes the problem
into an SPD system whose *sparsity class is iteration-invariant* — only
the values change.  This driver runs B independent minimizations in
lockstep and pushes each iteration's B linearized systems through ONE
:func:`repro_torch.core.solver.solve_batch` call on a shared
:class:`~repro_torch.core.engine.StampPattern` derived once per size class
(the pattern cache was built for exactly this reuse).

Two problem classes:

* :func:`newton_batch` — unconstrained smooth minimization.  Per
  iteration: one batched solve of ``(H_k + damp I) dx_k = -g_k``.
* :func:`newton_kkt_batch` — linear equality constraints ``C x = d``
  (SQP with a fixed working set).  The KKT matrix is symmetric
  *indefinite*, so it cannot map onto the RNM directly; following
  Khoja et al. (PAPERS.md, 2604.19100) the driver solves its **SPD
  circuit analogs** instead: the Schur complement
  ``S = C H^-1 C^T`` is SPD whenever ``H`` is SPD and ``C`` has full
  row rank, so each iteration is two batched RNM rounds — a size-n
  multi-RHS round for ``H^-1 [g, C^T]`` (all ``B * (m+1)`` unit
  systems in one ``solve_batch``) and a size-m round for
  ``S lambda = C x - d - C H^-1 g``.

Every system is normalized into the paper's operating ranges before it
reaches the circuit (conductances ~500 uS peak, currents sized for
~0.25 V solutions — Eq. 27, solutions are scale-invariant), exactly as
the reference's ``analog_newton.refresh_preconditioner`` does for its
block inverses.

``rounds=`` swaps the direct ``solve_batch`` executor for any object
with ``solve_round(a, b) -> x`` — in particular a
:class:`repro_torch.serving.solve_service.SolveSession`, which carries
each round through the service's bucketed pipelines with the service's
deadline/retry semantics applying per round.  :func:`newton_looped` /
:func:`newton_kkt_looped` are the one-system-at-a-time references
(identical host arithmetic, per-system
:func:`repro_torch.core.solver.solve` calls) used by the parity tests;
the batched iterates match them because a batched solve row does not
depend on its batch neighbors.

A port of the reference's ``optim/batched_newton.py``: the host
arithmetic is the reference's numpy, and the direct and looped
executors solve on ``device`` (default ``"cuda"``; it raises without a
card unless given ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

# paper operating ranges (Sec. V): peak mapped conductance and the
# current scale that lands solution voltages near 0.25 V
_G_PEAK = 500e-6
_I_SCALE = 0.25 * 500e-6


@dataclasses.dataclass(frozen=True)
class BatchedNewtonConfig:
    method: str = "analog_2n"    # solve_batch method (analog or digital)
    opamp: str = "AD712"
    nonideal: Any = None         # repro_torch.core.operating_point.NonIdealities
    damping: float = 1e-9        # Levenberg floor, relative to mean(diag H)
    max_iter: int = 50
    tol: float = 1e-8            # stop: ||grad||_2 <= tol (unconstrained)
                                 #       max(|dx|_inf, |Cx-d|_inf) <= tol (KKT)


@dataclasses.dataclass
class NewtonTrace:
    """Result of a batched (or looped) Newton run."""

    x: np.ndarray                # (B, n) final iterates
    iterations: np.ndarray       # (B,) Newton steps taken per system
    converged: np.ndarray        # (B,) bool
    grad_norm: np.ndarray        # (B,) final ||g||_2 (unconstrained)
    solve_rounds: int            # solve_batch (or service) rounds issued
    pattern_derivations: int     # stamp patterns derived (0 for digital)


def _scale_systems(a: np.ndarray, b: np.ndarray):
    """Normalize ``A x = b`` into circuit ranges, per system.

    Returns ``(a_s, b_s, back)`` with ``x = solve(a_s, b_s) * back``:
    conductances scaled to ~500 uS peak, currents to the ~0.25 V
    solution scale (zero-RHS systems pass through with unit current
    scale — their solution is exactly 0).
    """
    s = _G_PEAK / np.maximum(np.abs(a).max(axis=(1, 2)), 1e-300)
    bmax = np.abs(b).max(axis=1)
    c = np.where(bmax > 0.0, _I_SCALE / np.where(bmax > 0.0, bmax, 1.0), 1.0)
    return a * s[:, None, None], b * c[:, None], s / c


class _DirectRounds:
    """Default round executor: one ``solve_batch`` call per round, with
    the stamp pattern derived once per (n, method) class and the
    pre-built netlists handed through (the serving passthroughs)."""

    def __init__(self, cfg: BatchedNewtonConfig, device=None):
        from repro_torch.device import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        self._patterns: dict = {}
        self.solve_rounds = 0
        self.pattern_derivations = 0

    def solve_round(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        from repro_torch.core import engine
        from repro_torch.core.network import (
            build_preliminary_batch,
            build_proposed_batch,
        )
        from repro_torch.core.solver import solve_batch
        from repro_torch.core.specs import OPAMPS

        kwargs: dict = {}
        if self.cfg.method in ("analog_2n", "analog_n"):
            nets = (
                build_proposed_batch(a, b, device=self.device)
                if self.cfg.method == "analog_2n"
                else build_preliminary_batch(a, b)
            )
            key = (a.shape[1], self.cfg.method)
            pattern = self._patterns.get(key)
            if pattern is None:
                spec = (
                    OPAMPS[self.cfg.opamp]
                    if isinstance(self.cfg.opamp, str) else self.cfg.opamp
                )
                pattern = engine.pattern_union(nets, spec)
                self._patterns[key] = pattern
                self.pattern_derivations += 1
            kwargs = dict(nets=nets, pattern=pattern)
        res = solve_batch(
            a, b,
            method=self.cfg.method,
            opamp=self.cfg.opamp,
            nonideal=self.cfg.nonideal,
            device=self.device,
            **kwargs,
        )
        self.solve_rounds += 1
        return np.asarray(res.x, dtype=np.float64)


class _LoopedRounds:
    """Reference executor: per-system ``solve()`` calls (the
    one-at-a-time physics path — tests only)."""

    def __init__(self, cfg: BatchedNewtonConfig, device=None):
        from repro_torch.device import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        self.solve_rounds = 0
        self.pattern_derivations = 0

    def solve_round(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        from repro_torch.core.solver import solve

        x = np.zeros_like(b)
        for k in range(a.shape[0]):
            x[k] = np.asarray(
                solve(
                    a[k], b[k],
                    method=self.cfg.method,
                    opamp=self.cfg.opamp,
                    nonideal=self.cfg.nonideal,
                    device=self.device,
                ).x,
                dtype=np.float64,
            )
        self.solve_rounds += 1
        return x


def _damped(h: np.ndarray, damping: float) -> np.ndarray:
    n = h.shape[-1]
    damp = damping * np.maximum(
        np.einsum("bii->b", h) / n, 1e-12
    )
    return h + damp[:, None, None] * np.eye(n)


def _newton_loop(
    grad_hess: Callable,
    x0: np.ndarray,
    cfg: BatchedNewtonConfig,
    rounds,
) -> NewtonTrace:
    x = np.array(x0, dtype=np.float64, copy=True)
    bsz, n = x.shape
    iters = np.zeros(bsz, dtype=np.int64)
    converged = np.zeros(bsz, dtype=bool)
    gnorm = np.full(bsz, np.inf)

    for _ in range(cfg.max_iter):
        g, h = grad_hess(x)
        g = np.asarray(g, dtype=np.float64)
        h = np.asarray(h, dtype=np.float64)
        gnorm = np.linalg.norm(g, axis=1)
        converged |= gnorm <= cfg.tol
        active = ~converged
        if not active.any():
            break
        a_s, b_s, back = _scale_systems(_damped(h, cfg.damping), -g)
        dx = rounds.solve_round(a_s, b_s) * back[:, None]
        x[active] += dx[active]
        iters[active] += 1

    g, _ = grad_hess(x)
    gnorm = np.linalg.norm(np.asarray(g, dtype=np.float64), axis=1)
    converged |= gnorm <= cfg.tol
    return NewtonTrace(
        x=x,
        iterations=iters,
        converged=converged,
        grad_norm=gnorm,
        solve_rounds=rounds.solve_rounds,
        pattern_derivations=rounds.pattern_derivations,
    )


def newton_batch(
    grad_hess: Callable,
    x0,
    cfg: BatchedNewtonConfig = BatchedNewtonConfig(),
    *,
    rounds=None,
    device=None,
) -> NewtonTrace:
    """Run B unconstrained Newton minimizations in lockstep.

    ``grad_hess(x)`` maps (B, n) iterates to ``(g, h)`` with ``g``
    (B, n) and ``h`` (B, n, n) SPD.  Each iteration issues exactly one
    fixed-shape batched solve round of the damped Newton systems (a
    stable shape keeps one stamp pattern across rounds);
    converged systems freeze — their solved rows are discarded — so
    per-system iterates and iteration counts match
    :func:`newton_looped` exactly.  ``rounds`` swaps the executor (see
    module docstring); otherwise each round is one ``solve_batch`` on
    ``device``.
    """
    x0 = np.asarray(x0, dtype=np.float64)
    return _newton_loop(grad_hess, x0, cfg, rounds or _DirectRounds(cfg, device))


def newton_looped(
    grad_hess: Callable,
    x0,
    cfg: BatchedNewtonConfig = BatchedNewtonConfig(),
    *,
    device=None,
) -> NewtonTrace:
    """One-system-at-a-time reference for :func:`newton_batch` (same
    host arithmetic, per-system ``solve()`` calls on ``device``)."""
    x0 = np.asarray(x0, dtype=np.float64)
    return _newton_loop(grad_hess, x0, cfg, _LoopedRounds(cfg, device))


# ---------------------------------------------------------------------------
# equality-constrained (SQP / KKT) path
# ---------------------------------------------------------------------------

def _kkt_loop(
    grad_hess: Callable,
    c_mat: np.ndarray,
    d: np.ndarray,
    x0: np.ndarray,
    cfg: BatchedNewtonConfig,
    rounds,
) -> NewtonTrace:
    x = np.array(x0, dtype=np.float64, copy=True)
    bsz, n = x.shape
    m = c_mat.shape[1]
    iters = np.zeros(bsz, dtype=np.int64)
    converged = np.zeros(bsz, dtype=bool)
    gnorm = np.full(bsz, np.inf)

    for _ in range(cfg.max_iter):
        active = ~converged
        if not active.any():
            break
        g, h = grad_hess(x)
        g = np.asarray(g, dtype=np.float64)
        h = np.asarray(h, dtype=np.float64)
        r = np.einsum("bmn,bn->bm", c_mat, x) - d
        hd = _damped(h, cfg.damping)

        # round 1 — H^-1 [g, C^T]: all B*(m+1) unit systems in one batch
        rhs = np.concatenate([g[:, None, :], c_mat], axis=1)     # (B, m+1, n)
        flat_a = np.repeat(hd, m + 1, axis=0)                    # (B*(m+1), n, n)
        flat_b = rhs.reshape(bsz * (m + 1), n)
        a_s, b_s, back = _scale_systems(flat_a, flat_b)
        sol = (rounds.solve_round(a_s, b_s) * back[:, None]).reshape(
            bsz, m + 1, n
        )
        u = sol[:, 0]                                            # H^-1 g
        v = sol[:, 1:]                                           # rows: H^-1 c_j

        # round 2 — the SPD Schur complement S lam = r - C u
        schur = np.einsum("bin,bjn->bij", c_mat, v)              # C H^-1 C^T
        rhs2 = r - np.einsum("bmn,bn->bm", c_mat, u)
        a_s, b_s, back = _scale_systems(
            _damped(schur, cfg.damping), rhs2
        )
        lam = rounds.solve_round(a_s, b_s) * back[:, None]

        dx = -u - np.einsum("bjn,bj->bn", v, lam)
        x[active] += dx[active]
        iters[active] += 1
        gnorm = np.linalg.norm(g + np.einsum("bmn,bm->bn", c_mat, lam), axis=1)
        step = np.maximum(
            np.abs(dx).max(axis=1),
            np.abs(np.einsum("bmn,bn->bm", c_mat, x) - d).max(axis=1),
        )
        converged |= step <= cfg.tol

    return NewtonTrace(
        x=x,
        iterations=iters,
        converged=converged,
        grad_norm=gnorm,
        solve_rounds=rounds.solve_rounds,
        pattern_derivations=rounds.pattern_derivations,
    )


def newton_kkt_batch(
    grad_hess: Callable,
    constraints: tuple,
    x0,
    cfg: BatchedNewtonConfig = BatchedNewtonConfig(),
    *,
    rounds=None,
    device=None,
) -> NewtonTrace:
    """B equality-constrained minimizations ``min f_k(x) s.t. C_k x = d_k``.

    ``constraints = (c_mat, d)`` with ``c_mat`` (B, m, n) full row rank
    and ``d`` (B, m).  Each iteration's KKT step is computed through
    two SPD circuit rounds (Schur-complement reduction, see module
    docstring) — the KKT matrix itself never needs to be stamped.
    """
    c_mat = np.asarray(constraints[0], dtype=np.float64)
    d = np.asarray(constraints[1], dtype=np.float64)
    x0 = np.asarray(x0, dtype=np.float64)
    return _kkt_loop(grad_hess, c_mat, d, x0, cfg, rounds or _DirectRounds(cfg, device))


def newton_kkt_looped(
    grad_hess: Callable,
    constraints: tuple,
    x0,
    cfg: BatchedNewtonConfig = BatchedNewtonConfig(),
    *,
    device=None,
) -> NewtonTrace:
    """One-system-at-a-time reference for :func:`newton_kkt_batch`."""
    c_mat = np.asarray(constraints[0], dtype=np.float64)
    d = np.asarray(constraints[1], dtype=np.float64)
    x0 = np.asarray(x0, dtype=np.float64)
    return _kkt_loop(grad_hess, c_mat, d, x0, cfg, _LoopedRounds(cfg, device))
