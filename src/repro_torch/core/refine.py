"""Mixed-precision iterative refinement around the analog solve.

Counterpart of :mod:`repro.core.refine` (see there for the method).  A
low-precision analog solve (quantized pots, tolerances, a bf16 sweep) is
still a good *preconditioner*: wrapped as the inner solve of fp64
iterative refinement it recovers full digital precision in
``log(tol) / log(eps)`` passes.  Two drivers loop on the host around an
abstract batched ``inner_solve(idx, rhs)``:

* :func:`refine_batch` — classic refinement ``x += inner(b - A x)``;
* :func:`fcg_batch` — flexible CG (Notay's FCG(1), Polak-Ribiere beta),
  which tolerates an inner solve that changes between passes.

Both freeze converged rows (they leave the active subset and stop
consuming inner solves), roll back a pass that moved away from the
solution, and mark a row stalled when a pass contracts less than
``stall_ratio`` or the measured contraction cannot reach ``tol`` within
the remaining budget.

The fp64 products ``A x`` run on the solve's device (``a`` as a float64
tensor there); norms, counters and flags (``iters``, ``converged``,
``stalled``) stay host numpy, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import as_float64

_TINY = 1e-300

REFINE_DRIVERS = ("ir", "fcg")


@dataclasses.dataclass(frozen=True)
class RefineSpec:
    """Refinement contract for one :func:`~repro_torch.core.solver.solve_batch`.

    ``tol`` — target relative fp64 residual ``|b - A x| / |b|`` per
    system.  ``max_iters`` — inner (analog) solve budget per system.
    ``stall_ratio`` — minimum per-pass residual contraction; a pass
    that contracts less marks the row stalled (escalate to fallback).
    ``driver`` — ``"ir"`` (iterative refinement) or ``"fcg"``
    (flexible CG).
    """

    tol: float = 1e-10
    max_iters: int = 12
    stall_ratio: float = 0.5
    driver: str = "ir"

    def __post_init__(self) -> None:
        if self.driver not in REFINE_DRIVERS:
            raise ValueError(
                f"driver must be one of {REFINE_DRIVERS}, got {self.driver!r}"
            )
        if not self.tol > 0.0:
            raise ValueError(f"tol must be > 0, got {self.tol}")
        if self.max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got {self.max_iters}")
        if not (0.0 < self.stall_ratio < 1.0):
            raise ValueError(f"stall_ratio in (0, 1), got {self.stall_ratio}")


DEFAULT_REFINE = RefineSpec()


def as_refine_spec(refine) -> RefineSpec | None:
    """Normalize the ``refine=`` knob: None/False -> off, True -> the
    default spec, a driver name -> default spec with that driver, a
    :class:`RefineSpec` -> itself."""
    if refine is None or refine is False:
        return None
    if refine is True:
        return DEFAULT_REFINE
    if isinstance(refine, str):
        return RefineSpec(driver=refine)
    if isinstance(refine, RefineSpec):
        return refine
    raise TypeError(f"refine must be None, bool, str or RefineSpec: {refine!r}")


@dataclasses.dataclass
class RefineResult:
    x: np.ndarray          # (B, n) refined solutions (fp64)
    residual: np.ndarray   # (B,) final relative fp64 residual
    iters: np.ndarray      # (B,) int inner solves consumed
    converged: np.ndarray  # (B,) bool residual <= tol
    stalled: np.ndarray    # (B,) bool stopped by stall/hopeless detection


def _residual(a_t: torch.Tensor, b64: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``b - A x`` per system, the product on ``a_t``'s device (fp64)."""
    ax = torch.einsum("bij,bj->bi", a_t, torch.as_tensor(x, device=a_t.device))
    return b64 - ax.cpu().numpy()


def relative_residuals(a, b: np.ndarray, x: np.ndarray, *, device=None) -> np.ndarray:
    """Per-system fp64 relative residual ``|b - A x|_2 / |b|_2``.

    ``a`` (a tensor stays on its device; an array goes to ``device``,
    default ``"cuda"``).  Nonfinite rows of ``x`` report ``inf``.
    """
    a_t = as_float64(a, device)
    b64 = np.asarray(b, dtype=np.float64)
    x64 = np.asarray(x, dtype=np.float64)
    b_norm = np.maximum(np.linalg.norm(b64, axis=1), _TINY)
    finite = np.all(np.isfinite(x64), axis=1)
    r = _residual(a_t, b64, np.where(finite[:, None], x64, 0.0))
    rel = np.linalg.norm(r, axis=1) / b_norm
    return np.where(finite, rel, np.inf)


def _project_hopeless(rel_new, rel_old, tol, remaining):
    """Rows whose measured contraction cannot reach ``tol`` within the
    remaining budget (the budget-predictive stopping rule)."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        rho = np.clip(rel_new / np.maximum(rel_old, _TINY), _TINY, 1.0 - 1e-12)
        need = np.ceil(np.log(np.maximum(tol, _TINY) / np.maximum(rel_new, _TINY))
                       / np.log(rho))
    return np.isfinite(need) & (need > remaining) & (rel_new > tol)


def _start(a, b, x0, device):
    """Shared set-up of both drivers: the operator on its device, the
    host copies, and the initial residuals (inf for nonfinite rows)."""
    a_t = as_float64(a, device)
    b64 = np.asarray(b, dtype=np.float64)
    x = np.array(x0, dtype=np.float64, copy=True)
    b_norm = np.maximum(np.linalg.norm(b64, axis=1), _TINY)
    finite = np.all(np.isfinite(x), axis=1)
    r = np.where(finite[:, None], _residual(a_t, b64, np.where(finite[:, None], x, 0.0)),
                 np.inf)
    rel = np.where(finite, np.linalg.norm(
        np.where(finite[:, None], r, 0.0), axis=1) / b_norm, np.inf)
    return a_t, b64, x, b_norm, finite, r, rel


def refine_batch(a, b: np.ndarray, x0: np.ndarray, inner_solve, *,
                 spec: RefineSpec = DEFAULT_REFINE, device=None) -> RefineResult:
    """Iterative refinement: ``x += inner_solve(b - A x)`` to fp64.

    ``inner_solve(idx, rhs)`` solves ``A[idx] d = rhs`` approximately
    for the active subset ``idx`` (host numpy in, numpy out); ``rhs`` is
    handed over at its natural (residual) scale.  ``a`` may be an array
    (moved to ``device``, default ``"cuda"``) or a tensor (used where it
    lies).  Per-system freezing, rollback and stall rules as in the
    reference; nonfinite ``x0`` rows stall at once with ``residual = inf``.
    """
    a_t, b64, x, b_norm, finite, r, rel = _start(a, b, x0, device)
    iters = np.zeros(x.shape[0], dtype=np.int64)
    stalled = ~finite
    active = finite & (rel > spec.tol)
    while np.any(active):
        idx = np.nonzero(active)[0]
        d = np.asarray(inner_solve(idx, r[idx]), dtype=np.float64)
        x[idx] += d
        iters[idx] += 1
        r_new = _residual(a_t[idx], b64[idx], x[idx])
        rel_new = np.linalg.norm(r_new, axis=1) / b_norm[idx]

        worse = ~np.isfinite(rel_new) | (rel_new >= rel[idx])
        if np.any(worse):
            # a pass that moved away from the solution is rolled back:
            # deliver the best iterate, not the last one
            back = idx[worse]
            x[back] -= d[worse]
            rel_new = np.where(worse, rel[idx], rel_new)
            r_new = np.where(worse[:, None], r[idx], r_new)
        no_contract = rel_new > spec.stall_ratio * rel[idx]
        hopeless = _project_hopeless(rel_new, rel[idx], spec.tol,
                                     spec.max_iters - iters[idx])
        r[idx] = r_new
        rel[idx] = rel_new

        stall_now = worse | no_contract | hopeless
        stalled[idx[stall_now & (rel_new > spec.tol)]] = True
        active[idx] = ~stall_now & (rel_new > spec.tol) & (iters[idx] < spec.max_iters)
    return RefineResult(x=x, residual=rel, iters=iters, converged=rel <= spec.tol,
                        stalled=stalled)


def fcg_batch(a, b: np.ndarray, x0: np.ndarray, inner_solve, *,
              spec: RefineSpec = DEFAULT_REFINE, device=None) -> RefineResult:
    """Flexible CG with the analog pass as a variable preconditioner.

    Notay's FCG(1): ``p_k = z_k + beta_k p_{k-1}`` with the
    Polak-Ribiere ``beta_k = z_k.(r_k - r_{k-1}) / (z_{k-1}.r_{k-1})``.
    Same ``inner_solve`` contract, device rule, freezing, stall/budget
    rules and result as :func:`refine_batch`; a row whose search
    direction loses positive curvature (``p.Ap <= 0``) stalls at its
    current iterate.
    """
    a_t, b64, x, b_norm, finite, r, rel = _start(a, b, x0, device)
    b_count, n = x.shape
    p_prev = np.zeros((b_count, n))
    r_prev = np.zeros((b_count, n))
    zr_prev = np.zeros(b_count)
    have_prev = np.zeros(b_count, dtype=bool)

    iters = np.zeros(b_count, dtype=np.int64)
    stalled = ~finite
    active = finite & (rel > spec.tol)
    while np.any(active):
        idx = np.nonzero(active)[0]
        z = np.asarray(inner_solve(idx, r[idx]), dtype=np.float64)
        beta = np.where(
            have_prev[idx],
            np.einsum("bi,bi->b", z, r[idx] - r_prev[idx])
            / np.where(zr_prev[idx] == 0.0, 1.0, zr_prev[idx]),
            0.0,
        )
        p = z + beta[:, None] * p_prev[idx]
        a_sub = a_t[idx]
        ap = torch.einsum("bij,bj->bi", a_sub, torch.as_tensor(p, device=a_t.device))
        ap = ap.cpu().numpy()
        pap = np.einsum("bi,bi->b", p, ap)
        curved = pap > 0.0
        alpha = np.where(curved, np.einsum("bi,bi->b", p, r[idx])
                         / np.where(curved, pap, 1.0), 0.0)

        x_new = x[idx] + alpha[:, None] * p
        r_new = _residual(a_sub, b64[idx], x_new)
        rel_new = np.linalg.norm(r_new, axis=1) / b_norm[idx]
        iters[idx] += 1

        worse = ~curved | ~np.isfinite(rel_new) | (rel_new >= rel[idx])
        keep = ~worse
        x[idx[keep]] = x_new[keep]
        rel_new = np.where(worse, rel[idx], rel_new)
        r_new = np.where(worse[:, None], r[idx], r_new)
        no_contract = rel_new > spec.stall_ratio * rel[idx]
        hopeless = _project_hopeless(rel_new, rel[idx], spec.tol,
                                     spec.max_iters - iters[idx])

        r_prev[idx] = r[idx]
        zr_prev[idx] = np.einsum("bi,bi->b", z, r[idx])
        p_prev[idx] = p
        have_prev[idx] = True
        r[idx] = r_new
        rel[idx] = rel_new

        stall_now = worse | no_contract | hopeless
        stalled[idx[stall_now & (rel_new > spec.tol)]] = True
        active[idx] = ~stall_now & (rel_new > spec.tol) & (iters[idx] < spec.max_iters)
    return RefineResult(x=x, residual=rel, iters=iters, converged=rel <= spec.tol,
                        stalled=stalled)


def refine_driver(spec: RefineSpec):
    """The driver function selected by ``spec.driver``."""
    return {"ir": refine_batch, "fcg": fcg_batch}[spec.driver]
