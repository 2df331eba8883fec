"""Digital solver baselines (Sec. I-A), in PyTorch float64.

Counterpart of :mod:`repro.core.baselines`:

* :func:`cholesky_solve` / :func:`cholesky_solve_batch` — direct
  factorization.
* :func:`cg_solve` / :func:`cg_solve_batch` — Conjugate Gradient.
* :func:`jacobi_solve` / :func:`jacobi_solve_batch` — stationary Jacobi
  iteration.

The single-system solvers take the reference's arguments and return its
fields, iteration counts included.  The batched iterative solvers
*freeze* each system at its own convergence step, so its iterates and
its recorded ``iterations`` equal a loop of single-system solves while
the batch steps on until every system is done.  The loops run on the
host and check convergence once per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class IterativeResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor
    residual_norm: torch.Tensor


def cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` (n, n) SPD, ``b`` (n,) -> ``x`` (n,)."""
    return cholesky_solve_batch(a[None], b[None])[0]


def cg_solve(a: torch.Tensor, b: torch.Tensor, *, tol: float = 1e-10, max_iter: int = 1000,
             x0: torch.Tensor | None = None) -> IterativeResult:
    """Conjugate Gradient with the reference's stopping rule: iterate while
    ``|r|^2 / |b|^2 > tol^2`` and fewer than ``max_iter`` steps."""
    res = cg_solve_batch(a[None], b[None], tol=tol, max_iter=max_iter,
                         x0=None if x0 is None else x0[None])
    return IterativeResult(*(t[0] for t in res))


def jacobi_solve(a: torch.Tensor, b: torch.Tensor, *, tol: float = 1e-10,
                 max_iter: int = 10000) -> IterativeResult:
    """Jacobi iteration from ``x0 = b / diag(a)`` (counted as iteration 1),
    while ``|b - a x| / |b| > tol`` and fewer than ``max_iter`` steps."""
    res = jacobi_solve_batch(a[None], b[None], tol=tol, max_iter=max_iter)
    return IterativeResult(*(t[0] for t in res))


def cholesky_solve_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` (B, n, n) SPD, ``b`` (B, n) -> ``x`` (B, n).

    A system whose factorization fails (not positive definite, or NaN)
    gets an all-NaN row and the others their solutions, as the
    reference's ``jnp.linalg.cholesky`` gives; nothing raises, and the
    device is not synchronized for the check.
    """
    l, info = torch.linalg.cholesky_ex(a)
    y = torch.linalg.solve_triangular(l, b.unsqueeze(-1), upper=False)
    x = torch.linalg.solve_triangular(l.transpose(-1, -2), y, upper=True)[..., 0]
    return torch.where((info == 0)[:, None], x, torch.nan)


def _bdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-system inner product (B, n) x (B, n) -> (B,)."""
    return torch.einsum("bi,bi->b", u, v)


def _bmv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-system matvec (B, n, n) x (B, n) -> (B, n)."""
    return torch.einsum("bij,bj->bi", a, v)


def cg_solve_batch(a: torch.Tensor, b: torch.Tensor, *, tol: float = 1e-10,
                   max_iter: int = 1000, x0: torch.Tensor | None = None) -> IterativeResult:
    """Batched CG with per-system convergence freezing, from ``x0`` (B, n)
    or zero."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - _bmv(a, x)
    p = r
    rs = _bdot(r, r)
    b_norm2 = torch.clamp(_bdot(b, b), min=1e-300)
    it = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)

    def active_mask(rs, it):
        return (rs / b_norm2 > tol * tol) & (it < max_iter)

    act = active_mask(rs, it)
    while bool(act.any()):
        ap = _bmv(a, p)
        pap = _bdot(p, ap)
        alpha = torch.where(act, rs / torch.where(pap == 0.0, 1.0, pap), 0.0)
        x = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * ap
        rs_new = _bdot(r_new, r_new)
        beta = rs_new / torch.where(rs == 0.0, 1.0, rs)
        p = torch.where(act[:, None], r_new + beta[:, None] * p, p)
        r = torch.where(act[:, None], r_new, r)
        rs = torch.where(act, rs_new, rs)
        it = it + act.to(torch.int32)
        act = active_mask(rs, it)
    return IterativeResult(x=x, iterations=it, residual_norm=torch.sqrt(rs))


def jacobi_solve_batch(a: torch.Tensor, b: torch.Tensor, *, tol: float = 1e-10,
                       max_iter: int = 10000) -> IterativeResult:
    """Batched Jacobi iteration with per-system convergence freezing."""
    d = torch.diagonal(a, dim1=1, dim2=2)
    r_op = a - torch.diag_embed(d)
    b_norm = torch.clamp(torch.linalg.norm(b, dim=1), min=1e-300)

    def active_mask(res, it):
        return (res / b_norm > tol) & (it < max_iter)

    x = b / d
    res = torch.linalg.norm(b - _bmv(a, x), dim=1)
    it = torch.ones(b.shape[0], dtype=torch.int32, device=b.device)
    act = active_mask(res, it)
    while bool(act.any()):
        x_new = (b - _bmv(r_op, x)) / d
        res_new = torch.linalg.norm(b - _bmv(a, x_new), dim=1)
        x = torch.where(act[:, None], x_new, x)
        res = torch.where(act, res_new, res)
        it = it + act.to(torch.int32)
        act = active_mask(res, it)
    return IterativeResult(x=x, iterations=it, residual_norm=res)
