"""Plain PyTorch oracles for the settle-sweep kernels K1-K4.

Counterpart of the matching functions of :mod:`repro.kernels.ref`, with
the reference's layouts: ELL slots row-major ``(B, nz, K)`` and dense
operators untransposed ``(B, n, n)``.  Float32 throughout.
"""

from __future__ import annotations

import torch


def ell_spmv_ref(idx: torch.Tensor, w: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Batched ELL matvec ``(M z)[b, i] = sum_k w[b,i,k] z[b, idx[b,i,k]]``.

    Runs in the operand dtype (pass float64 for an exact-parity oracle).
    """
    gathered = z.unsqueeze(1).expand(-1, idx.shape[1], -1).gather(2, idx.long())
    return (w * gathered).sum(dim=2)


def ell_sweep_ref(idx, w, z, c, *, n_steps: int, dt: float = 1.0):
    """n_steps batched ELL Euler steps + final residual (f32 throughout)."""
    z32 = z.to(torch.float32)
    w32 = w.to(torch.float32)
    c32 = c.to(torch.float32)
    for _ in range(n_steps):
        z32 = z32 + dt * (ell_spmv_ref(idx, w32, z32) + c32)
    dz = ell_spmv_ref(idx, w32, z32) + c32
    return z32.to(z.dtype), dz.abs().amax(dim=1)


def transient_step_batched_ref(m, z, c, dt: float):
    """Per-system step + fused residual: m (B,n,n), z/c (B,n)."""
    dz = torch.einsum("bij,bj->bi", m.to(torch.float32), z.to(torch.float32)) \
        + c.to(torch.float32)
    out = (z.to(torch.float32) + dt * dz).to(z.dtype)
    return out, dz.abs().amax(dim=1)


def transient_sweep_ref(m, z, c, *, n_steps: int, dt: float = 1.0):
    """n_steps batched Euler steps + final residual (f32 throughout)."""
    z32 = z.to(torch.float32)
    m32 = m.to(torch.float32)
    c32 = c.to(torch.float32)
    for _ in range(n_steps):
        z32 = z32 + dt * (torch.einsum("bij,bj->bi", m32, z32) + c32)
    dz = torch.einsum("bij,bj->bi", m32, z32) + c32
    return z32.to(z.dtype), dz.abs().amax(dim=1)
