"""Matrix-free ELL-format transient sweep kernels K1 and K2.

Counterpart of :mod:`repro.kernels.ell_transient`.  The circuit operator
is stored per row as a fixed-width list of ``(column, weight)`` slots,

    dz[i] = sum_k  w[i, k] * z[idx[i, k]]          (+ c[i])

with unused slots ``(idx=0, w=0)`` exact no-ops.  The Hopper kernels
(``csrc/ell_transient.cu``) take the slots **slot-major**, ``(B, K, nz)``
— the coalesced layout for a thread per row; :func:`repro_torch.kernels.
ops.ell_transient_sweep` transposes the reference's row-major
``(B, nz, K)`` arrays once, outside the settle loop.

* :func:`ell_sweep` (K1) — ``n_steps`` fused Euler steps per system and
  the fused ``max |M z + c|`` at the final state.
* :func:`ell_step` (K2) — one row-tiled step; the max of ``|M z + c|``
  at the *input* state per 128-row block.

Each wrapper launches its kernel for tensors on a CUDA device and runs
its plain PyTorch version (``*_plain``, same contract, same rounding)
for tensors on the CPU.  ``sweep_dtype="bfloat16"`` means ``w`` is
bf16: the gathered state is rounded to bf16, the product rounded once to
bf16, and the slot sum runs in float32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

ROW_BLOCK = 128

# sweep_dtype values accepted by the sweep kernels and their wrappers
SWEEP_DTYPES = ("float32", "bfloat16")


def ell_dz_plain(idx_t: torch.Tensor, w_t: torch.Tensor, z: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """``M z + c`` from slot-major slots: idx_t/w_t (B, K, nz), z/c (B, nz)."""
    gathered = z.unsqueeze(1).expand(-1, idx_t.shape[1], -1).gather(2, idx_t.long())
    prod = (w_t * gathered.to(w_t.dtype)).to(torch.float32)
    return prod.sum(dim=1) + c


def ell_sweep_plain(idx_t, w_t, z, c, *, n_steps: int, dt: float = 1.0):
    """Plain PyTorch version of :func:`ell_sweep` (same contract)."""
    zz = z.to(torch.float32)
    for _ in range(n_steps):
        zz = zz + dt * ell_dz_plain(idx_t, w_t, zz, c)
    dz = ell_dz_plain(idx_t, w_t, zz, c)
    return zz, dz.abs().amax(dim=1, keepdim=True)


def ell_step_plain(idx_t, w_t, z, c, dt: float = 1.0):
    """Plain PyTorch version of :func:`ell_step` (same contract)."""
    dz = ell_dz_plain(idx_t, w_t, z, c)
    bsz, nz = z.shape
    res = dz.abs().reshape(bsz, nz // ROW_BLOCK, ROW_BLOCK).amax(dim=2)
    return z + dt * dz, res


def _check(idx_t, w_t, z, c) -> tuple[int, int, int]:
    bsz, k, nz = idx_t.shape
    if w_t.shape != idx_t.shape or z.shape != (bsz, nz) or c.shape != (bsz, nz):
        raise ValueError(
            f"shapes: idx {tuple(idx_t.shape)}, w {tuple(w_t.shape)}, "
            f"z {tuple(z.shape)}, c {tuple(c.shape)}")
    if nz % ROW_BLOCK:
        raise ValueError(f"nz={nz} must be a multiple of {ROW_BLOCK}")
    if idx_t.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx_t.dtype}")
    if w_t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w must be float32 or bfloat16, got {w_t.dtype}")
    if z.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"z and c must be float32, got {z.dtype}, {c.dtype}")
    dev = z.device
    for name, t in (("idx", idx_t), ("w", w_t), ("z", z), ("c", c)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, z on {dev}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return bsz, k, nz


def ell_sweep(idx_t: torch.Tensor, w_t: torch.Tensor, z: torch.Tensor,
              c: torch.Tensor, *, n_steps: int, dt: float = 1.0):
    """K1: ``n_steps`` fused ELL Euler steps per system.

    idx_t int32 and w_t float32/bfloat16 ``(B, K, nz)`` slot-major,
    z/c float32 ``(B, nz)``, ``nz % 128 == 0``.  Returns ``(z', res)``
    with ``res[b, 0] = max_i |M_b z'_b + c_b|_i`` at the final state.

    Replaces ``repro/kernels/ell_transient.py:ell_sweep_pallas``.  Bound
    by bytes (the slots stream from L2/HBM every step, one SM per
    system); the state stays in shared memory (``csrc/ell_transient.cu``).
    """
    bsz, k, nz = _check(idx_t, w_t, z, c)
    if z.device.type == "cpu":
        return ell_sweep_plain(idx_t, w_t, z, c, n_steps=n_steps, dt=dt)
    lib = build.load_library()
    out = torch.empty_like(z)
    res = torch.empty((bsz, 1), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = build.current_stream(z.device)
        lib.call("repro_ell_sweep", idx_t.data_ptr(), w_t.data_ptr(),
                 int(w_t.dtype == torch.bfloat16), z.data_ptr(), c.data_ptr(),
                 out.data_ptr(), res.data_ptr(), bsz, nz, k, int(n_steps),
                 float(dt), stream)
    ell_sweep.launches += 1
    return out, res


def ell_step(idx_t: torch.Tensor, w_t: torch.Tensor, z: torch.Tensor,
             c: torch.Tensor, dt: float = 1.0):
    """K2: one row-tiled ELL Euler step.

    Shapes as :func:`ell_sweep`.  Returns ``(z', res)`` where
    ``res[b, blk]`` is the max of ``|M_b z_b + c_b|`` over the 128 rows
    of block ``blk`` at the *input* state — reduce over axis 1 for the
    per-system check.  ``z'`` is a new buffer; ``z`` is not written.

    Replaces ``repro/kernels/ell_transient.py:ell_step_pallas``.  Bound
    by bytes on the card and, in a loop of steps, by the host call per
    launch; 128-row blocks over all SMs (``csrc/ell_transient.cu``).
    """
    bsz, k, nz = _check(idx_t, w_t, z, c)
    if z.device.type == "cpu":
        return ell_step_plain(idx_t, w_t, z, c, dt)
    lib = build.load_library()
    out = torch.empty_like(z)
    res = torch.empty((bsz, nz // ROW_BLOCK), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = build.current_stream(z.device)
        lib.call("repro_ell_step", idx_t.data_ptr(), w_t.data_ptr(),
                 int(w_t.dtype == torch.bfloat16), z.data_ptr(), c.data_ptr(),
                 out.data_ptr(), res.data_ptr(), bsz, nz, k, float(dt), stream)
    ell_step.launches += 1
    return out, res


# launch counts of the CUDA kernels (plain-version calls do not count)
ell_sweep.launches = 0
ell_step.launches = 0
