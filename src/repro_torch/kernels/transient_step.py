"""Dense forward-Euler kernels K3, K4 and K5.

Counterpart of :mod:`repro.kernels.transient_step` (the Hopper sources
are ``csrc/transient_step.cu``):

* :func:`transient_sweep` (K3) — ``n_steps`` fused steps
  ``z <- z + dt (M z + c)`` per system on the *pre-transposed* operator
  ``m_t[b] = M_b^T``, and the fused ``max |M z + c|`` at the final state.
* :func:`transient_step_batched` (K4) — one row-tiled step on the
  untransposed operator, and the max of ``|M z + c|`` at the *input*
  state per 128-row block.
* :func:`transient_step` (K5) — one step ``Z' = Z + dt (M Z + C)`` of a
  single operator ``M`` (n, n) on ``nb`` state columns, float32 or
  bfloat16 operands with a float32 accumulator: K6's tiled product with
  the step as its epilogue.

Each wrapper launches its kernel for tensors on a CUDA device and runs
its plain PyTorch version (``*_plain``) for tensors on the CPU.  K3 and
K4 run in float32 with a float32 accumulator.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

ROW_BLOCK = 128


def transient_sweep_plain(m_t, z, c, *, n_steps: int, dt: float = 1.0):
    """Plain PyTorch version of :func:`transient_sweep` (same contract)."""
    zz = z.to(torch.float32)
    for _ in range(n_steps):
        zz = zz + dt * (torch.einsum("bj,bji->bi", zz, m_t) + c)
    dz = torch.einsum("bj,bji->bi", zz, m_t) + c
    return zz, dz.abs().amax(dim=1, keepdim=True)


def transient_step_batched_plain(m, z, c, dt: float = 1.0):
    """Plain PyTorch version of :func:`transient_step_batched`."""
    dz = torch.einsum("bij,bj->bi", m, z) + c
    bsz, n = z.shape
    res = dz.abs().reshape(bsz, n // ROW_BLOCK, ROW_BLOCK).amax(dim=2)
    return z + dt * dz, res


def _check(m, z, c) -> tuple[int, int]:
    bsz, n, n2 = m.shape
    if n != n2 or z.shape != (bsz, n) or c.shape != (bsz, n):
        raise ValueError(
            f"shapes: m {tuple(m.shape)}, z {tuple(z.shape)}, c {tuple(c.shape)}")
    if n % ROW_BLOCK:
        raise ValueError(f"n={n} must be a multiple of {ROW_BLOCK}")
    dev = z.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("m", m), ("z", z), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, z on {dev}")
        if dev.type == "cuda" and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return bsz, n


def transient_sweep(m_t: torch.Tensor, z: torch.Tensor, c: torch.Tensor, *,
                    n_steps: int, dt: float = 1.0):
    """K3: ``n_steps`` fused dense Euler steps per system.

    ``m_t`` (B, n, n) holds the transposed operators; z/c (B, n), all
    float32, ``n % 128 == 0``.  Returns ``(z', res)`` with
    ``res[b, 0] = max_i |M_b z'_b + c_b|_i`` at the final state.

    Replaces ``repro/kernels/transient_step.py:transient_sweep_pallas``.
    Bound by bytes (the operator streams every step through one SM per
    system); the state stays in shared memory (``csrc/transient_step.cu``).
    """
    bsz, n = _check(m_t, z, c)
    if z.device.type == "cpu":
        return transient_sweep_plain(m_t, z, c, n_steps=n_steps, dt=dt)
    lib = build.load_library()
    out = torch.empty_like(z)
    res = torch.empty((bsz, 1), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = build.current_stream(z.device)
        lib.call("repro_dense_sweep", m_t.data_ptr(), z.data_ptr(), c.data_ptr(),
                 out.data_ptr(), res.data_ptr(), bsz, n, int(n_steps), float(dt),
                 stream)
    transient_sweep.launches += 1
    return out, res


def transient_step_batched(m: torch.Tensor, z: torch.Tensor, c: torch.Tensor,
                           dt: float = 1.0):
    """K4: one row-tiled dense Euler step per system.

    ``m`` (B, n, n) untransposed, z/c (B, n), all float32,
    ``n % 128 == 0``.  Returns ``(z', res)`` where ``res[b, blk]`` is
    the max of ``|M_b z_b + c_b|`` over the rows of block ``blk`` at the
    input state.  ``z'`` is a new buffer; ``z`` is not written.

    Replaces ``repro/kernels/transient_step.py:transient_step_batched_pallas``.
    Bound by bytes (the operator once per step, over all SMs) and, in a
    loop of steps, by the host call per launch (``csrc/transient_step.cu``).
    """
    bsz, n = _check(m, z, c)
    if z.device.type == "cpu":
        return transient_step_batched_plain(m, z, c, dt)
    lib = build.load_library()
    out = torch.empty_like(z)
    res = torch.empty((bsz, n // ROW_BLOCK), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = build.current_stream(z.device)
        lib.call("repro_dense_step", m.data_ptr(), z.data_ptr(), c.data_ptr(),
                 out.data_ptr(), res.data_ptr(), bsz, n, float(dt), stream)
    transient_step_batched.launches += 1
    return out, res


def transient_step_plain(m, z, c, dt: float):
    """Plain PyTorch version of :func:`transient_step`; matches
    ``repro.kernels.ref.transient_step_ref`` (float32 product, cast to
    ``z``'s dtype; TF32 must be off on CUDA, as for
    ``crosspoint_mvm_plain``)."""
    mz = torch.matmul(m.float(), z.float())
    return (z.float() + dt * (mz + c.float())).to(z.dtype)


def transient_step(m: torch.Tensor, z: torch.Tensor, c: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """K5: ``z + dt * (m @ z + c)`` for m (n, n) and z, c (n, nb), all of
    one dtype (float32 or bfloat16), accumulated in float32; returns a new
    (n, nb) tensor in ``z``'s dtype.

    Any n and nb: the kernel masks the ragged edges, nothing is padded.
    Replaces ``repro/kernels/transient_step.py:transient_step_pallas``.
    Bound by bytes (M read once) at small nb, by float32 operations past
    nb ~ 40 (``csrc/transient_step.cu``).
    """
    dev = build.check_tensors(build.FLOAT_DTYPES, m=m, z=z, c=c)
    n = m.shape[0]
    if (m.ndim != 2 or m.shape != (n, n) or z.ndim != 2 or z.shape[0] != n
            or c.shape != z.shape or len({m.dtype, z.dtype, c.dtype}) != 1):
        raise ValueError(f"need m (n, n) and z, c (n, nb) of one dtype, got m "
                         f"{tuple(m.shape)} {m.dtype}, z {tuple(z.shape)} {z.dtype}, "
                         f"c {tuple(c.shape)} {c.dtype}")
    if dev.type == "cpu":
        return transient_step_plain(m, z, c, dt)
    nb = z.shape[1]
    lib = build.load_library()
    out = torch.empty_like(z)
    with torch.cuda.device(dev):
        stream = build.current_stream(dev)
        lib.call("repro_transient_step", m.data_ptr(), z.data_ptr(), c.data_ptr(),
                 int(z.dtype == torch.bfloat16), out.data_ptr(), n, nb, float(dt), stream)
    transient_step.launches += 1
    return out


# launch counts of the CUDA kernels (plain-version calls do not count)
transient_sweep.launches = 0
transient_step_batched.launches = 0
transient_step.launches = 0
