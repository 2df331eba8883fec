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
  the fused ``max |M z + c|`` at the final state; each system on the
  blocks of a thread-block cluster (:func:`ell_sweep_ranks`), its slots
  resident in their shared memory where they fit
  (:func:`ell_sweep_variant`).
* :func:`ell_step` (K2) — one row-tiled step; the max of ``|M z + c|``
  at the *input* state per 128-row block.

Each wrapper launches its kernel for tensors on a CUDA device and runs
its plain PyTorch version (``*_plain``, same contract, same rounding)
for tensors on the CPU.  ``sweep_dtype="bfloat16"`` means ``w`` is
bf16: the gathered state is rounded to bf16, the product rounded once to
bf16, and the slot sum runs in float32.
"""

from __future__ import annotations

import ctypes

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


def ell_sweep_fits(nz_p: int, k: int, w_itemsize: int, ranks: int) -> bool:
    """Whether K1's resident variant fits one block at ``ranks`` blocks a
    system: the rank's ``nz_p / ranks`` rows of ``k`` slots (an int32
    index and a weight of ``w_itemsize`` bytes each) beside the whole
    state, double-buffered, and the static scratch."""
    rows = nz_p // ranks
    return (rows * k * (4 + w_itemsize) + 2 * nz_p * 4 + build.SWEEP_SCRATCH_BYTES
            <= build.SMEM_PER_BLOCK)


def ell_sweep_ranks(nz_p: int, k: int, w_itemsize: int) -> int:
    """K1's cluster size for ``nz_p`` padded states and ``k`` slots: the
    smallest power of two up to 16 at which the rank's slots fit beside
    the state, else 16 (streamed).  16 at the matrix-free n = 1024 case
    (8192, 32) in both dtypes; 4 (f32) and 2 (bf16) at n = 256 (2048, 29).
    It divides ``nz_p`` (a multiple of 128), so every rank owns whole rows."""
    return build.sweep_ranks(lambda r: ell_sweep_fits(nz_p, k, w_itemsize, r))


def ell_sweep_variant(nz_p: int, k: int, w_itemsize: int) -> str:
    """``"resident"`` where K1's slots fit at :func:`ell_sweep_ranks`, else
    ``"streamed"`` (e.g. (16384, 33), past the ELL route's limit, which
    the route sends to K2)."""
    fits = ell_sweep_fits(nz_p, k, w_itemsize, ell_sweep_ranks(nz_p, k, w_itemsize))
    return "resident" if fits else "streamed"


def ell_sweep_clusters_per_wave(nz_p: int, k: int, w_dtype: torch.dtype) -> int:
    """How many K1 clusters at this shape and dtype, of its chosen size and
    variant, the current CUDA device runs at once
    (``cudaOccupancyMaxActiveClusters``); 0 would refuse the launch."""
    isz = w_dtype.itemsize
    clusters = ctypes.c_int(0)
    build.load_library().call(
        "repro_ell_sweep_clusters", int(w_dtype == torch.bfloat16), nz_p, k,
        ell_sweep_ranks(nz_p, k, isz), int(ell_sweep_variant(nz_p, k, isz) == "resident"),
        ctypes.addressof(clusters))
    return clusters.value


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
    z/c float32 ``(B, nz)``, ``nz % 128 == 0``, on CUDA 16-byte aligned.
    Returns ``(z', res)`` with ``res[b, 0] = max_i |M_b z'_b + c_b|_i`` at
    the final state.

    Replaces ``repro/kernels/ell_transient.py:ell_sweep_pallas``.  Each
    system runs on the :func:`ell_sweep_ranks` blocks of a thread-block
    cluster, each rank computing its rows with K2's arithmetic (so the
    result equals ``n_steps`` K2 launches bit for bit) and sharing them
    through distributed shared memory; the slots stay in shared memory
    where :func:`ell_sweep_variant` says they fit, else stream from L2
    (``csrc/ell_transient.cu``).  A cluster the card cannot place raises.
    """
    bsz, k, nz = _check(idx_t, w_t, z, c)
    if z.device.type == "cpu":
        return ell_sweep_plain(idx_t, w_t, z, c, n_steps=n_steps, dt=dt)
    if not build.aligned16(idx_t, w_t, z, c):
        raise ValueError("idx, w, z and c must be 16-byte aligned")
    isz = w_t.element_size()
    ranks = ell_sweep_ranks(nz, k, isz)
    variant = ell_sweep_variant(nz, k, isz)
    lib = build.load_library()
    out = torch.empty_like(z)
    res = torch.empty((bsz, 1), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = build.current_stream(z.device)
        lib.call("repro_ell_sweep", idx_t.data_ptr(), w_t.data_ptr(),
                 int(w_t.dtype == torch.bfloat16), z.data_ptr(), c.data_ptr(),
                 out.data_ptr(), res.data_ptr(), bsz, nz, k, int(n_steps),
                 float(dt), ranks, int(variant == "resident"), stream)
    ell_sweep.launches += 1
    ell_sweep.launches_by_variant[variant] += 1
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


# launch counts of the CUDA kernels, and K1's by variant (plain-version
# calls do not count)
ell_sweep.launches = 0
ell_sweep.launches_by_variant = dict.fromkeys(build.SWEEP_VARIANTS, 0)
ell_step.launches = 0
