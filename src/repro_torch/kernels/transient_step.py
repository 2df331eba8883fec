"""Dense forward-Euler kernels K3, K4 and K5.

Counterpart of :mod:`repro.kernels.transient_step` (the Hopper sources
are ``csrc/transient_step.cu``):

* :func:`transient_sweep` (K3) — ``n_steps`` fused steps
  ``z <- z + dt (M z + c)`` per system on the *pre-transposed* operator
  ``m_t[b] = M_b^T``, and the fused ``max |M z + c|`` at the final state;
  each system on the blocks of a thread-block cluster
  (:func:`dense_sweep_ranks`), its rows of the operator resident in their
  shared memory where they fit (:func:`dense_sweep_variant`).
* :func:`transient_step_batched` (K4) — one row-tiled step on the
  untransposed operator, and the max of ``|M z + c|`` at the *input*
  state per 128-row block; each block's columns split over the blocks of
  a thread-block cluster (:func:`dense_step_ranks`).
* :func:`transient_step` (K5) — one step ``Z' = Z + dt (M Z + C)`` of a
  single operator ``M`` (n, n) on ``nb`` state columns, float32 or
  bfloat16 operands with a float32 accumulator, on the route of
  :func:`transient_step_route`: for 2 <= nb <= 16 a product split over k
  across a cluster (:func:`transient_step_split`), at nb = 1 K6's GEMV
  (:mod:`repro_torch.kernels.gemv`) and past 16 a tiled product, each
  with the step as its epilogue.

Each wrapper launches its kernel for tensors on a CUDA device and runs
its plain PyTorch version (``*_plain``) for tensors on the CPU.  K3 and
K4 run in float32 with a float32 accumulator.  The ``*_in_kernel_order``
functions repeat the split kernels' order of summation in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, gemv

ROW_BLOCK = 128

# K4's split (csrc/transient_step.cu: dense_step_kernel): the columns of
# each 128-row block go to the R ranks of a cluster in chunks of 128, R
# up to DENSE_STEP_MAX_SPLIT, the grid within one wave (build.split_ranks).
DENSE_STEP_CHUNK = 128
DENSE_STEP_MAX_SPLIT = 8

# K5's routes (csrc/transient_step.cu): "narrow_async", 2 <= nb <= 16 split
# over k across a cluster and fed by 16-byte asynchronous copies;
# "narrow_scalar", the same kernel staging its tiles through masked scalar
# loads; "column", nb = 1, on the GEMV of K6's fma route (common.cuh:
# gemv_rows, in the variant of gemv.gemv_variant), and "wide", nb > 16, on
# common.cuh:tile_product.
STEP_ROUTES = ("narrow_async", "narrow_scalar", "column", "wide")
# The narrow route's tile (NS_BM x NS_BN), its k steps (128 bytes of each
# M row: 32 float32 or 64 bf16 k, a sixteen-byte slice to each of 8
# warps), the grid its ranks' k ranges start on, and its split: up to
# NARROW_MAX_SPLIT ranks, the grid within one wave (build.split_ranks), each
# rank at least NARROW_MIN_RANK_K of k.
NARROW_BM, NARROW_BN = 128, 16
NARROW_WARPS = 8
NARROW_K_GRID = 64
NARROW_MAX_SPLIT = 8
NARROW_MIN_RANK_K = 512


def transient_sweep_plain(m_t, z, c, *, n_steps: int, dt: float = 1.0):
    """Plain PyTorch version of :func:`transient_sweep` (same contract)."""
    zz = z.to(torch.float32)
    for _ in range(n_steps):
        zz = zz + dt * (torch.einsum("bj,bji->bi", zz, m_t) + c)
    dz = torch.einsum("bj,bji->bi", zz, m_t) + c
    return zz, dz.abs().amax(dim=1, keepdim=True)


def dense_sweep_fits(n: int, ranks: int) -> bool:
    """Whether K3's resident variant fits one block at ``ranks`` blocks a
    system: the rank's slab of the transposed operator (``n`` columns of
    ``n / ranks`` rows, float32) beside the whole state, double-buffered,
    and the static scratch."""
    return n * (n // ranks) * 4 + 2 * n * 4 + build.SWEEP_SCRATCH_BYTES <= build.SMEM_PER_BLOCK


def dense_sweep_ranks(n: int) -> int:
    """K3's cluster size for ``n`` padded states: the smallest power of two
    up to 16 at which the rank's slab fits beside the state, else 16
    (streamed).  4 at the n = 48 case (nz = 384), 8 at nz = 512 and 640,
    16 (streamed) from nz = 1024.  It divides ``n`` (a multiple of 128),
    so every rank owns whole rows."""
    return build.sweep_ranks(lambda r: dense_sweep_fits(n, r))


def dense_sweep_variant(n: int) -> str:
    """``"resident"`` where K3's slab fits at :func:`dense_sweep_ranks`,
    else ``"streamed"``."""
    return "resident" if dense_sweep_fits(n, dense_sweep_ranks(n)) else "streamed"


def dense_sweep_clusters_per_wave(n: int) -> int:
    """How many K3 clusters at ``n`` states, of its chosen size and variant,
    the current CUDA device runs at once (``cudaOccupancyMaxActiveClusters``);
    0 would refuse the launch."""
    clusters = ctypes.c_int(0)
    build.load_library().call("repro_dense_sweep_clusters", n, dense_sweep_ranks(n),
                              int(dense_sweep_variant(n) == "resident"),
                              ctypes.addressof(clusters))
    return clusters.value


def transient_step_batched_plain(m, z, c, dt: float = 1.0):
    """Plain PyTorch version of :func:`transient_step_batched`."""
    dz = torch.einsum("bij,bj->bi", m, z) + c
    bsz, n = z.shape
    res = dz.abs().reshape(bsz, n // ROW_BLOCK, ROW_BLOCK).amax(dim=2)
    return z + dt * dz, res


def dense_step_ranks(batch: int, n: int) -> int:
    """How many blocks of a cluster share each 128-row block's columns in
    K4: the largest power of two up to DENSE_STEP_MAX_SPLIT that keeps the
    grid ``batch * n / 128 * R`` within one wave (build.split_ranks) and
    gives every rank a 128-column chunk.  2 at the settle sweep's
    (4, 2048) and at (1, 8192), 4 at (4, 1024) and (4, 640)."""
    return build.split_ranks(batch * (n // ROW_BLOCK), DENSE_STEP_MAX_SPLIT,
                             n // DENSE_STEP_CHUNK)


def dense_step_column_ranges(n: int, ranks: int) -> list[tuple[int, int]]:
    """The columns ``[c0, c1)`` each rank of K4's split adds, in rank
    order: ``ceil(chunks / ranks)`` chunks of 128 a rank, the last ranks
    short or empty (as ``csrc/transient_step.cu:repro_dense_step``)."""
    chunks = n // DENSE_STEP_CHUNK
    per_rank = -(-chunks // ranks) * DENSE_STEP_CHUNK
    return [(min(n, r * per_rank), min(n, (r + 1) * per_rank)) for r in range(ranks)]


def dense_step_clusters_per_wave(ranks: int) -> int:
    """How many clusters of ``ranks`` K4 blocks the current CUDA device runs
    at once (``cudaOccupancyMaxActiveClusters``)."""
    clusters = ctypes.c_int(0)
    build.load_library().call("repro_dense_step_clusters", ranks, ctypes.addressof(clusters))
    return clusters.value


def dense_step_in_kernel_order(m, z, c, dt: float = 1.0):
    """K4's order of the sum in plain PyTorch: each rank's columns
    (:func:`dense_step_column_ranges`) as one float32 product, the
    partials added in rank order, then the step and the block maxima.
    Within a rank the kernel adds in its own order, which a library
    product need not, so this holds the split's rounding, not the
    kernel's bits."""
    bsz, n = z.shape
    acc = None
    for c0, c1 in dense_step_column_ranges(n, dense_step_ranks(bsz, n)):
        part = torch.einsum("bij,bj->bi", m[:, :, c0:c1], z[:, c0:c1])
        acc = part if acc is None else acc + part
    dz = acc + c
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
    Each system runs on the :func:`dense_sweep_ranks` blocks of a
    thread-block cluster, a row a thread, each row's sum in column order
    (the first port's bits), the new rows shared through distributed
    shared memory; each rank's rows of the operator stay in its shared
    memory where :func:`dense_sweep_variant` says they fit, else stream
    from L2/HBM (``csrc/transient_step.cu``).  A cluster the card cannot
    place raises.
    """
    bsz, n = _check(m_t, z, c)
    if z.device.type == "cpu":
        return transient_sweep_plain(m_t, z, c, n_steps=n_steps, dt=dt)
    ranks, variant = dense_sweep_ranks(n), dense_sweep_variant(n)
    lib = build.load_library()
    out = torch.empty_like(z)
    res = torch.empty((bsz, 1), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = build.current_stream(z.device)
        lib.call("repro_dense_sweep", m_t.data_ptr(), z.data_ptr(), c.data_ptr(),
                 out.data_ptr(), res.data_ptr(), bsz, n, int(n_steps), float(dt),
                 ranks, int(variant == "resident"), stream)
    transient_sweep.launches += 1
    transient_sweep.launches_by_variant[variant] += 1
    return out, res


def transient_step_batched(m: torch.Tensor, z: torch.Tensor, c: torch.Tensor,
                           dt: float = 1.0):
    """K4: one row-tiled dense Euler step per system.

    ``m`` (B, n, n) untransposed, z/c (B, n), all float32,
    ``n % 128 == 0``.  Returns ``(z', res)`` where ``res[b, blk]`` is
    the max of ``|M_b z_b + c_b|`` over the rows of block ``blk`` at the
    input state.  ``z'`` is a new buffer; ``z`` is not written.

    Replaces ``repro/kernels/transient_step.py:transient_step_batched_pallas``.
    Bound by bytes (the operator once per step) and, in a loop of steps,
    by the host call per launch (``csrc/transient_step.cu``).  Each
    128-row block's columns are split over :func:`dense_step_ranks`
    blocks of a cluster and added in rank order: the same bits from
    launch to launch.
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
                 out.data_ptr(), res.data_ptr(), bsz, n, dense_step_ranks(bsz, n),
                 float(dt), stream)
    transient_step_batched.launches += 1
    return out, res


def transient_step_plain(m, z, c, dt: float):
    """Plain PyTorch version of :func:`transient_step`; matches
    ``repro.kernels.ref.transient_step_ref`` (float32 product, cast to
    ``z``'s dtype; TF32 must be off on CUDA, as for
    ``crosspoint_mvm_plain``)."""
    mz = torch.matmul(m.float(), z.float())
    return (z.float() + dt * (mz + c.float())).to(z.dtype)


def transient_step_route(dtype: torch.dtype, n: int, nb: int, aligned: bool) -> str:
    """The route of a K5 step, a pure function of its dtype, shape and
    alignment (``aligned``: m's and z's bases on 16-byte boundaries).

    ``nb == 1`` takes ``"column"`` and ``nb > 16`` ``"wide"``.  Between,
    the split-k product: ``"narrow_async"`` where every 16-byte chunk of
    M's and Z's rows lies wholly inside or outside the matrix (n and nb
    multiples of 4 in float32, of 8 in bf16) and the bases are aligned,
    else ``"narrow_scalar"``.
    """
    if nb <= 1:
        return "column"
    if nb > NARROW_BN:
        return "wide"
    per_chunk = 8 if dtype == torch.bfloat16 else 4
    vec16 = n % per_chunk == 0 and nb % per_chunk == 0 and aligned
    return "narrow_async" if vec16 else "narrow_scalar"


def transient_step_split(n: int) -> int:
    """How many blocks of a cluster share each tile's contraction on the
    narrow route (one column tile: nb <= 16): the largest power of two up
    to NARROW_MAX_SPLIT that keeps the grid within one wave
    (build.split_ranks) and gives each rank at least NARROW_MIN_RANK_K of
    k.  2 at n = 8192 (64 row tiles, 128 blocks)."""
    return build.split_ranks(-(-n // NARROW_BM), NARROW_MAX_SPLIT,
                             -(-n // NARROW_MIN_RANK_K))


def narrow_k_ranges(n: int, ranks: int) -> list[tuple[int, int]]:
    """The k range ``[k0, k1)`` each rank of the narrow route adds, in rank
    order: ``ceil(n / ranks)`` rounded up to the 64-deep grid, the tail to
    the last ranks (as ``csrc/transient_step.cu:launch_narrow``)."""
    per_rank = -(-n // ranks)
    chunk = -(-per_rank // NARROW_K_GRID) * NARROW_K_GRID
    return [(min(n, r * chunk), min(n, (r + 1) * chunk)) for r in range(ranks)]


def narrow_clusters_per_wave(ranks: int) -> int:
    """How many clusters of ``ranks`` blocks of the narrow route the current
    CUDA device runs at once (``cudaOccupancyMaxActiveClusters``)."""
    clusters = ctypes.c_int(0)
    build.load_library().call("repro_transient_step_narrow_clusters", ranks,
                              ctypes.addressof(clusters))
    return clusters.value


def transient_step_in_kernel_order(m, z, c, dt: float):
    """The column route's step (nb = 1) in plain PyTorch, bit for bit: the
    GEMV's float32 sums (:func:`repro_torch.kernels.gemv.
    gemv_in_kernel_order`) and the step rounded as the plain version rounds
    it.

    On the narrow route (2 <= nb <= 16) the order of the sum: within each
    rank's k range (:func:`narrow_k_ranges`) warp w adds the k whose
    offset from the range's start falls in the w-th sixteen bytes of a
    128-byte step, the warps' partials are added in warp order, then the
    ranks' in rank order, and the step is rounded as the plain version
    rounds it.  Each warp's products are one float32 product here, whose
    order a library need not keep: this holds the split's rounding, not
    the kernel's bits."""
    n, nb = z.shape
    if nb == 1:
        acc = gemv.gemv_in_kernel_order(m, z[:, 0])[:, None]
        return (z.float() + dt * (acc + c.float())).to(z.dtype)
    per_warp = 16 // m.element_size()
    step = NARROW_WARPS * per_warp
    acc = None
    for k0, k1 in narrow_k_ranges(n, transient_step_split(n)):
        ks = torch.arange(k0, k1, device=m.device)
        warp = ((ks - k0) % step) // per_warp
        for w in range(NARROW_WARPS):
            sel = ks[warp == w]
            part = torch.matmul(m[:, sel].float(), z[sel].float())
            acc = part if acc is None else acc + part
    return (z.float() + dt * (acc + c.float())).to(z.dtype)


def transient_step(m: torch.Tensor, z: torch.Tensor, c: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """K5: ``z + dt * (m @ z + c)`` for m (n, n) and z, c (n, nb), all of
    one dtype (float32 or bfloat16), accumulated in float32; returns a new
    (n, nb) tensor in ``z``'s dtype.

    Any n and nb: the kernel masks the ragged edges, nothing is padded.
    Replaces ``repro/kernels/transient_step.py:transient_step_pallas``.
    Bound by bytes (M read once) at small nb, by float32 operations past
    nb ~ 40 (``csrc/transient_step.cu``).  The route is
    :func:`transient_step_route`'s; the narrow routes split k over
    :func:`transient_step_split` blocks of a cluster and add the partials
    in a fixed order: the same bits from launch to launch.
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
    route = transient_step_route(z.dtype, n, nb, build.aligned16(m, z))
    lib = build.load_library()
    out = torch.empty_like(z)
    is_bf16 = int(z.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = build.current_stream(dev)
        if route.startswith("narrow"):
            lib.call("repro_transient_step_narrow", m.data_ptr(), z.data_ptr(), c.data_ptr(),
                     is_bf16, out.data_ptr(), n, nb, transient_step_split(n),
                     int(route == "narrow_async"), float(dt), stream)
        else:
            variant = gemv.gemv_variant(z.dtype, n, build.aligned16(m, z))
            lib.call("repro_transient_step", m.data_ptr(), z.data_ptr(), c.data_ptr(),
                     is_bf16, out.data_ptr(), n, nb, int(variant == "vec16"), float(dt),
                     stream)
            if route == "column":
                transient_step.launches_by_variant[variant] += 1
    transient_step.launches += 1
    transient_step.launches_by_route[route] += 1
    transient_step.launches_by_dtype[str(z.dtype).removeprefix("torch.")][route] += 1
    return out


# launch counts of the CUDA kernels, K3's by variant, and K5's by route,
# by dtype and route, and on the column route by the GEMV's variant
# (plain-version calls do not count)
transient_sweep.launches = 0
transient_sweep.launches_by_variant = dict.fromkeys(build.SWEEP_VARIANTS, 0)
transient_step_batched.launches = 0
transient_step.launches = 0
transient_step.launches_by_route = dict.fromkeys(STEP_ROUTES, 0)
transient_step.launches_by_variant = dict.fromkeys(gemv.VARIANTS, 0)   # the column route's
transient_step.launches_by_dtype = {dt: dict.fromkeys(STEP_ROUTES, 0)
                                    for dt in ("float32", "bfloat16")}
