"""Crosspoint-array MVM kernel K6: crossbar currents ``I = G V``.

Counterpart of :mod:`repro.kernels.crosspoint_mvm` (the Hopper source is
``csrc/crosspoint_mvm.cu``).  The analog crossbar computes this product
for free through Ohm's and Kirchhoff's laws; on the card it is a tiled
product with a float32 accumulator, ``G`` (m, k) and ``V`` (k, nb) both
float32 or both bfloat16, the result in ``V``'s dtype.

:func:`crosspoint_mvm` launches the kernel for CUDA tensors and runs its
plain PyTorch version, :func:`crosspoint_mvm_plain`, for CPU tensors.
The route it launches is :func:`crosspoint_mvm_route`'s.  The public
wrapper with 1-D voltages is :func:`repro_torch.kernels.ops.crosspoint_mvm`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, gemv

# "mma_async": bf16 tensor cores fed by 16-byte asynchronous copies;
# "mma_scalar": the same product staged through masked scalar loads;
# "f32_async": the float32 FFMA product split over k across a thread-block
# cluster, fed by 16-byte asynchronous copies; "f32_scalar": the same
# product staged through masked scalar loads; "fma": the GEMV at nb = 1
# (common.cuh:gemv_rows, in the variant of gemv.gemv_variant)
ROUTES = ("mma_async", "mma_scalar", "f32_async", "f32_scalar", "fma")

# The float32 route's tile (csrc/crosspoint_mvm.cu: F32_BM, F32_BN, F32_BK)
# and its k split: up to F32_MAX_SPLIT blocks of a cluster share an output
# tile's contraction, the grid within one wave (build.split_ranks), each
# rank with at least F32_MIN_RANK_K of k.
F32_BM, F32_BN, F32_BK = 128, 64, 32
F32_MAX_SPLIT = 4
F32_MIN_RANK_K = 256


def crosspoint_mvm_route(dtype: torch.dtype, m: int, k: int, nb: int, aligned: bool) -> str:
    """The route of a K6 product, a pure function of its dtype, shape and
    alignment (``aligned``: both base pointers on 16-byte boundaries).

    ``nb == 1`` (the crossbar's GEMV, where neither tiles nor tensor
    cores buy anything) takes ``"fma"`` in both dtypes, in the variant of
    :func:`repro_torch.kernels.gemv.gemv_variant`.  bf16 with
    ``nb >= 2`` takes the tensor cores: ``"mma_async"`` where every
    8-element chunk of G's and V's rows lies wholly inside or outside the
    matrix (``k % 8 == 0``, ``nb % 8 == 0``) and the bases are aligned,
    else ``"mma_scalar"``.  float32 with ``nb >= 2`` takes the split-k
    FFMA product (TF32 stays off): ``"f32_async"`` where ``k % 4 == 0``,
    ``nb % 4 == 0`` and the bases are aligned, else ``"f32_scalar"``.
    ``m`` does not change the route.
    """
    del m
    if nb < 2:
        return "fma"
    if dtype == torch.bfloat16:
        return "mma_async" if k % 8 == 0 and nb % 8 == 0 and aligned else "mma_scalar"
    return "f32_async" if k % 4 == 0 and nb % 4 == 0 and aligned else "f32_scalar"


def crosspoint_mvm_split(m: int, k: int, nb: int) -> int:
    """How many blocks of a cluster share each output tile's contraction
    on the float32 route: the largest power of two up to F32_MAX_SPLIT
    that keeps the grid within one wave (build.split_ranks) and gives each
    rank at least F32_MIN_RANK_K of k; 1 where the tiles alone fill the
    card.  At nb = 64: 2 for m = 8192 (64 row tiles, 128 blocks), 4 for
    m = 7680 (240 blocks)."""
    tiles = -(-m // F32_BM) * -(-nb // F32_BN)
    return build.split_ranks(tiles, F32_MAX_SPLIT, -(-k // F32_MIN_RANK_K))


def k_ranges(k: int, ranks: int) -> list[tuple[int, int]]:
    """The k range ``[k0, k1)`` that each rank of the split adds, in rank
    order: whole 32-deep steps of ``ceil(k / ranks)`` rounded up, the tail
    to the last ranks (as ``csrc/crosspoint_mvm.cu:launch_f32``)."""
    per_rank = -(-k // ranks)
    chunk = -(-per_rank // F32_BK) * F32_BK
    return [(min(k, r * chunk), min(k, (r + 1) * chunk)) for r in range(ranks)]


def f32_clusters_per_wave(ranks: int) -> int:
    """How many clusters of ``ranks`` blocks of the float32 route the
    current CUDA device runs at once (``cudaOccupancyMaxActiveClusters``):
    a grid of more clusters runs in more than one wave."""
    clusters = ctypes.c_int(0)
    build.load_library().call("repro_crosspoint_mvm_f32_clusters", ranks,
                              ctypes.addressof(clusters))
    return clusters.value


def crosspoint_mvm_in_split_order(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The float32 routes' order of the sum, in plain PyTorch: each rank's
    k range (:func:`k_ranges`) as one float32 product, the partials added
    in rank order.  Within a range the kernel adds in k order, which a
    library product need not, so this holds the split's rounding, not the
    kernel's bits."""
    m, k = g.shape
    ranks = crosspoint_mvm_split(m, k, v.shape[1])
    out = None
    for k0, k1 in k_ranges(k, ranks):
        part = torch.matmul(g[:, k0:k1].float(), v[k0:k1].float())
        out = part if out is None else out + part
    return out.to(v.dtype)


def crosspoint_mvm_in_kernel_order(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The fma route (nb = 1) in plain PyTorch, bit for bit: the GEMV's
    float32 sums (:func:`repro_torch.kernels.gemv.gemv_in_kernel_order`)
    rounded to ``v``'s dtype."""
    if v.shape[1] != 1:
        raise ValueError(f"the GEMV's order needs nb = 1, got v {tuple(v.shape)}")
    return gemv.gemv_in_kernel_order(g, v[:, 0]).to(v.dtype)[:, None]


def crosspoint_mvm_plain(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`crosspoint_mvm`.

    Matches ``repro.kernels.ref.crosspoint_mvm_ref``: the product in
    float32, cast to ``v``'s dtype.  On CUDA it is a float32 matmul, full
    precision only while TF32 is off
    (``torch.backends.cuda.matmul.allow_tf32``, off by default).
    """
    return torch.matmul(g.float(), v.float()).to(v.dtype)


def crosspoint_mvm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K6: ``g @ v`` for g (m, k) and v (k, nb) of one dtype (float32 or
    bfloat16), accumulated in float32; returns (m, nb) in ``v``'s dtype.

    Any shape: the kernel masks the ragged edges, so nothing is padded.
    Replaces ``repro/kernels/crosspoint_mvm.py:crosspoint_mvm_pallas``.
    Bound by bytes (G read once) at small nb and in bf16, by float32
    operations past nb ~ 40 in float32 (``csrc/crosspoint_mvm.cu``).  The
    float32 routes split k over the blocks of a cluster
    (:func:`crosspoint_mvm_split`, :func:`k_ranges`) and add the partials
    in rank order: the same bits from launch to launch.  At nb = 1 the
    GEMV streams G once in a fixed order
    (:func:`crosspoint_mvm_in_kernel_order` gives its bits).
    """
    dev = build.check_tensors(build.FLOAT_DTYPES, g=g, v=v)
    if g.ndim != 2 or v.ndim != 2 or g.shape[1] != v.shape[0] or g.dtype != v.dtype:
        raise ValueError(f"need g (m, k) and v (k, nb) of one dtype, got g "
                         f"{tuple(g.shape)} {g.dtype}, v {tuple(v.shape)} {v.dtype}")
    if dev.type == "cpu":
        return crosspoint_mvm_plain(g, v)
    (m, k), nb = g.shape, v.shape[1]
    route = crosspoint_mvm_route(v.dtype, m, k, nb, build.aligned16(g, v))
    lib = build.load_library()
    out = torch.empty((m, nb), dtype=v.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = build.current_stream(dev)
        if route == "fma":
            variant = gemv.gemv_variant(v.dtype, k, build.aligned16(g, v))
            lib.call("repro_crosspoint_mvm", g.data_ptr(), v.data_ptr(),
                     int(v.dtype == torch.bfloat16), out.data_ptr(), m, k,
                     int(variant == "vec16"), stream)
            crosspoint_mvm.launches_by_variant[variant] += 1
        elif route.startswith("f32"):
            lib.call("repro_crosspoint_mvm_f32", g.data_ptr(), v.data_ptr(), out.data_ptr(),
                     m, k, nb, crosspoint_mvm_split(m, k, nb), int(route == "f32_async"),
                     stream)
        else:
            lib.call("repro_crosspoint_mvm_mma", g.data_ptr(), v.data_ptr(), out.data_ptr(),
                     m, k, nb, int(route == "mma_async"), stream)
    crosspoint_mvm.launches += 1
    crosspoint_mvm.launches_by_route[route] += 1
    return out


# launch counts of the CUDA kernel, in all, by route and, on the fma route,
# by the GEMV's variant (plain-version calls do not count)
crosspoint_mvm.launches = 0
crosspoint_mvm.launches_by_route = dict.fromkeys(ROUTES, 0)
crosspoint_mvm.launches_by_variant = dict.fromkeys(gemv.VARIANTS, 0)
