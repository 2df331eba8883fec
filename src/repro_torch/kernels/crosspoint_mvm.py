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

import torch

from repro_torch.kernels import build

# "mma_async": bf16 tensor cores fed by 16-byte asynchronous copies;
# "mma_scalar": the same product staged through masked scalar loads;
# "fma": the float32 FMA tile product (common.cuh:tile_product)
ROUTES = ("mma_async", "mma_scalar", "fma")


def crosspoint_mvm_route(dtype: torch.dtype, m: int, k: int, nb: int, aligned: bool) -> str:
    """The route of a K6 product, a pure function of its dtype, shape and
    alignment (``aligned``: both base pointers on 16-byte boundaries).

    bf16 with ``nb >= 2`` takes the tensor cores: ``"mma_async"`` where
    every 8-element chunk of G's and V's rows lies wholly inside or outside
    the matrix (``k % 8 == 0``, ``nb % 8 == 0``) and the bases are
    aligned, else ``"mma_scalar"``.  bf16 at ``nb == 1`` (a GEMV, where
    tensor cores buy nothing) and every float32 product take ``"fma"``:
    TF32 stays off, so float32 gets no tensor cores.  ``m`` does not
    change the route.
    """
    del m
    if dtype != torch.bfloat16 or nb < 2:
        return "fma"
    if k % 8 == 0 and nb % 8 == 0 and aligned:
        return "mma_async"
    return "mma_scalar"


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
    operations past nb ~ 40 in float32 (``csrc/crosspoint_mvm.cu``).
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
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "fma":
            lib.call("repro_crosspoint_mvm", g.data_ptr(), v.data_ptr(),
                     int(v.dtype == torch.bfloat16), out.data_ptr(), m, k, nb, stream)
        else:
            lib.call("repro_crosspoint_mvm_mma", g.data_ptr(), v.data_ptr(), out.data_ptr(),
                     m, k, nb, int(route == "mma_async"), stream)
    crosspoint_mvm.launches += 1
    crosspoint_mvm.launches_by_route[route] += 1
    return out


# launch counts of the CUDA kernel, in all and by route (plain-version
# calls do not count)
crosspoint_mvm.launches = 0
crosspoint_mvm.launches_by_route = dict.fromkeys(ROUTES, 0)
