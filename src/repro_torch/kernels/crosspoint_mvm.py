"""Crosspoint-array MVM kernel K6: crossbar currents ``I = G V``.

Counterpart of :mod:`repro.kernels.crosspoint_mvm` (the Hopper source is
``csrc/crosspoint_mvm.cu``).  The analog crossbar computes this product
for free through Ohm's and Kirchhoff's laws; on the card it is a tiled
product with a float32 accumulator, ``G`` (m, k) and ``V`` (k, nb) both
float32 or both bfloat16, the result in ``V``'s dtype.

:func:`crosspoint_mvm` launches the kernel for CUDA tensors and runs its
plain PyTorch version, :func:`crosspoint_mvm_plain`, for CPU tensors.
The public wrapper with 1-D voltages is
:func:`repro_torch.kernels.ops.crosspoint_mvm`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build


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
    Bound by bytes (G read once) at small nb and by float32 operations
    past nb ~ 40 (``csrc/crosspoint_mvm.cu``).
    """
    dev = build.check_tensors(build.FLOAT_DTYPES, g=g, v=v)
    if g.ndim != 2 or v.ndim != 2 or g.shape[1] != v.shape[0] or g.dtype != v.dtype:
        raise ValueError(f"need g (m, k) and v (k, nb) of one dtype, got g "
                         f"{tuple(g.shape)} {g.dtype}, v {tuple(v.shape)} {v.dtype}")
    if dev.type == "cpu":
        return crosspoint_mvm_plain(g, v)
    (m, k), nb = g.shape, v.shape[1]
    lib = build.load_library()
    out = torch.empty((m, nb), dtype=v.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.call("repro_crosspoint_mvm", g.data_ptr(), v.data_ptr(),
                 int(v.dtype == torch.bfloat16), out.data_ptr(), m, k, nb, stream)
    crosspoint_mvm.launches += 1
    return out


# launch count of the CUDA kernel (plain-version calls do not count)
crosspoint_mvm.launches = 0
