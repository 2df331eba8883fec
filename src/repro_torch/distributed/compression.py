"""Gradient compression with error feedback: int8 with one scale per
tensor (counterpart of :mod:`repro.distributed.compression`).

The gradient plus the carried residual is quantized to int8 with a
per-tensor scale ``max|g| / 127``; the dequantized gradient goes on to the
optimizer and the quantization residual is carried to the next step
(Seide et al. 2014; Karimireddy et al. 2019), so the bias vanishes over
steps.  The functions work on ``{name: tensor}`` dicts, the port's
gradient and optimizer-state layout, and plug into
``make_train_step(compressor=compress_int8)``.  The reference's tensor
of a per-layer leaf stacks every layer, so the layers of one leaf
(``blocks.{i}.attn.wq`` for every ``i``) share one scale, the largest
over them, as there.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""

from __future__ import annotations

import re

import torch

from repro_torch.models.model import STACKED

_LAYER = re.compile(rf"^({'|'.join(STACKED)})\.\d+\.")


def scale_group(name: str) -> str:
    """The reference leaf ``name`` belongs to: its layer index dropped."""
    return _LAYER.sub(r"\1.", name)


def init_error_state(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-30) / 127`` rounded once, as float32 division rounds
    it on every device.  The divisor is a tensor on ``amax``'s device: a
    CUDA tensor divided by a Python scalar is multiplied by the scalar's
    reciprocal, which can round the scale one ulp away from the CPU's
    (and flip an int8 level at a half-level tie)."""
    return torch.clamp(amax, min=1e-30) / torch.full((), 127.0, dtype=amax.dtype,
                                                     device=amax.device)


def compress_int8(grads: dict[str, torch.Tensor], error_state: dict | None
                  ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Quantize (grad + error) to int8, one scale per reference leaf
    (:func:`scale_group`); return the dequantized grads, each in its
    gradient's dtype, and the new float32 error residual."""
    if error_state is None:
        error_state = init_error_state(grads)
    g32 = {n: g.float() + error_state[n] for n, g in grads.items()}
    amax: dict[str, torch.Tensor] = {}
    for n, x in g32.items():
        m = x.abs().max()
        key = scale_group(n)
        amax[key] = torch.maximum(amax[key], m) if key in amax else m
    out, err = {}, {}
    for n, g in grads.items():
        scale = int8_scale(amax[scale_group(n)])
        q = torch.clamp(torch.round(g32[n] / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        out[n] = deq.to(g.dtype)
        err[n] = g32.pop(n) - deq
    return out, err


def compression_ratio(dtype: torch.dtype = torch.bfloat16) -> float:
    """Wire-format ratio vs the uncompressed gradient dtype."""
    return dtype.itemsize / 1.0
