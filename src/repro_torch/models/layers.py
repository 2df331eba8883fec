"""Shared building blocks: norms, RoPE, MLPs, embeddings, sinusoids.

Counterpart of :mod:`repro.models.layers`.  Functions on tensors; every
op takes and returns the compute dtype, with norm and activation
statistics in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, *,
             mean_over=None) -> torch.Tensor:
    """RMS norm over the last axis in float32.  ``mean_over`` takes the
    mean square of a last axis split into equal shards (tensor
    parallelism over ``head_dim``): it averages the shards' mean squares,
    and ``scale`` is this shard's."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    if mean_over is not None:
        var = mean_over(var)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with the population variance, in float32."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    """(d_head/2,) inverse frequencies, float32."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split-half convention (not interleaved pairs).

    x: (..., seq, heads, d_head); positions: (..., seq) integers.  The
    angles are float32 from the integer positions.
    """
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)   # (d/2,)
    angles = positions[..., None].float() * freqs                   # (..., seq, d/2)
    cos = torch.cos(angles)[..., None, :]                           # (..., seq, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope_columns(x: torch.Tensor, partner: torch.Tensor, positions: torch.Tensor,
                       theta: float, d_head: int, first: int) -> torch.Tensor:
    """:func:`apply_rope` on columns ``first .. first + c`` of heads of
    ``d_head`` columns (``x`` (..., seq, heads, c), a ``head_dim`` shard
    within one half), given ``partner``, the columns ``d_head / 2`` away
    that the half-split rotation pairs with them: each element is the
    one-device rotation's."""
    half, c = d_head // 2, x.shape[-1]
    if (first % half) + c > half:
        raise ValueError(f"columns {first}..{first + c} straddle the halves of {d_head}")
    freqs = rope_frequencies(d_head, theta, device=x.device)[first % half:first % half + c]
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x32, p32 = x.float(), partner.float()
    out = x32 * cos - p32 * sin if first < half else x32 * cos + p32 * sin
    return out.to(x.dtype)


def swiglu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    """LLaMA-style gated MLP: w_down(silu(w_gate x) * w_up x); SiLU in
    float32, cast back to the compute dtype."""
    g = x @ p.w_gate
    u = x @ p.w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p.w_down


def gelu_mlp(x: torch.Tensor, p, exit=None) -> torch.Tensor:
    """Whisper-style MLP: w_down(gelu(w_up x + b_up)) + b_down, GELU's tanh
    form in float32.  Under tensor parallelism ``x`` has entered through
    f, ``w_up`` and ``b_up`` are the rank's ``ff`` columns, ``w_down`` its
    rows, and ``exit`` (Megatron's g) sums the partial products over the
    ranks before ``b_down``, which is whole on every rank, is added once."""
    h = x @ p.w_up + p.b_up.to(x.dtype)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = h @ p.w_down
    if exit is not None:
        y = exit(y)
    return y + p.b_down.to(x.dtype)


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocab."""
    return x @ table


def _sinusoid_freqs(d_model: int, device) -> torch.Tensor:
    half = d_model // 2
    steps = torch.arange(half, dtype=torch.float32, device=device)
    return torch.exp(-math.log(10000.0) * steps / (half - 1))


def sinusoid_positions(length: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal positions, float32 (length, d):
    ``[sin | cos]`` of ``pos * exp(-log(10000) i / (d/2 - 1))``."""
    freqs = _sinusoid_freqs(d_model, device)
    args = torch.arange(length, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


def sinusoid_position_at(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """The sinusoidal embedding at each position of ``pos`` (any shape of
    integers): (*pos.shape, d), float32."""
    freqs = _sinusoid_freqs(d_model, pos.device)
    args = pos.float()[..., None] * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
