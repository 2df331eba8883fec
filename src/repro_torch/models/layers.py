"""Shared building blocks: norms, RoPE, the gated MLP, embeddings.

Counterpart of :mod:`repro.models.layers` (the dense decoder's part;
``layer_norm``, ``gelu_mlp`` and the sinusoids belong to Whisper and are
not ported yet).  Functions on tensors; every op takes and returns the
compute dtype, with norm and activation statistics in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


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


def swiglu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    """LLaMA-style gated MLP: w_down(silu(w_gate x) * w_up x); SiLU in
    float32, cast back to the compute dtype."""
    g = x @ p.w_gate
    u = x @ p.w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p.w_down


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocab."""
    return x @ table
