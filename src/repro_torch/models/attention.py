"""Attention: flash attention (prefill) and cached decode attention.

Counterpart of :mod:`repro.models.attention`.  :func:`flash_attention`
runs K8 (:mod:`repro_torch.kernels.flash_attention`) for CUDA tensors and
its plain PyTorch version for CPU tensors; it keeps the reference's
signature except ``q_block``/``kv_block``, which the kernel fixes itself.
:func:`decode_attention` is plain PyTorch, as the reference's is plain
jnp: one query row per sequence against the cache.  GQA is native in
both: query head ``h`` reads KV head ``h // G``, and K/V are never
repeated.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as _k8

NEG_INF = _k8.NEG_INF


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    p_dtype: torch.dtype | None = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KV, D); H = KV * G.  -> (B, S, H, D).

    ``p_dtype`` rounds the probability tile before the PV product
    (``None`` keeps it float32, as the reference does unless
    ``ModelConfig.attn_p_bf16``).
    """
    return _k8.flash_attention(q, k, v, causal=causal, window=window, p_dtype=p_dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, *, head_dim: int | None = None,
                     reduce_scores=None) -> torch.Tensor:
    """Single-step cached attention.

    q: (B, 1, H, D); caches: (B, S, KV, D); pos: () or (B,) — keys at
    index > pos are masked out (the row at ``pos``, just written, is
    included).  Scores and softmax in float32.

    With D a shard of the heads' columns (tensor parallelism over
    ``head_dim``), ``head_dim`` is the whole heads' size, which the
    scores' scale ``1 / sqrt(head_dim)`` reads, and ``reduce_scores``
    sums the float32 partial scores over the shards before the scale;
    the output is this shard's columns.
    """
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(head_dim or d)
    qg = q.reshape(b, kv, g, d).float()
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    if reduce_scores is not None:
        scores = reduce_scores(scores)
    scores = scores * scale
    kpos = torch.arange(s, device=q.device)
    valid = kpos[None, :] <= pos.reshape(-1, 1)                  # (B or 1, S)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
