"""Per-layer blocks of the dense decoder: parameter modules, initializers
and forward functions.

Counterpart of the dense part of :mod:`repro.models.blocks` (MoE, Mamba
and the encoder-decoder blocks are not ported yet).  Parameters live in
small :class:`torch.nn.Module` containers whose attribute names are the
reference's dict keys (``attn.wq``, ``mlp.w_gate``, ...), so a state dict
maps one to one onto the reference's parameter tree; the forward
functions are plain functions on tensors, as in the reference.  The
reference's sharding hints (``lc``, ``boundary_pin``) are dropped:
without mesh rules they are no-ops.

Initialization draws float32 normals from an explicit
:class:`torch.Generator` on its own device, scales them and casts to the
parameter dtype, tensor by tensor, with the reference's shapes and
scales; the values differ from the reference's (another RNG), so parity
tests carry the reference's weights across with
:func:`repro_torch.convert.lm_params_from_arrays`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm, swiglu_mlp


def _normal(generator: torch.Generator, shape, dtype: torch.dtype, std: float) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (x.mul_(std)).to(dtype)


def _param(x: torch.Tensor) -> nn.Parameter:
    # the serving path runs under torch.inference_mode; no gradients yet
    return nn.Parameter(x, requires_grad=False)


class Attention(nn.Module):
    """Head-structured projections: ``wq`` (d, H, dh), ``wk``/``wv``
    (d, KV, dh), ``wo`` (H, dh, d); ``q_norm``/``k_norm`` (dh,) with
    ``qk_norm``."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_param, (wq, wk, wv, wo))
        self.q_norm = None if q_norm is None else _param(q_norm)
        self.k_norm = None if k_norm is None else _param(k_norm)


class MLP(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = map(_param, (w_gate, w_up, w_down))


class DenseBlock(nn.Module):
    def __init__(self, ln1, attn: Attention, ln2, mlp: MLP):
        super().__init__()
        self.ln1, self.ln2 = _param(ln1), _param(ln2)
        self.attn, self.mlp = attn, mlp


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def init_attn(generator: torch.Generator, cfg: ModelConfig, out_scale: float) -> Attention:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.p_dtype()
    norms = {}
    if cfg.qk_norm:
        norms = dict(q_norm=torch.ones(dh, dtype=dt, device=generator.device),
                     k_norm=torch.ones(dh, dtype=dt, device=generator.device))
    return Attention(
        _normal(generator, (d, h, dh), dt, d ** -0.5),
        _normal(generator, (d, kv, dh), dt, d ** -0.5),
        _normal(generator, (d, kv, dh), dt, d ** -0.5),
        _normal(generator, (h, dh, d), dt, out_scale * (h * dh) ** -0.5),
        **norms,
    )


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, heads, dh = w.shape
    return (x @ w.reshape(d, heads * dh)).reshape(*x.shape[:-1], heads, dh)


def _qkv(x: torch.Tensor, p: Attention, cfg: ModelConfig):
    q, k, v = _project(x, p.wq), _project(x, p.wk), _project(x, p.wv)
    if cfg.qk_norm:
        # rms_norm over head_dim per head, before RoPE
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def _out(o: torch.Tensor, p: Attention) -> torch.Tensor:
    h, dh, d = p.wo.shape
    return o.reshape(*o.shape[:-2], h * dh) @ p.wo.reshape(h * dh, d)


def attn_forward(x: torch.Tensor, p: Attention, cfg: ModelConfig, *,
                 positions: torch.Tensor, causal: bool = True, use_rope: bool = True):
    """Full-sequence attention.  Returns ``(out, (k, v))`` — k/v are the
    cache entries a prefill caller stores."""
    q, k, v = _qkv(x, p, cfg)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = attn_lib.flash_attention(
        q, k, v, causal=causal, window=cfg.sliding_window,
        p_dtype=torch.bfloat16 if cfg.attn_p_bf16 else None,
    )
    return _out(o, p), (k, v)


def pos_vector(pos, batch: int, device=None) -> torch.Tensor:
    """A decode position as a per-sequence (B,) int64 vector.

    Takes a scalar (every sequence at one length) or a per-slot (B,)
    vector — continuous batching runs slots at different lengths, so
    each slot writes its KV row and rotates its query at its own
    position.
    """
    pos = torch.as_tensor(pos, dtype=torch.int64, device=device)
    return pos.reshape(-1).expand(batch)


def _cache_row_write(cache: torch.Tensor, new: torch.Tensor, pos_vec: torch.Tensor) -> None:
    """Write one new KV row per sequence, in place: ``cache`` (B, S, KV, dh)
    gets ``new[:, 0]`` at row ``pos_vec[b]`` of sequence ``b``."""
    b = cache.shape[0]
    cache[torch.arange(b, device=cache.device), pos_vec] = new[:, 0].to(cache.dtype)


def attn_decode(x: torch.Tensor, p: Attention, cfg: ModelConfig, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos) -> torch.Tensor:
    """One-token step; cache_k/v (B, S, KV, dh) are updated in place at
    each sequence's position; pos: () or (B,)."""
    b = x.shape[0]
    q, k, v = _qkv(x, p, cfg)
    pos_vec = pos_vector(pos, b, x.device)
    q = apply_rope(q, pos_vec[:, None], cfg.rope_theta)
    k = apply_rope(k, pos_vec[:, None], cfg.rope_theta)
    _cache_row_write(cache_k, k, pos_vec)
    _cache_row_write(cache_v, v, pos_vec)
    o = attn_lib.decode_attention(q, cache_k, cache_v, pos_vec)
    return _out(o, p)


# --------------------------------------------------------------------------
# dense decoder block
# --------------------------------------------------------------------------

def init_dense_block(generator: torch.Generator, cfg: ModelConfig) -> DenseBlock:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.p_dtype()
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    attn = init_attn(generator, cfg, out_scale)
    mlp = MLP(
        _normal(generator, (d, f), dt, d ** -0.5),
        _normal(generator, (d, f), dt, d ** -0.5),
        _normal(generator, (f, d), dt, out_scale * f ** -0.5),
    )
    ones = torch.ones(d, dtype=dt, device=generator.device)
    return DenseBlock(ones, attn, ones.clone(), mlp)


def dense_block_forward(x: torch.Tensor, p: DenseBlock, cfg: ModelConfig,
                        positions: torch.Tensor, *, causal: bool = True):
    if cfg.parallel_block:
        h = rms_norm(x, p.ln1, cfg.norm_eps)
        a, kvc = attn_forward(h, p.attn, cfg, positions=positions, causal=causal)
        return x + a + swiglu_mlp(h, p.mlp), kvc
    a, kvc = attn_forward(rms_norm(x, p.ln1, cfg.norm_eps), p.attn, cfg,
                          positions=positions, causal=causal)
    x = x + a
    return x + swiglu_mlp(rms_norm(x, p.ln2, cfg.norm_eps), p.mlp), kvc


def dense_block_decode(x: torch.Tensor, p: DenseBlock, cfg: ModelConfig,
                       cache_k: torch.Tensor, cache_v: torch.Tensor, pos) -> torch.Tensor:
    """One token through one block; the caches are updated in place."""
    if cfg.parallel_block:
        h = rms_norm(x, p.ln1, cfg.norm_eps)
        a = attn_decode(h, p.attn, cfg, cache_k, cache_v, pos)
        return x + a + swiglu_mlp(h, p.mlp)
    x = x + attn_decode(rms_norm(x, p.ln1, cfg.norm_eps), p.attn, cfg, cache_k, cache_v, pos)
    return x + swiglu_mlp(rms_norm(x, p.ln2, cfg.norm_eps), p.mlp)
