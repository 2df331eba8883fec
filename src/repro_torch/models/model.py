"""The dense decoder: initialization, prefill, decode and accounting.

Counterpart of the dense part of :mod:`repro.models.model`.  The
reference scans over layer-stacked parameters; here the decoder is an
:class:`torch.nn.Module` holding one :class:`~repro_torch.models.blocks.
DenseBlock` per layer, and the scan is a Python loop.  State-dict names
are the reference's tree with the layer axis unstacked
(``blocks.{i}.attn.wq`` for ``blocks.attn.wq[i]``).  ``jax.checkpoint``
(training only) and the sharding hints are dropped.

The serving functions run under :func:`torch.inference_mode`.  Unlike
the reference, which returns new caches, they write the KV cache in
place and return it.  Other families than ``dense`` raise
:class:`NotImplementedError` naming their ROADMAP item.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_tokens, rms_norm, unembed

# where each family's port stands in ROADMAP.md, Queue 1
_UNPORTED = {
    "vlm": "12.2 (VLM prefill: patches plus the dense decoder)",
    "moe": "12.3 (MoE, models/moe.py)",
    "ssm": "12.4 (SSM and hybrid, models/ssm.py)",
    "hybrid": "12.4 (SSM and hybrid, models/ssm.py)",
    "encdec": "12.5 (encoder-decoder)",
}


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        item = _UNPORTED.get(cfg.family)
        if item is None:
            raise ValueError(f"unknown model family {cfg.family!r}")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch_id}) is not ported yet: "
            f"ROADMAP Queue 1 item {item}")


class DenseDecoder(nn.Module):
    """Parameters of a dense decoder: ``embed`` (vocab_padded, d),
    ``final_norm`` (d,), ``lm_head`` (d, vocab_padded) unless
    ``tie_embeddings``, and ``blocks`` (one DenseBlock per layer)."""

    def __init__(self, embed, final_norm, blocks, lm_head=None):
        super().__init__()
        self.embed = B._param(embed)
        self.final_norm = B._param(final_norm)
        self.lm_head = None if lm_head is None else B._param(lm_head)
        self.blocks = nn.ModuleList(blocks)


# ===========================================================================
# parameter initialization
# ===========================================================================

def init_params(cfg: ModelConfig, generator: torch.Generator, *, device=None) -> DenseDecoder:
    """Random parameters at ``cfg``'s shapes and the reference's scales.

    ``generator`` must live on ``device`` (default ``"cuda"``): every
    tensor is drawn there, one at a time, so a full-size model never
    holds more than one float32 tensor beside its parameters.
    """
    _require_dense(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters go to {dev}: "
                         "pass a generator of the target device")
    dt = cfg.p_dtype()
    d = cfg.d_model
    embed = B._normal(generator, (cfg.vocab_padded, d), dt, 0.02)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = B._normal(generator, (d, cfg.vocab_padded), dt, 0.02)
    blocks = [B.init_dense_block(generator, cfg) for _ in range(cfg.n_layers)]
    return DenseDecoder(embed, torch.ones(d, dtype=dt, device=dev), blocks, lm_head)


def _device_of(params: DenseDecoder) -> torch.device:
    return params.embed.device


def _logits(params: DenseDecoder, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    table = params.embed.T if cfg.tie_embeddings else params.lm_head
    return unembed(x, table)


# ===========================================================================
# serving: prefill + decode
# ===========================================================================

def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device=None) -> dict:
    """Zero KV caches ``{"k", "v"}`` of shape (n_layers, batch, max_seq,
    KV, dh) in the activation dtype."""
    _require_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.act_dtype(), device=dev),
            "v": torch.zeros(shape, dtype=cfg.act_dtype(), device=dev)}


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).to(torch.int64)


@torch.inference_mode()
def prefill_into(params: DenseDecoder, tokens, cfg: ModelConfig, cache: dict,
                 slot: int = 0) -> torch.Tensor:
    """Prefill ``tokens`` (B, S) into rows ``slot .. slot + B`` of
    ``cache``, in place: cache rows [0, S) take the prompt's K/V and rows
    [S, max_seq) are zeroed, as the reference's padded prefill cache
    does.  Returns the last-token logits (B, vocab_padded)."""
    _require_dense(cfg)
    dev = _device_of(params)
    tokens = _tokens(tokens, dev)
    bsz, s = tokens.shape
    max_seq = cache["k"].shape[2]
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens does not fit max_seq={max_seq}")
    x = embed_tokens(tokens, params.embed)
    positions = torch.arange(s, device=dev).expand(bsz, s)
    rows = slice(slot, slot + bsz)
    for i, p in enumerate(params.blocks):
        x, (k, v) = B.dense_block_forward(x, p, cfg, positions)
        for name, new in (("k", k), ("v", v)):
            cache[name][i, rows, :s] = new
            cache[name][i, rows, s:] = 0
    return _logits(params, cfg, x[:, -1:, :])[:, 0, :]


def prefill(params: DenseDecoder, batch: dict, cfg: ModelConfig, max_seq: int):
    """Full-sequence prefill building the decode cache.

    ``batch["tokens"]`` (B, S).  Returns (last-token logits
    (B, vocab_padded), cache padded to ``max_seq``).
    """
    tokens = batch["tokens"]
    cache = init_decode_cache(cfg, len(tokens), max_seq, device=_device_of(params))
    logits = prefill_into(params, tokens, cfg, cache)
    return logits, cache


@torch.inference_mode()
def decode_step(params: DenseDecoder, token, pos, cache: dict, cfg: ModelConfig):
    """One token for every sequence.  Returns (logits (B, vocab_padded),
    cache), the cache updated in place.

    ``pos`` may be a scalar (every sequence at the same length) or a
    per-sequence (B,) vector: each slot writes its KV row, rotates its
    query and masks its keys at its own position.
    """
    _require_dense(cfg)
    dev = _device_of(params)
    token = _tokens(token, dev)
    pos_vec = B.pos_vector(pos, token.shape[0], dev)
    x = embed_tokens(token, params.embed)
    for i, p in enumerate(params.blocks):
        x = B.dense_block_decode(x, p, cfg, cache["k"][i], cache["v"][i], pos_vec)
    return _logits(params, cfg, x)[:, 0, :], cache


# ===========================================================================
# accounting
# ===========================================================================

def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def count_flop_params(params: DenseDecoder, cfg: ModelConfig) -> int:
    """Parameters without the embedding table (a lookup, not a product;
    the LM head product is counted).  Dense: every parameter is active."""
    _require_dense(cfg)
    return count_params(params) - params.embed.numel()


def model_flops(params: DenseDecoder, cfg: ModelConfig, n_tokens: int, *,
                train: bool = True) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N = non-embedding
    parameters."""
    return (6.0 if train else 2.0) * count_flop_params(params, cfg) * n_tokens
