"""Per-layer blocks of every model family: parameter modules,
initializers and forward functions.

Counterpart of :mod:`repro.models.blocks`: the dense (and shared
attention) block, the MoE block, the Mamba2 block and Whisper's
encoder and decoder blocks.  Parameters live in small
:class:`torch.nn.Module` containers whose attribute names are the
reference's dict keys (``attn.wq``, ``mlp.w_gate``, ``moe.w_router``,
``ln1.scale``, ...), so a state dict maps one to one onto the
reference's parameter tree; the forward functions are plain functions on
tensors, as in the reference.  Of the reference's sharding hints one
stands: the attention batch layout at the attention's boundary
(:func:`attn_forward`, where the reference pins ``attn_batch``), which
without active rules and a mesh returns its input unchanged, so every
one-device path keeps its bits.  The others (``lc``) are dropped: the
port places state, not activations
(:func:`repro_torch.training.step.make_sharded_train_step`), and a block
of any family under tensor parallelism (``tp``, a
:class:`~repro_torch.distributed.sharding.ModelSplit`) computes the
rank's share of what GSPMD splits under them; an MoE block on a mesh
also takes the rank's place in the batch (``shard``), since its
dispatch groups are the global batch's.  Each
``*_axes`` function gives its block's leaves' logical axes, keyed as the
block's parameters, as the reference's does.
The float32 leaves of the reference (``moe.w_router``, the Mamba
block's ``conv_*``, ``dt_bias``, ``a_log`` and ``d_skip``) stay float32
at any ``param_dtype``.

Initialization draws float32 normals from an explicit
:class:`torch.Generator` on its own device (or, without one, makes
``meta`` tensors of the same shapes and dtypes for a dry run), scales
them and casts to the parameter dtype, tensor by tensor, with the
reference's shapes and scales; the values differ from the reference's
(another RNG), so parity tests carry the reference's weights across with
:func:`repro_torch.convert.lm_params_from_arrays`.
"""

from __future__ import annotations

import math
import types

import torch
from torch import nn

from repro_torch.distributed.sharding import attn_batch_split
from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    apply_rope_columns,
    gelu_mlp,
    layer_norm,
    rms_norm,
    swiglu_mlp,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import mamba2_decode, mamba2_forward


def _draw_device(generator: torch.Generator | None) -> torch.device:
    """Where parameters are drawn: on the generator's device, or on
    ``meta`` (shapes and dtypes, no data) without a generator."""
    return torch.device("meta") if generator is None else generator.device


def _normal(generator: torch.Generator, shape, dtype: torch.dtype, std: float) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=_draw_device(generator),
                    dtype=torch.float32)
    return (x.mul_(std)).to(dtype)


def _param(x: torch.Tensor) -> nn.Parameter:
    # frozen by default (serving runs under torch.inference_mode); training
    # turns gradients on with LanguageModel.requires_grad_()
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


class MoE(nn.Module):
    """``w_router`` (d, E) float32; ``w_gate``/``w_up`` (E, d, f),
    ``w_down`` (E, f, d)."""

    def __init__(self, w_router, w_gate, w_up, w_down):
        super().__init__()
        self.w_router, self.w_gate, self.w_up, self.w_down = map(
            _param, (w_router, w_gate, w_up, w_down))


class MoEBlock(nn.Module):
    def __init__(self, ln1, attn: Attention, ln2, moe: MoE):
        super().__init__()
        self.ln1, self.ln2 = _param(ln1), _param(ln2)
        self.attn, self.moe = attn, moe


# the Mamba2 block's leaves, in the reference's order
MAMBA_LEAVES = ("ln", "w_z", "w_x", "w_bc", "w_dt", "conv_x_w", "conv_x_b", "conv_bc_w",
                "conv_bc_b", "dt_bias", "a_log", "d_skip", "norm_scale", "w_out")


class MambaBlock(nn.Module):
    """A Mamba2 block: ``ln`` (d,), the split in-projection ``w_z``/``w_x``
    (d, d_in), ``w_bc`` (d, 2GN), ``w_dt`` (d, H); the float32 conv
    ``conv_x_w`` (K, d_in), ``conv_x_b``, ``conv_bc_w`` (K, 2GN),
    ``conv_bc_b``; float32 ``dt_bias``, ``a_log``, ``d_skip`` (H,);
    ``norm_scale`` (d_in,) and ``w_out`` (d_in, d)."""

    def __init__(self, **leaves):
        super().__init__()
        if set(leaves) != set(MAMBA_LEAVES):
            raise ValueError(f"Mamba block leaves {sorted(leaves)}, want {sorted(MAMBA_LEAVES)}")
        for name in MAMBA_LEAVES:
            setattr(self, name, _param(leaves[name]))


class LayerNorm(nn.Module):
    def __init__(self, scale, bias):
        super().__init__()
        self.scale, self.bias = _param(scale), _param(bias)


class GeluMLP(nn.Module):
    def __init__(self, w_up, b_up, w_down, b_down):
        super().__init__()
        self.w_up, self.b_up, self.w_down, self.b_down = map(_param, (w_up, b_up, w_down, b_down))


class EncDecBlock(nn.Module):
    """Whisper's block: ``ln1``, ``attn``, ``ln2``, ``mlp`` (GELU, biases);
    a decoder block also has ``ln_x`` and the cross attention ``xattn``."""

    def __init__(self, ln1: LayerNorm, attn: Attention, ln2: LayerNorm, mlp: GeluMLP,
                 ln_x: LayerNorm | None = None, xattn: Attention | None = None):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp
        self.ln_x, self.xattn = ln_x, xattn


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def init_attn(generator: torch.Generator, cfg: ModelConfig, out_scale: float) -> Attention:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.p_dtype()
    norms = {}
    if cfg.qk_norm:
        norms = dict(q_norm=torch.ones(dh, dtype=dt, device=_draw_device(generator)),
                     k_norm=torch.ones(dh, dtype=dt, device=_draw_device(generator)))
    return Attention(
        _normal(generator, (d, h, dh), dt, d ** -0.5),
        _normal(generator, (d, kv, dh), dt, d ** -0.5),
        _normal(generator, (d, kv, dh), dt, d ** -0.5),
        _normal(generator, (h, dh, d), dt, out_scale * (h * dh) ** -0.5),
        **norms,
    )


def attn_axes(cfg: ModelConfig) -> dict:
    p = {
        "wq": ("embed", "q_heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("q_heads", "head_dim", "embed"),
    }
    if cfg.qk_norm:
        p["q_norm"] = (None,)
        p["k_norm"] = (None,)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, heads, dh = w.shape
    return (x @ w.reshape(d, heads * dh)).reshape(*x.shape[:-1], heads, dh)


def _qkv(x: torch.Tensor, p: Attention, cfg: ModelConfig, *, whole=None, cols=None):
    """q, k and v of ``x``.  ``whole`` (a head_dim shard to whole heads)
    is applied to each projection before the q/k norms; with ``cols`` (a
    :class:`~repro_torch.distributed.sharding.ModelSplit` in head_dim
    mode) the projections stay the rank's columns, whose norms take the
    mean square over ``"model"``."""
    q, k, v = _project(x, p.wq), _project(x, p.wk), _project(x, p.wv)
    if whole is not None:
        q, k, v = whole(q), whole(k), whole(v)
    if cfg.qk_norm:
        # rms_norm over head_dim per head, before RoPE
        q_norm, k_norm, mean_over = p.q_norm, p.k_norm, None
        if cols is not None:
            q_norm, k_norm = cols.head_dim_shard(q_norm), cols.head_dim_shard(k_norm)

            def mean_over(var):
                return cols.reduce(var) / cols.count

        q = rms_norm(q, q_norm, cfg.norm_eps, mean_over=mean_over)
        k = rms_norm(k, k_norm, cfg.norm_eps, mean_over=mean_over)
    return q, k, v


def _out(o: torch.Tensor, p: Attention) -> torch.Tensor:
    h, dh, d = p.wo.shape
    return o.reshape(*o.shape[:-2], h * dh) @ p.wo.reshape(h * dh, d)


def _leaves(p: Attention) -> dict:
    return {n: getattr(p, n) for n in ("wq", "wk", "wv", "wo", "q_norm", "k_norm")}


def _split_leaves(p: Attention, tp) -> types.SimpleNamespace:
    """The attention's leaves as a rank uses them under tensor parallelism
    ``tp`` (a :class:`~repro_torch.distributed.sharding.ModelSplit` whose
    attention is split): in heads mode the kv heads its q heads read, of
    K/V projections held whole; the q/k norms, of which each rank uses a
    part, with their gradients summed over ``"model"``."""
    leaves = _leaves(p)
    if tp.attn == "heads":
        leaves["wk"], leaves["wv"] = tp.take_kv(p.wk), tp.take_kv(p.wv)
    for n in ("q_norm", "k_norm"):
        if leaves[n] is not None:
            leaves[n] = tp.enter(leaves[n])
    return types.SimpleNamespace(**leaves)


def _partial(tp) -> bool:
    """Whether the attention's output is a rank's partial sum under
    tensor parallelism ``tp`` (None on one device)."""
    return tp is not None and tp.attn_partial


def attn_forward(x: torch.Tensor, p: Attention, cfg: ModelConfig, *,
                 positions: torch.Tensor, causal: bool = True, use_rope: bool = True,
                 tp=None):
    """Full-sequence attention.  Returns ``(out, (k, v))`` — k/v are the
    cache entries a prefill caller stores.

    Under the attention batch layout of the active rules and mesh
    (:func:`~repro_torch.distributed.sharding.attn_batch_split`), which
    only a train batch takes (no cell's prefill batch covers the data and
    model axes), the attention runs on this rank's share of the rows,
    ``out`` is gathered over the layout's axis and k/v, which no training
    caller keeps, are None.

    Under tensor parallelism ``tp`` whose attention is split (``x`` the
    region's input, after f), ``out`` is this rank's partial sum over
    ``"model"``: in heads mode its q heads over the kv heads they read
    (k/v those kv heads); in head_dim mode q, k and v are projected to
    the rank's columns and all-gathered to whole heads, the attention
    runs on every head (replicated over ``"model"``) and the rank keeps
    its columns of the output for ``wo`` (k/v whole)."""
    split = attn_batch_split()
    head_dim = _partial(tp) and tp.attn == "head_dim"
    if split is not None:
        if _partial(tp):
            raise ValueError("the attention batch layout over \"model\" with the attention's "
                             "leaves split there: its rules place them off the axis")
        if not torch.is_grad_enabled():
            raise NotImplementedError("the attention batch layout outside training: a "
                                      "prefill would need its k and v gathered")
        x, positions, leaves = split.enter(x, positions, _leaves(p))
        p = types.SimpleNamespace(**leaves)
    elif _partial(tp):
        p = _split_leaves(p, tp)
    q, k, v = _qkv(x, p, cfg, whole=tp.gather_columns if head_dim else None)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = attn_lib.flash_attention(
        q, k, v, causal=causal, window=cfg.sliding_window,
        p_dtype=torch.bfloat16 if cfg.attn_p_bf16 else None,
    )
    if head_dim:
        o = tp.head_dim_shard(o)
    if split is None:
        return _out(o, p), (k, v)
    return split.exit(_out(o, p)), None


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


def _rope_decode(q: torch.Tensor, k: torch.Tensor, pos_vec: torch.Tensor, cfg: ModelConfig,
                 tp=None):
    """RoPE of one decode step's q and k; under tensor parallelism ``tp``
    over more than one rank, each column's partner (``head_dim / 2`` away)
    comes from the rank that holds it."""
    if tp is None or tp.count == 1:
        return (apply_rope(q, pos_vec[:, None], cfg.rope_theta),
                apply_rope(k, pos_vec[:, None], cfg.rope_theta))
    h, first = q.shape[2], tp.index * q.shape[-1]
    partner = tp.rope_partner(torch.cat([q, k], dim=2))
    return tuple(apply_rope_columns(x, part, pos_vec[:, None], cfg.rope_theta, tp.head_dim, first)
                 for x, part in ((q, partner[:, :, :h]), (k, partner[:, :, h:])))


def _decode_columns(tp):
    """The split whose ``head_dim`` columns a decode step's attention
    holds (None where it computes whole heads); raises where the split
    puts q heads on ``"model"``, which no decode rule does."""
    cols = tp if _partial(tp) else None
    if cols is not None and cols.attn != "head_dim":
        raise NotImplementedError("a decode step with q heads on \"model\": the decode "
                                  "rules place head_dim there")
    return cols


def _decode_attention(q, cache_k, cache_v, pos_vec, cfg: ModelConfig, cols):
    """:func:`~repro_torch.models.attention.decode_attention` at the whole
    head's scale, the float32 scores summed over ``"model"`` where ``cols``
    holds a rank's columns."""
    return attn_lib.decode_attention(q, cache_k, cache_v, pos_vec, head_dim=cfg.head_dim,
                                     reduce_scores=None if cols is None else cols.reduce)


def attn_decode(x: torch.Tensor, p: Attention, cfg: ModelConfig, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos, *, tp=None, use_rope: bool = True) -> torch.Tensor:
    """One-token step; cache_k/v (B, S, KV, dh) are updated in place at
    each sequence's position; pos: () or (B,).  ``use_rope=False`` is
    Whisper's decoder step (no rotation).

    Under tensor parallelism ``tp`` in head_dim mode (the decode rules'),
    the rank's share: q, k and v are its columns of every head, the cache
    its columns (B, S, KV, dh / m); the q/k norms' mean squares and the
    float32 scores are summed over ``"model"``, RoPE takes the paired
    columns from the rank that holds them, the scale is the whole head's,
    and the output is the partial sum of ``wo``'s rows."""
    cols = _decode_columns(tp)
    b = x.shape[0]
    q, k, v = _qkv(x, p, cfg, cols=cols)
    pos_vec = pos_vector(pos, b, x.device)
    if use_rope:
        q, k = _rope_decode(q, k, pos_vec, cfg, cols)
    _cache_row_write(cache_k, k, pos_vec)
    _cache_row_write(cache_v, v, pos_vec)
    return _out(_decode_attention(q, cache_k, cache_v, pos_vec, cfg, cols), p)


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
    ones = torch.ones(d, dtype=dt, device=_draw_device(generator))
    return DenseBlock(ones, attn, ones.clone(), mlp)


def dense_block_axes(cfg: ModelConfig) -> dict:
    return {
        "ln1": (None,),
        "attn": attn_axes(cfg),
        "ln2": (None,),
        "mlp": {
            "w_gate": ("embed", "ff"),
            "w_up": ("embed", "ff"),
            "w_down": ("ff", "embed"),
        },
    }


def dense_block_forward(x: torch.Tensor, p: DenseBlock, cfg: ModelConfig,
                        positions: torch.Tensor, *, causal: bool = True, tp=None):
    """``(x + block(x), (k, v))``.  Under tensor parallelism ``tp`` (a
    :class:`~repro_torch.distributed.sharding.ModelSplit`) the MLP is
    Megatron's, f at its entry, ``w_gate``/``w_up`` column- and ``w_down``
    row-parallel, g at its exit, and so is a split attention (``wo``
    row-parallel); a parallel block's two branches share one f and one
    g."""
    return _dense_block(x, p, cfg, tp, lambda h: attn_forward(
        h, p.attn, cfg, positions=positions, causal=causal, tp=tp))


def _dense_block(x: torch.Tensor, p: DenseBlock, cfg: ModelConfig, tp, attention):
    """A dense block, or a rank's share of it under tensor parallelism
    ``tp``; ``attention(h)`` returns the attention's ``(out, kv)``, a
    partial sum where the attention is split.  Without ``tp``, f and g
    are the identity and the sums are the one-device block's."""
    def f(h):
        return h if tp is None else tp.enter(h)

    def g(h):
        return h if tp is None else tp.exit(h)

    if cfg.parallel_block:
        h = rms_norm(x, p.ln1, cfg.norm_eps)
        hf = f(h)
        if _partial(tp):
            a, kvc = attention(hf)
            return x + g(a + swiglu_mlp(hf, p.mlp)), kvc
        a, kvc = attention(h)
        return x + a + g(swiglu_mlp(hf, p.mlp)), kvc
    x, kvc = _attention_half(x, p, cfg, tp, attention)
    return x + g(swiglu_mlp(f(rms_norm(x, p.ln2, cfg.norm_eps)), p.mlp)), kvc


def _attention_half(x: torch.Tensor, p, cfg: ModelConfig, tp, attention, norm=None):
    """``x`` plus the attention of its norm, and the attention's kv: a
    sequential block's first half (dense, MoE, or with ``norm`` a
    Whisper block's LayerNorm in place of ``rms_norm`` with ``p.ln1``).
    ``attention(h)`` returns ``(out, kv)``, under a split attention a
    partial sum, which enters through f and leaves through g.  The norm's
    output is not held past the attention."""
    if norm is None:
        def norm(h):
            return rms_norm(h, p.ln1, cfg.norm_eps)

    if _partial(tp):
        a, kvc = attention(tp.enter(norm(x)))
        return x + tp.exit(a), kvc
    a, kvc = attention(norm(x))
    return x + a, kvc


def dense_block_decode(x: torch.Tensor, p: DenseBlock, cfg: ModelConfig,
                       cache_k: torch.Tensor, cache_v: torch.Tensor, pos, *,
                       tp=None) -> torch.Tensor:
    """One token through one block; the caches are updated in place.
    Under tensor parallelism ``tp``, the rank's share, as
    :func:`dense_block_forward`'s."""
    return _dense_block(x, p, cfg, tp, lambda h: (
        attn_decode(h, p.attn, cfg, cache_k, cache_v, pos, tp=tp), None))[0]


# --------------------------------------------------------------------------
# MoE decoder block
# --------------------------------------------------------------------------

def init_moe_block(generator: torch.Generator, cfg: ModelConfig) -> MoEBlock:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.p_dtype()
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    attn = init_attn(generator, cfg, out_scale)
    moe = MoE(
        _normal(generator, (d, e), torch.float32, d ** -0.5),
        _normal(generator, (e, d, f), dt, d ** -0.5),
        _normal(generator, (e, d, f), dt, d ** -0.5),
        _normal(generator, (e, f, d), dt, out_scale * f ** -0.5),
    )
    ones = torch.ones(d, dtype=dt, device=_draw_device(generator))
    return MoEBlock(ones, attn, ones.clone(), moe)


def moe_block_axes(cfg: ModelConfig) -> dict:
    ep = cfg.moe_parallel == "ep"
    ff_axis = None if ep else "ff"      # EP: the rules map "expert" to "model"
    return {
        "ln1": (None,),
        "attn": attn_axes(cfg),
        "ln2": (None,),
        "moe": {
            "w_router": ("embed", None),
            "w_gate": ("expert", "embed", ff_axis),
            "w_up": ("expert", "embed", ff_axis),
            "w_down": ("expert", ff_axis, "embed"),
        },
    }


def moe_block_forward(x: torch.Tensor, p: MoEBlock, cfg: ModelConfig, positions: torch.Tensor,
                      *, tp=None, shard=None):
    """Returns ``(out, aux, (k, v))``: the reference's ``(out, aux)`` and
    the attention's k/v, the cache entries of a prefill.  The FFN
    dispatches the reference's ``dispatch_groups`` groups of the batch,
    of which ``x`` is the share ``shard`` on a mesh (aux then the rank's
    share of the batch's).  Under tensor parallelism ``tp`` the attention
    is :func:`dense_block_forward`'s and the experts compute the rank's
    share (:mod:`repro_torch.models.moe`)."""
    x, kvc = _attention_half(x, p, cfg, tp, lambda h: attn_forward(
        h, p.attn, cfg, positions=positions, tp=tp))
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    b, s, d = h.shape
    y, aux = moe_ffn(h.reshape(b * s, d), p.moe, n_experts=cfg.n_experts, top_k=cfg.top_k,
                     groups=cfg.dispatch_groups, shard=shard, tp=tp)
    return x + y.reshape(b, s, d), aux, kvc


def moe_block_decode(x: torch.Tensor, p: MoEBlock, cfg: ModelConfig, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, *, tp=None, shard=None) -> torch.Tensor:
    """One token through one MoE block: flat dispatch of the whole batch
    (of which ``x`` is the share ``shard`` on a mesh) at capacity factor
    2, as the reference decodes; the caches are updated in place.  Under
    tensor parallelism ``tp``, the rank's share, as
    :func:`moe_block_forward`'s."""
    x, _ = _attention_half(x, p, cfg, tp, lambda h: (
        attn_decode(h, p.attn, cfg, cache_k, cache_v, pos, tp=tp), None))
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    b, _, d = h.shape
    y, _ = moe_ffn(h.reshape(b, d), p.moe, n_experts=cfg.n_experts, top_k=cfg.top_k,
                   capacity_factor=2.0, shard=shard, tp=tp)
    return x + y.reshape(b, 1, d)


# --------------------------------------------------------------------------
# Mamba2 block (ssm / hybrid families)
# --------------------------------------------------------------------------

def _uniform(generator: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=_draw_device(generator),
                   dtype=torch.float32)
    return u.mul_(hi - lo).add_(lo)


def init_mamba_block(generator: torch.Generator, cfg: ModelConfig) -> MambaBlock:
    d, d_in = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    dt, f32 = cfg.p_dtype(), torch.float32
    dev = _draw_device(generator)
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    # dt_bias = softplus^-1(dt0), dt0 log-uniform in [1e-3, 1e-1]
    dt0 = torch.exp(_uniform(generator, (h,), math.log(1e-3), math.log(1e-1)))
    return MambaBlock(
        ln=torch.ones(d, dtype=dt, device=dev),
        w_z=_normal(generator, (d, d_in), dt, d ** -0.5),
        w_x=_normal(generator, (d, d_in), dt, d ** -0.5),
        w_bc=_normal(generator, (d, 2 * g * n), dt, d ** -0.5),
        w_dt=_normal(generator, (d, h), dt, d ** -0.5),
        conv_x_w=_normal(generator, (cfg.ssm_conv, d_in), f32, d_in ** -0.5),
        conv_x_b=torch.zeros(d_in, dtype=f32, device=dev),
        conv_bc_w=_normal(generator, (cfg.ssm_conv, 2 * g * n), f32, (2 * g * n) ** -0.5),
        conv_bc_b=torch.zeros(2 * g * n, dtype=f32, device=dev),
        dt_bias=torch.log(torch.expm1(dt0)),
        a_log=torch.log(1.0 + 15.0 * _uniform(generator, (h,), 0.0, 1.0)),
        d_skip=torch.ones(h, dtype=f32, device=dev),
        norm_scale=torch.ones(d_in, dtype=dt, device=dev),
        w_out=_normal(generator, (d_in, d), dt, out_scale * d_in ** -0.5),
    )


def mamba_block_axes(cfg: ModelConfig) -> dict:
    return {
        "ln": (None,),
        "w_z": ("embed", "inner"),
        "w_x": ("embed", "inner"),
        "w_bc": ("embed", None),
        "w_dt": ("embed", None),
        "conv_x_w": (None, "inner"),
        "conv_x_b": ("inner",),
        "conv_bc_w": (None, None),
        "conv_bc_b": (None,),
        "dt_bias": (None,),
        "a_log": (None,),
        "d_skip": (None,),
        "norm_scale": ("inner",),
        "w_out": ("inner", "embed"),
    }


def mamba_block_forward(x: torch.Tensor, p: MambaBlock, cfg: ModelConfig, *, tp=None):
    """Returns (x + Mamba2(rms_norm(x)), final ssm state).  Under tensor
    parallelism ``tp`` the rank's share (:mod:`repro_torch.models.ssm`):
    the state of its SSM heads, the block's output whole."""
    y, state = mamba2_forward(rms_norm(x, p.ln, cfg.norm_eps), p, cfg, tp=tp)
    return x + y, state


def mamba_conv_tail(x: torch.Tensor, p: MambaBlock, cfg: ModelConfig, *,
                    tp=None) -> torch.Tensor:
    """The decode conv window a prefill leaves: the pre-conv ``[x | B C]``
    in-projections of the last K-1 tokens of the block's input ``x``.
    Under tensor parallelism ``tp`` the rank's ``inner`` columns of x are
    gathered over ``"model"``: the window is replicated there."""
    tail = rms_norm(x[:, -(cfg.ssm_conv - 1):, :], p.ln, cfg.norm_eps)
    xs = tail @ p.w_x
    if tp is not None and tp.ssm_partial:
        xs = tp.gather_columns(xs)
    return torch.cat([xs, tail @ p.w_bc], dim=-1)


def mamba_block_decode(x: torch.Tensor, p: MambaBlock, cfg: ModelConfig,
                       conv_state: torch.Tensor, ssm_state: torch.Tensor, *, tp=None):
    """Returns (out, new conv_state, new ssm_state); under tensor
    parallelism ``tp`` the rank's share, as :func:`mamba_block_forward`'s."""
    y, conv_state, ssm_state = mamba2_decode(rms_norm(x, p.ln, cfg.norm_eps), p, cfg,
                                             conv_state, ssm_state, tp=tp)
    return x + y, conv_state, ssm_state


# --------------------------------------------------------------------------
# Whisper-style encoder / decoder blocks (LayerNorm, biases, GELU)
# --------------------------------------------------------------------------

def _init_ln(d: int, dt: torch.dtype, device) -> LayerNorm:
    return LayerNorm(torch.ones(d, dtype=dt, device=device),
                     torch.zeros(d, dtype=dt, device=device))


def init_encdec_block(generator: torch.Generator, cfg: ModelConfig, *,
                      cross: bool) -> EncDecBlock:
    d, f = cfg.d_model, cfg.d_ff
    dt, dev = cfg.p_dtype(), _draw_device(generator)
    out_scale = 1.0 / math.sqrt(2 * (cfg.n_layers + cfg.n_enc_layers))
    attn = init_attn(generator, cfg, out_scale)
    mlp = GeluMLP(
        _normal(generator, (d, f), dt, d ** -0.5),
        torch.zeros(f, dtype=dt, device=dev),
        _normal(generator, (f, d), dt, out_scale * f ** -0.5),
        torch.zeros(d, dtype=dt, device=dev),
    )
    cross_parts = {}
    if cross:
        cross_parts = dict(ln_x=_init_ln(d, dt, dev), xattn=init_attn(generator, cfg, out_scale))
    return EncDecBlock(_init_ln(d, dt, dev), attn, _init_ln(d, dt, dev), mlp, **cross_parts)


def encdec_block_axes(cfg: ModelConfig, *, cross: bool) -> dict:
    ln = {"scale": (None,), "bias": (None,)}
    p = {
        "ln1": dict(ln),
        "attn": attn_axes(cfg),
        "ln2": dict(ln),
        "mlp": {
            "w_up": ("embed", "ff"),
            "b_up": ("ff",),
            "w_down": ("ff", "embed"),
            "b_down": (None,),
        },
    }
    if cross:
        p["ln_x"] = dict(ln)
        p["xattn"] = attn_axes(cfg)
    return p


def _ln(x: torch.Tensor, p: LayerNorm, cfg: ModelConfig) -> torch.Tensor:
    return layer_norm(x, p.scale, p.bias, cfg.norm_eps)


def _gelu_half(x: torch.Tensor, p: EncDecBlock, cfg: ModelConfig, tp) -> torch.Tensor:
    """``x`` plus the GELU MLP of its LayerNorm: a Whisper block's last
    half.  Under tensor parallelism ``tp`` the MLP is Megatron's, f at its
    entry, ``w_up``/``b_up`` column- and ``w_down`` row-parallel, g before
    ``b_down`` (:func:`~repro_torch.models.layers.gelu_mlp`)."""
    h = _ln(x, p.ln2, cfg)
    if tp is None:
        return x + gelu_mlp(h, p.mlp)
    return x + gelu_mlp(tp.enter(h), p.mlp, exit=tp.exit)


def encoder_block_forward(x: torch.Tensor, p: EncDecBlock, cfg: ModelConfig,
                          positions: torch.Tensor, *, tp=None) -> torch.Tensor:
    """Bidirectional self-attention without RoPE (K8, non-causal), then the
    GELU MLP; under tensor parallelism ``tp`` the rank's share, the
    attention as :func:`dense_block_forward`'s."""
    x, _ = _attention_half(x, p, cfg, tp, lambda h: attn_forward(
        h, p.attn, cfg, positions=positions, causal=False, use_rope=False, tp=tp),
        norm=lambda h: _ln(h, p.ln1, cfg))
    return _gelu_half(x, p, cfg, tp)


def cross_source(enc_out: torch.Tensor, tp=None) -> torch.Tensor:
    """The encoder's output as every decoder layer's cross K/V projection
    reads it.  Under tensor parallelism ``tp`` whose attention is split,
    each layer's projection is column-parallel and gives ``enc_out`` a
    rank's share of its gradient: ``enc_out`` enters through one f here,
    where it leaves the encoder, whose backward sums the layers' shares
    over ``"model"`` once (an f at each layer's projection as well would
    sum them ``count`` times)."""
    return tp.enter(enc_out) if _partial(tp) else enc_out


def encdec_cross_kv(p: Attention, cfg: ModelConfig, enc_out: torch.Tensor, *, tp=None):
    """The cross K/V (B, T, KV, dh) of ``enc_out`` (:func:`cross_source`'s
    output).  Under tensor parallelism ``tp`` whose attention is split the
    rank's: in heads mode its kv heads, whole; in head_dim mode its columns
    of every kv head, gathered to whole heads."""
    if not _partial(tp):
        return _project(enc_out, p.wk), _project(enc_out, p.wv)
    leaves = _split_leaves(p, tp)
    k, v = _project(enc_out, leaves.wk), _project(enc_out, leaves.wv)
    if tp.attn == "head_dim":
        k, v = tp.gather_columns(k), tp.gather_columns(v)
    return k, v


def cross_attn(x: torch.Tensor, p: Attention, cfg: ModelConfig, enc_k: torch.Tensor,
               enc_v: torch.Tensor, *, tp=None) -> torch.Tensor:
    """Cross attention over precomputed encoder K/V (B, T, KV, dh): K8,
    non-causal, S decoder rows against T encoder keys.  Under tensor
    parallelism ``tp`` whose attention is split (``x`` after f, ``enc_k``
    and ``enc_v`` :func:`encdec_cross_kv`'s), the rank's partial sum of
    ``wo``'s rows: in heads mode its q heads over the kv heads they read;
    in head_dim mode q gathered to whole heads, the attention on every
    head and the rank's columns of its output kept for ``wo``."""
    head_dim = _partial(tp) and tp.attn == "head_dim"
    q = _project(x, p.wq)
    if head_dim:
        q = tp.gather_columns(q)
    o = attn_lib.flash_attention(q, enc_k, enc_v, causal=False)
    if head_dim:
        o = tp.head_dim_shard(o)
    return _out(o, p)


def decoder_block_forward(x: torch.Tensor, p: EncDecBlock, cfg: ModelConfig,
                          positions: torch.Tensor, enc_out: torch.Tensor, *, tp=None):
    """Causal self-attention (no RoPE), cross attention over ``enc_out``
    (:func:`cross_source`'s output), the GELU MLP.  Returns (out, (k, v))
    of the self-attention.  Under tensor parallelism ``tp`` the rank's
    share: each attention's input enters through f and its partial sum
    leaves through g, the self-attention's k/v and the cross K/V are its
    heads' or (head_dim mode) whole heads."""
    x, kvc = _attention_half(x, p, cfg, tp, lambda h: attn_forward(
        h, p.attn, cfg, positions=positions, causal=True, use_rope=False, tp=tp),
        norm=lambda h: _ln(h, p.ln1, cfg))
    xk, xv = encdec_cross_kv(p.xattn, cfg, enc_out, tp=tp)
    x, _ = _attention_half(x, p, cfg, tp, lambda h: (
        cross_attn(h, p.xattn, cfg, xk, xv, tp=tp), None), norm=lambda h: _ln(h, p.ln_x, cfg))
    return _gelu_half(x, p, cfg, tp), kvc


def decoder_block_decode(x: torch.Tensor, p: EncDecBlock, cfg: ModelConfig,
                         cache_k: torch.Tensor, cache_v: torch.Tensor, xk: torch.Tensor,
                         xv: torch.Tensor, pos, *, tp=None) -> torch.Tensor:
    """One decoder token: the self cache written in place at each
    sequence's position (no RoPE, no qk-norm, as the reference's step),
    then cross attention over every encoder row.  Under tensor
    parallelism ``tp`` in head_dim mode (the decode rules') the rank's
    share: q, k and v its columns of every head, both caches its columns,
    each attention's float32 scores summed over ``"model"`` at the whole
    head's scale, each output a partial sum of ``wo``'s rows (g)."""
    x, _ = _attention_half(x, p, cfg, tp, lambda h: (
        attn_decode(h, p.attn, cfg, cache_k, cache_v, pos, tp=tp, use_rope=False), None),
        norm=lambda h: _ln(h, p.ln1, cfg))
    cols = _decode_columns(tp)
    b = x.shape[0]
    # every encoder row: the last valid key is row T - 1
    last = torch.full((b,), xk.shape[1] - 1, dtype=torch.int64, device=x.device)
    x, _ = _attention_half(x, p, cfg, tp, lambda h: (_out(_decode_attention(
        _project(h, p.xattn.wq), xk, xv, last, cfg, cols), p.xattn), None),
        norm=lambda h: _ln(h, p.ln_x, cfg))
    return _gelu_half(x, p, cfg, tp)
