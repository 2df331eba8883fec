"""Top-level models of every family: initialization, the train forward,
prefill, decode and accounting.

Counterpart of :mod:`repro.models.model`.  The reference scans over
layer-stacked parameters; here a model is one :class:`LanguageModel`
holding one block module per layer, and the scan is a Python loop.
State-dict names are the reference's tree with the layer axis unstacked
(``blocks.{i}.attn.wq`` for ``blocks.attn.wq[i]``); the top-level keys
are the reference's: ``embed``, ``final_norm``, ``lm_head`` (unless
``tie_embeddings``), and ``blocks`` (dense, vlm, moe, ssm, hybrid),
``shared_attn`` (hybrid), ``enc_blocks``/``dec_blocks``/``enc_final_norm``
(encdec).  The sharding hints are dropped.  :func:`forward_train` runs
every block under ``torch.utils.checkpoint`` as the reference runs it
under ``jax.checkpoint`` (``ModelConfig.remat_policy``).

The families, as the reference runs them:

* ``dense``: a stack of :class:`~repro_torch.models.blocks.DenseBlock`.
* ``vlm`` (InternVL2): the dense stack over ``batch["patches"]``
  (B, n_patches, d), precomputed patch embeddings, prepended to the text;
  a decode position counts the patches.
* ``moe``: attention plus a sort-dispatched MoE FFN per layer
  (:mod:`repro_torch.models.moe`); decode dispatches flat at capacity
  factor 2.  The decode step ignores ``sliding_window`` (the reference's
  does too), so Mixtral's decode attends to the whole cache.
* ``ssm`` (Mamba2): Mamba2 blocks; the cache is the conv window and the
  SSD state.  A prompt longer than ``ssm_chunk`` must be a multiple of
  it, and at least ``ssm_conv - 1`` tokens long (:class:`ValueError`).
* ``hybrid`` (Zamba2): one weight-shared dense block applied before every
  group of ``attn_every`` Mamba blocks, then the leftover Mamba blocks;
  one KV cache per application.
* ``encdec`` (Whisper): an encoder over ``batch["frames"]`` (B, enc_len,
  d) plus sinusoids, and a decoder with self and cross attention; the
  cache holds the decoder's self K/V and each layer's cross K/V.

The serving functions run under :func:`torch.inference_mode`.  Unlike
the reference, which returns new caches, they write the cache in place
and return it.  Every prefill's attention runs K8 on the card.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve_device
from repro_torch.kernels.build import uncounted
from repro_torch.models import blocks as B
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    embed_tokens,
    rms_norm,
    sinusoid_position_at,
    sinusoid_positions,
    unembed,
)
from repro_torch.models.ssm import check_chunk

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
# the subtrees the reference stacks on a leading layer axis; here each
# layer is its own module, named ``blocks.{i}`` and so on
STACKED = ("blocks", "enc_blocks", "dec_blocks")


class LanguageModel(nn.Module):
    """Parameters of a model of any family: ``embed`` (vocab_padded, d),
    ``final_norm`` (d,), ``lm_head`` (d, vocab_padded) unless
    ``tie_embeddings``; ``blocks`` (one block per layer), ``shared_attn``
    (hybrid), ``enc_blocks``, ``dec_blocks`` and ``enc_final_norm``
    (encdec), each None where the family has none."""

    def __init__(self, embed, final_norm, blocks=None, lm_head=None, *, shared_attn=None,
                 enc_blocks=None, dec_blocks=None, enc_final_norm=None):
        super().__init__()
        self.embed = B._param(embed)
        self.final_norm = B._param(final_norm)
        self.lm_head = None if lm_head is None else B._param(lm_head)
        self.blocks = None if blocks is None else nn.ModuleList(blocks)
        self.shared_attn = shared_attn
        self.enc_blocks = None if enc_blocks is None else nn.ModuleList(enc_blocks)
        self.dec_blocks = None if dec_blocks is None else nn.ModuleList(dec_blocks)
        self.enc_final_norm = None if enc_final_norm is None else B._param(enc_final_norm)
        # a rank's tensor parallelism over "model" and its share of the
        # batch (gather_params), None on one device
        self.split = None
        self.batch_shard = None


# the dense decoder's name since the first LM slice
DenseDecoder = LanguageModel


def family_of(cfg: ModelConfig) -> str:
    """``cfg.family``, raising on a family the models do not know."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}: expected one of {FAMILIES}")
    return cfg.family


def hybrid_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(shared-attention applications, trailing Mamba blocks) of a hybrid."""
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.n_layers - g * cfg.attn_every


# ===========================================================================
# parameter initialization
# ===========================================================================

def init_params(cfg: ModelConfig, generator: torch.Generator | None, *,
                device=None) -> LanguageModel:
    """Random parameters at ``cfg``'s shapes, dtypes and the reference's
    scales.

    ``generator`` must live on ``device`` (default ``"cuda"``): every
    tensor is drawn there, one at a time, so a full-size model never
    holds more than one float32 tensor beside its parameters.  On
    ``device="meta"`` (a dry run) the parameters are shapes and dtypes
    without data and ``generator`` must be None.
    """
    family = family_of(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        if generator is not None:
            raise ValueError("meta parameters are drawn from no generator: pass None")
    elif generator is None or generator.device.type != dev.type:
        raise ValueError(f"generator is on {getattr(generator, 'device', None)}, parameters "
                         f"go to {dev}: pass a generator of the target device")
    dt = cfg.p_dtype()
    d = cfg.d_model
    embed = B._normal(generator, (cfg.vocab_padded, d), dt, 0.02)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = B._normal(generator, (d, cfg.vocab_padded), dt, 0.02)
    parts: dict = {}
    if family in ("dense", "vlm"):
        parts["blocks"] = [B.init_dense_block(generator, cfg) for _ in range(cfg.n_layers)]
    elif family == "moe":
        parts["blocks"] = [B.init_moe_block(generator, cfg) for _ in range(cfg.n_layers)]
    elif family in ("ssm", "hybrid"):
        parts["blocks"] = [B.init_mamba_block(generator, cfg) for _ in range(cfg.n_layers)]
        if family == "hybrid":
            parts["shared_attn"] = B.init_dense_block(generator, cfg)
    else:
        parts["enc_blocks"] = [B.init_encdec_block(generator, cfg, cross=False)
                               for _ in range(cfg.n_enc_layers)]
        parts["dec_blocks"] = [B.init_encdec_block(generator, cfg, cross=True)
                               for _ in range(cfg.n_layers)]
        parts["enc_final_norm"] = torch.ones(d, dtype=dt, device=dev)
    return LanguageModel(embed, torch.ones(d, dtype=dt, device=dev), lm_head=lm_head, **parts)


def _flat_axes(tree: dict, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_axes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def param_logical_axes(cfg: ModelConfig) -> dict[str, tuple]:
    """Each parameter's logical axes, keyed by its state-dict name (the
    counterpart of ``repro/models/model.py:78``): the reference's leaf
    axes, without the leading ``"layers"`` of the subtrees the port holds
    one module per layer (:data:`STACKED`)."""
    family = family_of(cfg)
    axes: dict = {"embed": ("vocab", "embed"), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")

    def per_layer(name: str, block: dict, n: int) -> None:
        for i in range(n):
            axes[f"{name}.{i}"] = block

    if family in ("dense", "vlm"):
        per_layer("blocks", B.dense_block_axes(cfg), cfg.n_layers)
    elif family == "moe":
        per_layer("blocks", B.moe_block_axes(cfg), cfg.n_layers)
    elif family in ("ssm", "hybrid"):
        per_layer("blocks", B.mamba_block_axes(cfg), cfg.n_layers)
        if family == "hybrid":
            axes["shared_attn"] = B.dense_block_axes(cfg)
    else:
        per_layer("enc_blocks", B.encdec_block_axes(cfg, cross=False), cfg.n_enc_layers)
        per_layer("dec_blocks", B.encdec_block_axes(cfg, cross=True), cfg.n_layers)
        axes["enc_final_norm"] = (None,)
    return _flat_axes(axes, "")


def cache_logical_axes(cfg: ModelConfig) -> dict[str, tuple]:
    """Logical axes of the decode cache, keyed as :func:`init_decode_cache`
    (the counterpart of ``repro/models/model.py:491``; the cache keeps the
    reference's leading layer axis)."""
    family = family_of(cfg)
    attn = ("layers", "batch", "seq", "kv_heads", "head_dim")
    if family in ("dense", "moe", "vlm"):
        return {"k": attn, "v": attn}
    ssm = {"conv": ("layers", "batch", None, None),
           "ssm": ("layers", "batch", "ssm_heads", None, "state")}
    if family == "ssm":
        return ssm
    if family == "hybrid":
        return {**ssm, "k": attn, "v": attn}
    return {"k": attn, "v": attn, "xk": attn, "xv": attn}


def _model_split(cfg: ModelConfig, sharded: dict, local: dict):
    """The rank's :class:`~repro_torch.distributed.sharding.ModelSplit`
    from how the rules placed the leaves on the mesh (``wq``'s dimension
    on ``"model"``, a hybrid's shared block's or an encdec's first decoder
    block's, gives the attention's mode, ``wk``'s whether kv heads are
    split, an MoE's ``w_gate``'s whether its experts or their ``ff``
    columns are, a Mamba block's ``w_x``'s whether its ``inner`` columns
    are) and its local shards' sizes; None on a mesh without a ``"model"``
    axis.  A model without attention (Mamba2) has the mode ``"none"``.  A
    vlm's blocks are dense blocks and need no field of their own; an
    encdec's ``ff`` is read from its GELU MLP's ``w_up``.  A split the
    port cannot follow raises :class:`NotImplementedError`: an encdec
    whose encoder self-attention, decoder self-attention and cross
    attention the rules place differently, ``inner`` on the axis while
    the SSM heads do not divide it (a rank's columns would cut across
    heads), or a rank's heads that neither hold whole groups of B and C
    nor lie in one."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.sharding import ModelSplit

    mesh = sharded["embed"].device_mesh
    names = mesh.mesh_dim_names
    if "model" not in names:
        return None
    axis = names.index("model")

    def model_dim(name):
        p = sharded[name].placements[axis]
        return p.dim if isinstance(p, Shard) else None

    family = cfg.family
    count, index = mesh.size(axis), mesh.get_local_rank("model")
    block = {"hybrid": "shared_attn", "encdec": "dec_blocks.0"}.get(family, "blocks.0")
    attn, q_per_kv, ff = "none", 0, 0
    heads, kv_heads, kv_first, sliced = 0, 0, 0, False
    if not cfg.is_attention_free:
        wq, wk = f"{block}.attn.wq", f"{block}.attn.wk"
        if family == "encdec":
            # one split serves the three attentions: the rules must place
            # them alike
            attns = ("enc_blocks.0.attn", "dec_blocks.0.attn", "dec_blocks.0.xattn")
            for w in ("wq", "wk", "wv", "wo"):
                dims = {f"{a}.{w}": (model_dim(f"{a}.{w}"), tuple(local[f"{a}.{w}"].shape))
                        for a in attns}
                if len(set(dims.values())) > 1:
                    raise NotImplementedError(f"an encdec whose attentions the rules place "
                                              f"differently over \"model\": {dims}")
        attn = {1: "heads", 2: "head_dim", None: "replicated"}[model_dim(wq)]
        heads, kv_heads = cfg.n_heads, cfg.n_kv_heads
        q_per_kv = heads // kv_heads
    if attn == "heads":
        heads, g = local[wq].shape[1], q_per_kv
        if model_dim(wk) == 1:
            kv_heads = local[wk].shape[1]
            kv_first = index * kv_heads
        elif g % heads == 0 or heads % g == 0:
            kv_heads, kv_first, sliced = max(1, heads // g), index * heads // g, True
        else:
            raise NotImplementedError(f"{heads} q heads a rank over kv groups of {g}: a rank's "
                                      "q heads must read whole kv heads")
    moe, experts, expert_first = "replicated", 0, 0
    if family == "moe":
        w_gate = local["blocks.0.moe.w_gate"]
        moe = {0: "experts", 2: "ff"}.get(model_dim("blocks.0.moe.w_gate"))
        if moe is None:
            raise NotImplementedError("an MoE whose experts' w_gate is not split over "
                                      "\"model\" on its expert or ff dimension")
        ff, experts = w_gate.shape[2], w_gate.shape[0]
        if moe == "experts":
            # the leaves split as torch.chunk does: ceil(E / count) a rank,
            # the last ranks' shares short or empty
            expert_first = min(index * -(-cfg.n_experts // count), cfg.n_experts)
    elif not cfg.is_attention_free:
        ff = local[f"{block}.mlp.{'w_up' if family == 'encdec' else 'w_gate'}"].shape[1]
    ssm, ssm_heads, ssm_first = "none", 0, 0
    if family in ("ssm", "hybrid"):
        ssm = "heads" if model_dim("blocks.0.w_x") == 1 else "replicated"
        ssm_heads = cfg.ssm_heads
    if ssm == "heads":
        if cfg.d_inner % count or cfg.ssm_heads % count:
            raise NotImplementedError(
                f"{cfg.d_inner} inner columns over {count} \"model\" ranks with {cfg.ssm_heads} "
                f"SSM heads of {cfg.ssm_head_dim}: a rank's columns would cut across SSM heads")
        ssm_heads = cfg.ssm_heads // count
        ssm_first = index * ssm_heads
        rep = cfg.ssm_heads // cfg.ssm_groups
        if cfg.ssm_groups > 1 and ssm_heads % rep and rep % ssm_heads:
            raise NotImplementedError(
                f"{ssm_heads} SSM heads a rank over {cfg.ssm_groups} groups of {rep} heads: a "
                "rank's heads must hold whole groups of B and C or lie in one")
    return ModelSplit(group=mesh.get_group("model"), index=index, count=count, attn=attn,
                      head_dim=cfg.head_dim, heads=heads, kv_heads=kv_heads, kv_first=kv_first,
                      kv_sliced=sliced, q_per_kv=q_per_kv, ff=ff, vocab=local["embed"].shape[0],
                      moe=moe, experts=experts, expert_first=expert_first, ssm=ssm,
                      ssm_heads=ssm_heads, ssm_first=ssm_first)


def gather_params(cfg: ModelConfig, sharded: dict, model: LanguageModel | None = None,
                  batch_axes=()) -> LanguageModel:
    """A model whose parameters are the DTensors of ``sharded`` (keyed by
    state-dict name), each gathered over every mesh axis but ``"model"``
    (whole on a mesh without one): a collective over their mesh, which
    every member rank calls.  Each leaf keeps its ``"model"`` shard, and
    the model's ``split`` says how the rank computes its share
    (:func:`_model_split`), in every family.  ``batch_axes`` are the mesh
    axes the step splits its batch over; the model's ``batch_shard`` is
    the rank's place among them (None where there is one shard), which an
    MoE's dispatch reads.  ``model`` (one from an earlier call) is reused;
    a new one is built on the shards' device, trainable, holding nothing
    until its leaves are gathered, and a counter of the step
    (:mod:`repro_torch.roofline.cost`) does not count the building."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import batch_shard

    if model is None:
        dev = next(iter(sharded.values())).to_local().device
        with uncounted():
            model = init_params(cfg, None, device="meta")
            for module in model.modules():
                for name, p in list(module.named_parameters(recurse=False)):
                    setattr(module, name, nn.Parameter(torch.empty(0, dtype=p.dtype, device=dev)))
    local = {}
    for n, p in model.named_parameters():
        leaf = sharded[n]
        keep = [pl if a == "model" else Replicate()
                for a, pl in zip(leaf.device_mesh.mesh_dim_names, leaf.placements)]
        local[n] = leaf.redistribute(leaf.device_mesh, keep).to_local()
        p.data = local[n]
    model.split = _model_split(cfg, sharded, local)
    model.batch_shard = batch_shard(next(iter(sharded.values())).device_mesh, batch_axes)
    return model


def release_params(model: LanguageModel) -> None:
    """Drop the gathered leaves of :func:`gather_params`'s model."""
    for p in model.parameters():
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)


def _device_of(params: LanguageModel) -> torch.device:
    return params.embed.device


def _embed(params: LanguageModel, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embeddings; under tensor parallelism a lookup in the
    rank's vocab rows, summed over ``"model"``."""
    if params.split is not None:
        return params.split.embed(tokens, params.embed)
    return embed_tokens(tokens, params.embed)


def _logits(params: LanguageModel, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits over the padded vocab; under tensor parallelism the rank's
    vocab columns (the input enters through f)."""
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    table = params.embed.T if cfg.tie_embeddings else params.lm_head
    if params.split is not None:
        x = params.split.enter(x)
    return unembed(x, table)


# ===========================================================================
# train forward (full sequence -> logits)
# ===========================================================================

REMAT_POLICIES = ("full", "dots", "none")
# the matrix products without batch dimensions: what
# jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under block remat, the counterpart of the reference's
    ``_ckpt`` (``repro/models/model.py:18``): ``"full"`` keeps only the
    block's inputs and recomputes the rest in the backward; ``"dots"``
    also keeps the outputs of the matrix products without batch
    dimensions; ``"none"`` (the port's) keeps every activation.  Remat
    changes memory, not values.  Outside grad mode it is ``fn``."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: expected one of {REMAT_POLICIES}")
    if cfg.remat_policy == "none":
        return fn
    kwargs = {}
    if cfg.remat_policy == "dots":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _save_dots)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)

    return run


def forward_train(params: LanguageModel, batch: dict, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S_text, vocab_padded), aux loss ()), the
    counterpart of ``repro/models/model.py:125``.

    ``batch["tokens"]`` (B, S); a vlm also takes ``batch["patches"]``
    (B, n_patches, d) and an encdec ``batch["frames"]`` (B, enc_len, d).
    Runs under autograd: every attention goes through K8 and its
    hand-written backward on the card.  The aux loss is the MoE's
    load-balancing loss summed over layers (zero for the other families),
    on a mesh the rank's share of the global batch's.  Under tensor
    parallelism (``params.split``) the logits are the rank's vocab
    columns (a vlm's of the text positions: the patches meet the
    vocab-parallel lookup's sum, whole), and an encdec's encoder output
    enters the decoder through one f
    (:func:`~repro_torch.models.blocks.cross_source`).
    """
    family = family_of(cfg)
    dev = _device_of(params)
    tokens = _tokens(batch["tokens"], dev)
    bsz, s_text = tokens.shape
    x = _embed(params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if family == "vlm":
        x = torch.cat([_embeddings(batch["patches"], dev, x.dtype), x], dim=1)
    s_total = x.shape[1]
    positions = torch.arange(s_total, device=dev).expand(bsz, s_total)

    split = params.split

    def dense(p):
        return _remat(lambda h: B.dense_block_forward(h, p, cfg, positions, tp=split)[0], cfg)

    def mamba(p):
        return _remat(lambda h: B.mamba_block_forward(h, p, cfg, tp=split)[0], cfg)

    if family in ("dense", "vlm"):
        for p in params.blocks:
            x = dense(p)(x)
    elif family == "moe":
        for p in params.blocks:
            x, a = _remat(lambda h, p=p: B.moe_block_forward(
                h, p, cfg, positions, tp=split, shard=params.batch_shard)[:2], cfg)(x)
            aux = aux + a
    elif family == "ssm":
        for p in params.blocks:
            x = mamba(p)(x)
    elif family == "hybrid":
        g, _ = hybrid_groups(cfg)
        for j in range(g):
            x = dense(params.shared_attn)(x)
            for i in range(j * cfg.attn_every, (j + 1) * cfg.attn_every):
                x = mamba(params.blocks[i])(x)
        for i in range(g * cfg.attn_every, cfg.n_layers):
            x = mamba(params.blocks[i])(x)
    else:
        frames = _embeddings(batch["frames"], dev, x.dtype)
        t = frames.shape[1]
        h = frames + sinusoid_positions(t, cfg.d_model, dev)[None].to(x.dtype)
        epos = torch.arange(t, device=dev).expand(bsz, t)
        for p in params.enc_blocks:
            h = _remat(lambda c, p=p: B.encoder_block_forward(c, p, cfg, epos, tp=split),
                       cfg)(h)
        enc_out = B.cross_source(rms_norm(h, params.enc_final_norm, cfg.norm_eps), split)
        x = x + sinusoid_positions(s_text, cfg.d_model, dev)[None].to(x.dtype)
        for p in params.dec_blocks:
            x = _remat(lambda c, e, p=p: B.decoder_block_forward(c, p, cfg, positions, e,
                                                                 tp=split)[0], cfg)(x, enc_out)
    if family == "vlm":
        x = x[:, -s_text:, :]
    return _logits(params, cfg, x), aux


# ===========================================================================
# serving: prefill + decode
# ===========================================================================

def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device=None) -> dict:
    """Zero caches of the reference's leaves, shapes and dtypes:

    * dense, vlm, moe: ``k``, ``v`` (n_layers, batch, max_seq, KV, dh);
    * ssm: ``conv`` (n_layers, batch, K-1, d_in + 2GN) and ``ssm``
      (n_layers, batch, H, P, N) float32;
    * hybrid: those, and ``k``, ``v`` with one row per shared-attention
      application;
    * encdec: ``k``, ``v`` and the cross ``xk``, ``xv`` (n_layers, batch,
      enc_len, KV, dh).

    Everything but ``ssm`` is in the activation dtype.  On
    ``device="meta"`` the leaves are shapes and dtypes without data.
    """
    family = family_of(cfg)
    dev = resolve_device(device)
    dt = cfg.act_dtype()
    kv, dh = cfg.n_kv_heads, cfg.head_dim

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if family in ("dense", "vlm", "moe"):
        return {"k": zeros(cfg.n_layers, batch, max_seq, kv, dh),
                "v": zeros(cfg.n_layers, batch, max_seq, kv, dh)}
    if family in ("ssm", "hybrid"):
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        cache = {"conv": zeros(cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim),
                 "ssm": zeros(cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state, dtype=torch.float32)}
        if family == "hybrid":
            g, _ = hybrid_groups(cfg)
            cache["k"] = zeros(g, batch, max_seq, kv, dh)
            cache["v"] = zeros(g, batch, max_seq, kv, dh)
        return cache
    return {"k": zeros(cfg.n_layers, batch, max_seq, kv, dh),
            "v": zeros(cfg.n_layers, batch, max_seq, kv, dh),
            "xk": zeros(cfg.n_layers, batch, cfg.enc_len, kv, dh),
            "xv": zeros(cfg.n_layers, batch, cfg.enc_len, kv, dh)}


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).to(torch.int64)


def _embeddings(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


@torch.inference_mode()
def prefill_into(params: LanguageModel, tokens, cfg: ModelConfig, cache: dict,
                 slot: int = 0, *, patches=None, frames=None) -> torch.Tensor:
    """Prefill ``tokens`` (B, S) into rows ``slot .. slot + B`` of
    ``cache``, in place, and return the last-token logits (B, vocab_padded).

    Every leaf of those rows is written: K/V rows [0, S') take the prompt's
    (S' = n_patches + S for a vlm) and rows [S', max_seq) are zeroed, as
    the reference's padded prefill cache; an ssm or hybrid writes each
    layer's conv window and final SSD state; an encdec also writes each
    decoder layer's cross K/V.  ``patches`` (B, n_patches, d) is a vlm's
    input, ``frames`` (B, enc_len, d) an encdec's.
    """
    family = family_of(cfg)
    dev = _device_of(params)
    tokens = _tokens(tokens, dev)
    bsz, s = tokens.shape
    rows = slice(slot, slot + bsz)
    split = params.split
    x = _embed(params, tokens)
    if family == "vlm":
        if patches is None:
            raise ValueError("a vlm prefill needs patches (B, n_patches, d_model)")
        x = torch.cat([_embeddings(patches, dev, x.dtype), x], dim=1)
    elif family == "encdec" and frames is None:
        raise ValueError("an encdec prefill needs frames (B, enc_len, d_model)")
    s_total = x.shape[1]
    if "k" in cache and s_total > cache["k"].shape[2]:
        raise ValueError(f"prompt of {s_total} positions does not fit "
                         f"max_seq={cache['k'].shape[2]}")
    if family in ("ssm", "hybrid"):
        if s < cfg.ssm_conv - 1:
            raise ValueError(f"prompt of {s} tokens is shorter than the conv window "
                             f"ssm_conv - 1 = {cfg.ssm_conv - 1}")
        check_chunk(s, min(cfg.ssm_chunk, s))
    positions = torch.arange(s_total, device=dev).expand(bsz, s_total)

    def put_kv(i, k, v):
        for name, new in (("k", k), ("v", v)):
            cache[name][i, rows, :s_total] = new if split is None else split.cache_columns(new)
            # zero_, not "= 0": a scalar setitem is a fill_ on the card but
            # a copy_ of a scalar tensor on meta, which the dry run counts
            cache[name][i, rows, s_total:].zero_()

    def mamba(i, x):
        p = params.blocks[i]
        cache["conv"][i, rows] = B.mamba_conv_tail(x, p, cfg, tp=split)
        x, cache["ssm"][i, rows] = B.mamba_block_forward(x, p, cfg, tp=split)
        return x

    if family in ("dense", "vlm"):
        for i, p in enumerate(params.blocks):
            x, (k, v) = B.dense_block_forward(x, p, cfg, positions, tp=split)
            put_kv(i, k, v)
    elif family == "moe":
        if cfg.qk_norm and split is not None:
            raise NotImplementedError("a tensor-parallel MoE prefill with qk_norm: its cache "
                                      "would need the rank's un-normed k")
        for i, p in enumerate(params.blocks):
            h = x
            x, _, (k, v) = B.moe_block_forward(x, p, cfg, positions, tp=split,
                                               shard=params.batch_shard)
            if cfg.qk_norm:
                # the reference caches the un-normed k (model.py:400-410);
                # without qk_norm, as in every MoE config, that is the
                # attention's own k
                hn = rms_norm(h, p.ln1, cfg.norm_eps)
                k = apply_rope(B._project(hn, p.attn.wk), positions, cfg.rope_theta)
            put_kv(i, k, v)
    elif family == "ssm":
        for i in range(cfg.n_layers):
            x = mamba(i, x)
    elif family == "hybrid":
        g, _ = hybrid_groups(cfg)
        for j in range(g):
            x, (k, v) = B.dense_block_forward(x, params.shared_attn, cfg, positions, tp=split)
            put_kv(j, k, v)
            for i in range(j * cfg.attn_every, (j + 1) * cfg.attn_every):
                x = mamba(i, x)
        for i in range(g * cfg.attn_every, cfg.n_layers):
            x = mamba(i, x)
    else:
        h = _embeddings(frames, dev, x.dtype)
        t = h.shape[1]
        h = h + sinusoid_positions(t, cfg.d_model, dev)[None].to(x.dtype)
        epos = torch.arange(t, device=dev).expand(bsz, t)
        for p in params.enc_blocks:
            h = B.encoder_block_forward(h, p, cfg, epos, tp=split)
        enc_out = B.cross_source(rms_norm(h, params.enc_final_norm, cfg.norm_eps), split)
        x = x + sinusoid_positions(s, cfg.d_model, dev)[None].to(x.dtype)
        for i, p in enumerate(params.dec_blocks):
            x, (k, v) = B.decoder_block_forward(x, p, cfg, positions, enc_out, tp=split)
            put_kv(i, k, v)
            for name, new in zip(("xk", "xv"), B.encdec_cross_kv(p.xattn, cfg, enc_out,
                                                                 tp=split)):
                cache[name][i, rows] = new if split is None else split.cache_columns(new)
    return _logits(params, cfg, x[:, -1:, :])[:, 0, :]


def prefill(params: LanguageModel, batch: dict, cfg: ModelConfig, max_seq: int):
    """Full-sequence prefill building the decode cache.

    ``batch["tokens"]`` (B, S), with ``batch["patches"]`` for a vlm and
    ``batch["frames"]`` for an encdec.  Returns (last-token logits
    (B, vocab_padded), cache padded to ``max_seq``).  Under tensor
    parallelism (``params.split``) the logits are the rank's vocab
    columns and the cache its share in the decode rules' layout
    (:func:`_split_prefill_cache`).
    """
    tokens = batch["tokens"]
    split, dev = params.split, _device_of(params)
    sends = {}
    if split is None:
        cache = init_decode_cache(cfg, len(tokens), max_seq, device=dev)
    else:
        cache, sends = _split_prefill_cache(split, cfg, len(tokens), max_seq, dev)
    logits = prefill_into(params, tokens, cfg, cache, patches=batch.get("patches"),
                          frames=batch.get("frames"))
    for names, send in sends.items():
        cache.update(zip(names, split.heads_to_head_dim(send, cfg.n_kv_heads)))
    return logits, cache


def _split_prefill_cache(split, cfg: ModelConfig, batch: int, max_seq: int, dev):
    """A tensor-parallel rank's prefill cache and, in heads mode, the
    buffers that all-to-alls send on, keyed by the leaves they hold (none
    otherwise).  The decode rules' layout of K/V (one row a layer, a
    hybrid's one a shared-attention application; an encdec's cross K/V
    too, ``enc_len`` positions) is every kv head and the rank's
    ``head_dim`` columns (its whole heads where the axis does not divide
    ``head_dim``).  In heads mode the rank holds only its kv heads, whole:
    its cache is a view (rows, B, positions, its kv heads, ranks, columns)
    of a buffer (ranks, 2, rows, B, positions, its kv heads, columns),
    which :meth:`~repro_torch.distributed.sharding.ModelSplit.heads_to_head_dim`
    turns into the decode layout in one all-to-all, ``k``/``v`` and
    ``xk``/``xv`` each a buffer of their own (their positions differ); in
    head_dim mode (k/v gathered whole) and with replicated attention the
    rank writes its columns.  An SSM or hybrid rank's ``ssm`` state is
    its SSM heads' (all of them where its Mamba blocks compute replicated)
    and its ``conv`` window whole, as the rules place them.  Every row is
    written by :func:`prefill_into`."""
    dt = cfg.act_dtype()
    cache, sends = {}, {}
    if cfg.family in ("ssm", "hybrid"):
        heads = split.ssm_heads if split.ssm_partial else cfg.ssm_heads
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        cache["conv"] = torch.empty((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=dt,
                                    device=dev)
        cache["ssm"] = torch.empty((cfg.n_layers, batch, heads, cfg.ssm_head_dim, cfg.ssm_state),
                                   dtype=torch.float32, device=dev)
    if cfg.family == "ssm":
        return cache, sends
    rows = hybrid_groups(cfg)[0] if cfg.family == "hybrid" else cfg.n_layers
    kv, dh, m = cfg.n_kv_heads, cfg.head_dim, split.count
    c = dh // m if split.shards_head_dim else dh
    leaves = {("k", "v"): max_seq}
    if cfg.family == "encdec":
        leaves[("xk", "xv")] = cfg.enc_len
    if split.attn != "heads":
        cache.update({n: torch.empty((rows, batch, length, kv, c), dtype=dt, device=dev)
                      for names, length in leaves.items() for n in names})
        return cache, sends
    if not split.shards_head_dim:
        raise NotImplementedError(f"a heads-mode prefill whose cache keeps whole heads: "
                                  f"head_dim {dh} over {m} ranks")
    for names, length in leaves.items():
        send = torch.empty((m, 2, rows, batch, length, split.kv_heads, c), dtype=dt, device=dev)
        cache.update(zip(names, (send[:, 0].movedim(0, -2), send[:, 1].movedim(0, -2))))
        sends[names] = send
    return cache, sends


@torch.inference_mode()
def decode_step(params: LanguageModel, token, pos, cache: dict, cfg: ModelConfig):
    """One token for every sequence.  Returns (logits (B, vocab_padded),
    cache), the cache updated in place.

    ``pos`` may be a scalar (every sequence at the same length) or a
    per-sequence (B,) vector: each slot writes its KV row, rotates its
    query and masks its keys at its own position (a vlm's positions count
    its patches; an ssm's state carries its own).
    """
    family = family_of(cfg)
    dev = _device_of(params)
    token = _tokens(token, dev)
    pos_vec = B.pos_vector(pos, token.shape[0], dev)
    x = _embed(params, token)
    split = params.split

    def mamba(i, x):
        x, cache["conv"][i], cache["ssm"][i] = B.mamba_block_decode(
            x, params.blocks[i], cfg, cache["conv"][i], cache["ssm"][i], tp=split)
        return x

    if family in ("dense", "vlm"):
        for i, p in enumerate(params.blocks):
            x = B.dense_block_decode(x, p, cfg, cache["k"][i], cache["v"][i], pos_vec, tp=split)
    elif family == "moe":
        for i, p in enumerate(params.blocks):
            x = B.moe_block_decode(x, p, cfg, cache["k"][i], cache["v"][i], pos_vec, tp=split,
                                   shard=params.batch_shard)
    elif family == "ssm":
        for i in range(cfg.n_layers):
            x = mamba(i, x)
    elif family == "hybrid":
        g, _ = hybrid_groups(cfg)
        for j in range(g):
            x = B.dense_block_decode(x, params.shared_attn, cfg, cache["k"][j], cache["v"][j],
                                     pos_vec, tp=split)
            for i in range(j * cfg.attn_every, (j + 1) * cfg.attn_every):
                x = mamba(i, x)
        for i in range(g * cfg.attn_every, cfg.n_layers):
            x = mamba(i, x)
    else:
        x = x + sinusoid_position_at(pos_vec, cfg.d_model)[:, None, :].to(x.dtype)
        for i, p in enumerate(params.dec_blocks):
            x = B.decoder_block_decode(x, p, cfg, cache["k"][i], cache["v"][i], cache["xk"][i],
                                       cache["xv"][i], pos_vec, tp=split)
    return _logits(params, cfg, x)[:, 0, :], cache


# ===========================================================================
# accounting
# ===========================================================================

def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def count_active_params(params: LanguageModel, cfg: ModelConfig) -> int:
    """MoE: only top_k of n_experts experts act on a token."""
    total = count_params(params)
    if cfg.family != "moe":
        return total
    expert = sum(getattr(p.moe, name).numel() for p in params.blocks
                 for name in ("w_gate", "w_up", "w_down"))
    return int(total - expert * (1.0 - cfg.top_k / cfg.n_experts))


def count_flop_params(params: LanguageModel, cfg: ModelConfig) -> int:
    """Active parameters without the embedding table (a lookup, not a
    product; the LM head product is counted)."""
    return count_active_params(params, cfg) - params.embed.numel()


def model_flops(params: LanguageModel, cfg: ModelConfig, n_tokens: int, *,
                train: bool = True) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N = active
    non-embedding parameters."""
    return (6.0 if train else 2.0) * count_flop_params(params, cfg) * n_tokens
