"""Port parity: the dry run's registry (``SHAPES``, ``shape_applicable``,
``input_specs``) against the reference's ``repro.configs``, the
``meta``-device entry points it needs, and ``repro_torch.launch.dryrun``
at SMOKE size.

``input_specs`` must give the reference's shapes and dtypes for every
SMOKE config and shape; the decode cache's leaves keep the reference's
names (``k``, ``v``, ``conv``, ``ssm``, ``xk``, ``xv``: the key mapping is
the identity).  Exact: shapes and dtypes.  ``run_cell`` must come back
``ok`` for every cell, or ``skipped`` with the reference's reason where
the reference skips (``long_500k`` on a full-attention arch), on one
card and on both production meshes, which trace rank 0 of a fake process
group of 512 ranks in this process: a rank's FLOPs equal the one-device
step's at its rows, its collective bytes a count by hand, and the
attention batch layout splits K8's work 16 ways.  The reference's
``repro.launch.dryrun`` is not imported here: it sets ``XLA_FLAGS`` for
512 host devices when imported.
"""

import dataclasses
import functools
import json
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.configs import input_specs as jinput_specs  # noqa: E402
from repro.configs import shape_applicable as jshape_applicable  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    ARCH_IDS,
    SHAPES,
    get_config,
    get_smoke_config,
    input_specs,
    shape_applicable,
)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import rule_axes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.roofline import analysis, cost  # noqa: E402

DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}
REF_KEYS = {"arch", "shape", "mesh", "status", "n_chips", "memory", "cost", "collectives",
            "roofline", "active_params"}


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _shape_dtype(tree):
    if isinstance(tree, dict):
        return {k: _shape_dtype(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    return tuple(tree.shape), DTYPES[jnp.dtype(tree.dtype)]


def test_shape_grid_is_the_references():
    assert list(SHAPES) == list(JSHAPES)
    for name, spec in SHAPES.items():
        ref = JSHAPES[name]
        assert (spec.name, spec.seq_len, spec.global_batch, spec.kind) == \
            (ref.name, ref.seq_len, ref.global_batch, ref.kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_applicable_is_the_references(arch):
    for name in SHAPES:
        for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                          (get_smoke_config(arch), jget_smoke(arch))):
            assert shape_applicable(cfg, SHAPES[name]) == jshape_applicable(jcfg, JSHAPES[name])


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_are_the_references(arch, shape):
    got = input_specs(get_smoke_config(arch), SHAPES[shape])
    want = jinput_specs(jget_smoke(arch), JSHAPES[shape])
    assert _shape_dtype(got) == _shape_dtype(want)
    assert all(t.device.type == "meta" for t in _leaves(got))


def test_meta_is_taken_only_when_asked_for():
    """``resolve_device`` returns meta when named; the kernels' tensor check
    takes meta only from a wrapper that passes ``allow_meta`` (K8's)."""
    assert resolve_device("meta").type == "meta"
    t = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        build.check_tensors(build.FLOAT_DTYPES, a=t)
    assert build.check_tensors(build.FLOAT_DTYPES, allow_meta=True, a=t).type == "meta"


def test_meta_params_take_no_generator():
    cfg = get_smoke_config("zamba2_7b")
    params = tmodel.init_params(cfg, None, device="meta")
    assert all(p.device.type == "meta" for p in params.parameters())
    cpu = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {n: (p.shape, p.dtype) for n, p in params.named_parameters()} == \
        {n: (p.shape, p.dtype) for n, p in cpu.named_parameters()}
    with pytest.raises(ValueError, match="no generator"):
        tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    with pytest.raises(ValueError, match="generator"):
        tmodel.init_params(cfg, None, device="cpu")
    cache = tmodel.init_decode_cache(cfg, 2, 64, device="meta")
    assert all(t.device.type == "meta" for t in cache.values())


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_at_smoke_size(arch, shape):
    res = dryrun.run_cell(arch, shape, smoke=True)
    applies, reason = jshape_applicable(jget_smoke(arch), JSHAPES[shape])
    if not applies:
        assert res == {"arch": arch, "shape": shape, "mesh": "single_card",
                       "status": "skipped", "reason": reason}
        return
    assert res["status"] == "ok"
    assert REF_KEYS | {"host_s", "kernels"} == set(res)
    assert set(res["memory"]) == {"argument_size_b", "output_size_b", "temp_size_b",
                                  "generated_code_size_b"}
    assert res["memory"]["generated_code_size_b"] is None
    assert res["collectives"] == {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
                                  "all-to-all": 0.0, "collective-permute": 0.0, "total": 0.0}
    roof = res["roofline"]
    ref_roof = jax_roofline_keys()
    assert ref_roof <= set(roof)
    assert roof["hw"] == "h100-sxm-80gb" and roof["compute_dtype"] == "float32"
    assert roof["step_time_lower_bound_s"] == max(roof["compute_s"], roof["memory_s"]) > 0
    assert res["cost"]["flops"] == roof["hlo_flops_per_chip"] > 0
    assert res["memory"]["temp_size_b"] > 0 and res["memory"]["argument_size_b"] > 0
    attention = get_smoke_config(arch).family != "ssm"
    if attention and SHAPES[shape].kind != "decode":
        assert "flash_attention" in res["kernels"]
    if SHAPES[shape].kind == "train" and attention:
        assert {"flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
                "flash_attention_bwd_dq"} <= set(res["kernels"])


def jax_roofline_keys() -> set:
    from repro.roofline.analysis import roofline_report

    return set(roofline_report(flops=1.0, bytes_accessed=1.0, collective_bytes=0.0, n_chips=1,
                               model_flops=1.0))


def test_run_cell_counts_what_the_cell_needs():
    """A dense SMOKE decode step: 2 flops a token for each weight of a
    product (every matrix but the embedding table; the norms' scales are
    elementwise), the attention over the whole cache (4 H D a key, in
    plain PyTorch), and bytes past every argument read once."""
    cfg = get_smoke_config("qwen3_8b")
    res = dryrun.run_cell("qwen3_8b", "decode_32k", smoke=True)
    b = SHAPES["decode_32k"].global_batch
    params = tmodel.init_params(cfg, None, device="meta")
    n = sum(p.numel() for name, p in params.named_parameters()
            if p.ndim >= 2 and name != "embed")
    attention = 4 * b * cfg.n_heads * cfg.head_dim * SHAPES["decode_32k"].seq_len * cfg.n_layers
    assert res["cost"]["flops"] == 2 * n * b + attention
    assert res["roofline"]["model_flops"] == 2 * tmodel.count_flop_params(params, cfg) * b
    assert res["cost"]["bytes_accessed"] > res["memory"]["argument_size_b"]


# ------------------------------------------------ the production meshes

# the production meshes' axis sizes
AXIS_SIZES = mesh_lib.production_axis_sizes(multi_pod=True)
N_CHIPS = {"single_pod": 256, "multi_pod": 512}


@functools.cache
def sharded_cell(arch: str, shape: str, mesh: str, layout: bool = True) -> dict:
    return dryrun.run_cell(arch, shape, mesh, smoke=True, attn_batch_layout=layout)


def rank_batch(arch: str, shape: str, mesh: str) -> int:
    """The rows of one rank: the global batch over the batch rule's axes."""
    spec = SHAPES[shape]
    rules = dryrun.cell_rules(get_smoke_config(arch), spec, mesh, False)
    return spec.global_batch // math.prod(AXIS_SIZES[a] for a in rule_axes(rules["batch"]))


@functools.cache
def one_device_flops(arch: str, shape: str, batch: int) -> tuple[int, int]:
    """The one-device step's FLOPs at ``batch`` rows, and K8's share."""
    spec = dataclasses.replace(SHAPES[shape], global_batch=batch)
    counter = dryrun.trace_cell(get_smoke_config(arch), spec)[0]
    return counter.flops, sum(k["flops"] for k in counter.kernels.values())


def moe_expert_flops(cfg, spec, mesh: str, rows: int) -> tuple[int, int, int]:
    """An MoE cell's products at a rank's ``rows`` rows that do not split
    over "model" as the rest: the router's, which every rank runs whole;
    the experts' of the one-device step at those rows (its own dispatch
    groups of them); and a rank's (its experts, or its ``ff`` columns of
    every expert, over the global batch's dispatch groups).  A rank of R
    batch shards, of a global batch that the reference cuts into G
    groups (one where G does not divide its tokens), holds G / R whole
    groups of ``cap`` slots an expert where R divides G, else its share
    of one group of R / G ranks, at most its own tokens an expert of the
    group's ``cap`` (no token picks an expert twice).  Training runs
    each product four times (forward, remat's recompute, the backward's
    two)."""
    from repro.models.moe import moe_capacity

    rules = dryrun.cell_rules(cfg, spec, mesh, False)
    shards = math.prod(AXIS_SIZES[a] for a in rule_axes(rules["batch"]))
    model = AXIS_SIZES["model"]
    decode = spec.kind == "decode"
    n = rows * (1 if decode else spec.seq_len)
    passes = 4 if spec.kind == "train" else 1
    groups, factor = (1, 2.0) if decode else (cfg.dispatch_groups, 1.25)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def experts(count: int, e_r: int, f_r: int) -> int:
        total = n * count
        g = groups if total % groups == 0 else 1
        cap = moe_capacity(total // g, e, cfg.top_k, factor)
        local, block = (g // count, cap) if g % count == 0 else (1, min(cap, n))
        return passes * 3 * 2 * e_r * local * block * d * f_r * cfg.n_layers

    e_r, f_r = (min(-(-e // model), e), f) if cfg.moe_parallel == "ep" else (e, f // model)
    return (passes * 2 * n * d * e * cfg.n_layers, experts(1, e, f),
            experts(shards, e_r, f_r))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", dryrun.SHARDED_MESHES)
def test_sharded_cell_at_smoke_size(mesh, arch, shape):
    """Every cell on both production meshes (the attention batch layout on,
    as the CLI runs them): the reference's status and skip reason,
    ``n_chips``, the result keys, collectives counted (every step gathers
    its leaves), and, wherever the layout leaves the rules as they were, a
    rank's FLOPs against the one-device step's at the rank's rows
    (``global_batch`` over the batch rule's axes; AdamW adds no
    products): for the dense, vlm and encdec families, tensor parallel,
    the products' share of them over the model axis (every product
    splits: the projections and ``wo`` over head_dim at SMOKE's 4 heads,
    Whisper's cross attention's too, the MLP over ``ff``, the logits over
    the vocab) and K8's whole, its q, k and v gathered (head mode would
    split it too); in decode the attention over each cache (Whisper's
    self and cross caches) keeps half its product whole, below; for the
    MoE family the same, but the router whole and the experts' products
    the rank's (:func:`moe_expert_flops`).  The SSM and hybrid families' SMOKE
    configs are tensor parallel too, but the rules put their 128 ``inner``
    columns on the 16 "model" ranks and not their 8 SSM heads, so the
    split refuses them, naming the counts (their ranks are traced on a
    fake (2, 4) world, 2 heads a rank, in
    ``tests/test_torch_tensor_parallel.py``; the full-size configs, 32
    and 112 heads, split on these meshes in the smoke's dry run)."""
    applies, reason = jshape_applicable(jget_smoke(arch), JSHAPES[shape])
    cfg = get_smoke_config(arch)
    if applies and cfg.family in ("ssm", "hybrid"):
        with pytest.raises(NotImplementedError, match="128 inner columns over 16 \"model\" "
                                                      "ranks with 8 SSM heads"):
            sharded_cell(arch, shape, mesh)
        return
    res = sharded_cell(arch, shape, mesh)
    if not applies:
        assert res == {"arch": arch, "shape": shape, "mesh": mesh, "status": "skipped",
                       "reason": reason}
        return
    assert res["status"] == "ok", res.get("traceback")
    assert REF_KEYS | {"host_s", "kernels", "compute", "attention"} == set(res)
    assert res["n_chips"] == res["roofline"]["n_chips"] == N_CHIPS[mesh]
    assert res["compute"] == {"moe": {"ep": "expert parallel over model",
                                      "tp": "tensor parallel inside experts over model"}.get(
                                          cfg.moe_parallel)}.get(cfg.family,
                                                                 "tensor parallel over model")
    coll = res["collectives"]
    assert jax_roofline_keys() <= set(res["roofline"])
    assert coll["all-gather"] > 0 and coll["total"] == sum(
        v for k, v in coll.items() if k != "total")
    assert res["roofline"]["collective_s"] == coll["total"] / analysis.H100_SXM.link_bw
    assert res["memory"]["temp_size_b"] > 0 and res["memory"]["argument_size_b"] > 0
    spec = SHAPES[shape]
    if dryrun.cell_rules(cfg, spec, mesh, True) == dryrun.cell_rules(cfg, spec, mesh, False):
        flops, k8 = one_device_flops(arch, shape, rank_batch(arch, shape, mesh))
        model = AXIS_SIZES["model"]
        heads = res["attention"] == "heads"
        assert res["attention"] in ("head_dim",
                                    "replicated over model (head_dim: q, k, v gathered)")
        # decode's attention over the cache, 4 B H D S a layer: the scores
        # contract a rank's one head_dim column, an elementwise product
        # and a sum (in the reference's count too), so only the values'
        # product, half of it, stays a product
        attn = 0
        if spec.kind == "decode":
            keys = spec.seq_len + (cfg.enc_len if cfg.family == "encdec" else 0)
            attn = (4 * rank_batch(arch, shape, mesh) * cfg.n_heads * cfg.head_dim
                    * keys * cfg.n_layers)
            assert cfg.head_dim == model
        whole = mine = 0
        if cfg.family == "moe":
            whole, one, mine = moe_expert_flops(cfg, spec, mesh, rank_batch(arch, shape, mesh))
            flops -= one
        assert (flops - k8 - attn - whole) % model == 0
        flops = ((flops - k8 - attn - whole) // model + attn // 2 // model
                 + (k8 // model if heads else k8) + whole + mine)
        assert res["cost"]["flops"] == flops


def _tp_param_gathers(cfg, rules) -> tuple[int, int, int]:
    """A tensor-parallel step's gathers of the parameters over "data" alone
    (each leaf keeps its "model" shard): their number and result bytes,
    and the bytes of the leaves a rank then holds (its gradients')."""
    params = tmodel.init_params(cfg, None, device="meta")
    axes = tmodel.param_logical_axes(cfg)
    calls = gathered = held = 0
    for name, p in params.named_parameters():
        spec = [a for entry in sharding.logical_spec(axes[name], rules) for a in rule_axes(entry)]
        share = p.numel() * p.element_size() // (AXIS_SIZES["model"] if "model" in spec else 1)
        held += share
        if "data" in spec:
            calls, gathered = calls + 1, gathered + share
    return calls, gathered, held


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_sharded_collective_bytes_equal_a_count_by_hand(shape):
    """qwen3_8b at SMOKE size on single_pod without the layout, tensor
    parallel over "model" (4 heads on 16 ranks: head_dim mode, a rank's
    one column of each head): every step gathers each parameter over
    "data" alone; the embedding's lookup and each layer's attention and
    MLP end in an all-reduce of the residual stream (g).  Train and
    prefill all-gather q, k and v to whole heads each layer; train also
    repeats the forward's gathers and the attention's all-reduce in block
    remat's recompute (which stops before the block's last operator, the
    MLP's all-reduce), all-reduces the gradient of each region's input (f: a
    layer's attention and MLP, the logits) and of the q/k norms,
    reduce-scatters q's, k's and v's gradients, reduces the
    vocab-parallel loss's row max, sum of exponentials, target logit and
    argmax (a max and an int64 min), all-reduces each gradient (a
    rank's "model" shard) and its six scalar metrics over "data", and the
    global norm's per-leaf sums over "model".  Decode all-reduces the q/k
    norms' mean squares and the float32 scores each layer and exchanges
    RoPE's paired columns of q and k in one all-to-all; the cache stays
    in place.  Prefill's outputs are local slices."""
    cfg = get_smoke_config("qwen3_8b")
    spec = SHAPES[shape]
    rules = dryrun.cell_rules(cfg, spec, "single_pod", False)
    _, gathered, held = _tp_param_gathers(cfg, rules)
    m = AXIS_SIZES["model"]
    rows = rank_batch("qwen3_8b", shape, "single_pod")
    tokens = rows * (1 if spec.kind == "decode" else spec.seq_len)
    act = torch.empty((), dtype=cfg.act_dtype()).element_size()
    n_l, h, kv, dh = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    resid = tokens * cfg.d_model * act
    qkv = tokens * (h + 2 * kv) * dh * act
    want = {"all-gather": gathered, "all-reduce": resid * (1 + 2 * n_l), "reduce-scatter": 0,
            "all-to-all": 0}
    if spec.kind == "train":
        n_leaves = len(list(tmodel.init_params(cfg, None, device="meta").parameters()))
        want["all-gather"] += 2 * n_l * qkv
        want["all-reduce"] += (resid * (n_l + 2 * n_l + 1) + n_l * 2 * dh * 4
                               + tokens * (4 + 4 + 4 + 4 + 8) + held + 6 * 4 + n_leaves * 4)
        want["reduce-scatter"] = n_l * qkv // m
    elif spec.kind == "prefill":
        want["all-gather"] += n_l * qkv
    else:
        want["all-reduce"] += n_l * (rows * (h + kv) * 4 + rows * h * spec.seq_len * 4)
        want["all-to-all"] = n_l * rows * (h + kv) * (dh // m) * act
    got = sharded_cell("qwen3_8b", shape, "single_pod", False)["collectives"]
    assert got == {**dict.fromkeys(cost.COLLECTIVES, 0.0), **want,
                   "total": float(sum(want.values()))}


@pytest.mark.parametrize("arch", ["yi_34b", "internvl2_1b"])
def test_attention_batch_layout_splits_attention_over_model(arch):
    """train_4k on single_pod at SMOKE size, with the layout against
    without: K8's counted work (forward and backward) is 1/16 a rank, and
    each layer adds three all-gathers of the attention's output rows (the
    forward's, the one of block remat's recompute, and the one of the
    input slice's gradient) and an all-reduce of each attention weight's
    gradient over "model".  Both steps are tensor parallel (InternVL2's
    blocks are dense blocks): without the layout the attention is in
    head_dim mode, so each layer also all-gathers q, k and v (the
    forward's and remat's recompute) and all-reduces the attention's
    partial sums (g, and g again in the recompute) and its input's
    gradient (f), which the layout, whose attention is replicated over
    "model", does not; the step all-reduces each gradient as a rank holds
    it, the attention's weights whole under the layout and 1/16
    without."""
    cfg = get_smoke_config(arch)
    spec = SHAPES["train_4k"]
    runs, params = {}, {}
    for layout in (False, True):
        rules = dryrun.cell_rules(cfg, spec, "single_pod", layout)
        with mesh_lib.fake_world() as mesh:
            counter, _ = dryrun.trace_sharded_cell(cfg, spec, mesh, rules)
        runs[layout] = counter
        params[layout] = _tp_param_gathers(cfg, rules)
    assert rules["attn_batch"] == ("data", "model")
    base, lay = runs[False], runs[True]
    assert set(base.kernels) == set(lay.kernels) == {
        "flash_attention", "flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
        "flash_attention_bwd_dq"}
    for name, k in base.kernels.items():
        assert lay.kernels[name]["calls"] == k["calls"]
        assert lay.kernels[name]["flops"] * 16 == k["flops"], name
    # the layout places attention's weights without "model" (the reference's
    # rules), so the parameters' own gathers differ: count them apart
    rows = rank_batch(arch, "train_4k", "single_pod")
    act = torch.empty((), dtype=cfg.act_dtype()).element_size()
    n_l = cfg.n_layers
    extra = 3 * n_l
    resid = rows * spec.seq_len * cfg.d_model * act
    qkv = rows * spec.seq_len * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim * act
    for layout, c in runs.items():
        n, b, _ = params[layout]
        tp_gathers = 0 if layout else 2 * n_l
        assert c.by_op["all_gather_into_tensor"][0] == n + extra * layout + 3 * tp_gathers
        assert c.collective_bytes["all-gather"] == (
            b + extra * layout * resid + tp_gathers * qkv)
    attn = tmodel.init_params(cfg, None, device="meta").blocks[0].attn
    weights = list(attn.parameters())
    attn_bytes = n_l * sum(w.numel() * w.element_size() for w in weights)
    # the step's own all-reduces are torch.distributed's in place (allreduce_),
    # the layout's functional (all_reduce), as are tensor parallelism's
    assert lay.by_op["allreduce_"][0] == base.by_op["allreduce_"][0]
    assert not cfg.qk_norm
    assert lay.by_op["all_reduce"][0] == base.by_op["all_reduce"][0] + n_l * (len(weights) - 3)
    assert (lay.collective_bytes["all-reduce"] - base.collective_bytes["all-reduce"]
            == attn_bytes - 3 * n_l * resid + params[True][2] - params[False][2])
    assert params[True][2] - params[False][2] == attn_bytes * 15 // 16


def test_attention_batch_layout_waits_on_rules_and_a_mesh():
    """Without active rules and a mesh (every one-device path), or where
    the layout is the batch's own, there is no split."""
    assert sharding.attn_batch_split() is None
    with sharding.use_rules({"batch": "data", "attn_batch": ("data", "model")}):
        assert sharding.attn_batch_split() is None
    with mesh_lib.fake_world() as mesh, mesh_lib.mesh_context(mesh):
        with sharding.use_rules({"batch": "data", "attn_batch": "data"}):
            assert sharding.attn_batch_split() is None
        with sharding.use_rules({"batch": "data", "attn_batch": ("data", "model")}):
            split = sharding.attn_batch_split()
            assert (split.axis, split.index, split.count) == ("model", 0, 16)


def test_fake_world_refuses_an_open_group_and_leaves_none(tmp_path):
    with mesh_lib.fake_world(multi_pod=True) as mesh:
        assert dist.get_world_size() == mesh_lib.FAKE_WORLD == 512
        assert mesh.size() == 512 and mesh.mesh_dim_names == ("pod", "data", "model")
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with mesh_lib.fake_world() as mesh:
            assert mesh.size() == 256
            raise ZeroDivisionError
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            with mesh_lib.fake_world():
                pass
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_per_pod_batch_are_the_references(arch, shape):
    got = input_specs(get_smoke_config(arch), SHAPES[shape], per_pod_batch=8)
    want = jinput_specs(jget_smoke(arch), JSHAPES[shape], per_pod_batch=8)
    assert _shape_dtype(got) == _shape_dtype(want)
    leaf = got["token"] if SHAPES[shape].kind == "decode" else got["tokens"]
    assert leaf.shape[0] == 8


def test_main_runs_both_production_meshes(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    dryrun.main(["--both-meshes", "--arch", "granite_20b", "--shape", "decode_32k", "--smoke",
                 "--baseline"])
    for mesh in dryrun.SHARDED_MESHES:
        res = json.loads((tmp_path / mesh / "granite_20b__decode_32k.json").read_text())
        assert res["status"] == "ok" and res["n_chips"] == N_CHIPS[mesh]
    assert "DRY-RUN PASSED" in capsys.readouterr().out


def test_main_writes_a_result_per_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    dryrun.main(["--arch", "whisper_base", "--smoke", "--tag", "_t"])
    files = sorted(p.name for p in (tmp_path / "single_card_t").iterdir())
    assert files == sorted(f"whisper_base__{s}.json" for s in SHAPES)
    res = json.loads((tmp_path / "single_card_t" / "whisper_base__decode_32k.json").read_text())
    assert res["status"] == "ok"
    skipped = json.loads((tmp_path / "single_card_t" / "whisper_base__long_500k.json")
                         .read_text())
    assert skipped["status"] == "skipped"
    assert "DRY-RUN PASSED" in capsys.readouterr().out


def test_run_cells_records_a_failed_cell(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    (res,) = dryrun.run_cells([("qwen3_8b", "train_4k")])
    assert res["status"] == "error" and "boom" in res["error"]


def test_target_card_spec():
    assert dryrun.TARGET_CARD in analysis.CARDS
