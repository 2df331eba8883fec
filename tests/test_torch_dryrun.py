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
def one_device_flops(arch: str, shape: str, batch: int) -> int:
    spec = dataclasses.replace(SHAPES[shape], global_batch=batch)
    return dryrun.trace_cell(get_smoke_config(arch), spec)[0].flops


# the SSM families' train and prefill traces run a Python loop over chunks
# (seconds each at SMOKE size): their FLOPs are held on decode alone
SLOW_TRACES = {("mamba2_370m", "train_4k"), ("mamba2_370m", "prefill_32k"),
               ("zamba2_7b", "train_4k"), ("zamba2_7b", "prefill_32k")}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", dryrun.SHARDED_MESHES)
def test_sharded_cell_at_smoke_size(mesh, arch, shape):
    """Every cell on both production meshes (the attention batch layout on,
    as the CLI runs them): the reference's status and skip reason,
    ``n_chips``, the result keys, collectives counted (every step gathers
    its leaves), and a rank's FLOPs exactly the one-device step's at the
    rank's rows (``global_batch`` over the batch rule's axes; AdamW adds
    no products), wherever the layout leaves the rules as they were."""
    res = sharded_cell(arch, shape, mesh)
    applies, reason = jshape_applicable(jget_smoke(arch), JSHAPES[shape])
    if not applies:
        assert res == {"arch": arch, "shape": shape, "mesh": mesh, "status": "skipped",
                       "reason": reason}
        return
    assert res["status"] == "ok", res.get("traceback")
    assert REF_KEYS | {"host_s", "kernels", "compute"} == set(res)
    assert res["n_chips"] == res["roofline"]["n_chips"] == N_CHIPS[mesh]
    assert res["compute"] == "replicated over model"
    coll = res["collectives"]
    assert jax_roofline_keys() <= set(res["roofline"])
    assert coll["all-gather"] > 0 and coll["total"] == sum(
        v for k, v in coll.items() if k != "total")
    assert res["roofline"]["collective_s"] == coll["total"] / analysis.H100_SXM.link_bw
    assert res["memory"]["temp_size_b"] > 0 and res["memory"]["argument_size_b"] > 0
    cfg = get_smoke_config(arch)
    spec = SHAPES[shape]
    if (dryrun.cell_rules(cfg, spec, mesh, True) == dryrun.cell_rules(cfg, spec, mesh, False)
            and (arch, shape) not in SLOW_TRACES):
        assert res["cost"]["flops"] == one_device_flops(arch, shape,
                                                        rank_batch(arch, shape, mesh))


def _gathers(shape, itemsize: int, spec, mesh_names) -> tuple[int, int]:
    """DTensor's all-gathers of a leaf whole, their number and result
    bytes: one per sharded mesh axis, the last mesh axis first, each
    result the leaf's share still split over the axes not yet gathered."""
    full = math.prod(shape) * itemsize
    left = [a for entry in spec for a in rule_axes(entry)]
    calls = total = 0
    for axis in reversed(mesh_names):
        if axis in left:
            left.remove(axis)
            calls += 1
            total += full // math.prod(AXIS_SIZES[a] for a in left)
    return calls, total


def _param_gathers(cfg, rules, mesh_names) -> tuple[int, int, int]:
    """The parameters' all-gathers (number, result bytes) and their whole
    bytes."""
    params = tmodel.init_params(cfg, None, device="meta")
    axes = tmodel.param_logical_axes(cfg)
    calls = gathered = whole = 0
    for name, p in params.named_parameters():
        spec = sharding.logical_spec(axes[name], rules)
        n, b = _gathers(p.shape, p.element_size(), spec, mesh_names)
        calls, gathered, whole = calls + n, gathered + b, whole + p.numel() * p.element_size()
    return calls, gathered, whole


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_sharded_collective_bytes_equal_a_count_by_hand(shape):
    """qwen3_8b at SMOKE size on single_pod without the layout: every step
    gathers each parameter whole (a leaf sharded over both axes in two
    all-gathers); train all-reduces each float32 gradient and its six
    scalar metrics over "data"; decode all-gathers its rows of the cache
    over "model" (head_dim); prefill's outputs are local slices."""
    cfg = get_smoke_config("qwen3_8b")
    spec = SHAPES[shape]
    rules = dryrun.cell_rules(cfg, spec, "single_pod", False)
    names = ("data", "model")
    _, gathered, whole = _param_gathers(cfg, rules, names)
    want = {"all-gather": gathered, "all-reduce": 0}
    if spec.kind == "train":
        want["all-reduce"] = whole + 6 * 4
    if spec.kind == "decode":
        rows = rank_batch("qwen3_8b", shape, "single_pod")
        cache = tmodel.init_decode_cache(cfg, rows, spec.seq_len, device="meta")
        want["all-gather"] += sum(c.numel() * c.element_size() for c in cache.values())
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
    gradient over "model"."""
    cfg = get_smoke_config(arch)
    spec = SHAPES["train_4k"]
    runs, params = {}, {}
    for layout in (False, True):
        rules = dryrun.cell_rules(cfg, spec, "single_pod", layout)
        with mesh_lib.fake_world() as mesh:
            counter, _ = dryrun.trace_sharded_cell(cfg, spec, mesh, rules)
        runs[layout] = counter
        params[layout] = _param_gathers(cfg, rules, ("data", "model"))
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
    extra = 3 * cfg.n_layers
    for layout, c in runs.items():
        n, b, _ = params[layout]
        assert c.by_op["all_gather_into_tensor"][0] == n + extra * layout
        assert c.collective_bytes["all-gather"] == (
            b + extra * layout * rows * spec.seq_len * cfg.d_model * act)
    attn = tmodel.init_params(cfg, None, device="meta").blocks[0].attn
    weights = list(attn.parameters())
    # the step's own all-reduces are torch.distributed's in place (allreduce_),
    # the layout's functional (all_reduce)
    assert "all_reduce" not in base.by_op
    assert lay.by_op["all_reduce"][0] == cfg.n_layers * len(weights)
    assert lay.by_op["allreduce_"][0] == base.by_op["allreduce_"][0]
    assert (lay.collective_bytes["all-reduce"] - base.collective_bytes["all-reduce"]
            == cfg.n_layers * sum(w.numel() * w.element_size() for w in weights))


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
