"""Port parity: the distributed runtime — sharding rules, logical axes,
straggler tracking, elastic planning, int8 compression, the meshes — held
against the reference's ``repro.distributed`` and ``repro.launch.mesh``,
and the sharded train step with its elastic re-shard on 8 gloo processes
held against the port's one-device step.

The rules, the straggler tracker, the mesh plans, the specs and the
logical axes are pure host code: equal.  The compression is held within
float32 rounding.  The processes rendezvous through a ``FileStore`` under
the test's own directory (no port), so the suite's parallel workers do
not collide.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch_distributed_worker as worker  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed import elastic as jelastic  # noqa: E402
from repro.distributed import rules as jrules  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.distributed import straggler as jstraggler  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim.adamw import adamw as jadamw  # noqa: E402
from repro.training.step import init_train_state as jinit_state  # noqa: E402
from repro.training.step import make_train_step as jmake_step  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import reference_leaf, train_state_from_arrays  # noqa: E402
from repro_torch.distributed import compression, elastic, rules, sharding, straggler  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim.adamw import adamw  # noqa: E402
from repro_torch.training.step import (  # noqa: E402
    AUX_WEIGHT,
    full_params,
    init_train_state,
    loss_and_grads,
    make_sharded_train_step,
    make_train_step,
    shard_train_state,
)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_distributed_worker.py"
KINDS = {"full": (jget_config, get_config), "smoke": (jget_smoke, get_smoke_config)}
JOBS = ("train", "prefill", "decode")
MODEL_AXES = (2, 4, 16)


def _configs(kind: str, arch: str):
    jget, tget = KINDS[kind]
    return jget(arch), tget(arch)


# ------------------------------------------------------------------ rules

@pytest.mark.parametrize("job", JOBS)
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_rules_and_attn_layout_equal_reference(arch, kind, job):
    """make_rules over multi_pod x model axes, and apply_attn_batch_layout
    of each over global batches and data axes: equal dicts."""
    jcfg, cfg = _configs(kind, arch)
    for multi_pod in (False, True):
        for model_axis in MODEL_AXES:
            kw = dict(multi_pod=multi_pod, job=job, model_axis=model_axis)
            got, want = rules.make_rules(cfg, **kw), jrules.make_rules(jcfg, **kw)
            assert got == want, kw
            for global_batch in (1, 2, 32, 256, 512):
                for data_axis in (1, 2, 16):
                    lay = dict(multi_pod=multi_pod, data_axis=data_axis, model_axis=model_axis)
                    assert (rules.apply_attn_batch_layout(got, cfg, global_batch, **lay)
                            == jrules.apply_attn_batch_layout(want, jcfg, global_batch, **lay))
                assert (rules.adjust_batch_rule(got, global_batch, multi_pod)
                        == jrules.adjust_batch_rule(want, global_batch, multi_pod))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_axis_for_equals_reference(multi_pod):
    for global_batch in range(0, 600):
        for data_axis in (1, 2, 4, 16):
            assert (rules.batch_axis_for(global_batch, multi_pod, data_axis)
                    == jrules.batch_axis_for(global_batch, multi_pod, data_axis))


def test_reference_rule_cases_hold_in_the_port():
    """tests/test_distributed.py's and tests/test_perf_levers.py's rule
    cases, on the port."""
    r = rules.make_rules(get_config("qwen3_8b"))
    assert r["q_heads"] == "model" and r["head_dim"] is None
    r = rules.make_rules(get_config("yi_34b"))
    assert r["q_heads"] is None and r["head_dim"] == "model"
    r = rules.make_rules(get_config("command_r_35b"), job="decode")
    assert r["head_dim"] == "model" and r["kv_heads"] is None
    assert rules.make_rules(get_config("granite_moe_1b_a400m"))["expert"] == "model"
    r = rules.make_rules(get_config("mixtral_8x22b"))
    assert r["expert"] is None and r["ff"] == "model"
    assert rules.batch_axis_for(256, False) == "data"
    assert rules.batch_axis_for(1, False) is None
    assert rules.batch_axis_for(256, True) == ("pod", "data")
    assert rules.batch_axis_for(2, True) == "pod"
    cfg = get_config("yi_34b")
    out = rules.apply_attn_batch_layout(rules.make_rules(cfg), cfg, 256, multi_pod=False)
    assert out["attn_batch"] == ("data", "model") and out["head_dim"] is None
    assert rules.apply_attn_batch_layout(rules.make_rules(cfg), cfg, 32,
                                         multi_pod=False)["attn_batch"] == "data"


# ----------------------------------------------------------- logical axes

def _tuple(spec) -> tuple:
    return tuple(spec)


def _reference_axes(tree: dict, name: str):
    """The reference tree's leaf (an axes tuple or a spec) for the port's
    name, its layer index dropped: the whole stacked leaf."""
    parts = name.split(".")
    if parts[0] in tmodel.STACKED:
        del parts[1]
    for part in parts:
        tree = tree[part]
    return tree


@pytest.mark.parametrize("job", JOBS)
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_equal_reference(arch, multi_pod, job):
    """param_logical_axes / cache_logical_axes by the port's names: each
    leaf the reference's axes less the leading "layers" of a per-layer
    subtree, a rank per tensor dimension; param_specs under make_rules
    and the default rule sets equal the reference's PartitionSpecs as
    tuples; logical_spec without rules is ()."""
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    jaxes = jmodel.param_logical_axes(jcfg)
    axes = tmodel.param_logical_axes(cfg)
    params = dict(tmodel.init_params(cfg, None, device="meta").named_parameters())
    assert set(axes) == set(params)
    for name, ax in axes.items():
        want = _reference_axes(jaxes, name)
        stacked = name.split(".")[0] in tmodel.STACKED
        assert ax == (want[1:] if stacked else want), name
        assert stacked == (want[0] == "layers"), name
        assert len(ax) == params[name].ndim, name
    cache = tmodel.init_decode_cache(cfg, 2, 64, device="meta")
    caxes = tmodel.cache_logical_axes(cfg)
    assert caxes == jmodel.cache_logical_axes(jcfg)
    assert {k: len(v) for k, v in caxes.items()} == {k: t.ndim for k, t in cache.items()}
    base = sharding.LOGICAL_RULES_MULTI_POD if multi_pod else sharding.LOGICAL_RULES_SINGLE_POD
    assert base == (jsharding.LOGICAL_RULES_MULTI_POD if multi_pod
                    else jsharding.LOGICAL_RULES_SINGLE_POD)
    for model_axis in MODEL_AXES:
        for r in (rules.make_rules(cfg, multi_pod=multi_pod, job=job, model_axis=model_axis),
                  base):
            specs = sharding.param_specs(axes, r)
            jspecs = jsharding.param_specs(jaxes, r)
            for name, spec in specs.items():
                want = _tuple(_reference_axes(jspecs, name))
                assert spec == (want[1:] if name.split(".")[0] in tmodel.STACKED else want)
            assert (sharding.param_specs(caxes, r)
                    == {k: _tuple(v) for k, v in jsharding.param_specs(
                        jmodel.cache_logical_axes(jcfg), r).items()})
    assert sharding.logical_spec(("batch", "embed")) == _tuple(jsharding.logical_spec(
        ("batch", "embed"))) == ()


def test_use_rules_is_thread_local_and_nests():
    import threading

    seen = {}
    with sharding.use_rules({"batch": "data"}):
        with sharding.use_rules({"batch": None}):
            assert sharding.logical_spec(("batch",)) == (None,)
        assert sharding.logical_spec(("batch", None)) == ("data", None)
        t = threading.Thread(target=lambda: seen.update(rules=sharding.active_rules()))
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert seen["rules"] is None and sharding.active_rules() is None


def test_constraints_return_their_input_outside_rules_or_when_layouts_match():
    """tests/test_perf_levers.py:45-52 and the no-rules case of both
    functions: the object itself, untouched."""
    x = torch.ones(4, 8)
    assert sharding.logical_constraint(x, ("batch", None)) is x
    assert sharding.boundary_pin(x, ("batch", None)) is x
    with sharding.use_rules({"batch": "data", "attn_batch": "data"}):
        assert sharding.boundary_pin(x, ("batch", None)) is x


def test_constraints_reach_with_sharding_constraint_under_rules(monkeypatch):
    """tests/test_perf_levers.py:55-67: on a layout mismatch the pin, and
    under rules every logical_constraint, calls the port's
    with_sharding_constraint once with the reference's spec."""
    calls = []
    monkeypatch.setattr(sharding, "with_sharding_constraint",
                        lambda x, spec: calls.append(spec) or x)
    x = torch.ones(4, 8)
    r = {"batch": "data", "attn_batch": ("data", "model")}
    with sharding.use_rules(r):
        sharding.boundary_pin(x, ("batch", None))
    assert calls == [_tuple(jax.sharding.PartitionSpec("data", None))]
    with sharding.use_rules(r):
        sharding.logical_constraint(x, ("attn_batch", None, "batch"))
    assert calls[1] == (("data", "model"), None, "data")


# -------------------------------------------------------------- straggler

def _drive_tracker(mod, seed: int) -> list:
    """A seeded stream of observations, straggler scans, evictions and
    reassignments; every answer and the tracker's state after each."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    cfg = mod.StragglerConfig(k_dev=float(rng.uniform(0.5, 3.0)), ewma=float(rng.uniform(0.5,
                              0.95)), evict_after=int(rng.integers(1, 6)),
                              min_samples=int(rng.integers(1, 6)))
    tr = mod.StragglerTracker(n, cfg)
    slow = set(rng.choice(n, size=int(rng.integers(0, n)), replace=False).tolist())
    log = []
    for _ in range(60):
        op = rng.integers(0, 4)
        if op < 2:
            w = int(rng.integers(0, n))
            tr.observe(w, float(rng.gamma(4.0, 0.25)) * (3.0 if w in slow else 1.0))
        elif op == 2:
            log.append(("stragglers", tr.stragglers(), tr.to_evict()))
        else:
            mb = {w: list(range(3 * w, 3 * w + int(rng.integers(0, 4)))) for w in range(n)}
            log.append(("reassign", tr.reassign(mb)))
        log.append((tr.mean, tr.dev, tr.samples, tr.flag_streak, tr.fleet_mean(),
                    tr.fleet_dev()))
    return log


@pytest.mark.parametrize("seed", range(8))
def test_straggler_tracker_equals_reference_on_seeded_streams(seed):
    assert _drive_tracker(straggler, seed) == _drive_tracker(jstraggler, seed)


def test_straggler_reference_cases_hold_in_the_port():
    tr = straggler.StragglerTracker(4, straggler.StragglerConfig(min_samples=4, k_dev=2.0))
    for _ in range(10):
        for w in range(4):
            tr.observe(w, 1.0 if w != 3 else 3.0)
    assert tr.stragglers() == [3]
    out = tr.reassign({0: [0, 1], 1: [2, 3], 2: [4, 5], 3: [6, 7]})
    assert len(out[3]) == 1 and sorted(sum(out.values(), [])) == list(range(8))
    tr = straggler.StragglerTracker(2, straggler.StragglerConfig(min_samples=2, k_dev=1.5,
                                                                 evict_after=3))
    for _ in range(10):
        tr.observe(0, 1.0)
        tr.observe(1, 5.0)
        tr.stragglers()
    assert tr.to_evict() == [1]


# ---------------------------------------------------------------- elastic

def _plan(plan) -> tuple:
    return plan.pods, plan.data, plan.model


def test_plan_mesh_and_grad_accum_equal_reference():
    assert elastic.SUPPORTED_MESHES == jelastic.SUPPORTED_MESHES
    for n in range(1, 601):
        got, want = elastic.plan_mesh(n), jelastic.plan_mesh(n)
        assert _plan(got) == _plan(want), n
        assert (got.n_devices, got.multi_pod) == (want.n_devices, want.multi_pod)
    for mod in (elastic, jelastic):
        with pytest.raises(RuntimeError, match="no devices"):
            mod.plan_mesh(0)
    for args in [(256, 16, 8, 2), (256, 16, 16, 2), (7, 4, 3, 2), (1, 2, 1, 1), (300, 8, 5, 7)]:
        assert elastic.grad_accum_factor(*args) == jelastic.grad_accum_factor(*args)


@pytest.fixture
def world1(tmp_path):
    """A gloo process group of one rank, rendezvous by a FileStore under
    the test's directory."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_meshes_name_both_sizes_when_the_world_is_too_small(world1):
    from torch.distributed.device_mesh import DeviceMesh

    with pytest.raises(RuntimeError, match=r"needs 4 ranks, the process group has 1"):
        tmesh.make_debug_mesh((2, 2))
    with pytest.raises(RuntimeError, match=r"\(16, 16\) needs 256 ranks.* has 1"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match=r"\(2, 16, 16\) needs 512 ranks.* has 1"):
        tmesh.make_production_mesh(multi_pod=True)
    mesh = elastic.plan_mesh(1).build()
    assert isinstance(mesh, DeviceMesh)
    assert mesh.mesh_dim_names == ("data", "model") and mesh.device_type == "cpu"
    assert tmesh.active_mesh() is None
    with tmesh.mesh_context(mesh):
        assert tmesh.active_mesh() is mesh
    assert tmesh.active_mesh() is None


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_debug_mesh((1, 1))


def test_placements_follow_the_spec_in_mesh_order(world1):
    from torch.distributed.tensor import Replicate, Shard

    mesh = tmesh.make_debug_mesh((1, 1, 1), ("pod", "data", "model"))
    assert sharding.placements(("model", "data"), mesh) == (Replicate(), Shard(1), Shard(0))
    assert sharding.placements((None, ("pod", "data")), mesh) == (Shard(1), Shard(1),
                                                                  Replicate())
    assert sharding.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="twice"):
        sharding.placements(("data", "data"), mesh)
    with pytest.raises(ValueError, match="'expert'"):
        sharding.placements(("expert",), mesh)


def test_reshard_state_places_redistributes_and_moves_meshes(world1):
    """reshard_state: a plain tensor distributed by its spec, a DTensor of
    the mesh redistributed, one of another mesh moved over; the values
    kept.  Under rules and the active mesh, logical_constraint
    redistributes a DTensor and leaves a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    cfg = get_smoke_config("qwen3_8b")
    r = rules.make_rules(cfg, model_axis=1)
    mesh = tmesh.make_debug_mesh((1, 1))
    params = {n: p.detach() for n, p in tmodel.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu").named_parameters()}
    axes = tmodel.param_logical_axes(cfg)
    placed = elastic.reshard_state(params, axes, mesh, r)
    assert all(isinstance(x, DTensor) for x in placed.values())
    assert placed["embed"].placements == (Shard(1), Shard(0))        # (vocab, embed)
    assert placed["final_norm"].placements == (Replicate(), Replicate())
    again = elastic.reshard_state(placed, axes, mesh, {**r, "embed": None, "vocab": None})
    assert again["embed"].placements == (Replicate(), Replicate())
    other = tmesh.make_debug_mesh((1, 1, 1), ("pod", "data", "model"))
    moved = elastic.reshard_state(again, axes, other, {**r, "batch": ("pod", "data")})
    assert moved["embed"].device_mesh == other
    for n, p in params.items():
        assert torch.equal(moved[n].full_tensor(), p), n
    x = placed["embed"]
    with tmesh.mesh_context(mesh), sharding.use_rules({"vocab": None, "embed": "model"}):
        y = sharding.logical_constraint(x, ("vocab", "embed"))
        assert y.placements == (Replicate(), Shard(1))
        plain = torch.ones(3)
        assert sharding.logical_constraint(plain, ("embed",)) is plain


def test_shard_train_state_refuses_other_optimizer_states(world1):
    cfg = get_smoke_config("qwen3_8b")
    state = init_train_state(cfg, adamw(1e-3), torch.Generator().manual_seed(0), device="cpu")
    state["opt_state"]["comp_err"] = {}
    with pytest.raises(ValueError, match="AdamW"):
        shard_train_state(state, cfg, tmesh.make_debug_mesh((1, 1)), rules.make_rules(cfg))


def test_sharded_step_on_one_rank_equals_the_one_device_step_bit_for_bit(world1):
    """On a (1, 1) mesh the sharded step's loss and parameters are the
    one-device step's, bit for bit (the batch is not split)."""
    cfg = get_smoke_config("qwen3_8b")
    opt = adamw(1e-3)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 33))
                              .astype(np.int32))
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    mesh = tmesh.make_debug_mesh((1, 1))
    r = rules.make_rules(cfg, model_axis=1)
    one, sharded = (init_train_state(cfg, opt, torch.Generator().manual_seed(0), device="cpu")
                    for _ in range(2))
    sharded = shard_train_state(sharded, cfg, mesh, r)
    step, sstep = make_train_step(cfg, opt), make_sharded_train_step(cfg, opt, mesh)
    for _ in range(2):
        one, m = step(one, batch)
        sharded, sm = sstep(sharded, batch)
        assert torch.equal(m["loss"], sm["loss"]) and torch.equal(m["tokens"], sm["tokens"])
    got = full_params(sharded)
    for n, p in one["params"].named_parameters():
        assert torch.equal(got[n], p.detach()), n
    assert sharded["step"] == one["step"] == 2 == sharded["opt_state"]["step"]


# ------------------------------------------------------------ compression

def _grads(seed: int, dtype) -> dict:
    rng = np.random.default_rng(seed)
    shapes = {"w": (64, 64), "b": (64,), "e": (3, 5, 7), "z": (4, 4)}
    out = {n: (rng.standard_normal(s) * 10.0 ** rng.uniform(-6, 1)).astype(np.float32)
           for n, s in shapes.items()}
    out["z"][:] = 0.0
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_int8_matches_reference(dtype):
    """Ten rounds with the error fed back: dequantized gradients (in the
    gradient's dtype) and residuals within float32 rounding of their
    scale (one float32 ulp of max|g + e|; an int8 level may round the
    other way only at an exact half, which both round to even)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    err_t, err_j = None, None
    for step in range(10):
        g = _grads(step, dtype)
        gt = {n: torch.from_numpy(x).to(tdt) for n, x in g.items()}
        gj = {n: jnp.asarray(x).astype(jdt) for n, x in g.items()}
        ct, err_t = compression.compress_int8(gt, err_t)
        cj, err_j = jcomp.compress_int8(gj, err_j)
        for n in g:
            assert ct[n].dtype == tdt
            want_g = np.asarray(cj[n].astype(jnp.float32))
            want_e = np.asarray(err_j[n])
            scale = float(np.abs(want_g).max() + np.abs(want_e).max())
            atol = scale * 2.0 ** -23
            np.testing.assert_allclose(ct[n].float().numpy(), want_g, rtol=0, atol=atol)
            np.testing.assert_allclose(err_t[n].numpy(), want_e, rtol=0, atol=atol)


def test_compress_int8_rounds_half_to_even_and_keeps_the_ratio():
    g = {"w": torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -3.5])}
    c, e = compression.compress_int8(g, None)
    assert c["w"].tolist() == [127.0, 0.0, 2.0, 2.0, -0.0, -4.0]
    jc, _ = jcomp.compress_int8({"w": jnp.asarray(g["w"].numpy())}, None)
    assert np.asarray(jc["w"]).tolist() == c["w"].tolist()
    assert torch.equal(e["w"], g["w"] - c["w"])
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32),
                     (torch.float16, jnp.float16)):
        assert compression.compression_ratio(tdt) == jcomp.compression_ratio(jdt)
    assert compression.compression_ratio() == jcomp.compression_ratio() == 2.0


def test_int8_scale_is_the_correctly_rounded_quotient():
    """The scale is ``amax / 127`` rounded once in float32 (numpy's float32
    division), on amaxes where the product with the rounded reciprocal
    ``1/127`` (what CUDA computes for a Python-scalar divisor) differs
    from it, and at the clamp."""
    rng = np.random.default_rng(0)
    amax = (rng.uniform(1.0, 2.0, 4096) * 10.0 ** rng.integers(-6, 2, 4096)).astype(np.float32)
    want = amax / np.float32(127.0)
    assert (amax * (np.float32(1.0) / np.float32(127.0)) != want).sum() > 100
    got = compression.int8_scale(torch.from_numpy(amax)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)
    zero = compression.int8_scale(torch.zeros((), dtype=torch.float32))
    assert zero.item() == np.float32(1e-30) / np.float32(127.0)


def test_error_feedback_removes_the_bias():
    """tests/test_training_optim.py:126 on the port: the mean of 50
    dequantized copies of one gradient converges to it."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64))
                               .astype(np.float32))}
    err = compression.init_error_state(g)
    total = torch.zeros_like(g["w"])
    for _ in range(50):
        gc, err = compression.compress_int8(g, err)
        total = total + gc["w"]
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(), atol=2e-2)


def _keeping(compress):
    """``compress`` as a compressor whose state also keeps the
    dequantized gradients it returned: ``{"err": ..., "deq": ...}``."""
    def run(grads, state):
        deq, err = compress(grads, None if state is None else state["err"])
        return deq, {"err": err, "deq": deq}
    return run


def test_train_step_with_int8_compression_matches_reference():
    """Three AdamW steps through make_train_step(compressor=compress_int8)
    against the reference's make_train_step(compressor=compress_int8), each
    from the reference's state carried over (weights, moments, residual)
    and one seeded batch.  Each loss within 1e-5.  The dequantized
    gradient of every leaf within one int8 level (its scale, max|g + e| /
    127) of the reference's everywhere, and within 1e-5 of max|g + e|
    wherever the level is the same; each leaf's largest level equal (one
    scale per reference leaf): the two gradients differ by float32
    rounding, so a level differs only where they straddle a half level.
    The residual, both moments and every parameter within 1e-4 of their
    largest element (``lm_head`` 1e-3, as in tests/test_torch_training.py)
    where the level is the same; where it differs, the residual within
    one level and the parameter within Adam's step, 2 lr."""
    lr = 3e-3
    jcfg, cfg = jget_smoke("qwen3_8b"), get_smoke_config("qwen3_8b")
    jopt = jadamw(lr)
    jstate = jinit_state(jcfg, jopt, jax.random.PRNGKey(0))
    jstep = jax.jit(jmake_step(jcfg, jopt, compressor=_keeping(jcomp.compress_int8)))
    step = make_train_step(cfg, adamw(lr), compressor=_keeping(compression.compress_int8))
    rng = np.random.default_rng(3)

    def rel_err(got, want) -> np.ndarray:
        want = np.asarray(want, np.float64)
        return np.abs(got.detach().double().numpy() - want) / max(np.abs(want).max(), 1e-30)

    for i in range(3):
        host = jax.tree.map(np.asarray, jstate)
        state = train_state_from_arrays(host, cfg, "adamw", "cpu")
        if i:
            state["opt_state"]["comp_err"] = {"err": {
                n: torch.from_numpy(np.array(reference_leaf(host["opt_state"]["comp_err"]["err"],
                                                            n)))
                for n in state["opt_state"]["mu"]}}
        tokens = rng.integers(0, cfg.vocab, (4, 24)).astype(np.int32)
        batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(x) for k, x in batch.items()})
        state, m = step(state, {k: torch.from_numpy(x) for k, x in batch.items()})
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= 1e-5 * abs(want), i
        jerr, jdeq = jstate["opt_state"]["comp_err"]["err"], jstate["opt_state"]["comp_err"]["deq"]
        tdeq = state["opt_state"]["comp_err"]["deq"]
        for name, p in state["params"].named_parameters():
            got_g = tdeq[name].double().numpy()
            want_g = np.asarray(reference_leaf(jdeq, name), np.float64)
            group = [n for n in tdeq if compression.scale_group(n)
                     == compression.scale_group(name)]
            amax = max(float(np.abs(np.asarray(reference_leaf(jdeq, n))).max()
                             + np.abs(np.asarray(reference_leaf(jerr, n))).max())
                       for n in group)
            level = amax / 127
            # one scale per reference leaf: its largest element is +-127 levels
            top_t = max(float(tdeq[n].abs().max()) for n in group)
            top_j = max(float(np.abs(np.asarray(reference_leaf(jdeq, n))).max()) for n in group)
            assert abs(top_t - top_j) <= 1e-5 * top_j, (i, name)
            diff = np.abs(got_g - want_g)
            flipped = diff > 0.5 * level
            assert diff.max() <= level * (1 + 1e-3), (i, name)
            assert np.all(diff[~flipped] <= 1e-5 * amax), (i, name)
            err_diff = np.abs(state["opt_state"]["comp_err"]["err"][name].double().numpy()
                              - np.asarray(reference_leaf(jerr, name), np.float64))
            assert np.all(err_diff <= np.where(flipped, level * (1 + 1e-3), 1e-5 * amax)), name
            bar = 1e-3 if name == "lm_head" else 1e-4
            for key in ("mu", "nu"):
                e = rel_err(state["opt_state"][key][name],
                            reference_leaf(jstate["opt_state"][key], name))
                assert np.all(e[~flipped] <= 1e-4), (i, key, name)
            want_p = np.asarray(reference_leaf(jstate["params"], name), np.float64)
            e = rel_err(p, want_p)
            assert np.all(e[~flipped] <= bar), (i, name)
            assert np.all(e[flipped] * np.abs(want_p).max() <= 2 * lr), (i, name)
    assert state["step"] == int(jstate["step"]) == 3


# ------------------------------------------------- the sharded train step

WORLD = 8
TIME_LIMIT_S = 240      # all 8 ranks together; about 15 s alone
LR = 1e-3
# a leaf whose largest gradient is below this share of the model's
# largest is rounding noise: its gradient is zero in exact arithmetic
NOISE_SHARE = 1e-6
# the exempted elements of _hold_params stay under this share of the
# model's (those of its noise leaves aside)
AMPLIFIED_SHARE = 1e-3


def _hold_gradients(got: dict, want: dict, noise: set) -> None:
    """Every element of the sharded step's step-1 gradients within 1e-5
    of its leaf's largest one-device gradient (of the model's largest for
    a noise leaf)."""
    top = max(float(w.abs().max()) for w in want.values())
    for n, w in want.items():
        err = float((got[n] - w).abs().max())
        bar = 1e-5 * (top if n in noise else float(w.abs().max()))
        assert err <= bar, ("step-1 gradient", n, err, bar)


def _hold_params(got: dict, want: dict, k: int, gap: dict, noise: set) -> int:
    """Every parameter after step ``k`` within 1e-5 of its leaf's max|p|,
    but within 2 lr a step in a noise leaf and in an element whose first
    Adam steps from the two step-1 gradients (held by _hold_gradients)
    land further apart than that bar (``gap``,
    worker.adam_first_step_gap); returns the number of such elements."""
    amplified = 0
    for n, w in want.items():
        bar = 1e-5 * float(w.abs().max())
        free = torch.ones_like(w, dtype=torch.bool) if n in noise else gap[n] > bar
        amplified += 0 if n in noise else int(free.sum())
        err = (got[n] - w).abs()
        assert bool((err <= torch.where(free, 2 * LR * k, bar)).all()), (
            n, k, float(err.max()), bar)
    return amplified


def _one_device(batch: dict) -> tuple[list, dict, dict]:
    """The port's one-device step from the workers' state: losses, the
    parameters after steps 2 and 4, and each leaf's step-1 gradient."""
    cfg = get_smoke_config("qwen3_8b")
    opt = adamw(LR)
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(worker.SEED),
                             device="cpu")
    _, grads = loss_and_grads(state["params"], batch, cfg, AUX_WEIGHT)
    step = make_train_step(cfg, opt)
    losses, snaps = [], {}
    for i in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        snaps[i + 1] = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
    return losses, snaps, grads


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """The 8 gloo ranks of tests/torch_distributed_worker.py, within
    TIME_LIMIT_S together; rank 0's results."""
    out = tmp_path_factory.mktemp("sharded")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD),
                               str(out / "store"), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              cwd=str(ROOT))
             for r in range(WORLD)]
    logs, deadline = [], time.monotonic() + TIME_LIMIT_S
    try:
        for p in procs:
            log = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0]
            logs.append(log.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs) if p.returncode]
    assert not bad, bad
    return torch.load(out / "rank0.pt", weights_only=True)


@pytest.mark.parametrize("batch_name", ["threes", "seeded"])
def test_sharded_step_and_elastic_reshard_match_the_one_device_step(sharded_run, batch_name,
                                                                    request):
    """Two steps on (2, 4), plan_mesh(4), a re-shard to (2, 2), two more
    steps, tensor parallel over "model": each loss within 1e-5 of the
    one-device step's, every element of the step-1 gradients within 1e-5
    of its leaf's max|g|, and every parameter after steps 2 and 4 within
    1e-5 of its leaf's max|p|.  On the reference's batch (every token 3)
    the attention output does not depend on q or k, so wq, wk, q_norm and
    k_norm take gradients that are zero in exact arithmetic (float32
    rounding, under NOISE_SHARE of the model's largest); Adam's u = m /
    (sqrt(v) + eps) maps that rounding, which the split batch and the
    split products sum in another order, to any value in (-1, 1), so
    those leaves are held to the steps' own size, 2 lr a step.  So is an
    element where Adam's first step, from two step-1 gradients that
    agree, lands further apart than the bar: a gradient within a few eps
    of zero (_hold_params; the number of such elements is recorded as
    the test's ``adam_amplified_elements`` property).  The seeded batch
    has no noise leaf."""
    cfg = get_smoke_config("qwen3_8b")
    res = sharded_run[batch_name]
    losses, snaps, grads = _one_device(worker.batches(cfg.vocab)[batch_name])
    gmax = {n: float(g.abs().max()) for n, g in grads.items()}
    assert res["plan"] == (1, 2, 2) and res["step"] == res["opt_step"] == 4
    assert res["local_shapes_2x4"] == {"embed": (cfg.vocab_padded // 4, cfg.d_model // 2),
                                       "blocks.0.attn.wq": (cfg.d_model // 2, 1, cfg.head_dim),
                                       "blocks.0.attn.wk": (cfg.d_model // 2, 2, cfg.head_dim)}
    assert res["local_shapes_2x2"] == {"embed": (cfg.vocab_padded // 2, cfg.d_model // 2),
                                       "blocks.0.attn.wq": (cfg.d_model // 2, 2, cfg.head_dim),
                                       "blocks.0.attn.wk": (cfg.d_model // 2, 1, cfg.head_dim)}
    for got, want in zip(res["losses"], losses, strict=True):
        assert abs(got - want) <= 1e-5 * abs(want), (res["losses"], losses)
    top = max(gmax.values())
    noise = {n for n, g in gmax.items() if g < NOISE_SHARE * top}
    assert noise == (set() if batch_name == "seeded" else {
        f"blocks.{i}.attn.{w}" for i in range(cfg.n_layers)
        for w in ("wq", "wk", "q_norm", "k_norm")})
    _hold_gradients(res["grads_1"], grads, noise)
    gap = worker.adam_first_step_gap(res["grads_1"], grads)
    amplified = {key: _hold_params(res[key], snaps[k], k, gap, noise)
                 for key, k in (("params_2", 2), ("params_4", 4))}
    request.node.user_properties.append(("adam_amplified_elements", amplified))
    total = sum(w.numel() for n, w in snaps[2].items() if n not in noise)
    assert max(amplified.values()) <= AMPLIFIED_SHARE * total, (amplified, total)


def test_attention_batch_layout_keeps_the_one_device_step(sharded_run, request):
    """Two steps on (2, 4) with the attention batch layout (each "model"
    rank runs attention on 1 of its "data" rank's 4 rows, the output
    all-gathered, the gathered gradient sliced, the slice's gradient
    gathered, the attention weights' gradients summed over "model"):
    each loss within 1e-5 of the one-device step's, every element of the
    step-1 gradients within 1e-5 of its leaf's max|g|, and every parameter
    within 1e-5 of its leaf's max|p| (the seeded batch has no noise leaf;
    an element that Adam's first step drives apart within 2 lr a step, as
    in test_sharded_step_and_elastic_reshard_match_the_one_device_step);
    3 all-gathers a layer a step (the forward's, block remat's recompute,
    the slice's gradient).  Outside attention the step is tensor parallel
    over "model"."""
    cfg = get_smoke_config("qwen3_8b")
    res = sharded_run["layout"]
    opt = adamw(LR)
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(worker.SEED),
                             device="cpu")
    _, grads = loss_and_grads(state["params"], worker.layout_batch(cfg.vocab), cfg, AUX_WEIGHT)
    step, losses = make_train_step(cfg, opt), []
    for _ in range(2):
        state, m = step(state, worker.layout_batch(cfg.vocab))
        losses.append(float(m["loss"]))
    assert res["gathers"] == 3 * cfg.n_layers * 2
    for got, want in zip(res["losses"], losses, strict=True):
        assert abs(got - want) <= 1e-5 * abs(want), (res["losses"], losses)
    _hold_gradients(res["grads_1"], grads, set())
    want = {n: p.detach() for n, p in state["params"].named_parameters()}
    amplified = _hold_params(res["params_2"], want, 2,
                             worker.adam_first_step_gap(res["grads_1"], grads), set())
    request.node.user_properties.append(("adam_amplified_elements", amplified))
    assert amplified <= AMPLIFIED_SHARE * sum(w.numel() for w in want.values()), amplified
