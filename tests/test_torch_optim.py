"""Port parity: the optimizers — AdamW, AnalogNewton and its
preconditioner refresh through the circuit, the cosine schedule — against
the reference's ``repro.optim``, and AnalogNewton's rule of which leaves
get a preconditioner.

Float32 updates on equal gradients within 1e-6 of each array's largest
element; the schedule within 1e-7; the refreshed block inverses within
1e-6 (each backend's solve in float64 on both sides), with the refresh
counters equal.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim.adamw import adamw as jadamw  # noqa: E402
from repro.optim.adamw import apply_updates as japply  # noqa: E402
from repro.optim.schedule import cosine_schedule as jcosine  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim.adamw import adamw, apply_updates  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402

# the packages export the function analog_newton under the module's name
jan = importlib.import_module("repro.optim.analog_newton")
tan = importlib.import_module("repro_torch.optim.analog_newton")

CPU = "cpu"
SHAPES = {"w": (48, 40), "lm_head": (40, 96), "bias": (40,)}


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _params(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in SHAPES.items()}


def _run(jopt, topt, steps, refresh=None):
    """``steps`` updates of both optimizers on the same gradients (drawn
    anew each step), the updates applied; the states and parameters."""
    p_np = _params(0)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(1)
    for i in range(steps):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        ju, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        tu, tstate = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp)
        for k in SHAPES:
            assert _rel(tu[k], ju[k]) <= 1e-6, (i, k)
        jp = japply(jp, ju)
        apply_updates(tp, tu)
        if refresh is not None and (i + 1) % refresh[0].refresh_every == 0:
            jstate = jan.refresh_preconditioner(jstate, refresh[0])
            tstate = tan.refresh_preconditioner(tstate, refresh[1])
    return jstate, tstate, jp, tp


def test_adamw_updates_match_reference():
    jstate, tstate, jp, tp = _run(jadamw(3e-2, weight_decay=0.1, grad_clip=1.0),
                                  adamw(3e-2, weight_decay=0.1, grad_clip=1.0), 6)
    assert tstate["step"] == int(jstate["step"]) == 6
    for k in SHAPES:
        assert _rel(tp[k], jp[k]) <= 1e-6, k
        assert _rel(tstate["mu"][k], jstate["mu"][k]) <= 1e-6, k
        assert _rel(tstate["nu"][k], jstate["nu"][k]) <= 1e-6, k


def test_adamw_keeps_bf16_parameters_and_float32_moments():
    """bf16 parameters: float32 moments, updates rounded to bf16 once, as
    the reference's ``(-lr u).astype(p.dtype)``."""
    p = {"w": torch.randn(8, 8).to(torch.bfloat16)}
    opt = adamw(1e-2)
    state = opt.init(p)
    upd, state = opt.update({"w": torch.randn(8, 8).to(torch.bfloat16)}, state, p)
    assert state["mu"]["w"].dtype == torch.float32 and upd["w"].dtype == torch.bfloat16
    ju, _ = jadamw(1e-2).update({"w": jnp.asarray(np.zeros((8, 8)), jnp.bfloat16)},
                                jadamw(1e-2).init({"w": jnp.zeros((8, 8), jnp.bfloat16)}),
                                {"w": jnp.zeros((8, 8), jnp.bfloat16)})
    assert ju["w"].dtype == jnp.bfloat16


@pytest.mark.parametrize("backend", ["cholesky", "analog_2n", "cg"])
def test_analog_newton_updates_and_refresh_match_reference(backend):
    """AnalogNewton on equal gradients, with two refreshes through each
    backend: updates, mu and cov within 1e-6, the block inverses within
    1e-6, REFRESH_STATS equal.  The preconditioned leaves are the 2-D ones
    (``w`` and ``lm_head``), not ``bias``."""
    kw = dict(block=16, min_dim=8, max_blocks=4, refresh_every=3, backend=backend,
              damping=1e-3)
    jcfg, tcfg = jan.AnalogNewtonConfig(**kw), tan.AnalogNewtonConfig(**kw)
    jan.reset_refresh_stats()
    tan.reset_refresh_stats()
    jstate, tstate, jp, tp = _run(jan.analog_newton(0.05, jcfg, weight_decay=0.01),
                                  tan.analog_newton(0.05, tcfg, weight_decay=0.01), 7,
                                  refresh=(jcfg, tcfg))
    assert sorted(tstate["cov"]) == ["lm_head", "w"]
    assert jstate["cov"]["bias"] is None
    for k in ("lm_head", "w"):
        assert _rel(tstate["cov"][k], jstate["cov"][k]) <= 1e-6, k
        assert _rel(tstate["pinv"][k], jstate["pinv"][k]) <= 1e-6, k
    for k in SHAPES:
        assert _rel(tstate["mu"][k], jstate["mu"][k]) <= 1e-6, k
        assert _rel(tp[k], jp[k]) <= 1e-6, k
    assert dataclasses.asdict(tan.REFRESH_STATS) == dataclasses.asdict(jan.REFRESH_STATS)
    assert tan.REFRESH_STATS.refreshes == 2
    if backend != "cholesky":
        assert tan.REFRESH_STATS.solve_batch_calls == 2
    jan.reset_refresh_stats()
    tan.reset_refresh_stats()


def test_refresh_inverts_one_covariance_state():
    """From one covariance state (the reference's, carried across), each
    backend's block inverses within 1e-6 of the reference's; the analog
    ones also within 2e-2 of the exact damped inverse (the reference's own
    bar, tests/test_training_optim.py)."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((3, 8, 30))
    cov = np.einsum("brn,bsn->brs", g, g).astype(np.float32) / 30
    for backend in ("cholesky", "analog_2n", "cg"):
        kw = dict(block=8, min_dim=8, backend=backend, damping=1e-6)
        jcfg, tcfg = jan.AnalogNewtonConfig(**kw), tan.AnalogNewtonConfig(**kw)
        jan.reset_refresh_stats()
        tan.reset_refresh_stats()
        eye = np.broadcast_to(np.eye(8, dtype=np.float32), cov.shape).copy()
        jstate = jan.refresh_preconditioner(
            {"cov": {"w": jnp.asarray(cov)}, "pinv": {"w": jnp.asarray(eye)}}, jcfg)
        tstate = tan.refresh_preconditioner(
            {"cov": {"w": torch.from_numpy(cov)}, "pinv": {"w": torch.from_numpy(eye)}}, tcfg)
        assert _rel(tstate["pinv"]["w"], jstate["pinv"]["w"]) <= 1e-6, backend
        c = cov.astype(np.float64)
        damp = kw["damping"] * np.trace(c, axis1=1, axis2=2) / 8
        want = np.linalg.inv(c + damp[:, None, None] * np.eye(8))
        assert _rel(tstate["pinv"]["w"], want) <= 2e-2, backend
        assert dataclasses.asdict(tan.REFRESH_STATS) == dataclasses.asdict(jan.REFRESH_STATS)
    jan.reset_refresh_stats()
    tan.reset_refresh_stats()


def test_cosine_schedule_matches_reference():
    jlr = jcosine(3e-3, warmup_steps=11, total_steps=300, min_ratio=0.1)
    tlr = cosine_schedule(3e-3, warmup_steps=11, total_steps=300, min_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 12, 100, 299, 300, 450):
        want = float(jlr(jnp.asarray(step)))
        assert abs(tlr(step) - want) <= 1e-7 * abs(want), step
    assert tlr(5) < 3e-3 and tlr(300) < 0.15 * 3e-3


def _reference_preconditioned(jcfg_model, acfg) -> set:
    """The '/'-joined paths of the reference tree's preconditioned leaves."""
    shapes = jax.eval_shape(lambda: jmodel.init_params(jcfg_model, jax.random.PRNGKey(0)))
    cov = jax.eval_shape(lambda: jan.analog_newton(1e-2, acfg).init(
        jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)))["cov"]
    flat, _ = jax.tree_util.tree_flatten_with_path(cov)
    return {"/".join(str(p.key) for p in path) for path, _ in flat}


@pytest.mark.parametrize("which", ["qwen3_100m", "zamba2_7b", "qwen3_8b"])
def test_preconditioned_leaves_are_the_references(which):
    """Only the reference's unstacked 2-D leaves qualify: with train_lm's
    100M config, exactly ``lm_head`` (768 x 32768, 24 blocks of 32); with
    Zamba2's SMOKE config, the shared attention's MLP weights and the
    embedding tables that fit; never a layer's own 2-D weights, which the
    port holds unstacked."""
    import importlib.util
    import pathlib

    if which == "qwen3_100m":
        path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "train_lm_torch.py"
        spec = importlib.util.spec_from_file_location("train_lm_torch", path)
        ex = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ex)
        cfg = ex.lm_100m()
        kw = dict(block=32, min_dim=256, max_blocks=24)
        jcfg_model = dataclasses.replace(jget_smoke("qwen3_8b"), **{
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    else:
        cfg, jcfg_model = get_smoke_config(which), jget_smoke(which)
        kw = dict(block=16, min_dim=32, max_blocks=8)
    want = _reference_preconditioned(jcfg_model, jan.AnalogNewtonConfig(**kw))
    params = dict(tmodel.init_params(cfg, torch.Generator(), device=CPU).named_parameters())
    got = tan.preconditioned(params, tan.AnalogNewtonConfig(**kw))
    assert {n.replace(".", "/") for n in got} == want
    if which == "qwen3_100m":
        assert got == ["lm_head"] and tuple(params["lm_head"].shape) == (768, 32768)
        state = tan.analog_newton(1e-2, tan.AnalogNewtonConfig(**kw)).init(params)
        assert list(state["cov"]) == ["lm_head"]
        assert tuple(state["cov"]["lm_head"].shape) == (24, 32, 32)
    # a layer's own 2-D weights, which the port holds unstacked, never qualify
    assert any(n.split(".")[0] == "blocks" and p.ndim == 2 and min(p.shape) >= kw["min_dim"]
               for n, p in params.items())
    assert not any(n.split(".")[0] == "blocks" for n in got)


def test_stacked_leaf_the_reference_would_precondition_raises():
    """A (layers, d) stacked leaf that the reference would precondition
    (at least min_dim layers) is refused, not run differently."""
    params = {f"blocks.{i}.ln1": torch.ones(16) for i in range(20)}
    params["lm_head"] = torch.ones(32, 40)
    cfg = tan.AnalogNewtonConfig(block=16, min_dim=16, max_blocks=4)
    assert tan.reference_shapes(params)["blocks.3.ln1"] == (20, 16)
    with pytest.raises(NotImplementedError, match="blocks.0.ln1"):
        tan.preconditioned(params, cfg)
    assert tan.preconditioned(params, dataclasses.replace(cfg, min_dim=24)) == ["lm_head"]
