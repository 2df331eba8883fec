"""Port parity: the dense language-model serving path — layers, dense
blocks, ``prefill``/``decode_step`` and ``ServeEngine`` — against the
reference's on the SMOKE configs, with the reference's weights carried
across by ``repro_torch.convert.lm_params_from_arrays``.

The SMOKE configs are float32: Qwen3-8B (GQA, qk_norm), Granite-20B
(MQA) and Command-R (parallel attention and MLP).  On the CPU the
port's attention runs K8's plain version.  Logits are held within
1e-5 of max|logit| (float32 sums in another order through two layers);
greedy tokens must be equal.  Several reference engine tests use the
``mamba2_370m`` SSM config: their cases run here on the ``qwen3_8b``
SMOKE config, in both packages, and the engine's other families (moe,
ssm, hybrid) have their own greedy parity test.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving.faults import FaultInjector as JFaultInjector  # noqa: E402
from repro.serving.faults import FaultPlan as JFaultPlan  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AdmissionQueue,
    FaultInjector,
    FaultPlan,
    Request,
    ServeEngine,
)

CPU = "cpu"
DENSE = ["qwen3_8b", "granite_20b", "command_r_35b"]
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """SMOKE config, reference params and the port's copy, per dense arch."""
    out = {}
    for arch in DENSE:
        jcfg = jget_smoke(arch)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jp)
        cfg = get_smoke_config(arch)
        out[arch] = (jcfg, jp, cfg, lm_params_from_arrays(tree, cfg, CPU))
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close_scaled(got, want, tol=LOGIT_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))), err


def _tokens(cfg, bsz, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (bsz, s)).astype(np.int32)


# ---------------------------------------------------------------- configs


def test_configs_match_reference():
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        for mine, ref in ((get_config(arch), jget_config(arch)),
                          (get_smoke_config(arch), jget_smoke(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
            assert (mine.head_dim, mine.vocab_padded) == (ref.head_dim, ref.vocab_padded)
    q = get_config("qwen3_8b")
    assert (q.n_layers, q.d_model, q.n_heads, q.n_kv_heads, q.head_dim, q.d_ff) == \
        (36, 4096, 32, 8, 128, 12288)
    assert q.act_dtype() == torch.bfloat16 and q.p_dtype() == torch.bfloat16
    assert get_smoke_config("qwen3_8b").act_dtype() == torch.float32


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "internvl2_1b", "mamba2_370m",
                                  "whisper_base", "zamba2_7b"])
def test_unported_families_raise_naming_roadmap_item(arch):
    """The families that raised NotImplementedError naming their ROADMAP
    Queue 1 item (12.2-12.5) until they were ported: now each builds its
    parameters and its decode cache with the reference's names, shapes
    and dtypes (tests/test_torch_families.py holds their values)."""
    cfg = get_smoke_config(arch)
    jcfg = jget_smoke(arch)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    shapes = jax.eval_shape(lambda key: jmodel.init_params(jcfg, key), jax.random.PRNGKey(0))
    assert tmodel.count_params(params) == jmodel.count_params(shapes)
    assert tmodel.count_active_params(params, cfg) == jmodel.count_active_params(shapes, jcfg)
    cache = tmodel.init_decode_cache(cfg, 1, 8, device=CPU)
    ref = jax.eval_shape(lambda: jmodel.init_decode_cache(jcfg, 1, 8))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in cache.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in ref.items()}


def test_default_device_is_cuda_and_raises_without_it(monkeypatch, models):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen3_8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_decode_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, models["qwen3_8b"][3])


# ---------------------------------------------------------------- init


def test_init_params_shapes_scales_and_counts(models):
    """The port's own init keeps the reference's names, shapes, dtypes and
    scales (its values come from another RNG); counts and model FLOPs
    equal the reference's."""
    for arch in DENSE:
        jcfg, jp, cfg, _ = models[arch]
        mine = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
        flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
        for name, t in mine.named_parameters():
            parts = name.split(".")
            if parts[0] == "blocks":            # blocks.{i}.x.y <-> blocks/x/y[i]
                ref = flat["/".join(["blocks"] + parts[2:])][int(parts[1])]
            else:
                ref = flat[name]
            assert tuple(t.shape) == ref.shape, name
            assert t.dtype == torch.float32, name
            std_ref = float(np.std(np.asarray(ref)))
            std = float(t.std()) if t.numel() > 1 else 0.0
            if std_ref > 0:
                assert abs(std / std_ref - 1) < 0.1, (name, std, std_ref)
            else:
                assert torch.equal(t, torch.ones_like(t)), name
        assert tmodel.count_params(mine) == jmodel.count_params(jp)
        assert tmodel.model_flops(mine, cfg, 1000, train=False) == \
            jmodel.model_flops(jp, jcfg, 1000, train=False)
    gen_a, gen_b = (torch.Generator().manual_seed(7) for _ in range(2))
    a = tmodel.init_params(cfg, gen_a, device=CPU)
    b = tmodel.init_params(cfg, gen_b, device=CPU)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


# ---------------------------------------------------------------- layers


def test_layers_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    xt = torch.from_numpy(x)
    _close_scaled(tlayers.rms_norm(xt, torch.from_numpy(scale), 1e-6),
                  jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    np.testing.assert_allclose(tlayers.rope_frequencies(16, 1e6).numpy(),
                               np.asarray(jlayers.rope_frequencies(16, 1e6)), rtol=1e-6)
    # angles up to 5000 rad: float32 sin/cos of large arguments differ by
    # a few ulps of the angle between libraries
    _close_scaled(tlayers.apply_rope(xt, torch.from_numpy(pos), 1e6),
                  jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-4)
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("w_gate", (32, 64)), ("w_up", (32, 64)), ("w_down", (64, 32)))}
    mlp = tblocks.MLP(*(torch.from_numpy(w[k]) for k in ("w_gate", "w_up", "w_down")))
    _close_scaled(tlayers.swiglu_mlp(torch.from_numpy(h), mlp),
                  jlayers.swiglu_mlp(jnp.asarray(h), {k: jnp.asarray(v) for k, v in w.items()}))
    table = rng.standard_normal((50, 32)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 5))
    emb = tlayers.embed_tokens(torch.from_numpy(toks), torch.from_numpy(table))
    np.testing.assert_array_equal(emb.numpy(), np.asarray(
        jlayers.embed_tokens(jnp.asarray(toks), jnp.asarray(table))))
    _close_scaled(tlayers.unembed(emb, torch.from_numpy(table.T.copy())),
                  jlayers.unembed(jnp.asarray(emb.numpy()), jnp.asarray(table.T)))


def test_rope_is_split_half_not_interleaved():
    """Position p rotates the pair (x[i], x[i + d/2]) by p * freq[i]."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 1] = 1.0
    out = tlayers.apply_rope(x, torch.tensor([[3]]), 1e4)
    ang = 3 * float(tlayers.rope_frequencies(8, 1e4)[1])
    want = torch.zeros(8)
    want[1], want[5] = np.cos(ang), np.sin(ang)
    torch.testing.assert_close(out.reshape(8), want)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_block_forward_and_decode_match_reference(models, arch):
    jcfg, jp, cfg, tp = models[arch]
    jb = jax.tree.map(lambda a: a[0], jp["blocks"])
    tb = tp.blocks[0]
    rng = np.random.default_rng(6)
    b, s = 2, 12
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jout, (jk, jv) = jblocks.dense_block_forward(jnp.asarray(x), jb, jcfg, jnp.asarray(pos))
    with torch.inference_mode():
        tout, (tk, tv) = tblocks.dense_block_forward(torch.from_numpy(x), tb, cfg,
                                                     torch.from_numpy(pos).long())
    for got, want in ((tout, jout), (tk, jk), (tv, jv)):
        _close_scaled(got, want)
    # one decode step per slot at staggered positions against the same cache
    cache_k = rng.standard_normal((b, 16, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    cache_v = rng.standard_normal(cache_k.shape).astype(np.float32)
    x1 = x[:, :1]
    p = np.array([4, 9], np.int32)
    jo, jck, jcv = jblocks.dense_block_decode(jnp.asarray(x1), jb, jcfg, jnp.asarray(cache_k),
                                              jnp.asarray(cache_v), jnp.asarray(p))
    tck, tcv = torch.from_numpy(cache_k.copy()), torch.from_numpy(cache_v.copy())
    with torch.inference_mode():
        to = tblocks.dense_block_decode(torch.from_numpy(x1), tb, cfg, tck, tcv,
                                        torch.from_numpy(p))
    for got, want in ((to, jo), (tck, jck), (tcv, jcv)):
        _close_scaled(got, want)


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(models, arch):
    """prefill logits and caches, then three decode steps at a per-slot
    position vector (the second sequence lags by two), against the
    reference."""
    jcfg, jp, cfg, tp = models[arch]
    toks = _tokens(cfg, 2, 10)
    max_seq = 24
    jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, max_seq=max_seq)
    tl, tc = tmodel.prefill(tp, {"tokens": toks}, cfg, max_seq)
    _close_scaled(tl, jl)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        _close_scaled(tc[name], jc[name])
    pos = np.array([10, 8], np.int32)
    nxt = np.array([[3], [7]], np.int32)
    for _ in range(3):
        jl, jc = jmodel.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc, jcfg)
        tl, tc = tmodel.decode_step(tp, nxt, pos, tc, cfg)
        _close_scaled(tl, jl)
        for name in ("k", "v"):
            _close_scaled(tc[name], jc[name])
        nxt = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(models, arch):
    """The serving contract of tests/test_models_smoke.py:61-92: decode on
    the prefix cache equals the full forward (the reference's
    forward_train), and the port's own prefill of the whole sequence."""
    jcfg, jp, cfg, tp = models[arch]
    bsz, s = 2, 32
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (bsz, s), 0, cfg.vocab),
                      np.int32)
    full, _ = jmodel.forward_train(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    lg_pre, cache = tmodel.prefill(tp, {"tokens": toks[:, :-1]}, cfg, s + 8)
    np.testing.assert_allclose(_np(lg_pre), np.asarray(full[:, -2, :]), rtol=1e-4, atol=1e-4)
    lg_dec, _ = tmodel.decode_step(tp, toks[:, -1:], s - 1, cache, cfg)
    np.testing.assert_allclose(_np(lg_dec), np.asarray(full[:, -1, :]), rtol=1e-4, atol=1e-4)
    lg_all, _ = tmodel.prefill(tp, {"tokens": toks}, cfg, s + 8)
    np.testing.assert_allclose(_np(lg_dec), _np(lg_all), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- engine


def _serve(engine_cls, request_cls, cfg, params, prompts, *, slots, max_seq=64, max_new=6,
           submit_kw=None, **kw):
    eng = engine_cls(cfg, params, batch_slots=slots, max_seq=max_seq, **kw)
    reqs = [request_cls(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    for r, skw in zip(reqs, submit_kw or [{}] * len(reqs)):
        eng.submit(r, **skw)
    eng.run(max_steps=300)
    return eng, reqs


def _both(models, prompts, *, slots, **kw):
    """Serve ``prompts`` with the reference engine and the port's on the
    qwen3_8b SMOKE config; return (reference, port) (engine, requests)."""
    jcfg, jp, cfg, tp = models["qwen3_8b"]
    jkw = dict(kw)
    if "fault_injector" in kw:
        plan = dataclasses.asdict(kw["fault_injector"].plan)
        jkw["fault_injector"] = JFaultInjector(JFaultPlan(**plan))
    ref = _serve(jengine.ServeEngine, jengine.Request, jcfg, jp, prompts, slots=slots, **jkw)
    mine = _serve(ServeEngine, Request, cfg, tp, prompts, slots=slots, device=CPU, **kw)
    return ref, mine


def test_serve_engine_greedy_matches_reference(models):
    """tests/test_roofline_serving.py:84-98: four requests through two
    slots; greedy tokens equal the reference engine's."""
    cfg = get_smoke_config("qwen3_8b")
    prompts = [np.arange(5 + i) % cfg.vocab for i in range(4)]
    (_, jreqs), (_, reqs) = _both(models, prompts, slots=2)
    for j, r in zip(jreqs, reqs):
        assert r.done and len(r.out) >= 6
        assert all(0 <= t < cfg.vocab_padded for t in r.out)
        assert r.out == j.out


def test_serve_engine_staggered_prompts_match_sequential(models):
    """tests/test_roofline_serving.py:116-146: staggered prompts decoded in
    a shared batch (the third admitted mid-stream) give the tokens of
    one-at-a-time decoding, and the reference's."""
    _, _, cfg, tp = models["qwen3_8b"]
    prompts = [np.arange(3) % cfg.vocab, (np.arange(9) * 7) % cfg.vocab,
               (np.arange(4) * 3) % cfg.vocab]
    (_, jreqs), (_, reqs) = _both(models, prompts, slots=2)
    _, seq = _serve(ServeEngine, Request, cfg, tp, prompts, slots=1, device=CPU)
    assert all(r.done for r in reqs + seq)
    assert [r.out for r in reqs] == [r.out for r in seq] == [r.out for r in jreqs]


def test_serve_engine_slot_recycling_and_priority_admission(models):
    """tests/test_roofline_serving.py:101-113 and :183-210 (their mamba2_370m
    cases run here on qwen3_8b, in both packages): one slot recycled over
    three requests; the priority-1 request takes the first freed slot
    ahead of the FIFO arrivals; tokens equal the reference's."""
    prompts = [np.arange(4)] * 3
    admitted = {}
    runs = []
    for engine_cls, request_cls, cfg, params, kw in (
            (jengine.ServeEngine, jengine.Request, *models["qwen3_8b"][:2], {}),
            (ServeEngine, Request, *models["qwen3_8b"][2:], {"device": CPU})):
        eng = engine_cls(cfg, params, batch_slots=1, max_seq=48, **kw)
        reqs = [request_cls(rid=i, prompt=p, max_new=3) for i, p in enumerate(prompts)]
        eng.submit(reqs[0])
        eng.submit(reqs[1])
        eng.submit(reqs[2], priority=1)
        order = admitted.setdefault(engine_cls, [])
        orig = eng._prefill_slot

        def spy(slot, req, orig=orig, order=order):
            order.append(req.rid)
            return orig(slot, req)

        eng._prefill_slot = spy
        eng.run(max_steps=100)
        assert all(r.done and len(r.out) == 3 for r in reqs)
        runs.append([r.out for r in reqs])
    assert admitted[ServeEngine] == admitted[jengine.ServeEngine] == [2, 0, 1]
    assert runs[0] == runs[1]


def test_admission_queue_ordering_and_requeue():
    """tests/test_roofline_serving.py:148-181: priority first, EDF within a
    class (deadline=None last), FIFO ties; requeue keeps the original
    rank."""
    q = AdmissionQueue()
    fifo1 = q.push(Request(rid=0, prompt=np.arange(2)))
    late = q.push(Request(rid=1, prompt=np.arange(2)), deadline=2.0)
    soon = q.push(Request(rid=2, prompt=np.arange(2)), deadline=1.0)
    hi = q.push(Request(rid=3, prompt=np.arange(2)), priority=1, deadline=9.0)
    fifo2 = q.push(Request(rid=4, prompt=np.arange(2)))
    assert [q.pop() for _ in range(len(q))] == [hi, soon, late, fifo1, fifo2]
    with pytest.raises(IndexError):
        q.pop()

    first = q.push(Request(rid=0, prompt=np.arange(2)), priority=2)
    second = q.push(Request(rid=1, prompt=np.arange(2)))
    drained = q.pop_all()
    assert drained == [first, second] and not q
    q.requeue(drained)
    newcomer = q.push(Request(rid=2, prompt=np.arange(2)))
    assert q.pop_all() == [first, second, newcomer]
    assert q.discard(lambda r: r.rid == 1) == [] and len(q) == 0


def test_admission_queue_preserves_explicit_stamps():
    """tests/test_faults.py:347-364."""
    q = AdmissionQueue()
    pre = Request(rid=0, prompt=np.arange(3), priority=7, deadline=42.0)
    q.push(pre)
    assert pre.priority == 7 and pre.deadline == 42.0
    over = Request(rid=1, prompt=np.arange(3), priority=7)
    q.push(over, priority=1, deadline=5.0)
    assert over.priority == 1 and over.deadline == 5.0
    assert q.pop() is pre
    seq = pre.seq
    q.requeue([pre])
    assert pre.seq == seq and q.pop() is pre


def test_serve_engine_rejects_expired_deadline(models):
    """tests/test_faults.py:367-386 on qwen3_8b, in both packages: the
    expired request is never prefilled; the fresh one is served."""
    now = time.monotonic()
    kw = dict(slots=1, max_seq=48, max_new=3,
              submit_kw=[{"deadline": now - 1.0}, {"deadline": now + 60.0}])
    (jeng, jreqs), (eng, reqs) = _both(models, [np.arange(4)] * 2, **kw)
    stale, fresh = reqs
    assert stale.done and stale.error is not None and stale.error.kind == "deadline_expired"
    assert stale.out == []
    assert fresh.done and fresh.error is None and len(fresh.out) >= 3
    assert eng.expired == jeng.expired == 1
    assert fresh.out == jreqs[1].out


def test_serve_engine_survives_injected_step_faults(models):
    """tests/test_faults.py:389-405 on qwen3_8b, in both packages: faulted
    steps are no-op retries; every request finishes; the same seeded plan
    faults the same steps and the tokens equal the reference's."""
    inj = FaultInjector(FaultPlan(seed=9, rates={"device_fault": 0.3}))
    kw = dict(slots=1, max_seq=48, max_new=3, fault_injector=inj)
    (jeng, jreqs), (eng, reqs) = _both(models, [np.arange(4)] * 3, **kw)
    assert all(r.done and len(r.out) >= 3 for r in reqs)
    assert eng.faulted_steps > 0 and eng.faulted_steps == jeng.faulted_steps
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_categorical_sampling_is_seeded(models):
    """Categorical sampling cannot match jax.random bit for bit; it is
    reproducible from the engine's seed and differs between seeds."""
    _, _, cfg, tp = models["qwen3_8b"]
    prompts = [np.arange(5), np.arange(7) * 3]

    def run(seed):
        _, reqs = _serve(ServeEngine, Request, cfg, tp, prompts, slots=2, max_new=12,
                         device=CPU, sampler="categorical", temperature=2.0, seed=seed)
        assert all(r.done and all(0 <= t < cfg.vocab_padded for t in r.out) for r in reqs)
        return [r.out for r in reqs]

    assert run(3) == run(3)
    assert run(3) != run(4)


ENGINE_FAMILIES = ["granite_moe_1b_a400m", "mamba2_370m", "zamba2_7b"]


@pytest.mark.parametrize("arch", ENGINE_FAMILIES)
def test_serve_engine_families_greedy_match_reference(arch):
    """ServeEngine on the moe, ssm and hybrid SMOKE configs: four requests
    through two slots (the later two admitted mid-stream, so slots decode
    at staggered positions), greedy tokens equal the reference engine's.
    Prompts stay within the SMOKE ssm_chunk (32) and above the conv
    window."""
    jcfg = jget_smoke(arch)
    jp = jax.jit(lambda key: jmodel.init_params(jcfg, key))(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    tp = lm_params_from_arrays(jax.tree.map(np.asarray, jp), cfg, CPU)
    prompts = [(np.arange(5 + 4 * i) * (i + 3)) % cfg.vocab for i in range(4)]
    (_, jreqs) = _serve(jengine.ServeEngine, jengine.Request, jcfg, jp, prompts, slots=2,
                        max_new=5)
    (_, reqs) = _serve(ServeEngine, Request, cfg, tp, prompts, slots=2, max_new=5, device=CPU)
    for j, r in zip(jreqs, reqs):
        assert r.done and len(r.out) == 5
        assert all(0 <= t < cfg.vocab_padded for t in r.out)
        assert r.out == j.out


@pytest.mark.parametrize("arch", ["internvl2_1b", "whisper_base"])
def test_serve_engine_refuses_families_needing_embeddings(arch):
    """The reference's engine prefills tokens alone (repro/serving/engine.py
    :209), so it cannot serve a vlm (patches) or an encdec (frames); the
    port's refuses them at construction, naming the family."""
    cfg = get_smoke_config(arch)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    with pytest.raises(ValueError, match=cfg.family):
        ServeEngine(cfg, params, batch_slots=1, max_seq=32, device=CPU)
