"""Port parity: the model families beside the dense decoder — InternVL2
(vlm), Granite-MoE and Mixtral (moe), Mamba2 (ssm), Zamba2 (hybrid) and
Whisper (encdec) — against the reference's ``repro.models.model`` on
their SMOKE configs, with the reference's weights carried across by
``repro_torch.convert.lm_params_from_arrays``.

The SMOKE configs are float32.  Logits are held within 1e-5 of
max|logit| and every cache leaf within 1e-5 of its largest element
(float32 sums taken in other orders through two to five layers); the
parameter tree's names, shapes and dtypes must be the reference's, and
``count_active_params`` equal.  On the CPU the port's attention runs
K8's plain version.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import FLOAT32_LEAVES, lm_params_from_arrays  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

CPU = "cpu"
FAMILY_ARCHS = ["internvl2_1b", "granite_moe_1b_a400m", "mixtral_8x22b", "mamba2_370m",
                "zamba2_7b", "whisper_base"]
TOL = 1e-5
PROMPT = 32          # a multiple of the SMOKE ssm_chunk (32)
MAX_SEQ = 64


@pytest.fixture(scope="module")
def models():
    """SMOKE config, reference params and the port's copy, per arch."""
    out = {}
    for arch in FAMILY_ARCHS:
        jcfg = jget_smoke(arch)
        jp = jax.jit(lambda key, jcfg=jcfg: jmodel.init_params(jcfg, key))(jax.random.PRNGKey(3))
        cfg = get_smoke_config(arch)
        out[arch] = (jcfg, jp, cfg, lm_params_from_arrays(jax.tree.map(np.asarray, jp), cfg, CPU))
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(float(np.max(np.abs(want))), 1e-30), err


def _batch(cfg, bsz, s, seed=1):
    """Tokens and, by family, patch or frame embeddings from a numpy seed."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (bsz, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((bsz, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((bsz, cfg.enc_len, cfg.d_model)).astype(
            np.float32)
    return batch


def _ref_leaves(jp) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}


def _ref_leaf(flat: dict, name: str):
    """The reference leaf of a port parameter name: ``blocks.{i}.x.y`` is
    layer i of ``blocks/x/y`` (likewise enc_blocks, dec_blocks; a shape's
    leaf is returned whole, stacked); the rest map as they are."""
    parts = name.split(".")
    if parts[0] in ("blocks", "enc_blocks", "dec_blocks"):
        leaf = flat["/".join([parts[0]] + parts[2:])]
        return leaf if isinstance(leaf, jax.ShapeDtypeStruct) else leaf[int(parts[1])]
    return flat["/".join(parts)]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_names_shapes_and_dtypes(models, arch, dtype):
    """The port's own init and the carried-across tree (the float32
    reference weights cast to the config's dtype) both have the reference
    tree's leaves, shapes and dtypes (float32 leaves stay float32 in a
    bf16 model), equal parameter counts, and the port's cache the
    reference's leaves, shapes and dtypes."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=dtype, param_dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, param_dtype=dtype)
    shapes = jax.eval_shape(lambda key: jmodel.init_params(jcfg, key), jax.random.PRNGKey(0))
    flat = _ref_leaves(shapes)
    jp = models[arch][1]
    mine = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    carried = lm_params_from_arrays(jax.tree.map(np.asarray, jp), cfg, CPU)
    for params in (mine, carried):
        names = dict(params.named_parameters())
        assert len(names) == sum(leaf.shape[0] if key.split("/")[0].endswith("blocks") else 1
                                 for key, leaf in flat.items())
        for name, t in names.items():
            ref = _ref_leaf(flat, name)
            assert tuple(t.shape) == ref.shape[1:] if name.split(".")[0].endswith("blocks") \
                else tuple(t.shape) == ref.shape, name
            assert str(t.dtype).removeprefix("torch.") == str(ref.dtype), name
            if name.split(".")[-1] in FLOAT32_LEAVES:
                assert t.dtype == torch.float32, name
        assert tmodel.count_params(params) == jmodel.count_params(shapes)
        assert tmodel.count_active_params(params, cfg) == \
            jmodel.count_active_params(shapes, jcfg)
        assert tmodel.model_flops(params, cfg, 1000, train=False) == \
            jmodel.model_flops(shapes, jcfg, 1000, train=False)
    values = _ref_leaves(jp)
    for name, t in carried.named_parameters():
        want = np.asarray(_ref_leaf(values, name), np.float32)
        if t.dtype == torch.bfloat16:
            want = np.asarray(jnp.asarray(want, jnp.bfloat16), np.float32)
        np.testing.assert_array_equal(t.float().numpy(), want)
    jc = jax.eval_shape(lambda: jmodel.init_decode_cache(jcfg, 2, MAX_SEQ))
    tc = tmodel.init_decode_cache(cfg, 2, MAX_SEQ, device=CPU)
    assert set(tc) == set(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        assert str(tc[name].dtype).removeprefix("torch.") == str(jc[name].dtype), name


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_and_staggered_decode_match_reference(models, arch):
    """Prefill logits and every cache leaf, then three decode steps at a
    per-slot position vector (the second sequence lags by three), against
    the reference."""
    jcfg, jp, cfg, tp = models[arch]
    batch = _batch(cfg, 2, PROMPT)
    jl, jc = jmodel.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                            max_seq=MAX_SEQ)
    tl, tc = tmodel.prefill(tp, batch, cfg, MAX_SEQ)
    _close(tl, jl)
    assert set(tc) == set(jc)
    for name in jc:
        _close(tc[name], jc[name])
    offset = cfg.n_patches if cfg.family == "vlm" else 0
    pos = np.array([offset + PROMPT, offset + PROMPT - 3], np.int32)
    nxt = np.array([[3], [7]], np.int32)
    for _ in range(3):
        jl, jc = jmodel.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc, jcfg)
        tl, tc = tmodel.decode_step(tp, nxt, pos, tc, cfg)
        _close(tl, jl)
        for name in jc:
            _close(tc[name], jc[name])
        nxt = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_bf16_prefill_tracks_reference(arch):
    """The SMOKE config in bf16 (the published configs' dtype; the float32
    leaves stay float32): prefill logits and every cache leaf within 5e-2
    of their largest element.  The packages round bf16 at other places
    (XLA:CPU keeps fused intermediates in float32), so 1-2 % apart after
    two to five layers is the sound reading; a leaf in the wrong dtype or
    a cast left out shows well past it."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="bfloat16", param_dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16", param_dtype="bfloat16")
    jp = jax.jit(lambda key: jmodel.init_params(jcfg, key))(jax.random.PRNGKey(1))
    tp = lm_params_from_arrays(jax.tree.map(np.asarray, jp), cfg, CPU)
    batch = _batch(cfg, 2, PROMPT)
    jl, jc = jmodel.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                            max_seq=MAX_SEQ)
    tl, tc = tmodel.prefill(tp, batch, cfg, MAX_SEQ)
    assert tl.dtype == torch.bfloat16
    _close(tl, jl, 5e-2)
    for name in jc:
        assert str(tc[name].dtype).removeprefix("torch.") == str(jc[name].dtype), name
        _close(tc[name], jc[name], 5e-2)


def test_moe_prefill_with_qk_norm_caches_the_reference_k():
    """No MoE config sets qk_norm, but the reference's MoE prefill caches k
    recomputed without it (repro/models/model.py:400-410): with qk_norm on,
    the port's prefill cache still equals the reference's."""
    jcfg = dataclasses.replace(jget_smoke("granite_moe_1b_a400m"), qk_norm=True)
    cfg = dataclasses.replace(get_smoke_config("granite_moe_1b_a400m"), qk_norm=True)
    jp = jax.jit(lambda key: jmodel.init_params(jcfg, key))(jax.random.PRNGKey(2))
    tp = lm_params_from_arrays(jax.tree.map(np.asarray, jp), cfg, CPU)
    batch = _batch(cfg, 2, 20)
    jl, jc = jmodel.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                            max_seq=MAX_SEQ)
    tl, tc = tmodel.prefill(tp, batch, cfg, MAX_SEQ)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[name], jc[name])


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_7b"])
def test_ssm_prompt_contract(models, arch):
    """A prompt longer than ssm_chunk must be a multiple of it (the
    reference asserts it; the port raises), and one shorter than the conv
    window is refused; a short prompt under the chunk is served."""
    _, _, cfg, tp = models[arch]
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tmodel.prefill(tp, _batch(cfg, 1, cfg.ssm_chunk + 8), cfg, MAX_SEQ)
    with pytest.raises(ValueError, match="conv window"):
        tmodel.prefill(tp, _batch(cfg, 1, cfg.ssm_conv - 2), cfg, MAX_SEQ)
    lg, _ = tmodel.prefill(tp, _batch(cfg, 1, cfg.ssm_chunk - 5), cfg, MAX_SEQ)
    assert bool(torch.isfinite(lg).all())


def test_family_inputs_are_required(models):
    """A vlm prefill needs patches and an encdec prefill frames."""
    for arch, what in (("internvl2_1b", "patches"), ("whisper_base", "frames")):
        _, _, cfg, tp = models[arch]
        with pytest.raises(ValueError, match=what):
            tmodel.prefill(tp, {"tokens": np.zeros((1, 4), np.int32)}, cfg, MAX_SEQ)


def test_hybrid_groups_of_zamba2():
    """Zamba2-7B: 13 shared-attention applications, then 3 Mamba layers."""
    from repro_torch.configs import get_config

    assert tmodel.hybrid_groups(get_config("zamba2_7b")) == (13, 3)
    assert get_config("zamba2_7b").head_dim == 112


@pytest.mark.parametrize("arch", ["qwen3_8b", "granite_20b", "command_r_35b", "yi_34b",
                                  *FAMILY_ARCHS])
def test_serve_lm_example_runs_every_arch(arch):
    """examples/serve_lm_torch.py on the CPU: every arch's SMOKE config
    serves its requests, through the engine or (vlm, encdec) through
    prefill_into/decode_step, with tokens inside the vocabulary."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.main(["--arch", arch, "--device", CPU, "--requests", "3", "--max-new", "4"])
    cfg = get_smoke_config(arch)
    assert out["family"] == cfg.family
    assert [len(o) for o in out["outs"]] == [4, 4, 4]
    assert all(0 <= t < cfg.vocab_padded for o in out["outs"] for t in o)
