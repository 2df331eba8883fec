"""Port parity: the dry run's registry (``SHAPES``, ``shape_applicable``,
``input_specs``) against the reference's ``repro.configs``, the
``meta``-device entry points it needs, and ``repro_torch.launch.dryrun``
at SMOKE size.

``input_specs`` must give the reference's shapes and dtypes for every
SMOKE config and shape; the decode cache's leaves keep the reference's
names (``k``, ``v``, ``conv``, ``ssm``, ``xk``, ``xv``: the key mapping is
the identity).  Exact: shapes and dtypes.  ``run_cell`` must come back
``ok`` for every cell, or ``skipped`` with the reference's reason where
the reference skips (``long_500k`` on a full-attention arch).  The
reference's ``repro.launch.dryrun`` is not imported here: it sets
``XLA_FLAGS`` for 512 host devices when imported.
"""

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

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
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402

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


@pytest.mark.parametrize("mesh", ["single_pod", "multi_pod"])
def test_sharded_meshes_wait_on_the_sharding_rules(mesh):
    with pytest.raises(NotImplementedError, match="production meshes.*item 13"):
        dryrun.run_cell("qwen3_8b", "decode_32k", mesh, smoke=True)
    with pytest.raises(NotImplementedError, match="production meshes.*item 13"):
        dryrun.main(["--mesh", mesh, "--arch", "qwen3_8b", "--shape", "decode_32k"])


def test_attention_batch_layout_waits_on_the_sharding_rules():
    with pytest.raises(NotImplementedError, match="production meshes.*item 13"):
        dryrun.run_cell("qwen3_8b", "decode_32k", attn_batch_layout=True, smoke=True)


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
