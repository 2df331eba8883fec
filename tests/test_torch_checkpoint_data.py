"""Port parity: checkpointing and the token pipeline — the reference's
``tests/test_checkpoint_data.py`` on ``repro_torch.checkpoint`` and
``repro_torch.data.tokens``, the stream bit for bit against the
reference's, a cut-and-resumed ``train_loop`` bit for bit against an
uncut one, and a reference checkpoint loaded into the port.
"""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.tokens import SyntheticTokens  # noqa: E402

CPU = "cpu"


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 8), generator=g),
                   "b": torch.zeros((8,), dtype=torch.bfloat16)},
        "step": 7,
    }


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    state = _state()
    state["params"]["b"] += torch.arange(8).to(torch.bfloat16) / 3
    mgr.save(7, state, data_state={"index": 42, "seed": 0, "host_index": 0, "host_count": 1})
    restored, ds = mgr.restore(7, _state(1))
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["b"], state["params"]["b"])
    assert restored["step"] == 7 and ds["index"] == 42
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert manifest["leaves"]["params/b"] == {"file": "params__b.npy", "shape": [8],
                                              "dtype": "bfloat16"}
    assert np.load(tmp_path / "step_00000007" / "params__b.npy").dtype == np.uint16


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state())
    assert mgr.all_steps() == [3, 4]


def test_async_save_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(5, _state())
    mgr.wait()
    assert mgr.latest_step() == 5
    step, restored, _ = mgr.restore_latest(_state())
    assert step == 5


def test_atomicity_no_torn_checkpoint(tmp_path):
    """A .tmp directory must never be discoverable as a checkpoint."""
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, _state())
    tmp = tmp_path / "step_00000009.tmp"
    tmp.mkdir()
    (tmp / "manifest.json").write_text("{}")
    assert mgr.all_steps() == [1]


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, _state())
    bad_like = {"params": {"w": torch.zeros(4, 4), "b": torch.zeros(8, dtype=torch.bfloat16)},
                "step": 0}
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, bad_like)


def test_module_restores_in_place_and_snapshot_is_taken_at_save(tmp_path):
    """A module's parameters are leaves by state-dict name, restored into the
    module in place; the async save writes the values of the save call,
    not later ones."""
    model = torch.nn.Linear(4, 3)
    mgr = CheckpointManager(tmp_path, async_save=True)
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    mgr.save(2, {"params": model, "opt_state": {"step": 2, "skip": None}})
    with torch.no_grad():
        model.weight.add_(1.0)
    mgr.wait()
    assert set(json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())["leaves"]) \
        == {"params/weight", "params/bias", "opt_state/step"}
    state, _ = mgr.restore(2, {"params": model, "opt_state": {"step": 0, "skip": None}})
    assert state["params"] is model and state["opt_state"] == {"step": 2, "skip": None}
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), want[n])


# ------------------------------------------------------------------ data
def test_data_deterministic():
    d1 = SyntheticTokens(vocab=100, seq_len=16, batch_size=4, seed=3)
    d2 = SyntheticTokens(vocab=100, seq_len=16, batch_size=4, seed=3)
    b1, b2 = next(d1), next(d2)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    d1.close(); d2.close()


def test_data_resume_from_state():
    d = SyntheticTokens(vocab=100, seq_len=16, batch_size=4, seed=5)
    next(d); next(d)
    st = d.state()
    b3 = next(d)
    d.close()
    d2 = SyntheticTokens.from_state(st, vocab=100, seq_len=16, batch_size=4)
    b3b = next(d2)
    d2.close()
    np.testing.assert_array_equal(b3["tokens"], b3b["tokens"])


def test_data_host_sharding_disjoint():
    a = SyntheticTokens(vocab=100, seq_len=16, batch_size=4, seed=1, host_index=0, host_count=2)
    b = SyntheticTokens(vocab=100, seq_len=16, batch_size=4, seed=1, host_index=1, host_count=2)
    ba, bb = next(a), next(b)
    assert not np.array_equal(ba["tokens"], bb["tokens"])
    a.close(); b.close()


def test_data_targets_shifted():
    d = SyntheticTokens(vocab=100, seq_len=16, batch_size=2, seed=1)
    b = next(d)
    d.close()
    assert b["tokens"].shape == (2, 16)
    assert b["targets"].shape == (2, 16)
    assert b["tokens"].dtype == np.int32
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 100
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_data_learnable_structure():
    """The Markov component makes next-token prediction beatable:
    P(correct | follow-rule) ~ 0.5 >> uniform 1/vocab."""
    d = SyntheticTokens(vocab=1000, seq_len=256, batch_size=8, seed=2)
    b = next(d)
    d.close()
    toks, tgt = b["tokens"], b["targets"]
    pred = (toks + d._shift[toks % 997]) % 1000
    assert (pred == tgt).mean() > 0.2


@pytest.mark.parametrize("seed,host_index,start", [(0, 0, 0), (7, 1, 3), (123, 2, 10)])
def test_stream_equals_reference_bit_for_bit(seed, host_index, start):
    from repro.data.tokens import SyntheticTokens as JTokens

    kw = dict(vocab=777, seq_len=40, batch_size=3, seed=seed, host_index=host_index,
              host_count=4, start_batch=start)
    ours, ref = SyntheticTokens(**kw), JTokens(**kw)
    for _ in range(4):
        a, b = next(ours), next(ref)
        for key in ("tokens", "targets"):
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])
    assert ours.state() == ref.state()
    ours.close(); ref.close()


# ------------------------------------------------------------------ loop
def _lm_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    return ex.lm_smoke(), ex.analog_config(True)


class _Preempted(Exception):
    pass


def test_train_loop_cut_and_resumed_ends_where_an_uncut_run_ends(tmp_path):
    """AnalogNewton (refresh every 2 steps, through the circuit) for 8 steps
    with a checkpoint every 4: a run preempted after its step-4 checkpoint
    and started again resumes there (parameters, moments, covariance and
    block inverses, the data stream's position) and ends bit for bit where
    the uncut run ends."""
    from repro_torch.launch.train import train_loop

    cfg, acfg = _lm_smoke()
    kw = dict(steps=8, batch_size=2, seq_len=32, optimizer_name="analog_newton", lr=0.02,
              ckpt_every=4, log_every=1, analog_cfg=acfg, device=CPU)
    whole = train_loop(cfg, ckpt_dir=str(tmp_path / "whole"), log_fn=lambda s: None, **kw)

    def preempt(line):
        if line.startswith("step     6"):
            raise _Preempted
    with pytest.raises(_Preempted):
        train_loop(cfg, ckpt_dir=str(tmp_path / "cut"), log_fn=preempt, **kw)
    mgr = CheckpointManager(tmp_path / "cut")
    for _ in range(300):                     # the step-4 save may still be committing
        if mgr.latest_step() == 4:
            break
        time.sleep(0.1)
    assert mgr.latest_step() == 4
    lines = []
    resumed = train_loop(cfg, ckpt_dir=str(tmp_path / "cut"), log_fn=lines.append, **kw)
    assert lines[0] == "resumed from step 4"
    assert [h["step"] for h in resumed["history"]] == [5, 6, 7, 8]
    assert resumed["history"] == whole["history"][4:]
    a, b = whole["state"], resumed["state"]
    assert a["step"] == b["step"] == 8
    for n, p in a["params"].named_parameters():
        assert torch.equal(p, b["params"].get_parameter(n)), n
    for key in ("mu", "cov", "pinv"):
        for n, t in a["opt_state"][key].items():
            assert torch.equal(t, b["opt_state"][key][n]), (key, n)


def test_reference_checkpoint_loads_through_train_state_from_arrays(tmp_path):
    """A train state saved by the reference's CheckpointManager (the qwen3_8b
    SMOKE config in bf16, AnalogNewton) restores to host arrays and loads
    through train_state_from_arrays with every leaf equal."""
    import dataclasses
    import importlib

    import jax

    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.configs import get_smoke_config as jget_smoke
    from repro.training.step import init_train_state as jinit
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import reference_leaf, train_state_from_arrays

    # the package exports the function analog_newton under the module's name
    jan = importlib.import_module("repro.optim.analog_newton")
    jcfg = dataclasses.replace(jget_smoke("qwen3_8b"), dtype="bfloat16", param_dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke_config("qwen3_8b"), dtype="bfloat16",
                              param_dtype="bfloat16")
    acfg = jan.AnalogNewtonConfig(block=16, min_dim=32, max_blocks=8)
    jstate = jinit(jcfg, jan.analog_newton(1e-2, acfg), jax.random.PRNGKey(2))
    jstate["opt_state"]["mu"] = jax.tree.map(lambda x: x + 0.5, jstate["opt_state"]["mu"])
    mgr = JManager(tmp_path, async_save=False)
    mgr.save(3, jstate, data_state={"index": 3, "seed": 0, "host_index": 0, "host_count": 1})
    tree, ds = mgr.restore(3, jax.eval_shape(lambda: jstate))
    state = train_state_from_arrays(jax.tree.map(np.asarray, tree), cfg, "analog_newton", CPU)
    assert ds["index"] == 3 and state["step"] == 0 and state["opt_state"]["step"] == 0
    for n, p in state["params"].named_parameters():
        want = np.asarray(reference_leaf(jstate["params"], n), np.float32)
        assert p.dtype == torch.bfloat16 and p.requires_grad
        assert np.array_equal(p.detach().float().numpy(), want), n
        assert np.array_equal(state["opt_state"]["mu"][n].numpy(),
                              np.asarray(reference_leaf(jstate["opt_state"]["mu"], n))), n
    assert sorted(state["opt_state"]["cov"]) == sorted(state["opt_state"]["pinv"]) == ["lm_head"]
    assert np.array_equal(state["opt_state"]["pinv"]["lm_head"].numpy(),
                          np.asarray(jstate["opt_state"]["pinv"]["lm_head"]))
