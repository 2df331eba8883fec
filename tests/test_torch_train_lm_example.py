"""Smoke test of ``examples/train_lm_torch.py --smoke --device cpu``, the
port's counterpart of ``tests/test_examples_smoke.py::test_train_lm_example_smoke``:
finite losses, and the refresh accounting (steps = 4, refresh_every = 2
-> 2 refreshes, each ONE batched solve on the one cached pattern, and
blocks actually qualified)."""

import importlib
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" / "train_lm_torch.py"


def test_train_lm_torch_example_smoke(capsys):
    spec = importlib.util.spec_from_file_location("train_lm_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    an = importlib.import_module("repro_torch.optim.analog_newton")
    out = mod.main(["--smoke", "--device", "cpu"])
    hist = out["history"]
    assert hist and all(h["loss"] == h["loss"] for h in hist)  # finite
    rs = an.REFRESH_STATS
    assert rs.refreshes == 2
    assert rs.solve_batch_calls == rs.refreshes
    assert rs.systems_solved > 0
    assert rs.pattern_derivations == 1
    printed = capsys.readouterr().out
    assert "model: qwen3_smoke" in printed and "refreshes: 2, solve_batch calls: 2" in printed
    an.reset_refresh_stats()
