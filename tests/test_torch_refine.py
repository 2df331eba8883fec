"""Port parity: repro_torch.core.refine (the refinement drivers) and the
solver's graded recovery against the JAX reference, on the CPU.

Bars:
* the drivers on the same inputs and the same seeded inner solve:
  ``iters``, ``converged`` and ``stalled`` equal, ``x`` within 1e-12 of
  max|x|, the relative ``residual`` within 1e-14 absolute (a residual
  near 1e-13 is a cancellation, its digits set by the order of the
  products: measured up to 1.1e-16 apart);
* ``solve_batch(refine=...)`` under the reference tests'
  ``NonIdealities``: ``precision_path``, ``refine_iters`` and
  ``fallback`` equal, ``x`` within 1e-8 of max|x|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro.core import refine as jref  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core.operating_point import NonIdealities as JNonIdealities  # noqa: E402
from repro.data.spd import random_rhs_from_solution, random_sdd, random_spd  # noqa: E402

from repro_torch.core import refine as tref  # noqa: E402
from repro_torch.core import solver as tsolver  # noqa: E402
from repro_torch.core.operating_point import NonIdealities as TNonIdealities  # noqa: E402

CPU = "cpu"
RECOVER_TOL = 1e-10
# the reference tests' research budget for the recovery grid
BUDGET = dict(tol=RECOVER_TOL, max_iters=24)


def _mixed_batch(seed: int, n: int = 10):
    """tests/test_refine.py's batch: non-SDD sparse SPD, SDD, dense SPD."""
    rng = np.random.default_rng(seed)
    aa, bb, xx = [], [], []
    for kind, density in (("spd", 0.5), ("sdd", 1.0), ("spd", 1.0)):
        a = random_sdd(rng, n) if kind == "sdd" else random_spd(rng, n, density=density)
        x, b = random_rhs_from_solution(rng, a)
        aa.append(a), bb.append(b), xx.append(x)
    return np.stack(aa), np.stack(bb), np.stack(xx)


def _noisy_inner(a, noise):
    """The seeded noisy digital inner solve of tests/test_refine.py: per
    call, a fresh generator seeded by the call count."""
    calls = []

    def inner(idx, rhs):
        idx = np.asarray(idx)
        calls.append(idx.copy())
        d = np.stack([np.linalg.solve(a[i], r) for i, r in zip(idx, rhs)])
        rng = np.random.default_rng(len(calls))
        pert = rng.standard_normal(d.shape)
        scale = noise[idx][:, None] * np.max(np.abs(d), axis=1)[:, None]
        return d + pert * scale / np.maximum(np.max(np.abs(pert), axis=1)[:, None], 1e-30)

    return inner, calls


def _assert_result(got, want):
    for key in ("iters", "converged", "stalled"):
        assert np.array_equal(getattr(got, key), getattr(want, key)), key
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-12 * np.abs(want.x).max())
    np.testing.assert_allclose(got.residual, want.residual, rtol=0, atol=1e-14)


def test_refine_spec_api_matches_reference():
    for kw in (dict(tol=0.0), dict(max_iters=0), dict(driver="gmres"),
               dict(stall_ratio=1.0)):
        with pytest.raises(ValueError):
            tref.RefineSpec(**kw)
    assert tref.as_refine_spec(None) is None and tref.as_refine_spec(False) is None
    assert tref.as_refine_spec(True) == tref.DEFAULT_REFINE
    assert tref.as_refine_spec("fcg").driver == "fcg"
    spec = tref.RefineSpec(max_iters=5)
    assert tref.as_refine_spec(spec) is spec
    with pytest.raises(TypeError):
        tref.as_refine_spec(3)
    for f in ("tol", "max_iters", "stall_ratio", "driver"):
        assert getattr(tref.DEFAULT_REFINE, f) == getattr(jref.DEFAULT_REFINE, f)
    assert tref.refine_driver(spec) is tref.refine_batch
    assert tref.refine_driver(tref.RefineSpec(driver="fcg")) is tref.fcg_batch


@pytest.mark.parametrize("driver", ["refine_batch", "fcg_batch"])
def test_drivers_match_reference_with_noisy_inner_solve(driver):
    """The reference test's noisy inner solve (row 0 nearly exact, row 2
    a sloppy 20 %): the same passes, flags and iterates in both packages,
    with per-row freezing."""
    a, b, x_true = _mixed_batch(3)
    noise = np.array([1e-8, 1e-2, 2e-1])
    spec_kw = dict(tol=1e-12, max_iters=40)
    j_inner, j_calls = _noisy_inner(a, noise)
    t_inner, t_calls = _noisy_inner(a, noise)
    want = getattr(jref, driver)(a, b, np.zeros_like(b), j_inner,
                                 spec=jref.RefineSpec(**spec_kw))
    got = getattr(tref, driver)(a, b, np.zeros_like(b), t_inner,
                                spec=tref.RefineSpec(**spec_kw), device=CPU)
    _assert_result(got, want)
    assert [c.tolist() for c in t_calls] == [c.tolist() for c in j_calls]
    assert bool(got.converged.all()) and got.iters[0] < got.iters[2]
    np.testing.assert_allclose(got.x, x_true, rtol=0.0, atol=1e-8)


@pytest.mark.parametrize("driver", ["refine_batch", "fcg_batch"])
def test_drivers_match_reference_on_stall_and_nonfinite(driver):
    """A non-contracting inner solve stalls every row in the same pass;
    a nonfinite start row stalls at once with residual inf."""
    a, b, _ = _mixed_batch(4)
    x0 = np.zeros_like(b)
    x0[1, 3] = np.nan
    want = getattr(jref, driver)(a, b, x0, lambda idx, rhs: np.zeros_like(rhs),
                                 spec=jref.RefineSpec(tol=1e-12, max_iters=10))
    got = getattr(tref, driver)(a, b, x0, lambda idx, rhs: np.zeros_like(rhs),
                                spec=tref.RefineSpec(tol=1e-12, max_iters=10),
                                device=CPU)
    for key in ("iters", "converged", "stalled"):
        assert np.array_equal(getattr(got, key), getattr(want, key)), key
    assert bool(got.stalled.all()) and int(got.iters.max()) < 10
    assert np.isinf(got.residual[1]) and got.iters[1] == 0
    np.testing.assert_array_equal(np.isnan(got.x), np.isnan(want.x))
    np.testing.assert_allclose(got.residual[[0, 2]], want.residual[[0, 2]], rtol=1e-12)


def test_relative_residuals_match_reference():
    a, b, x = _mixed_batch(47)
    x_bad = x + 1e-3
    x_bad[1, 0] = np.nan
    for xx in (x, x_bad):
        got = tref.relative_residuals(a, b, xx, device=CPU)
        want = jref.relative_residuals(a, b, xx)
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-15)
    # a tensor stays on its device
    got = tref.relative_residuals(torch.as_tensor(a), b, x_bad)
    assert np.isinf(got[1])


# (label, method, (bits, pot_tol, seed), refine knob in the reference's
# form, fallback) — the reference tests' NonIdealities
RECOVERY_CASES = {
    "int8_ir": ("analog_2n", (8, 0.01, 1), ("spec", dict(BUDGET)), "cholesky", 88),
    "int8_fcg": ("analog_2n", (8, 0.01, 1), ("spec", dict(BUDGET, driver="fcg")),
                 "cholesky", 81),
    "int6_analog_n": ("analog_n", (6, 0.01, 1), ("spec", dict(BUDGET)), "cholesky", 70),
    "int4_fallback": ("analog_2n", (4, 0.05, 2), ("spec", dict(BUDGET)), "cholesky", 7),
    "int4_unrefined": ("analog_2n", (4, 0.05, 4), ("spec", dict(tol=RECOVER_TOL,
                                                                max_iters=2)), "none", 13),
    "int8_default_true": ("analog_2n", (8, 0.01, 3), ("knob", True), "cholesky", 11),
    "int8_knob_fcg": ("analog_2n", (8, 0.01, 5), ("knob", "fcg"), "cg", 19),
    "int8_knob_ir": ("analog_2n", (8, 0.0, 1), ("knob", "ir"), "cholesky", 80),
}


def _knob(pkg, refine):
    kind, val = refine
    return pkg.RefineSpec(**val) if kind == "spec" else val


@pytest.mark.parametrize("case", sorted(RECOVERY_CASES))
def test_solve_batch_refine_matches_reference(case):
    method, (bits, pot_tol, seed), refine, fallback, data_seed = RECOVERY_CASES[case]
    a, b, x_true = _mixed_batch(data_seed)
    want = jsolver.solve_batch(a, b, method=method, fallback=fallback,
                               nonideal=JNonIdealities(pot_bits=bits, pot_tol=pot_tol,
                                                       seed=seed),
                               refine=_knob(jref, refine))
    got = tsolver.solve_batch(a, b, method=method, fallback=fallback, device=CPU,
                              nonideal=TNonIdealities(pot_bits=bits, pot_tol=pot_tol,
                                                      seed=seed),
                              refine=_knob(tref, refine))
    for key in ("precision_path", "refine_iters", "fallback"):
        assert np.array_equal(got.info[key], want.info[key]), (key, got.info[key],
                                                               want.info[key])
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-8 * np.abs(want.x).max())
    assert set(got.info["precision_path"].tolist()) <= set(tsolver.PRECISION_PATHS)
    delivered = got.info["precision_path"] != "unrefined"
    assert float(np.max(got.info["residual"][delivered], initial=0.0)) <= RECOVER_TOL
    if case == "int4_fallback":
        assert "fallback" in set(got.info["precision_path"].tolist())
    if case == "int4_unrefined":
        assert "unrefined" in set(got.info["precision_path"].tolist())


def test_refine_single_system_and_refine_none():
    """solve(refine=...) is a B = 1 solve_batch; refine=None keeps the
    binary contract (no precision keys); refine composes with settling."""
    a, b, _ = _mixed_batch(17)
    ni_t = TNonIdealities(pot_bits=8, pot_tol=0.01, seed=1)
    ni_j = JNonIdealities(pot_bits=8, pot_tol=0.01, seed=1)
    got = tsolver.solve(a[2], b[2], nonideal=ni_t, refine=True, device=CPU)
    want = jsolver.solve(a[2], b[2], nonideal=ni_j, refine=True)
    assert got.info["precision_path"] == want.info["precision_path"]
    assert got.info["refine_iters"] == want.info["refine_iters"]
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-8 * np.abs(want.x).max())
    plain = tsolver.solve_batch(a, b, device=CPU)
    assert "precision_path" not in plain.info and "refine_iters" not in plain.info
    timings = {}
    both = tsolver.solve_batch(a, b, nonideal=ni_t, refine="fcg", compute_settling=True,
                               settle_method="spectral", device=CPU, timings=timings)
    assert "refine" in timings and "spectral" in timings
    assert both.info["settle_certified"].shape == (3,)
    assert float(both.info["residual"].max()) <= tref.DEFAULT_REFINE.tol
