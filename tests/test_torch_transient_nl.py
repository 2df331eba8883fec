"""Port parity: repro_torch.core.transient_nl (the nonlinear RK4
transient) and ``transient_batch(method="nonlinear")`` against the JAX
reference, on the CPU.

Bars: ``times`` equal; ``x`` (every stored sample) and ``x_final``
within 1e-9 of max|x|; ``saturated`` equal; ``transient_batch``'s
``stable`` and ``settle_time`` equal.  The inputs are those of
tests/test_network_transient.py: the PD system of
``test_nonlinear_agrees_with_op_on_pd`` and the negated (-A, -b) system
of ``test_nonlinear_saturation_on_negative_definite``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro.core import engine as jengine  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core import transient_nl as jnl  # noqa: E402
from repro.data.spd import random_rhs_from_solution, random_spd  # noqa: E402

from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import transient_nl as tnl  # noqa: E402

CPU = "cpu"
TOL_X = 1e-9


def _sys(seed, n):
    r = np.random.default_rng(seed)
    a = random_spd(r, n)
    x, b = random_rhs_from_solution(r, a)
    return a, x, b


def _assert_trace(got, want):
    np.testing.assert_array_equal(got.times, want.times)
    scale = np.abs(want.x).max()
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=TOL_X * scale)
    np.testing.assert_allclose(got.x_final, want.x_final, rtol=0, atol=TOL_X * scale)
    np.testing.assert_allclose(got.amp_out, want.amp_out, rtol=0,
                               atol=TOL_X * max(np.abs(want.amp_out).max(), 1e-30))
    assert np.array_equal(np.asarray(got.saturated), np.asarray(want.saturated))


@pytest.mark.parametrize("case", ["pd", "negated"])
def test_nonlinear_transient_matches_reference(case):
    """The single-system wrapper on the reference tests' two circuits."""
    if case == "pd":
        a, x, b = _sys(9, 5)
        t_end = 4e-4
    else:
        a, x, b = _sys(7, 5)
        a, b, t_end = -a, -b, 5e-5
    want = jnl.nonlinear_transient(jnet.build_proposed(a, b), t_end=t_end)
    got = tnl.nonlinear_transient(tnet.build_proposed(a, b, device=CPU), t_end=t_end,
                                  device=CPU)
    _assert_trace(got, want)
    assert got.saturated == (case == "negated")
    if case == "pd":
        np.testing.assert_allclose(got.x_final, x, atol=2e-3)


def test_nonlinear_transient_batch_matches_reference():
    """A batch of the PD system and its negation on one pattern, one
    shared dt: saturated exactly for the negated one; z_final and dt too."""
    a, _x, b = _sys(9, 5)
    a2, b2 = np.stack([a, -a]), np.stack([b, -b])
    want = jnl.nonlinear_transient_batch(
        [jnet.build_proposed(a2[k], b2[k]) for k in range(2)], t_end=1e-4)
    got = tnl.nonlinear_transient_batch(tnet.build_proposed_batch(a2, b2, device=CPU),
                                        t_end=1e-4, device=CPU)
    _assert_trace(got, want)
    assert got.saturated.tolist() == [False, True]
    assert got.dt == want.dt and len(got) == 2
    np.testing.assert_allclose(got.z_final, want.z_final, rtol=0,
                               atol=TOL_X * np.abs(want.z_final).max())


def test_transient_batch_nonlinear_matches_reference():
    """transient_batch(method="nonlinear"): stable and settle_time as in
    the reference (the settle time read on the shared sample grid)."""
    rows = [_sys(9, 5), _sys(21, 5), _sys(7, 5)]
    a = np.stack([r[0] for r in rows])
    b = np.stack([r[2] for r in rows])
    a[2], b[2] = -a[2], -b[2]
    kw = dict(method="nonlinear", nl_t_end=2e-4, nl_n_samples=200)
    want = jengine.transient_batch([jnet.build_proposed(a[k], b[k]) for k in range(3)],
                                   **kw)
    timings = {}
    got = tengine.transient_batch(tnet.build_proposed_batch(a, b, device=CPU), device=CPU,
                                  timings=timings, **kw)
    assert got.method == "nonlinear" and "rk4" in timings
    assert np.array_equal(got.stable, want.stable)
    assert got.stable.tolist() == [True, True, False]
    np.testing.assert_array_equal(got.settle_time, want.settle_time)
    fin = np.isfinite(want.x_converged)
    np.testing.assert_array_equal(np.isfinite(got.x_converged), fin)
    np.testing.assert_allclose(got.x_converged[fin], want.x_converged[fin], rtol=0,
                               atol=TOL_X * np.abs(want.x_converged[fin]).max())
    np.testing.assert_allclose(got.mirror_residual, want.mirror_residual, rtol=0,
                               atol=1e-10)

