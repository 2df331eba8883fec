"""Port parity: the single-system digital baselines of
``repro_torch.core.baselines`` (``cholesky_solve``, ``cg_solve``,
``jacobi_solve``) against ``repro.core.baselines`` on the seeded systems of
``tests/test_solver_baselines.py``: solutions within 1e-10 (the float64
parity contract) and the same iteration counts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro.core import baselines as jb  # noqa: E402
from repro.data.spd import random_rhs_from_solution, random_sdd, random_spd  # noqa: E402

from repro_torch.core import baselines as tb  # noqa: E402

# (seed, n) of tests/test_solver_baselines.py's _sys calls, and hypothesis
# draws inside its seed and size bounds (seed 0..5000, n 2..20)
SYSTEMS = [(1, 12), (2, 8), (3, 6), (0, 2), (17, 20), (4999, 13)]


def _sys(seed, n):
    r = np.random.default_rng(seed)
    a = random_spd(r, n)
    x, b = random_rhs_from_solution(r, a)
    return a, x, b


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


@pytest.mark.parametrize("seed,n", SYSTEMS)
def test_cholesky_solve_matches_reference(seed, n):
    a, x, b = _sys(seed, n)
    got = tb.cholesky_solve(_t(a), _t(b))
    assert got.shape == (n,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(jb.cholesky_solve(a, b)),
                               rtol=0.0, atol=1e-10)
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("tol", [1e-10, 1e-12])
@pytest.mark.parametrize("seed,n", SYSTEMS)
def test_cg_solve_matches_reference(seed, n, tol):
    a, _x, b = _sys(seed, n)
    got = tb.cg_solve(_t(a), _t(b), tol=tol)
    want = jb.cg_solve(a, b, tol=tol)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0.0, atol=1e-10)
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(float(got.residual_norm), float(want.residual_norm),
                               rtol=1e-6, atol=1e-14)


def test_cg_solve_from_a_start_vector_and_capped():
    """x0 and max_iter as in the reference: a warm start and a cap that
    stops the iteration before convergence."""
    a, x, b = _sys(7, 16)
    x0 = x + 0.01
    got = tb.cg_solve(_t(a), _t(b), x0=_t(x0))
    want = jb.cg_solve(a, b, x0=x0)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0.0, atol=1e-10)
    assert int(got.iterations) == int(want.iterations)
    got = tb.cg_solve(_t(a), _t(b), max_iter=3)
    want = jb.cg_solve(a, b, max_iter=3)
    assert int(got.iterations) == int(want.iterations) == 3
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0.0, atol=1e-10)


@pytest.mark.parametrize("seed,n", [(5, 12), (6, 20), (11, 4)])
def test_jacobi_solve_matches_reference(seed, n):
    """On diagonally dominant systems (test_solve_jacobi_on_sdd's draw and
    two more), where Jacobi converges."""
    r = np.random.default_rng(seed)
    a = random_sdd(r, n)
    x, b = random_rhs_from_solution(r, a)
    got = tb.jacobi_solve(_t(a), _t(b))
    want = jb.jacobi_solve(a, b)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0.0, atol=1e-10)
    np.testing.assert_allclose(got.x.numpy(), x, rtol=1e-5, atol=1e-9)
    assert int(got.iterations) == int(want.iterations)
    got = tb.jacobi_solve(_t(a), _t(b), max_iter=4)
    want = jb.jacobi_solve(a, b, max_iter=4)
    assert int(got.iterations) == int(want.iterations) == 4
