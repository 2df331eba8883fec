"""Port parity: repro_torch.data.fem against repro.data.fem, bit for bit
(pure numpy on both sides), and the stencil's definition
(tests/test_batched_newton.py's FEM checks)."""

import numpy as np
import pytest

from repro.data import fem as jfem

from repro_torch.data import fem as tfem


def _poisson_reference(nx, ny, scale, reaction):
    """Literal 5-point stencil loop."""
    n = nx * ny
    a = np.zeros((n, n))
    for i in range(nx):
        for j in range(ny):
            k = i * ny + j
            a[k, k] = 4.0 + reaction
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < nx and 0 <= jj < ny:
                    a[k, ii * ny + jj] = -1.0
    return a * scale


@pytest.mark.parametrize("nx,ny,kw", [
    (4, 4, {}), (3, 5, {}), (6, 2, dict(conductance_scale=3e-5, reaction=0.5)), (1, 7, {}),
])
def test_poisson_arrays_match_reference_bit_for_bit(nx, ny, kw):
    dense = tfem.poisson_2d(nx, ny, **kw)
    assert np.array_equal(dense, jfem.poisson_2d(nx, ny, **kw))
    assert np.array_equal(dense, _poisson_reference(
        nx, ny, kw.get("conductance_scale", 100e-6), kw.get("reaction", 0.1)))
    ell, jell = tfem.poisson_2d_ell(nx, ny, **kw), jfem.poisson_2d_ell(nx, ny, **kw)
    assert ell.indices.dtype == jell.indices.dtype == np.int32
    assert np.array_equal(ell.indices, jell.indices)
    assert np.array_equal(ell.weights, jell.weights)
    assert ell.n == jell.n == nx * ny
    assert np.array_equal(ell.to_dense(), dense)
    v = np.random.default_rng(8).normal(size=(3, nx * ny))
    assert np.array_equal(ell.matvec(v), jell.matvec(v))
    assert np.abs(ell.matvec(v[0]) - dense @ v[0]).max() <= 1e-18
    assert np.array_equal(tfem.poisson_rhs(nx, ny), jfem.poisson_rhs(nx, ny))
    assert np.array_equal(tfem.poisson_rhs(nx, ny, scale=3e-6),
                          jfem.poisson_rhs(nx, ny, scale=3e-6))
    assert tfem.ELL_WIDTH == jfem.ELL_WIDTH


@pytest.mark.parametrize("seed,count,grids", [
    (0, 10, ((4, 4), (5, 5), (6, 6))),
    (11, 8, ((4, 4), (5, 5), (6, 6), (8, 8))),
    (99, 6, ((16, 16), (24, 24), (32, 32))),
])
def test_mesh_stream_matches_reference_bit_for_bit(seed, count, grids):
    got = list(tfem.mesh_stream(seed, count, grids=grids))
    want = list(jfem.mesh_stream(seed, count, grids=grids))
    assert len(got) == len(want) == count
    for m, w in zip(got, want):
        assert (m.nx, m.ny, m.n) == (w.nx, w.ny, w.n)
        assert np.array_equal(m.a, w.a) and np.array_equal(m.b, w.b)


def test_mesh_stream_is_seeded_and_prefix_stable():
    a = list(tfem.mesh_stream(11, 8))
    prefix = list(tfem.mesh_stream(11, 4))
    other = list(tfem.mesh_stream(12, 8))
    for ma, mp in zip(a, prefix):
        assert (ma.nx, ma.ny) == (mp.nx, mp.ny) and np.array_equal(ma.b, mp.b)
    assert any((ma.nx, ma.ny) != (mo.nx, mo.ny) or not np.array_equal(ma.b, mo.b)
               for ma, mo in zip(a, other))


def test_mesh_operators_are_sdd_and_passive():
    from repro_torch.core.network import build_proposed

    for m in tfem.mesh_stream(0, 4, grids=((4, 4), (5, 5))):
        diag = np.abs(np.diag(m.a))
        off = np.abs(m.a).sum(axis=0) - diag
        assert (diag > off).all()
        assert build_proposed(m.a, m.b, device="cpu").is_passive
