"""Finite-element / finite-difference assembly — the paper's motivating
application domain (Sec. VI: "such as those arising from Finite Element
Analysis in Computational Solid Mechanics").

A copy of :mod:`repro.data.fem` (host numpy, so the port keeps its own):
the same functions give the same arrays, bit for bit.

:func:`poisson_2d` assembles the 5-point Laplacian stiffness matrix of
the 2-D Poisson problem on a unit square with Dirichlet boundaries —
a symmetric *diagonally dominant* system, i.e. exactly the class the
proposed design solves with a purely passive network at O(1).

Assembly is vectorized (no Python loop over grid points): the dense form
scatters the four neighbor couplings with index arithmetic, and
:func:`poisson_2d_ell` emits the same operator directly as padded ELL
``(indices, weights)`` arrays without materializing the ``(n, n)``
matrix.  :func:`mesh_stream` turns the assembly into a seeded mixed-size
request stream, the solve service's FEM traffic model (see
``examples/fem_poisson_torch.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

# interior couplings of the 5-point stencil: diag + 4 neighbors
ELL_WIDTH = 5


def _stencil_entries(nx: int, ny: int):
    """Vectorized 5-point stencil structure on the nx-by-ny interior
    grid with ``idx(i, j) = i * ny + j`` row ordering.

    Returns ``(rows, cols)`` of every off-diagonal ``-1`` coupling
    (both orientations, so the scatter is symmetric by construction).
    """
    i = np.repeat(np.arange(nx), ny)          # (n,) grid row of each node
    j = np.tile(np.arange(ny), nx)            # (n,) grid col of each node
    k = i * ny + j                            # == idx(i, j)

    # undirected edges: east neighbor (i+1, j) and north neighbor (i, j+1)
    east = i < nx - 1
    north = j < ny - 1
    src = np.concatenate([k[east], k[north]])
    dst = np.concatenate([k[east] + ny, k[north] + 1])
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    return rows, cols


def poisson_2d(
    nx: int,
    ny: int,
    *,
    conductance_scale: float = 100e-6,
    reaction: float = 0.1,
) -> np.ndarray:
    """5-point Laplacian + reaction term on an nx-by-ny interior grid
    (Dirichlet): the discretization of  -div(grad u) + c u = f.

    ``reaction > 0`` gives every column a strict dominance margin (the
    pure Laplacian's interior rows have zero slack, so any nonzero
    supply conductance K_s would tip Eq. 25); with it the transformed
    network is fully passive.  Scaled into the paper's uS range.
    """
    n = nx * ny
    a = np.zeros((n, n))
    rows, cols = _stencil_entries(nx, ny)
    a[rows, cols] = -1.0
    a[np.arange(n), np.arange(n)] = 4.0 + reaction
    return a * conductance_scale


@dataclasses.dataclass(frozen=True)
class PoissonEll:
    """The 5-point operator in padded ELL form: row ``k`` couples to
    ``indices[k, :]`` with ``weights[k, :]`` (padding lanes carry index
    ``k`` itself with weight 0, so a gather-based SpMV needs no mask).
    """

    nx: int
    ny: int
    indices: np.ndarray        # (n, ELL_WIDTH) int32
    weights: np.ndarray        # (n, ELL_WIDTH) float64

    @property
    def n(self) -> int:
        return self.nx * self.ny

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """y = A x without densifying (works on (n,) or (..., n))."""
        x = np.asarray(x)
        return np.einsum("...nk,...nk->...n", self.weights, x[..., self.indices])

    def to_dense(self) -> np.ndarray:
        """Materialize (n, n) — tests/small grids only."""
        a = np.zeros((self.n, self.n))
        np.add.at(a, (np.repeat(np.arange(self.n), ELL_WIDTH),
                      self.indices.reshape(-1)), self.weights.reshape(-1))
        return a


def poisson_2d_ell(
    nx: int,
    ny: int,
    *,
    conductance_scale: float = 100e-6,
    reaction: float = 0.1,
) -> PoissonEll:
    """Assemble the same operator as :func:`poisson_2d` directly in ELL
    form — O(n) memory, no dense (n, n) materialization, so grids far
    beyond 64x64 are representable.  ``to_dense()`` matches
    :func:`poisson_2d` exactly (tested)."""
    n = nx * ny
    k = np.arange(n)
    i, j = k // ny, k % ny
    # lanes: [diag, west, east, south, north]; invalid neighbors pad to
    # the row's own index with weight 0
    offs = np.array([0, -ny, ny, -1, 1])
    valid = np.stack([
        np.ones(n, dtype=bool),
        i > 0, i < nx - 1, j > 0, j < ny - 1,
    ], axis=1)
    indices = np.where(valid, k[:, None] + offs[None, :], k[:, None])
    weights = np.where(valid, -1.0, 0.0)
    weights[:, 0] = 4.0 + reaction
    return PoissonEll(
        nx=nx,
        ny=ny,
        indices=indices.astype(np.int32),
        weights=weights * conductance_scale,
    )


def poisson_rhs(nx: int, ny: int, *, scale: float = 1e-6) -> np.ndarray:
    """Smooth source term f(x, y) = sin(pi x) sin(pi y), scaled to the
    paper's current range (uA)."""
    xs = (np.arange(nx) + 1) / (nx + 1)
    ys = (np.arange(ny) + 1) / (ny + 1)
    f = np.sin(np.pi * xs)[:, None] * np.sin(np.pi * ys)[None, :]
    return (f * scale).reshape(-1)


@dataclasses.dataclass(frozen=True)
class MeshProblem:
    """One item of a FEM request stream: the assembled operator of an
    ``nx`` x ``ny`` Poisson grid plus a randomized smooth source."""

    nx: int
    ny: int
    a: np.ndarray              # (n, n) stiffness, uS range
    b: np.ndarray              # (n,) source currents, uA range

    @property
    def n(self) -> int:
        return self.nx * self.ny


def mesh_stream(
    seed: int,
    count: int,
    *,
    grids: Sequence[tuple[int, int]] = ((4, 4), (5, 5), (6, 6), (8, 8)),
    conductance_scale: float = 100e-6,
    reaction: float = 0.1,
    source_scale: float = 1e-6,
    n_modes: int = 3,
) -> Iterator[MeshProblem]:
    """Seeded mixed-n FEM mesh stream for serving traffic.

    Yields ``count`` :class:`MeshProblem` items, each a uniformly drawn
    grid size from ``grids`` with a randomized smooth source (a random
    combination of the first ``n_modes`` x ``n_modes`` Dirichlet sine
    modes — the realistic load pattern: one fixed sparsity class per
    grid size, varying right-hand sides).  Deterministic in ``seed``,
    independent of ``count`` prefix-wise (item k is the same whether
    you ask for 10 or 1000 items).
    """
    rng = np.random.default_rng(seed)
    cache: dict[tuple[int, int], np.ndarray] = {}
    for _ in range(count):
        nx, ny = grids[int(rng.integers(len(grids)))]
        key = (nx, ny)
        if key not in cache:
            cache[key] = poisson_2d(
                nx, ny,
                conductance_scale=conductance_scale, reaction=reaction,
            )
        xs = (np.arange(nx) + 1) / (nx + 1)
        ys = (np.arange(ny) + 1) / (ny + 1)
        amps = rng.uniform(-1.0, 1.0, size=(n_modes, n_modes))
        f = np.zeros((nx, ny))
        for p in range(n_modes):
            for q in range(n_modes):
                f += amps[p, q] * (
                    np.sin((p + 1) * np.pi * xs)[:, None]
                    * np.sin((q + 1) * np.pi * ys)[None, :]
                )
        yield MeshProblem(
            nx=nx, ny=ny, a=cache[key], b=(f * source_scale).reshape(-1)
        )
