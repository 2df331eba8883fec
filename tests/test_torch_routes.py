"""Routing of the kernels with more than one route (K5, K6, K7a, K8) and
the splits of the kernels that reduce across a cluster (K4, K5, K6, K7a),
on the CPU.

* The route choosers are pure functions of dtype, shape and alignment:
  each returns the route its source note documents.
* K4, K5's narrow routes, K7a and K6's float32 routes split a reduction
  over the blocks of a thread-block cluster and add the partials in a
  fixed order: the split itself is a pure function of the shape, and the
  sums taken in that order stay within the kernels' bars of the plain
  versions.
* K8's ``p_dtype = None`` on the tensor cores splits p into two bf16
  parts, p_hi + p_lo; a plain emulation shows the split keeps p float32
  in meaning.
* On the CPU the wrappers run the plain versions and count no launch.

No JAX here: the parity of the plain versions with the reference is in
``tests/test_torch_ops.py`` and ``tests/test_torch_attention.py``.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as k8  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spd_transform as tr  # noqa: E402

# repro_torch.kernels re-exports functions named like these submodules
mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")
st = importlib.import_module("repro_torch.kernels.transient_step")

BF16, F32 = torch.bfloat16, torch.float32


# ---------------------------------------------------------------------------
# (a) the route choosers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb", [1, 5, 64])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_crosspoint_mvm_route(dtype, nb, aligned):
    """The GEMV (nb = 1) takes the FMA product in both dtypes; bf16 with
    nb >= 2 the tensor cores, by 16-byte copies only where k and nb are
    multiples of 8 and both bases are aligned; float32 with nb >= 2 the
    split-k FFMA product, by 16-byte copies only where k and nb are
    multiples of 4 and both bases are aligned."""
    m, k = 8192, 8192
    route = mvm.crosspoint_mvm_route(dtype, m, k, nb, aligned)
    if nb == 1:
        assert route == "fma"
    elif dtype == BF16:
        assert route == ("mma_async" if nb % 8 == 0 and aligned else "mma_scalar")
    else:
        assert route == ("f32_async" if nb % 4 == 0 and aligned else "f32_scalar")
    assert route in mvm.ROUTES


@pytest.mark.parametrize("m,k,nb,route", [
    (1000, 1048, 24, "mma_async"),    # m and k tails, 16-byte copies
    (300, 520, 64, "mma_async"),
    (300, 513, 5, "mma_scalar"),      # k and nb off the 8-element grid
    (257, 130, 64, "mma_scalar"),     # k off the grid
    (300, 513, 1, "fma"),             # the GEMV
    (1, 8, 8, "mma_async"),           # m does not change the route
])
def test_crosspoint_mvm_route_of_ragged_shapes(m, k, nb, route):
    """The ragged bf16 shapes the smoke run holds (RAGGED_MVM) reach the
    route it expects of each."""
    assert mvm.crosspoint_mvm_route(BF16, m, k, nb, True) == route


@pytest.mark.parametrize("m,k,nb,route", [
    (8192, 8192, 64, "f32_async"),    # the main path's batch of 64
    (1000, 1048, 24, "f32_async"),    # m and k tails, 16-byte copies
    (300, 520, 68, "f32_async"),      # a second column tile
    (300, 513, 64, "f32_scalar"),     # k off the 4-element grid
    (300, 520, 5, "f32_scalar"),      # nb off the grid
    (257, 130, 64, "f32_scalar"),
    (300, 513, 1, "fma"),             # the GEMV (common.cuh:gemv_rows)
    (1, 4, 4, "f32_async"),           # m does not change the route
])
def test_crosspoint_mvm_f32_route_of_ragged_shapes(m, k, nb, route):
    """The float32 shapes the smoke run holds (RAGGED_MVM_F32) reach the
    route it expects of each."""
    assert mvm.crosspoint_mvm_route(F32, m, k, nb, True) == route


@pytest.mark.parametrize("tiles,max_split,max_by_work,ranks", [
    (64, 8, 16, 2),      # 64 x 4 = 256 blocks would take a second wave
    (60, 4, 32, 4),      # 60 x 4 = 240 blocks: one wave exactly
    (16, 8, 4, 4),       # the work gives only 4 ranks a share
    (16, 8, 3, 2),       # rounded down to a power of two
    (30, 8, 64, 8),      # 30 clusters of 8: one wave exactly
    (241, 8, 64, 1),     # the tiles alone are past one wave
    (0, 8, 0, 1),        # nothing to split: one rank
])
def test_split_ranks(tiles, max_split, max_by_work, ranks):
    """The split kernels' shared chooser: the largest power of two up to
    max_split and max_by_work whose grid fits ONE_WAVE_BLOCKS, at least 1."""
    got = build.split_ranks(tiles, max_split, max_by_work)
    assert got == ranks and got & (got - 1) == 0
    assert got == 1 or tiles * got <= build.ONE_WAVE_BLOCKS


@pytest.mark.parametrize("m,k,nb,ranks", [
    (8192, 8192, 64, 2),     # 64 row tiles x 2 = 128 blocks: x 4 would not fit one wave
    (7680, 8192, 64, 4),     # 60 row tiles x 4 = 240 blocks
    (1000, 1048, 24, 4),
    (300, 513, 5, 2),        # ceil(513 / 256) = 3, rounded down to 2
    (257, 130, 64, 1),       # less than two ranks' worth of k
    (64, 64, 17, 1),
    (65536, 8192, 64, 1),    # 512 row tiles fill the card unsplit
    (16384, 8192, 64, 1),
    (8192, 8192, 128, 1),    # two column tiles
    (8192, 0, 64, 1),
])
def test_crosspoint_mvm_split(m, k, nb, ranks):
    """The k split of the float32 routes: the largest power of two up to 4
    that keeps the grid within one wave (240 blocks) and gives each rank
    at least 256 of k."""
    assert mvm.crosspoint_mvm_split(m, k, nb) == ranks


@pytest.mark.parametrize("k", [0, 1, 31, 32, 130, 513, 1048, 8192])
@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_k_ranges_cover_k_on_the_step_grid(k, ranks):
    """The ranks' k ranges, in rank order, cover [0, k) once; each starts
    on the 32-deep step grid, or at k when nothing is left for it."""
    ranges = mvm.k_ranges(k, ranks)
    assert len(ranges) == ranks
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a0 <= a1 == b0
    assert all(k0 % mvm.F32_BK == 0 or k0 == k for k0, _ in ranges)


@pytest.mark.parametrize("rows", [1, 3, 4096])
@pytest.mark.parametrize("cols", [4096, 4000, 4100, 4001])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_colabs_route(dtype, cols, rows, aligned):
    """K7a takes its 16-byte loads where a lane's 4 float32 or 8 bf16
    columns lie wholly inside every row and the base is aligned, else its
    scalar loads; rows (fewer than the cluster's blocks or not) do not
    change the route."""
    vec = 4 if dtype == F32 else 8
    want = "vec16" if cols % vec == 0 and aligned else "scalar"
    assert tr.colabs_route(dtype, rows, cols, aligned) == want
    assert want in tr.COLABS_ROUTES


@pytest.mark.parametrize("rows,ranks", [
    (0, 1), (1, 1), (3, 1), (64, 1), (65, 2), (128, 2), (200, 4), (256, 4),
    (257, 4), (4000, 8), (4096, 8), (100_000, 8),
])
def test_colabs_ranks(rows, ranks):
    """K7a's row split: a power of two up to 8 blocks, each with at least
    one pass of its 8 warps' 8-row groups; fewer rows than a cluster of 8
    takes fewer ranks."""
    assert tr.colabs_ranks(rows) == ranks


def _within(got: torch.Tensor, want: torch.Tensor, tol: float) -> bool:
    """max |got - want| <= tol max |want| (the kernel-API bars)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


# K7a's bar (chip_smoke.py, tests/test_kernels.py) and K6's float32 one
# (chip_smoke.py:TOL_MVM_F32), each times max |want|
TOL_COLABS, TOL_MVM_F32 = 1e-5, 5e-5


@pytest.mark.parametrize("shape", [(4000, 40), (1000, 33), (4096, 64), (130, 20), (3, 17)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_colabs_kernel_order_within_the_bar(shape, dtype):
    """K7a's order (rows split over ranks and warps, partials added in warp
    and rank order) gives column sums within 1e-5 max of the plain
    version, and adding the split in another rank order moves nothing
    past that bar either."""
    rng = np.random.default_rng(shape[0] + shape[1])
    a = torch.as_tensor(rng.standard_normal(shape), dtype=F32).to(dtype)
    got = tr.colabs_in_kernel_order(a)
    assert got.dtype == F32 and got.shape == (shape[1],)
    assert _within(got, tr.colabs_plain(a), TOL_COLABS)
    one_rank = tr.colabs_in_kernel_order(a, ranks=1)
    assert _within(got, one_rank, TOL_COLABS)


@pytest.mark.parametrize("shape", [(300, 513, 5), (1000, 1048, 24), (257, 130, 64),
                                   (300, 2048, 64)])
def test_mvm_split_order_within_the_bar(shape):
    """K6 float32's split-k order (each rank's k range, partials in rank
    order) stays within 5e-5 max of the plain product."""
    m, k, nb = shape
    rng = np.random.default_rng(m + k + nb)
    g = torch.as_tensor(rng.standard_normal((m, k)), dtype=F32)
    v = torch.as_tensor(rng.standard_normal((k, nb)), dtype=F32)
    got = mvm.crosspoint_mvm_in_split_order(g, v)
    assert _within(got, mvm.crosspoint_mvm_plain(g, v), TOL_MVM_F32)


@pytest.mark.parametrize("d", k8.HEAD_DIMS)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_attention_route(dtype, d, aligned):
    """bf16 takes the tensor cores at every head size when aligned;
    float32, and a bf16 view off the 16-byte grid, the FMA kernel."""
    want = "mma" if dtype == BF16 and aligned else "fma"
    assert k8.flash_attention_route(dtype, d, aligned) == want
    assert want in k8.ROUTES


# ---------------------------------------------------------------------------
# (b) the p_hi + p_lo split of K8's p_dtype = None on the tensor cores
# ---------------------------------------------------------------------------


def _split(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split: p_hi = bf16(p), p_lo = bf16(p - p_hi), both
    rounded to nearest even (``pack_bf16``/``bf16_residual`` in
    ``csrc/mma_bf16.cuh``)."""
    p_hi = p.to(BF16)
    p_lo = (p - p_hi.float()).to(BF16)
    return p_hi, p_lo


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_p_split_reconstructs_p(seed):
    """p_hi + p_lo is p within 2^-16 p for p in [0, 1] (the residual's
    bf16 rounding leaves at most 2^-9 of |p - p_hi| <= 2^-8 p)."""
    rng = np.random.default_rng(seed)
    p = torch.as_tensor(rng.uniform(0.0, 1.0, 100_000), dtype=F32)
    p = torch.cat([p, torch.exp(-torch.as_tensor(rng.uniform(0, 80, 10_000), dtype=F32)),
                   torch.tensor([0.0, 1.0])])
    p_hi, p_lo = _split(p)
    err = (p_hi.double() + p_lo.double() - p.double()).abs()
    assert bool((err <= 2.0**-16 * p.double()).all())


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits; the smallest normal's
    below it)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0**-126)))
    return torch.pow(2.0, e - 7)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("keys", [64, 2048])
def test_p_split_keeps_the_float32_pv_product(seed, keys):
    """(p_hi + p_lo) @ v for bf16 v, as two bf16 products into one float32
    sum, is the float32-p product within 2^-15 of sum p |v| (the split's
    2^-16 plus float32 sums in another order), and the two round to bf16
    outputs at most one bf16 ulp apart wherever the output is not
    cancelled below 2^-7 of sum p |v| (there float32 sums taken in two
    orders alone move it by more than its ulp): the split keeps
    p_dtype = None's meaning."""
    rng = np.random.default_rng(seed)
    p = torch.as_tensor(np.exp(-rng.uniform(0, 12, (32, keys))), dtype=F32)
    v = torch.as_tensor(rng.standard_normal((keys, 128)), dtype=F32).to(BF16).float()
    p_hi, p_lo = _split(p)
    want = p.double() @ v.double()
    got = p_hi.float() @ v + p_lo.float() @ v
    scale = p.double() @ v.double().abs()
    assert bool(((got.double() - want).abs() <= 2.0**-15 * scale).all())
    ref32 = (p @ v).to(BF16).double()
    out = got.to(BF16).double()
    kept = want.abs() >= 2.0**-7 * scale
    assert int(kept.sum()) > kept.numel() // 2
    ulps = (out - ref32).abs() / _bf16_ulp(ref32.float()).double()
    assert bool((ulps[kept] <= 1).all())


# ---------------------------------------------------------------------------
# (c) on the CPU the wrappers run the plain versions and count no launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("nb", [1, 5, 64])
def test_crosspoint_mvm_on_cpu_runs_the_plain_version(dtype, nb):
    rng = np.random.default_rng(nb)
    g = torch.as_tensor(rng.standard_normal((70, 90)), dtype=F32).to(dtype)
    v = torch.as_tensor(rng.standard_normal((90, nb)), dtype=F32).to(dtype)
    before = (ops.launch_counts(), ops.launch_counts_by_route())
    assert torch.equal(mvm.crosspoint_mvm(g, v), mvm.crosspoint_mvm_plain(g, v))
    assert (ops.launch_counts(), ops.launch_counts_by_route()) == before


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("cols", [64, 77])
def test_colabs_on_cpu_runs_the_plain_version(dtype, cols):
    rng = np.random.default_rng(cols)
    a = torch.as_tensor(rng.standard_normal((90, cols)), dtype=F32).to(dtype)
    before = (ops.launch_counts(), ops.launch_counts_by_route())
    assert torch.equal(tr.colabs(a), tr.colabs_plain(a))
    assert (ops.launch_counts(), ops.launch_counts_by_route()) == before


@pytest.mark.parametrize("dtype,p_dtype", [(F32, None), (BF16, None), (BF16, BF16)])
@pytest.mark.parametrize("d", [16, 128])
def test_flash_attention_on_cpu_runs_the_plain_version(dtype, p_dtype, d):
    gen = torch.Generator().manual_seed(d)
    q = torch.randn((1, 70, 4, d), generator=gen).to(dtype)
    k = torch.randn((1, 70, 2, d), generator=gen).to(dtype)
    v = torch.randn((1, 70, 2, d), generator=gen).to(dtype)
    before = (ops.launch_counts(), ops.launch_counts_by_route())
    got = k8.flash_attention(q, k, v, p_dtype=p_dtype)
    assert torch.equal(got, k8.flash_attention_plain(q, k, v, p_dtype=p_dtype))
    assert (ops.launch_counts(), ops.launch_counts_by_route()) == before


def test_launch_counts_by_route_keys_and_reset():
    """Every route of K5, K6, K7a and K8 has a count, and the reset zeroes
    them beside the per-kernel counts."""
    counts = ops.launch_counts_by_route()
    assert set(counts) == {"transient_step", "crosspoint_mvm", "colabs", "flash_attention"}
    assert set(counts["transient_step"]) == set(st.STEP_ROUTES)
    assert set(counts["crosspoint_mvm"]) == set(mvm.ROUTES)
    assert set(counts["colabs"]) == set(tr.COLABS_ROUTES)
    assert set(counts["flash_attention"]) == set(k8.ROUTES)
    by_dtype = ops.launch_counts_by_dtype()
    assert set(by_dtype) == {"float32", "bfloat16"}
    assert all(set(by_route) == set(st.STEP_ROUTES) for by_route in by_dtype.values())
    ops.reset_launch_counts()
    assert all(n == 0 for by_route in ops.launch_counts_by_route().values()
               for n in by_route.values())
    assert all(n == 0 for by_route in ops.launch_counts_by_dtype().values()
               for n in by_route.values())
    assert all(n == 0 for n in ops.launch_counts().values())


# ---------------------------------------------------------------------------
# (d) K4 and K5's narrow routes: splits, routes and sum orders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bsz,n,ranks", [
    (4, 2048, 2),     # the settle sweep's shape: 64 row blocks, 128 blocks
    (1, 8192, 2),     # one n = 1024 circuit (the K5 vs K4 check)
    (4, 1024, 4),
    (4, 640, 4),      # five column chunks: one rank short
    (4, 512, 4),
    (4, 384, 2),      # three column chunks
    (1, 128, 1),      # one chunk
    (64, 2048, 1),    # 1024 row blocks fill the card alone
])
def test_dense_step_ranks(bsz, n, ranks):
    """K4's split: the largest power of two up to 8 that keeps the grid
    within 240 blocks (one wave) and gives every rank a column chunk."""
    assert st.dense_step_ranks(bsz, n) == ranks
    row_blocks = bsz * n // st.ROW_BLOCK
    assert ranks == 1 or row_blocks * ranks <= build.ONE_WAVE_BLOCKS
    assert ranks <= n // st.DENSE_STEP_CHUNK


@pytest.mark.parametrize("n", [128, 384, 640, 2048, 8192])
@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_dense_step_column_ranges_cover_the_columns(n, ranks):
    """The ranks' column ranges tile [0, n) in order, on the 128-column grid."""
    ranges = st.dense_step_column_ranges(n, ranks)
    assert len(ranges) == ranks and ranges[0][0] == 0 and ranges[-1][1] == n
    for (a0, a1), (b0, _b1) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(c0 % 128 == 0 and c0 <= c1 for c0, c1 in ranges)


@pytest.mark.parametrize("bsz,n", [(4, 2048), (4, 640), (2, 384), (1, 1024)])
def test_dense_step_kernel_order_within_the_bar(bsz, n):
    """K4's split order in plain PyTorch (each rank's columns as one
    product, the partials in rank order) against the plain step, within
    the sweeps' bar of 1e-5 max|z'|; the block maxima are the plain ones."""
    rng = np.random.default_rng(n + bsz)
    m = torch.as_tensor(rng.uniform(-1, 1, (bsz, n, n)) / n ** 0.5, dtype=F32)
    z = torch.as_tensor(rng.uniform(-0.5, 0.5, (bsz, n)), dtype=F32)
    c = torch.as_tensor(rng.uniform(-0.5, 0.5, (bsz, n)), dtype=F32)
    got, res = st.dense_step_in_kernel_order(m, z, c, 0.5)
    want, want_res = st.transient_step_batched_plain(m, z, c, 0.5)
    assert res.shape == want_res.shape == (bsz, n // 128)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float((res - want_res).abs().max()) <= 1e-4 * float(want_res.abs().max())


@pytest.mark.parametrize("nb", [1, 2, 5, 8, 12, 16, 17, 64])
@pytest.mark.parametrize("n", [8192, 8190, 137])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_transient_step_route(dtype, n, nb, aligned):
    """nb = 1 takes the column tile and nb > 16 the wide one in both
    dtypes; between, the split-k product, by 16-byte copies only where n
    and nb are multiples of 4 (float32) or 8 (bf16) and both bases are
    aligned."""
    route = st.transient_step_route(dtype, n, nb, aligned)
    per_chunk = 8 if dtype == BF16 else 4
    if nb == 1:
        assert route == "column"
    elif nb > 16:
        assert route == "wide"
    else:
        vec16 = n % per_chunk == 0 and nb % per_chunk == 0 and aligned
        assert route == ("narrow_async" if vec16 else "narrow_scalar")
    assert route in st.STEP_ROUTES


@pytest.mark.parametrize("n,ranks", [
    (8192, 2),     # 64 row tiles: 4 ranks would be 256 blocks, past one wave
    (8190, 2),
    (4096, 4),     # 32 tiles
    (1000, 2),     # 8 tiles, each rank at least 512 of k
    (512, 1),
    (137, 1),
    (16384, 1),    # 128 tiles fill the card alone
])
def test_transient_step_split(n, ranks):
    """K5's narrow split: the largest power of two up to 8 that keeps the
    grid within 240 blocks and gives each rank at least 512 of k."""
    assert st.transient_step_split(n) == ranks
    tiles = -(-n // st.NARROW_BM)
    assert ranks == 1 or tiles * ranks <= build.ONE_WAVE_BLOCKS


@pytest.mark.parametrize("n", [0, 1, 63, 64, 137, 1000, 8190, 8192])
@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_narrow_k_ranges_cover_k_on_the_grid(n, ranks):
    """The ranks' k ranges tile [0, n) in rank order, each starting on the
    64-deep grid that both dtypes' steps divide."""
    ranges = st.narrow_k_ranges(n, ranks)
    assert len(ranges) == ranks and ranges[0][0] == 0 and ranges[-1][1] == n
    for (a0, a1), (b0, _b1) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(k0 % st.NARROW_K_GRID == 0 or k0 == n for k0, _ in ranges)


@pytest.mark.parametrize("shape", [(2048, 16), (1000, 16), (137, 5), (300, 2), (700, 12)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_transient_step_kernel_order_within_the_bar(shape, dtype):
    """K5's narrow order in plain PyTorch (each warp's k slice of each
    128-byte step, warps then ranks in order) against the plain step:
    float32 within 5e-5 max|want| (the kernel-API bar), bf16 element by
    element within one bf16 rounding of the float32 result."""
    n, nb = shape
    rng = np.random.default_rng(n + nb)
    m = torch.as_tensor(rng.uniform(-1, 1, (n, n)) / n ** 0.5, dtype=F32).to(dtype)
    z = torch.as_tensor(rng.uniform(-0.5, 0.5, (n, nb)), dtype=F32).to(dtype)
    c = torch.as_tensor(rng.uniform(-0.5, 0.5, (n, nb)), dtype=F32).to(dtype)
    got = st.transient_step_in_kernel_order(m, z, c, 0.5)
    want = st.transient_step_plain(m, z, c, 0.5)
    assert got.dtype == dtype and got.shape == (n, nb)
    g, w = got.double(), want.double()
    if dtype == F32:
        assert float((g - w).abs().max()) <= 5e-5 * float(w.abs().max())
    else:
        assert bool(((g - w).abs() <= 1e-2 * w.abs() + 1e-3 * w.abs().max()).all())


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("nb", [1, 5, 16, 33])
def test_transient_step_on_cpu_runs_the_plain_version(dtype, nb):
    rng = np.random.default_rng(nb)
    m = torch.as_tensor(rng.standard_normal((90, 90)) * 0.1, dtype=F32).to(dtype)
    z = torch.as_tensor(rng.standard_normal((90, nb)), dtype=F32).to(dtype)
    before = (ops.launch_counts(), ops.launch_counts_by_route(), ops.launch_counts_by_dtype())
    assert torch.equal(st.transient_step(m, z, z, 0.1), st.transient_step_plain(m, z, z, 0.1))
    assert (ops.launch_counts(), ops.launch_counts_by_route(),
            ops.launch_counts_by_dtype()) == before


def test_transient_step_batched_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(3)
    m = torch.as_tensor(rng.standard_normal((2, 256, 256)) * 0.05, dtype=F32)
    z = torch.as_tensor(rng.standard_normal((2, 256)), dtype=F32)
    before = ops.launch_counts()
    for got, want in zip(st.transient_step_batched(m, z, z, 0.5),
                         st.transient_step_batched_plain(m, z, z, 0.5)):
        assert torch.equal(got, want)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("n,route", [(40, "dense"), (48, "dense"), (64, "dense"),
                                     (80, "dense-step"), (256, "dense-step")])
@pytest.mark.parametrize("sweep_dtype", ["float32", "bfloat16"])
def test_dense_prepare_lays_out_the_operand_for_its_kernel(n, route, sweep_dtype):
    """dense_prepare rounds through the sweep dtype, pads to the row block
    and transposes for K3 only (the persistent route up to a 1 MiB
    operator: nz = 8n states on the proposed design)."""
    nz = 8 * n
    rng = np.random.default_rng(n)
    m = torch.as_tensor(rng.standard_normal((2, nz, nz)), dtype=F32)
    got_route, operand = ops.dense_prepare(m, sweep_dtype)
    assert got_route == route == ops.sweep_backend(nz, None)
    size = nz + (-nz) % 128
    assert operand.shape == (2, size, size) and operand.is_contiguous()
    want = m.to(BF16).float() if sweep_dtype == "bfloat16" else m
    want = ops.pad_rows(want, (1, 2))
    if route == "dense":
        want = want.transpose(1, 2)
    assert torch.equal(operand, want)


@pytest.mark.parametrize("n", [40, 80])
def test_transient_sweep_transposed_operand_on_both_routes(n):
    """m_transposed=True takes M^T padded on both sides of the persistent
    route's limit and gives what the untransposed call gives; the
    prepared path (the engine's) gives it too."""
    nz = 8 * n
    rng = np.random.default_rng(n + 1)
    m = torch.as_tensor(rng.uniform(-1, 1, (2, nz, nz)) * 0.3 / nz ** 0.5 - 0.5 * np.eye(nz),
                        dtype=F32)
    z = torch.as_tensor(rng.uniform(-0.5, 0.5, (2, nz)), dtype=F32)
    c = torch.as_tensor(rng.uniform(-0.5, 0.5, (2, nz)), dtype=F32)
    want_z, want_r = ops.transient_sweep(m, z, c, n_steps=7)
    zp, cp = ops.pad_rows(z, (1,)), ops.pad_rows(c, (1,))
    mt = ops.pad_rows(m, (1, 2)).transpose(1, 2).contiguous()
    got_z, got_r = ops.transient_sweep(mt, zp, cp, n_steps=7, m_transposed=True)
    assert torch.equal(got_z[:, :nz], want_z) and torch.equal(got_r, want_r)
    route, operand = ops.dense_prepare(m)
    prep_z, prep_r = ops.dense_sweep_prepared(route, operand, zp, cp, n_steps=7)
    assert torch.equal(prep_z[:, :nz], want_z) and torch.equal(prep_r, want_r)
