"""The GEMV of K6 at b = 1 and K5 at nb = 1 (``repro_torch.kernels.gemv``)
on the CPU: its order of summation against the reference and the plain
versions, its row plan, its k layout and its variant.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``
holds them bit for bit against :func:`gemv.gemv_in_kernel_order`); what is
checked here is the plain-PyTorch order that gives their bits, and the
pure functions that choose the split and the variant.  Inputs are drawn
with numpy and rounded to the working dtype once, so both packages see
identical operands.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402

from repro_torch.kernels import gemv, ops  # noqa: E402

mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")
st = importlib.import_module("repro_torch.kernels.transient_step")

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPES = ["float32", "bfloat16"]
# float32: the reference's kernel-test bar (tests/test_kernels.py), scaled
# to the largest output: k <= 8190 float32 sums taken in another order.
TOL_F32 = 5e-5
# bf16 outputs: both sides round float32 sums taken in other orders to
# bf16, so a sound pair lies at most one bf16 ulp (2^-7 |want|) apart; the
# atol, scaled to the output, covers outputs near zero (chip_smoke.py's
# element-by-element bar for the crossbar's bf16 products).
BF16_RTOL, BF16_ATOL_OF_MAX = 1e-2, 1e-3
# (m, k): aligned, k off the 4- and 8-element grids, k = 8190, m = 8190
MVM_SHAPES = [(64, 64), (137, 137), (300, 513), (64, 8190), (8190, 40), (5, 1)]
# n: aligned (a multiple of 8), off the grid, one past a multiple of 1024
STEP_SIZES = [128, 137, 1030]


def _pair(x: np.ndarray, dt: str):
    xj = jnp.asarray(x, JNP[dt])
    return xj, torch.from_numpy(np.array(xj, np.float32)).to(TORCH[dt])


def _hold(got: torch.Tensor, want, dt: str) -> None:
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    if dt == "float32":
        assert float(np.abs(got - want).max()) <= TOL_F32 * scale
    else:
        assert np.all(np.abs(got - want) <= BF16_RTOL * np.abs(want) + BF16_ATOL_OF_MAX * scale)


@pytest.mark.parametrize("m,k", MVM_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_crosspoint_order_matches_reference(m, k, dt):
    """K6's b = 1 order against ``repro.kernels.ops.crosspoint_mvm`` (the
    Pallas kernel in interpret mode, padded) on the same operands."""
    rng = np.random.default_rng(m * 7 + k)
    gj, gt = _pair(rng.uniform(0, 1e-3, (m, k)), dt)
    vj, vt = _pair(rng.uniform(-1, 1, k), dt)
    want = np.asarray(jops.crosspoint_mvm(gj, vj, interpret=True), np.float32)
    got = mvm.crosspoint_mvm_in_kernel_order(gt, vt[:, None])[:, 0]
    assert got.dtype == TORCH[dt] and got.shape == (m,)
    _hold(got, want, dt)


@pytest.mark.parametrize("n", STEP_SIZES)
@pytest.mark.parametrize("dt", DTYPES)
def test_transient_step_order_matches_reference(n, dt):
    """K5's nb = 1 order (the column route's step) against
    ``repro.kernels.ops.transient_step`` in interpret mode at dt = 1, where
    the product is as large as the state."""
    rng = np.random.default_rng(n)
    mj, mt = _pair(rng.uniform(-1, 1, (n, n)) * 0.1 * min(1.0, (137 / n) ** 0.5), dt)
    zj, zt = _pair(rng.uniform(-1, 1, n), dt)
    cj, ct = _pair(rng.uniform(-1, 1, n), dt)
    want = np.asarray(jops.transient_step(mj, zj, cj, 1.0, interpret=True), np.float32)
    got = st.transient_step_in_kernel_order(mt, zt[:, None], ct[:, None], 1.0)[:, 0]
    assert got.dtype == TORCH[dt] and got.shape == (n,)
    _hold(got, want, dt)


@pytest.mark.parametrize("m,k", MVM_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_orders_match_plain_versions(m, k, dt):
    """Both orders against the plain versions (one float32 product), and
    the CPU wrappers run the plain versions and count no launch."""
    rng = np.random.default_rng(m + 3 * k)
    g = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.float32).to(TORCH[dt])
    v = torch.as_tensor(rng.standard_normal((k, 1)), dtype=torch.float32).to(TORCH[dt])
    ops.reset_launch_counts()
    _hold(mvm.crosspoint_mvm_in_kernel_order(g, v), mvm.crosspoint_mvm_plain(g, v).float(), dt)
    assert torch.equal(mvm.crosspoint_mvm(g, v), mvm.crosspoint_mvm_plain(g, v))
    sq = g[:min(m, k), :min(m, k)].contiguous()
    z, c = v[:sq.shape[0]], v[:sq.shape[0]].flip(0).contiguous()
    _hold(st.transient_step_in_kernel_order(sq, z, c, 0.5),
          st.transient_step_plain(sq, z, c, 0.5).float(), dt)
    assert torch.equal(st.transient_step(sq, z, c, 0.5), st.transient_step_plain(sq, z, c, 0.5))
    assert not any(ops.launch_counts().values())
    assert all(n == 0 for per in ops.launch_counts_by_gemv_variant().values()
               for n in per.values())


@pytest.mark.parametrize("k", [1, 5, 128, 131, 8190])
@pytest.mark.parametrize("dt", DTYPES)
def test_order_is_the_lane_loop(k, dt):
    """The vectorised order against the kernel's loop written out one
    float32 operation at a time in numpy: lane l adds chunk l + 32 j, j
    ascending, each product rounded before its add; the chunk's
    accumulators pairwise; the lanes by the shuffle tree."""
    rng = np.random.default_rng(k)
    a = torch.as_tensor(rng.standard_normal((3, k)), dtype=torch.float32).to(TORCH[dt])
    x = torch.as_tensor(rng.standard_normal(k), dtype=torch.float32).to(TORCH[dt])
    af, xf = a.float().numpy(), x.float().numpy()
    idx = gemv.lane_chunks(k, TORCH[dt]).numpy()
    steps, lanes, e = idx.shape
    want = np.zeros(3, np.float32)
    for r in range(3):
        acc = np.zeros((lanes, e), np.float32)
        for j in range(steps):
            for lane in range(lanes):
                for q in range(e):
                    i = idx[j, lane, q]
                    p = np.float32(af[r, i] * xf[i]) if i < k else np.float32(0.0)
                    acc[lane, q] = np.float32(acc[lane, q] + p)
        while acc.shape[1] > 1:
            acc = (acc[:, 0::2] + acc[:, 1::2]).astype(np.float32)
        s = acc[:, 0]
        o = lanes // 2
        while o:
            s = (s[:o] + s[o:2 * o]).astype(np.float32)
            o //= 2
        want[r] = s[0]
    assert np.array_equal(gemv.gemv_in_kernel_order(a, x).numpy(), want)


@pytest.mark.parametrize("m", [1, 2, 5, 131, 132, 133, 137, 264, 1000, 4096, 8190, 8192,
                               16384, 100_003])
def test_plan_covers_every_row_once_within_one_wave(m):
    """Every row is added by exactly one warp; the grid is one wave of at
    most GEMV_SMS blocks, the blocks' row counts differ by at most one (the
    largest within one row of the mean m / blocks), and the plan's
    rows_per_block and rows_per_warp are the largest block's and warp's."""
    plan = gemv.gemv_plan(m)
    blocks, warps = plan["blocks"], plan["warps"]
    assert 1 <= blocks <= gemv.GEMV_SMS and 1 <= warps <= gemv.GEMV_WARPS
    per_block, per_warp, seen = [], [], []
    for b in range(blocks):
        rows_b = []
        for w in range(warps):
            rows_w = gemv.gemv_rows_of(m, b, w)
            per_warp.append(len(rows_w))
            rows_b += rows_w
        per_block.append(len(rows_b))
        seen += rows_b
    assert sorted(seen) == list(range(m))
    assert max(per_block) - min(per_block) <= 1
    assert max(per_block) == plan["rows_per_block"] < m / blocks + 1
    assert max(per_warp) == plan["rows_per_warp"]


@pytest.mark.parametrize("k", [1, 3, 4, 8, 127, 128, 129, 513, 8190, 8192])
@pytest.mark.parametrize("dt", DTYPES)
def test_lanes_cover_every_k_once(k, dt):
    """Every element of a row is one lane's at one step, each lane walking
    its 16-byte chunks l + 32 j in order; only the last step holds padding
    past k."""
    idx = gemv.lane_chunks(k, TORCH[dt])
    steps, lanes, e = idx.shape
    assert lanes == 32 and e == 16 // TORCH[dt].itemsize
    flat = idx.flatten()
    assert sorted(flat[flat < k].tolist()) == list(range(k))
    assert int((flat >= k).sum()) == steps * lanes * e - k
    assert bool((idx[:-1] < k).all())
    chunk = idx // e
    assert torch.equal(chunk[:, :, 0] % 32, torch.arange(32).expand(steps, 32))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("k", [1, 4, 6, 8, 137, 8190, 8192])
@pytest.mark.parametrize("dt", DTYPES)
def test_variant(dt, k, aligned):
    """16-byte loads only where every row is whole chunks (k a multiple of
    4 in float32, of 8 in bf16) and both bases are aligned; else the
    masked scalar loads of the same chunks."""
    per_chunk = 4 if dt == "float32" else 8
    want = "vec16" if aligned and k % per_chunk == 0 else "scalar"
    assert gemv.gemv_variant(TORCH[dt], k, aligned) == want
    assert want in gemv.VARIANTS


def test_launch_counts_by_gemv_variant_keys_and_reset():
    counts = ops.launch_counts_by_gemv_variant()
    assert set(counts) == {"crosspoint_mvm", "transient_step"}
    assert all(set(per) == set(gemv.VARIANTS) for per in counts.values())
    mvm.crosspoint_mvm.launches_by_variant["vec16"] += 1
    ops.reset_launch_counts()
    assert all(n == 0 for per in ops.launch_counts_by_gemv_variant().values()
               for n in per.values())
