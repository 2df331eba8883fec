"""The persistent sweeps K1 and K3 of repro_torch: their cluster layouts
and the contracts the Hopper kernels are held to, on the CPU.

Each system runs on the R blocks of a thread-block cluster, its share of
the operator resident in shared memory where it fits beside the state
(``ell_sweep_ranks`` / ``ell_sweep_variant``, ``dense_sweep_ranks`` /
``dense_sweep_variant``: pure functions of the shape, held here).  The
kernels themselves run only on a CUDA device (``tests/test_torch_cuda.py``);
their parity with the reference's Pallas kernels is held in
``tests/test_torch_kernels.py``.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ell_transient as ell  # noqa: E402

st = importlib.import_module("repro_torch.kernels.transient_step")

F32, BF16 = torch.float32, torch.bfloat16


def _ell_bytes(nz_p, k, isz, ranks):
    return nz_p // ranks * k * (4 + isz) + 2 * nz_p * 4 + build.SWEEP_SCRATCH_BYTES


def _dense_bytes(n, ranks):
    return n * (n // ranks) * 4 + 2 * n * 4 + build.SWEEP_SCRATCH_BYTES


# ---------------------------------------------------------------------------
# cluster layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nz_p,k,isz,ranks,variant", [
    (8192, 32, 4, 16, "resident"),    # matrix-free n = 1024: 131,072 B of slots a rank
    (8192, 32, 2, 16, "resident"),    # the same in bf16: 98,304 B
    (2048, 29, 4, 4, "resident"),     # n = 256, transient_batch / euler_settle_batch
    (2048, 29, 2, 2, "resident"),
    (16384, 33, 4, 16, "streamed"),   # n = 2048 (4.3 MB a system), K2's route
    (16384, 33, 2, 16, "streamed"),
    (640, 20, 4, 1, "resident"),
    (128, 10, 4, 1, "resident"),
])
def test_ell_sweep_layout_at_the_engine_shapes(nz_p, k, isz, ranks, variant):
    """K1's designed cluster size and variant at the shapes the main path
    and the smoke build."""
    assert ell.ell_sweep_ranks(nz_p, k, isz) == ranks
    assert ell.ell_sweep_variant(nz_p, k, isz) == variant
    assert ell.ell_sweep_fits(nz_p, k, isz, ranks) == (variant == "resident")


@pytest.mark.parametrize("nz_p", [128, 256, 640, 1024, 2048, 5120, 8192, 16384, 28928])
@pytest.mark.parametrize("k", [1, 7, 29, 32, 33, 64])
@pytest.mark.parametrize("isz", [2, 4])
def test_ell_sweep_layout_properties(nz_p, k, isz):
    """R is a power of two up to 16 that splits nz_p into whole rows, a
    multiple of 8 a rank (16-byte copies); a resident choice fits one
    block's 232,448 bytes and is the smallest R that does; a streamed one
    is R = 16, where no R fits."""
    ranks = ell.ell_sweep_ranks(nz_p, k, isz)
    variant = ell.ell_sweep_variant(nz_p, k, isz)
    assert ranks in (1, 2, 4, 8, 16) and nz_p % (8 * ranks) == 0
    assert variant in build.SWEEP_VARIANTS
    if variant == "resident":
        assert _ell_bytes(nz_p, k, isz, ranks) <= build.SMEM_PER_BLOCK
        assert ranks == 1 or _ell_bytes(nz_p, k, isz, ranks // 2) > build.SMEM_PER_BLOCK
    else:
        assert ranks == build.SWEEP_MAX_RANKS
        assert _ell_bytes(nz_p, k, isz, ranks) > build.SMEM_PER_BLOCK


@pytest.mark.parametrize("n,ranks,variant", [
    (384, 4, "resident"),      # dense n = 48, the main path's K3 case: 150,784 B
    (512, 8, "resident"),      # the 1 MiB persistent limit
    (640, 8, "resident"),      # 80 rows a rank: a partial warp
    (1024, 16, "streamed"),
    (2048, 16, "streamed"),    # dense n = 256, K4's route
    (128, 1, "resident"),
    (256, 2, "resident"),
])
def test_dense_sweep_layout_at_the_engine_shapes(n, ranks, variant):
    """K3's designed cluster size and variant at the shapes the smoke builds."""
    assert st.dense_sweep_ranks(n) == ranks
    assert st.dense_sweep_variant(n) == variant
    assert st.dense_sweep_fits(n, ranks) == (variant == "resident")


@pytest.mark.parametrize("n", [128 * i for i in (1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 64, 226)])
def test_dense_sweep_layout_properties(n):
    """As for K1: R a power of two up to 16 owning whole rows, the smallest
    resident R fits 232,448 bytes, streamed only at R = 16 where none fits."""
    ranks, variant = st.dense_sweep_ranks(n), st.dense_sweep_variant(n)
    assert ranks in (1, 2, 4, 8, 16) and n % (8 * ranks) == 0
    if variant == "resident":
        assert _dense_bytes(n, ranks) <= build.SMEM_PER_BLOCK
        assert ranks == 1 or _dense_bytes(n, ranks // 2) > build.SMEM_PER_BLOCK
    else:
        assert ranks == build.SWEEP_MAX_RANKS and _dense_bytes(n, ranks) > build.SMEM_PER_BLOCK


@pytest.mark.parametrize("first_fit,ranks", [(1, 1), (2, 2), (3, 4), (16, 16), (17, 16),
                                             (None, 16)])
def test_sweep_ranks_takes_the_smallest_fitting_power_of_two(first_fit, ranks):
    assert build.sweep_ranks(lambda r: first_fit is not None and r >= first_fit) == ranks


def test_routed_dense_shapes_take_the_resident_variant():
    """Every dense operator the route sends to K3 (up to 1 MiB) has its
    rows of M resident: the main path never takes the streamed variant."""
    for nz in range(128, 2049, 128):
        if ops.sweep_backend(nz, None) == "dense":
            assert st.dense_sweep_variant(nz) == "resident"


# ---------------------------------------------------------------------------
# the contracts the kernels are held to
# ---------------------------------------------------------------------------


def _ell_operator(seed, bsz, k, nz, dtype):
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, nz, (bsz, k, nz)), dtype=torch.int32)
    w = torch.as_tensor(rng.uniform(-1, 1, (bsz, k, nz)) * 0.4 / k, dtype=F32).to(dtype)
    z = torch.as_tensor(rng.uniform(-0.5, 0.5, (bsz, nz)), dtype=F32)
    c = torch.as_tensor(rng.uniform(-0.5, 0.5, (bsz, nz)), dtype=F32)
    return idx, w, z, c


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("bsz,k,nz", [(2, 7, 256), (3, 29, 640), (1, 33, 1024)])
def test_ell_sweep_equals_the_step_loop_bit_for_bit(dtype, bsz, k, nz):
    """n K1 steps are n K2 steps and the dt = 0 residual, bit for bit (the
    contract the card holds K1 to: both kernels run one row arithmetic)."""
    idx, w, z, c = _ell_operator(nz + k, bsz, k, nz, dtype)
    got_z, got_r = ell.ell_sweep(idx, w, z, c, n_steps=9, dt=0.5)
    zl = z
    for _ in range(9):
        zl, _ = ell.ell_step(idx, w, zl, c, 0.5)
    _, rl = ell.ell_step(idx, w, zl, c, 0.0)
    assert torch.equal(got_z, zl) and torch.equal(got_r[:, 0], rl.amax(dim=1))


@pytest.mark.parametrize("n", [128, 384])
def test_dense_sweep_equals_the_step_loop_within_the_bar(n):
    """K3 on M^T against the loop of K4 on M within the sweeps' bar of
    1e-5 max|z| (the plain versions sum in other orders)."""
    rng = np.random.default_rng(n)
    m = torch.as_tensor(rng.uniform(-1, 1, (2, n, n)) * 0.3 / n ** 0.5 - 0.5 * np.eye(n),
                        dtype=F32)
    z = torch.as_tensor(rng.uniform(-0.5, 0.5, (2, n)), dtype=F32)
    c = torch.as_tensor(rng.uniform(-0.5, 0.5, (2, n)), dtype=F32)
    got_z, got_r = st.transient_sweep(m.transpose(1, 2).contiguous(), z, c, n_steps=11)
    zl = z
    for _ in range(11):
        zl, _ = st.transient_step_batched(m, zl, c)
    _, rl = st.transient_step_batched(m, zl, c, 0.0)
    assert float((got_z - zl).abs().max()) <= 1e-5 * float(zl.abs().max())
    assert float((got_r[:, 0] - rl.amax(dim=1)).abs().max()) <= 1e-4 * float(rl.abs().max())


def test_sweeps_on_cpu_run_the_plain_versions_and_count_nothing():
    idx, w, z, c = _ell_operator(1, 2, 5, 256, F32)
    m = torch.as_tensor(np.random.default_rng(2).standard_normal((2, 256, 256)) * 0.02,
                        dtype=F32)
    before = (ops.launch_counts(), ops.launch_counts_by_variant())
    for got, want in zip(ell.ell_sweep(idx, w, z, c, n_steps=3),
                         ell.ell_sweep_plain(idx, w, z, c, n_steps=3)):
        assert torch.equal(got, want)
    for got, want in zip(st.transient_sweep(m, z, c, n_steps=3),
                         st.transient_sweep_plain(m, z, c, n_steps=3)):
        assert torch.equal(got, want)
    assert (ops.launch_counts(), ops.launch_counts_by_variant()) == before


def test_launch_counts_by_variant_keys_and_reset():
    """K1 and K3 count their launches by variant; the reset zeroes them."""
    counts = ops.launch_counts_by_variant()
    assert set(counts) == {"ell_sweep", "transient_sweep"}
    assert all(set(per) == set(build.SWEEP_VARIANTS) for per in counts.values())
    ell.ell_sweep.launches_by_variant["resident"] += 1
    ops.reset_launch_counts()
    assert all(v == 0 for per in ops.launch_counts_by_variant().values() for v in per.values())
