"""Port parity: the kernel API of repro_torch — ``crosspoint_mvm`` (K6),
``transient_step`` (K5), ``transient_step_batched`` (K4),
``transient_sweep`` (K3 or K4) and ``spd_transform_arrays`` (K7a + K7b) —
against the reference's wrappers in Pallas interpret mode, at the shapes
and with the tolerances of the reference's own tests
(``tests/test_kernels.py``, ``tests/test_batched_engine.py``).

On the CPU each port wrapper runs its kernel's plain PyTorch version;
``tests/test_torch_cuda.py`` holds the Hopper kernels against those plain
versions on a CUDA device.  Inputs are drawn with numpy and rounded to
the working dtype once, so both packages see identical operands.
"""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.transform import transform_2n as jtransform_2n  # noqa: E402
from repro.data.spd import random_rhs_from_solution, random_spd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.spd_transform import colabs_pallas  # noqa: E402
from repro.kernels.transient_step import transient_step_batched_pallas  # noqa: E402

import repro_torch.kernels as tkernels  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spd_transform as tr  # noqa: E402

# repro_torch.kernels re-exports functions named like these submodules
mvm = importlib.import_module("repro_torch.kernels.crosspoint_mvm")
st = importlib.import_module("repro_torch.kernels.transient_step")

SHAPES_MVM = [
    (16, 16, 1), (100, 100, 1), (128, 128, 128), (257, 130, 5), (300, 513, 64),
]
STEP_SHAPES = [(64, 1), (200, 3), (256, 128), (130, 17)]
DTYPES = ["float32", "bfloat16"]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dt):
    # the reference's tolerances (tests/test_kernels.py:19-23): f32 sums in
    # another order over k <= 513; bf16 outputs may round one ulp apart
    return dict(rtol=2e-2, atol=2e-2) if dt == "bfloat16" else dict(rtol=5e-5, atol=5e-5)


def _pair(x: np.ndarray, dt: str):
    """The same operand for both packages: rounded to ``dt`` once by JAX,
    carried to torch exactly through float32."""
    xj = jnp.asarray(x, JNP[dt])
    return xj, torch.from_numpy(np.array(xj, np.float32)).to(TORCH[dt])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(autouse=True)
def _cpu_path_launches_nothing():
    """Every test here runs the plain versions: no kernel launch is counted."""
    ops.reset_launch_counts()
    yield
    assert not any(ops.launch_counts().values()), ops.launch_counts()


@pytest.mark.parametrize("m,k,b", SHAPES_MVM)
@pytest.mark.parametrize("dt", DTYPES)
def test_crosspoint_mvm_matches_reference(m, k, b, dt):
    rng = np.random.default_rng(m * 7 + k)
    gj, gt = _pair(rng.standard_normal((m, k)), dt)
    vj, vt = _pair(rng.standard_normal((k, b)), dt)
    got = ops.crosspoint_mvm(gt, vt)
    want = jops.crosspoint_mvm(gj, vj, interpret=True)
    assert got.shape == (m, b) and got.dtype == TORCH[dt]
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dt))


def test_crosspoint_mvm_vector_input():
    rng = np.random.default_rng(0)
    gj, gt = _pair(rng.standard_normal((50, 50)), "float32")
    vj, vt = _pair(rng.standard_normal(50), "float32")
    got = ops.crosspoint_mvm(gt, vt)
    assert got.shape == (50,)
    np.testing.assert_allclose(got.numpy(), np.asarray(gj) @ np.asarray(vj),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), _f32(jops.crosspoint_mvm(gj, vj, interpret=True)),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n,b", STEP_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_transient_step_matches_reference(n, b, dt):
    rng = np.random.default_rng(n + b)
    mj, mt = _pair(rng.standard_normal((n, n)) * 0.1, dt)
    zj, zt = _pair(rng.standard_normal((n, b)), dt)
    cj, ct = _pair(rng.standard_normal((n, b)), dt)
    got = ops.transient_step(mt, zt, ct, 1e-2)
    want = jops.transient_step(mj, zj, cj, 1e-2, interpret=True)
    assert got.shape == (n, b) and got.dtype == TORCH[dt]
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dt))


def test_transient_step_vector_input():
    """1-D state and constant (the reference's single-system call,
    tests/test_batched_engine.py:184) on an odd n."""
    rng = np.random.default_rng(5)
    n = 37
    mj, mt = _pair(rng.standard_normal((n, n)) * 0.1, "float32")
    zj, zt = _pair(rng.standard_normal(n), "float32")
    cj, ct = _pair(rng.standard_normal(n), "float32")
    got = ops.transient_step(mt, zt, ct, 1e-2)
    assert got.shape == (n,)
    want = jops.transient_step(mj, zj, cj, 1e-2, interpret=True)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=2e-5, atol=2e-5)


def test_transient_step_iterates_to_fixed_point():
    """Scanning the step converges to the linear solve, and the port's
    trajectory stays on the reference's (f32, 400 steps)."""
    rng = np.random.default_rng(3)
    n = 32
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = rng.uniform(0.5, 2.0, n)
    a = (q * lam) @ q.T
    x_true = rng.standard_normal(n)
    b = a @ x_true
    mj, mt = _pair(-a, "float32")
    cj, ct = _pair(b[:, None], "float32")
    zj = jnp.zeros((n, 1), jnp.float32)
    zt = torch.zeros((n, 1), dtype=torch.float32)
    dt = 0.5 / lam.max()
    for _ in range(400):
        zj = jops.transient_step(mj, zj, cj, dt, interpret=True)
        zt = ops.transient_step(mt, zt, ct, dt)
    np.testing.assert_allclose(zt[:, 0].numpy(), x_true, rtol=1e-3, atol=1e-3)
    # f32 reassociation drifts by ~1e-7 per step; 1e-5 of max|z| after 400
    np.testing.assert_allclose(zt.numpy(), _f32(zj), rtol=0.0,
                               atol=1e-5 * float(np.abs(_f32(zj)).max()))


@pytest.mark.parametrize("n", [16, 100, 128, 200])
def test_spd_transform_matches_reference(n):
    """K_A, K_B, D against the float64 transform within 1e-5 max|K_A| (the
    reference's bar), and against the reference's fused wrapper."""
    rng = np.random.default_rng(n)
    a = random_spd(rng, n)
    x, b = random_rhs_from_solution(rng, a)
    aj, at = _pair(a, "float32")
    bj, bt = _pair(b, "float32")
    ka, kb, d, ks = ops.spd_transform_arrays(at, bt)
    assert all(t.dtype == torch.float32 for t in (ka, kb, d, ks))
    assert ka.shape == kb.shape == (n, n) and d.shape == ks.shape == (n,)
    ref = jtransform_2n(a, b)
    scale = float(np.abs(np.asarray(ref.k_a)).max())
    for got, want in ((ka, ref.k_a), (kb, ref.k_b), (d, ref.d), (ks, ref.k_s)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=0.0, atol=1e-5 * scale)
    fused = jops.spd_transform_arrays(aj, bj, interpret=True)
    for got, want in zip((ka, kb, d, ks), fused):
        np.testing.assert_allclose(got.numpy(), _f32(want), rtol=0.0, atol=1e-6 * scale)


def test_spd_transform_bf16_matches_reference():
    """bf16 A: float32 arithmetic, K_A/K_B stored in bf16, D and K_s in
    float32 (the assembly reads them rounded to bf16, as the reference)."""
    rng = np.random.default_rng(4)
    n = 40
    a = random_spd(rng, n) * 1e4
    _x, b = random_rhs_from_solution(rng, a)
    aj, at = _pair(a, "bfloat16")
    bj, bt = _pair(b, "float32")
    got = ops.spd_transform_arrays(at, bt)
    want = jops.spd_transform_arrays(aj, bj, interpret=True)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                      torch.float32]
    scale = float(np.abs(_f32(want[0])).max())
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=0.0, atol=1e-2 * scale)


def test_spd_transform_solution_roundtrip():
    """Kernel-path K_A/K_B solve back to x (end-to-end fusion check)."""
    rng = np.random.default_rng(9)
    n = 60
    a = random_spd(rng, n) * 1e6   # scale to O(1) for f32 conditioning
    x, b = random_rhs_from_solution(rng, a)
    ka, kb, _d, ks = (t.double().numpy() for t in ops.spd_transform_arrays(
        torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(b, dtype=torch.float32)))
    m = np.block([[ka + np.diag(ks), kb], [kb, ka + np.diag(ks)]])
    y = np.linalg.solve(m, np.concatenate([b, -b]))
    np.testing.assert_allclose(y[:n], x, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("dt", DTYPES)
def test_plain_versions_match_reference_oracles(dt):
    """Each kernel's plain version against its oracle in repro/kernels/ref.py,
    at the ragged shapes the card run also uses."""
    rng = np.random.default_rng(12)
    tol = _tol(dt)
    gj, gt = _pair(rng.standard_normal((300, 513)), dt)
    vj, vt = _pair(rng.standard_normal((513, 5)), dt)
    np.testing.assert_allclose(_f32(mvm.crosspoint_mvm_plain(gt, vt)),
                               _f32(jref.crosspoint_mvm_ref(gj, vj)), **tol)
    mj, mt = _pair(rng.standard_normal((137, 137)) * 0.1, dt)
    zj, zt = _pair(rng.standard_normal((137, 17)), dt)
    cj, ct = _pair(rng.standard_normal((137, 17)), dt)
    np.testing.assert_allclose(_f32(st.transient_step_plain(mt, zt, ct, 1e-2)),
                               _f32(jref.transient_step_ref(mj, zj, cj, 1e-2)), **tol)
    aj, at = _pair(rng.standard_normal((70, 70)), dt)
    np.testing.assert_allclose(tr.colabs_plain(at).numpy(),
                               _f32(jref.colabs_ref(aj))[0], rtol=1e-5, atol=1e-5)
    dj, dtt = _pair(rng.uniform(1.0, 2.0, 70), "float32")
    kj, kt = _pair(rng.uniform(0.0, 0.5, 70), "float32")
    for g, w in zip(tr.assemble_plain(at, dtt, kt), jref.assemble_ref(aj, dj, kj)):
        assert g.dtype == TORCH[dt]
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("shape", [(1000, 130), (4000, 40), (300, 77), (3, 17)])
@pytest.mark.parametrize("dt", DTYPES)
def test_colabs_kernel_order_matches_reference(shape, dt):
    """K7a's summation order (rows split over cluster ranks and warps,
    partials added in warp and rank order) against colabs_pallas in
    interpret mode, within K7a's bar of 1e-5 max|want|.  A is zero-padded
    to the Pallas block, which leaves abs-sums exact."""
    rows, cols = shape
    rng = np.random.default_rng(rows + cols)
    aj, at = _pair(rng.standard_normal(shape), dt)
    padded = jnp.pad(aj, ((0, (-rows) % 128), (0, (-cols) % 128)))
    want = _f32(colabs_pallas(padded, interpret=True))[0, :cols]
    got = tr.colabs_in_kernel_order(at).numpy()
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


@pytest.mark.parametrize("m,k,b", [(300, 513, 5), (257, 1048, 24), (128, 2048, 64)])
def test_mvm_split_order_matches_reference(m, k, b):
    """K6 float32's split-k order (each cluster rank's k range, partials
    added in rank order) against crosspoint_mvm_pallas in interpret mode,
    within TOL_MVM_F32 = 5e-5 max|want|."""
    rng = np.random.default_rng(m + k + b)
    gj, gt = _pair(rng.standard_normal((m, k)), "float32")
    vj, vt = _pair(rng.standard_normal((k, b)), "float32")
    assert mvm.crosspoint_mvm_split(m, k, b) > 1
    want = _f32(jops.crosspoint_mvm(gj, vj, interpret=True))
    got = mvm.crosspoint_mvm_in_split_order(gt, vt).numpy()
    assert float(np.abs(got - want).max()) <= 5e-5 * float(np.abs(want).max())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Wrong dtype, mixed dtypes, shape mismatches and devices other than
    CPU and CUDA raise; nothing falls back."""
    f32 = torch.ones((4, 4))
    with pytest.raises(TypeError):
        ops.crosspoint_mvm(f32.double(), f32.double())
    with pytest.raises(ValueError):
        ops.crosspoint_mvm(f32, f32.bfloat16())
    with pytest.raises(ValueError):
        ops.crosspoint_mvm(f32, torch.ones((5, 2)))
    with pytest.raises(ValueError):
        ops.transient_step(torch.ones((4, 5)), torch.ones((4, 1)), torch.ones((4, 1)), 0.1)
    with pytest.raises(ValueError):
        ops.transient_step(f32, torch.ones((4, 2)), torch.ones((4, 1)), 0.1)
    with pytest.raises(ValueError):
        ops.crosspoint_mvm(f32.to("meta"), f32.to("meta"))
    with pytest.raises(ValueError):
        ops.crosspoint_mvm(f32.to_sparse(), f32)
    with pytest.raises(ValueError):
        ops.spd_transform_arrays(torch.ones((4, 5)), torch.ones(4))
    with pytest.raises(TypeError):
        tr.assemble(f32, torch.ones(4, dtype=torch.float64), torch.ones(4))


def _ops_imports(package: str) -> list[str]:
    """The names ``package/__init__.py`` imports from its ops module, in order."""
    root = Path(__file__).resolve().parents[1] / "src" / package / "kernels" / "__init__.py"
    for node in ast.parse(root.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module.endswith("kernels.ops"):
            return [alias.name for alias in node.names]
    raise AssertionError(f"no ops import in {root}")


def test_package_reexports_the_kernel_api():
    """repro_torch.kernels exports the reference's kernel API names, in the
    reference's order."""
    assert tkernels.crosspoint_mvm is ops.crosspoint_mvm
    assert tkernels.transient_step is ops.transient_step
    assert tkernels.transient_step_batched is ops.transient_step_batched
    assert tkernels.transient_sweep is ops.transient_sweep
    assert tkernels.spd_transform_arrays is ops.spd_transform_arrays
    assert _ops_imports("repro_torch") == _ops_imports("repro")
    assert set(ops.launch_counts()) >= {"transient_step", "crosspoint_mvm", "colabs",
                                        "assemble", "transient_step_batched"}


@pytest.mark.parametrize("n", [100, 128, 300])
def test_transient_step_batched_matches_reference(n):
    """The public padded dense step (any n) against the reference's, with
    its tolerances (tests/test_batched_engine.py:164): the state sliced
    back to n and the per-system residual at the input state."""
    rng = np.random.default_rng(n)
    m = rng.standard_normal((3, n, n)) * 0.05
    z = rng.standard_normal((3, n))
    c = rng.standard_normal((3, n))
    (mj, mt), (zj, zt), (cj, ct) = (_pair(x, "float32") for x in (m, z, c))
    got, res = ops.transient_step_batched(mt, zt, ct, 1e-2)
    want, want_res = jops.transient_step_batched(mj, zj, cj, 1e-2, interpret=True)
    assert got.shape == (3, n) and res.shape == (3,)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(res.numpy(), _f32(want_res), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("nz,route", [(384, "dense"), (640, "dense-step")])
def test_transient_sweep_transposed_operand_matches_reference(nz, route):
    """m_transposed=True means m[b] = M_b^T, padded, on both sides of the
    persistent route's 1 MiB limit (nz = 384: 576 KiB, K3; nz = 640:
    1.6 MiB, K4), as the reference reads it; M is not symmetric, so a
    route that took the operand as M would compute M^T z."""
    rng = np.random.default_rng(nz)
    bsz = 2
    m = rng.uniform(-1, 1, (bsz, nz, nz)) * 0.3 / np.sqrt(nz) - 0.5 * np.eye(nz)
    assert np.abs(m - m.transpose(0, 2, 1)).max() > 0.01
    z = rng.uniform(-0.5, 0.5, (bsz, nz))
    c = rng.uniform(-0.5, 0.5, (bsz, nz))
    (mj, _), (zj, zt), (cj, ct) = (_pair(x, "float32") for x in (m, z, c))
    m_t = np.ascontiguousarray(_f32(mj).transpose(0, 2, 1))
    assert ops.sweep_backend(nz, None) == route
    got_z, got_r = ops.transient_sweep(torch.from_numpy(m_t), zt, ct, n_steps=12,
                                       m_transposed=True)
    want_z, want_r = jops.transient_sweep(jnp.asarray(m_t), zj, cj, n_steps=12,
                                          interpret=True, m_transposed=True)
    np.testing.assert_allclose(got_z.numpy(), _f32(want_z), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_r.numpy(), _f32(want_r), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bsz,n", [(4, 512), (1, 1024), (2, 640)])
def test_dense_step_kernel_order_matches_reference(bsz, n):
    """K4's split order (each cluster rank's columns, partials added in
    rank order) against transient_step_batched_pallas in interpret mode,
    within 1e-5 max|z'| (the sweeps' bar) and 1e-4 of the residual."""
    rng = np.random.default_rng(bsz * n)
    m = rng.uniform(-1, 1, (bsz, n, n)) / np.sqrt(n)
    z = rng.uniform(-0.5, 0.5, (bsz, n))
    c = rng.uniform(-0.5, 0.5, (bsz, n))
    (mj, mt), (zj, zt), (cj, ct) = (_pair(x, "float32") for x in (m, z, c))
    assert st.dense_step_ranks(bsz, n) > 1
    want, want_res = transient_step_batched_pallas(mj, zj, cj, 1.0, interpret=True)
    got, res = st.dense_step_in_kernel_order(mt, zt, ct, 1.0)
    want = _f32(want)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())
    want_res = _f32(want_res)
    assert float(np.abs(res.numpy() - want_res).max()) <= 1e-4 * float(np.abs(want_res).max())


@pytest.mark.parametrize("n,b", [(1000, 16), (2048, 5), (700, 2)])
def test_transient_step_kernel_order_matches_reference(n, b):
    """K5's narrow split order (warps' k slices, then cluster ranks) against
    transient_step in interpret mode, within TOL_MVM_F32 = 5e-5 max|want|."""
    rng = np.random.default_rng(n + b)
    mj, mt = _pair(rng.uniform(-1, 1, (n, n)) / np.sqrt(n), "float32")
    zj, zt = _pair(rng.uniform(-0.5, 0.5, (n, b)), "float32")
    cj, ct = _pair(rng.uniform(-0.5, 0.5, (n, b)), "float32")
    assert st.transient_step_split(n) > 1
    want = _f32(jops.transient_step(mj, zj, cj, 0.5, interpret=True))
    got = st.transient_step_in_kernel_order(mt, zt, ct, 0.5).numpy()
    assert float(np.abs(got - want).max()) <= 5e-5 * float(np.abs(want).max())
