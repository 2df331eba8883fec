"""On a CUDA device: each Hopper kernel of repro_torch (K1-K4) against
its plain PyTorch version, and the main path through the kernels.

Imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import solve_batch  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.network import build_proposed_batch  # noqa: E402
from repro_torch.data.spd import random_rhs_from_solution, random_spd  # noqa: E402
from repro_torch.kernels import ell_transient as ell  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import transient_step as st  # noqa: E402

# f32 reassociation between the kernels' sequential sums and torch's
# reductions: 1e-5 of max|z| after 100 steps (as the CPU parity bar)
Z_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    return torch.device("cuda")


def _systems(seed, n, count):
    rng = np.random.default_rng(seed)
    a, x, b = [], [], []
    for _ in range(count):
        ak = random_spd(rng, n)
        xk, bk = random_rhs_from_solution(rng, ak)
        a.append(ak), x.append(xk), b.append(bk)
    return np.stack(a), np.stack(x), np.stack(b)


def _close(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    assert float((got - want).abs().max()) <= Z_TOL * float(want.abs().max())


@pytest.mark.cuda
def test_kernels_match_plain_versions(cuda):
    a, _x, b = _systems(19, 16, 3)
    nets = build_proposed_batch(a, b, device=cuda)
    ell_ss = engine.assemble_batch_ell(nets, device=cuda)
    dense = engine.assemble_batch(nets, device=cuda)
    dt = torch.as_tensor(engine._settle_dt(dense, 0.5, "diag"), device=cuda)
    c = ops.pad_rows((dense.c * dt[:, None]).float(), (1,))
    z0 = torch.rand(c.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    before = ops.launch_counts()
    for sweep_dtype in ("float32", "bfloat16"):
        idx_t, w_t = ops.ell_prepare(ell_ss.indices, ell_ss.weights * dt[:, None, None],
                                     sweep_dtype)
        _close(ell.ell_sweep(idx_t, w_t, z0, c, n_steps=100)[0],
               ell.ell_sweep_plain(idx_t, w_t, z0, c, n_steps=100)[0])
        _close(ell.ell_step(idx_t, w_t, z0, c)[0], ell.ell_step_plain(idx_t, w_t, z0, c)[0])
    m = ops.pad_rows((dense.m * dt[:, None, None]).float(), (1, 2)).contiguous()
    m_t = m.transpose(1, 2).contiguous()
    _close(st.transient_sweep(m_t, z0, c, n_steps=100)[0],
           st.transient_sweep_plain(m_t, z0, c, n_steps=100)[0])
    _close(st.transient_step_batched(m, z0, c)[0],
           st.transient_step_batched_plain(m, z0, c)[0])
    after = ops.launch_counts()
    assert after["ell_sweep"] - before["ell_sweep"] == 2
    assert after["ell_step"] - before["ell_step"] == 2
    assert after["transient_sweep"] - before["transient_sweep"] == 1
    assert after["transient_step_batched"] - before["transient_step_batched"] == 1


@pytest.mark.cuda
def test_main_path_on_the_card_matches_cpu(cuda):
    """solve_batch on the card and on the CPU: same settle steps (the
    kernels and the plain versions sum in other orders, so a crossing
    may move by one 50-step chunk), DC solutions within 1e-10."""
    a, x, b = _systems(23, 12, 3)
    for kw in (dict(settle_matrix_free=True, x_ref=x), {}):
        got = solve_batch(a, b, compute_settling=True, settle_method="euler",
                          device=cuda, **kw)
        want = solve_batch(a, b, compute_settling=True, settle_method="euler",
                           device="cpu", **kw)
        np.testing.assert_allclose(got.x, want.x, rtol=0.0, atol=1e-10)
        assert np.all(np.abs(got.info["settle_steps"] - want.info["settle_steps"]) <= 50)
        assert np.array_equal(got.stable, want.stable)
