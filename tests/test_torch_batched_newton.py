"""Port parity: repro_torch.optim.batched_newton against the JAX
reference on the CPU (tests/test_batched_newton.py).

Bars: the port's batched and looped runs agree as the reference's do
(equal iteration counts, iterates within 1e-12); the port against the
reference: equal iteration counts, rounds and pattern derivations,
iterates within 1e-10 (float64 host arithmetic on both sides; the solves
agree to the 1e-10 solution bar of the parity contract).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro.optim import batched_newton as jbn  # noqa: E402

from repro_torch.optim import batched_newton as tbn  # noqa: E402

CPU = "cpu"
ITERATE_ATOL = 1e-12
REFERENCE_ATOL = 1e-10


def _quartic_problem(bsz, n, seed=0):
    """B strictly convex quartics with O(1) SPD Hessians."""
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(bsz, n))
    m = rng.normal(size=(bsz, n, n)) / np.sqrt(n)
    q = 0.5 * np.einsum("bij,bkj->bik", m, m) + np.eye(n)
    eye = np.eye(n)

    def grad_hess(x):
        d = x - t
        return np.einsum("bij,bj->bi", q, d) + d ** 3, q + (3.0 * d ** 2)[:, :, None] * eye

    return grad_hess, t, q


def _same_trace(got, want, atol):
    assert np.array_equal(got.converged, want.converged)
    assert np.array_equal(got.iterations, want.iterations)
    assert np.abs(got.x - want.x).max() <= atol
    assert got.solve_rounds == want.solve_rounds
    assert got.pattern_derivations == want.pattern_derivations


@pytest.mark.parametrize("method", ["cholesky", "analog_2n", "analog_n"])
def test_batched_newton_matches_looped_and_reference(method):
    grad_hess, _, _ = _quartic_problem(bsz=3, n=6, seed=1)
    x0 = np.zeros((3, 6))
    kw = dict(method=method, tol=1e-9, max_iter=30)
    tr_b = tbn.newton_batch(grad_hess, x0, tbn.BatchedNewtonConfig(**kw), device=CPU)
    tr_l = tbn.newton_looped(grad_hess, x0, tbn.BatchedNewtonConfig(**kw), device=CPU)
    assert tr_b.converged.all() and tr_l.converged.all()
    assert np.array_equal(tr_b.iterations, tr_l.iterations)
    assert np.abs(tr_b.x - tr_l.x).max() <= ITERATE_ATOL
    assert tr_b.iterations.max() >= 3
    want = jbn.newton_batch(grad_hess, x0, jbn.BatchedNewtonConfig(**kw))
    _same_trace(tr_b, want, REFERENCE_ATOL)


def test_batched_newton_one_round_per_iteration_one_pattern():
    grad_hess, t, _q = _quartic_problem(bsz=2, n=5, seed=2)
    cfg = tbn.BatchedNewtonConfig(method="analog_2n", tol=1e-9, max_iter=30)
    tr = tbn.newton_batch(grad_hess, np.zeros((2, 5)), cfg, device=CPU)
    assert tr.converged.all()
    assert tr.solve_rounds == tr.iterations.max()
    assert tr.pattern_derivations == 1
    assert np.abs(tr.x - t).max() <= 1e-6


def _kkt_problem(bsz, n, m, seed):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(bsz, n))
    mm = rng.normal(size=(bsz, n, n)) / np.sqrt(n)
    q = 0.5 * np.einsum("bij,bkj->bik", mm, mm) + np.eye(n)
    c = rng.normal(size=(bsz, m, n))
    d = rng.normal(size=(bsz, m))

    def grad_hess(x):
        return np.einsum("bij,bj->bi", q, x - t), np.broadcast_to(q, (bsz, n, n))

    return grad_hess, t, q, c, d


def test_kkt_batched_matches_dense_kkt_solve():
    bsz, n, m = 3, 6, 2
    grad_hess, t, q, c, d = _kkt_problem(bsz, n, m, 3)
    kw = dict(method="cholesky", tol=1e-10, damping=0.0)
    tr = tbn.newton_kkt_batch(grad_hess, (c, d), np.zeros((bsz, n)),
                              tbn.BatchedNewtonConfig(**kw), device=CPU)
    assert tr.converged.all()
    for k in range(bsz):
        kkt = np.block([[q[k], c[k].T], [c[k], np.zeros((m, m))]])
        x_ref = np.linalg.solve(kkt, np.concatenate([q[k] @ t[k], d[k]]))[:n]
        assert np.abs(tr.x[k] - x_ref).max() <= 1e-8
        assert np.abs(c[k] @ tr.x[k] - d[k]).max() <= 1e-8
    want = jbn.newton_kkt_batch(grad_hess, (c, d), np.zeros((bsz, n)),
                                jbn.BatchedNewtonConfig(**kw))
    _same_trace(tr, want, REFERENCE_ATOL)


def test_kkt_batched_matches_looped_on_circuit():
    bsz, n, m = 2, 5, 2
    grad_hess, _t, _q, c, d = _kkt_problem(bsz, n, m, 4)
    kw = dict(method="analog_2n", tol=1e-8, max_iter=20)
    tr_b = tbn.newton_kkt_batch(grad_hess, (c, d), np.zeros((bsz, n)),
                                tbn.BatchedNewtonConfig(**kw), device=CPU)
    tr_l = tbn.newton_kkt_looped(grad_hess, (c, d), np.zeros((bsz, n)),
                                 tbn.BatchedNewtonConfig(**kw), device=CPU)
    assert tr_b.converged.all()
    assert np.array_equal(tr_b.iterations, tr_l.iterations)
    assert np.abs(tr_b.x - tr_l.x).max() <= ITERATE_ATOL
    assert tr_b.solve_rounds == 2 * tr_b.iterations.max()
    assert tr_b.pattern_derivations == 2
    want = jbn.newton_kkt_batch(grad_hess, (c, d), np.zeros((bsz, n)),
                                jbn.BatchedNewtonConfig(**kw))
    _same_trace(tr_b, want, REFERENCE_ATOL)


def test_newton_runs_on_the_card_unless_asked(monkeypatch):
    grad_hess, _, _ = _quartic_problem(bsz=1, n=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tbn.newton_batch, tbn.newton_looped):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(grad_hess, np.zeros((1, 3)))
