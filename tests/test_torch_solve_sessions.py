"""Port parity: repro_torch's SolveSession, the settle submit/wait split
in the service, Newton clients through a session and a FEM mesh stream,
against the JAX reference on the CPU (tests/test_solve_sessions.py).

Bars: delivered ``x`` within 1e-9 (``PARITY_ATOL``) of the reference's
and of a direct solve; Newton iteration counts equal and iterates within
1e-7 of the direct executor (the reference test's bar); service counters
equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

from repro.data.fem import mesh_stream as j_mesh_stream  # noqa: E402
from repro.data.spd import random_rhs_from_solution, random_spd  # noqa: E402
from repro.optim.batched_newton import BatchedNewtonConfig as JConfig  # noqa: E402
from repro.optim.batched_newton import newton_batch as j_newton_batch  # noqa: E402
from repro.serving import SolveService as JSolveService  # noqa: E402

from repro_torch.core.solver import solve, solve_batch, solve_batch_submit  # noqa: E402
from repro_torch.data.fem import mesh_stream  # noqa: E402
from repro_torch.optim.batched_newton import BatchedNewtonConfig, newton_batch  # noqa: E402
from repro_torch.serving import SessionRoundError, SolveService  # noqa: E402
from repro_torch.serving.faults import FaultInjector, FaultPlan, SolveError  # noqa: E402

PARITY_ATOL = 1e-9
CPU = "cpu"


def _systems(bsz, n, seed=0):
    rng = np.random.default_rng(seed)
    a = np.stack([random_spd(rng, n) for _ in range(bsz)])
    xb = [random_rhs_from_solution(rng, a[k]) for k in range(bsz)]
    return a, np.stack([x for x, _ in xb]), np.stack([b for _, b in xb])


def _service(**kw):
    return SolveService(devices=[CPU], **kw)


def _ref_service(**kw):
    import jax

    return JSolveService(devices=[jax.devices()[0]], **kw)


# --------------------------------------------------- two-phase handles
def test_analog_pending_is_split_and_composes_to_solve_batch():
    a, _, b = _systems(3, 5)
    ref = solve_batch(a, b, method="analog_2n", compute_settling=True, device=CPU)
    pending = solve_batch_submit(a, b, method="analog_2n", compute_settling=True,
                                 device=CPU)
    assert pending.split
    dc = pending.wait_dc()
    assert dc.x.shape == b.shape
    assert dc.settle_time is None and "settle_method" not in dc.info
    full = pending.wait()
    assert np.array_equal(full.x, ref.x)
    assert full.settle_time is not None and "settle_method" in full.info
    assert full is dc
    assert pending.wait() is full and pending.wait_dc() is full


def test_digital_pending_is_single_phase():
    a, _, b = _systems(2, 4, seed=1)
    pending = solve_batch_submit(a, b, method="cholesky", device=CPU)
    assert not pending.split
    assert pending.wait_dc() is pending.wait()


def test_injected_nonfinite_lands_after_the_finish_phase():
    a, _, b = _systems(2, 4, seed=3)
    pending = solve_batch_submit(a, b, method="analog_2n", device=CPU)
    inj = FaultInjector(FaultPlan(schedule=((0, "nonfinite"),)))
    inj.arm(pending, inj.draw())
    assert np.isfinite(pending.wait_dc().x).all()
    assert np.isnan(pending.wait().x[:, 0]).all()


# ------------------------------------------------- settle split in the service
def test_service_settle_split_accounts_and_keeps_parity():
    """Half the stream settles: those micro-batches finish after their
    DC harvest; delivery matches the reference service's."""
    a, _, b = _systems(6, 5, seed=4)
    svcs = (_ref_service(batch_slots=2), _service(batch_slots=2))
    outs = []
    for svc in svcs:
        rids = [svc.submit(a[k], b[k], method="analog_2n", compute_settling=(k % 2 == 0))
                for k in range(6)]
        outs.append((rids, svc.drain()))
    (jrids, jout), (rids, out) = outs
    assert rids == jrids
    for k, rid in enumerate(rids):
        ref = solve(a[k], b[k], method="analog_2n", device=CPU)
        assert np.abs(out[rid].x - ref.x).max() <= PARITY_ATOL
        assert np.abs(out[rid].x - np.asarray(jout[rid].x)).max() <= PARITY_ATOL
        if k % 2 == 0:
            np.testing.assert_allclose(out[rid].settle_time, jout[rid].settle_time,
                                       rtol=1e-6)
    st, jst = svcs[1].stats, svcs[0].stats
    assert st["settle_finish_s"] > 0.0
    assert st["errors"] == {k: 0 for k in st["errors"]}
    assert st["buckets"] == jst["buckets"]


# ----------------------------------------------------------- session rounds
def test_session_round_validates_shapes():
    sess = _service(batch_slots=2).session(method="cholesky")
    with pytest.raises(ValueError, match="expected"):
        sess.solve_round(np.eye(4), np.ones(4))
    with pytest.raises(ValueError, match="expected"):
        sess.solve_round(np.ones((2, 4, 4)), np.ones((3, 4)))


def test_session_round_parity_and_counters():
    a, _, b = _systems(4, 5, seed=5)
    sess = _service(batch_slots=4).session(method="analog_2n")
    jsess = _ref_service(batch_slots=4).session(method="analog_2n")
    x = sess.solve_round(a, b)
    jx = jsess.solve_round(a, b)
    assert np.abs(x - jx).max() <= PARITY_ATOL
    for k in range(4):
        assert np.abs(x[k] - solve(a[k], b[k], method="analog_2n", device=CPU).x).max() \
            <= PARITY_ATOL
    assert sess.rounds == sess.solve_rounds == 1 and sess.systems == 4
    assert sess.pattern_derivations == jsess.pattern_derivations == 1


def _quartic(seed, bsz, n):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(bsz, n))
    m = rng.normal(size=(bsz, n, n)) / np.sqrt(n)
    q = 0.5 * np.einsum("bij,bkj->bik", m, m) + np.eye(n)
    eye = np.eye(n)

    def grad_hess(x):
        d = x - t
        return (np.einsum("bij,bj->bi", q, d) + d ** 3,
                q + (3.0 * d ** 2)[:, :, None] * eye)

    return grad_hess


def test_session_newton_matches_direct_batched_run():
    """A Newton client whose rounds ride the port's service converges as
    the direct executor does, on one pattern, and as the reference's
    session run does."""
    bsz, n = 3, 5
    grad_hess = _quartic(6, bsz, n)
    cfg = BatchedNewtonConfig(method="analog_2n", tol=1e-9, max_iter=30)
    tr_direct = newton_batch(grad_hess, np.zeros((bsz, n)), cfg, device=CPU)
    sess = _service(batch_slots=4).session(method="analog_2n")
    tr_svc = newton_batch(grad_hess, np.zeros((bsz, n)), cfg, rounds=sess)
    assert tr_svc.converged.all()
    assert np.array_equal(tr_svc.iterations, tr_direct.iterations)
    assert np.abs(tr_svc.x - tr_direct.x).max() <= 1e-7
    assert tr_svc.iterations.max() >= 3
    assert tr_svc.solve_rounds == tr_svc.iterations.max()
    assert sess.pattern_derivations == 1

    jtr = j_newton_batch(grad_hess, np.zeros((bsz, n)),
                         JConfig(method="analog_2n", tol=1e-9, max_iter=30),
                         rounds=_ref_service(batch_slots=4).session(method="analog_2n"))
    assert np.array_equal(tr_svc.iterations, jtr.iterations)
    assert np.abs(tr_svc.x - jtr.x).max() <= 1e-7


def test_session_preserves_interleaved_foreign_traffic():
    svc = _service(batch_slots=4)
    a1, _, b1 = _systems(1, 5, seed=7)
    foreign = svc.submit(a1[0], b1[0], method="cholesky")
    sess = svc.session(method="cholesky")
    a, _, b = _systems(3, 5, seed=8)
    x = sess.solve_round(a, b)
    assert np.isfinite(x).all()
    assert foreign in sess.other_results
    ref = np.linalg.solve(a1[0], b1[0])
    assert np.abs(sess.other_results[foreign].x - ref).max() <= PARITY_ATOL


def test_session_round_error_carries_partial_solutions():
    a, _, b = _systems(3, 5, seed=9)
    a[1, 0, 0] = np.nan
    errs = []
    for svc in (_ref_service(batch_slots=4), _service(batch_slots=4)):
        sess = svc.session(method="analog_2n")
        with pytest.raises(Exception) as ei:
            sess.solve_round(a, b)
        errs.append((sess, ei.value))
    (_jsess, jerr), (sess, err) = errs
    assert isinstance(err, SessionRoundError)
    assert err.round_index == 0 and set(err.errors) == set(jerr.errors) == {1}
    assert isinstance(err.errors[1], SolveError)
    assert err.errors[1].kind == jerr.errors[1].kind
    assert np.isnan(err.x[1]).all()
    for k in (0, 2):
        ref = solve(a[k], b[k], method="analog_2n", device=CPU)
        assert np.abs(err.x[k] - ref.x).max() <= PARITY_ATOL
    assert sess.rounds == 1


def test_session_newton_recovers_injected_midloop_device_fault():
    rng = np.random.default_rng(10)
    bsz, n = 2, 5
    t = rng.normal(size=(bsz, n))
    eye = np.eye(n)

    def grad_hess(x):
        d = x - t
        return d + d ** 3, (1.0 + 3.0 * d ** 2)[:, :, None] * eye

    cfg = BatchedNewtonConfig(method="analog_2n", tol=1e-9, max_iter=30)
    tr_clean = newton_batch(grad_hess, np.zeros((bsz, n)), cfg,
                            rounds=_service(batch_slots=4).session(method="analog_2n"))
    inj = FaultInjector(FaultPlan(schedule=((1, "device_fault"),)))
    svc = _service(batch_slots=4, fault_injector=inj)
    tr = newton_batch(grad_hess, np.zeros((bsz, n)), cfg,
                      rounds=svc.session(method="analog_2n"))
    st = svc.stats
    assert st["fault_injections"] >= 1
    assert st["retries"] + st["bisections"] >= 1
    assert st["errors"] == {k: 0 for k in st["errors"]}
    assert tr.converged.all()
    assert np.array_equal(tr.iterations, tr_clean.iterations)
    assert np.abs(tr.x - tr_clean.x).max() <= 1e-12


def test_session_warm_start_seeds_next_round():
    """warm_start hands round k's solutions to round k+1's settle sweep
    (x0 per ticket) in both packages, with the same settle steps."""
    a, _, b = _systems(2, 5, seed=12)
    steps = []
    for svc in (_ref_service(batch_slots=2), _service(batch_slots=2)):
        sess = svc.session(method="analog_2n", compute_settling=True, settle_method="euler",
                           warm_start=True)
        x1 = sess.solve_round(a, b)
        sess.solve_round(a, b * 1.01)
        assert sess.warm_submits == 2 and sess.rounds == 2
        steps.append((np.asarray(x1), sess.settle_steps_by_round))
    (jx1, jsteps), (x1, tsteps) = steps
    assert np.abs(x1 - jx1).max() <= PARITY_ATOL
    assert tsteps == jsteps
    assert tsteps[1] < tsteps[0]


# --------------------------------------------------------- FEM mesh stream
def test_fem_stream_through_service_parity():
    meshes = list(mesh_stream(0, 10, grids=((4, 4), (5, 5), (6, 6))))
    jmeshes = list(j_mesh_stream(0, 10, grids=((4, 4), (5, 5), (6, 6))))
    outs = []
    for svc, ms in ((_ref_service(batch_slots=4), jmeshes), (_service(batch_slots=4), meshes)):
        rids = [svc.submit(m.a, m.b, method="analog_2n") for m in ms]
        outs.append((svc, rids, svc.drain()))
    (jsvc, jrids, jout), (svc, rids, out) = outs
    for rid, m in zip(rids, meshes):
        ref = solve(m.a, m.b, method="analog_2n", device=CPU)
        assert np.abs(out[rid].x - ref.x).max() <= PARITY_ATOL
        assert np.abs(out[rid].x - np.asarray(jout[rid].x)).max() <= PARITY_ATOL
    st = svc.stats
    assert st["requests"] == len(meshes)
    assert all(b["pattern_derivations"] == 1 for b in st["buckets"].values())
    assert st["buckets"] == jsvc.stats["buckets"]


def test_fem_poisson_torch_example_matches_reference_example(capsys):
    """examples/fem_poisson_torch.py on the CPU: the reference example's
    flow, its solutions within 1e-9 and its settling probe within 1e-6."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "fem_poisson_torch.py"
    spec = importlib.util.spec_from_file_location("fem_poisson_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--smoke", "--device", CPU])
    text = capsys.readouterr().out
    assert "ERROR" not in text and "zero op-amps at every size" in text
    assert out["worst"] <= 1e-6
    assert all(b["pattern_derivations"] == 1 for b in out["stats"]["buckets"].values())

    from repro.core import engine as jengine
    from repro.core.network import build_proposed as j_build_proposed
    from repro.core.solver import solve as jsolve

    meshes = list(j_mesh_stream(0, 9, grids=((4, 4), (5, 5), (6, 6))))
    for rid, m in zip(out["rids"], meshes):
        want = jsolve(m.a, m.b, method="analog_2n").x
        assert np.abs(out["results"][rid].x - np.asarray(want)).max() <= PARITY_ATOL
    for (nx, ny), got in out["settle"].items():
        m = next(mi for mi in meshes if (mi.nx, mi.ny) == (nx, ny))
        want = jengine.transient_batch([j_build_proposed(m.a, m.b)], method="eig")
        np.testing.assert_allclose(got, float(want.settle_time[0]), rtol=1e-6)
