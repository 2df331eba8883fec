"""Port parity: repro_torch.serving.SolveService against the JAX
reference's service on the CPU (tests/test_solve_service.py and the
service chaos of tests/test_faults.py).

Both services get the same submissions.  Bars:

* every delivered ``x`` within 1e-9 (``PARITY_ATOL``, the benchmark's)
  of the reference service's and of a direct ``repro_torch.solve``;
* ``stats`` counters equal: buckets with their ``n_pad``,
  ``micro_batches``, ``fill_slots``, ``pattern_derivations``,
  ``retries``, ``bisections``, ``shed``, ``deadline_expired``,
  ``quarantines``, ``errors`` by kind, ``precision_paths``;
* the same ``SolveError`` kinds for the same seeded ``FaultPlan``.

The port's streams here are ``devices=["cpu"] * k``, in place of the
reference's forced host devices.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import repro.serving.solve_service as jss  # noqa: E402
from repro.core.operating_point import DEFAULT_NONIDEAL as J_DEFAULT_NONIDEAL  # noqa: E402
from repro.core.specs import OPAMPS as J_OPAMPS  # noqa: E402
from repro.data.spd import random_rhs_from_solution, random_sdd, random_spd  # noqa: E402
from repro.serving.faults import FaultInjector as JFaultInjector  # noqa: E402
from repro.serving.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.serving.faults import SolveError as JSolveError  # noqa: E402

import repro_torch.core.solver as tsolver_mod  # noqa: E402
import repro_torch.serving.solve_service as tss  # noqa: E402
from repro_torch.core.operating_point import DEFAULT_NONIDEAL as T_DEFAULT_NONIDEAL  # noqa: E402
from repro_torch.core.specs import OPAMPS as T_OPAMPS  # noqa: E402
from repro_torch.serving.faults import FaultInjector as TFaultInjector  # noqa: E402
from repro_torch.serving.faults import FaultPlan as TFaultPlan  # noqa: E402
from repro_torch.serving.faults import SolveError as TSolveError  # noqa: E402

PARITY_ATOL = 1e-9
CPU = "cpu"
COUNTERS = ("requests", "fill_slots", "retries", "bisections", "shed",
            "deadline_expired", "fallbacks", "fallbacks_injected", "quarantines",
            "requeued_on_quarantine", "errors", "precision_paths", "refine_iters_total",
            "fault_injections", "batch_slots", "inflight_per_device")


def _sys(rng, n, kind="spd"):
    a = random_sdd(rng, n) if kind == "sdd" else random_spd(rng, n)
    x, b = random_rhs_from_solution(rng, a)
    return a, x, b


def _services(n_streams=1, plan=None, **kw):
    """One reference service and one port service with the same options
    (the port's streams on the CPU); ``plan`` (a dict of FaultPlan fields)
    arms each with its package's seeded injector."""
    import jax

    jinj = None if plan is None else JFaultInjector(JFaultPlan(**plan))
    tinj = None if plan is None else TFaultInjector(TFaultPlan(**plan))
    return (jss.SolveService(devices=[jax.devices()[0]] * n_streams, fault_injector=jinj, **kw),
            tss.SolveService(devices=[CPU] * n_streams, fault_injector=tinj, **kw))


def _both(submissions, n_streams=1, plan=None, **kw):
    """Submit the same requests to both services and drain both.
    ``submissions`` is a list of ``(a, b, submit options)``."""
    jsvc, tsvc = _services(n_streams, plan, **kw)
    jrids = [jsvc.submit(a, b, **opts) for a, b, opts in submissions]
    trids = [tsvc.submit(a, b, **opts) for a, b, opts in submissions]
    assert jrids == trids
    return jsvc, tsvc, jsvc.drain(), tsvc.drain(), trids


def _same_stats(jsvc, tsvc):
    js, ts = jsvc.stats, tsvc.stats
    for key in COUNTERS:
        assert ts[key] == js[key], (key, ts[key], js[key])
    assert ts["buckets"] == js["buckets"]
    assert ts["pad_overhead"] == pytest.approx(js["pad_overhead"], rel=1e-12)
    assert ts["breaker"] == js["breaker"]
    assert ts["devices"] == js["devices"]


def _same_results(jres, tres, rids):
    """Exactly-once on both sides, the same error kinds, x within 1e-9."""
    assert set(jres) == set(tres) == set(rids)
    for rid in rids:
        j, t = jres[rid], tres[rid]
        assert isinstance(j, JSolveError) == isinstance(t, TSolveError), rid
        if isinstance(t, TSolveError):
            assert (t.kind, t.attempts) == (j.kind, j.attempts), rid
            continue
        np.testing.assert_allclose(t.x, np.asarray(j.x), rtol=0.0, atol=PARITY_ATOL)
        assert t.stable == j.stable and t.method == j.method
        assert t.info["service_n_padded"] == j.info["service_n_padded"]


def _direct(a, b, method, **kw):
    return tsolver_mod.solve(a, b, method=method, device=CPU, **kw)


# ------------------------------------------------------------ pad parity
def test_pad_system_and_pad_grid_match_reference():
    """pad_system bit for bit for both pad right-hand sides, the grid's
    constants and pad_to over every size up to 300."""
    assert tss.PAD_SOLUTION_V == jss.PAD_SOLUTION_V
    assert tss.DEFAULT_PAD_SIZES == jss.DEFAULT_PAD_SIZES
    assert tss.PAD_QUANTUM == jss.PAD_QUANTUM
    rng = np.random.default_rng(3)
    a, _x, b = _sys(rng, 6)
    for rhs in ("supply", "zero"):
        for n_pad in (6, 8, 10):
            ta, tb = tss.pad_system(a, b, n_pad, rhs=rhs)
            ja, jb = jss.pad_system(a, b, n_pad, rhs=rhs)
            assert np.array_equal(ta, ja) and np.array_equal(tb, jb)
    with pytest.raises(ValueError, match="cannot pad"):
        tss.pad_system(a, b, 4)
    jsvc, tsvc = _services()
    assert [tsvc.pad_to(n) for n in range(1, 301)] == [jsvc.pad_to(n) for n in range(1, 301)]


@pytest.mark.parametrize("method", ["analog_2n", "analog_n", "cholesky", "cg"])
def test_padding_parity_inside_bucket(method):
    """Non-SDD SPD, SDD and all-negative-b systems padded into one n = 8
    bucket, as tests/test_solve_service.py's."""
    rng = np.random.default_rng(4)
    cases = []
    for kind in ("spd", "sdd", "neg"):
        a, _x, b = _sys(rng, 7, "sdd" if kind == "sdd" else "spd")
        cases.append((a, -np.abs(b) if kind == "neg" else b, dict(method=method, tol=1e-12)))
    jsvc, tsvc, jres, tres, rids = _both(cases, batch_slots=4)
    _same_results(jres, tres, rids)
    _same_stats(jsvc, tsvc)
    for rid, (a, b, _opts) in zip(rids, cases):
        assert tres[rid].x.shape == b.shape and tres[rid].info["service_n_padded"] == 8
        np.testing.assert_allclose(tres[rid].x, _direct(a, b, method, tol=1e-12).x,
                                   rtol=0.0, atol=1e-10)


# ------------------------------------------------------------- the service
def test_mixed_stream_buckets_and_parity():
    rng = np.random.default_rng(5)
    subs = []
    for i in range(10):
        a, _x, b = _sys(rng, [6, 11, 16][i % 3])
        subs.append((a, b, dict(method="analog_2n" if i % 2 else "cholesky")))
    jsvc, tsvc, jres, tres, rids = _both(subs, batch_slots=3)
    _same_results(jres, tres, rids)
    _same_stats(jsvc, tsvc)
    assert set(tsvc.stats["buckets"]) == {
        "n8/analog_2n", "n16/analog_2n", "n8/cholesky", "n16/cholesky"}
    for rid, (a, b, opts) in zip(rids, subs):
        np.testing.assert_allclose(tres[rid].x, _direct(a, b, opts["method"]).x,
                                   rtol=0.0, atol=PARITY_ATOL)


def test_bucket_pipeline_reuses_pattern():
    """One analog_2n bucket over three micro-batches and a later drain:
    one pattern derivation, the same pattern object."""
    rng = np.random.default_rng(6)
    subs = [(a, b, dict(method="analog_2n")) for a, _x, b in (_sys(rng, 10) for _ in range(6))]
    jsvc, tsvc, jres, tres, rids = _both(subs, batch_slots=2)
    _same_results(jres, tres, rids)
    (_key, pipe), = tsvc._pipelines.items()
    assert pipe.micro_batches == 3 and pipe.pattern_derivations == 1
    assert pipe.pattern_rebuilds == 0
    first = pipe.pattern
    more = [_sys(rng, 10) for _ in range(2)]
    for svc in (jsvc, tsvc):
        for a, _x, b in more:
            svc.submit(a, b, method="analog_2n")
    _same_results(jsvc.drain(), tsvc.drain(), [6, 7])
    assert pipe.pattern is first and pipe.micro_batches == 4
    _same_stats(jsvc, tsvc)
    assert tsvc.stats["buckets"]["n16/analog_2n"]["pattern_derivations"] == 1


def _tridiag_spd(n):
    a = np.zeros((n, n))
    idx = np.arange(n - 1)
    a[idx, idx + 1] = a[idx + 1, idx] = -1.0
    np.fill_diagonal(a, 3.0)
    return a


def test_analog_n_pattern_cached_and_merge_is_sound():
    """A repeated sparse pattern derives once; a micro-batch stamping new
    slots grows the union by one merge; results still match."""
    rng = np.random.default_rng(20)
    a_sp = _tridiag_spd(8)
    first = [(a_sp, random_rhs_from_solution(rng, a_sp)[1], dict(method="analog_n"))
             for _ in range(4)]
    jsvc, tsvc, jres, tres, rids = _both(first, batch_slots=2)
    _same_results(jres, tres, rids)
    (_key, pipe), = tsvc._pipelines.items()
    assert (pipe.micro_batches, pipe.pattern_derivations, pipe.pattern_rebuilds) == (2, 1, 0)
    a_dense, _x, b = _sys(rng, 8)
    second = [(a_dense, b), (a_sp, random_rhs_from_solution(rng, a_sp)[1])]
    for svc in (jsvc, tsvc):
        for a, b in second:
            svc.submit(a, b, method="analog_n")
    _same_results(jsvc.drain(), tsvc.drain(), [4, 5])
    assert (pipe.pattern_derivations, pipe.pattern_rebuilds) == (2, 1)
    _same_stats(jsvc, tsvc)


def test_custom_opamp_spec_buckets_apart():
    rng = np.random.default_rng(8)
    a, _x, b = _sys(rng, 6)
    jsvc, tsvc = _services(batch_slots=2)
    jmod = dataclasses.replace(J_OPAMPS["AD712"], open_loop_gain=50.0)
    tmod = dataclasses.replace(T_OPAMPS["AD712"], open_loop_gain=50.0)
    for svc, mod, ni in ((jsvc, jmod, J_DEFAULT_NONIDEAL), (tsvc, tmod, T_DEFAULT_NONIDEAL)):
        svc.submit(a, b, method="analog_2n", opamp=mod, nonideal=ni)
        svc.submit(a, b, method="analog_2n", opamp="AD712", nonideal=ni)
    _same_results(jsvc.drain(), tsvc.drain(), [0, 1])
    assert len(tsvc._pipelines) == 2
    _same_stats(jsvc, tsvc)
    with pytest.raises(ValueError, match="unknown opamp"):
        tsvc.submit(a, b, opamp="OP999")


def test_builds_nets_once_per_micro_batch(monkeypatch):
    rng = np.random.default_rng(9)
    a, _x, b = _sys(rng, 6)
    calls = {"n": 0}
    orig = tsolver_mod._build_nets

    def counting(*args, **kw):
        calls["n"] += 1
        return orig(*args, **kw)

    monkeypatch.setattr(tsolver_mod, "_build_nets", counting)
    monkeypatch.setattr(tss, "_build_nets", counting)
    svc = tss.SolveService(batch_slots=2, devices=[CPU])
    svc.submit(a, b, method="analog_2n")
    svc.submit(a, b, method="analog_2n")
    svc.drain()
    assert calls["n"] == 1


def test_stats_distinct_buckets_and_fill_overhead():
    rng = np.random.default_rng(10)
    a, _x, b = _sys(rng, 6)
    subs = [(a, b, dict(method="cg", tol=1e-10)), (a, b, dict(method="cg", tol=1e-12))]
    jsvc, tsvc, jres, tres, rids = _both(subs, batch_slots=4)
    _same_results(jres, tres, rids)
    _same_stats(jsvc, tsvc)
    assert set(tsvc.stats["buckets"]) == {"n8/cg", "n8/cg#2"}
    assert tsvc.stats["pad_overhead"] == pytest.approx((2 * 4 * 8.0 ** 2) / (2 * 6.0 ** 2))


SIGNATURE_CASES = [
    dict(method="cholesky", opamp="LTC2050", tol=1e-13, compute_settling=True),
    dict(method="cg", tol=1e-12, max_iter=50, beta=0.3, sweep_dtype="bfloat16"),
    dict(method="analog_2n", tol=1e-13, settle_method="eig"),
    dict(method="analog_2n", compute_settling=True, settle_method="euler",
         settle_dt_policy="spectral", sweep_dtype="bfloat16", d_policy="scaled", beta=0.7),
    dict(method="analog_n", beta=0.3, d_policy="scaled", alpha=0.5),
    dict(method="analog_n", compute_settling=True, settle_max_steps=1000),
]


@pytest.mark.parametrize("opts", SIGNATURE_CASES)
def test_signature_normalization_matches_reference(opts):
    """Every field of the normalized signature equals the reference's."""
    rng = np.random.default_rng(12)
    a, _x, b = _sys(rng, 6)
    jsvc, tsvc = _services()
    jsvc.submit(a, b, **opts)
    tsvc.submit(a, b, **opts)
    jsig = jsvc.queue.pop().sig
    tsig = tsvc.queue.pop().sig
    for field in dataclasses.fields(tss.SolveSignature):
        tv, jv = getattr(tsig, field.name), getattr(jsig, field.name)
        if field.name == "opamp":
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
        else:
            assert tv == jv, field.name


def test_signature_normalization_shares_buckets():
    rng = np.random.default_rng(12)
    a, _x, b = _sys(rng, 6)
    subs = [(a, b, dict(method="cholesky", opamp="AD712", tol=1e-10)),
            (a, b, dict(method="cholesky", opamp="LTC2050", tol=1e-13)),
            (a, b, dict(method="analog_2n", tol=1e-10)),
            (a, b, dict(method="analog_2n", tol=1e-13, settle_method="eig")),
            (a, b, dict(method="analog_n", beta=0.5)),
            (a, b, dict(method="analog_n", beta=0.3, d_policy="scaled"))]
    jsvc, tsvc, jres, tres, rids = _both(subs, batch_slots=4)
    _same_results(jres, tres, rids)
    assert len(tsvc._pipelines) == 3
    _same_stats(jsvc, tsvc)


def test_iterative_tol_honored_under_padding():
    rng = np.random.default_rng(13)
    a, _x, b = _sys(rng, 6)
    b = b * 1e-4
    jsvc, tsvc, jres, tres, rids = _both([(a, b, dict(method="cg", tol=1e-10))],
                                         batch_slots=2)
    _same_results(jres, tres, rids)
    direct = _direct(a, b, "cg", tol=1e-10)
    np.testing.assert_allclose(tres[0].x, direct.x, rtol=0.0, atol=1e-14)
    assert tres[0].info["iterations"] == direct.info["iterations"] == jres[0].info["iterations"]


# ------------------------------------------------------ failure machinery
def test_poison_bisection_fails_fast_and_batch_mates_solve(monkeypatch):
    rng = np.random.default_rng(15)
    a, _x, b = _sys(rng, 6)
    bad_a = a.copy()
    bad_a[0, 0] = np.nan
    subs = [(a, b, dict(method="cholesky")), (bad_a, b, dict(method="analog_2n")),
            (a, b, dict(method="analog_2n"))]
    for mod in (jss, tss):
        orig = mod.solve_batch_submit

        def building(a_stack, b_stack, _orig=orig, **kw):
            if np.isnan(a_stack).any():
                raise RuntimeError("netlist build failed")
            return _orig(a_stack, b_stack, **kw)

        monkeypatch.setattr(mod, "solve_batch_submit", building)
    jsvc, tsvc, jres, tres, rids = _both(subs, batch_slots=2, max_attempts=3)
    _same_results(jres, tres, rids)
    _same_stats(jsvc, tsvc)
    err = tres[1]
    assert isinstance(err, TSolveError) and err.kind == "poison" and err.attempts == 3
    assert tsvc.stats["bisections"] >= 1 and len(tsvc.queue) == 0
    assert not hasattr(tsvc, "results")


def test_nan_system_lands_as_bounded_nonfinite_error():
    rng = np.random.default_rng(15)
    a, _x, b = _sys(rng, 6)
    a[0, 0] = np.nan
    jsvc, tsvc, jres, tres, rids = _both([(a, b, dict(method="analog_2n"))],
                                         batch_slots=1, max_attempts=2)
    _same_results(jres, tres, rids)
    _same_stats(jsvc, tsvc)
    assert tres[0].kind == "nonfinite" and tres[0].attempts == 2


def test_priority_deadline_admission_order():
    rng = np.random.default_rng(17)
    a, _x, b = _sys(rng, 6)
    now = tss.SolveService.now()
    subs = [(a, b, dict(method="cholesky")),
            (a, b, dict(method="cholesky", deadline=now + 120.0)),
            (a, b, dict(method="cholesky", priority=5)),
            (a, b, dict(method="cholesky", deadline=now + 60.0))]
    jsvc, tsvc = _services(batch_slots=2)
    orders = []
    for svc in (jsvc, tsvc):
        order = []
        orig = svc._dispatch_micro_batch

        def spy(pipe, chunk, dev, _orig=orig, _order=order):
            _order.extend(t.rid for t in chunk)
            return _orig(pipe, chunk, dev)

        svc._dispatch_micro_batch = spy
        for a_, b_, opts in subs:
            svc.submit(a_, b_, **opts)
        orders.append((order, svc.drain()))
    (jorder, jres), (torder, tres) = orders
    assert torder == jorder == [2, 3, 1, 0]
    _same_results(jres, tres, [0, 1, 2, 3])


def test_expired_deadline_and_queue_depth_shedding():
    rng = np.random.default_rng(22)
    a, _x, b = _sys(rng, 6)
    now = tss.SolveService.now()
    subs = [(a, b, dict(method="cholesky", deadline=now - 1.0)),
            (a, b, dict(method="cholesky", deadline=now + 60.0)),
            (a, b, dict(method="cholesky", priority=5)),
            (a, b, dict(method="cholesky", priority=-1))]
    jsvc, tsvc, jres, tres, rids = _both(subs, batch_slots=1, max_queue_depth=3)
    _same_results(jres, tres, rids)
    _same_stats(jsvc, tsvc)
    assert tres[3].kind == "shed" and tres[0].kind == "deadline_expired"
    assert tsvc.stats["shed"] == tsvc.stats["deadline_expired"] == 1


def test_midflight_injected_fault_retries_to_delivery():
    rng = np.random.default_rng(18)
    subs = [(a, b, dict(method="cholesky")) for a, _x, b in (_sys(rng, 6) for _ in range(4))]
    jsvc, tsvc, jres, tres, rids = _both(
        subs, plan=dict(schedule=((2, "device_fault"),)), batch_slots=1,
        inflight_per_device=2)
    _same_results(jres, tres, rids)
    _same_stats(jsvc, tsvc)
    st = tsvc.stats
    assert st["fault_injections"] == 1 and st["retries"] == 1
    assert st["errors"]["device_fault"] == 0


@pytest.mark.parametrize("rates", [
    {"device_fault": 0.2},
    {"nonfinite": 0.2},
    {"build_error": 0.2},
    {"device_fault": 0.1, "nonfinite": 0.05, "build_error": 0.05},
    {"slow": 0.5},
])
def test_chaos_same_errors_for_same_plan(rates):
    """tests/test_faults.py's mixed chaos stream under the same seeded
    plan: the same faults fire at the same dispatches, so both services
    deliver the same answers and the same error kinds."""
    rng = np.random.default_rng(11)
    subs = []
    for i in range(18):
        a, _x, b = _sys(rng, (6, 9, 12)[i % 3])
        subs.append((a, b, dict(method=("analog_2n", "cholesky", "cg")[i % 3], tol=1e-12)))
    jsvc, tsvc, jres, tres, rids = _both(
        subs, plan=dict(seed=11, rates=rates, slow_s=0.001), batch_slots=2,
        max_attempts=4)
    _same_results(jres, tres, rids)
    _same_stats(jsvc, tsvc)
    assert tsvc.stats["fault_injections"] > 0
    for rid, (a, b, opts) in zip(rids, subs):
        if not isinstance(tres[rid], TSolveError):
            np.testing.assert_allclose(tres[rid].x, _direct(a, b, opts["method"], tol=1e-12).x,
                                       rtol=0.0, atol=PARITY_ATOL)


def test_persistent_fault_terminates_with_errors():
    rng = np.random.default_rng(11)
    subs = [(a, b, dict(method="cholesky")) for a, _x, b in (_sys(rng, 6) for _ in range(6))]
    jsvc, tsvc, jres, tres, rids = _both(
        subs, plan=dict(seed=11, rates={"device_fault": 1.0}), batch_slots=2,
        max_attempts=2, breaker_backoff_s=0.0)
    _same_results(jres, tres, rids)
    assert all(r.kind == "device_fault" and r.attempts == 2 for r in tres.values())
    assert tsvc.stats["errors"]["device_fault"] == 6
    assert tsvc.stats["breaker"]["trips"] >= 1


def test_quarantine_reroutes_to_healthy_stream():
    rng = np.random.default_rng(21)
    subs = [(a, b, dict(method="cholesky")) for a, _x, b in (_sys(rng, 6) for _ in range(8))]
    jsvc, tsvc, jres, tres, rids = _both(
        subs, n_streams=2, plan=dict(seed=5, rates={"device_fault": 1.0}, devices=(0,)),
        batch_slots=1, breaker_threshold=1, breaker_backoff_s=30.0, max_attempts=10)
    _same_results(jres, tres, rids)
    _same_stats(jsvc, tsvc)
    st = tsvc.stats
    assert st["quarantines"] >= 1 and sum(st["errors"].values()) == 0
    assert st["breaker"]["states"] == ["open", "closed"]


def test_breaker_recovers_after_transient_fault():
    rng = np.random.default_rng(23)
    subs = [(a, b, dict(method="cholesky")) for a, _x, b in (_sys(rng, 6) for _ in range(8))]
    jsvc, tsvc, jres, tres, rids = _both(
        subs, n_streams=2, plan=dict(schedule=((0, "device_fault"),)), batch_slots=1,
        breaker_threshold=1, breaker_backoff_s=0.0, max_attempts=5)
    _same_results(jres, tres, rids)
    _same_stats(jsvc, tsvc)
    st = tsvc.stats["breaker"]
    assert st["trips"] >= 1 and st["restores"] >= 1 and st["states"] == ["closed", "closed"]


# ----------------------------------------------------- overlap and streams
def test_double_buffered_dispatch_parity():
    """inflight 1 and 2 give the same bytes; both within 1e-9 of the
    reference service."""
    rng = np.random.default_rng(19)
    subs = [(a, b, dict(method="analog_2n")) for a, _x, b in (_sys(rng, 10) for _ in range(6))]
    got = {}
    for inflight in (1, 2):
        jsvc, tsvc, jres, tres, rids = _both(subs, batch_slots=2,
                                             inflight_per_device=inflight)
        _same_results(jres, tres, rids)
        got[inflight] = [tres[r].x for r in rids]
    for x1, x2 in zip(got[1], got[2]):
        assert np.array_equal(x1, x2)


def test_streams_over_cpu_devices():
    """Round-robin over four CPU streams (the reference's forced-host-
    device case): 1e-9 parity, the same bytes as one stream."""
    rng = np.random.default_rng(11)
    subs = []
    for i in range(6):
        a, _x, b = _sys(rng, [8, 12][i % 2])
        subs.append((a, b, dict(method="analog_2n" if i % 2 else "cg", tol=1e-12)))
    jsvc, tsvc, jres, tres, rids = _both(subs, n_streams=4, batch_slots=4)
    _same_results(jres, tres, rids)
    _same_stats(jsvc, tsvc)
    assert tsvc.stats["devices"] == 4 and tsvc.stats["host_build_s"] > 0
    one = tss.SolveService(devices=[CPU], batch_slots=4)
    for a, b, opts in subs:
        one.submit(a, b, **opts)
    single = one.drain()
    for rid in rids:
        assert np.array_equal(single[rid].x, tres[rid].x)


def test_vectorized_unpack_matches_batch_getitem():
    rng = np.random.default_rng(21)
    cases = [_sys(rng, 6) for _ in range(2)]
    svc = tss.SolveService(batch_slots=3, devices=[CPU])
    rids = [svc.submit(a, b, method="analog_2n") for a, _x, b in cases]
    res = svc.drain()
    padded = [tss.pad_system(a, b, 8) for a, _x, b in cases]
    padded.append(padded[-1])
    batch = tsolver_mod.solve_batch(np.stack([p[0] for p in padded]),
                                    np.stack([p[1] for p in padded]),
                                    method="analog_2n", device=CPU)
    for k, rid in enumerate(rids):
        ref, got = batch[k], res[rid]
        assert np.array_equal(got.x, ref.x[:6])
        assert got.stable == ref.stable and got.method == ref.method
        for key, want in ref.info.items():
            assert type(got.info[key]) is type(want), key
            assert got.info[key] == want, key


@pytest.mark.parametrize("settle_method", ["eig", "euler"])
def test_settling_buckets_at_exact_n(settle_method):
    """Settling requests are not padded: settle_time (and the sweep's
    settle_steps) equal the reference service's and the direct solve's."""
    rng = np.random.default_rng(14)
    a, _x, b = _sys(rng, 6)
    opts = dict(method="analog_2n", compute_settling=True, settle_method=settle_method)
    jsvc, tsvc, jres, tres, rids = _both([(a, b, opts)], batch_slots=2)
    _same_results(jres, tres, rids)
    _same_stats(jsvc, tsvc)
    got = tres[0]
    assert got.info["service_n_padded"] == 6 and got.stable
    direct = _direct(a, b, **opts)
    np.testing.assert_allclose(got.settle_time, direct.settle_time, rtol=1e-6)
    np.testing.assert_allclose(got.settle_time, jres[0].settle_time, rtol=1e-6)
    if settle_method == "euler":
        assert got.info["settle_steps"] == direct.info["settle_steps"] \
            == jres[0].info["settle_steps"]


def test_entry_points_raise_without_a_card(monkeypatch):
    """The service, its streams and the mesh run on the card unless given
    CPU devices."""
    from repro_torch.distributed import sharding

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tss.SolveService, sharding.solver_mesh, sharding.stream_devices,
                 lambda: tss.SolveService(devices=["cuda"]),
                 lambda: sharding.solver_mesh(n_devices=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert tss.SolveService(devices=[CPU] * 2).devices == [torch.device(CPU)] * 2
    assert sharding.solver_mesh(devices=[CPU]).devices == (torch.device(CPU),)
