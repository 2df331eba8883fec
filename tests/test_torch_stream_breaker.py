"""Port parity: repro_torch's StreamBreaker and the serving fault
injector against the JAX reference's, on the CPU.

The breaker is pure host logic: both packages' breakers are driven
through the same transitions with one fake clock and must report the same
states, return values and counters at every step (tests/test_faults.py:
111-163).  The injector must validate plans alike and draw the same fault
sequence from the same seed, device filter included (tests/test_faults.py:
50-110).
"""

import numpy as np
import pytest

from repro.distributed.sharding import StreamBreaker as JBreaker
from repro.serving import faults as jfaults

from repro_torch.distributed.sharding import StreamBreaker as TBreaker
from repro_torch.serving import faults as tfaults


class _Pair:
    """The reference's and the port's breaker on one fake clock; every
    call runs on both and must return the same."""

    def __init__(self, *args, **kw):
        self.t = [0.0]
        clock = lambda: self.t[0]  # noqa: E731
        self.j = JBreaker(*args, clock=clock, **kw)
        self.p = TBreaker(*args, clock=clock, **kw)

    def __getattr__(self, name):
        def both(*args):
            want = getattr(self.j, name)(*args)
            got = getattr(self.p, name)(*args)
            assert got == want, (name, args, got, want)
            assert self.p.stats() == self.j.stats()
            for i in range(len(self.j)):
                assert vars(self.p._streams[i]) == vars(self.j._streams[i])
            return got
        return both


def test_breaker_trips_after_threshold_and_probes_after_backoff():
    br = _Pair(2, threshold=3, backoff_s=1.0)
    assert br.acquire(0) and br.state(0) == "closed"
    assert not br.record_failure(0)
    assert not br.record_failure(0)
    assert br.record_failure(0)
    assert br.state(0) == "open" and br.p.trips == 1
    assert not br.acquire(0)
    assert br.acquire(1)
    br.t[0] = 1.5
    assert br.acquire(0)
    assert br.state(0) == "half_open" and br.p.probes == 1
    assert not br.acquire(0)
    br.record_success(0)
    assert br.state(0) == "closed" and br.p.restores == 1


def test_breaker_failed_probe_doubles_backoff_capped():
    br = _Pair(1, threshold=1, backoff_s=1.0, backoff_max_s=3.0)
    assert br.record_failure(0)
    for expect in (2.0, 3.0, 3.0):
        br.t[0] += 10.0
        assert br.acquire(0)
        assert br.record_failure(0)
        assert br.p._streams[0].backoff_s == expect


def test_breaker_release_returns_probe_unjudged():
    br = _Pair(1, threshold=1, backoff_s=1.0)
    br.record_failure(0)
    br.t[0] = 2.0
    assert br.acquire(0) and br.state(0) == "half_open"
    br.release(0)
    assert br.state(0) == "open"
    assert br.acquire(0)


def test_breaker_force_probe_expires_soonest_open():
    br = _Pair(2, threshold=1, backoff_s=5.0)
    br.record_failure(0)
    br.t[0] = 1.0
    br.record_failure(1)
    assert br.force_probe() == 0
    assert br.acquire(0)
    br.record_success(0)
    assert br.p.stats()["states"] == ["closed", "open"]


def test_breaker_random_walk_matches_reference():
    """600 seeded random calls over three streams, the clock advancing."""
    rng = np.random.default_rng(0)
    br = _Pair(3, threshold=2, backoff_s=0.5, backoff_max_s=4.0)
    for _ in range(600):
        br.t[0] += float(rng.uniform(0.0, 0.4))
        dev = int(rng.integers(3))
        op = ("acquire", "release", "record_success", "record_failure", "state")[
            int(rng.integers(5))]
        getattr(br, op)(dev)
        if all(s.state == "open" for s in br.j._streams):
            br.force_probe()
    assert br.p.trips > 0 and br.p.probes > 0


def test_breaker_validates_arguments():
    for cls in (JBreaker, TBreaker):
        with pytest.raises(ValueError, match="at least one stream"):
            cls(0)
        with pytest.raises(ValueError, match="threshold"):
            cls(1, threshold=0)
        with pytest.raises(RuntimeError, match="no open stream"):
            cls(1).force_probe()


# ------------------------------------------------------- fault injector
def test_error_taxonomy_and_fault_kinds_match_reference():
    assert tfaults.ERROR_KINDS == jfaults.ERROR_KINDS
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    err = tfaults.SolveError(kind="device_fault", attempts=2, detail="boom")
    assert err.kind == "device_fault" and err.attempts == 2
    with pytest.raises(ValueError, match="unknown error kind"):
        tfaults.SolveError(kind="gremlins")


@pytest.mark.parametrize("kw, match", [
    (dict(rates={"gremlins": 0.1}), "unknown fault kind"),
    (dict(schedule=((0, "gremlins"),)), "unknown scheduled fault"),
    (dict(rates={"device_fault": 0.7, "nonfinite": 0.7}), "sum to"),
])
def test_fault_plan_validates_as_reference(kw, match):
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError, match=match):
            mod.FaultPlan(**kw)
    tfaults.FaultPlan(rates={"device_fault": 0.5, "nonfinite": 0.5})


@pytest.mark.parametrize("plan", [
    dict(seed=7, rates={"device_fault": 0.3, "nonfinite": 0.2}),
    dict(seed=31, rates={"device_fault": 0.1, "nonfinite": 0.05, "build_error": 0.05}),
    dict(seed=1, rates={"slow": 0.5}, schedule=((3, "build_error"), (9, "nonfinite"))),
    dict(schedule=((3, "build_error"),)),
])
def test_injector_draws_the_reference_sequence(plan):
    j = jfaults.FaultInjector(jfaults.FaultPlan(**plan))
    t = tfaults.FaultInjector(tfaults.FaultPlan(**plan))
    seq = [t.draw() for _ in range(200)]
    assert seq == [j.draw() for _ in range(200)]
    assert t.stats() == j.stats()
    # a pure function of the seed: a fresh injector repeats the sequence
    fresh = tfaults.FaultInjector(tfaults.FaultPlan(**plan))
    assert [fresh.draw() for _ in range(200)] == seq


def test_injector_device_filter_does_not_retime():
    devs = [i % 4 for i in range(100)]
    seqs = {}
    for name, mod in (("j", jfaults), ("t", tfaults)):
        inj_all = mod.FaultInjector(mod.FaultPlan(seed=3, rates={"device_fault": 0.4}))
        inj_dev0 = mod.FaultInjector(mod.FaultPlan(seed=3, rates={"device_fault": 0.4},
                                                   devices=(0,)))
        seqs[name] = ([inj_all.draw(dev=d) for d in devs], [inj_dev0.draw(dev=d) for d in devs])
    assert seqs["t"] == seqs["j"]
    seq_all, seq_dev0 = seqs["t"]
    for i, d in enumerate(devs):
        assert seq_dev0[i] == (seq_all[i] if d == 0 else None)
    assert any(k is not None for k in seq_dev0)
