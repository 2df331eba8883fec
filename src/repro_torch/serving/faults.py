"""Deterministic fault injection and the serving error taxonomy.

A copy of :mod:`repro.serving.faults` (numpy only, so the port keeps its
own): :class:`SolveError`, the structured error delivered instead of a
result (``kind`` / ``attempts`` / ``detail``); :class:`FaultInjected`;
and :class:`FaultPlan` / :class:`FaultInjector`, a *seeded* injector of
the four serving fault classes, driven by per-kind rates or an exact
``(dispatch_index, kind)`` schedule.  :class:`~repro_torch.serving.
engine.ServeEngine` takes the injector as a constructor hook and draws
once per decode step; :meth:`FaultInjector.arm` plants a fault into a
:class:`repro_torch.core.PendingBatchSolve`, and
:class:`~repro_torch.serving.solve_service.SolveService` draws once per
micro-batch dispatch.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Mapping

import numpy as np

# the service's structured error taxonomy (SolveError.kind):
#   device_fault     — the device-side solve raised (dispatch/harvest)
#   nonfinite        — the delivered solution carried NaN/Inf
#   uncertified      — settling never certified AND the residual
#                      overflowed, with digital fallback disabled
#   unrefined        — graded recovery was enabled, refinement stalled /
#                      exhausted its budget AND digital fallback was
#                      disabled: the residual-verified precision
#                      contract cannot be met (deterministic — never
#                      retried)
#   deadline_expired — the ticket's deadline passed before dispatch
#   poison           — the request's own host build raised repeatedly
#   shed             — dropped by queue-depth load shedding (lowest
#                      admission rank first)
ERROR_KINDS = (
    "device_fault",
    "nonfinite",
    "uncertified",
    "unrefined",
    "deadline_expired",
    "poison",
    "shed",
)

# injectable fault classes (FaultPlan.rates keys / schedule kinds)
FAULT_KINDS = ("device_fault", "nonfinite", "build_error", "slow")


@dataclasses.dataclass
class SolveError:
    """Structured failure delivered in a ticket's result slot.

    Never *raised* by the service — it is the exactly-once "answer"
    for a ticket the service could not solve, so ``drain()`` terminates
    and batch-mates of a failing request still get their solutions.
    """

    kind: str
    attempts: int = 0
    detail: str = ""

    def __post_init__(self) -> None:
        if self.kind not in ERROR_KINDS:
            raise ValueError(
                f"unknown error kind {self.kind!r}: expected one of "
                f"{ERROR_KINDS}"
            )


class FaultInjected(RuntimeError):
    """An injected fault (carries the injected ``kind``)."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"injected {kind}" + (f": {detail}" if detail else ""))
        self.kind = kind


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded description of *what* to inject and *when*.

    ``rates`` maps a fault kind to its per-dispatch probability; the
    kinds draw one uniform sample per dispatch event against the
    cumulative rate ladder, so a plan's fault sequence is a pure
    function of ``seed`` and the dispatch count — independent of
    wall-clock, thread timing, or which stream the dispatch lands on.
    ``schedule`` forces exact ``(dispatch_index, kind)`` hits on top
    (deterministic single-fault scenarios: "the 3rd micro-batch's
    device dies").  ``devices`` restricts injection to those stream
    indices (the quarantine scenarios: one stream is sick, the rest
    are healthy); the rng is consumed identically either way, so
    narrowing the target set never re-times the other faults.
    """

    seed: int = 0
    rates: Mapping[str, float] = dataclasses.field(default_factory=dict)
    schedule: tuple[tuple[int, str], ...] = ()
    devices: tuple[int, ...] | None = None
    slow_s: float = 0.02

    def __post_init__(self) -> None:
        for kind in self.rates:
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}: expected one of "
                    f"{FAULT_KINDS}"
                )
        for _, kind in self.schedule:
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown scheduled fault kind {kind!r}")
        if sum(self.rates.values()) > 1.0 + 1e-12:
            raise ValueError("fault rates must sum to <= 1")


class FaultInjector:
    """Stateful, deterministic dispenser of a :class:`FaultPlan`.

    One injector instance follows one service's dispatch stream:
    :meth:`draw` is called once per micro-batch dispatch (and once per
    engine decode step) and decides the fault for that event;
    :meth:`arm` mutates an in-flight :class:`~repro_torch.core.solver.\
    PendingBatchSolve` so the fault surfaces exactly where the real
    one would.  ``stats()`` reports what was actually injected, which
    the service re-surfaces as its ``fault_injections`` counter.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed)
        self.dispatches = 0
        self.injected: dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self._schedule = {idx: kind for idx, kind in plan.schedule}
        # draw() is called from every stream's dispatch path and must
        # consume exactly one rng sample per dispatch index — an
        # unlocked interleaving double-spends indices and desyncs the
        # reproducible fault timeline
        self._lock = threading.Lock()

    # ------------------------------------------------------------ decide
    def draw(self, dev: int | None = None) -> str | None:
        """The fault (or ``None``) for the next dispatch event.

        Exactly one rng sample is consumed per call, before the
        device-target filter, so the fault timeline is reproducible
        across different stream layouts.
        """
        with self._lock:
            idx = self.dispatches
            self.dispatches += 1
            u = float(self.rng.random())
            kind = self._schedule.get(idx)
            if kind is None and self.plan.rates:
                acc = 0.0
                for k in FAULT_KINDS:
                    acc += float(self.plan.rates.get(k, 0.0))
                    if u < acc:
                        kind = k
                        break
            if kind is None:
                return None
            if (
                self.plan.devices is not None
                and dev is not None
                and dev not in self.plan.devices
            ):
                return None
            self.injected[kind] += 1
            return kind

    # ------------------------------------------------------------- apply
    def build_fault(self, kind: str | None) -> None:
        """Raise now if ``kind`` is the host-build fault."""
        if kind == "build_error":
            raise FaultInjected("build_error", "host build failed")

    def arm(self, pending, kind: str | None):
        """Plant ``kind`` into an in-flight solve handle.

        ``device_fault`` raises from the device-phase harvest
        (``wait_dc()`` on a split handle, ``wait()`` otherwise) — the
        point where an async device error genuinely surfaces under
        asynchronous dispatch; ``nonfinite`` corrupts every solution row of the
        *delivered* batch — after the finish phase on a split handle,
        so the digital fallback cannot quietly repair the injected
        corruption (the whole micro-batch retries, like a real bad
        device buffer); ``slow`` stalls the harvest by ``plan.slow_s``.
        """
        if kind is None or kind == "build_error":
            return pending
        orig = pending._finalize
        if kind == "device_fault":

            def injected_device_fault():
                raise FaultInjected("device_fault", "stream died mid-solve")

            pending._finalize = injected_device_fault
        elif kind == "nonfinite":

            def corrupt(batch):
                x = np.array(batch.x, dtype=np.float64, copy=True)
                x[:, 0] = np.nan
                batch.x = x
                return batch

            if pending._finish is not None:
                orig_finish = pending._finish
                pending._finish = lambda dc: corrupt(orig_finish(dc))
            else:
                pending._finalize = lambda: corrupt(orig())
        elif kind == "slow":
            slow_s = self.plan.slow_s

            def injected_slow():
                time.sleep(slow_s)
                return orig()

            pending._finalize = injected_slow
        else:
            raise ValueError(f"unknown fault kind {kind!r}")
        return pending

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "injected": dict(self.injected),
            "total_injected": sum(self.injected.values()),
        }
