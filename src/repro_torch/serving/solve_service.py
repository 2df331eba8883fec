"""Continuously batched solve service on CUDA streams.

Counterpart of :mod:`repro.serving.solve_service`, with its names and its
delivery contract.  A stream of heterogeneous requests (different ``n``,
methods and settle options) becomes fixed-shape, shared-stamp-pattern
micro-batches for :func:`repro_torch.core.solver.solve_batch_submit`:

* **submit** — requests are queued, not solved; each carries its system,
  its method, the option signature that decides batch compatibility, and
  its admission stamps (``priority`` / ``deadline``) for the
  :class:`repro_torch.serving.engine.AdmissionQueue`: priority first,
  earliest deadline within a class, FIFO on ties.
* **bucket** — admitted requests group by ``(n_padded, signature)``;
  ``n_padded`` comes from a small padding grid.  Settling requests
  bucket at their exact ``n`` (settle metrics describe the whole circuit
  and do not un-pad).
* **pad** — ``A_pad = blockdiag(A, g_pad I)`` with ``g_pad`` the mean
  diagonal of ``A``, ``b_pad = g_pad * PAD_SOLUTION_V`` on the pad rows
  for the analog designs (a supply leg keeps the circuit regular), zero
  for the digital baselines (the iterative stopping test sees the real
  ``||b||``).  The pad solution is masked out of every result.
* **stream** — whole micro-batches go round-robin to the service's
  streams; nothing is split within one.
* **overlap** — dispatch is split submit/wait: the host phase (pad,
  stack, netlist build, error model) runs, the device phase (assembly,
  float64 DC solve) is enqueued, and the scheduler builds the next
  micro-batch while the card computes.  Each stream holds up to
  ``inflight_per_device`` dispatched micro-batches (2 = double
  buffering, 1 = the serial loop); a settling micro-batch releases its
  stream at the DC harvest and runs its settle sweep as a deferred
  *finish* phase.
* **pattern reuse** — each bucket caches one stamp pattern across
  micro-batches, streams and drains; ``analog_n`` buckets grow the cached
  union with ``pattern_merge`` when a micro-batch stamps a new slot.

How the reference's per-device JAX streams become CUDA streams:

* **A service stream is a pair: a** :class:`torch.device` **and a**
  :class:`torch.cuda.Stream` **on it.**  ``devices=["cuda", "cuda"]``
  gives two CUDA streams on one card; the default is one stream on
  ``cuda:0``.  On the CPU a stream is only an index (the tests use
  ``devices=["cpu"] * k``).
* **Dispatch, harvest** (:meth:`PendingBatchSolve.wait_dc`) **and the
  deferred finish** (:meth:`PendingBatchSolve.wait`: the settle sweep,
  graded recovery, fallback) run under ``torch.cuda.stream(stream)``, so
  the kernels (K3, K4 of the settle sweep) launch on it unchanged: they
  launch on the current stream.  CUDA's asynchronous launches take the
  place of JAX's async dispatch.
* **The netlist build runs on a build stream of its own**, one per card.
  ``build_proposed_batch`` runs the Sec. IV transform on the card and
  copies the result back with ``.cpu()``, which waits for everything
  queued on the current stream.  On the service stream that is the
  previous micro-batch's DC solve, so the host build of micro-batch
  ``i+1`` would wait for the solve of ``i`` and double buffering would
  be lost while every result stayed right.  On the build stream the
  copy waits only for the build's own transform.
* **No tensor crosses streams.**  Netlists and stamp patterns are numpy
  (the pattern cache is shared by every stream safely), every device
  tensor of a micro-batch is made and consumed on its own stream, and
  the build's tensors die on the build stream.  So no
  ``Stream.wait_stream`` / ``Tensor.record_stream`` pair is needed; a
  change that hands a device tensor from one stream to another must add
  one, or the caching allocator may reuse its memory early.
* **Buffer donation** of the reference's per-device DC solve (JAX
  ``donate_argnums``) has no counterpart and none is added.
* **A real CUDA fault is sticky**: it poisons the CUDA context for the
  process, where a JAX device error leaves the runtime usable.
  Quarantine, re-queueing and half-open probes therefore act on the
  faults the seeded :class:`~repro_torch.serving.faults.FaultInjector`
  plants; no recovery from a real fault is attempted.
* **Phases are labeled for the runtime sync gate** as in the reference:
  :func:`~repro_torch.analysis.runtime.sync_scope` marks ``dispatch``
  (the host phase and submit), ``harvest`` (``wait_dc``), ``finish``
  (``wait``) and ``unpack``; the netlist build inside dispatch is
  ``net_build`` and the settle poll inside finish ``settle_poll``
  (innermost label wins).  ``python -m repro_torch.analysis
  --runtime-gate`` requires no host copy under ``dispatch``.  The submit
  path's host-to-device copies go through pinned memory
  (:func:`repro_torch.device.to_device`): a copy from pageable memory
  would wait for the stream's previous solve.

Failure semantics (the delivery contract): every submitted ticket gets
exactly one terminal answer from :meth:`SolveService.drain` — a
:class:`~repro_torch.core.solver.SolveResult` or a structured
:class:`~repro_torch.serving.faults.SolveError` — through bounded retry
with poison bisection, deadline enforcement and queue-depth shedding,
per-stream quarantine (:class:`~repro_torch.distributed.sharding.\
StreamBreaker`), the analog-to-digital fallback and, with ``refine=``,
graded recovery.  :class:`SolveSession` is the multi-round ticket kind
of an iterative client (the ``rounds=`` executor of
:func:`repro_torch.optim.batched_newton.newton_batch`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.analysis.runtime import sync_scope
from repro_torch.core import engine
from repro_torch.core.operating_point import NonIdealities
from repro_torch.core.refine import as_refine_spec
from repro_torch.core.solver import (
    ANALOG_METHODS,
    DIGITAL_METHODS,
    FALLBACK_METHODS,
    FALLBACK_RESIDUAL_TOL,
    PRECISION_PATHS,
    PendingBatchSolve,
    SolveResult,
    _build_nets,
    solve_batch_submit,
)
from repro_torch.core.specs import DEFAULT_PARAMS, OPAMPS, CircuitParams, OpAmpSpec
from repro_torch.distributed.sharding import StreamBreaker, stream_devices
from repro_torch.kernels.ell_transient import SWEEP_DTYPES
from repro_torch.serving.engine import AdmissionQueue
from repro_torch.serving.faults import ERROR_KINDS, FaultInjector, SolveError

# nominal voltage of padded unknowns; in-range for the paper's
# x ~ U[-0.5, 0.5] V protocol, nonzero so pad nodes keep a supply leg
PAD_SOLUTION_V = 0.1

# default padding grid; sizes beyond the grid round up to PAD_QUANTUM
DEFAULT_PAD_SIZES = (8, 16, 32, 48, 64, 96, 128, 192, 256)
PAD_QUANTUM = 64


@dataclasses.dataclass(frozen=True)
class SolveSignature:
    """The option tuple that decides batch compatibility.

    Two requests may share a device batch iff their signatures are
    equal — every field changes the stamped circuit, the solver
    semantics or the settle pipeline.  ``opamp`` is the full (frozen,
    hashable) spec, so custom parts bucket apart from registry parts
    even under a shared name.
    """

    method: str
    opamp: OpAmpSpec
    d_policy: str = "proposed"
    beta: float = 0.5
    alpha: float = 1.0
    compute_settling: bool = False
    settle_method: str = "auto"
    settle_max_steps: int = 200_000
    settle_dt_policy: str = "diag"
    sweep_dtype: str = "float32"
    tol: float = 1e-10
    max_iter: int = 10000
    nonideal: NonIdealities | None = None

    def normalized(self) -> "SolveSignature":
        """Reset every field the dispatched solver ignores to its
        default, so requests differing only in irrelevant options still
        share a bucket (a digital request's opamp, an analog request's
        CG tolerance, settle options without ``compute_settling``...).
        """
        changes: dict[str, Any] = {}
        if self.method in DIGITAL_METHODS:
            # no circuit is stamped and nothing settles
            changes.update(
                opamp=OPAMPS["AD712"], nonideal=None, d_policy="proposed",
                beta=0.5, alpha=1.0, compute_settling=False,
            )
            if self.method == "cholesky":    # direct: no iteration knobs
                changes.update(tol=1e-10, max_iter=10000)
        else:
            changes.update(tol=1e-10, max_iter=10000)
            if self.method == "analog_n":
                # the preliminary builder takes only (a, b, params)
                changes.update(d_policy="proposed", beta=0.5, alpha=1.0)
        if not (self.compute_settling and self.method in ANALOG_METHODS):
            # sweep_dtype only selects the settle sweep kernel, so it must
            # not split buckets without one
            changes.update(
                settle_method="auto", settle_max_steps=200_000,
                settle_dt_policy="diag", sweep_dtype="float32",
            )
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class SolveTicket:
    """One queued request; ``result`` is filled by :meth:`SolveService.drain`
    with the solution or a structured :class:`SolveError`, never nothing."""

    rid: int
    a: np.ndarray
    b: np.ndarray
    sig: SolveSignature
    # optional settle warm start (previous solution, (n,)): a per-ticket
    # payload, not part of the bucket signature
    x0: np.ndarray | None = None
    result: SolveResult | SolveError | None = None
    # failed dispatch/harvest count (bounded by max_attempts)
    attempts: int = 0
    # admission stamps (set by AdmissionQueue.push)
    priority: int = 0
    deadline: float | None = None
    seq: int = 0

    @property
    def n(self) -> int:
        return self.a.shape[0]


@dataclasses.dataclass
class _BucketPipeline:
    """Cached per-bucket dispatch state."""

    n_pad: int
    sig: SolveSignature
    pattern: engine.StampPattern | None = None
    micro_batches: int = 0
    systems: int = 0
    fill_slots: int = 0
    pattern_derivations: int = 0
    pattern_rebuilds: int = 0


@dataclasses.dataclass
class _InFlight:
    """One dispatched micro-batch awaiting harvest on its stream."""

    pipe: _BucketPipeline
    tickets: list
    pending: PendingBatchSolve
    dev: int
    # the fault kind the chaos injector planted into this dispatch (None
    # for a clean one), so delivery accounting can attribute recovery
    injected: str | None = None


def pad_system(
    a: np.ndarray, b: np.ndarray, n_pad: int, *, rhs: str = "supply"
) -> tuple[np.ndarray, np.ndarray]:
    """Identity-extend ``(A, b)`` to ``n_pad`` unknowns.

    The pad block is ``g_pad I`` with ``g_pad = mean(diag(A))``.  The
    pad right-hand side is ``g_pad * PAD_SOLUTION_V`` for
    ``rhs="supply"`` (the analog designs: every pad node keeps a supply
    leg, so the DC operator is never singular) and zero for
    ``rhs="zero"`` (the digital baselines: a nonzero pad would inflate
    ``||b||`` and loosen the iterative solvers' relative stopping test).
    """
    n = a.shape[0]
    if n == n_pad:
        return a, b
    if n > n_pad:
        raise ValueError(f"system of size {n} cannot pad to {n_pad}")
    g_pad = float(np.mean(np.diagonal(a)))
    a_pad = np.zeros((n_pad, n_pad), dtype=np.float64)
    a_pad[:n, :n] = a
    a_pad[np.arange(n, n_pad), np.arange(n, n_pad)] = g_pad
    fill = g_pad * PAD_SOLUTION_V if rhs == "supply" else 0.0
    b_pad = np.full(n_pad, fill, dtype=np.float64)
    b_pad[:n] = b
    return a_pad, b_pad


class SolveService:
    """Queue -> bucket -> pad -> round-robin dispatch on device streams.

    Parameters as the reference's :class:`repro.serving.SolveService`:

    batch_slots:
        Systems per micro-batch.  Partial micro-batches are filled by
        repeating the last system (counted in ``stats``).
    mesh / n_devices / devices:
        The streams (:func:`repro_torch.distributed.sharding.stream_devices`):
        ``devices`` lists one device per stream (a device may repeat:
        ``["cuda", "cuda"]`` is two CUDA streams on one card,
        ``["cpu"] * k`` k host streams); ``mesh`` contributes its
        device order; ``n_devices`` takes the first N cards.  Default:
        one stream on ``cuda:0``; without a card it raises unless given
        CPU devices.
    inflight_per_device:
        Dispatched-but-unharvested micro-batches each stream may hold
        (2 double-buffers, 1 is the serial loop).
    pad_sizes:
        The bucketing grid for ``n``; off-grid sizes round up to the
        next multiple of ``PAD_QUANTUM``.
    max_attempts:
        Failed dispatches/harvests a single ticket may see before it is
        failed fast with a :class:`SolveError` (never re-queued).
    max_queue_depth:
        Optional load shedding: a drain admitting more tickets sheds the
        lowest-admission-rank excess with ``SolveError(kind="shed")``.
    fallback / fallback_residual_tol / refine:
        The analog-to-digital degradation and graded-recovery policy
        forwarded to :func:`repro_torch.core.solver.solve_batch_submit`.
    breaker_threshold / breaker_backoff_s / breaker_backoff_max_s:
        The per-stream circuit breaker.
    fault_injector:
        Optional seeded :class:`repro_torch.serving.faults.FaultInjector`.
    """

    def __init__(
        self,
        *,
        batch_slots: int = 8,
        mesh=None,
        n_devices: int | None = None,
        devices=None,
        inflight_per_device: int = 2,
        pad_sizes: tuple[int, ...] = DEFAULT_PAD_SIZES,
        params: CircuitParams = DEFAULT_PARAMS,
        max_attempts: int = 3,
        max_queue_depth: int | None = None,
        fallback: str = "cholesky",
        fallback_residual_tol: float = FALLBACK_RESIDUAL_TOL,
        refine=None,
        breaker_threshold: int = 3,
        breaker_backoff_s: float = 0.25,
        breaker_backoff_max_s: float = 30.0,
        fault_injector: FaultInjector | None = None,
    ):
        self.devices = stream_devices(mesh=mesh, devices=devices, n_devices=n_devices)
        if inflight_per_device < 1:
            raise ValueError("inflight_per_device must be >= 1")
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if fallback is None:
            fallback = "none"
        if fallback not in FALLBACK_METHODS:
            raise ValueError(
                f"unknown fallback {fallback!r}: expected one of "
                f"{FALLBACK_METHODS}"
            )
        # one CUDA stream per service stream, one build stream per card
        self._streams = [
            torch.cuda.Stream(device=d) if d.type == "cuda" else None
            for d in self.devices
        ]
        self._build_streams = {
            d: torch.cuda.Stream(device=d) for d in self.devices if d.type == "cuda"
        }
        self.inflight_per_device = int(inflight_per_device)
        self.batch_slots = max(1, int(batch_slots))
        self.pad_sizes = tuple(sorted(pad_sizes))
        self.params = params
        self.max_attempts = int(max_attempts)
        self.max_queue_depth = (
            None if max_queue_depth is None else int(max_queue_depth)
        )
        self.fallback = fallback
        self.fallback_residual_tol = float(fallback_residual_tol)
        self.refine = as_refine_spec(refine)
        self.fault_injector = fault_injector
        self.breaker = StreamBreaker(
            len(self.devices),
            threshold=breaker_threshold,
            backoff_s=breaker_backoff_s,
            backoff_max_s=breaker_backoff_max_s,
        )
        self.queue = AdmissionQueue()
        self._pipelines: dict[tuple, _BucketPipeline] = {}
        self._next_rid = 0
        self._rr = 0             # round-robin stream cursor
        self._wall_s = 0.0
        self._host_build_s = 0.0
        self._device_wait_s = 0.0
        self._settle_finish_s = 0.0
        self._unpack_s = 0.0
        self._real_sq = 0.0      # sum n^2 over served systems (stats)
        self._counters: dict[str, Any] = {
            "retries": 0,
            "bisections": 0,
            "shed": 0,
            "deadline_expired": 0,
            "fallbacks": 0,
            # fallbacks in micro-batches whose dispatch carried an
            # injected corruption, kept apart so "fallbacks" stays a
            # clean numerics signal
            "fallbacks_injected": 0,
            "refine_iters_total": 0,
            "precision_paths": {k: 0 for k in PRECISION_PATHS},
            "quarantines": 0,
            "requeued_on_quarantine": 0,
            "errors": {k: 0 for k in ERROR_KINDS},
        }

    @staticmethod
    def now() -> float:
        """The service's deadline clock (:func:`time.monotonic`).

        Deadlines are absolute stamps on this clock:
        ``submit(..., deadline=SolveService.now() + budget_s)``.
        """
        return time.monotonic()

    def _on_stream(self, dev: int):
        """Run the block on stream ``dev``'s CUDA stream (a no-op on the CPU)."""
        s = self._streams[dev]
        return contextlib.nullcontext() if s is None else torch.cuda.stream(s)

    def _on_build_stream(self, dev: int):
        """Run the block on the build stream of stream ``dev``'s card."""
        s = self._build_streams.get(self.devices[dev])
        return contextlib.nullcontext() if s is None else torch.cuda.stream(s)

    # ------------------------------------------------------------ intake
    def pad_to(self, n: int) -> int:
        for size in self.pad_sizes:
            if n <= size:
                return size
        return n + (-n) % PAD_QUANTUM

    def _bucket_n(self, ticket: SolveTicket) -> int:
        """The bucket size: exact ``n`` for settling requests (settle
        metrics describe the whole circuit, pad nodes included), the
        padding grid otherwise."""
        if ticket.sig.compute_settling:
            return ticket.n
        return self.pad_to(ticket.n)

    def submit(
        self,
        a,
        b,
        *,
        method: str = "analog_2n",
        opamp: str | OpAmpSpec = "AD712",
        nonideal: NonIdealities | None = None,
        d_policy: str = "proposed",
        beta: float = 0.5,
        alpha: float = 1.0,
        compute_settling: bool = False,
        settle_method: str = "auto",
        settle_max_steps: int = 200_000,
        settle_dt_policy: str = "diag",
        sweep_dtype: str = "float32",
        tol: float = 1e-10,
        max_iter: int = 10000,
        x0=None,
        priority: int = 0,
        deadline: float | None = None,
    ) -> int:
        """Queue one system; returns the request id.

        Nothing is solved until :meth:`drain`: submission validates
        shapes, records the batch-compatibility signature and stamps the
        admission order.  ``x0`` ((n,)) warm-starts the settle sweep; it
        does not affect bucketing.
        """
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if a.ndim != 2 or a.shape[0] != a.shape[1] or b.shape != (a.shape[0],):
            raise ValueError(f"expected (n, n) and (n,); got {a.shape}, {b.shape}")
        if sweep_dtype not in SWEEP_DTYPES:
            raise ValueError(
                f"unknown sweep_dtype {sweep_dtype!r}: expected one of "
                f"{SWEEP_DTYPES}"
            )
        if x0 is not None:
            x0 = np.asarray(x0, dtype=np.float64)
            if x0.shape != b.shape or not np.isfinite(x0).all():
                # a malformed warm start must not poison the sweep
                raise ValueError(
                    f"x0 must be a finite ({a.shape[0]},) array"
                )
        if method not in ANALOG_METHODS + DIGITAL_METHODS:
            raise ValueError(
                f"unknown method {method!r}: expected one of "
                f"{ANALOG_METHODS + DIGITAL_METHODS}"
            )
        if isinstance(opamp, str):
            if opamp not in OPAMPS:
                raise ValueError(f"unknown opamp {opamp!r}")
            opamp = OPAMPS[opamp]
        sig = SolveSignature(
            method=method,
            opamp=opamp,
            d_policy=d_policy,
            beta=beta,
            alpha=alpha,
            compute_settling=compute_settling,
            settle_method=settle_method,
            settle_max_steps=settle_max_steps,
            settle_dt_policy=settle_dt_policy,
            sweep_dtype=sweep_dtype,
            tol=tol,
            max_iter=max_iter,
            nonideal=nonideal,
        ).normalized()
        rid = self._next_rid
        self._next_rid += 1
        self.queue.push(
            SolveTicket(rid=rid, a=a, b=b, sig=sig, x0=x0),
            priority=priority, deadline=deadline,
        )
        return rid

    # ---------------------------------------------------------- dispatch
    def _bucket_key(self, ticket: SolveTicket) -> tuple:
        return (self._bucket_n(ticket), ticket.sig)

    def _bucket_pattern(
        self,
        pipe: _BucketPipeline,
        a_pad: np.ndarray,
        b_pad: np.ndarray,
        dev: int,
    ) -> tuple[engine.StampPattern | None, list | None]:
        """The bucket's cached stamp pattern, re-derived only on a miss.

        ``analog_2n`` slot sets are normalized per ``(n, design)``, so
        after the first micro-batch this is a cache read; ``analog_n``
        buckets re-derive and ``pattern_merge`` only when a micro-batch
        stamps a slot the cached union lacks (an inactive stamped slot
        is an exact no-op).  The netlists built for the cover check are
        returned and handed to ``solve_batch_submit``, so each
        micro-batch builds them once, on the card's build stream.
        """
        sig = pipe.sig
        if sig.method not in ANALOG_METHODS:
            return None, None
        with self._on_build_stream(dev):
            nets = _build_nets(
                a_pad, b_pad, sig.method, d_policy=sig.d_policy,
                beta=sig.beta, alpha=sig.alpha, params=self.params,
                device=self.devices[dev],
            )
        if pipe.pattern is not None and engine.pattern_covers(pipe.pattern, nets):
            return pipe.pattern, nets
        union = engine.pattern_union(nets, sig.opamp)
        pipe.pattern_derivations += 1
        if pipe.pattern is None:
            pipe.pattern = union
        else:
            pipe.pattern = engine.pattern_merge(pipe.pattern, union)
            pipe.pattern_rebuilds += 1
        return pipe.pattern, nets

    def _dispatch_micro_batch(
        self, pipe: _BucketPipeline, tickets: list[SolveTicket], dev: int
    ) -> _InFlight:
        """Host phase of one micro-batch + asynchronous dispatch on stream ``dev``.

        Returns without waiting for the card.  An armed fault injector
        draws once per dispatch: ``build_error`` raises out of the host
        phase, the other kinds are planted into the returned handle so
        they surface at harvest where real ones would.
        """
        t_build = time.perf_counter()
        fault = (
            None if self.fault_injector is None
            else self.fault_injector.draw(dev=dev)
        )
        # sync_scope: a host copy in here is a dispatch-phase sync —
        # the runtime gate requires none
        try:
            with sync_scope("dispatch"):
                if fault is not None:
                    self.fault_injector.build_fault(fault)  # raises build_error
                sig = pipe.sig
                n_real = len(tickets)
                fill = self.batch_slots - n_real
                rhs = "zero" if sig.method in DIGITAL_METHODS else "supply"
                padded = [pad_system(t.a, t.b, pipe.n_pad, rhs=rhs) for t in tickets]
                padded += [padded[-1]] * fill    # repeat-fill to fixed shape
                a_stack = np.stack([p[0] for p in padded])
                b_stack = np.stack([p[1] for p in padded])

                settle_x0 = None
                if sig.method in ANALOG_METHODS and any(t.x0 is not None for t in tickets):
                    # warm-start stack: a cold ticket's row is the zero initial
                    # state; warm pad entries sit at the known pad solution
                    rows = []
                    for t in tickets:
                        row = np.zeros(pipe.n_pad, dtype=np.float64)
                        if t.x0 is not None:
                            row[: t.n] = t.x0
                            row[t.n:] = PAD_SOLUTION_V
                        rows.append(row)
                    rows += [rows[-1]] * fill
                    settle_x0 = np.stack(rows)

                pattern, nets = self._bucket_pattern(pipe, a_stack, b_stack, dev)
                with self._on_stream(dev):
                    pending = solve_batch_submit(
                        a_stack,
                        b_stack,
                        method=sig.method,
                        opamp=sig.opamp,
                        nonideal=sig.nonideal,
                        nets=nets,
                        d_policy=sig.d_policy,
                        beta=sig.beta,
                        alpha=sig.alpha,
                        compute_settling=sig.compute_settling,
                        settle_method=sig.settle_method,
                        settle_max_steps=sig.settle_max_steps,
                        settle_dt_policy=sig.settle_dt_policy,
                        tol=sig.tol,
                        max_iter=sig.max_iter,
                        fallback=self.fallback,
                        fallback_residual_tol=self.fallback_residual_tol,
                        refine=self.refine,
                        sweep_dtype=sig.sweep_dtype,
                        settle_x0=settle_x0,
                        pattern=pattern,
                        device=self.devices[dev],
                    )
        finally:
            self._host_build_s += time.perf_counter() - t_build
        if fault is not None:
            pending = self.fault_injector.arm(pending, fault)
        pipe.micro_batches += 1
        pipe.systems += n_real
        pipe.fill_slots += fill
        return _InFlight(
            pipe=pipe, tickets=tickets, pending=pending, dev=dev, injected=fault,
        )

    def _unpack_micro_batch(
        self, pipe, tickets, batch, injected: str | None = None
    ) -> list[tuple[SolveTicket, str, str]]:
        """Per-ticket results from one harvested micro-batch, vectorized.

        One batched slice (and ``tolist``) per result field and per
        ``info`` key; ``x`` rows are views into the micro-batch array,
        trimmed to each ticket's ``n``.  Delivery acceptance runs here: a
        non-finite solution returns as ``("nonfinite", ...)`` for the
        retry machinery; an uncertified settling result whose residual
        overflows with fallback disabled as ``("uncertified", ...)``; an
        ``"unrefined"`` precision path as ``("unrefined", ...)``.  The
        rest is delivered, with fallbacks (``fallbacks_injected`` when the
        dispatch carried injected corruption), precision paths and
        refinement passes counted.
        """
        n_real = len(tickets)
        xs = np.asarray(batch.x)
        stable = np.asarray(batch.stable)[:n_real].tolist()
        settle = (
            None if batch.settle_time is None
            else np.asarray(batch.settle_time)[:n_real].tolist()
        )
        cols: dict[str, list] = {}
        shared: dict[str, Any] = {}
        for key, v in batch.info.items():
            if isinstance(v, np.ndarray) and v.ndim >= 1:
                cols[key] = v[:n_real].tolist()
            else:
                # a scalar shared by the batch, normalized as
                # BatchSolveResult.__getitem__ does
                shared[key] = batch._info_entry(v, 0)
        bad: list[tuple[SolveTicket, str, str]] = []
        for i, ticket in enumerate(tickets):
            info = {k: (cols[k][i] if k in cols else shared[k]) for k in batch.info}
            x = xs[i, : ticket.n]
            if not np.isfinite(x).all():
                bad.append((ticket, "nonfinite", "solution carried NaN/Inf"))
                continue
            if info.get("precision_path") == "unrefined":
                rel = info.get("residual", float("nan"))
                bad.append((
                    ticket, "unrefined",
                    f"refinement stalled at rel residual {rel:.3e} "
                    f"after {info.get('refine_iters', 0)} inner solve(s), "
                    "fallback disabled",
                ))
                continue
            if info.get("settle_certified") is False:
                r = ticket.a @ x - ticket.b
                rel = float(
                    np.linalg.norm(r)
                    / max(np.linalg.norm(ticket.b), np.finfo(np.float64).tiny)
                )
                if rel > self.fallback_residual_tol and not info.get("fallback"):
                    bad.append((
                        ticket, "uncertified",
                        f"settle uncertified, rel residual {rel:.3e}",
                    ))
                    continue
            if info.get("fallback"):
                key = "fallbacks_injected" if injected == "nonfinite" else "fallbacks"
                self._counters[key] += 1
            path = info.get("precision_path")
            if path is not None:
                self._counters["precision_paths"][path] += 1
                self._counters["refine_iters_total"] += int(info.get("refine_iters", 0))
            info["service_n_padded"] = pipe.n_pad
            info["service_batch_slots"] = self.batch_slots
            ticket.result = SolveResult(
                x=x,
                method=batch.method,
                stable=bool(stable[i]),
                settle_time=None if settle is None else float(settle[i]),
                info=info,
            )
            self._real_sq += float(ticket.n) ** 2
        return bad

    # ------------------------------------------------- failure machinery
    def _fail(self, ticket: SolveTicket, kind: str, detail: str, out) -> None:
        """Terminal: deliver a structured error in the result slot."""
        err = SolveError(kind=kind, attempts=ticket.attempts, detail=detail)
        ticket.result = err
        out[ticket.rid] = err
        self._counters["errors"][kind] += 1

    def _admit_ticket(self, ticket: SolveTicket, out) -> bool:
        """Pop-time gate: re-deliver already-terminal tickets, reject
        expired deadlines (never dispatched).  True = dispatchable."""
        if ticket.result is not None:
            # answered in an interrupted drain: re-deliver, don't redo
            out[ticket.rid] = ticket.result
            return False
        if ticket.deadline is not None and self.now() >= ticket.deadline:
            self._counters["deadline_expired"] += 1
            self._fail(ticket, "deadline_expired", "deadline passed before dispatch", out)
            return False
        return True

    def _group_failed(
        self, pipe, group, exc: Exception, *, device_side: bool, work, out
    ) -> None:
        """One micro-batch raised: bisect groups, charge singletons.

        A group of more than one ticket splits in half and both halves
        re-dispatch at the front of the work queue (no blame).  A
        singleton's retry budget is charged; at ``max_attempts`` it fails
        fast with ``device_fault`` (the stream's solve raised) or
        ``poison`` (its own host build raised).
        """
        if len(group) > 1:
            self._counters["bisections"] += 1
            mid = (len(group) + 1) // 2
            work.appendleft((pipe, group[mid:]))
            work.appendleft((pipe, group[:mid]))
            return
        ticket = group[0]
        ticket.attempts += 1
        kind = "device_fault" if device_side else "poison"
        if ticket.attempts >= self.max_attempts:
            detail = f"{type(exc).__name__}: {exc}"
            self._fail(ticket, kind, detail[:200], out)
        else:
            self._counters["retries"] += 1
            work.appendleft((pipe, [ticket]))

    def _quarantine(self, dev: int, inflight, per_dev, work) -> None:
        """A stream tripped open: pull its in-flight micro-batches and
        re-queue their tickets (blameless) at the front of the work queue."""
        self._counters["quarantines"] += 1
        stuck = [f for f in inflight if f.dev == dev]
        for flight in reversed(stuck):
            inflight.remove(flight)
            per_dev[dev] -= 1
            self._counters["requeued_on_quarantine"] += len(flight.tickets)
            work.appendleft((flight.pipe, flight.tickets))

    def _next_stream(self, per_dev) -> int | None:
        """Round-robin over streams with a free in-flight slot that the
        circuit breaker admits (closed, or due for a half-open probe)."""
        n_dev = len(self.devices)
        for k in range(n_dev):
            dev = (self._rr + k) % n_dev
            if per_dev[dev] < self.inflight_per_device and self.breaker.acquire(dev):
                self._rr = (dev + 1) % n_dev
                return dev
        return None

    def _harvest(self, flight: _InFlight, out, per_dev, work, inflight, finishing) -> None:
        """Block on one in-flight micro-batch's device phase (``wait_dc``
        on its stream), then deliver it or queue its deferred finish.

        A clean DC harvest releases the stream slot and records a breaker
        success; a device-side exception feeds the stream's breaker
        (tripping it quarantines the stream) and the group-failure
        machinery.
        """
        t_wait = time.perf_counter()
        try:
            with self._on_stream(flight.dev), sync_scope("harvest"):
                batch = flight.pending.wait_dc()
        except Exception as exc:
            self._device_wait_s += time.perf_counter() - t_wait
            per_dev[flight.dev] -= 1
            tripped = self.breaker.record_failure(flight.dev)
            self._group_failed(
                flight.pipe, flight.tickets, exc, device_side=True, work=work, out=out,
            )
            if tripped:
                self._quarantine(flight.dev, inflight, per_dev, work)
            return
        self._device_wait_s += time.perf_counter() - t_wait
        per_dev[flight.dev] -= 1
        self.breaker.record_success(flight.dev)
        if flight.pending.split:
            finishing.append(flight)
            return
        self._deliver(flight, batch, out, work)

    def _finish_flight(self, flight: _InFlight, out, work) -> None:
        """Run a deferred finish phase (settle sweep, recovery, fallback)
        on the flight's stream and deliver.

        The stream already did its job, so a finish-phase exception is
        charged to the ticket group, never to the stream's breaker.
        """
        t_finish = time.perf_counter()
        try:
            with self._on_stream(flight.dev), sync_scope("finish"):
                batch = flight.pending.wait()
        except Exception as exc:
            self._settle_finish_s += time.perf_counter() - t_finish
            self._group_failed(
                flight.pipe, flight.tickets, exc, device_side=True, work=work, out=out,
            )
            return
        self._settle_finish_s += time.perf_counter() - t_finish
        self._deliver(flight, batch, out, work)

    def _deliver(self, flight: _InFlight, batch, out, work) -> None:
        """Delivery acceptance for one harvested micro-batch: unpack,
        hand out terminal answers, route rejected tickets to retry."""
        t_unpack = time.perf_counter()
        with sync_scope("unpack"):
            bad = self._unpack_micro_batch(
                flight.pipe, flight.tickets, batch, injected=flight.injected
            )
        self._unpack_s += time.perf_counter() - t_unpack
        for t in flight.tickets:
            if t.result is not None:
                out[t.rid] = t.result
        retry: list[SolveTicket] = []
        for ticket, kind, detail in bad:
            ticket.attempts += 1
            if kind in ("uncertified", "unrefined") or ticket.attempts >= self.max_attempts:
                # uncertified/unrefined are deterministic: retrying cannot help
                self._fail(ticket, kind, detail, out)
            else:
                self._counters["retries"] += 1
                retry.append(ticket)
        if retry:
            work.appendleft((flight.pipe, retry))

    def drain(self) -> dict[int, SolveResult | SolveError]:
        """Answer everything queued; returns ``{rid: result-or-error}``.

        Tickets leave the queue in admission order (shedding the
        over-depth excess, rejecting expired deadlines) and group into
        buckets; each bucket's micro-batches go to breaker-admitted
        streams round-robin.  A stream holding ``inflight_per_device``
        micro-batches back-pressures the scheduler: the oldest in-flight
        micro-batch is harvested before the next host build.  Failures
        never raise out of here; every admitted ticket is answered
        exactly once.  Results are handed to the caller and not retained.

        Only an unexpected exception propagates; then every popped
        ticket is re-queued at its original admission rank (answered
        ones re-deliver from their result slot on the next drain).
        """
        t0 = time.perf_counter()
        popped = self.queue.pop_all()
        if not popped:
            return {}
        out: dict[int, SolveResult | SolveError] = {}

        queued = popped
        if self.max_queue_depth is not None and len(queued) > self.max_queue_depth:
            # load shedding: the lowest admission rank drops first
            queued, shed = queued[: self.max_queue_depth], queued[self.max_queue_depth:]
            self._counters["shed"] += len(shed)
            for ticket in shed:
                self._fail(ticket, "shed", f"queue depth over {self.max_queue_depth}", out)

        buckets: dict[tuple, list[SolveTicket]] = {}
        for ticket in queued:
            buckets.setdefault(self._bucket_key(ticket), []).append(ticket)

        # fixed-shape micro-batch groups, bucket-major in admission order
        # of each bucket's head request; retries and bisections re-enter
        # at the front so old work finishes first
        work: collections.deque = collections.deque()
        for key, tickets in buckets.items():
            n_pad, sig = key
            pipe = self._pipelines.setdefault(key, _BucketPipeline(n_pad=n_pad, sig=sig))
            for start in range(0, len(tickets), self.batch_slots):
                work.append((pipe, tickets[start:start + self.batch_slots]))

        inflight: list[_InFlight] = []          # dispatch-FIFO harvest order
        finishing: list[_InFlight] = []         # DC done, finish phase due
        per_dev = [0] * len(self.devices)
        # deterministic placement per drain: identical request streams
        # land on identical (bucket, stream) pairs every drain
        self._rr = 0
        try:
            while work or inflight or finishing:
                if work:
                    pipe, group = work.popleft()
                    group = [t for t in group if self._admit_ticket(t, out)]
                    if not group:
                        continue
                    dev = self._next_stream(per_dev)
                    if dev is not None:
                        try:
                            flight = self._dispatch_micro_batch(pipe, group, dev)
                        except Exception as exc:
                            # host build failure: no device verdict, so a
                            # consumed probe slot goes back unjudged
                            self.breaker.release(dev)
                            self._group_failed(
                                pipe, group, exc, device_side=False, work=work, out=out,
                            )
                        else:
                            inflight.append(flight)
                            per_dev[dev] += 1
                        continue
                    work.appendleft((pipe, group))
                if inflight:
                    self._harvest(inflight.pop(0), out, per_dev, work, inflight, finishing)
                elif finishing:
                    # streams idle (or blocked): run deferred finish phases
                    self._finish_flight(finishing.pop(0), out, work)
                elif work:
                    # every stream quarantined with backoff pending:
                    # degrade to probing, never to a deadlock
                    self.breaker.force_probe()
        except BaseException:
            # the caller receives nothing: put every popped ticket back at
            # its original admission rank, then re-raise
            self.queue.requeue(popped)
            self._wall_s += time.perf_counter() - t0
            raise
        self._wall_s += time.perf_counter() - t0
        return out

    # ----------------------------------------------------------- sessions
    def session(self, **opts) -> "SolveSession":
        """Open a multi-round ticket kind on this service (see
        :class:`SolveSession` for ``opts``)."""
        return SolveSession(self, **opts)

    # ------------------------------------------------------------- stats
    @property
    def stats(self) -> dict[str, Any]:
        """Service counters, as the reference's.

        ``pad_overhead`` is ``sum((systems + fill_slots) * n_pad^2) /
        sum(n^2)``.  ``host_build_s`` / ``device_wait_s`` /
        ``settle_finish_s`` / ``unpack_s`` decompose ``wall_s``:
        ``device_wait_s`` is the DC-phase device time the host phases
        could not hide, ``settle_finish_s`` the deferred finish phases.
        ``pattern_derivations`` counts ``pattern_union`` calls per bucket.
        The fault counters (``retries``, ``bisections``, ``shed``,
        ``deadline_expired``, ``quarantines``, ``requeued_on_quarantine``,
        ``fallbacks``, ``fallbacks_injected``, per-kind ``errors``,
        ``fault_injections``, the ``breaker`` snapshot) and the precision
        contract (``precision_paths``, ``refine_iters_total``) ride along.
        """
        per_bucket = {}
        pad_sq = 0.0
        total = fills = 0
        for (n_pad, sig), pipe in self._pipelines.items():
            base = key = f"n{n_pad}/{sig.method}"
            suffix = 2
            while key in per_bucket:     # same (n_pad, method), other sig
                key = f"{base}#{suffix}"
                suffix += 1
            per_bucket[key] = {
                "micro_batches": pipe.micro_batches,
                "systems": pipe.systems,
                "fill_slots": pipe.fill_slots,
                "pattern_derivations": pipe.pattern_derivations,
                "pattern_rebuilds": pipe.pattern_rebuilds,
            }
            total += pipe.systems
            fills += pipe.fill_slots
            pad_sq += (pipe.systems + pipe.fill_slots) * float(n_pad) ** 2
        real_sq = self._real_sq
        c = self._counters
        return {
            "requests": total,
            "fill_slots": fills,
            "buckets": per_bucket,
            "pad_overhead": pad_sq / real_sq if real_sq else 1.0,
            "wall_s": self._wall_s,
            "host_build_s": self._host_build_s,
            "device_wait_s": self._device_wait_s,
            "settle_finish_s": self._settle_finish_s,
            "unpack_s": self._unpack_s,
            "devices": len(self.devices),
            "inflight_per_device": self.inflight_per_device,
            "batch_slots": self.batch_slots,
            "retries": c["retries"],
            "bisections": c["bisections"],
            "shed": c["shed"],
            "deadline_expired": c["deadline_expired"],
            "fallbacks": c["fallbacks"],
            "fallbacks_injected": c["fallbacks_injected"],
            "refine_iters_total": c["refine_iters_total"],
            "precision_paths": dict(c["precision_paths"]),
            "quarantines": c["quarantines"],
            "requeued_on_quarantine": c["requeued_on_quarantine"],
            "errors": dict(c["errors"]),
            "fault_injections": (
                0 if self.fault_injector is None
                else self.fault_injector.stats()["total_injected"]
            ),
            "breaker": self.breaker.stats(),
        }


class SessionRoundError(RuntimeError):
    """One or more tickets of a session round failed terminally.

    Raised by :meth:`SolveSession.solve_round` after the round's drain
    answered every ticket.  ``errors`` maps the round's batch index to
    its :class:`SolveError`; ``x`` holds the round's solutions with the
    failed rows NaN.
    """

    def __init__(self, round_index: int, errors: dict, x: np.ndarray):
        kinds = sorted({e.kind for e in errors.values()})
        super().__init__(
            f"session round {round_index}: {len(errors)} ticket(s) failed "
            f"terminally ({', '.join(kinds)})"
        )
        self.round_index = round_index
        self.errors = errors
        self.x = x


class SolveSession:
    """Multi-round ticket kind: one iterative client's rounds of solves.

    A round is a batch of B systems that must all resolve before the
    client forms its next round (a Newton/SQP iteration's linearized
    systems, :mod:`repro_torch.optim.batched_newton`).  Each
    :meth:`solve_round` submits the round as ordinary tickets (shared
    ``priority``, one fresh deadline from ``round_deadline_s``) into the
    service's bucketed pipelines and drains; the pipelines, and so the
    stamp patterns, persist across rounds.  It satisfies the ``rounds=``
    executor protocol: ``solve_round(a, b) -> x`` plus the
    ``solve_rounds`` / ``pattern_derivations`` counters.

    Options beyond the service are the per-round submit options
    (``method``, ``opamp``, ``nonideal``, ...), ``priority``,
    ``round_deadline_s`` and ``warm_start`` (the previous round's
    solutions seed the next round's settle sweep as ``x0``; a round with
    terminal failures never seeds one).  ``settle_steps_by_round``
    records each round's mean settle steps (None without them);
    ``warm_submits`` counts tickets that carried an ``x0``.
    """

    def __init__(
        self,
        service: SolveService,
        *,
        priority: int = 0,
        round_deadline_s: float | None = None,
        warm_start: bool = False,
        **submit_opts,
    ):
        self.service = service
        self.priority = int(priority)
        self.round_deadline_s = None if round_deadline_s is None else float(round_deadline_s)
        self.warm_start = bool(warm_start)
        self.submit_opts = submit_opts
        self.rounds = 0              # rounds completed (or failed terminally)
        self.systems = 0             # tickets submitted across rounds
        self.warm_submits = 0        # tickets submitted with a warm start
        self.settle_steps_by_round: list[float | None] = []
        self._last_x: np.ndarray | None = None
        # interleaved one-shot traffic answered by this session's drains
        self.other_results: dict[int, SolveResult | SolveError] = {}

    # the batched_newton rounds-protocol counters
    @property
    def solve_rounds(self) -> int:
        return self.rounds

    @property
    def pattern_derivations(self) -> int:
        """Stamp patterns the service derived since it started, over all
        its buckets (the session's own count when it is the only analog
        client)."""
        return sum(p.pattern_derivations for p in self.service._pipelines.values())

    def solve_round(self, a, b) -> np.ndarray:
        """Submit one round of ``(B,)`` systems and block for all B.

        ``a`` is (B, n, n), ``b`` (B, n); returns the (B, n) solutions
        in submission order.  Raises :class:`SessionRoundError` if any
        ticket of the round failed terminally.
        """
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if a.ndim != 3 or b.ndim != 2 or a.shape[:2] != b.shape:
            raise ValueError(f"expected (B, n, n) and (B, n); got {a.shape}, {b.shape}")
        deadline = (
            None if self.round_deadline_s is None
            else self.service.now() + self.round_deadline_s
        )
        warm = (
            self.warm_start
            and self._last_x is not None
            and self._last_x.shape == b.shape
        )
        rids = [
            self.service.submit(
                a[k], b[k],
                x0=self._last_x[k] if warm else None,
                priority=self.priority, deadline=deadline,
                **self.submit_opts,
            )
            for k in range(a.shape[0])
        ]
        if warm:
            self.warm_submits += len(rids)
        out = self.service.drain()
        x = np.full_like(b, np.nan)
        errors: dict[int, SolveError] = {}
        steps: list[float] = []
        for k, rid in enumerate(rids):
            res = out.pop(rid)
            if isinstance(res, SolveError):
                errors[k] = res
            else:
                x[k] = res.x
                s = res.info.get("settle_steps")
                if s is not None:
                    steps.append(float(s))
        self.settle_steps_by_round.append(float(np.mean(steps)) if steps else None)
        # answers for tickets other clients queued on the same service
        self.other_results.update(out)
        index = self.rounds
        self.rounds += 1
        self.systems += len(rids)
        if errors:
            # NaN rows of a partial round must not seed the next sweep
            self._last_x = None
            raise SessionRoundError(index, errors, x)
        if self.warm_start:
            self._last_x = x
        return x
