"""Runtime contract gates: build counting and host-sync attribution.

Counterpart of :mod:`repro.analysis.runtime`.  The static rules
(:mod:`repro_torch.analysis.rules`) claim two steady-state invariants
the service's throughput depends on; this module makes them falsifiable
at run time:

* **zero post-warmup builds** — :class:`BuildWatch` is the counterpart
  of the reference's ``CompileWatch``.  The port has no jit: what it
  compiles at run time is the ``nvcc`` build of the kernel library
  (:func:`repro_torch.kernels.build.load_library`; the watch counts the
  build itself, not the cached return), and, where code asks for them,
  ``torch.compile`` calls and CUDA graph captures
  (``CUDAGraph.capture_begin``).  The reference's scan of compiled HLO
  for host callbacks (``roofline.hlo_parse.host_callback_ops``) has no
  counterpart: a CUDA kernel cannot call back into Python.
* **zero dispatch-phase host syncs** — :class:`SyncWatch` counts host
  copies of tensors on the watched device type, attributed to the phase
  label the service declares with :func:`sync_scope` (``dispatch`` /
  ``harvest`` / ``finish`` / ``unpack`` / ``settle_poll`` /
  ``net_build``).  It patches the Python entry points: the ``Tensor``
  conversions (``item``, ``tolist``, ``numpy``, ``cpu``, ``__array__``,
  ``__float__``, ``__int__``, ``__bool__``, ``to`` towards the host)
  and the explicit waits (``torch.cuda.synchronize``,
  ``Stream.synchronize``, ``Event.synchronize``).  Copies made inside
  ATen (``nonzero``, boolean masks, ``linalg`` info checks) never pass
  through those; on a card the watch also turns on
  ``torch.cuda.set_sync_debug_mode("warn")`` and records each warning
  under the label current when it fires (``aten_counts``).  The gate
  asserts ``dispatch == 0`` *and* that the harvest-side phases counted
  syncs, so a dead counter cannot pass.

:func:`run_service_gate` is the smoke drain: warm a
:class:`~repro_torch.serving.solve_service.SolveService` on a mixed
workload, drain the identical workload again under both watches, and
require zero builds and zero dispatch-phase syncs.
"""

from __future__ import annotations

import contextlib
import sys
from collections import Counter
import warnings
from typing import Any, Iterator

import numpy as np
import torch

__all__ = ["BuildWatch", "SyncWatch", "sync_scope", "run_service_gate"]


# --------------------------------------------------------------- sync watch

# the scope-label stack the instrumented service pushes phases onto;
# index 0 is the ambient (unattributed) label
_SCOPE_STACK: list[str] = ["ambient"]


@contextlib.contextmanager
def sync_scope(label: str) -> Iterator[None]:
    """Attribute host syncs inside the block to ``label``; the innermost
    label wins.

    Near-zero overhead when no :class:`SyncWatch` is installed (a list
    push/pop per block), so the service keeps its phases labeled
    unconditionally.
    """
    _SCOPE_STACK.append(label)
    try:
        yield
    finally:
        _SCOPE_STACK.pop()


# Tensor methods that copy a tensor's value to the host
_TENSOR_SYNCS = ("item", "tolist", "numpy", "cpu", "__array__", "__float__",
                 "__int__", "__bool__")
# the text of torch's warning under set_sync_debug_mode("warn")
_ATEN_SYNC_TEXT = "synchronizing"


def _patch(saved: list, obj: Any, attr: str, make) -> None:
    """Replace ``obj.attr`` by ``make(original)``; ``saved`` remembers how
    to undo it (an attribute ``obj`` only inherited is deleted again)."""
    orig = getattr(obj, attr)
    saved.append((obj, attr, orig, attr in vars(obj)))
    setattr(obj, attr, make(orig))


def _restore(saved: list) -> None:
    for obj, attr, orig, own in reversed(saved):
        if own:
            setattr(obj, attr, orig)
        else:
            delattr(obj, attr)
    saved.clear()


def _to_host(args, kwargs) -> bool:
    """Whether ``Tensor.to(*args, **kwargs)`` targets the host."""
    target = kwargs.get("device")
    if target is None and args:
        first = args[0]
        if isinstance(first, torch.Tensor):
            target = first.device
        elif isinstance(first, (str, torch.device, int)):
            target = first
    if target is None or isinstance(target, int):
        return False         # a dtype-only cast, or a card ordinal
    return torch.device(target).type == "cpu"


class SyncWatch:
    """Context manager counting host copies per sync scope.

    ``counts`` maps a scope label to the host copies of tensors on
    ``device_type`` observed inside that scope, and ``calls`` lists
    ``(label, entry point)`` in order.  ``device_type="cpu"`` counts CPU
    tensors, which makes the counter live on a machine without a card
    (a ``.cpu()`` of a CPU tensor copies nothing, but runs the same code
    path).  A reentrancy flag keeps nested conversions (``__array__``
    calling ``numpy``) from counting twice.

    With ``device_type="cuda"`` and a card, the watch also sets
    ``torch.cuda.set_sync_debug_mode("warn")``: ``aten_counts`` /
    ``aten_calls`` hold each synchronizing ATen operation by label, with
    the Python line that issued it.  Those include the patched entry
    points' own syncs, and the copies inside ATen they cannot see.
    """

    _active: "SyncWatch | None" = None

    def __init__(self, *, device_type: str = "cuda") -> None:
        self.device_type = device_type
        self.counts: dict[str, int] = {}
        self.calls: list[tuple[str, str]] = []      # (scope, entry point)
        self.aten_counts: dict[str, int] = {}
        self.aten_calls: list[tuple[str, str]] = []  # (scope, "file:line")
        self._saved: list = []
        self._in_count = False
        self._site = ""             # the caller of the entry point being counted
        self._warnings: contextlib.ExitStack | None = None
        self._showwarning = None
        self._debug_mode: int | None = None

    def total(self, *labels: str) -> int:
        if not labels:
            return sum(self.counts.values())
        return sum(self.counts.get(l, 0) for l in labels)

    def _record(self, entry: str) -> None:
        scope = _SCOPE_STACK[-1]
        self.counts[scope] = self.counts.get(scope, 0) + 1
        self.calls.append((scope, entry))

    def _counted(self, entry: str, fn, *args, **kwargs):
        """Record ``entry`` and run ``fn``; conversions that ``fn`` makes
        itself (``__array__`` calling ``numpy``) are not counted again."""
        if self._in_count:
            return fn(*args, **kwargs)
        self._in_count = True
        caller = sys._getframe(2)       # _counted <- the patched method <- caller
        self._site = f"{caller.f_code.co_filename}:{caller.f_lineno}"
        try:
            self._record(entry)
            return fn(*args, **kwargs)
        finally:
            self._in_count = False

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        if _ATEN_SYNC_TEXT in str(message):
            scope = _SCOPE_STACK[-1]
            self.aten_counts[scope] = self.aten_counts.get(scope, 0) + 1
            # a sync inside a counted entry point is its caller's
            where = self._site if filename == __file__ else f"{filename}:{lineno}"
            self.aten_calls.append((scope, where))
        elif self._showwarning is not None:
            self._showwarning(message, category, filename, lineno, file, line)

    def __enter__(self) -> "SyncWatch":
        if SyncWatch._active is not None:
            raise RuntimeError("SyncWatch is not re-entrant")
        watch = self
        device_type = self.device_type

        def counting_method(name, orig):
            def wrapped(self, *args, **kwargs):
                if self.device.type == device_type:
                    return watch._counted(f"Tensor.{name}", orig, self, *args, **kwargs)
                return orig(self, *args, **kwargs)
            return wrapped

        def counting_to(orig):
            def wrapped(self, *args, **kwargs):
                if self.device.type == device_type and _to_host(args, kwargs):
                    return watch._counted("Tensor.to", orig, self, *args, **kwargs)
                return orig(self, *args, **kwargs)
            return wrapped

        def counting_wait(name, orig):
            def wrapped(*args, **kwargs):
                return watch._counted(name, orig, *args, **kwargs)
            return wrapped

        for attr in _TENSOR_SYNCS:
            _patch(self._saved, torch.Tensor, attr,
                   lambda orig, a=attr: counting_method(a, orig))
        _patch(self._saved, torch.Tensor, "to", counting_to)
        _patch(self._saved, torch.cuda, "synchronize",
               lambda orig: counting_wait("torch.cuda.synchronize", orig))
        for cls in (torch.cuda.Stream, torch.cuda.Event):
            _patch(self._saved, cls, "synchronize",
                   lambda orig, c=cls: counting_wait(f"{c.__name__}.synchronize", orig))
        if device_type == "cuda" and torch.cuda.is_available():
            self._warnings = contextlib.ExitStack()
            self._warnings.enter_context(warnings.catch_warnings())
            warnings.simplefilter("always")
            self._showwarning = warnings.showwarning
            warnings.showwarning = self._on_warning
            self._debug_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        SyncWatch._active = self
        return self

    def __exit__(self, *exc) -> None:
        if self._debug_mode is not None:
            torch.cuda.set_sync_debug_mode(self._debug_mode)
            self._debug_mode = None
        if self._warnings is not None:
            self._warnings.close()          # restores showwarning and filters
            self._warnings = None
        _restore(self._saved)
        SyncWatch._active = None


# ------------------------------------------------------------ build watch


class BuildWatch:
    """Context manager counting run-time builds while active.

    ``events`` lists ``(kind, detail)``: ``("nvcc", library name)`` for
    each build of the kernel library (``kernels/build.py:_build``, which
    :func:`~repro_torch.kernels.build.load_library` runs only when no
    built library exists; a cached return counts nothing),
    ``("torch.compile", repr)`` for each ``torch.compile`` call and
    ``("cuda_graph", "capture_begin")`` for each CUDA graph capture.
    Re-entrant use is rejected (the patches are process-global).
    """

    _active: "BuildWatch | None" = None

    def __init__(self) -> None:
        self.events: list[tuple[str, str]] = []
        self._saved: list = []

    @property
    def count(self) -> int:
        return len(self.events)

    def __enter__(self) -> "BuildWatch":
        if BuildWatch._active is not None:
            raise RuntimeError("BuildWatch is not re-entrant")
        from repro_torch.kernels import build

        events = self.events

        def counting_build(orig):
            def wrapped(target, *args, **kwargs):
                events.append(("nvcc", getattr(target, "name", str(target))))
                return orig(target, *args, **kwargs)
            return wrapped

        def counting_compile(orig):
            def wrapped(*args, **kwargs):
                events.append(("torch.compile", repr(args[0]) if args else ""))
                return orig(*args, **kwargs)
            return wrapped

        def counting_capture(orig):
            def wrapped(*args, **kwargs):
                events.append(("cuda_graph", "capture_begin"))
                return orig(*args, **kwargs)
            return wrapped

        _patch(self._saved, build, "_build", counting_build)
        _patch(self._saved, torch, "compile", counting_compile)
        _patch(self._saved, torch.cuda.CUDAGraph, "capture_begin", counting_capture)
        BuildWatch._active = self
        return self

    def __exit__(self, *exc) -> None:
        _restore(self._saved)
        BuildWatch._active = None


# ------------------------------------------------------------- service gate


def _gate_workload(service, rng: np.random.Generator) -> list[int]:
    """The reference's small mixed-n / mixed-method workload;
    deterministic given rng."""
    rids = []
    for n, method in ((6, "analog_2n"), (10, "analog_2n"), (6, "analog_n"),
                      (12, "cholesky"), (6, "analog_2n"), (10, "cg")):
        m = rng.normal(size=(n, n))
        a = m @ m.T + n * np.eye(n)
        b = rng.normal(size=n)
        rids.append(service.submit(a, b, method=method))
    return rids


def run_service_gate(
    *, device: str | torch.device = "cuda", n_streams: int = 1, seed: int = 0,
) -> dict[str, Any]:
    """Smoke-drain contract gate over a live :class:`SolveService`.

    Drains one warmup pass (the kernel build allowed), then re-drains an
    identical workload under :class:`BuildWatch` + :class:`SyncWatch`
    (counting host copies of tensors on ``device``'s type) on
    ``n_streams`` streams of ``device``.  Returns a report dict with
    ``ok`` plus the evidence; the contract:

    * ``post_warmup_builds == 0`` — no library build, compile or graph
      capture after the warmup;
    * ``dispatch_syncs == 0`` — the dispatch phase never copies a device
      value to the host (host/device overlap is real);
    * ``harvest_syncs > 0`` — the counter is alive (falsifiability);
    * no ``SolveError`` in either drain.
    """
    from repro_torch.device import resolve_device
    from repro_torch.serving.solve_service import SolveService

    dev = resolve_device(device)
    service = SolveService(
        batch_slots=2, devices=[dev] * n_streams, inflight_per_device=2,
    )
    rng = np.random.default_rng(seed)
    _gate_workload(service, rng)
    warm = service.drain()

    # measured drain: identical workload through fresh tickets — builds
    # and dispatch-phase syncs must both be silent
    with BuildWatch() as builds, SyncWatch(device_type=dev.type) as sync:
        rng = np.random.default_rng(seed)
        _gate_workload(service, rng)
        out = service.drain()

    errors = [r for r in list(warm.values()) + list(out.values())
              if not hasattr(r, "x")]
    dispatch_syncs = sync.total("dispatch")
    harvest_syncs = sync.total("harvest", "finish", "unpack", "settle_poll")
    return {
        "ok": (
            builds.count == 0
            and dispatch_syncs == 0
            and harvest_syncs > 0
            and not errors
        ),
        "device": str(dev),
        "streams": n_streams,
        "post_warmup_builds": builds.count,
        "post_warmup_build_events": builds.events,
        "dispatch_syncs": dispatch_syncs,
        "dispatch_aten_syncs": sync.aten_counts.get("dispatch", 0),
        "harvest_syncs": harvest_syncs,
        "sync_counts": dict(sync.counts),
        "aten_sync_counts": dict(sync.aten_counts),
        "aten_sync_sites": dict(Counter(f"{scope} {where}" for scope, where in sync.aten_calls)),
        "solve_errors": len(errors),
        "tickets": len(warm) + len(out),
    }
