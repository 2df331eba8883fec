"""The port's PyTorch-discipline rules.

Counterpart of :mod:`repro.analysis.rules`, retargeted from JAX to
PyTorch on CUDA streams.  Static analysis is approximate by nature:
every rule documents its blind spots, and the runtime gate
(:mod:`repro_torch.analysis.runtime`) makes the load-bearing claim, no
host sync in the dispatch phase, falsifiable at run time.

How each reference rule carries over:

* **host-sync-in-hot-path** — retargeted: a PyTorch host sync is a
  ``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` /
  ``.to("cpu")``, a ``float()`` / ``int()`` / ``bool()`` of a computed
  value, ``np.asarray`` / ``np.array``, or a ``synchronize()`` (of
  ``torch.cuda``, a ``Stream`` or an ``Event``).
* **recompile-hazard** — retargeted.  The port has no jit: what it
  compiles at run time is the ``nvcc`` build of
  :func:`repro_torch.kernels.build.load_library` (once per process,
  counted at run time by :class:`~repro_torch.analysis.runtime.
  BuildWatch`) and, where code asks for it, ``torch.compile``,
  ``torch.jit.*`` and CUDA graph capture (``torch.cuda.graph``,
  ``torch.cuda.CUDAGraph``, ``capture_begin``,
  ``torch.cuda.make_graphed_callables``).  The rule flags those built
  inside a function body on the hot path, where each call would compile
  or capture afresh; module scope and ``__init__`` are exempt.  The
  port has none today, so the rule starts clean and guards the
  CUDA-graph work that is coming.  The reference's unhashable-static-
  argument and traced-branch checks have no PyTorch counterpart.
* **dtype-contract** — retargeted: bf16 casts (``.to``, ``.type``,
  ``.astype``, ``.bfloat16()``, ``dtype=``) outside the ``sweep_dtype``
  boundary, and any narrowing (``.float()``, ``.half()``,
  ``.to(torch.float32)``, ``dtype=torch.float32``, ...) in the strict
  float64 modules.
* **unlocked-shared-state**, **blocking-call-in-stream-loop** and
  **swallowed-error** — carried over unchanged; the port's
  ``AdmissionQueue``, ``FaultInjector`` and ``StreamBreaker`` each hold
  a ``threading.Lock``.
* **donation-after-use** — not ported: the port donates no buffer
  (PyTorch's caching allocator has no counterpart of JAX's
  ``donate_argnums``), so there is nothing to read after donation.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import (
    FileContext,
    Finding,
    Rule,
    calls_in,
    dotted_name,
    loops_in,
    walk_functions,
)

# tensor methods that copy to the host or wait for the device
_SYNC_METHODS = ("item", "tolist", "numpy", "cpu", "synchronize")
_SYNC_CALLS = ("np.asarray", "np.array", "numpy.asarray", "numpy.array")
# Python conversions that read a tensor's value on the host
_SCALAR_CASTS = ("float", "int", "bool")


def _is_host_device(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and dotted_name(node.func) == "torch.device":
        return bool(node.args) and _is_host_device(node.args[0])
    return False


def _is_host_copy(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device("cpu"))``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    targets = list(call.args[:1]) + [kw.value for kw in call.keywords if kw.arg == "device"]
    return any(_is_host_device(t) for t in targets)


class HostSyncInHotPath(Rule):
    """Host copies and device waits inside serving dispatch and drain loops.

    The dispatch side of the stream loop must never wait for the card:
    the overlap model (the host builds micro-batch ``i+1`` while the card
    solves ``i``) collapses if it does.  Host copies belong to the
    harvest/unpack helpers, which run after the deliberate ``wait_dc()``
    / ``wait()``.  The rule flags direct syncs inside ``for``/``while``
    bodies (and tests) of the configured hot functions; syncs reached
    through helper calls are the runtime gate's job.  It cannot tell a
    tensor from a numpy array: a ``float()`` of a host value is flagged
    too, and is suppressed inline with the reason.
    """

    name = "host-sync-in-hot-path"
    severity = "error"
    description = "host sync inside a serving dispatch/drain loop"
    default_options = {
        "modules": ("serving/",),
        "hot_functions": (
            "drain", "_next_stream", "_dispatch_micro_batch",
            "_admit", "step", "run",
        ),
    }

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.matches(self.options["modules"]):
            return
        hot = set(self.options["hot_functions"])
        for func, _stack in walk_functions(ctx.tree):
            if func.name not in hot:
                continue
            for loop in loops_in(func):
                for call in calls_in(loop):
                    name = dotted_name(call.func)
                    if name is None:
                        continue
                    leaf = name.rsplit(".", 1)[-1]
                    if name in _SYNC_CALLS or (
                        "." in name and leaf in _SYNC_METHODS
                    ) or _is_host_copy(call):
                        yield self.finding(
                            ctx, call,
                            f"{name}() forces a host sync inside the "
                            f"{func.name}() loop — copy after harvest, "
                            "not in the dispatch path",
                        )
                    elif name in _SCALAR_CASTS and call.args and not isinstance(
                        call.args[0], ast.Constant
                    ):
                        yield self.finding(
                            ctx, call,
                            f"{name}() on a computed value inside the "
                            f"{func.name}() loop waits for the card if the "
                            "operand is a CUDA tensor",
                        )


# calls that compile or capture: each names a fresh compile cache or graph
_COMPILE_CALLS = (
    "torch.compile", "torch.cuda.graph", "torch.cuda.CUDAGraph",
    "torch.cuda.make_graphed_callables",
)


def _is_compile_call(call: ast.Call) -> bool:
    name = dotted_name(call.func) or ""
    return (name in _COMPILE_CALLS or name.startswith("torch.jit.")
            or name.endswith(".capture_begin"))


class RecompileHazard(Rule):
    """A compile or a graph capture built inside a hot-path function body.

    ``torch.compile(...)``, ``torch.jit.*(...)``, ``torch.cuda.graph(...)``,
    ``torch.cuda.CUDAGraph()``, ``make_graphed_callables(...)`` and
    ``.capture_begin()`` called inside a function body: every call
    compiles or captures anew instead of replaying.  Module scope,
    ``__init__`` (once per instance) and the function's own decorators
    (run once at definition) are exempt.  A capture built once and cached
    by a helper is invisible here; :class:`~repro_torch.analysis.runtime.
    BuildWatch` counts captures and compiles at run time.
    """

    name = "recompile-hazard"
    severity = "error"
    description = "compile or graph capture built in steady-state code"
    default_options = {
        "modules": ("core/engine.py", "kernels/", "serving/"),
        "allowed_functions": ("__init__",),
    }

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.matches(self.options["modules"]):
            return
        allowed = set(self.options["allowed_functions"])
        for func, _stack in walk_functions(ctx.tree):
            if func.name in allowed:
                continue
            decorator_calls = {
                id(n) for dec in func.decorator_list for n in ast.walk(dec)
            }
            for call in calls_in(func):
                if id(call) in decorator_calls or not _is_compile_call(call):
                    continue
                yield self.finding(
                    ctx, call,
                    f"{dotted_name(call.func)}() inside {func.name}() "
                    "compiles or captures per call — build it once at "
                    "module scope or in __init__ and replay it",
                )


_NARROW_DTYPES = ("float32", "bfloat16", "float16")
# dtype aliases whose leaf name is not the dtype's
_DTYPE_ALIASES = {"torch.float": "float32", "torch.half": "float16"}
# argument-free tensor casts and the dtype each narrows to
_CAST_METHODS = {"float": "float32", "half": "float16", "bfloat16": "bfloat16"}


def _dtype_of(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    name = dotted_name(node)
    if name is None:
        return None
    return _DTYPE_ALIASES.get(name, name.rsplit(".", 1)[-1])


def _cast_dtype(call: ast.Call) -> str | None:
    """The narrow dtype a cast call converts to: ``x.to(dt)``,
    ``x.to(dtype=dt)``, ``x.type(dt)``, ``x.astype(dt)``, ``x.float()`` /
    ``.half()`` / ``.bfloat16()``; None for any other call or dtype."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in _CAST_METHODS and not call.args and not call.keywords:
        return _CAST_METHODS[attr]
    if attr not in ("to", "type", "astype"):
        return None
    cands = list(call.args) + [kw.value for kw in call.keywords if kw.arg == "dtype"]
    for c in cands:
        dt = _dtype_of(c)
        if dt in _NARROW_DTYPES:
            return dt
    return None


class DtypeContract(Rule):
    """Precision-boundary violations on the solve path.

    The solve path is float64 end to end; only the settle sweep drops
    precision, and bf16 exists solely as *storage* inside the sweep
    kernels with float32 accumulation (the ``sweep_dtype`` boundary).
    Two sub-checks:

    * **bf16-escape** — a bf16 cast or ``dtype=`` construction outside
      ``kernels/`` and the declared boundary functions.
    * **x64-narrowing** — a float32/16 or bf16 cast or ``dtype=``
      construction inside the declared float64 modules (the direct-solve
      / refinement layers), outside the boundary functions.

    A dtype held in a variable (``w_dtype = torch.bfloat16``) is
    invisible to both.
    """

    name = "dtype-contract"
    severity = "error"
    description = "precision narrowing outside the sweep_dtype boundary"
    default_options = {
        "modules": ("core/", "serving/", "kernels/"),
        # the sanctioned low-precision zone: the kernels package plus
        # the engine functions that feed it
        "boundary_modules": ("kernels/",),
        "boundary_functions": (
            "euler_settle_batch", "ell_transient_sweep", "transient_sweep",
        ),
        # modules with the strict everything-float64 contract
        "x64_modules": (
            "core/solver.py", "core/operating_point.py", "core/refine.py",
            "core/transform.py",
        ),
    }

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.matches(self.options["modules"]):
            return
        in_boundary_module = ctx.matches(self.options["boundary_modules"])
        strict_x64 = ctx.matches(self.options["x64_modules"])
        boundary_funcs = set(self.options["boundary_functions"])

        spans: list[tuple[int, int]] = []
        for func, _stack in walk_functions(ctx.tree):
            if func.name in boundary_funcs:
                spans.append((func.lineno, func.end_lineno or func.lineno))

        def in_boundary(node: ast.AST) -> bool:
            line = getattr(node, "lineno", 0)
            return any(lo <= line <= hi for lo, hi in spans)

        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or in_boundary(node):
                continue
            dt = _cast_dtype(node)
            if dt is not None:
                if dt == "bfloat16" and not in_boundary_module:
                    yield self.finding(
                        ctx, node,
                        "bf16 cast outside the sweep_dtype boundary — "
                        "bf16 is kernel storage only, with f32 "
                        "accumulation inside the sweep",
                    )
                elif strict_x64 and dt in _NARROW_DTYPES:
                    yield self.finding(
                        ctx, node,
                        f"{dt} cast in a float64 solve module — the direct/"
                        "refinement path is float64 end to end",
                    )
                continue
            for kw in node.keywords:
                if kw.arg != "dtype":
                    continue
                dt = _dtype_of(kw.value)
                if dt == "bfloat16" and not in_boundary_module:
                    yield self.finding(
                        ctx, node,
                        "dtype=bfloat16 construction outside the sweep_dtype "
                        "boundary — bf16 is kernel storage only",
                    )
                elif strict_x64 and dt in _NARROW_DTYPES:
                    yield self.finding(
                        ctx, node,
                        f"dtype={dt} construction in a float64 solve "
                        "module — the direct/refinement path is float64 "
                        "end to end",
                    )


_MUTATING_METHODS = (
    "append", "appendleft", "extend", "pop", "popleft", "clear",
    "remove", "add", "update", "insert", "setdefault",
)


def _self_root(node: ast.AST) -> bool:
    """Whether an attribute/subscript chain is rooted at ``self``."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return isinstance(node, ast.Name) and node.id == "self"


class UnlockedSharedState(Rule):
    """Un-locked mutation of state shared across service streams.

    ``AdmissionQueue``, ``StreamBreaker`` and ``FaultInjector`` are
    reachable from every stream's dispatch/harvest path; per-stream host
    threads would make their mutations races.  Mutating methods of the
    configured classes must run under ``with self._lock:`` (``__init__``
    is exempt — construction happens-before sharing).  Mutations through
    local aliases (``s = self._streams[d]; s.x += 1``) are visible to
    this rule only if the aliasing statement itself sits outside the
    lock.
    """

    name = "unlocked-shared-state"
    severity = "error"
    description = "shared stream-visible state mutated without a lock"
    default_options = {
        "modules": ("serving/", "distributed/"),
        "classes": ("AdmissionQueue", "StreamBreaker", "FaultInjector"),
        "exempt_methods": ("__init__",),
    }

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.matches(self.options["modules"]):
            return
        classes = set(self.options["classes"])
        exempt = set(self.options["exempt_methods"])
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.ClassDef) and node.name in classes):
                continue
            for method in node.body:
                if not isinstance(
                    method, (ast.FunctionDef, ast.AsyncFunctionDef)
                ) or method.name in exempt:
                    continue
                locked = self._locked_spans(method)
                for mut in self._mutations(method):
                    line = getattr(mut, "lineno", 0)
                    if not any(lo <= line <= hi for lo, hi in locked):
                        yield self.finding(
                            ctx, mut,
                            f"{node.name}.{method.name}() mutates shared "
                            "state outside `with self._lock:` — racy "
                            "under per-stream host threads",
                        )

    @staticmethod
    def _locked_spans(method: ast.AST) -> list[tuple[int, int]]:
        spans = []
        for node in ast.walk(method):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                expr = item.context_expr
                name = dotted_name(expr)
                if name and name.endswith("._lock"):
                    spans.append((node.lineno, node.end_lineno or node.lineno))
        return spans

    @staticmethod
    def _mutations(method: ast.AST):
        for node in ast.walk(method):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)) \
                            and _self_root(t):
                        yield node
                        break
            elif isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr in _MUTATING_METHODS
                    and _self_root(f.value)
                ):
                    yield node


_BLOCKING_CALLS = (
    "open", "input", "os.system", "subprocess.run", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output", "subprocess.Popen",
)


class BlockingCallInStreamLoop(Rule):
    """Host-blocking operations inside per-stream service code.

    The stream loop's latency budget is the device solve itself — a
    ``time.sleep``, an in-function ``import`` (module-lock contention
    plus first-import filesystem I/O), or a filesystem/subprocess call
    stalls every ticket behind it on that stream.  Deliberate blocking
    (injected-slow chaos faults) is annotated with
    ``# repro: ignore[blocking-call-in-stream-loop]`` at the call site.
    """

    name = "blocking-call-in-stream-loop"
    severity = "error"
    description = "blocking host operation in per-device stream code"
    default_options = {
        "modules": ("serving/", "distributed/"),
        "hot_functions": (
            "drain", "_next_stream", "_dispatch_micro_batch", "_harvest",
            "_finish_flight", "_admit", "step", "run",
            "acquire", "record_success", "record_failure",
        ),
    }

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.matches(self.options["modules"]):
            return
        hot = set(self.options["hot_functions"])
        for func, _stack in walk_functions(ctx.tree):
            if func.name not in hot:
                continue
            for node in ast.walk(func):
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    yield self.finding(
                        ctx, node,
                        f"import inside {func.name}() — contends on the "
                        "interpreter import lock per call; hoist to "
                        "module scope",
                    )
                elif isinstance(node, ast.Call):
                    name = dotted_name(node.func)
                    if name is None:
                        continue
                    if name in _BLOCKING_CALLS or name.endswith(".sleep"):
                        yield self.finding(
                            ctx, node,
                            f"{name}() blocks the {func.name}() stream "
                            "path — every queued ticket on this stream "
                            "waits behind it",
                        )


class SwallowedError(Rule):
    """Bare excepts and silently-discarded exceptions.

    The delivery contract requires every failure to land as a
    structured ``SolveError`` in the ticket's result slot — an
    ``except`` that catches and drops is a ticket that never resolves.
    Flags bare ``except:`` anywhere, and broad handlers
    (``Exception``/``BaseException``/``FaultInjected``) whose body
    neither re-raises nor does anything with the failure (pass/
    continue/break only).
    """

    name = "swallowed-error"
    severity = "error"
    description = "bare except or silently swallowed exception"
    default_options = {
        "modules": ("",),        # everything
        "broad_types": ("Exception", "BaseException", "FaultInjected"),
    }

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.matches(self.options["modules"]):
            return
        broad = set(self.options["broad_types"])
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield self.finding(
                    ctx, node,
                    "bare except: catches SystemExit/KeyboardInterrupt "
                    "and hides the failure kind — name the exception",
                )
                continue
            caught = {
                (dotted_name(t) or "").rsplit(".", 1)[-1]
                for t in (
                    node.type.elts if isinstance(node.type, ast.Tuple)
                    else [node.type]
                )
            }
            if not (caught & broad):
                continue
            if all(isinstance(s, (ast.Pass, ast.Continue, ast.Break))
                   for s in node.body):
                yield self.finding(
                    ctx, node,
                    f"except {'/'.join(sorted(caught & broad))} swallowed "
                    "— deliver a structured error (SolveError) or "
                    "re-raise; a dropped failure is a ticket that "
                    "never resolves",
                )


ALL_RULES: tuple[type[Rule], ...] = (
    HostSyncInHotPath,
    RecompileHazard,
    DtypeContract,
    UnlockedSharedState,
    BlockingCallInStreamLoop,
    SwallowedError,
)
