"""Count a step's FLOPs, bytes and live memory while it runs.

Counterpart of :func:`repro.roofline.hlo_parse.loop_aware_costs`.  The
reference parses the compiled HLO of a step; the port runs the step
eagerly, on the ``meta`` device for a dry run (the counterpart of
``jax.eval_shape``/``lower``: shapes and dtypes, no data) or on the card,
under :class:`CostCounter`, a ``TorchDispatchMode`` that sees every aten
operator, forward and backward:

* **FLOPs**: 2 M N K of every matrix product (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``dot``, ``mv``; ``einsum``, ``matmul`` and ``linear``
  reach the dispatcher as these).  Elementwise FLOPs are not counted, as
  the reference counts only ``dot``.
* **bytes**: each operator's inputs read once and outputs written once.
  The port runs eagerly, so an operator's boundary is HBM traffic, as a
  fusion's boundary is for XLA.  Views and allocations count zero; a
  tensor counts the elements it addresses (a broadcast dimension of
  stride 0 once).  A write into a region of a larger tensor counts the
  region: ``copy_`` into a slice (the KV-cache update of ``prefill_into``)
  reads its source and writes the region, ``index_put_`` (the cache row
  of ``decode_step``) and the scatters read their indices and values and
  write the rows they name (``hlo_parse.py:172-205, 267-273``); a gather
  reads only the rows it returns.  L2 hits are not modelled: bytes that a
  consumer finds in the L2 count as HBM traffic.
* **K8** (``kernels/flash_attention.py``) runs outside the dispatcher (a
  ``ctypes`` launch) or not at all (``meta``), so its wrappers report one
  operation each, forward and each backward kernel, by formula, through
  the kernels' hook (``build.record_operation``, which this counter
  receives as a ``build.KernelCounter``), and the plain version that
  stands in for it on the CPU runs uncounted (``build.uncounted``).
* **memory**: every storage that an operator allocates under the mode
  is live until it is freed, and a storage that existed before (first
  seen as an operator's input) is credited when the step frees it (the
  old moments AdamW replaces).  ``peak_live_bytes`` is the most the step
  added at once to what it found allocated: the card's
  ``max_memory_allocated()`` less ``memory_allocated()`` before the step.
  ``peak_temp_bytes`` is the most held at once by the storages that the
  step both allocated and freed, neither arguments nor outputs: the
  counterpart of XLA's ``temp_size_in_bytes``.

* **collectives**: the c10d operators the step issues on a mesh (the
  functional ones of ``torch.distributed._functional_collectives`` and
  DTensor, ``_c10d_functional.*``, and the in-place ones of
  ``torch.distributed``, ``c10d.*_``) go by kind into the reference's
  keys (:data:`COLLECTIVES`), each adding its result's bytes to its kind
  and to ``bytes``, as the reference's parse of an HLO collective does
  (``hlo_parse.py:257-263``); waits count zero, and an operator of
  those namespaces that the counter does not know raises.  The dry run
  sees them on a fake process group (:func:`repro_torch.launch.mesh.fake_world`);
  on one card there are none.

``hlo_parse.host_callback_ops`` has no counterpart:
it serves the reference's ``CompileWatch``, which the port leaves out
(ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import functools
import math
import weakref

import torch
from repro_torch.kernels.build import KernelCounter

aten = torch.ops.aten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# matrix products: their FLOPs are 2 * numel(out) * K, K the contracted size
_PRODUCTS = {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default,
             aten.mv.default, aten.dot.default}
# allocations and metadata: no bytes
_NO_BYTES = {aten.empty.memory_format, aten.empty_like.default, aten.empty_strided.default,
             aten.new_empty.default, aten.new_empty_strided.default, aten._unsafe_view.default,
             aten.detach.default, aten.alias.default, aten.lift_fresh.default,
             aten.set_.source_Storage_storage_offset, aten.resize_.default}
# writes of the whole destination that do not read it
_WRITE_ONLY = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default}
# gathers: read the rows they return (and their indices)
_GATHERS = {aten.index.Tensor, aten.gather.default, aten.index_select.default,
            aten.embedding.default}
# writes of rows: read indices and values, write the rows they name
_ROW_WRITES = {aten.index_put_.default, aten._index_put_impl_.default}
_SCATTERS = {aten.scatter_.src, aten.scatter_.value, aten.scatter_add_.default,
             aten.scatter_reduce_.two}


# collectives by namespace and name: the reference's kind of each
_COLLECTIVE_KINDS = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
}
# the collectives' namespaces, and their operators that move nothing
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")
_COLLECTIVE_FREE = {"wait_tensor", "_wrap_tensor_autograd"}


_BACKEND_KEYS = ("CPU", "CUDA", "Meta", "CompositeExplicitAutograd",
                 "CompositeExplicitAutogradNonFunctional")


@functools.cache
def _lowers(func) -> bool:
    """Whether ``func`` is only a composite of other operators (no kernel
    of its own on any backend), so that what it lowers to is counted."""
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    return has(func.name(), "CompositeImplicitAutograd") and not any(
        has(func.name(), key) for key in _BACKEND_KEYS)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses: a dimension of stride 0
    (a broadcast) counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(x) -> list[torch.Tensor]:
    """The tensors in an operator's arguments or results (nested lists,
    tuples and dicts).  No recursive closure: its reference cycle would
    keep the tensors alive until the garbage collector runs."""
    out: list[torch.Tensor] = []
    stack = [x]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
    return out


def _product_flops(func, args, out) -> int:
    if func in (aten.mv.default, aten.dot.default):
        return 2 * args[0].numel()
    a = args[1] if func in (aten.addmm.default, aten.baddbmm.default) else args[0]
    return 2 * out.numel() * a.shape[-1]


def _row_write_bytes(func, args, kwargs) -> int:
    """``index_put_``: indices and values read, the indexed rows written."""
    self, indices, values = args[0], args[1], args[2]
    idx = [i for i in indices if i is not None]
    rows = math.prod(torch.broadcast_shapes(*(i.shape for i in idx))) if idx else 1
    rest = math.prod(s for i, s in enumerate(self.shape) if i >= len(indices)
                     or indices[i] is None)
    region = rows * rest * self.element_size()
    read = sum(tensor_bytes(i) for i in idx) + tensor_bytes(values)
    accumulate = (args[3] if len(args) > 3 else kwargs.get("accumulate", False))
    return read + region * (2 if accumulate else 1)


def _scatter_bytes(func, args) -> int:
    self, index = args[0], args[2]
    region = index.numel() * self.element_size()
    src = region if isinstance(args[3], torch.Tensor) else 0
    reads_dst = func is not aten.scatter_.src and func is not aten.scatter_.value
    return tensor_bytes(index) + src + region * (2 if reads_dst else 1)


def _op_bytes(func, args, kwargs, out) -> int:
    if func in _NO_BYTES or func.is_view:
        return 0
    if func in _GATHERS:
        index = [t for t in _tensors((args[1:], kwargs))]
        return 2 * sum(tensor_bytes(t) for t in _tensors(out)) \
            + sum(tensor_bytes(t) for t in index)
    if func in _ROW_WRITES:
        return _row_write_bytes(func, args, kwargs)
    if func in _SCATTERS:
        return _scatter_bytes(func, args)
    schema = func._schema
    total = 0
    named = dict(zip((a.name for a in schema.arguments), args))
    named.update(kwargs)
    for arg in schema.arguments:
        value = named.get(arg.name)
        if value is None:
            continue
        written = arg.alias_info is not None and arg.alias_info.is_write
        for t in _tensors(value):
            b = tensor_bytes(t)
            if written:
                total += b                       # written once
                if not (arg.is_out or func in _WRITE_ONLY):
                    total += b                   # and read (an in-place update)
            else:
                total += b
    for ret, value in zip(schema.returns, out if isinstance(out, (tuple, list)) else (out,)):
        if ret.alias_info is None:
            total += sum(tensor_bytes(t) for t in _tensors(value))
    return total


def _collective_kind(func) -> str | None:
    """The reference's kind of a c10d operator, ``""`` for one that moves
    nothing (a wait), None for any other operator."""
    namespace = func.namespace
    if namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func.overloadpacket.__name__
    if name in _COLLECTIVE_FREE:
        return ""
    try:
        return _COLLECTIVE_KINDS[(namespace, name)]
    except KeyError:
        raise NotImplementedError(f"CostCounter: collective {func} has no kind; add it to "
                                  "_COLLECTIVE_KINDS") from None


class CostCounter(KernelCounter):
    """``with CostCounter() as c: step()``; then ``c.flops``, ``c.bytes``,
    ``c.peak_live_bytes``, ``c.peak_temp_bytes``, ``c.kernels`` (K8's
    recorded operations by name: calls, flops, bytes) and
    ``c.collectives()`` (bytes by kind).  ``c.by_op`` holds flops and
    bytes by aten operator (K8's under its kernel names, a collective
    under its own).

    ``device`` (a device type, ``"cuda"`` or ``"meta"``) counts only the
    operators that touch a tensor there, and tracks only its storages:
    host work beside the step (the CPU scalars of the optimizer, the RNG
    state that block remat saves and restores on the card only) is not
    the device's.  None counts every operator."""

    def __init__(self, device: str | None = None):
        super().__init__()
        self.device = device
        self.flops = 0
        self.bytes = 0
        self.by_op: dict[str, list[int]] = {}
        self.kernels: dict[str, dict] = {}
        self.collective_bytes = dict.fromkeys(COLLECTIVES, 0)
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: dict[int, tuple[int, int]] = {}   # storage: (serial, bytes), made here
        self._before: dict[int, int] = {}            # storage: bytes, found at the start
        self._events: list[tuple[int, int]] = []     # (serial, +-bytes) while entered
        self._alive_at_exit: set[int] = set()
        self._depth = 0

    def __enter__(self):
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            self._alive_at_exit = {serial for serial, _ in self._live.values()}
        return super().__exit__(*exc)

    @property
    def peak_temp_bytes(self) -> int:
        """The most held at once by storages made and freed inside the
        counted block (the outputs, still held at its end, left out)."""
        held = peak = 0
        for serial, delta in self._events:
            if serial not in self._alive_at_exit:
                held += delta
                peak = max(peak, held)
        return peak

    def collectives(self) -> dict:
        """Collective bytes by kind and their ``total``, the reference's
        keys, as floats (0 on one card)."""
        out = {k: float(v) for k, v in self.collective_bytes.items()}
        return {**out, "total": float(sum(self.collective_bytes.values()))}

    def _add(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def record_kernel(self, name: str, flops: int, nbytes: int) -> None:
        """One operation that runs outside the dispatcher (a hand-written
        kernel), by formula."""
        if self.paused:
            return
        self._add(name, flops, nbytes)
        k = self.kernels.setdefault(name, dict(calls=0, flops=0, bytes=0))
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def _free(self, key: int) -> None:
        if key not in self._live:
            return                  # moved to the storage of an alias (_follow)
        serial, nbytes = self._live.pop(key)
        self.live_bytes -= nbytes
        if self._depth:
            self._events.append((serial, -nbytes))

    def _free_before(self, key: int) -> None:
        self.live_bytes -= self._before.pop(key)

    def _follow(self, args, out) -> None:
        """A collective's wait or autograd wrap returns, on the card, its
        input's storage (a wrapper of it); on meta the wrap makes a new
        one.  The input's allocation then follows the output, so that the
        gathered buffer counts once and lives as long as what holds it."""
        src = [t for t in _tensors(args) if self._mine(t)]
        dst = [t for t in _tensors(out) if self._mine(t)]
        if len(src) != 1 or len(dst) != 1:
            return
        old, new = src[0].untyped_storage(), dst[0].untyped_storage()
        if old._cdata not in self._live or new._cdata in self._live or new._cdata == old._cdata:
            return
        self._live[new._cdata] = self._live.pop(old._cdata)
        weakref.finalize(new, self._free, new._cdata)

    def _mine(self, t: torch.Tensor) -> bool:
        return self.device is None or t.device.type == self.device

    def _track(self, func, args, kwargs, out) -> None:
        for t in _tensors((args, kwargs)):
            if not self._mine(t):
                continue
            storage = t.untyped_storage()
            key = storage._cdata
            if key not in self._live and key not in self._before:
                self._before[key] = storage.nbytes()
                weakref.finalize(storage, self._free_before, key)
        if func.is_view or any(r.alias_info is not None for r in func._schema.returns):
            return
        for t in _tensors(out):
            if not self._mine(t):
                continue
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._live or key in self._before:
                continue
            serial = len(self._events)
            self._live[key] = (serial, storage.nbytes())
            self._events.append((serial, storage.nbytes()))
            self.live_bytes += storage.nbytes()
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            weakref.finalize(storage, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _lowers(func):
            # under inference_mode composite operators (matmul, einsum,
            # reshape, to) reach the mode whole; count what they lower to,
            # as under autograd (the mode is off inside this method: the
            # lowering runs under it again)
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self.paused or (self.device is not None and not any(
                t.device.type == self.device for t in _tensors((args, kwargs, out)))):
            return out
        name = str(func.overloadpacket.__name__)
        kind = _collective_kind(func)
        if kind is None:
            flops = _product_flops(func, args, out) if func in _PRODUCTS else 0
            self._add(name, flops, _op_bytes(func, args, kwargs, out))
        elif kind:
            # the result's bytes, to its kind and to the step's bytes
            nbytes = sum(tensor_bytes(t) for t in _tensors(out))
            self.collective_bytes[kind] += nbytes
            self._add(name, 0, nbytes)
        else:
            self._follow(args, out)
            return out
        self._track(func, args, kwargs, out)
        return out
