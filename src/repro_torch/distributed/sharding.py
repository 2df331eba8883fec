"""Logical-axis sharding rules, solver meshes, solve-service streams and
the per-stream circuit breaker (counterpart of
:mod:`repro.distributed.sharding`).

**Logical axes.**  A parameter or activation names a logical axis per
dimension (``("embed", "q_heads", "head_dim")``); the rules map each name
to a mesh axis, a tuple of mesh axes, or None (replicated).  A *spec* is
the reference's ``PartitionSpec`` as a plain tuple, one entry per tensor
dimension, and :func:`placements` turns it into DTensor placements on a
named :class:`~torch.distributed.device_mesh.DeviceMesh`.  The placement
policy is the reference's: ``embed`` over ``"data"`` (FSDP), heads,
``ff``, ``vocab`` and ``inner`` over ``"model"``, ``batch`` over
``"data"`` or ``("pod", "data")``.  The port's models carry one
sharding hint, the attention batch layout at the attention's boundary
(:func:`attn_batch_split`, a no-op without rules and a mesh); otherwise
the rules place state: :func:`logical_constraint` and
:func:`boundary_pin` are for callers holding DTensors, and without rules
return their input itself.  :func:`rank_rows` and :func:`place_rows`
take a rank's rows of a batch and place a step's outputs for the sharded
steps, whose compute is replicated over ``"model"``.

**The solver mesh.**  JAX places a sharded array on a ``Mesh`` and lets GSPMD split the work.
PyTorch has no such array, so the port's mesh is a plain tuple of
:class:`torch.device` and "sharding" a batch means splitting its axis 0
into contiguous parts, one per device; a caller runs each part where it
lies and gathers the results in order (see
:func:`repro_torch.core.engine.dc_solve_batch_submit`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import active_mesh

# ---------------------------------------------------------------------------
# Logical-axis rules of the model stack
# ---------------------------------------------------------------------------

LOGICAL_RULES_SINGLE_POD: dict[str, object] = {
    "batch": "data",
    "embed": "data",       # FSDP shard dim
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "inner": "model",      # mamba d_inner
    "expert": None,        # flipped to "model" by EP configs
    "moe_grp": "data",     # hierarchical MoE dispatch groups
    "seq": None,
    "state": None,
}

LOGICAL_RULES_MULTI_POD: dict[str, object] = {
    **LOGICAL_RULES_SINGLE_POD,
    "batch": ("pod", "data"),
}


class _Ctx(threading.local):
    def __init__(self):
        self.rules: Optional[Mapping[str, object]] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(rules: Mapping[str, object]):
    """Make ``rules`` the active rules of this thread inside the block."""
    prev = _CTX.rules
    _CTX.rules = rules
    try:
        yield
    finally:
        _CTX.rules = prev


def active_rules() -> Optional[Mapping[str, object]]:
    return _CTX.rules


def logical_spec(axes: Sequence[Optional[str]],
                 rules: Optional[Mapping[str, object]] = None) -> tuple:
    """The spec of ``axes`` under ``rules`` (default: the active rules):
    one mesh-axis entry per dimension; ``()`` without rules."""
    rules = rules if rules is not None else _CTX.rules
    if rules is None:
        return ()
    return tuple(rules.get(a) if a is not None else None for a in axes)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on the named ``mesh``: for each mesh
    dimension, in mesh order, ``Shard(d)`` where the spec names that axis
    at tensor dimension ``d`` (alone or in a tuple: ``("pod", "data")``
    shards one dimension over both), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is None:
                continue
            if axis not in names:
                raise ValueError(f"spec {tuple(spec)} names mesh axis {axis!r}; the mesh "
                                 f"has {names}")
            if axis in where:
                raise ValueError(f"spec {tuple(spec)} names mesh axis {axis!r} twice")
            where[axis] = d
    return tuple(Shard(where[n]) if n in where else Replicate() for n in names)


def with_sharding_constraint(x, spec: Sequence):
    """The port's ``jax.lax.with_sharding_constraint``: a DTensor on the
    active mesh (:func:`repro_torch.launch.mesh.mesh_context`) is
    redistributed to ``spec``'s placements; anything else is returned as
    it is (a plain tensor lies whole on its device)."""
    from torch.distributed.tensor import DTensor

    mesh = active_mesh()
    if mesh is None or not isinstance(x, DTensor) or x.device_mesh != mesh:
        return x
    return x.redistribute(mesh, placements(spec, mesh))


def logical_constraint(x, axes: Sequence[Optional[str]]):
    """with_sharding_constraint by logical axes; ``x`` itself without
    rules."""
    if _CTX.rules is None:
        return x
    return with_sharding_constraint(x, logical_spec(axes))


def boundary_pin(x, axes: Sequence[Optional[str]]):
    """The constraint applied only where the attention batch layout
    differs from the batch layout (the reference's lever for archs whose
    heads do not divide the model axis); ``x`` itself without rules or
    where the two layouts match."""
    rules = _CTX.rules
    if rules is None:
        return x
    if rules.get("attn_batch", rules.get("batch")) == rules.get("batch"):
        return x
    return with_sharding_constraint(x, logical_spec(axes))


def param_specs(logical_tree, rules: Mapping[str, object]):
    """Map a tree (dicts) of logical-axis tuples to specs."""
    if isinstance(logical_tree, tuple):
        return logical_spec(logical_tree, rules)
    return {k: param_specs(v, rules) for k, v in logical_tree.items()}


# ---------------------------------------------------------------------------
# A rank's rows of the batch, and the attention batch layout
# ---------------------------------------------------------------------------

def rule_axes(entry) -> tuple[str, ...]:
    """A rule's mesh axes as a tuple: None gives (), ``"data"`` gives
    ``("data",)``, a tuple itself."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def rank_share(mesh, axes: Sequence[str]) -> tuple[int, int]:
    """This rank's index among the ranks of ``axes`` (flattened in the
    given order, the first axis major) and their number."""
    names = mesh.mesh_dim_names
    index, count = 0, 1
    for a in axes:
        n = mesh.size(names.index(a))
        index, count = index * n + mesh.get_local_rank(a), count * n
    return index, count


def rank_rows(x: torch.Tensor, mesh, axes: Sequence[str], dim: int = 0) -> torch.Tensor:
    """This rank's contiguous share of ``x`` along ``dim`` when that
    dimension is split over the mesh ``axes`` (a view); ``x`` itself for
    no axes."""
    index, count = rank_share(mesh, axes)
    if x.shape[dim] % count:
        raise ValueError(f"{x.shape[dim]} rows do not split over {count} ranks of {tuple(axes)}")
    k = x.shape[dim] // count
    return x.narrow(dim, index * k, k)


def place_rows(local: torch.Tensor, mesh, axes: Sequence[str], dim: int, spec: Sequence):
    """A DTensor placed by ``spec`` from ``local``, this rank's rows along
    ``dim`` (split over the mesh ``axes``, as :func:`rank_rows` takes
    them) and whole along every other dimension, as every rank of the
    other axes holds them: the reference's ``out_shardings`` of a step
    whose compute is replicated there.  A spec that shards another
    dimension keeps this rank's slice of it (a local copy, no
    collective)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    held = [Shard(dim) if a in axes else Replicate() for a in mesh.mesh_dim_names]
    shape = list(local.shape)
    shape[dim] *= rank_share(mesh, axes)[1]
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    whole = DTensor.from_local(local, mesh, held, run_check=False, shape=torch.Size(shape),
                               stride=tuple(stride))
    return whole.redistribute(mesh, placements(spec, mesh))


_c10d = torch.ops._c10d_functional


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dimension 0 over ``group``."""
    return _c10d.wait_tensor(_c10d.all_gather_into_tensor(x.contiguous(), group.size(),
                                                          group.group_name))


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return _c10d.wait_tensor(_c10d.all_reduce(x.contiguous(), "sum", group.group_name))


class _SliceRows(torch.autograd.Function):
    """Forward: this rank's share of the rows, a view.  Backward: the
    shares' gradients gathered over the group, so that the input's
    gradient is whole on every rank, as the input is."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.narrow(0, split.index * (x.shape[0] // split.count), x.shape[0] // split.count)

    @staticmethod
    def backward(ctx, grad):
        return ctx.split.gather(grad), None


class _GatherRows(torch.autograd.Function):
    """Forward: the ranks' shares gathered over the group.  Backward: this
    rank's share of the gradient, which every rank holds whole (the
    compute after the gather is replicated), with no collective."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return split.gather(x)

    @staticmethod
    def backward(ctx, grad):
        k = grad.shape[0] // ctx.split.count
        return grad.narrow(0, ctx.split.index * k, k), None


class _SumGradients(torch.autograd.Function):
    """Forward: the tensor itself.  Backward: its gradient summed over the
    group, since each rank took only its share of the rows."""

    @staticmethod
    def forward(ctx, w, split):
        ctx.split = split
        return w.view_as(w)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.split.group), None


@dataclasses.dataclass(frozen=True)
class AttnBatchSplit:
    """The attention batch layout of the active rules on the active mesh:
    the batch of attention is split over one more mesh axis than the
    batch (``rules["attn_batch"]`` is ``rules["batch"]`` plus ``axis``).

    The port computes everything outside attention replicated over
    ``"model"`` (:func:`repro_torch.training.step.make_sharded_train_step`),
    so the layout means: each rank of ``axis`` takes its share of the
    rank's rows (:meth:`enter`), runs the attention on them, and the
    outputs are gathered over ``axis`` (:meth:`exit`): one all-gather of
    the attention's output a layer, the reference's one activation
    re-shard.  Under autograd the gather's gradient is a local slice,
    the slice's gradient an all-gather, and the attention's weights'
    gradients are summed over ``axis`` (an all-reduce each)."""

    axis: str
    group: object
    index: int
    count: int

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _gather_rows(x, self.group)

    def enter(self, x: torch.Tensor, positions: torch.Tensor, params: dict):
        """``x`` (B, S, d) and ``positions`` (B, S) cut to this rank's
        rows, and ``params`` (name: tensor) with their gradients summed
        over ``axis``."""
        if x.shape[0] % self.count:
            raise ValueError(f"the attention batch layout splits {x.shape[0]} rows over "
                             f"{self.count} ranks of {self.axis!r}")
        k = x.shape[0] // self.count
        return (_SliceRows.apply(x, self), positions.narrow(0, self.index * k, k),
                {n: None if w is None else _SumGradients.apply(w, self)
                 for n, w in params.items()})

    def exit(self, out: torch.Tensor) -> torch.Tensor:
        """The attention's output of every rank's rows, gathered."""
        return _GatherRows.apply(out, self)


def attn_batch_split() -> Optional[AttnBatchSplit]:
    """The attention batch layout of the active rules on the active mesh
    (:func:`use_rules`, :func:`repro_torch.launch.mesh.mesh_context`);
    None without both, or where the layout is the batch's own (every
    one-device path, and every rule-set that
    :func:`repro_torch.distributed.rules.apply_attn_batch_layout` left as
    it was)."""
    rules, mesh = _CTX.rules, active_mesh()
    if rules is None or mesh is None:
        return None
    batch = rule_axes(rules.get("batch"))
    extra = [a for a in rule_axes(rules.get("attn_batch", rules.get("batch")))
             if a not in batch]
    if not extra:
        return None
    if len(extra) > 1:
        raise NotImplementedError(f"an attention batch layout over more than one axis beyond "
                                  f"the batch's: {extra}")
    (axis,) = extra
    names = mesh.mesh_dim_names
    return AttnBatchSplit(axis=axis, group=mesh.get_group(axis),
                          index=mesh.get_local_rank(axis), count=mesh.size(names.index(axis)))


# ---------------------------------------------------------------------------
# Solver-side meshes and streams
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SolverMesh:
    """A 1-d solver mesh: the devices the system-batch axis is split over."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _visible_cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; raises (through resolve_device) without one."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def solver_mesh(n_devices: Optional[int] = None, devices=None) -> SolverMesh:
    """1-d solver mesh over the system-batch axis.

    ``devices`` lists the mesh's devices (``["cpu"] * k`` runs k parts on
    the host, as the tests do); otherwise ``n_devices`` takes the first N
    visible CUDA devices, and with neither the mesh is ``(cuda:0,)``.
    Like every entry point it raises without a card unless given CPU
    devices.
    """
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
    else:
        devs = _visible_cuda_devices()
        if n_devices is None:
            devs = devs[:1]
    if n_devices is not None:
        if n_devices > len(devs):
            raise RuntimeError(
                f"solver mesh wants {n_devices} devices, have {len(devs)}"
            )
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a solver mesh needs at least one device")
    return SolverMesh(devices=tuple(devs))


def stream_devices(mesh=None, devices=None, n_devices: Optional[int] = None):
    """Ordered device list for the solve service's streams.

    Accepts a 1-d solver mesh (its device order), an explicit device
    list, or a device count (the first N visible CUDA devices); with none
    of the three, the default device (``cuda:0``) alone.  A device may
    repeat: each entry is one stream.  The solve service assigns whole
    micro-batches to these streams round-robin instead of splitting one
    micro-batch with :func:`shard_system_batch`.
    """
    if devices is not None:
        return [resolve_device(d) for d in devices]
    if mesh is not None:
        return list(mesh.devices)
    devs = _visible_cuda_devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise RuntimeError(
                f"stream wants {n_devices} devices, have {len(devs)}"
            )
        return devs[:n_devices]
    return devs[:1]


@dataclasses.dataclass
class _StreamState:
    """Breaker state of one device stream."""

    state: str = "closed"            # closed | open | half_open
    consecutive_failures: int = 0
    backoff_s: float = 0.0           # current open-interval length
    open_until: float = 0.0          # monotonic time the backoff elapses


class StreamBreaker:
    """Per-device-stream circuit breaker for the solve service.

    Each stream (an index into the service's round-robin stream list)
    is ``closed`` (serving), ``open`` (quarantined: consecutive
    failures reached ``threshold``; no dispatches until its backoff
    elapses) or ``half_open`` (one probe micro-batch in flight).  A
    successful probe closes the stream and resets its backoff; a
    failed probe re-opens it with the backoff doubled (capped at
    ``backoff_max_s``) — exponential-backoff half-open probing, so a
    flapping device costs a geometrically shrinking share of traffic
    while a recovered one rejoins after a single probe.

    The service owns the policy around the breaker: on a trip it
    re-queues the quarantined stream's in-flight tickets (at original
    admission rank, blameless — no retry budget consumed) onto the
    healthy streams, and when *every* stream is open with work still
    queued it calls :meth:`force_probe` so the service degrades to
    probing instead of deadlocking.  Pure host logic; ``clock`` is
    injectable so tests drive it with a fake clock.
    """

    def __init__(
        self,
        n_streams: int,
        *,
        threshold: int = 3,
        backoff_s: float = 0.25,
        backoff_max_s: float = 30.0,
        clock=time.monotonic,
    ):
        if n_streams < 1:
            raise ValueError("need at least one stream")
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.clock = clock
        self._streams = [_StreamState() for _ in range(n_streams)]
        self.trips = 0               # closed/half_open -> open transitions
        self.probes = 0              # open -> half_open transitions
        self.restores = 0            # half_open -> closed transitions
        # acquire/record_* are read-modify-write on per-stream state; two
        # callers must not both win the same probe slot
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._streams)

    def state(self, dev: int) -> str:
        return self._streams[dev].state

    def acquire(self, dev: int) -> bool:
        """May stream ``dev`` take a dispatch right now?

        ``closed`` streams always may.  An ``open`` stream whose
        backoff has elapsed transitions to ``half_open`` and accepts
        exactly this one dispatch as its probe; while the probe is in
        flight further acquires are refused.
        """
        with self._lock:
            s = self._streams[dev]
            if s.state == "closed":
                return True
            if s.state == "open" and self.clock() >= s.open_until:
                s.state = "half_open"
                self.probes += 1
                return True
            return False

    def release(self, dev: int) -> None:
        """Hand back an acquired probe slot without a device verdict.

        Called when a dispatch acquired via :meth:`acquire` never
        reached the device (the *host* build raised): the probe said
        nothing about the stream's health, so a ``half_open`` stream
        returns to ``open`` with its backoff already elapsed — the
        next acquire probes again immediately.
        """
        with self._lock:
            s = self._streams[dev]
            if s.state == "half_open":
                s.state = "open"
                s.open_until = self.clock()

    def record_success(self, dev: int) -> None:
        with self._lock:
            s = self._streams[dev]
            if s.state == "half_open":
                s.state = "closed"
                self.restores += 1
            s.consecutive_failures = 0
            s.backoff_s = 0.0

    def record_failure(self, dev: int) -> bool:
        """Count one device-side failure; returns True when this call
        trips the stream open (caller quarantines its in-flights)."""
        with self._lock:
            s = self._streams[dev]
            s.consecutive_failures += 1
            if s.state == "half_open":
                # failed probe: back off twice as long
                s.state = "open"
                s.backoff_s = min(
                    max(s.backoff_s, self.backoff_s) * 2.0, self.backoff_max_s
                )
                s.open_until = self.clock() + s.backoff_s
                self.trips += 1
                return True
            if s.state == "closed" and s.consecutive_failures >= self.threshold:
                s.state = "open"
                s.backoff_s = self.backoff_s
                s.open_until = self.clock() + s.backoff_s
                self.trips += 1
                return True
            return False

    def force_probe(self) -> int:
        """Expire the soonest-recovering open stream's backoff now.

        Called when every stream is quarantined but work remains: the
        service must keep probing rather than deadlock — "degrade to
        fewer streams", never to zero.  Returns the stream index.
        """
        with self._lock:
            open_streams = [
                i for i, s in enumerate(self._streams) if s.state == "open"
            ]
            if not open_streams:
                raise RuntimeError("force_probe with no open stream")
            dev = min(open_streams, key=lambda i: self._streams[i].open_until)
            self._streams[dev].open_until = self.clock()
            return dev

    def stats(self) -> dict:
        return {
            "states": [s.state for s in self._streams],
            "trips": self.trips,
            "probes": self.probes,
            "restores": self.restores,
        }


def shard_system_batch(*arrays, mesh: SolverMesh):
    """Split each array's batch axis contiguously over the solver mesh.

    Returns, for each array, a list of ``mesh.size`` tensors: part ``i``
    holds rows ``[i k, (i + 1) k)`` on ``mesh.devices[i]``.  The batch
    size must divide evenly — the solve service pads every micro-batch to
    a fixed size before dispatch, and direct callers get a clear error.
    """
    n_dev = mesh.size
    out = []
    for x in arrays:
        if x.shape[0] % n_dev:
            raise ValueError(
                f"batch of {x.shape[0]} does not divide over {n_dev} "
                f"devices; pad the batch (the solve service does this "
                f"automatically)"
            )
        t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        k = t.shape[0] // n_dev
        out.append([t[i * k:(i + 1) * k].to(dev) for i, dev in enumerate(mesh.devices)])
    return tuple(out) if len(out) != 1 else out[0]
