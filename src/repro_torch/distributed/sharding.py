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
steps, and :class:`BatchShard` tells an MoE's dispatch where the rank's
rows lie.  :class:`ModelSplit` is a model's tensor parallelism over
``"model"``, in every family (Megatron's f and g, the vocab-parallel
lookup and logsumexp, the head_dim gather, RoPE's exchange, the experts'
gather, the gated norm's mean square summed both ways).

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
import math
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


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's place among the shards of a sharded step's batch:
    ``index`` of ``count`` contiguous shares (:func:`rank_rows`) over the
    batch axes, whose process groups are ``groups`` (in mesh order).  The
    MoE's dispatch groups read it (:mod:`repro_torch.models.moe`)."""

    groups: tuple
    index: int
    count: int

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` stacked in shard order, (count, *x.shape),
        outside autograd: gathered over the innermost axis first."""
        out = x.unsqueeze(0)
        for group in reversed(self.groups):
            out = _gather_rows(out, group)
        return out


def batch_shard(mesh, axes: Sequence[str]) -> Optional[BatchShard]:
    """This rank's :class:`BatchShard` over the mesh ``axes``; None where
    the batch is not split (no axes, or one shard)."""
    index, count = rank_share(mesh, axes)
    if count == 1:
        return None
    return BatchShard(groups=tuple(mesh.get_group(a) for a in axes), index=index, count=count)


def rank_rows(x: torch.Tensor, mesh, axes: Sequence[str], dim: int = 0) -> torch.Tensor:
    """This rank's contiguous share of ``x`` along ``dim`` when that
    dimension is split over the mesh ``axes`` (a view); ``x`` itself for
    no axes."""
    index, count = rank_share(mesh, axes)
    if x.shape[dim] % count:
        raise ValueError(f"{x.shape[dim]} rows do not split over {count} ranks of {tuple(axes)}")
    k = x.shape[dim] // count
    return x.narrow(dim, index * k, k)


def place_rows(local: torch.Tensor, mesh, axes: Sequence[str], dim: int, spec: Sequence,
               model_dim: Optional[int] = None):
    """A DTensor placed by ``spec`` from ``local``, this rank's rows along
    ``dim`` (split over the mesh ``axes``, as :func:`rank_rows` takes
    them), with ``model_dim`` this rank's share over ``"model"`` (a
    tensor-parallel step's output), and whole along every other
    dimension, as every rank of the other axes holds them: the
    reference's ``out_shardings`` of a step whose compute is replicated
    there.  A spec that shards another dimension keeps this rank's slice
    of it (a local copy, no collective)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    held = [Shard(dim) if a in axes else Shard(model_dim)
            if a == "model" and model_dim is not None else Replicate()
            for a in mesh.mesh_dim_names]
    shape = list(local.shape)
    shape[dim] *= rank_share(mesh, axes)[1]
    if model_dim is not None:
        shape[model_dim] *= rank_share(mesh, ("model",))[1]
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


def _reduce_over(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    return _c10d.wait_tensor(_c10d.all_reduce(x.contiguous(), op, group.group_name))


def _scatter_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (group size, ...) summed over the group, this rank's row of
    the sum: a reduce-scatter along dimension 0."""
    return _c10d.wait_tensor(_c10d.reduce_scatter_tensor(x.contiguous(), "sum", group.size(),
                                                         group.group_name))


def _all_to_all(x: torch.Tensor, group, sizes=None) -> torch.Tensor:
    """Row block ``i`` of ``x`` (split along dimension 0 by ``sizes``, even
    without) sent to rank ``i`` of the group; the blocks received, by
    sender, in the same order."""
    sizes = [x.shape[0] // group.size()] * group.size() if sizes is None else list(sizes)
    return _c10d.wait_tensor(_c10d.all_to_all_single(x.contiguous(), sizes, sizes,
                                                     group.group_name))


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
        return _reduce_over(grad, ctx.split.group), None


class _SumPartials(torch.autograd.Function):
    """Megatron's g.  Forward: the ranks' partial sums summed over the
    group.  Backward: the gradient itself, which every rank holds whole
    (the compute after the sum is replicated)."""

    @staticmethod
    def forward(ctx, x, split):
        return _reduce_over(x, split.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumShares(torch.autograd.Function):
    """Forward: the ranks' shares summed over the group.  Backward: the
    gradient summed over the group as well, since every rank's result
    depends on every rank's share (a statistic of a dimension split over
    the group, such as a norm's mean square)."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _reduce_over(x, split.group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_over(grad, ctx.split.group), None


class _GatherLast(torch.autograd.Function):
    """Forward: the ranks' shares of the last dimension gathered, in rank
    order.  Backward: the gradient summed over the group and cut to this
    rank's share (a reduce-scatter), since each rank's gradient of the
    gathered tensor is its own contribution."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        parts = _gather_rows(x.unsqueeze(0), split.group)          # (m, ..., c)
        return parts.movedim(0, -2).contiguous().flatten(-2)

    @staticmethod
    def backward(ctx, grad):
        parts = grad.unflatten(-1, (ctx.split.count, -1)).movedim(-2, 0)
        return _scatter_sum(parts, ctx.split.group)[0], None


class _Exchange(torch.autograd.Function):
    """Forward: ``x`` sent to rank ``partner`` of the group and the
    partner's received (an all-to-all in which each rank sends to one
    rank).  Backward: the same exchange, the pairing being symmetric."""

    @staticmethod
    def forward(ctx, x, split, partner):
        ctx.split, ctx.partner = split, partner
        return _exchange(x, split, partner)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.split, ctx.partner), None, None


def _exchange(x: torch.Tensor, split, partner: int) -> torch.Tensor:
    sizes = [0] * split.count
    sizes[partner] = 1
    return _all_to_all(x.unsqueeze(0), split.group, sizes)[0]


class _VocabLogSumExp(torch.autograd.Function):
    """``logsumexp`` over a last dimension split over the group, in
    ``torch.logsumexp``'s own steps (the max, masked where infinite, the
    sum of ``exp(x - max)``, its log plus the max), the max and the sum
    reduced over the group; the gradient is its own, ``g exp(x - lse)``,
    local to each rank's share (the result is replicated)."""

    @staticmethod
    def forward(ctx, x, split):
        maxes = _reduce_over(torch.amax(x, -1, keepdim=True), split.group, "max")
        maxes.masked_fill_(maxes.abs() == math.inf, 0)
        out = _reduce_over(torch.sum((x - maxes).exp_(), -1), split.group)
        out = out.log_().add_(maxes.squeeze(-1))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad.unsqueeze(-1) * (x - out.unsqueeze(-1)).exp(), None


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """Tensor parallelism over the ``"model"`` axis of a rank's step, as
    GSPMD splits the reference's step under its rules: the rank holds its
    ``"model"`` shard of every leaf (``q_heads`` or ``head_dim``, ``ff``,
    ``vocab``, ``inner``) and computes its share.

    Megatron's regions: :meth:`enter` (f) is the identity forward and an
    all-reduce of the gradient, at the entry of a region whose first
    product is column-parallel; :meth:`exit` (g) all-reduces the partial
    sums of its row-parallel last product, the gradient passing through.
    A leaf replicated over ``"model"`` that a rank uses only in part (the
    q/k norms, a K/V projection whose ``kv_heads`` are not on the axis, a
    Mamba block's ``w_dt``, ``dt_bias``, ``a_log``, ``d_skip`` and its B/C
    leaves) takes its gradient summed over the group (:meth:`enter` too);
    the norms of the residual stream see a replicated input and need
    nothing.  ``attn`` is the attention's mode, from the rules' placing
    of ``wq`` (a hybrid's shared block's, an encdec's first decoder
    block's, which its encoder and cross attention share): ``"heads"`` (this rank's q
    heads and the kv heads they read), ``"head_dim"`` (this rank's columns
    of every head), ``"replicated"`` (whole heads on every rank: neither
    divides the axis, or the attention batch layout) or ``"none"`` (a
    model without attention).  ``heads``, ``kv_heads`` and
    ``kv_first`` are this rank's q heads, kv heads and its first kv
    head (``kv_sliced``: taken from K/V projections held whole, whose
    ``kv_heads`` are not on the axis), ``q_per_kv`` the q heads a kv head
    serves; ``ff`` and ``vocab`` its columns of the MLP (of every expert
    in an MoE) and rows of the padded vocab.  ``moe`` is an MoE's mode,
    from the rules' placing of its experts' ``w_gate``: ``"experts"``
    (expert parallel: the rank's ``experts`` experts from
    ``expert_first``, whole), ``"ff"`` (tensor parallel inside the
    experts: its ``ff`` columns of every expert), and ``"replicated"``
    for the other families (the rules put an MoE's experts or their
    ``ff`` on the axis).  ``ssm`` is a Mamba block's mode, from the
    rules' placing of ``w_x``: ``"heads"`` (its ``inner`` columns, which
    are its ``ssm_heads`` SSM heads from ``ssm_first``, whole),
    ``"replicated"`` (``inner`` off the axis: the block computes
    replicated) or ``"none"`` (a model without Mamba blocks).  With
    ``count`` 1 every operator is the one-device arithmetic."""

    group: object
    index: int
    count: int
    attn: str
    head_dim: int
    heads: int
    kv_heads: int
    kv_first: int
    kv_sliced: bool
    q_per_kv: int
    ff: int
    vocab: int
    moe: str = "replicated"
    experts: int = 0
    expert_first: int = 0
    ssm: str = "none"
    ssm_heads: int = 0
    ssm_first: int = 0

    @property
    def attn_partial(self) -> bool:
        """Whether the attention's output is a partial sum over the group."""
        return self.attn in ("heads", "head_dim")

    @property
    def ssm_partial(self) -> bool:
        """Whether a Mamba block's output is a partial sum over the group."""
        return self.ssm == "heads"

    @property
    def vocab_offset(self) -> int:
        return self.index * self.vocab

    @property
    def shards_head_dim(self) -> bool:
        """Whether the decode rules put ``head_dim`` on the axis (it
        divides): the decode cache's layout, a rank's columns of every
        head, or whole heads on every rank."""
        return self.head_dim % self.count == 0

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f (and what a replicated leaf that each rank uses in
        part needs: its gradient summed over the group)."""
        return _SumGradients.apply(x, self)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's g."""
        return _SumPartials.apply(x, self)

    def reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the group, for a value that takes no gradient
        (decode's norms and scores, the global norm's sums, the vocab
        argmax): its backward is not this module's to set (PyTorch's
        functional all_reduce has one of its own in some releases), so a
        reduction that takes a gradient goes through :meth:`enter`,
        :meth:`exit` or :meth:`mean_over`."""
        return _reduce_over(x, self.group, op)

    def mean_over(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the group of each rank's ``x``, a mean over its
        equal share of a split dimension (the gated norm's mean square
        over ``inner``), its gradient summed over the group: every rank's
        output depends on every rank's share, so the sum is an all-reduce
        forward and backward."""
        return _SumShares.apply(x, self) / self.count

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated along dimension 0, outside
        autograd."""
        return _gather_rows(x, self.group)

    def gather_experts(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' experts' outputs (its experts first along dimension
        0) gathered into every expert's, in expert order; the gradient
        this rank's slice, since the compute after the gather is
        replicated."""
        return _GatherRows.apply(x, self)

    def take_kv(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's kv heads of a K/V projection ``w`` (d, KV, dh) held
        whole: a view, its gradient summed over the group."""
        if not self.kv_sliced:
            return w
        return self.enter(w).narrow(1, self.kv_first, self.kv_heads)

    def head_dim_shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns of the last (head_dim) dimension: a view."""
        c = x.shape[-1] // self.count
        return x.narrow(-1, self.index * c, c)

    def cache_columns(self, new: torch.Tensor) -> torch.Tensor:
        """A prefill's new k or v (..., kv heads, head_dim) as this rank's
        cache takes it: in heads mode cut into the ranks' blocks of
        columns (..., count, head_dim / count) that
        :meth:`heads_to_head_dim` sends on; else the rank's own columns,
        or whole heads where the axis does not divide ``head_dim``."""
        if self.attn == "heads":
            return new.unflatten(-1, (self.count, -1))
        return self.head_dim_shard(new) if self.shards_head_dim else new

    def gather_columns(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's columns of the last dimension gathered in rank order
        (whole heads from ``head_dim`` shards, the whole ``inner`` from its
        shards); the gradient reduce-scattered."""
        return _GatherLast.apply(x, self)

    def rope_partner(self, x: torch.Tensor) -> torch.Tensor:
        """The columns that RoPE pairs with this rank's (half-split: column
        ``i`` with ``i + head_dim / 2``), from the rank that holds them."""
        if self.count % 2:
            raise NotImplementedError(f"RoPE on head_dim split over {self.count} ranks: the "
                                      "pairs must fall on two ranks")
        return _Exchange.apply(x, self, (self.index + self.count // 2) % self.count)

    def embed(self, tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """A lookup in a table split by rows (vocab) over the group: each
        rank looks up the ids in its rows, zeros elsewhere, and the rows
        are summed."""
        local = tokens - self.vocab_offset
        inside = (local >= 0) & (local < table.shape[0])
        rows = table[local.clamp(0, table.shape[0] - 1)]
        return self.exit(torch.where(inside[..., None], rows, 0))

    def logsumexp(self, x: torch.Tensor) -> torch.Tensor:
        """``logsumexp`` over the last dimension, split over the group."""
        return _VocabLogSumExp.apply(x, self)

    def pick(self, x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        """``x``'s element at ``index`` in the whole last dimension, split
        over the group: the rank that holds it gives it, the others zero,
        and the sum is taken (Megatron's g)."""
        local = index - self.vocab_offset
        inside = (local >= 0) & (local < x.shape[-1])
        mine = torch.gather(x, -1, local.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
        return self.exit(torch.where(inside, mine, 0.0))

    def argmax(self, x: torch.Tensor) -> torch.Tensor:
        """The index in the whole last dimension of its largest element
        (the first of equal ones), outside autograd."""
        idx = x.argmax(-1)
        top = x.gather(-1, idx[..., None])[..., 0]
        best = self.reduce(top, "max")
        limit = torch.iinfo(torch.int64).max
        return self.reduce(torch.where(top == best, idx + self.vocab_offset, limit), "min")

    def kv_source(self, j: int) -> tuple[int, int]:
        """The first rank that holds kv head ``j`` in heads mode, and its
        index among that rank's kv heads."""
        rank = next(r for r in range(self.count)
                    if self._kv_first_of(r) <= j < self._kv_first_of(r) + self.kv_heads)
        return rank, j - self._kv_first_of(rank)

    def _kv_first_of(self, rank: int) -> int:
        # global q head h reads kv head h // q_per_kv
        if self.kv_sliced:
            return rank * self.heads // self.q_per_kv
        return rank * self.kv_heads

    def heads_to_head_dim(self, send: torch.Tensor, kv_total: int) -> torch.Tensor:
        """K/V in heads mode to the decode cache's layout (every kv head,
        this rank's ``head_dim`` columns) in one all-to-all: ``send`` is
        (count, ..., kv_heads, c), block ``i`` this rank's kv heads at rank
        ``i``'s columns; returns (..., kv_total, c), each kv head from the
        first rank that holds it."""
        recv = _all_to_all(send, self.group)
        out = recv.new_empty((*recv.shape[1:-2], kv_total, recv.shape[-1]))
        for j in range(kv_total):
            rank, local = self.kv_source(j)
            out[..., j, :] = recv[rank, ..., local, :]
        return out


@dataclasses.dataclass(frozen=True)
class AttnBatchSplit:
    """The attention batch layout of the active rules on the active mesh:
    the batch of attention is split over one more mesh axis than the
    batch (``rules["attn_batch"]`` is ``rules["batch"]`` plus ``axis``).

    Outside attention the step is tensor parallel with the attention's
    output whole on every rank
    (:func:`repro_torch.training.step.make_sharded_train_step`), so the
    layout means: each rank of ``axis`` takes its share of the
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
