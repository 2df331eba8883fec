"""Mixture-of-Experts FFN with sort-based dispatch.

Counterpart of :mod:`repro.models.moe`: token-choice top-k routing
(Mixtral/GShard semantics) with a stable argsort over the chosen experts
and a static per-expert capacity.  Within an expert the (token, choice)
pairs keep their flat order ``token * k + j``, and the first ``cap`` of
them are kept; the rest are dropped, as in the reference.

The reference's grouped dispatch is a ``vmap`` of the flat one over
token groups; here every function takes a leading group axis, and the
flat dispatch is one group.  The experts' products are batched matrix
products over the expert axis (``torch.bmm``), left to the library as
the reference leaves them to XLA.

**On a mesh** the reference's groups are those of the global batch: its
``N`` tokens in ``G`` groups of ``N / G`` (``G = dispatch_groups`` in
train and prefill, one flat group at capacity factor 2 in decode), or
one group where ``G`` does not divide ``N``.  A sharded step's rank
holds share ``r`` of ``R`` of the rows (a
:class:`~repro_torch.distributed.sharding.BatchShard`) and dispatches
the reference's groups, not its own: where ``R`` divides ``G`` it holds
``G / R`` whole groups; where ``G`` divides ``R`` its group spans ``R /
G`` ranks (:class:`Span`), and a pair's rank within its expert is the
expert's pairs on the group's earlier ranks (an all-gather of ``2 E``
integers) plus its own, kept below the group's capacity, so the rank
computes only its kept pairs, at most ``min(cap, n)`` slots an expert,
and moves no token.  The aux loss's ``me`` and ``ce`` are the group's
sums over its token count; a rank returns its share of the global
batch's aux loss (the shares sum to it).  Neither dividing the other
raises.

**Over ``"model"``** (a :class:`~repro_torch.distributed.sharding.ModelSplit`
whose ``moe`` is split) the router runs whole on every rank and the
experts on the rank's share: its experts (``"experts"``, expert
parallel) or its ``ff`` columns of every expert (``"ff"``: ``w_gate``
and ``w_up`` column-, ``w_down`` row-parallel).  Megatron's f sits on
the experts' input alone (the router reads the input whole, so its
share of the input's gradient must not be summed over the axis); the
experts' outputs are gathered over the axis (expert parallel) or their
partial sums all-reduced (g) before the combine, which then meets whole
outputs: the combine keeps the one-device order of sums and the
router's gradient comes out whole on every rank with no second
collective (GSPMD, too, reduces the row-parallel product's output).

Two deliberate differences in form, none in value:

* The router product takes ``x`` to float32 first: the reference's
  ``jnp.dot(x, w_router)`` of a bf16 ``x`` and the float32 router
  promotes to float32, where torch's ``@`` refuses mixed dtypes.
* The combine gathers each token's (at most ``k``) kept contributions
  and adds them in ascending expert order, the order of the reference's
  scatter-add over slots, instead of an ``index_add_`` whose atomics
  would add in a different order on every CUDA run.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def moe_capacity(n_tokens: int, n_experts: int, top_k: int, factor: float = 1.25) -> int:
    """Static per-expert capacity, rounded up to a multiple of 8."""
    cap = int(n_tokens * top_k * factor / n_experts) + 1
    return max(((cap + 7) // 8) * 8, 8)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: ties go to the lower index (a
    stable descending sort; ``torch.topk`` promises no tie order)."""
    w, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], i[..., :k]


def _one_hot(i: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(i, n)`` by the operators it runs on ``meta`` (a compare
    with ``arange(n)``, an int64 copy) on every device: on CUDA
    ``F.one_hot`` zero-fills and scatters, so a dry run on meta would count
    another step than the card runs."""
    return (i.unsqueeze(-1) == torch.arange(n, device=i.device)).to(torch.int64)


@dataclasses.dataclass(frozen=True)
class Span:
    """A dispatch group of ``tokens`` tokens that spans ``ranks``
    consecutive batch shards from shard ``first`` (``shard``, a
    :class:`~repro_torch.distributed.sharding.BatchShard`, is this
    rank's place): this rank's tokens follow those of the group's
    earlier shards."""

    shard: object
    first: int
    ranks: int
    tokens: int


def dispatch_plan(n: int, groups: int, shard=None) -> tuple[int, Span | None]:
    """How ``n`` tokens, this rank's share ``shard`` (None: the whole
    batch) of a global batch that the reference dispatches in ``groups``
    groups, dispatch: ``(local groups, span)``, the rank's tokens cut
    into that many whole groups (span None), or one share of a group
    that spans ranks."""
    index, count = (0, 1) if shard is None else (shard.index, shard.count)
    total = n * count
    g = groups if groups > 1 and total % groups == 0 else 1
    if g % count == 0:
        return g // count, None
    if count % g:
        raise NotImplementedError(f"{count} batch shards and {g} MoE dispatch groups: neither "
                                  "divides the other")
    ranks = count // g
    return 1, Span(shard=shard, first=index // ranks * ranks, ranks=ranks, tokens=total // g)


def moe_route(x: torch.Tensor, w_router: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, span: Span | None = None) -> dict:
    """Routing and dispatch of ``x`` (G, n, d), group by group, or with
    ``span`` of ``x`` (1, n, d), this rank's share of a group that spans
    ranks (a collective over the batch shards).

    Returns a dict of tensors: ``top_i``/``top_w`` (G, n, k) the chosen
    experts and their renormalised weights, ``aux`` (G,) the Switch
    load-balancing loss (with ``span`` this rank's share of the group's),
    ``cap`` the capacity, ``block`` the slots an expert a group (``cap``,
    or with ``span`` at most ``n``), and the dispatch over the G * E *
    block slots (group-major, then expert, then rank):
    ``src_for_slot`` the flat token index (``g * n + t``) each slot reads
    (0 where unused, masked by ``used``), ``used`` whether a pair holds the
    slot, and ``pair_slot`` (G, n, k) the slot of each (token, choice)
    pair, ``G * E * block`` (one past the end) where it was dropped.
    """
    g, n, _ = x.shape
    e, k = n_experts, top_k
    cap = moe_capacity(n if span is None else span.tokens, e, k, capacity_factor)
    block = cap if span is None else min(cap, n)
    dev = x.device

    logits = x.float() @ w_router.float()                            # (G, n, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    if span is None:
        me = probs.mean(dim=1)
        ce = _one_hot(top_i[..., 0], e).float().mean(dim=1)
        aux = e * (me * ce).sum(dim=-1)

    nk = n * k
    expert_of = top_i.reshape(g, nk)
    order = torch.argsort(expert_of, dim=-1, stable=True)
    sorted_e = torch.gather(expert_of, 1, order)
    sorted_tok = order // k                                          # token of each pair
    # rank within each expert's contiguous run
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(nk, device=dev) - first
    if span is None:
        keep = rank < cap
    else:
        # the pairs and the top-1 choices of each expert on every shard of
        # the group: the earlier shards' pairs come first in its run
        pairs = torch.searchsorted(sorted_e[0], torch.arange(e + 1, device=dev)).diff()
        top1 = _one_hot(top_i[0, :, 0], e).sum(dim=0)
        every = span.shard.gather(torch.stack([pairs, top1]))[span.first:span.first + span.ranks]
        before = every[:span.shard.index - span.first, 0].sum(dim=0)
        me = probs.sum(dim=1) / span.tokens
        ce = every[:, 1].sum(dim=0).float()[None] / span.tokens
        aux = e * (me * ce).sum(dim=-1)
        keep = rank + before[sorted_e] < cap

    base = torch.arange(g, device=dev)[:, None] * (e * block)
    n_slots = g * e * block                                          # the drop bin
    slot = torch.where(keep, base + sorted_e * block + rank, n_slots)

    src_for_slot = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev)
    src_for_slot[slot] = torch.where(keep, torch.arange(g, device=dev)[:, None] * n + sorted_tok,
                                     0)
    used = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    used[slot] = keep
    pair_slot = torch.empty_like(slot)
    pair_slot.scatter_(1, order, slot)
    return dict(top_i=top_i, top_w=top_w, aux=aux, cap=cap, block=block,
                src_for_slot=src_for_slot[:n_slots], used=used[:n_slots],
                pair_slot=pair_slot.reshape(g, n, k))


def _moe_groups(x: torch.Tensor, p, *, n_experts: int, top_k: int, capacity_factor: float,
                span: Span | None = None, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch of :func:`moe_route` through the experts and back, for
    ``x`` (G, n, d); under ``tp`` (a split MoE) the rank's share of the
    experts.  Returns (y (G, n, d) in x's dtype, aux (G,))."""
    g, n, d = x.shape
    e = n_experts
    r = moe_route(x, p.w_router, n_experts=e, top_k=top_k, capacity_factor=capacity_factor,
                  span=span)
    block = r["block"]

    src, used, mine = r["src_for_slot"], r["used"], e
    if tp is not None:
        x = tp.enter(x)                        # f: the experts read x in part
        if tp.moe == "experts":
            mine, keep = tp.experts, slice(tp.expert_first, tp.expert_first + tp.experts)
            src = src.reshape(g, e, block)[:, keep].reshape(-1)
            used = used.reshape(g, e, block)[:, keep].reshape(-1)
    xe = x.reshape(g * n, d)[src]
    xe = torch.where(used[:, None], xe, torch.zeros_like(xe))
    # (G, E, block, d) -> (E, G * block, d): one batched product per weight
    xe = xe.reshape(g, mine, block, d).transpose(0, 1).reshape(mine, g * block, d)
    gate = torch.bmm(xe, p.w_gate)
    up = torch.bmm(xe, p.w_up)
    h = F.silu(gate.float()).to(x.dtype) * up
    ye = torch.bmm(h, p.w_down)                                      # (E, G * block, d)
    if tp is not None and tp.moe == "experts":
        # every expert's output, whole: each rank's experts gathered (the
        # last ranks' shares padded to the first's, as the leaves split)
        per = -(-e // tp.count)
        if mine < per:
            ye = F.pad(ye, (0, 0, 0, 0, 0, per - mine))
        ye = tp.gather_experts(ye)[:e]
    elif tp is not None:
        ye = tp.exit(ye)                       # g: the partial sums over ff
    ye = ye.reshape(e, g, block, d).transpose(0, 1).reshape(g * e * block, d)

    # combine: each (token, choice) pair owns at most one slot; add a
    # token's kept contributions in ascending expert order, from zero
    ye = torch.cat([ye.float(), ye.new_zeros((1, d), dtype=torch.float32)])
    by_expert = torch.argsort(r["top_i"], dim=-1)
    slots = torch.gather(r["pair_slot"], 2, by_expert)               # (G, n, k)
    weights = torch.gather(r["top_w"], 2, by_expert)
    y = torch.zeros((g, n, d), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        y = y + ye[slots[..., j]] * weights[..., j, None]
    return y.to(x.dtype), r["aux"]


def moe_ffn(x: torch.Tensor, p, *, n_experts: int, top_k: int, groups: int = 1,
            capacity_factor: float = 1.25, shard=None, tp=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (N, d) flat tokens, dispatched in ``groups`` groups (flat where
    ``groups`` does not divide the global token count, as the reference
    does).  Returns (y (N, d), aux_loss ()): the mean of the groups' aux
    losses, or on a mesh this rank's share of the global batch's.

    p: ``w_router`` (d, E) float32, ``w_gate``/``w_up`` (E, d, f),
    ``w_down`` (E, f, d), or under ``tp`` (a
    :class:`~repro_torch.distributed.sharding.ModelSplit`) its share.
    ``shard`` (a :class:`~repro_torch.distributed.sharding.BatchShard`):
    ``x`` is that share of a sharded step's global batch.
    """
    n, d = x.shape
    local, span = dispatch_plan(n, groups, shard)
    y, aux = _moe_groups(x.reshape(local, n // local, d), p, n_experts=n_experts, top_k=top_k,
                         capacity_factor=capacity_factor, span=span, tp=tp)
    aux = aux[0] if local == 1 else aux.mean()
    if shard is not None:
        # the rank's share of the mean over the global batch's groups
        aux = aux / (shard.count if span is None else shard.count // span.ranks)
    return y.reshape(n, d), aux

