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


def moe_route(x: torch.Tensor, w_router: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25) -> dict:
    """Routing and dispatch of ``x`` (G, n, d), group by group.

    Returns a dict of tensors: ``top_i``/``top_w`` (G, n, k) the chosen
    experts and their renormalised weights, ``aux`` (G,) the Switch
    load-balancing loss, ``cap`` the capacity, and the dispatch over the
    G * E * cap slots (group-major, then expert, then rank):
    ``src_for_slot`` the flat token index (``g * n + t``) each slot reads
    (0 where unused, masked by ``used``), ``used`` whether a pair holds the
    slot, and ``pair_slot`` (G, n, k) the slot of each (token, choice)
    pair, ``G * E * cap`` (one past the end) where it was dropped.
    """
    g, n, _ = x.shape
    e, k = n_experts, top_k
    cap = moe_capacity(n, e, k, capacity_factor)
    dev = x.device

    logits = x.float() @ w_router.float()                            # (G, n, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=1)
    ce = F.one_hot(top_i[..., 0], e).float().mean(dim=1)
    aux = e * (me * ce).sum(dim=-1)

    nk = n * k
    expert_of = top_i.reshape(g, nk)
    order = torch.argsort(expert_of, dim=-1, stable=True)
    sorted_e = torch.gather(expert_of, 1, order)
    sorted_tok = order // k                                          # token of each pair
    # rank within each expert's contiguous run
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(nk, device=dev) - first
    keep = rank < cap
    base = torch.arange(g, device=dev)[:, None] * (e * cap)
    n_slots = g * e * cap                                            # the drop bin
    slot = torch.where(keep, base + sorted_e * cap + rank, n_slots)

    src_for_slot = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev)
    src_for_slot[slot] = torch.where(keep, torch.arange(g, device=dev)[:, None] * n + sorted_tok,
                                     0)
    used = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    used[slot] = keep
    pair_slot = torch.empty_like(slot)
    pair_slot.scatter_(1, order, slot)
    return dict(top_i=top_i, top_w=top_w, aux=aux, cap=cap, src_for_slot=src_for_slot[:n_slots],
                used=used[:n_slots], pair_slot=pair_slot.reshape(g, n, k))


def _moe_groups(x: torch.Tensor, p, *, n_experts: int, top_k: int,
                capacity_factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch of :func:`moe_route` through the experts and back, for
    ``x`` (G, n, d).  Returns (y (G, n, d) in x's dtype, aux (G,))."""
    g, n, d = x.shape
    e = n_experts
    r = moe_route(x, p.w_router, n_experts=e, top_k=top_k, capacity_factor=capacity_factor)
    cap = r["cap"]

    xe = x.reshape(g * n, d)[r["src_for_slot"]]
    xe = torch.where(r["used"][:, None], xe, torch.zeros_like(xe))
    # (G, E, cap, d) -> (E, G * cap, d): one batched product per weight
    xe = xe.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    gate = torch.bmm(xe, p.w_gate)
    up = torch.bmm(xe, p.w_up)
    h = F.silu(gate.float()).to(x.dtype) * up
    ye = torch.bmm(h, p.w_down)                                      # (E, G * cap, d)
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g * e * cap, d)

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


def moe_ffn(x: torch.Tensor, p, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (N, d) flat tokens.  Returns (y (N, d), aux_loss ()).

    p: ``w_router`` (d, E) float32, ``w_gate``/``w_up`` (E, d, f),
    ``w_down`` (E, f, d).
    """
    y, aux = _moe_groups(x[None], p, n_experts=n_experts, top_k=top_k,
                         capacity_factor=capacity_factor)
    return y[0], aux[0]


def moe_ffn_grouped(x: torch.Tensor, p, *, n_experts: int, top_k: int, groups: int,
                    capacity_factor: float = 1.25) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-local dispatch: the N tokens split into ``groups`` groups that
    route, sort and fill their own capacity.  Runs the flat dispatch when
    ``groups`` does not divide N, as the reference does.  Returns
    (y (N, d), the groups' mean aux loss)."""
    n, d = x.shape
    if n % groups != 0:
        return moe_ffn(x, p, n_experts=n_experts, top_k=top_k, capacity_factor=capacity_factor)
    y, aux = _moe_groups(x.reshape(groups, n // groups, d), p, n_experts=n_experts,
                         top_k=top_k, capacity_factor=capacity_factor)
    return y.reshape(n, d), aux.mean()
