"""Train step factory: loss, backward, optional gradient compression and
the optimizer update (counterpart of :mod:`repro.training.step`).

The state is a dict ``{"params": LanguageModel, "opt_state": dict,
"step": int}``: the model's parameters train in place, the optimizer
state (:mod:`repro_torch.optim`) holds float32 tensors keyed by the
model's state-dict names, and the step is a Python int.  The step is
family-agnostic (:func:`~repro_torch.models.model.forward_train`
dispatches) and runs where the model lies: every attention through K8
and its hand-written backward on the card.

:func:`make_sharded_train_step` is the step on a mesh
(:mod:`repro_torch.launch.mesh`), the port of the reference's step under
``jit`` with parameter shardings: FSDP storage and data-parallel compute.
Parameters and AdamW moments live as DTensors placed by
``param_specs(param_logical_axes(cfg), rules)`` (:func:`shard_train_state`).
Each rank takes its rows of the batch, split over the mesh's batch axes
(every axis but ``"model"``).  Every family runs tensor parallel over
``"model"``, as GSPMD splits the reference's step under its rules: each
leaf is gathered over the batch axes alone and keeps its ``"model"``
shard (its q heads or head_dim columns, ``ff`` columns and a GELU MLP's
``b_up``, an MoE's experts or their ``ff`` columns, a Mamba block's
``inner`` columns, vocab rows:
:func:`~repro_torch.models.model.gather_params`), and the rank computes
its share, Megatron's regions meeting in all-reduces over ``"model"``
(:class:`~repro_torch.distributed.sharding.ModelSplit`), the loss
vocab-parallel; inside attention, under the attention batch layout of
the active rules, the rank's share of the rows
(:func:`repro_torch.distributed.sharding.attn_batch_split`).  A leaf
replicated over ``"model"`` that a rank uses in part (a Mamba block's
``w_bc``, B/C conv, ``w_dt``, ``dt_bias``, ``a_log``, ``d_skip``) has its
gradient summed there in the backward, and one used after a region's g
or before its f (the norms, a GELU MLP's ``b_down``, an encdec's
``enc_final_norm``, whose output enters the decoder's cross K/V
projections through one f) takes it whole, so each is whole and equal
on every rank.  An MoE dispatches the reference's groups of the global
batch (:mod:`repro_torch.models.moe`), and its aux loss is the global
batch's.  The gradients, whole or a rank's ``"model"`` shards, are averaged over the
batch axes (weighted by each rank's token count) with ``all_reduce``;
AdamW's global-norm clip is taken over the whole averaged gradients, a
sharded leaf's sum of squares summed over ``"model"`` and a replicated
leaf's counted once; and each rank updates its own shards.  So the step's arithmetic is the one-device
step's but for the order of the sums (bit for bit on a mesh of one).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.elastic import reshard_state
from repro_torch.distributed.sharding import rank_rows
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    forward_train,
    gather_params,
    init_params,
    param_logical_axes,
    release_params,
)
from repro_torch.optim.adamw import Optimizer, apply_updates, global_norm
from repro_torch.training.loss import cross_entropy_loss, token_count

# the MoE load-balancing loss's weight in the train loss (zero aux elsewhere)
AUX_WEIGHT = 0.01


def named_params(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's parameters by state-dict name, in module order."""
    return dict(model.named_parameters())


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, generator: torch.Generator, *,
                     device=None) -> dict:
    """Fresh parameters (``init_params`` from ``generator``, which must
    live on ``device``, default ``"cuda"``), trainable, with the
    optimizer's initial state and step 0."""
    params = init_params(cfg, generator, device=device).requires_grad_(True)
    return {"params": params, "opt_state": optimizer.init(named_params(params)), "step": 0}


def loss_and_grads(model: torch.nn.Module, batch: dict, cfg: ModelConfig, aux_weight: float
                   ) -> tuple[dict, dict[str, torch.Tensor]]:
    """The loss ``ce + aux_weight * aux`` of ``batch`` and its gradient
    for every parameter (zeros where none flows), the model's own
    gradients cleared.  Metrics as :func:`make_train_step`'s, not yet
    detached."""
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        logits, aux = forward_train(model, batch, cfg)
        ce, metrics = cross_entropy_loss(logits, batch["targets"], cfg.vocab,
                                         split=getattr(model, "split", None))
        loss = ce + aux_weight * aux
        metrics["aux"] = aux
        metrics["loss"] = loss
        loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in named_params(model).items()}
    model.zero_grad(set_to_none=True)
    return metrics, grads


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *, aux_weight: float = AUX_WEIGHT,
                    compressor: Optional[Callable] = None):
    """``train_step(state, batch) -> (state, metrics)``: the loss ``ce +
    aux_weight * aux``, its gradients, then ``optimizer.update`` and the
    parameters updated in place.  ``batch`` holds ``tokens`` and
    ``targets`` (B, S), with ``patches`` (vlm) or ``frames`` (encdec).
    Metrics are the loss's (``ce``, ``z_loss``, ``accuracy``, ``tokens``)
    plus ``aux`` and ``loss``, as 0-d tensors.

    compressor: optional ``(grads, error_state) -> (grads, error_state)``
    (int8 error feedback:
    :func:`repro_torch.distributed.compression.compress_int8`); its error
    state rides in ``opt_state["comp_err"]``.
    """

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        model = state["params"]
        metrics, grads = loss_and_grads(model, batch, cfg, aux_weight)
        params = named_params(model)
        if compressor is not None:
            grads, err = compressor(grads, state["opt_state"].get("comp_err"))
        updates, opt_state = optimizer.update(grads, state["opt_state"], params)
        if compressor is not None:
            opt_state = {**opt_state, "comp_err": err}
        del grads
        apply_updates(params, updates)
        new_state = {"params": model, "opt_state": opt_state, "step": state["step"] + 1}
        return new_state, {k: v.detach() for k, v in metrics.items()}

    return train_step


# ---------------------------------------------------------------------------
# the step on a mesh
# ---------------------------------------------------------------------------

def shard_train_state(state: dict, cfg: ModelConfig, mesh, rules) -> dict:
    """An AdamW train state placed on ``mesh`` under ``rules``: ``params``,
    ``mu`` and ``nu`` as ``{name: DTensor}`` by their logical axes
    (:func:`~repro_torch.distributed.elastic.reshard_state`), the steps
    as ints.  ``state`` is a one-device state (:func:`init_train_state`)
    or a sharded one of any mesh, which is how the elastic path re-shards;
    every rank of the old and the new mesh calls it."""
    opt = state["opt_state"]
    if set(opt) != {"mu", "nu", "step"}:
        raise ValueError(f"the sharded step holds AdamW's state (mu, nu, step); got {sorted(opt)}")
    params = state["params"]
    if isinstance(params, torch.nn.Module):
        params = {n: p.detach() for n, p in named_params(params).items()}
    axes = param_logical_axes(cfg)
    return {"params": reshard_state(params, axes, mesh, rules),
            "opt_state": {"mu": reshard_state(opt["mu"], axes, mesh, rules),
                          "nu": reshard_state(opt["nu"], axes, mesh, rules),
                          "step": opt["step"]},
            "step": state["step"]}


def full_params(state: dict) -> dict[str, torch.Tensor]:
    """Copies of a sharded state's parameters gathered whole (a collective
    over its mesh; a replicated leaf's ``full_tensor()`` is its storage,
    which the next step updates in place)."""
    return {n: p.full_tensor().clone() for n, p in state["params"].items()}


def _like(local: torch.Tensor, like):
    """``local`` as the local shard of a DTensor placed as ``like``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def _local_shard(full: torch.Tensor, like, model_shard: bool = False) -> torch.Tensor:
    """This rank's shard of ``full``, placed as ``like``: a local slice.
    ``full`` is whole, or with ``model_shard`` whole but for its
    ``"model"`` shard (a tensor-parallel gradient)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    held = [p if model_shard and a == "model" else Replicate()
            for a, p in zip(mesh.mesh_dim_names, like.placements)]
    whole = DTensor.from_local(full, mesh, held, run_check=False, shape=like.shape,
                               stride=like.stride())
    return whole.redistribute(mesh, like.placements).to_local()


def _model_sums(split, on_model: list):
    """:func:`~repro_torch.optim.adamw.global_norm`'s ``reduce`` for
    gradients held as ``"model"`` shards (the leaves where ``on_model``
    is true) or whole: each sharded leaf's sum of squares summed over
    ``"model"``, a whole one counted once."""
    def reduce(sums: list) -> list:
        return split.reduce(torch.stack([s if m or split.index == 0 else torch.zeros_like(s)
                                         for s, m in zip(sums, on_model)])).unbind()

    return reduce


def _on_model(leaf) -> bool:
    """Whether a DTensor is sharded over its mesh's ``"model"`` axis."""
    names = leaf.device_mesh.mesh_dim_names
    return "model" in names and leaf.placements[names.index("model")].is_shard()


def make_sharded_train_step(cfg: ModelConfig, optimizer: Optimizer, mesh):
    """``train_step(state, batch) -> (state, metrics)`` on ``mesh``, for a
    state from :func:`shard_train_state` and an optimizer whose update
    takes ``gnorm=`` (AdamW).  Every member rank calls it with the same
    global ``batch``; each takes its rows, split contiguously over the
    mesh's batch axes (every axis but ``"model"``, in mesh order), whose
    product must divide the batch.  Metrics are the token-weighted means
    of the ranks' (``tokens`` their sum), equal on every rank.  An MoE's
    dispatch groups, capacity and aux loss are the global batch's, as the
    reference's: each rank's aux loss is its share, taken at ``1 / w`` of
    its weight ``w`` in the loss, so that the token weights leave the
    global aux loss and its gradient whole.  The step is tensor parallel
    over ``"model"`` (the module's docstring)."""
    batch_axes = [a for a in mesh.mesh_dim_names if a != "model"]
    groups = [mesh.get_group(a) for a in batch_axes]
    model = None            # the model the step runs, built at the first call

    def reduce(t: torch.Tensor) -> torch.Tensor:
        for g in groups:
            dist.all_reduce(t, group=g)
        return t

    def weight(tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        total = reduce(tokens.clone())
        return total, tokens / total

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        nonlocal model
        sharded = state["params"]
        model = gather_params(cfg, sharded, model, batch_axes)
        split = model.split
        rows = {k: rank_rows(x, mesh, batch_axes) for k, x in batch.items()}
        total, w = weight(token_count(rows["targets"]))
        metrics, grads = loss_and_grads(model, rows, cfg, AUX_WEIGHT / w)
        release_params(model)
        metrics["aux"] = metrics["aux"] / w
        for g in grads.values():
            reduce(g.mul_(w.to(g.dtype)))
        metrics = {k: total if k == "tokens" else reduce(v.detach() * w)
                   for k, v in metrics.items()}
        gnorm = global_norm(grads, None if split is None else
                            _model_sums(split, [_on_model(sharded[n]) for n in grads]))
        opt = state["opt_state"]
        local = {n: p.to_local() for n, p in sharded.items()}
        local_state = {"mu": {n: m.to_local() for n, m in opt["mu"].items()},
                       "nu": {n: v.to_local() for n, v in opt["nu"].items()},
                       "step": opt["step"]}
        local_grads = {n: _local_shard(grads.pop(n), sharded[n], split is not None)
                       for n in list(grads)}
        updates, local_state = optimizer.update(local_grads, local_state, local, gnorm=gnorm)
        del local_grads
        apply_updates(local, updates)
        new_state = {
            "params": {n: _like(local[n], p) for n, p in sharded.items()},
            "opt_state": {"mu": {n: _like(local_state["mu"][n], p) for n, p in sharded.items()},
                          "nu": {n: _like(local_state["nu"][n], p) for n, p in sharded.items()},
                          "step": local_state["step"]},
            "step": state["step"] + 1,
        }
        return new_state, metrics

    return train_step
