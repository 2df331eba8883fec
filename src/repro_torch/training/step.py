"""Train step factory: loss, backward, optional gradient compression and
the optimizer update (counterpart of :mod:`repro.training.step`).

The state is a dict ``{"params": LanguageModel, "opt_state": dict,
"step": int}``: the model's parameters train in place, the optimizer
state (:mod:`repro_torch.optim`) holds float32 tensors keyed by the
model's state-dict names, and the step is a Python int.  The step is
family-agnostic (:func:`~repro_torch.models.model.forward_train`
dispatches) and runs where the model lies: every attention through K8
and its hand-written backward on the card.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward_train, init_params
from repro_torch.optim.adamw import Optimizer, apply_updates
from repro_torch.training.loss import cross_entropy_loss


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


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *, aux_weight: float = 0.01,
                    compressor: Optional[Callable] = None):
    """``train_step(state, batch) -> (state, metrics)``: the loss ``ce +
    aux_weight * aux``, its gradients, then ``optimizer.update`` and the
    parameters updated in place.  ``batch`` holds ``tokens`` and
    ``targets`` (B, S), with ``patches`` (vlm) or ``frames`` (encdec).
    Metrics are the loss's (``ce``, ``z_loss``, ``accuracy``, ``tokens``)
    plus ``aux`` and ``loss``, as 0-d tensors.

    compressor: optional ``(grads, error_state) -> (grads, error_state)``
    (int8 error feedback in the reference's ``distributed.compression``);
    its error state rides in ``opt_state["comp_err"]``.
    """

    def loss_fn(params, batch):
        logits, aux = forward_train(params, batch, cfg)
        ce, metrics = cross_entropy_loss(logits, batch["targets"], cfg.vocab)
        loss = ce + aux_weight * aux
        metrics["aux"] = aux
        metrics["loss"] = loss
        return loss, metrics

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        model = state["params"]
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, metrics = loss_fn(model, batch)
            loss.backward()
        params = named_params(model)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        model.zero_grad(set_to_none=True)
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
