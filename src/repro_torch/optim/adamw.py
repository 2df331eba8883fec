"""AdamW, written out by hand (counterpart of :mod:`repro.optim.adamw`).

An ``(init, update)`` pair on dicts of tensors keyed by parameter name
(the model's state-dict names).  The arithmetic is the reference's, in
its order: the global-norm clip in float32, float32 moments whatever the
parameter dtype, bias correction at the new step, ``u = m^ / (sqrt(v^) +
eps) + wd p``, then ``p += (-lr u)`` rounded to the parameter's dtype.
This is not ``torch.optim.AdamW``, whose decoupled decay multiplies ``p``
by ``1 - lr wd`` before the step and rounds differently.

The state is ``{"mu": {name: float32}, "nu": {name: float32}, "step":
int}``; ``update`` replaces its tensors as it goes (the old moments are
freed leaf by leaf, so a large model holds one copy of them) and returns
it with the updates, each in its parameter's dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable       # (grads, state, params) -> (updates, state)


def global_norm(grads: dict[str, torch.Tensor], reduce=None) -> torch.Tensor:
    """The float32 L2 norm of every leaf together (the sum over leaves in
    dict order).  ``reduce`` takes the leaves' sums of squares and returns
    the whole gradients' (the leaves being a rank's shards)."""
    sums = [torch.sum(g * g) for g in (g.float() for g in grads.values())]
    return torch.sqrt(sum(sums if reduce is None else reduce(sums)))


def clip_by_global_norm(grads: dict[str, torch.Tensor], grad_clip: float,
                        gnorm: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """Float32 copies of ``grads`` scaled by ``min(1, clip / max(|g|,
    1e-12))``, ``|g|`` the global norm: :func:`global_norm` of ``grads``,
    or ``gnorm`` where the caller holds shards of the gradients and took
    the norm of the whole (the sharded step)."""
    g32 = {n: g.float() for n, g in grads.items()}
    if gnorm is None:
        gnorm = global_norm(g32)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {n: g * scale for n, g in g32.items()}


def learning_rate(lr, step: int) -> float:
    """``lr`` at ``step``: a constant, or a schedule called with the step."""
    return float(lr(step)) if callable(lr) else float(lr)


def adamw(lr: float | Callable[[int], float], *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1, grad_clip: float = 1.0) -> Optimizer:
    def init(params: dict[str, torch.Tensor]) -> dict:
        return {
            "mu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for n, p in params.items()},
            "nu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for n, p in params.items()},
            "step": 0,
        }

    def update(grads: dict, state: dict, params: dict, *, gnorm: torch.Tensor | None = None
               ) -> tuple[dict, dict]:
        step = state["step"] + 1
        g32 = clip_by_global_norm(grads, grad_clip, gnorm)
        f32 = torch.float32
        bc1 = 1 - torch.tensor(b1, dtype=f32) ** torch.tensor(step, dtype=f32)
        bc2 = 1 - torch.tensor(b2, dtype=f32) ** torch.tensor(step, dtype=f32)
        lr_t = learning_rate(lr, step)
        mu, nu = state["mu"], state["nu"]
        updates = {}
        for n, p in params.items():
            g = g32.pop(n)
            mu[n] = b1 * mu[n] + (1 - b1) * g
            nu[n] = b2 * nu[n] + (1 - b2) * g * g
            del g
            mhat = mu[n] / bc1.to(p.device)
            vhat = nu[n] / bc2.to(p.device)
            u = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.detach().float()
            updates[n] = (-lr_t * u).to(p.dtype)
        state["step"] = step
        return updates, state

    return Optimizer(init=init, update=update)


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor], updates: dict[str, torch.Tensor]) -> None:
    """``p += u`` in the parameter's dtype, in place, for every leaf."""
    for n, p in params.items():
        p.add_(updates[n].to(p.dtype))
