"""Next-token cross-entropy with padded-vocab masking and ignore ids
(counterpart of :mod:`repro.training.loss`)."""

from __future__ import annotations

import torch

IGNORE_ID = -1


def token_count(targets: torch.Tensor) -> torch.Tensor:
    """The loss's denominator: the targets that are not :data:`IGNORE_ID`,
    counted as a 0-d float32 tensor of at least 1."""
    return (targets != IGNORE_ID).float().sum().clamp_min(1.0)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor, vocab: int, *,
                       z_loss: float = 1e-4, split=None) -> tuple[torch.Tensor, dict]:
    """``logits`` (B, S, vocab_padded), ``targets`` (B, S) with
    :data:`IGNORE_ID` where masked.  Returns ``(ce + z_loss term,
    metrics)``, metrics ``ce``, ``z_loss``, ``accuracy`` and ``tokens`` as
    0-d float32 tensors.  The padded vocab rows take ``-1e30`` (no
    probability mass); ``z_loss`` weighs the squared log-normalizer (logit
    drift).

    ``split`` (a :class:`~repro_torch.distributed.sharding.ModelSplit`):
    ``logits`` are this rank's vocab columns, and the loss is the
    vocab-parallel one: the row max, the sum of exponentials and the
    target's logit are reduced over ``"model"``, the padded columns stay
    masked by their index in the whole vocab, and the result is equal on
    every rank."""
    vp = logits.shape[-1]
    first = 0 if split is None else split.vocab_offset
    whole = vp if split is None else vp * split.count
    logits = logits.float()
    if whole > vocab:
        pad = torch.arange(first, first + vp, device=logits.device) >= vocab
        logits = torch.where(pad, -1e30, logits)
    targets = torch.as_tensor(targets, device=logits.device).long()
    tgt = targets.clamp(0, vocab - 1)
    if split is None:
        lse = torch.logsumexp(logits, dim=-1)                   # (B, S)
        true_logit = torch.gather(logits, -1, tgt[..., None])[..., 0]
        top = logits.argmax(-1)
    else:
        lse, true_logit = split.logsumexp(logits), split.pick(logits, tgt)
        top = split.argmax(logits.detach())
    nll = lse - true_logit

    mask = (targets != IGNORE_ID).float()
    denom = token_count(targets)
    ce = (nll * mask).sum() / denom
    zl = z_loss * ((lse * mask) ** 2).sum() / denom
    acc = ((top == tgt).float() * mask).sum() / denom
    return ce + zl, {"ce": ce, "z_loss": zl, "accuracy": acc, "tokens": denom}
