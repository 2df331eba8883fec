"""Learning-rate schedules (counterpart of :mod:`repro.optim.schedule`)."""

from __future__ import annotations

import numpy as np


def cosine_schedule(peak_lr: float, *, warmup_steps: int = 100, total_steps: int = 10000,
                    min_ratio: float = 0.1):
    """``lr(step)``: linear warmup to ``peak_lr`` over ``warmup_steps``,
    then a cosine decay to ``min_ratio * peak_lr`` at ``total_steps``.
    Computed in float32, as the reference's jnp arithmetic; returns a
    Python float."""
    f32 = np.float32

    def lr(step) -> float:
        step = f32(step)
        warm = f32(peak_lr) * step / f32(max(warmup_steps, 1))
        frac = np.clip((step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(peak_lr) * (f32(min_ratio) + f32(1 - min_ratio) * f32(0.5)
                              * (f32(1) + np.cos(f32(np.pi) * frac)))
        return float(warm if step < warmup_steps else cos)

    return lr
