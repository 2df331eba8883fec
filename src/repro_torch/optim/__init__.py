"""Optimizers: AdamW (baseline), AnalogNewton — the paper's RNM solver
integrated as the SPD-solve backend of a layerwise second-order
preconditioner — the cosine schedule, and the batched Newton/SQP drivers
that push every iteration's linearized systems through ``solve_batch`` or
a solve service session (counterpart of :mod:`repro.optim`)."""

from repro_torch.optim.adamw import adamw  # noqa: F401
from repro_torch.optim.analog_newton import analog_newton  # noqa: F401
from repro_torch.optim.batched_newton import (  # noqa: F401
    BatchedNewtonConfig,
    NewtonTrace,
    newton_batch,
    newton_kkt_batch,
    newton_kkt_looped,
    newton_looped,
)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
