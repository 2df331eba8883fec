"""Optimizers: the batched Newton/SQP drivers that push every
iteration's linearized systems through ``solve_batch`` or a solve
service session (the batched-Newton part of :mod:`repro.optim`)."""

from repro_torch.optim.batched_newton import (  # noqa: F401
    BatchedNewtonConfig,
    NewtonTrace,
    newton_batch,
    newton_kkt_batch,
    newton_kkt_looped,
    newton_looped,
)
