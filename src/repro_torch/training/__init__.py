"""Training substrate: loss, train step, state, metrics (counterpart of
:mod:`repro.training`)."""

from repro_torch.training.loss import IGNORE_ID, cross_entropy_loss  # noqa: F401
from repro_torch.training.step import init_train_state, make_train_step  # noqa: F401
