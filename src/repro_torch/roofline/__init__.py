"""Roofline of a model step on one card (counterpart of
:mod:`repro.roofline`): the hardware specs and the three-term report
(:mod:`~repro_torch.roofline.analysis`), and the counter of a step's
FLOPs, bytes and live memory (:mod:`~repro_torch.roofline.cost`)."""

from repro_torch.roofline.analysis import (  # noqa: F401
    H100_SXM,
    HardwareSpec,
    bound,
    roofline_report,
    spec_for_card,
)
from repro_torch.roofline.cost import CostCounter  # noqa: F401
