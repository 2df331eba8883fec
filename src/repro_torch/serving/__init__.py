"""Serving: the batched prefill/decode engine for the dense decoder, its
slot admission, and the fault-injection hook (counterpart of
:mod:`repro.serving`; the solve service is still to be ported)."""

from repro_torch.serving.engine import (  # noqa: F401
    AdmissionQueue,
    Request,
    ServeEngine,
    admission_key,
)
from repro_torch.serving.faults import (  # noqa: F401
    FaultInjected,
    FaultInjector,
    FaultPlan,
    SolveError,
)
