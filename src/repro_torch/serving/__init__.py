"""Serving: the continuously batched solve service and its multi-round
sessions, the batched prefill/decode engine for the language models, its
slot admission, and the fault-injection hook (counterpart of
:mod:`repro.serving`)."""

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
from repro_torch.serving.solve_service import (  # noqa: F401
    SessionRoundError,
    SolveService,
    SolveSession,
)
