"""repro_torch.core — the analog SPD solver's circuit physics in PyTorch.

Counterpart of :mod:`repro.core`: specs, the Sec. IV transform,
netlists, the batched engine (stamp patterns, assembly, DC solve,
settling), the operating point, digital baselines and the solve API.
Unlike the reference, importing it changes no global dtype setting: the
port passes float64 and float32 explicitly.
"""

from repro_torch.core.specs import (  # noqa: F401
    AD712,
    LTC2050,
    LTC6268,
    OPAMPS,
    CircuitParams,
    OpAmpSpec,
)
from repro_torch.core.solver import (  # noqa: F401
    BatchSolveResult,
    PendingBatchSolve,
    SolveResult,
    solve,
    solve_batch,
    solve_batch_submit,
)
