"""repro_torch.core — the analog SPD solver's circuit physics in PyTorch.

Counterpart of :mod:`repro.core`, exporting every name of its
``__all__``:

* specs and op-amp models;
* the Sec. IV transform with the eigen split and the Eq. 20 margin
  (:mod:`~repro_torch.core.transform`), the Eq. 25 passivity test
  (:mod:`~repro_torch.core.sdd`);
* netlists of both designs (:mod:`~repro_torch.core.network`);
* the single-circuit modules: the state space and exact transient of one
  circuit (:mod:`~repro_torch.core.transient`), its operating point
  (:mod:`~repro_torch.core.operating_point`), its crossbar layout
  (:mod:`~repro_torch.core.crosspoint`), component counts (Table II,
  :mod:`~repro_torch.core.components`) and power (Eq. 31,
  :mod:`~repro_torch.core.power`);
* the batched engine (stamp patterns, assembly, DC solve, settling), the
  batched operating point, the digital baselines and the solve API;
* the spectral settling estimator (:mod:`~repro_torch.core.spectral`),
  mixed-precision refinement (:mod:`~repro_torch.core.refine`) and the
  nonlinear RK4 transient (:mod:`~repro_torch.core.transient_nl`),
  which the reference reaches as submodules; their public names are
  exported here too.

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
from repro_torch.core.transform import (  # noqa: F401
    Transformed2N,
    assemble_2n,
    column_abs_sums,
    d_matrix_proposed,
    d_matrix_scaled,
    supply_conductance,
    transform_2n,
)
from repro_torch.core.network import (  # noqa: F401
    Netlist,
    build_preliminary,
    build_preliminary_batch,
    build_proposed,
    build_proposed_batch,
)
from repro_torch.core.transient import (  # noqa: F401
    StateSpace,
    TransientResult,
    assemble_state_space,
    lti_transient,
    settling_time,
)
from repro_torch.core.operating_point import (  # noqa: F401
    BatchOperatingPoint,
    NonIdealities,
    OperatingPoint,
    operating_point,
    operating_point_batch,
)
from repro_torch.core.engine import (  # noqa: F401
    BatchTransientResult,
    BatchedStateSpace,
    StampPattern,
    assemble_batch,
    dc_solve_batch,
    euler_settle_batch,
    pattern_of,
    pattern_union,
    transient_batch,
)
from repro_torch.core.solver import (  # noqa: F401
    BatchSolveResult,
    PendingBatchSolve,
    SolveResult,
    solve,
    solve_batch,
    solve_batch_submit,
)
from repro_torch.core.spectral import (  # noqa: F401
    SpectralBounds,
    amplitude_settle_steps,
    spectral_bounds,
)
from repro_torch.core.refine import (  # noqa: F401
    DEFAULT_REFINE,
    RefineResult,
    RefineSpec,
    fcg_batch,
    refine_batch,
)
from repro_torch.core.solver import PRECISION_PATHS  # noqa: F401
from repro_torch.core.transient_nl import (  # noqa: F401
    BatchNLTrace,
    NLTrace,
    nonlinear_transient,
    nonlinear_transient_batch,
)
from repro_torch.core.sdd import is_diagonally_dominant, sdd_margin  # noqa: F401
from repro_torch.core.power import system_power  # noqa: F401
from repro_torch.core.components import component_counts  # noqa: F401
from repro_torch.core.crosspoint import crosspoint_layout  # noqa: F401

__all__ = [
    "AD712",
    "LTC2050",
    "LTC6268",
    "OPAMPS",
    "CircuitParams",
    "OpAmpSpec",
    "Transformed2N",
    "assemble_2n",
    "column_abs_sums",
    "d_matrix_proposed",
    "d_matrix_scaled",
    "supply_conductance",
    "transform_2n",
    "Netlist",
    "build_preliminary",
    "build_preliminary_batch",
    "build_proposed",
    "build_proposed_batch",
    "StateSpace",
    "TransientResult",
    "assemble_state_space",
    "lti_transient",
    "settling_time",
    "NonIdealities",
    "OperatingPoint",
    "BatchOperatingPoint",
    "operating_point",
    "operating_point_batch",
    "BatchTransientResult",
    "BatchedStateSpace",
    "StampPattern",
    "assemble_batch",
    "dc_solve_batch",
    "euler_settle_batch",
    "pattern_of",
    "pattern_union",
    "transient_batch",
    "SolveResult",
    "BatchSolveResult",
    "PendingBatchSolve",
    "solve",
    "solve_batch",
    "solve_batch_submit",
    "is_diagonally_dominant",
    "sdd_margin",
    "system_power",
    "component_counts",
    "crosspoint_layout",
    "SpectralBounds",
    "amplitude_settle_steps",
    "spectral_bounds",
    "DEFAULT_REFINE",
    "RefineResult",
    "RefineSpec",
    "fcg_batch",
    "refine_batch",
    "PRECISION_PATHS",
    "BatchNLTrace",
    "NLTrace",
    "nonlinear_transient",
    "nonlinear_transient_batch",
]
