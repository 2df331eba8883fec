"""Distributed runtime (counterpart of :mod:`repro.distributed`): the
logical-axis sharding rules, the per-architecture rules (``rules``), int8
gradient compression (``compression``), elastic re-meshing (``elastic``),
straggler tracking (``straggler``), and the solver mesh, the solve
service's device streams and their circuit breaker."""

from repro_torch.distributed.sharding import (  # noqa: F401
    LOGICAL_RULES_MULTI_POD,
    LOGICAL_RULES_SINGLE_POD,
    SolverMesh,
    StreamBreaker,
    logical_constraint,
    logical_spec,
    param_specs,
    shard_system_batch,
    solver_mesh,
    stream_devices,
    use_rules,
)
