"""Distributed: the solver mesh, the solve service's device streams and
their circuit breaker (counterpart of the solver part of
:mod:`repro.distributed`)."""

from repro_torch.distributed.sharding import (  # noqa: F401
    SolverMesh,
    StreamBreaker,
    shard_system_batch,
    solver_mesh,
    stream_devices,
)
