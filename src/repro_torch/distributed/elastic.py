"""Elastic scaling: rebuild the mesh from the surviving ranks and re-shard
the training state (counterpart of :mod:`repro.distributed.elastic`).

Failure model: a pod or host drops out of the job (hardware fault,
preemption).  The coordinator

1. discovers the surviving rank count,
2. picks the largest supported mesh that fits (:func:`plan_mesh`),
3. re-places every state leaf onto the new mesh (:func:`reshard_state`),
   checkpoint-free while the state survives on the old mesh, otherwise
   from ``CheckpointManager.restore``'s tensors,
4. rescales the data-parallel batch so the *global* batch stays constant
   (:func:`grad_accum_factor`).

A mesh is a named :class:`~torch.distributed.device_mesh.DeviceMesh`
(:mod:`repro_torch.launch.mesh`) and a placed leaf a
:class:`~torch.distributed.tensor.DTensor`.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.distributed.sharding import param_specs, placements
from repro_torch.launch.mesh import make_debug_mesh

# meshes we will run, largest first: (data, model) per pod
SUPPORTED_MESHES = [
    (2, (16, 16)),
    (1, (16, 16)),
    (1, (8, 16)),
    (1, (8, 8)),
    (1, (4, 8)),
    (1, (4, 4)),
    (1, (2, 4)),
    (1, (2, 2)),
    (1, (1, 2)),
    (1, (1, 1)),
]


@dataclasses.dataclass
class MeshPlan:
    pods: int
    data: int
    model: int

    @property
    def n_devices(self) -> int:
        return self.pods * self.data * self.model

    @property
    def multi_pod(self) -> bool:
        return self.pods > 1

    def build(self):
        """The plan's DeviceMesh over the first ``n_devices`` ranks (a
        collective: every rank of the world calls it)."""
        if self.multi_pod:
            return make_debug_mesh((self.pods, self.data, self.model),
                                   ("pod", "data", "model"))
        return make_debug_mesh((self.data, self.model), ("data", "model"))


def plan_mesh(n_available: int) -> MeshPlan:
    """Largest supported mesh fitting the surviving device count."""
    for pods, (d, m) in SUPPORTED_MESHES:
        if pods * d * m <= n_available:
            return MeshPlan(pods=pods, data=d, model=m)
    raise RuntimeError("no devices available")


def grad_accum_factor(global_batch: int, old_data: int, new_data: int,
                      per_device_batch: int) -> int:
    """Keep the global batch constant when the data axis shrinks."""
    del old_data
    micro = new_data * per_device_batch
    return max(1, math.ceil(global_batch / micro))


def place(x, mesh, spec):
    """``x`` as a DTensor on ``mesh`` with ``spec``'s placements: a DTensor
    of the same mesh is redistributed; one of another mesh is gathered
    whole on its mesh (every rank of that mesh takes part) and then
    distributed; a plain tensor is distributed from rank 0's copy."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    target = placements(spec, mesh)
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, target)
        x = x.full_tensor()
    return distribute_tensor(x.detach(), mesh, target)


def reshard_state(state, logical_axes, mesh, rules):
    """Place every leaf of ``state`` (dicts of tensors, keyed as
    ``logical_axes``) onto ``mesh`` under ``rules``.

    Works from host-resident tensors or from DTensors of this or another
    mesh; every rank of the old and the new mesh calls it.  A leaf that
    needs no data moved (a replicated one, or one already placed so) may
    share its storage with the input's, and the sharded step updates
    parameters in place, as the one-device step does: pass copies to
    keep the input as it was.
    """
    specs = param_specs(logical_axes, rules)

    def walk(x, spec):
        if isinstance(x, dict):
            return {k: walk(v, spec[k]) for k, v in x.items()}
        return place(x, mesh, spec)

    return walk(state, specs)
