"""Device meshes over the process group (counterpart of
:mod:`repro.launch.mesh`).

The reference builds ``jax.make_mesh`` over ``jax.devices()``.  Here a
mesh is a named :class:`~torch.distributed.device_mesh.DeviceMesh` over
the ranks of the initialized default process group, one device per rank,
on the group's device type (``"cuda"`` under NCCL, ``"cpu"`` otherwise).
The caller initializes the group (``torch.distributed.init_process_group``
with its own rendezvous: nothing here reads a cluster's environment).  A
mesh smaller than the world takes its first ranks; the others are not
members.  Building a mesh is collective: every rank of the world calls it.

:func:`mesh_context` makes a mesh the active one of this thread, as
:func:`repro_torch.distributed.sharding.use_rules` does rules;
:func:`~repro_torch.distributed.sharding.logical_constraint` reads it.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch.distributed as dist


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None


_CTX = _Ctx()


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the active mesh of this thread inside the block."""
    prev = _CTX.mesh
    _CTX.mesh = mesh
    try:
        yield mesh
    finally:
        _CTX.mesh = prev


def active_mesh():
    return _CTX.mesh


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group: call "
                           "torch.distributed.init_process_group first")
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def _make_mesh(shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    device_type = _device_type()
    n, world = math.prod(shape), dist.get_world_size()
    if world < n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks, the process group has "
                           f"{world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``."""
    if multi_pod:
        return _make_mesh((2, 16, 16), ("pod", "data", "model"))
    return _make_mesh((16, 16), ("data", "model"))


def make_debug_mesh(shape: tuple = (2, 2), axes: tuple = ("data", "model")):
    """A small mesh for integration tests (8 gloo processes on the CPU, a
    world of one on a card)."""
    return _make_mesh(tuple(shape), tuple(axes))
