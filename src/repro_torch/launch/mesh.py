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
:func:`~repro_torch.distributed.sharding.logical_constraint` and the
attention batch layout (:func:`~repro_torch.distributed.sharding.attn_batch_split`)
read it.  :func:`fake_world` builds a production mesh in one process,
over a process group that moves no data, for the dry run.
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


# the reference's production meshes: shape and axis names
PRODUCTION_MESHES = {"single_pod": ((16, 16), ("data", "model")),
                     "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def production_axis_sizes(multi_pod: bool = False) -> dict[str, int]:
    """Each axis of a production mesh and its size."""
    shape, axes = PRODUCTION_MESHES["multi_pod" if multi_pod else "single_pod"]
    return dict(zip(axes, shape))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``."""
    return _make_mesh(*PRODUCTION_MESHES["multi_pod" if multi_pod else "single_pod"])


# the ranks of the fake world: the larger production mesh's
FAKE_WORLD = 512


@contextlib.contextmanager
def fake_world(*, multi_pod: bool = False, mesh_shape: tuple | None = None):
    """A production mesh (:func:`make_production_mesh`) seen from rank 0 of
    a ``"fake"`` process group of :data:`FAKE_WORLD` ranks, in this process
    alone; the group is destroyed when the block ends.  ``mesh_shape``
    takes another mesh instead, ``("data", "model")`` or, of three axes,
    ``("pod", "data", "model")``, over a fake group of its own size (the
    (2, 4) debug mesh of the tests).

    The fake group takes every collective and moves nothing, so the dry
    run traces a rank's step on ``meta`` tensors with its collectives in
    place (``single_pod`` takes the world's first 256 ranks).  It refuses
    to open while a process group is initialized: that group belongs to
    someone else (the smoke's NCCL world, the 8-process gloo tests), and
    the process has one default group, which this would replace and then
    destroy."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialized in this "
                           "process; trace the production meshes in a process of their own")
    world = FAKE_WORLD if mesh_shape is None else math.prod(mesh_shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        if mesh_shape is None:
            yield make_production_mesh(multi_pod=multi_pod)
        else:
            yield _make_mesh(tuple(mesh_shape), ("data", "model") if len(mesh_shape) == 2
                             else ("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


def make_debug_mesh(shape: tuple = (2, 2), axes: tuple = ("data", "model")):
    """A small mesh for integration tests (8 gloo processes on the CPU, a
    world of one on a card)."""
    return _make_mesh(tuple(shape), tuple(axes))
