"""The sharding rules as DTensor placements over the production mesh.

:func:`device_mesh` opens a ``DeviceMesh`` of ``mesh.size`` ranks over the
axes of a :class:`~..launch.mesh.Mesh` value.  One process holds all of it:
the default group is a *fake* one (``torch.testing``'s ``FakeStore`` and
backend), opened for the mesh and destroyed when the context closes, so
nothing else in the process sees it.  Its collectives move nothing; they are
dispatched, and counted (``launch.collectives``), on ``meta`` tensors.

:func:`placements` turns a :class:`~.sharding.Sharding` spec in JAX's form
(one entry per tensor dim: None, an axis name or a tuple of names) into one
``Placement`` per mesh dim.  A tuple shards one tensor dim over several mesh
dims, major to minor, as JAX does; DTensor splits a dim sharded on several
mesh dims in mesh order, so the names of a tuple must come in the mesh's
order (every rule does).  Rank 0's local shape is then
``Sharding.shard_shape`` (:func:`distribute`)."""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from ..launch.mesh import Mesh
from .sharding import Sharding

__all__ = ["device_mesh", "placements", "distribute"]


@contextlib.contextmanager
def device_mesh(mesh: Mesh):
    """A CPU ``DeviceMesh`` over ``mesh``'s axis names and sizes, rank 0's
    view, on a fake default group of ``mesh.size`` ranks; the group is
    destroyed on exit.  While it is open, DTensor moves a sharded dim to
    another by its all-to-all op (``_dtensor.shard_dim_alltoall``), which a
    CPU mesh would replace by an all-gather and a chunk for gloo's sake: the
    fake group moves nothing, and the count is of what a device group would
    issue.  Raises where a default group is already open (a real one must
    not be replaced)."""
    from torch.distributed.tensor import placement_types
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("device_mesh opens its own fake process group; one is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    real = placement_types.shard_dim_alltoall

    def alltoall(t, gather_dim, shard_dim, dmesh, mesh_dim):
        group = dmesh.get_group(mesh_dim).group_name
        return torch.ops._dtensor.shard_dim_alltoall(t, gather_dim, shard_dim, group)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield init_device_mesh("cpu", tuple(mesh.sizes), mesh_dim_names=tuple(mesh.axis_names))
    finally:
        placement_types.shard_dim_alltoall = real
        dist.destroy_process_group()


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(sharding: Sharding) -> tuple[Placement, ...]:
    """One placement per mesh dim: ``Shard(i)`` on each mesh dim that a
    spec entry ``i`` names, ``Replicate()`` on the others."""
    mesh = sharding.mesh
    out: list[Placement] = [Replicate()] * len(mesh.axis_names)
    for i, entry in enumerate(sharding.spec):
        names = _names(entry)
        order = [mesh.axis_names.index(n) for n in names]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in the mesh's order {mesh.axis_names}")
        for j in order:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"mesh axis {mesh.axis_names[j]} shards two dims in {sharding.spec}")
            out[j] = Shard(i)
    return tuple(out)


def distribute(t: torch.Tensor, sharding: Sharding, dmesh: DeviceMesh) -> DTensor:
    """``t`` (any device; ``meta`` in the dry run) as a DTensor laid out by
    ``sharding`` on ``dmesh``: rank 0's block, as ``distribute_tensor``
    takes it."""
    return distribute_tensor(t, dmesh, list(placements(sharding)))

