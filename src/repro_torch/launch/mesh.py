"""Meshes (twin of ``repro/launch/mesh.py``): the production mesh the
sharding rules are written for, and the spatial engine's shard group.

The production mesh is a value, :class:`Mesh`: its axis names in order and
their sizes.  One process cannot hold a ``DeviceMesh`` of 256 or 512 ranks
without starting a process group, and the rules and the dry run read only
the names and sizes (JAX's dry run forces 512 host devices only to name its
mesh)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import resolve_device
from ..spatial.comm import LocalComm

__all__ = [
    "Mesh",
    "make_production_mesh",
    "make_spatial_comm",
    "mesh_axes",
    "dp_axes",
    "fsdp_axes",
]


@dataclass(frozen=True)
class Mesh:
    """A device mesh by its axes: ``axis_names`` in order, ``sizes`` the
    devices along each."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axes {self.axis_names} do not fit sizes {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in the mesh's order (JAX's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 devices per pod; 2x16x16 = 512 devices across two pods."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_spatial_comm(n: int, *, device: str | torch.device = "cuda") -> LocalComm:
    """``n`` height shards held by this process on ``device`` (the card unless
    ``device="cpu"``; raises when the card is asked for and absent).  A
    capacity-weighted deployment keeps this equal-block group and encodes the
    skew in the padded shard layout (``spatial.halo.shard_heights``)."""
    return LocalComm(n, resolve_device(device))


def mesh_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def dp_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes carrying data parallelism (batch sharding)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def fsdp_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes over which large models additionally shard parameters (ZeRO-3)."""
    return dp_axes(mesh)
