"""The spatial engine's shard group (twin of ``repro/launch/mesh.py:
make_spatial_mesh``)."""
from __future__ import annotations

import torch

from .. import resolve_device
from ..spatial.comm import LocalComm

__all__ = ["make_spatial_comm"]


def make_spatial_comm(n: int, *, device: str | torch.device = "cuda") -> LocalComm:
    """``n`` height shards held by this process on ``device`` (the card unless
    ``device="cpu"``; raises when the card is asked for and absent).  A
    capacity-weighted deployment keeps this equal-block group and encodes the
    skew in the padded shard layout (``spatial.halo.shard_heights``)."""
    return LocalComm(n, resolve_device(device))
