"""Neighbour exchange between height shards: the port's stand-in for
``shard_map`` plus ``lax.ppermute`` in ``repro/spatial/halo.py``.

The spatial engine (:mod:`repro_torch.spatial.halo`) takes and returns the
list of shards *this process* holds.  A :class:`Comm` says how many shards
there are in all (``n``), which of them the local list holds (``indices``, in
row order), and moves one donation per shard to a neighbour:
``shift(donations, +1)`` is ``ppermute(x, [(i, i + 1) for i in range(n - 1)])``
and ``shift(donations, -1)`` is ``ppermute(x, [(i, i - 1) for i in range(1, n)])``:
shard j receives shard j - 1's (resp. j + 1's) donation and an edge shard,
which has no such neighbour, receives zeros.  Every shard's donation has the
same shape.

* :class:`LocalComm` -- all ``n`` shards in one process on one device (what
  runs on one card).  A received halo is the neighbour's donation itself,
  usually a row-slice view of its shard: nothing is copied.
* :class:`DistComm` -- one shard per rank of a ``torch.distributed`` process
  group, over ``isend``/``irecv``: the form of a multi-device deployment.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

__all__ = ["Comm", "LocalComm", "DistComm"]


class Comm:
    """``n`` height shards in all, of which this process holds ``indices``."""

    n: int
    indices: tuple[int, ...]
    device: torch.device

    def shift(self, donations: Sequence[torch.Tensor], direction: int) -> list[torch.Tensor]:
        """Send each local shard's donation to shard ``index + direction``
        (``direction`` is +1 or -1); returns what each local shard received,
        zeros for an edge shard."""
        raise NotImplementedError

    def _check(self, donations: Sequence[torch.Tensor], direction: int) -> None:
        if direction not in (1, -1):
            raise ValueError(f"direction must be +1 or -1, got {direction}")
        if len(donations) != len(self.indices):
            raise ValueError(f"{len(donations)} donations for {len(self.indices)} local shards")


class LocalComm(Comm):
    """All ``n`` shards held by this process, on ``device``."""

    def __init__(self, n: int, device: str | torch.device):
        if n < 1:
            raise ValueError(f"need at least one shard, got n={n}")
        self.n = n
        self.indices = tuple(range(n))
        self.device = torch.device(device)

    def shift(self, donations, direction):
        self._check(donations, direction)
        edge = torch.zeros_like(donations[0])
        if direction == 1:
            return [edge, *donations[:-1]]
        return [*donations[1:], edge]


class DistComm(Comm):
    """One shard per rank of the default ``torch.distributed`` process group
    (which the caller has initialised); shard index = rank.  Tensors travel
    over ``isend``/``irecv`` of the group's backend (gloo for CPU tensors)."""

    def __init__(self, device: str | torch.device):
        self.n = dist.get_world_size()
        self.indices = (dist.get_rank(),)
        self.device = torch.device(device)

    def shift(self, donations, direction):
        self._check(donations, direction)
        (rank,) = self.indices
        send = donations[0].contiguous()  # kept alive until the send is done
        recv = torch.empty_like(send)
        src, dst = rank - direction, rank + direction
        reqs = []
        # the receive is posted before any wait, so no rank blocks another
        if 0 <= src < self.n:
            reqs.append(dist.irecv(recv, src))
        if 0 <= dst < self.n:
            reqs.append(dist.isend(send, dst))
        for r in reqs:
            r.wait()
        return [recv if 0 <= src < self.n else torch.zeros_like(send)]
