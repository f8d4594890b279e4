"""Input layout of the spatial engine (twin of the spatial half of
``repro/parallel/sharding.py``).

The JAX package places one global array with a ``NamedSharding`` over the
height axis (``spatial_shardings``); here the list of local shards, each on
the comm's device, is that placement, so ``spatial_shardings`` has no
counterpart of its own: it is folded into :func:`weighted_spatial_inputs`.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..spatial.comm import Comm
from ..spatial.halo import plan_shard_heights, to_padded_shards

__all__ = ["weighted_spatial_inputs"]


def weighted_spatial_inputs(
    x: torch.Tensor, plan_or_heights, comm: Comm, *, align: int = 1
) -> tuple[list[torch.Tensor], tuple[int, ...]]:
    """Lay a global image batch out for the capacity-weighted spatial engine.

    ``plan_or_heights`` is an N-way ``plan_even(ratios=...)`` plan (its
    first-layer row shares become the shard heights, re-quantised to
    ``align``: pass ``spatial_alignment(net)``) or explicit heights.  Returns
    ``(shards, heights)``: the padded blocks this process holds (``comm``'s
    indices), on ``comm.device``, which ``conv2d_spatial(heights=...)`` and
    ``max_pool_spatial(heights=...)`` take.  Equal heights give the plain
    equal split, which the unweighted ops take as well."""
    if hasattr(plan_or_heights, "parts"):
        heights = plan_shard_heights(plan_or_heights, align)
    else:
        heights = tuple(int(h) for h in plan_or_heights)
    if len(heights) != comm.n:
        raise ValueError(f"{len(heights)} shard heights for {comm.n} shards")
    blocks = to_padded_shards(x, heights)
    return [blocks[j].to(comm.device) for j in comm.indices], heights
