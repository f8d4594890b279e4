"""Plan execution of the port: the per-slot HALP segment executor and the
height-sharded spatial engine with its halo exchange."""
from .comm import Comm, DistComm, LocalComm
from .halo import (
    conv2d_spatial,
    exchange_halos,
    features_spatial,
    halo_sizes,
    max_pool_spatial,
    merge_padded_shards,
    plan_shard_heights,
    shard_heights,
    spatial_alignment,
    to_padded_shards,
)
from .partition_apply import run_plan, segment_forward

__all__ = [
    "Comm",
    "DistComm",
    "LocalComm",
    "conv2d_spatial",
    "exchange_halos",
    "features_spatial",
    "halo_sizes",
    "max_pool_spatial",
    "merge_padded_shards",
    "plan_shard_heights",
    "run_plan",
    "segment_forward",
    "shard_heights",
    "spatial_alignment",
    "to_padded_shards",
]
