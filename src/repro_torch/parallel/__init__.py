"""The port's parallel modules: sharding rules over the production mesh,
activation hints, GPipe over a ``Comm``, and the spatial engine's input
layout."""
from .pipeline import bubble_fraction, pipeline_apply
from .sharding import (
    Sharding,
    input_shardings,
    param_shardings,
    shard_rules,
    state_shardings,
    weighted_spatial_inputs,
)

__all__ = ["Sharding", "bubble_fraction", "input_shardings", "param_shardings", "pipeline_apply", "shard_rules",
           "state_shardings", "weighted_spatial_inputs"]
