"""Activation-sharding hints (twin of ``repro/parallel/hints.py``): models
call ``constrain(x, name)`` at annotated points; the dry run (or a variant)
installs a :class:`~.sharding.Sharding` for the names it wants to pin.
Default: no rule, so models stay mesh-agnostic.  A DTensor (the dry run's
collective pass) is redistributed to the rule's sharding, as
``with_sharding_constraint`` reshards under GSPMD."""
from __future__ import annotations

import torch

__all__ = ["set_rules", "clear_rules", "constrain"]

_RULES: dict[str, object] = {}


def set_rules(rules: dict[str, object]) -> None:
    global _RULES
    _RULES = dict(rules)


def clear_rules() -> None:
    _RULES.clear()


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` itself.  Where a rule for ``name`` is installed, its shard shape
    of ``x`` is taken (raising, as the pinned sharding would, where it does
    not fit ``x``); the value is never touched, as JAX's
    ``with_sharding_constraint`` leaves it.  One process holds the whole
    tensor, so there is nothing to reshard, except a DTensor: it is
    redistributed to the rule's sharding (the same value)."""
    sharding = _RULES.get(name)
    if sharding is not None:
        sharding.shard_shape(tuple(x.shape))
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            from .placements import placements

            return x.redistribute(x.device_mesh, placements(sharding))
    return x
