"""Planner geometry and the HALP plan, copied from ``repro.core`` (pure Python)."""
from .nets import ConvNetGeom, vgg16_geom
from .partition import (
    HALPPlan,
    PlanInfeasible,
    Segment,
    plan_even,
    plan_halp,
    plan_halp_n,
    split_rows,
)
from .rf import LayerGeom

__all__ = [
    "ConvNetGeom",
    "HALPPlan",
    "LayerGeom",
    "PlanInfeasible",
    "Segment",
    "plan_even",
    "plan_halp",
    "plan_halp_n",
    "split_rows",
    "vgg16_geom",
]
