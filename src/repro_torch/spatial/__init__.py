"""Plan execution of the port: the per-slot HALP segment executor."""
from .partition_apply import run_plan, segment_forward

__all__ = ["run_plan", "segment_forward"]
