"""Serving runtime of the port: the batching engine, admission and
trace-scale serving, and the traffic models."""
from .serve import (
    BatchingEngine,
    Request,
    ServeConfig,
    ServedTrace,
    ServeLoopConfig,
    VirtualClock,
    choose_batch_size,
    plan_aware_batch_size,
    serve_trace,
)
from .traffic import (
    DeadlineClass,
    DiurnalProcess,
    FlashCrowdProcess,
    PoissonProcess,
    Trace,
    make_trace,
)

__all__ = [
    "BatchingEngine",
    "DeadlineClass",
    "DiurnalProcess",
    "FlashCrowdProcess",
    "PoissonProcess",
    "Request",
    "ServeConfig",
    "ServeLoopConfig",
    "ServedTrace",
    "Trace",
    "VirtualClock",
    "choose_batch_size",
    "make_trace",
    "plan_aware_batch_size",
    "serve_trace",
]
