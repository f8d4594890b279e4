"""Runtime of the port: the batching engine, admission and trace-scale
serving, the traffic models, and checkpoint/restart training."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .fault import FaultConfig, FaultTolerantTrainer, InjectedFault, TrainerStats
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
    "FaultConfig",
    "FaultTolerantTrainer",
    "FlashCrowdProcess",
    "InjectedFault",
    "PoissonProcess",
    "Request",
    "ServeConfig",
    "ServeLoopConfig",
    "ServedTrace",
    "Trace",
    "TrainerStats",
    "VirtualClock",
    "choose_batch_size",
    "latest_step",
    "make_trace",
    "plan_aware_batch_size",
    "restore_checkpoint",
    "save_checkpoint",
    "serve_trace",
]
