"""Fault tolerance of the port's trainer (twin of ``repro/runtime/fault.py``):
checkpoint/restart with bounded retries, straggler statistics, and the feed
of step times to the online planner's compute-rate estimate.

* **checkpoint/restart** -- the trainer checkpoints every K steps and replays
  the deterministic data stream from the restored step; a step-level failure
  (a ``RuntimeError``: a refused kernel launch, a device error, an injected
  fault) restores the newest checkpoint this run wrote and continues, within
  a budget of consecutive failures.
* **straggler statistics** -- per-step wall times feed an EMA; steps slower
  than ``straggler_factor`` x the EMA are counted, and each newly completed
  step's time can feed a ``compute_observer``
  (``core.replan.ComputeRateEstimator.observe``).
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["FaultConfig", "FaultTolerantTrainer", "InjectedFault", "TrainerStats"]


class InjectedFault(RuntimeError):
    """Raised by tests and chaos hooks to simulate a node failure."""


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class FaultConfig:
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    max_failures: int = 3
    straggler_factor: float = 2.5
    ema_alpha: float = 0.1


@dataclass
class TrainerStats:
    steps: int = 0
    failures: int = 0
    restores: int = 0
    stragglers: int = 0
    ema_step_s: float = 0.0
    losses: list = field(default_factory=list)


def _synchronize(metrics: dict) -> None:
    """Wait for the devices the step's metrics lie on (JAX's
    ``block_until_ready``), so the step's time is its work's."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            torch.cuda.synchronize(v.device)


class FaultTolerantTrainer:
    """Wraps a train step with checkpoint/restart and straggler statistics.

    ``step_fn(state, **batch) -> (state, metrics)`` must return a new state
    and leave the one it is given intact (the port's steps do: AdamW is
    functional); ``stream.batch_at(i)`` must be deterministic in ``i``.

    With ``compute_observer`` and ``step_flops`` set, every *newly
    completed* step's wall time is reported as ``compute_observer(es_name,
    step_flops, dt)``.  Steps replayed after a restore are deduplicated by
    step index before the stats and the observer, so a fault feeds neither
    twice."""

    def __init__(self, step_fn: Callable, stream, cfg: FaultConfig,
                 fault_hook: Callable[[int], None] | None = None,
                 compute_observer: Callable[[str, float, float], None] | None = None,
                 es_name: str = "host",
                 step_flops: float | None = None):
        self.step_fn = step_fn
        self.stream = stream
        self.cfg = cfg
        self.fault_hook = fault_hook
        self.compute_observer = compute_observer
        self.es_name = es_name
        self.step_flops = step_flops
        self.stats = TrainerStats()
        self._tracked_upto = 0  # stats watermark: first step index not yet counted

    def _maybe_restore(self, state):
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return state, 0
        state, step, _ = restore_checkpoint(self.cfg.ckpt_dir, state)
        self.stats.restores += 1
        return state, step

    def run(self, state, n_steps: int, start_step: int = 0, resume: bool = True):
        if resume:
            state, start_step = self._maybe_restore(state)
        # steps below the run's start are re-executed for real (a fresh
        # resume=False run on a reused trainer): lower the watermark so they
        # count; replays within a run stay deduplicated
        self._tracked_upto = min(self._tracked_upto, start_step)
        # The entry state, kept by reference (the step never writes into a
        # state): a fault before the first checkpoint rewinds the state
        # together with the step index, so no batch is applied twice.
        entry_state = state
        i = start_step
        high_water = start_step  # furthest step completed in this run
        consecutive_failures = 0
        while i < n_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(i)  # chaos injection point
                batch = self.stream.batch_at(i)
                t0 = time.time()
                state, metrics = self.step_fn(state, **batch)
                _synchronize(metrics)
                dt = time.time() - t0
                self._track(i, dt, metrics)
                i += 1
                # new progress (not a replayed step) refills the retry budget:
                # it bounds consecutive unrecovered failures
                if i > high_water:
                    high_water = i
                    consecutive_failures = 0
                if i % self.cfg.ckpt_every == 0 or i == n_steps:
                    save_checkpoint(self.cfg.ckpt_dir, i, state)
            except (InjectedFault, RuntimeError) as e:
                consecutive_failures += 1
                self.stats.failures += 1
                if consecutive_failures > self.cfg.max_failures:
                    raise RuntimeError(
                        f"exceeded {self.cfg.max_failures} consecutive failures; last: {e}"
                    ) from e
                # restore the newest checkpoint only if this run could have
                # written it (within [start_step, high_water]); else replay
                # from the entry state
                step = latest_step(self.cfg.ckpt_dir)
                if step is not None and start_step <= step <= high_water:
                    state, i = self._maybe_restore(state)[0], step
                else:
                    state, i = entry_state, start_step
        return state, self.stats

    def _track(self, step: int, dt: float, metrics):
        if step < self._tracked_upto:  # a replayed step: counted once already
            return
        self._tracked_upto = step + 1
        s = self.stats
        if s.ema_step_s == 0.0:
            s.ema_step_s = dt
        elif dt > self.cfg.straggler_factor * s.ema_step_s:
            s.stragglers += 1
        s.ema_step_s = (1 - self.cfg.ema_alpha) * s.ema_step_s + self.cfg.ema_alpha * dt
        s.steps += 1
        loss = metrics.get("total", metrics.get("loss", metrics.get("ce")))
        if loss is not None:
            s.losses.append(float(loss))
        if self.compute_observer is not None and self.step_flops:
            self.compute_observer(self.es_name, self.step_flops, dt)
