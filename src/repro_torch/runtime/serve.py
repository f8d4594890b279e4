"""Serving engine: deadline-aware dynamic batching (twin of the
``BatchingEngine`` of ``repro/runtime/serve.py``).

Requests arrive with a deadline; the batcher takes them earliest-deadline
first, up to ``max_batch`` at a time, stacks their payloads into one batch,
runs the model on it, waits for the device, and hands every request its slice
of the output.  Batches launch when full or when the oldest queued request has
waited ``max_delay_s`` (:meth:`BatchingEngine.ready`).
"""
from __future__ import annotations

import heapq
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["Request", "ServeConfig", "BatchingEngine"]


@dataclass(order=True)
class Request:
    deadline: float
    rid: int = field(compare=False)
    payload: Any = field(compare=False, default=None)
    arrival: float = field(compare=False, default=0.0)
    done: float | None = field(compare=False, default=None)
    result: Any = field(compare=False, default=None)  # per-request model output


@dataclass
class ServeConfig:
    max_batch: int = 8
    max_delay_s: float = 0.002
    pad_to_max: bool = True  # every batch runs max_batch wide (one shape)

    def __post_init__(self) -> None:
        # an engine built with max_batch=0 would busy-loop on empty batches
        if self.max_batch < 1:
            raise ValueError(
                f"max_batch must be >= 1, got {self.max_batch}; an admission "
                f"result of 0 means shed/reject -- do not build an engine on it"
            )


class BatchingEngine:
    """Deadline-aware dynamic batcher around ``fn(stacked_payloads)``.

    Payloads are tensors of one shape; ``fn`` returns a tensor whose leading
    axis is the batch."""

    def __init__(
        self,
        fn: Callable[[torch.Tensor], torch.Tensor],
        cfg: ServeConfig,
        clock: Callable[[], float] = time.monotonic,
        observer: Callable[[int, float], None] | None = None,
        es_observer: Callable[[str, float, float], None] | None = None,
    ):
        self.fn = fn
        self.cfg = cfg
        self.clock = clock
        # called with (batch_size, elapsed_s) after every executed batch
        self.observer = observer
        # called with (es_name, flops, elapsed_s) for every reported per-ES
        # chunk execution (see observe_es_time)
        self.es_observer = es_observer
        self.queue: list[Request] = []  # deadline-ordered heap (EDF)
        self.completed: list[Request] = []
        self._rid = 0
        # arrival-ordered view of the queue for O(1) oldest-pending lookup in
        # ready(); taken rids are pruned off its head lazily
        self._fifo: deque[Request] = deque()
        self._taken: set[int] = set()

    def submit(self, payload: torch.Tensor, deadline_s: float) -> int:
        self._rid += 1
        req = Request(
            deadline=self.clock() + deadline_s,
            rid=self._rid,
            payload=payload,
            arrival=self.clock(),
        )
        heapq.heappush(self.queue, req)
        self._fifo.append(req)
        return self._rid

    def observe_es_time(self, es: str, flops: float, elapsed_s: float) -> None:
        """Per-ES timing hook (``run_plan``'s ``time_observer``): forwards one
        measured compute chunk to ``es_observer``."""
        if self.es_observer is not None:
            self.es_observer(es, flops, elapsed_s)

    def _take_batch(self) -> list[Request]:
        batch = []
        while self.queue and len(batch) < self.cfg.max_batch:
            req = heapq.heappop(self.queue)
            self._taken.add(req.rid)
            batch.append(req)
        return batch

    def _oldest_pending(self) -> Request:
        fifo = self._fifo
        while fifo[0].rid in self._taken:
            self._taken.discard(fifo.popleft().rid)
        return fifo[0]

    def ready(self) -> bool:
        """Whether a batch should launch now: the queue holds a full
        ``max_batch``, or the oldest queued request has waited ``max_delay_s``."""
        if not self.queue:
            return False
        if len(self.queue) >= self.cfg.max_batch:
            return True
        return self.clock() - self._oldest_pending().arrival >= self.cfg.max_delay_s

    def poll(self) -> list[Request]:
        """Run one batch iff :meth:`ready`; otherwise an empty no-op."""
        return self.step() if self.ready() else []

    def step(self) -> list[Request]:
        """Run one batch (earliest-deadline-first).  Returns completed reqs."""
        batch = self._take_batch()
        if not batch:
            return []
        payloads = [r.payload for r in batch]
        n = len(payloads)
        if self.cfg.pad_to_max and n < self.cfg.max_batch:
            payloads = payloads + [payloads[-1]] * (self.cfg.max_batch - n)
        stacked = torch.stack(payloads)
        t0 = self.clock()
        out = self.fn(stacked)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)  # the batch is done, not just queued
        now = self.clock()
        if self.observer is not None:
            # the executed width: with pad_to_max the forward ran
            # len(payloads) wide, whatever the number of real requests
            self.observer(len(payloads), now - t0)
        for i, r in enumerate(batch):
            r.done = now
            r.result = out[i]
            self.completed.append(r)
        return batch

    def run_until_drained(self, max_batches: int = 10_000) -> dict:
        b = 0
        while self.queue and b < max_batches:
            self.step()
            b += 1
        return self.stats()

    def stats(self) -> dict:
        met = [r for r in self.completed if r.done is not None and r.done <= r.deadline]
        lat = [r.done - r.arrival for r in self.completed if r.done is not None]
        return {
            "completed": len(self.completed),
            "deadline_met_frac": len(met) / max(1, len(self.completed)),
            "p50_latency_s": float(np.percentile(lat, 50)) if lat else 0.0,
            "p99_latency_s": float(np.percentile(lat, 99)) if lat else 0.0,
        }
