"""Serving engine: deadline-aware dynamic batching, the paper's admission
policy and trace-scale serving in virtual time (twin of
``repro/runtime/serve.py``).

Requests arrive with a deadline; the batcher takes them earliest-deadline
first, up to ``max_batch`` at a time, stacks their payloads into one batch,
runs the model on it, waits for the device, and hands every request its slice
of the output.  Batches launch when full or when the oldest queued request has
waited ``max_delay_s`` (:meth:`BatchingEngine.ready`).

Batch-size selection uses the paper's reliability machinery (§V.D): given a
measured per-batch latency curve and an offload-time distribution,
:func:`choose_batch_size` picks the largest batch whose P(deadline met)
clears the target, and returns ``0`` -- shed -- when none does.

The engine closes the measurement loop of the online re-planner
(``repro_torch.core.replan``) on both axes: every executed batch's (size,
latency) goes to an optional ``observer`` -- typically
``ReplanController.observe_batch_latency`` -- and per-ES chunk timings
reported through ``observe_es_time`` feed ``ReplanController.observe_compute``.
:func:`plan_aware_batch_size` re-runs the admission policy against the
*current* plan's (or per-task placement's) predicted makespan, so the admitted
batch tracks channel and compute drift alike.

:func:`serve_trace` scales the same policy to production traffic: an
event-driven loop in *virtual time* (a :class:`VirtualClock` is the only
clock; nothing sleeps) over a :class:`~repro_torch.runtime.traffic.Trace`
of seeded arrivals, forming batches from per-class EDF queues, admitting
each with the per-class generalisation of ``choose_batch_size`` (one
precomputed slack threshold per request, see
:func:`~repro_torch.core.reliability.required_slack`), shedding heads that
cannot clear their target even alone, and pricing every executed batch from
a latency table -- here the curve the card measured.  It is numpy on the
host, and gives the JAX package's results bit for bit; isolated underload
stretches go through a vectorized fast path that is bit-identical to the
scalar event loop (``ServeLoopConfig(fast_path=False)``).
"""
from __future__ import annotations

import heapq
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..core.reliability import OffloadChannel, probit, service_reliability

__all__ = [
    "Request",
    "ServeConfig",
    "BatchingEngine",
    "VirtualClock",
    "ServeLoopConfig",
    "ServedTrace",
    "serve_trace",
    "choose_batch_size",
    "plan_aware_batch_size",
]


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


class VirtualClock:
    """Deterministic manual clock: serving in simulated time, never wall time.

    Drop-in for the ``clock`` callable of :class:`BatchingEngine` (calling the
    instance returns the current virtual time), and the only notion of time
    :func:`serve_trace` has.  Tests advance it explicitly, so deadline and
    latency assertions are exact and instantaneous -- no ``time.sleep`` and no
    flakiness from scheduler jitter."""

    def __init__(self, start_s: float = 0.0):
        self._now = float(start_s)

    def __call__(self) -> float:
        return self._now

    def now(self) -> float:
        return self._now

    def advance(self, dt_s: float) -> float:
        """Move time forward by ``dt_s`` (>= 0); returns the new time."""
        if dt_s < 0:
            raise ValueError(f"virtual time cannot go backwards (dt={dt_s})")
        self._now += dt_s
        return self._now

    def advance_to(self, t_s: float) -> float:
        """Jump to absolute time ``t_s`` (>= now); returns the new time."""
        if t_s < self._now:
            raise ValueError(
                f"virtual time cannot go backwards ({t_s} < {self._now})"
            )
        self._now = float(t_s)
        return self._now

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


def choose_batch_size(
    per_batch_latency_s: Callable[[int], float],
    deadline_s: float,
    channel: OffloadChannel,
    target: float = 0.99999,
    max_batch: int = 64,
) -> int:
    """Largest batch size whose service reliability clears ``target``
    (paper §V-D as an admission-control policy).

    Returns ``0`` when *no* batch size clears the target: the request stream
    cannot meet its deadline at the required reliability on the current plan
    and channel, so the caller must shed/reject (or renegotiate the deadline)
    rather than admit doomed work.  The historical behaviour of falling back
    to ``1`` silently admitted requests that were already known to miss."""
    best = 0
    for b in range(1, max_batch + 1):
        t_inf = per_batch_latency_s(b)
        rel = service_reliability(channel, t_inf, deadline_s)
        if rel >= target:
            best = b
    return best


def plan_aware_batch_size(
    controller,
    deadline_s: float,
    channel: OffloadChannel,
    target: float = 0.99999,
    max_batch: int = 64,
) -> int:
    """``choose_batch_size`` against the *current* plan's predicted makespan.

    ``controller`` is a :class:`~repro_torch.core.replan.ReplanController` or a
    :class:`~repro_torch.core.placement.PlacementController`: its
    ``predicted_latency(b)`` prices a b-task batch on whatever the controller
    is serving right now -- the closed form on the shared plan, or the
    shared-pool DES over the per-task placement (calibrated by measured batch
    latencies either way) -- so after a re-plan or re-placement the admitted
    batch size follows without re-measuring a latency curve.

    Like :func:`choose_batch_size`, returns ``0`` when even a single-task
    batch cannot clear ``target`` under the current plan's predicted
    makespan: the caller sheds until the controller re-plans onto a faster
    operating point (or the channel recovers)."""
    return choose_batch_size(
        controller.predicted_latency, deadline_s, channel, target=target, max_batch=max_batch
    )


# ---------------------------------------------------------------------------
# Trace-scale serving: the event-driven loop over production traffic models
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServeLoopConfig:
    """Knobs of :func:`serve_trace` (all times virtual; nothing sleeps).

    ``admission=True`` applies the per-class §V.D policy (shed requests that
    cannot clear their class target even at batch size 1, cap the batch at
    the largest EDF prefix where *every* member clears its target);
    ``admission=False`` is the accept-everything baseline the flash-crowd
    benchmark compares against.  ``channel`` adds the offloading leg:
    per-executed-batch time ``max(0, mu + sigma * noise)`` with seeded
    Gaussian noise (``None`` serves pure inference).  ``segment_bounds``
    split the horizon into piecewise-stationary segments, one latency-table
    row each (e.g. hourly channel states of a diurnal day).  ``fast_path``
    toggles the vectorized underload path -- results are bit-identical
    either way; it exists only so that a test can run the scalar reference."""

    max_batch: int = 8
    max_delay_s: float = 0.002
    admission: bool = True
    channel: OffloadChannel | None = None
    seed: int = 0  # offload-noise stream (one draw per executed batch)
    segment_bounds: tuple[float, ...] = ()
    fast_path: bool = True

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {self.max_delay_s}")
        if list(self.segment_bounds) != sorted(self.segment_bounds):
            raise ValueError(f"segment_bounds must be sorted, got {self.segment_bounds}")


@dataclass
class ServedTrace:
    """Outcome of one :func:`serve_trace` run, per request and per batch.

    ``fin[i]`` is request ``i``'s completion time (NaN if shed), ``shed[i]``
    whether admission dropped it, ``met[i]`` whether it finished within its
    absolute deadline (shed requests never meet).  ``batch_size_counts[b]``
    counts executed batches of width ``b`` -- the shed accounting plus this
    histogram is the loop's entire observable state, so determinism is one
    array comparison."""

    trace: Any  # repro_torch.runtime.traffic.Trace
    fin: np.ndarray
    shed: np.ndarray
    met: np.ndarray
    n_batches: int
    batch_size_counts: np.ndarray

    def latency(self) -> np.ndarray:
        """Per-request sojourn time (completion - arrival; NaN if shed)."""
        return self.fin - self.trace.arrival

    @staticmethod
    def _stats_of(lat: np.ndarray, met: np.ndarray, shed: np.ndarray) -> dict:
        n = int(met.size)
        served = ~shed
        lat_served = lat[served]
        completed = int(served.sum())

        def pct(q: float) -> float:
            return float(np.percentile(lat_served, q)) if completed else 0.0

        return dict(
            n=n,
            completed=completed,
            shed=int(n - completed),
            shed_rate=float(shed.mean()) if n else 0.0,
            # met/total: a shed request is a missed request (the strictest
            # reading -- shedding only ever "helps" by protecting others)
            deadline_met_frac=float(met.mean()) if n else 0.0,
            met_of_admitted=float(met[served].mean()) if completed else 0.0,
            mean_latency_s=float(lat_served.mean()) if completed else 0.0,
            p50_latency_s=pct(50.0),
            p99_latency_s=pct(99.0),
            p999_latency_s=pct(99.9),
        )

    def stats(self) -> dict:
        """Whole-trace tail/shed metrics (plus batch-shape telemetry)."""
        out = self._stats_of(self.latency(), self.met, self.shed)
        out["n_batches"] = int(self.n_batches)
        out["mean_batch"] = (
            float(self.batch_size_counts @ np.arange(self.batch_size_counts.size))
            / self.n_batches
            if self.n_batches
            else 0.0
        )
        return out

    def class_stats(self) -> dict[str, dict]:
        """Per-deadline-class metrics, keyed by class name."""
        lat = self.latency()
        out = {}
        for ci, cls in enumerate(self.trace.classes):
            sel = self.trace.cls == ci
            out[cls.name] = self._stats_of(lat[sel], self.met[sel], self.shed[sel])
        return out


def _off_margins(cfg: ServeLoopConfig, classes) -> tuple[float, float, np.ndarray]:
    """(mu, sigma, per-class admission margin) of the offloading leg.

    ``margin[c] = mu + sigma * probit(target_c)`` is the batch-size-free part
    of :func:`~repro_torch.core.reliability.required_slack`; a request with
    remaining slack ``s`` clears its class target in a batch of size ``b``
    iff ``s - margin[c] >= lat(b)``, turning every admission decision into
    one subtraction and one comparison."""
    if cfg.channel is None:
        return 0.0, 0.0, np.zeros(len(classes))
    mu, sigma = cfg.channel.mu_s, cfg.channel.sigma_s
    if sigma <= 0:
        return mu, 0.0, np.full(len(classes), mu)
    return mu, sigma, np.array([mu + sigma * probit(c.target) for c in classes])


def serve_trace(trace, lat_table: np.ndarray, cfg: ServeLoopConfig = ServeLoopConfig()) -> ServedTrace:
    """Serve one arrival :class:`~repro_torch.runtime.traffic.Trace` end-to-end in
    virtual time; returns the per-request/per-batch :class:`ServedTrace`.

    ``lat_table`` is the service-time model: ``lat_table[s, b-1]`` is the
    makespan of a ``b``-task batch during segment ``s`` -- a latency curve
    the caller measured on the card, or a DES table as
    :func:`~repro_torch.core.simulator.serve_latency_table` gives it; a 1-D
    table means one stationary segment.

    The loop (documented here once, both code paths implement it exactly):

    1. **Formation** -- let ``first`` be the earliest pending arrival and
       ``t0 = max(server_free, first)``.  If a full ``max_batch`` is already
       pending at ``t0``, the batch forms at ``t0``; otherwise it forms at
       the *earlier* of the ``max_batch``-th pending arrival (the queue
       fills during the wait -- the launch-when-full rule of
       :meth:`BatchingEngine.ready`) and
       ``max(server_free, first + max_delay_s)`` (the head's delay budget).
    2. **EDF** -- up to ``max_batch`` arrived requests are taken earliest
       absolute deadline first (ties by arrival order), merged across the
       per-class queues.
    3. **Admission** (``cfg.admission``) -- doomed heads (slack below the
       class's :func:`~repro_torch.core.reliability.required_slack` even at
       ``b=1`` -- exactly ``choose_batch_size(...) == 0``) are shed; the
       batch is then the largest EDF prefix in which every member clears its
       own class target at the prefix's width.
    4. **Execution** -- the batch occupies the server for
       ``offload + lat_table[segment, b-1]`` starting at formation time;
       completions are checked against absolute deadlines.

    Underload stretches (every pending queue empty, arrivals further apart
    than ``max_delay_s``) execute through a vectorized fast path that commits
    whole runs of singleton batches at once -- bit-identical to the scalar
    loop (same formation times, same shed decisions, same noise stream), so
    a million-request day costs seconds instead of a million Python
    iterations."""
    classes = trace.classes
    n = len(trace)
    n_cls = len(classes)
    lat_tab = np.asarray(lat_table, dtype=np.float64)
    if lat_tab.ndim == 1:
        lat_tab = lat_tab[None, :]
    if lat_tab.shape[0] != len(cfg.segment_bounds) + 1:
        raise ValueError(
            f"lat_table has {lat_tab.shape[0]} segment rows for "
            f"{len(cfg.segment_bounds)} bounds (need bounds+1)"
        )
    if lat_tab.shape[1] < cfg.max_batch:
        raise ValueError(
            f"lat_table covers batches 1..{lat_tab.shape[1]} but max_batch is "
            f"{cfg.max_batch}"
        )
    if np.any(lat_tab <= 0) or not np.all(np.isfinite(lat_tab)):
        raise ValueError("lat_table entries must be positive and finite")

    fin = np.full(n, np.nan)
    shed = np.zeros(n, dtype=bool)
    met = np.zeros(n, dtype=bool)
    counts = np.zeros(cfg.max_batch + 1, dtype=np.int64)
    out = ServedTrace(
        trace=trace, fin=fin, shed=shed, met=met, n_batches=0, batch_size_counts=counts
    )
    if n == 0:
        return out

    arrival = trace.arrival
    cls_of = trace.cls
    rel_dl = np.array([c.deadline_s for c in classes])
    deadline = arrival + rel_dl[cls_of]
    mu, sigma, off_margin = _off_margins(cfg, classes)
    # one noise value per *executed batch*, indexed by batch counter (not a
    # sequential stream), so the vectorized fast path and the scalar loop
    # consume identical values no matter how runs are cut
    pool = (
        np.random.default_rng(cfg.seed).standard_normal(n) if sigma > 0 else None
    )
    bounds = np.asarray(cfg.segment_bounds, dtype=np.float64)
    segmented = bounds.size > 0
    max_batch, max_delay = cfg.max_batch, cfg.max_delay_s

    # per-class EDF queues: within a class the absolute deadline order IS the
    # arrival order (one relative deadline per class), so each queue is its
    # sorted arrival array plus a head pointer, and EDF across classes only
    # ever compares the heads.  Consumption is therefore a per-class prefix.
    ix_c = [np.flatnonzero(cls_of == c) for c in range(n_cls)]
    arr_c = [arrival[ix] for ix in ix_c]
    dl_c = [deadline[ix] for ix in ix_c]
    n_c = [len(ix) for ix in ix_c]
    head = [0] * n_cls

    consumed = np.zeros(n, dtype=bool)  # global order, for the fast-path scan
    g = 0  # earliest globally-unconsumed request
    window = 1024  # fast-path probe size, adapts to the last committed run
    free = 0.0  # server next-free time
    remaining = n
    n_batches = 0
    lat1_col = lat_tab[:, 0]

    while remaining > 0:
        while consumed[g]:
            g += 1
        first_t = arrival[g]

        # ---- fast path: chains of singleton batches ------------------------
        # Hypothesis: the next requests each form and execute as their own
        # width-1 batch (the dominant regime away from bursts).  Everything
        # per-element (formation floor, segment, b=1 latency, offload noise,
        # admission threshold) precomputes vectorized; the only inherently
        # sequential part -- form_k = max(fin_{k-1}, a_k + delay) -- runs as
        # a tight validate-and-commit loop over plain floats using the SAME
        # expressions as the scalar step, so the committed prefix is
        # bit-identical to what the scalar loop would produce.  The first
        # element that would really batch up, shed, or cross a segment
        # boundary mid-wait breaks the chain and falls through.
        if cfg.fast_path and max_batch > 1:
            end = min(n, g + window)
            holes = consumed[g:end]
            if holes.any():
                end = g + int(np.argmax(holes))
            m = end - g
            if m > 0:
                a = arrival[g:end]
                run_cls = cls_of[g:end]
                x = a + max_delay  # formation floor of a solo head
                if segmented:
                    seg = np.searchsorted(bounds, x, side="right")
                    lat1 = lat1_col[seg]
                    # chain stays valid while form_k < the segment's upper edge
                    seg_hi = np.append(bounds, np.inf)[seg].tolist()
                else:
                    lat1 = np.full(m, lat1_col[0])
                    seg_hi = None
                t_off = np.full(m, mu)
                if pool is not None:
                    # all-singleton prefix => pool slots are consecutive
                    t_off = np.maximum(0.0, mu + sigma * pool[n_batches : n_batches + m])
                nxt = np.empty(m)
                nxt[:-1] = a[1:]
                # window/hole edge: the next *global* arrival is <= the next
                # pending one, so using it only ever invalidates, never admits
                nxt[-1] = arrival[end] if end < n else np.inf
                dls = deadline[g:end].tolist()
                offm = off_margin[run_cls].tolist()
                xs, nxts, lat1s, t_offs = x.tolist(), nxt.tolist(), lat1.tolist(), t_off.tolist()
                fr = free
                fins: list[float] = []
                r = 0
                admit = cfg.admission
                while r < m:
                    xk = xs[r]
                    form_k = xk if fr <= xk else fr
                    if nxts[r] <= form_k:  # a second request would join
                        break
                    if seg_hi is not None and form_k >= seg_hi[r]:
                        break  # queued past the segment edge; re-price scalar
                    # same expression order as the scalar margins, bit-exact
                    if admit and dls[r] - form_k - offm[r] < lat1s[r]:
                        break  # head is doomed; scalar step sheds it
                    fr = form_k + t_offs[r] + lat1s[r]
                    fins.append(fr)
                    r += 1
                if r > 0:
                    sl = slice(g, g + r)
                    fin_run = np.array(fins)
                    consumed[sl] = True
                    fin[sl] = fin_run
                    met[sl] = fin_run <= deadline[sl]
                    counts[1] += r
                    n_batches += r
                    for c, cnt in zip(*np.unique(run_cls[:r], return_counts=True)):
                        head[c] += int(cnt)
                    free = fr
                    remaining -= r
                    window = min(4096, max(64, 2 * r))
                    continue
                window = 64  # scalar territory ahead; probe small next time

        # ---- scalar event step: one batch formation -----------------------
        t0 = max(free, first_t)
        pending0 = 0
        pos = [0] * n_cls
        for c in range(n_cls):
            pos[c] = int(np.searchsorted(arr_c[c], t0, side="right"))
            pending0 += pos[c] - head[c]
        if pending0 >= max_batch:
            form_t = t0
        else:
            # the queue may fill to max_batch *during* the head's delay wait:
            # the batch then forms at the max_batch-th pending arrival
            # (BatchingEngine.ready's launch-when-full rule), not at the
            # budget.  The fill time is the `need`-th arrival after t0 --
            # gather at most `need` upcoming arrivals per class and merge.
            need = max_batch - pending0
            upcoming = np.concatenate(
                [arr_c[c][pos[c] : pos[c] + need] for c in range(n_cls)]
            )
            if len(upcoming) >= need:
                upcoming.sort()
                t_full = float(upcoming[need - 1])
            else:
                t_full = np.inf
            form_t = min(t_full, max(free, first_t + max_delay))
        ends = [int(np.searchsorted(arr_c[c], form_t, side="right")) for c in range(n_cls)]

        # EDF merge across the class heads (ties by global arrival index)
        cand_gi: list[int] = []
        cand_cls: list[int] = []
        cand_dl: list[float] = []
        cur = list(head)
        while len(cand_gi) < max_batch:
            best = -1
            best_key = (np.inf, n)
            for c in range(n_cls):
                if cur[c] < ends[c]:
                    key = (dl_c[c][cur[c]], int(ix_c[c][cur[c]]))
                    if key < best_key:
                        best, best_key = c, key
            if best < 0:
                break
            cand_gi.append(int(ix_c[best][cur[best]]))
            cand_cls.append(best)
            cand_dl.append(float(dl_c[best][cur[best]]))
            cur[best] += 1

        seg = int(np.searchsorted(bounds, form_t, side="right")) if segmented else 0
        lat_row = lat_tab[seg]
        margins = [
            cand_dl[i] - form_t - off_margin[cand_cls[i]] for i in range(len(cand_gi))
        ]
        start = 0
        if cfg.admission:
            # shed doomed heads: choose_batch_size(...) == 0 for them, and
            # their slack only shrinks from here -- drop them now so the
            # server's capacity goes to requests that can still make it
            while start < len(cand_gi) and margins[start] < lat_row[0]:
                gi = cand_gi[start]
                consumed[gi] = True
                shed[gi] = True
                head[cand_cls[start]] += 1
                remaining -= 1
                start += 1
            b_star = 0
            pref_min = np.inf
            for b in range(1, len(cand_gi) - start + 1):
                pref_min = min(pref_min, margins[start + b - 1])
                if pref_min >= lat_row[b - 1]:
                    b_star = b
        else:
            b_star = len(cand_gi)

        if b_star > 0:
            t_off = mu
            if pool is not None:
                t_off = max(0.0, mu + sigma * pool[n_batches])
            fin_t = form_t + t_off + lat_row[b_star - 1]
            for i in range(start, start + b_star):
                gi = cand_gi[i]
                consumed[gi] = True
                fin[gi] = fin_t
                met[gi] = fin_t <= cand_dl[i]
                head[cand_cls[i]] += 1
            remaining -= b_star
            free = fin_t
            n_batches += 1
            counts[b_star] += 1

    out.n_batches = n_batches
    return out
