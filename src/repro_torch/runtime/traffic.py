"""Production traffic models for the serving pipeline: seeded arrival
processes + per-request deadline classes.

The port's copy of ``repro/runtime/traffic.py``.  Arrival streams are host
data and stay numpy (``np.random.default_rng``): a seed gives the same
trace, bit for bit, in both packages.

The paper's §V.D evaluates service reliability for one batch size under a
time-variant channel; nothing in it models *load* -- the
arrival pattern that decides how large the EDF backlog gets and therefore how
much queueing delay eats into each request's deadline slack.  The authors'
prototype paper (arXiv 2211.13778) serves real request streams, and DistrEdge
(arXiv 2202.01699) reports tail latency rather than means precisely because
production arrivals are bursty.  This module provides the three canonical
arrival shapes a serving stack must survive, all virtual-time and seeded
(bit-identical traces per seed, no wall clock anywhere):

* :class:`PoissonProcess` -- memoryless steady load (the M/.../1 baseline);
* :class:`DiurnalProcess` -- a sinusoid-modulated nonhomogeneous Poisson
  process (the day/night swing of a user-facing service), generated by
  Lewis-Shedler thinning against the peak rate;
* :class:`FlashCrowdProcess` -- baseline Poisson plus one or more bounded
  burst windows at a multiple of the base rate (the retweeted-link /
  thundering-herd shape that motivates admission control: during the burst
  the offered load exceeds the serving capacity by design).

:class:`DeadlineClass` attaches the §V.D reliability semantics to each
request: a relative deadline and a target reliability (the admission policy
sheds work that cannot clear the target -- see
:func:`repro_torch.core.reliability.required_slack`), plus a traffic share.
:func:`make_trace` assembles a :class:`Trace`: sorted arrival times, one
class label per request, and the derived absolute deadlines that the serving
loop's per-class EDF queues pop in order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = [
    "DeadlineClass",
    "PoissonProcess",
    "DiurnalProcess",
    "FlashCrowdProcess",
    "Trace",
    "make_trace",
]


@dataclass(frozen=True)
class DeadlineClass:
    """One request class: relative deadline, §V.D reliability target, share.

    ``deadline_s`` is relative to arrival (absolute deadline = arrival +
    ``deadline_s``); ``target`` is the per-class service-reliability floor the
    admission policy enforces (a request whose remaining slack cannot clear
    ``target`` even alone in a batch is shed, pinning the "0 means shed"
    semantics of :func:`~repro_torch.runtime.serve.choose_batch_size`); ``share`` is
    the class's relative traffic weight (normalised across the class set by
    :func:`make_trace`)."""

    name: str
    deadline_s: float
    target: float = 0.999
    share: float = 1.0

    def __post_init__(self) -> None:
        if self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {self.deadline_s}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"target must be in (0, 1), got {self.target}; 1.0 is "
                f"unattainable under a Gaussian offload (every batch sheds)"
            )
        if self.share <= 0:
            raise ValueError(f"share must be positive, got {self.share}")


def _poisson_times(
    rng: np.random.Generator, rate_hz: float, start_s: float, end_s: float
) -> np.ndarray:
    """Homogeneous Poisson arrival times in [start, end), vectorized.

    Draws exponential gaps in blocks and extends until the horizon is
    crossed; the block schedule is a pure function of (rate, horizon), so the
    result is bit-identical for a given generator state."""
    horizon = end_s - start_s
    if horizon <= 0:
        return np.empty(0)
    block = max(256, int(1.2 * rate_hz * horizon) + 64)
    gaps = rng.exponential(1.0 / rate_hz, size=block)
    times = np.cumsum(gaps)
    while times[-1] < horizon:
        gaps = rng.exponential(1.0 / rate_hz, size=block)
        times = np.concatenate([times, times[-1] + np.cumsum(gaps)])
    return start_s + times[: int(np.searchsorted(times, horizon))]


@dataclass(frozen=True)
class PoissonProcess:
    """Memoryless arrivals at a constant ``rate_hz`` (exponential gaps)."""

    rate_hz: float
    seed: int = 0

    def __post_init__(self) -> None:
        if self.rate_hz <= 0:
            raise ValueError(f"rate_hz must be positive, got {self.rate_hz}")

    def times(self, horizon_s: float) -> np.ndarray:
        """Sorted arrival times in [0, horizon_s); bit-identical per seed."""
        return _poisson_times(np.random.default_rng(self.seed), self.rate_hz, 0.0, horizon_s)


@dataclass(frozen=True)
class DiurnalProcess:
    """Sinusoid-modulated nonhomogeneous Poisson arrivals.

    Instantaneous rate ``lambda(t) = base_rate_hz * (1 + amplitude *
    sin(2 pi (t + phase_s) / period_s))`` -- the day/night swing of a
    user-facing service (``period_s`` defaults to 24 h).  Generated by
    Lewis-Shedler thinning against the peak rate ``base * (1 + amplitude)``,
    which is exact for any bounded rate function and stays fully vectorized."""

    base_rate_hz: float
    amplitude: float = 0.8
    period_s: float = 86_400.0
    phase_s: float = 0.0
    seed: int = 0

    def __post_init__(self) -> None:
        if self.base_rate_hz <= 0:
            raise ValueError(f"base_rate_hz must be positive, got {self.base_rate_hz}")
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError(
                f"amplitude must be in [0, 1] (rates stay nonnegative), got "
                f"{self.amplitude}"
            )
        if self.period_s <= 0:
            raise ValueError(f"period_s must be positive, got {self.period_s}")

    def rate_at(self, t_s: float | np.ndarray) -> float | np.ndarray:
        return self.base_rate_hz * (
            1.0 + self.amplitude * np.sin(2.0 * np.pi * (t_s + self.phase_s) / self.period_s)
        )

    def times(self, horizon_s: float) -> np.ndarray:
        """Sorted arrival times in [0, horizon_s); bit-identical per seed."""
        rng = np.random.default_rng(self.seed)
        peak = self.base_rate_hz * (1.0 + self.amplitude)
        candidates = _poisson_times(rng, peak, 0.0, horizon_s)
        accept = rng.uniform(size=candidates.size) * peak <= self.rate_at(candidates)
        return candidates[accept]


@dataclass(frozen=True)
class FlashCrowdProcess:
    """Baseline Poisson plus bounded burst windows of extra arrivals.

    ``bursts`` is a sequence of ``(start_s, duration_s, extra_rate_hz)``
    windows; within each, an *additional* homogeneous Poisson stream at
    ``extra_rate_hz`` is superposed on the baseline (the superposition of
    Poisson processes is Poisson at the summed rate, so inside a window the
    offered load is exactly ``base + extra``).  The default is one 10x burst
    a quarter of the way into the horizon -- sized so admission control has
    real shedding work to do."""

    base_rate_hz: float
    bursts: tuple[tuple[float, float, float], ...] = ()
    seed: int = 0

    def __post_init__(self) -> None:
        if self.base_rate_hz <= 0:
            raise ValueError(f"base_rate_hz must be positive, got {self.base_rate_hz}")
        for start, dur, rate in self.bursts:
            if dur <= 0 or rate <= 0 or start < 0:
                raise ValueError(
                    f"burst windows need start >= 0, duration > 0, rate > 0; "
                    f"got ({start}, {dur}, {rate})"
                )

    def times(self, horizon_s: float) -> np.ndarray:
        """Sorted arrival times in [0, horizon_s); bit-identical per seed."""
        rng = np.random.default_rng(self.seed)
        bursts = self.bursts or ((0.25 * horizon_s, 0.05 * horizon_s, 10.0 * self.base_rate_hz),)
        streams = [_poisson_times(rng, self.base_rate_hz, 0.0, horizon_s)]
        for start, dur, rate in bursts:
            streams.append(_poisson_times(rng, rate, start, min(start + dur, horizon_s)))
        merged = np.concatenate(streams)
        merged.sort(kind="stable")
        return merged


@dataclass(frozen=True)
class Trace:
    """One request stream: sorted arrivals, per-request class labels.

    ``arrival[i]`` is request ``i``'s arrival time, ``cls[i]`` indexes into
    ``classes``; absolute deadlines derive as ``arrival + deadline_s[cls]``.
    Everything downstream (the serving loop, the property harness) consumes
    this triple -- a trace is data, never a process with hidden state."""

    arrival: np.ndarray
    cls: np.ndarray
    classes: tuple[DeadlineClass, ...]

    def __post_init__(self) -> None:
        if self.arrival.shape != self.cls.shape:
            raise ValueError(
                f"arrival and cls must align, got {self.arrival.shape} vs {self.cls.shape}"
            )
        if self.arrival.size and np.any(np.diff(self.arrival) < 0):
            raise ValueError("arrival times must be sorted non-decreasing")
        if self.arrival.size and not (
            0 <= int(self.cls.min()) and int(self.cls.max()) < len(self.classes)
        ):
            raise ValueError("cls labels must index into classes")

    def __len__(self) -> int:
        return int(self.arrival.size)

    def deadlines(self) -> np.ndarray:
        """Absolute per-request deadlines (arrival + class-relative deadline)."""
        rel = np.array([c.deadline_s for c in self.classes])
        return self.arrival + rel[self.cls]


def make_trace(
    process, classes: Sequence[DeadlineClass], horizon_s: float, seed: int = 0
) -> Trace:
    """Draw one request stream: ``process.times(horizon_s)`` arrivals, each
    labelled with a class sampled i.i.d. by the classes' (normalised) shares.

    The label stream is seeded independently of the arrival process, so the
    same arrival trace can be re-labelled (e.g. to sweep class mixes) without
    disturbing the arrival determinism."""
    classes = tuple(classes)
    if not classes:
        raise ValueError("need at least one DeadlineClass")
    arrival = np.asarray(process.times(horizon_s), dtype=np.float64)
    shares = np.array([c.share for c in classes])
    rng = np.random.default_rng(seed)
    cls = rng.choice(len(classes), size=arrival.size, p=shares / shares.sum())
    return Trace(arrival=arrival, cls=cls.astype(np.int64), classes=classes)
