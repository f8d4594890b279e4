"""Service-reliability model under a time-variant offloading channel (paper §V.D).

The port's copy of ``repro/core/reliability.py`` (pure ``math``).

The IoT device offloads a batch of ``n_tasks`` images (125 KB each) to the host
ES; the offloading time is Gaussian, T_off ~ N(mu, sigma^2) with
mu = batch_bits / rate.  The service deadline D corresponds to the target
system throughput (30 FPS with 4 tasks per batch -> D = 4/30 s = 133.3 ms), and

    reliability = P(T_off + T_inf <= D) = Phi((D - mu - T_inf) / sigma).

Reverse-engineering note (validated by the JAX package's Table III benchmark): the
paper's Table III entries are exactly Phi(slack/sigma) with a 4 Mbit offload --
e.g. 0.815931 = Phi(0.90), 0.571420 = Phi(0.90/5), 0.992992 = Phi(34.4/14) --
which pins the paper's implied constants: T_inf(pre-trained, Xavier) such that
slack at 40 Mbps is 0.9 ms, and T_inf(HALP) matching Table II's 225 fps entry.
The paper's rate-fluctuation column is phi = rate - batch_bits/(mu + 3 sigma)
(3-sigma rule), which reproduces every phi in the table header.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = [
    "phi",
    "probit",
    "OffloadChannel",
    "service_reliability",
    "rate_fluctuation",
    "required_slack",
]

IMAGE_BYTES = 125_000  # paper: "each input image of 125 KBytes"


def phi(z: float) -> float:
    """Standard normal CDF."""
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


@dataclass(frozen=True)
class OffloadChannel:
    rate_bps: float  # nominal IoT->host rate
    sigma_s: float  # std-dev of the offloading time
    n_tasks: int = 4

    @property
    def batch_bits(self) -> float:
        return 8.0 * IMAGE_BYTES * self.n_tasks

    @property
    def mu_s(self) -> float:
        return self.batch_bits / self.rate_bps


def service_reliability(ch: OffloadChannel, t_inf_s: float, deadline_s: float) -> float:
    """P(T_off + T_inf <= D) for Gaussian offloading time."""
    if ch.sigma_s <= 0:
        return 1.0 if ch.mu_s + t_inf_s <= deadline_s else 0.0
    return phi((deadline_s - ch.mu_s - t_inf_s) / ch.sigma_s)


def rate_fluctuation(ch: OffloadChannel) -> float:
    """phi (Mbps-style fluctuation) via the 3-sigma rule: the nominal rate minus
    the effective rate when the offload takes mu + 3 sigma."""
    return ch.rate_bps - ch.batch_bits / (ch.mu_s + 3.0 * ch.sigma_s)


def probit(p: float) -> float:
    """Inverse standard normal CDF (quantile), ``phi(probit(p)) == p``.

    Solved by bisection on :func:`phi` -- monotone, branch-free of special
    cases, and accurate to ~1e-12 over the targets admission control uses
    (0.9 .. 0.999999); the stdlib has ``erf`` but no ``erfinv``, and pulling
    in scipy for one quantile is not worth a dependency."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0, 1), got {p}")
    lo, hi = -9.0, 9.0  # phi saturates to 0/1 in float64 well inside +-9
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if phi(mid) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def required_slack(ch: OffloadChannel, t_inf_s: float, target: float) -> float:
    """The smallest deadline slack at which a batch still clears ``target``:
    the §V.D reliability integral *inverted* into an admission threshold.

    ``service_reliability(ch, t_inf, D) >= target``  iff
    ``D >= mu + t_inf + sigma * probit(target)`` (for ``sigma > 0``; a
    deterministic channel degenerates to ``mu + t_inf``).  Admission control
    over a request stream uses this form: per deadline class the threshold is
    one precomputed number per batch size, so admitting or shedding a request
    with remaining slack ``deadline - now`` is a single comparison instead of
    a reliability evaluation -- what makes §V.D's policy affordable at
    millions of requests (see ``repro_torch.runtime.serve.serve_trace``)."""
    if not 0.0 < target < 1.0:
        raise ValueError(f"target must be in (0, 1), got {target}")
    if ch.sigma_s <= 0:
        return ch.mu_s + t_inf_s
    return ch.mu_s + t_inf_s + ch.sigma_s * probit(target)
