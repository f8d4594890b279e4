"""Collaboration topology: which ESs collaborate, at what speeds, over what links.

The port's copy of ``repro/core/topology.py`` (plain dataclasses):
:func:`~repro_torch.core.partition.plan_scheme` takes a
:class:`CollabTopology` and derives capacity-weighted secondary ratios from it.
A topology holds:

* an ordered list of *secondary* ESs (their order is their position along the
  partitioned row axis),
* one designated *host* ES that owns every overlapping zone and relays all
  boundary traffic (the no-secondary-exchange invariant), and
* per-ES compute :class:`Platform`\\ s and *directed* per-pair :class:`Link`
  rates (uplink and downlink of an ES may differ).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Sequence

__all__ = ["Platform", "Link", "CollabTopology"]


@dataclass(frozen=True)
class Platform:
    name: str
    peak_flops: float  # advertised peak (fp32 for the paper's GPUs)
    eff_flops: float  # calibrated effective FLOP/s

    def compute_time(self, flops: float) -> float:
        return flops / self.eff_flops

    def scaled(self, factor: float, name: str | None = None) -> "Platform":
        """A platform ``factor`` x as fast (heterogeneous-cluster modelling)."""
        return Platform(
            name=name or f"{self.name} x{factor:g}",
            peak_flops=self.peak_flops * factor,
            eff_flops=self.eff_flops * factor,
        )


@dataclass(frozen=True)
class Link:
    rate_bps: float  # bits per second

    def comm_time(self, nbytes: float) -> float:
        return 8.0 * nbytes / self.rate_bps


@dataclass(frozen=True)
class CollabTopology:
    """One host + N ordered secondaries with per-ES platforms and per-link rates.

    ``links`` maps directed ``(src, dst)`` ES-name pairs to :class:`Link`;
    pairs not listed fall back to ``default_link``.  ``secondaries`` are
    ordered along the partitioned row axis (first name owns the topmost
    segment).
    """

    host: str
    secondaries: tuple[str, ...]
    platforms: Mapping[str, Platform]
    links: Mapping[tuple[str, str], Link] = field(default_factory=dict)
    default_link: Link | None = None

    def __post_init__(self) -> None:
        if len(self.secondaries) < 1:
            raise ValueError("need at least one secondary ES")
        if self.host in self.secondaries:
            raise ValueError(f"host {self.host!r} cannot also be a secondary")
        for es in (self.host, *self.secondaries):
            if es not in self.platforms:
                raise ValueError(f"no platform for ES {es!r}")

    @property
    def n_secondaries(self) -> int:
        return len(self.secondaries)

    @property
    def es_names(self) -> tuple[str, ...]:
        return (self.host, *self.secondaries)

    def platform_of(self, es: str) -> Platform:
        return self.platforms[es]

    def link_between(self, src: str, dst: str) -> Link:
        link = self.links.get((src, dst), self.default_link)
        if link is None:
            raise KeyError(f"no link {src!r} -> {dst!r} and no default_link")
        return link

    def capacity_ratios(self) -> tuple[float, ...]:
        """Secondary segment ratios proportional to effective FLOP/s.

        This is the DistrEdge-style capacity-aware starting point; the
        optimizer refines it further when link rates are also asymmetric."""
        eff = [self.platforms[s].eff_flops for s in self.secondaries]
        total = sum(eff)
        return tuple(e / total for e in eff)

    def collab_pairs(self) -> tuple[tuple[str, str], ...]:
        """Every directed host<->secondary pair the HALP schedule can use.

        Secondaries never exchange rows directly (the scheme's invariant), so
        these 2N pairs are exactly the links a rate estimator must track."""
        pairs: list[tuple[str, str]] = []
        for s in self.secondaries:
            pairs.append((self.host, s))
            pairs.append((s, self.host))
        return tuple(pairs)

    def sub_topology(self, secondaries: Sequence[str]) -> "CollabTopology":
        """This pool restricted to ``secondaries`` (same host, same rates).

        The subset keeps the *given* order -- it becomes the row order of the
        sub-cluster's plan, so callers (e.g. the per-task placement engine)
        can put faster ESs first and let thin-layer auto-reduction shed the
        weakest members.  Links touching dropped ESs are filtered out."""
        secs = tuple(secondaries)
        if len(set(secs)) != len(secs):
            raise ValueError(f"duplicate secondaries in subset: {secs}")
        for s in secs:
            if s not in self.secondaries:
                raise ValueError(f"{s!r} is not a secondary of this topology")
        keep = {self.host, *secs}
        return CollabTopology(
            host=self.host,
            secondaries=secs,
            platforms={es: self.platforms[es] for es in keep},
            links={p: l for p, l in self.links.items() if p[0] in keep and p[1] in keep},
            default_link=self.default_link,
        )

    def with_links(
        self,
        links: Mapping[tuple[str, str], Link],
        default_link: Link | None = None,
    ) -> "CollabTopology":
        """A copy with some directed link rates replaced (same ESs/platforms).

        This is the measured-rate rebuild used by the online re-planner: pairs
        not in ``links`` keep their current rate (or the default link)."""
        merged = dict(self.links)
        merged.update(links)
        return dataclasses.replace(
            self, links=merged, default_link=default_link or self.default_link
        )

    def with_platforms(self, platforms: Mapping[str, Platform]) -> "CollabTopology":
        """A copy with some ES platforms replaced (same names/links).

        The compute-side mirror of :meth:`with_links`: the measured-compute
        rebuild used by the online re-planner when per-ES effective FLOP/s
        drift away from the calibrated nominals (a straggling secondary).
        ESs not in ``platforms`` keep their current platform; naming an ES
        the topology does not have raises (a typo would otherwise silently
        leave the straggler unmodelled)."""
        merged = dict(self.platforms)
        for es, plat in platforms.items():
            if es not in merged:
                raise ValueError(f"{es!r} is not an ES of this topology")
            merged[es] = plat
        return dataclasses.replace(self, platforms=merged)

    @staticmethod
    def symmetric(
        platform: Platform,
        link: Link,
        n_secondaries: int = 2,
        host_platform: Platform | None = None,
        host: str = "e0",
    ) -> "CollabTopology":
        """The paper's setting: identical secondaries, one shared link rate.

        For ``n_secondaries=2`` the ES names are the paper's ``(e1, e0, e2)``;
        larger clusters get ``e1..eN`` around the same host."""
        names = tuple(f"e{j}" for j in range(1, n_secondaries + 1))
        platforms = {host: host_platform or platform}
        platforms.update({s: platform for s in names})
        return CollabTopology(
            host=host, secondaries=names, platforms=platforms, default_link=link
        )
