"""Online joint compute+link adaptive re-planning: estimate, bucket, cache,
re-optimise (the port's copy of ``repro/core/replan.py``, plain Python and
numpy).

The paper's §V.D evaluates HALP under a *time-variant* offloading channel but
still runs one plan chosen offline against nominal rates; DistrEdge
(arXiv 2202.01699) and the authors' own prototype (arXiv 2211.13778) show the
remaining latency on real testbeds comes from exactly that gap -- measured
link rates AND measured per-device compute rates both drift away from the
nominals the partition was optimised for (a straggling secondary stretches
every makespan just like a collapsed link).  This module closes the loop
online, in three layers:

* :class:`LinkRateEstimator` -- an EWMA over observed per-link transfer times
  ``rate_sample = 8 * nbytes / elapsed``, seeded from the
  :class:`~repro_torch.core.topology.CollabTopology` nominals, one estimate per
  directed host<->secondary pair (secondaries never talk directly, so 2N
  links suffice; any other measured pair -- e.g. the IoT offload uplink of an
  :class:`~repro_torch.core.reliability.OffloadChannel` -- can be folded in through
  the same ``observe``).  Its compute-side mirror is
  :class:`ComputeRateEstimator`: an EWMA over observed per-ES execution
  times ``rate_sample = flops / elapsed``, seeded from each
  :class:`~repro_torch.core.topology.Platform`'s calibrated ``eff_flops`` and fed
  by the serving engine's per-ES timing hook (``runtime.serve``), which
  ``run_plan(..., time_observer=...)`` drives.

* :class:`PlanCache` -- an LRU map from **(topology fingerprint + optimiser
  config, quantised rate buckets)** to the
  :class:`~repro_torch.core.optimizer.OptimizeResult`
  for that operating point.  Link rates are quantised into geometric bands of
  width ``bucket_frac`` (30% by default): every rate inside a band maps to the
  same key, and the plan is optimised against the band's *representative*
  (geometric centre) rate, so cache entries are reproducible regardless of
  which measured rate first filled them.  Compute rates are quantised into
  geometric bands **anchored at each ES's nominal** (:func:`compute_bucket`):
  band 0's representative is *exactly* the calibrated ``eff_flops``, so a
  controller whose compute never drifts optimises against the nominal
  platforms and serves plans identical to the link-only controller's --
  compute adaptivity is free until a straggler actually appears.  The
  per-ES ``eff_flops`` therefore lives in the bucketed key space (as the
  band anchor), NOT in :func:`topology_fingerprint`: revisited compute
  operating points amortise through the cache exactly like revisited channel
  bands.  In steady state -- mean-reverting conditions revisiting a handful
  of bands -- every plan request is an O(1) dict hit.

* :class:`ReplanController` -- the policy.  Each control epoch it re-buckets
  the current estimates (link and compute jointly) and applies a **shared
  hysteresis**: the estimates must sit outside the active bands -- on any
  link or any ES -- for ``hysteresis`` consecutive epochs before the latest
  bucket key becomes active (a single-epoch excursion therefore cannot
  thrash the plan, at the cost of reacting ``hysteresis - 1`` epochs late; a
  steadily drifting condition is not starved).  Only when the active key
  changes does the controller consult the cache, and only on a cache miss
  does it rebuild the :class:`CollabTopology` with the band-representative
  link rates (:meth:`~repro_torch.core.topology.CollabTopology.with_links`) and
  platforms (:meth:`~repro_torch.core.topology.CollabTopology.with_platforms`) and
  invoke :func:`~repro_torch.core.optimizer.optimize_plan`.  Setting
  ``bucket_frac=0`` keys on the exact estimates (every drift is a miss): that
  degenerate configuration is the "always re-plan" upper baseline;
  ``ReplanConfig(adapt_compute=False)`` keeps the link-only behaviour
  (compute estimates frozen at the nominals) -- the baseline joint
  adaptation is measured against.

The re-optimisation objective defaults to the discrete-event simulator (the
repo's ground truth); ``ReplanConfig(use_simulator=False)`` switches to the
paper's closed-form recursion (:func:`~repro_torch.core.schedule.halp_closed_form`),
which prices the same event topology ~two orders of magnitude faster but, for
``n_tasks > 1``, over-weights communication (see :class:`ReplanConfig`).
Plans produced here are geometry-only (row partitions), so a plan optimised
for estimated rates is always *valid* (lossless) under the true rates -- only
its latency is at stake.  ``runtime.serve`` consumes the controller through
:func:`~repro_torch.runtime.serve.plan_aware_batch_size`, which feeds the *current*
plan's predicted makespan into ``choose_batch_size``.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Mapping

import numpy as np

from .events import simulate_scheme
from .nets import ConvNetGeom
from .optimizer import OptimizeResult, optimize_plan
from .partition import HALPPlan, SCHEME_HALO, SchemePlan
from .schedule import halp_closed_form
from .topology import CollabTopology, Link

__all__ = [
    "FINGERPRINT_EXCLUDED",
    "LinkRateEstimator",
    "ComputeRateEstimator",
    "PlanCache",
    "ReplanConfig",
    "ReplanController",
    "StaticPlanner",
    "optimize_static",
    "topology_fingerprint",
    "rate_bucket",
    "bucket_rate",
    "compute_bucket",
    "compute_band_flops",
]

# Reference rate for the geometric bucket grid.  Any positive constant works
# (it only shifts bucket indices); 1 Mbps keeps indices small and readable for
# both Mbps offload channels and Gbps ES-ES links.
BUCKET_REF_BPS = 1e6


def rate_bucket(rate_bps: float, bucket_frac: float) -> float:
    """Quantise a rate into a geometric band index of width ``bucket_frac``.

    Band ``i`` covers ``[REF * (1+f)^i, REF * (1+f)^(i+1))``; with the default
    f = 0.3 two rates land in the same band iff they differ by < 30%.
    ``bucket_frac <= 0`` disables quantisation and returns the exact rate
    (the always-replan degenerate keying)."""
    if rate_bps <= 0:
        raise ValueError(f"rate must be positive, got {rate_bps}")
    if bucket_frac <= 0:
        return rate_bps
    return math.floor(math.log(rate_bps / BUCKET_REF_BPS) / math.log1p(bucket_frac))


def bucket_rate(bucket: float, bucket_frac: float) -> float:
    """The band's representative rate (geometric centre) -- the rate plans are
    optimised against, so a band's cached plan is independent of which
    measured rate first triggered it."""
    if bucket_frac <= 0:
        return bucket  # exact keying: the "bucket" is the rate itself
    return BUCKET_REF_BPS * (1.0 + bucket_frac) ** (bucket + 0.5)


def compute_bucket(rate_flops: float, nominal_flops: float, bucket_frac: float) -> float:
    """Quantise an effective-compute estimate into a geometric band of width
    ``bucket_frac``, anchored at the ES's calibrated nominal.

    Band ``i`` is centred on ``nominal * (1+f)^i`` (round-to-nearest in log
    space), so band 0 covers ``nominal * (1+f)^(-1/2) .. nominal * (1+f)^(1/2)``
    and -- unlike the floor-based link grid of :func:`rate_bucket` -- the
    *seed estimate itself sits exactly on its band's representative*.  A
    controller whose compute never drifts therefore optimises against the
    nominal ``eff_flops`` bit-for-bit, preserving plan equality with the
    link-only path; see :func:`compute_band_flops`.  ``bucket_frac <= 0``
    disables quantisation and returns the exact estimate (the always-replan
    degenerate keying)."""
    if rate_flops <= 0 or nominal_flops <= 0:
        raise ValueError(f"need positive rates, got {rate_flops}, {nominal_flops}")
    if bucket_frac <= 0:
        return rate_flops
    return round(math.log(rate_flops / nominal_flops) / math.log1p(bucket_frac))


def compute_band_flops(bucket: float, nominal_flops: float, bucket_frac: float) -> float:
    """The compute band's representative effective FLOP/s -- what plans are
    optimised against.  Band 0 maps back to the nominal *exactly* (not merely
    within the band), which is what keeps an undrifted joint controller
    bit-identical to the link-only controller."""
    if bucket_frac <= 0:
        return bucket  # exact keying: the "bucket" is the estimate itself
    return nominal_flops * (1.0 + bucket_frac) ** bucket


def topology_fingerprint(topology: CollabTopology) -> tuple:
    """Hashable identity of everything the optimum depends on *except* rates:
    the host/secondary names in order.

    Per-ES effective compute is deliberately NOT part of the fingerprint
    anymore: like link rates, ``eff_flops`` is an online-estimated quantity
    and lives in the bucketed key space (as each ES's band anchor plus band
    index -- see :func:`compute_bucket`), so the :class:`PlanCache` amortises
    across revisited compute operating points instead of pinning one compute
    level per cluster."""
    return (topology.host, topology.secondaries)


class _EwmaRateEstimator:
    """Shared EWMA machinery of the link/compute estimators: a dict of rate
    estimates seeded from nominals, each observation folding ``alpha`` of the
    way toward the new sample."""

    def __init__(self, nominal: Mapping, alpha: float = 0.4):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._rates = dict(nominal)

    def _fold(self, key, sample: float) -> float:
        prev = self._rates.get(key)
        est = sample if prev is None else (1.0 - self.alpha) * prev + self.alpha * sample
        self._rates[key] = est
        return est

    def rates(self) -> dict:
        return dict(self._rates)


class LinkRateEstimator(_EwmaRateEstimator):
    """EWMA per-link rate estimates from observed transfer times.

    Each observation ``(src, dst, nbytes, elapsed_s)`` yields a rate sample
    ``8 * nbytes / elapsed_s``; the estimate moves ``alpha`` of the way toward
    it.  Estimates are seeded from nominal rates, so before any traffic a
    controller optimises for the nominal rates' *bands* (representative rates
    within ``bucket_frac`` of the nominals -- close to, but not necessarily
    identical with, the offline nominal-rate plan)."""

    @classmethod
    def from_topology(cls, topology: CollabTopology, alpha: float = 0.4) -> "LinkRateEstimator":
        """Seed one estimate per directed host<->secondary link from nominals."""
        return cls(
            {pair: topology.link_between(*pair).rate_bps for pair in topology.collab_pairs()},
            alpha=alpha,
        )

    def observe(self, src: str, dst: str, nbytes: float, elapsed_s: float) -> float:
        """Fold one observed transfer in; returns the updated estimate."""
        if nbytes <= 0 or elapsed_s <= 0:
            raise ValueError(f"need positive bytes/elapsed, got {nbytes}, {elapsed_s}")
        return self._fold((src, dst), 8.0 * nbytes / elapsed_s)

    def rate(self, src: str, dst: str) -> float:
        return self._rates[(src, dst)]


class ComputeRateEstimator(_EwmaRateEstimator):
    """EWMA per-ES effective-compute estimates from observed execution times.

    The compute-side mirror of :class:`LinkRateEstimator`: each observation
    ``(es, flops, elapsed_s)`` -- one timed compute chunk of known FLOP count
    on one ES -- yields a rate sample ``flops / elapsed_s`` (effective
    FLOP/s) and moves that ES's estimate ``alpha`` of the way toward it.
    Estimates are seeded from each :class:`~repro_torch.core.topology.Platform`'s
    calibrated ``eff_flops`` (host and secondaries alike), so an ES that is
    never measured keeps behaving like its nominal.  Feeder: the serving
    engine's per-ES timing hook
    (:meth:`~repro_torch.runtime.serve.BatchingEngine.observe_es_time`)."""

    @classmethod
    def from_topology(cls, topology: CollabTopology, alpha: float = 0.4) -> "ComputeRateEstimator":
        """Seed one estimate per ES (host included) from the platform nominals."""
        return cls(
            {es: topology.platform_of(es).eff_flops for es in topology.es_names},
            alpha=alpha,
        )

    def observe(self, es: str, flops: float, elapsed_s: float) -> float:
        """Fold one observed execution in; returns the updated estimate."""
        if flops <= 0 or elapsed_s <= 0:
            raise ValueError(f"need positive flops/elapsed, got {flops}, {elapsed_s}")
        return self._fold(es, flops / elapsed_s)

    def observe_samples(self, samples) -> dict[str, float]:
        """Fold an iterable of ``(es, flops, elapsed_s)`` samples -- the exact
        triples the serving executor's timing attribution emits
        (``run_plan(..., time_observer=...)``).  Returns the updated per-ES
        estimates for the ESs observed."""
        seen: dict[str, float] = {}
        for es, flops, elapsed_s in samples:
            seen[es] = self.observe(es, flops, elapsed_s)
        return seen

    def rate(self, es: str) -> float:
        return self._rates[es]


class PlanCache:
    """LRU cache of optimisation results keyed on (fingerprint, buckets),
    where the fingerprint covers the cluster *and* the optimiser config.

    ``get`` / ``put`` are O(1); ``hits``/``misses``/``evictions`` make the
    amortisation claim measurable (the steady-state hit rate).

    With a persistent ``store`` (:class:`~repro_torch.core.planstore.PlanStore`)
    attached, the cache becomes the in-memory front of a two-tier read-through
    / write-through hierarchy: a memory miss falls through to the store (a
    store hit is promoted into the LRU *without* a write-back and counted in
    both ``hits`` and ``store_hits``), ``put`` writes both tiers, and LRU
    eviction only drops the memory copy -- the store keeps every plan ever
    optimised, so restarts and sibling processes warm-start from it.
    ``peek`` stays memory-only by design: the serving path peeks per
    admission decision, and hammering sqlite from that loop would buy nothing
    (the active entry is always resident after its first ``get``)."""

    def __init__(self, capacity: int = 128, store=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.store = store
        self._entries: OrderedDict[tuple, OptimizeResult] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.store_hits = 0  # memory misses served by the persistent tier

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: tuple) -> OptimizeResult | None:
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            return entry
        if self.store is not None:
            entry = self.store.get(key)
            if entry is not None:
                self._insert(key, entry)
                self.hits += 1
                self.store_hits += 1
                return entry
        self.misses += 1
        return None

    def peek(self, key: tuple) -> OptimizeResult | None:
        """Read the *memory tier only*, without touching hit/miss counters or
        the LRU order.  The serving path (latency predictions, admission
        control) peeks, so the telemetry keeps counting *plan requests per
        control epoch* -- the quantity the amortisation claim is stated in --
        rather than being swamped by per-admission lookups."""
        return self._entries.get(key)

    def put(self, key: tuple, result: OptimizeResult, provenance: dict | None = None) -> None:
        self._insert(key, result)
        if self.store is not None:
            self.store.put(key, result, provenance=provenance)

    def _insert(self, key: tuple, result: OptimizeResult) -> None:
        """Memory-tier insert with LRU eviction (never touches the store)."""
        self._entries[key] = result
        self._entries.move_to_end(key)
        if len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def entries(self) -> list[OptimizeResult]:
        """All cached results, least- to most-recently used (e.g. for
        verifying every plan a controller ever served stays lossless)."""
        return list(self._entries.values())


# Every ReplanConfig field is either folded into ReplanController._fingerprint
# (it changes which plan a cache/store key maps to) or named here with the
# reason it may NOT key.  The partition is machine-checked by
# repro_torch.analysis.keying_lint: adding a config field without fingerprinting it
# or justifying its exclusion is a lint failure -- the silent-stale-plan bug
# class (two controllers differing in an unkeyed knob sharing wrong store
# entries) cannot land unnoticed.
FINGERPRINT_EXCLUDED: dict[str, str] = {
    "engine": "batched and scalar candidate pricing return bit-identical "
    "plans (pinned in tests/test_torch_optimizer.py), so both engines share one "
    "cache entry by design",
    "adapt_compute": "gates whether bucket keys *move* under compute drift, "
    "never what plan a given key maps to; frozen and adaptive controllers "
    "share entries by design",
    "alpha": "estimator-side EWMA smoothing: it changes when a band boundary "
    "is crossed, not the plan either band maps to (bands key via the bucket "
    "part of the cache key)",
    "hysteresis": "adoption timing only: how many epochs a drift must persist "
    "before the active key switches; the key->plan mapping is untouched",
}


@dataclass(frozen=True)
class ReplanConfig:
    """Knobs of the online re-planner (see the module docstring for design)."""

    bucket_frac: float = 0.3  # geometric band width; <= 0 keys on exact rates
    hysteresis: int = 2  # consecutive epochs outside the active bands to adopt
    alpha: float = 0.4  # EWMA weight of the rate estimators (link and compute)
    n_tasks: int = 4  # concurrent tasks the plan is optimised for
    # Joint compute+link adaptation.  False freezes the compute estimates at
    # the platform nominals (the link-only controller, kept as the
    # baseline joint adaptation is measured against): observe_compute
    # becomes a no-op, so compute buckets never
    # switch and only channel drift triggers re-planning.  This knob is NOT
    # part of the cache fingerprint: it only gates whether keys *move*, never
    # what plan a given key maps to, so adaptive and frozen controllers can
    # share cache entries by design.
    adapt_compute: bool = True
    overlap_choices: tuple[int, ...] = (2, 4, 6, 8)
    max_rounds: int = 6  # coordinate-descent budget per re-optimisation
    # Candidate-pricing engine for cache-miss re-optimisations.  "batched"
    # (the DAG-template + vectorized-DES fast path) and "scalar" return
    # bit-identical plans; the knob exists so benchmarks can price the miss
    # path both ways.  Misses therefore pay the fast path by default.
    engine: str = "batched"
    # Hard planner-latency bounds for the miss path (None/0.0 = unbounded):
    # eval_budget caps priced candidates per optimize_plan call, tol stops a
    # replan once a descent round improves the makespan by less than this.
    eval_budget: int | None = None
    tol: float = 0.0
    # Objective engine.  The DES is the repo's ground truth and the default:
    # the closed form prices each secondary slot's uplink as shared across
    # tasks (eq. 17's x n_tasks) while the DES models the paper's multi-task
    # deployment of N * n_tasks distinct secondaries with their own links, so
    # for n_tasks > 1 the closed form over-weights communication and
    # over-shrinks slow-link segments.  Set False for the ~20x cheaper
    # closed-form search when the re-plan latency budget is tight (it stays a
    # safe choice for single-task controllers, where the two engines agree).
    use_simulator: bool = True
    # Per-stage partitioning-scheme vocabulary handed to the optimizer.  The
    # halo-only default keeps every miss on the legacy search (bit-identical
    # plans).  A larger vocabulary enlarges the searched space, so it IS part
    # of the cache fingerprint -- two controllers with different vocabularies
    # must never share an entry, while the pricing `engine` still does not
    # key (bit-identical scores either way).  Scheme vocabularies beyond the
    # default require the DES objective (the closed form is halo-only), so
    # use_simulator=False with a non-trivial vocabulary raises.
    schemes: tuple[str, ...] = (SCHEME_HALO,)


def _optimize_against(
    net: ConvNetGeom, topology: CollabTopology, config: ReplanConfig
) -> OptimizeResult:
    """One plan optimisation against the given topology's rates."""
    objective = None
    if not config.use_simulator and tuple(config.schemes) != (SCHEME_HALO,):
        raise ValueError(
            "use_simulator=False prices through the halo-only closed form; "
            f"the scheme vocabulary {tuple(config.schemes)} needs the DES "
            "objective (use_simulator=True)"
        )
    if not config.use_simulator:

        def objective(ratios: tuple[float, ...], w: int) -> float:
            try:
                return halp_closed_form(
                    net,
                    topology=topology,
                    ratios=ratios,
                    overlap_rows=w,
                    n_tasks=config.n_tasks,
                )["total"]
            except (AssertionError, ValueError):
                return float("inf")

    return optimize_plan(
        net,
        topology,
        n_tasks=config.n_tasks,
        overlap_choices=config.overlap_choices,
        max_rounds=config.max_rounds,
        objective=objective,
        engine=config.engine,
        eval_budget=config.eval_budget,
        tol=config.tol,
        schemes=tuple(config.schemes),
    )


def optimize_static(
    net: ConvNetGeom, topology: CollabTopology, config: ReplanConfig = ReplanConfig()
) -> OptimizeResult:
    """The offline baseline: optimise once against *nominal* rates.

    Uses the same objective/budget as :class:`ReplanController`, so benchmark
    comparisons isolate adaptivity rather than optimiser settings."""
    return _optimize_against(net, topology, config)


class StaticPlanner:
    """Planner-protocol wrapper around one fixed plan (the paper's baseline):
    ignores all observations (link and compute), serves the same plan every
    epoch."""

    def __init__(self, plan: HALPPlan):
        self._plan = plan

    def observe_transfer(self, src: str, dst: str, nbytes: float, elapsed_s: float) -> None:
        pass

    def observe_compute(self, es: str, flops: float, elapsed_s: float) -> None:
        pass

    def plan_for_epoch(self) -> HALPPlan:
        return self._plan


class ReplanController:
    """Joint compute+link adaptive planner: EWMA estimates -> buckets ->
    shared hysteresis -> cached :func:`optimize_plan`.

    Implements the same planner protocol as :class:`StaticPlanner`
    (``observe_transfer`` + ``observe_compute`` + ``plan_for_epoch``), so
    :func:`~repro_torch.core.simulator.replay_trace` and the serving loop drive
    either interchangeably.

    Subclasses may override :meth:`_optimize` to swap what is recomputed on a
    bucket switch (e.g. :class:`~repro_torch.core.placement.PlacementController`
    re-places *every task* instead of re-optimising one shared plan); the
    estimator, bucketing, hysteresis, cache, and telemetry are inherited
    unchanged.  ``_cache_kind`` namespaces cache keys so different controller
    kinds can share one :class:`PlanCache`."""

    _cache_kind = "plan"

    def __init__(
        self,
        net: ConvNetGeom,
        topology: CollabTopology,
        config: ReplanConfig = ReplanConfig(),
        cache: PlanCache | None = None,
        store=None,
    ):
        self.net = net
        self.nominal = topology
        self.config = config
        # store= attaches a persistent tier (core.planstore.PlanStore): a
        # restarted controller then serves previously-optimised operating
        # points with zero optimizer calls (warm start), and controllers in
        # other processes sharing the same store file inherit them too.
        self.cache = cache if cache is not None else PlanCache(store=store)
        if store is not None and self.cache.store is None:
            self.cache.store = store
        self.estimator = LinkRateEstimator.from_topology(topology, alpha=config.alpha)
        self.compute_estimator = ComputeRateEstimator.from_topology(
            topology, alpha=config.alpha
        )
        # per-ES band anchors of the compute grid (the calibrated nominals)
        self._nominal_flops = {
            es: topology.platform_of(es).eff_flops for es in topology.es_names
        }
        # identity of everything a cached optimum depends on besides the rate
        # buckets: the cluster and every optimiser-facing config knob (bucket
        # indices are grid-relative, so bucket_frac in particular must key) --
        # controllers with different configs can then share one PlanCache.
        # eff_flops is NOT here: it keys through the compute part of the
        # bucket key (anchor + band index), and adapt_compute only gates
        # whether keys move, never what a key maps to.
        self._fingerprint = (
            self._cache_kind,
            topology_fingerprint(topology),
            config.bucket_frac,
            config.n_tasks,
            tuple(config.overlap_choices),
            config.max_rounds,
            config.use_simulator,
            # search-bounding knobs change which plan a miss produces, so they
            # must key; the pricing engine does NOT (bit-identical scores) --
            # batched and scalar controllers share entries by design
            config.eval_budget,
            config.tol,
            # the scheme vocabulary changes the searched space (and hence the
            # plan a miss produces), so it keys like the search bounds do
            tuple(config.schemes),
        )
        self._active = self._bucket_key()
        self._pending_count = 0  # consecutive epochs spent outside the active bands
        # telemetry
        self.epochs = 0
        self.replans = 0  # adopted bucket switches
        self.optimizer_calls = 0
        self._calibration = 1.0  # measured/predicted latency EWMA (serving)
        # (fingerprint, active key, batch) -> raw predicted latency; the
        # serving loop prices whole latency *tables* per operating point, so
        # repeat pricing of the same point must be a dict hit
        self._latency_memo: dict[tuple, float] = {}

    # -- bucketing ------------------------------------------------------------

    def _bucket_key(self) -> tuple:
        """The joint operating point: quantised link bands + quantised compute
        bands.  The compute part carries each ES's band *anchor* (its nominal
        ``eff_flops``) alongside the band index, so the key alone determines
        the representative platform -- controllers over different-speed
        clusters can share one cache without colliding."""
        f = self.config.bucket_frac
        links = tuple(
            sorted((pair, rate_bucket(r, f)) for pair, r in self.estimator.rates().items())
        )
        noms = self._nominal_flops
        compute = tuple(
            sorted(
                (es, noms[es], compute_bucket(r, noms[es], f))
                for es, r in self.compute_estimator.rates().items()
            )
        )
        return (links, compute)

    def estimated_topology(self) -> CollabTopology:
        """The nominal topology rebuilt with the active bands' representative
        link rates and per-ES platforms -- what plans are optimised against.
        Undrifted ESs sit in compute band 0, whose representative is exactly
        the nominal ``eff_flops`` (see :func:`compute_bucket`)."""
        f = self.config.bucket_frac
        link_part, compute_part = self._active
        links = {pair: Link(bucket_rate(b, f)) for pair, b in link_part}
        platforms = {
            es: dataclasses.replace(
                self.nominal.platform_of(es),
                eff_flops=compute_band_flops(b, nom, f),
            )
            for es, nom, b in compute_part
        }
        return self.nominal.with_links(links).with_platforms(platforms)

    # -- planner protocol -----------------------------------------------------

    def observe_transfer(self, src: str, dst: str, nbytes: float, elapsed_s: float) -> float:
        """Feed one observed transfer into the link-rate estimator."""
        return self.estimator.observe(src, dst, nbytes, elapsed_s)

    def observe_compute(self, es: str, flops: float, elapsed_s: float) -> float:
        """Feed one observed per-ES execution (a timed compute chunk of known
        FLOP count) into the compute-rate estimator.  With
        ``config.adapt_compute=False`` the sample is dropped (estimates stay
        at the nominals -- the link-only baseline), but the arguments are
        still validated so mis-wired feeders fail loudly either way."""
        if es not in self._nominal_flops:
            raise ValueError(f"{es!r} is not an ES of this controller's topology")
        if not self.config.adapt_compute:
            if flops <= 0 or elapsed_s <= 0:
                raise ValueError(f"need positive flops/elapsed, got {flops}, {elapsed_s}")
            return self.compute_estimator.rate(es)
        return self.compute_estimator.observe(es, flops, elapsed_s)

    def step(self) -> bool:
        """Advance one control epoch; returns True iff the active bucket key
        switched (i.e. the serving plan may change).

        Hysteresis: the estimates must sit *outside* the active bands for
        ``hysteresis`` consecutive epochs (<= 1 means immediately) before the
        most recent candidate key is adopted; wandering back inside the
        active bands resets the counter.  Counting epochs-away-from-active
        (rather than epochs-on-one-candidate) means a channel drifting
        monotonically across one band per epoch still replans after the
        hysteresis lag instead of being starved by its own motion."""
        self.epochs += 1
        candidate = self._bucket_key()
        if candidate == self._active:
            self._pending_count = 0
            return False
        self._pending_count += 1
        if self._pending_count < max(1, self.config.hysteresis):
            return False
        self._active = candidate
        self._pending_count = 0
        self.replans += 1
        # a bucket switch retires every latency-memo entry priced at another
        # operating point; without this the memo grows one latency table per
        # bucket key ever visited over a long-running controller
        self._latency_memo = {
            k: v for k, v in self._latency_memo.items() if k[1] == candidate
        }
        return True

    def _optimize(self, topology: CollabTopology) -> OptimizeResult:
        """Recompute the operating point for ``topology`` (cache-miss path).
        Subclasses override this to re-place instead of re-plan."""
        return _optimize_against(self.net, topology, self.config)

    def current(self) -> OptimizeResult:
        """The active operating point's plan: an O(1) cache hit in steady
        state, a fresh :meth:`_optimize` run on a miss.

        This is the *per-epoch* entry point and the one place hit/miss
        telemetry is counted; out-of-epoch reads (``plan``, ``makespan``, the
        serving integration) go through :meth:`_active_result` instead."""
        key = (self._fingerprint, self._active)
        result = self.cache.get(key)
        if result is None:
            topology = self.estimated_topology()
            result = self._optimize(topology)
            self.optimizer_calls += 1
            self.cache.put(key, result, provenance=self._provenance(topology, result))
        return result

    def _provenance(self, topology: CollabTopology, result: OptimizeResult) -> dict:
        """What a freshly-optimised entry was computed against -- the band
        representatives, not the raw measurements (the measurements that led
        here are not part of the key, so recording them would be misleading).
        Persisted verbatim by the store tier; harmless when there is none."""
        return dict(
            kind=self._cache_kind,
            engine=self.config.engine,
            makespan=float(result.makespan),
            host=topology.host,
            link_rates_bps={
                f"{src}->{dst}": topology.link_between(src, dst).rate_bps
                for src, dst in topology.collab_pairs()
            },
            platform_eff_flops={
                es: topology.platform_of(es).eff_flops for es in topology.es_names
            },
        )

    def prime(self, bucket_key: tuple) -> OptimizeResult:
        """Fill the cache (and store, if attached) for an arbitrary operating
        point without adopting it: the offline entry point that walks the
        bucket lattice with the controller's own keying/optimisation logic.
        The active key, pending hysteresis count, and latency memo are left
        untouched."""
        saved = self._active
        self._active = bucket_key
        try:
            return self.current()
        finally:
            self._active = saved

    def _active_result(self) -> OptimizeResult:
        """The active plan without disturbing the epoch telemetry (peek);
        falls through to :meth:`current` only if the entry is genuinely
        absent (first request, or evicted)."""
        result = self.cache.peek((self._fingerprint, self._active))
        return result if result is not None else self.current()

    def plan_for_epoch(self) -> HALPPlan:
        """One control epoch: hysteresis step, then the (cached) active plan."""
        self.step()
        return self.current().plan

    @property
    def plan(self) -> HALPPlan:
        return self._active_result().plan

    @property
    def makespan(self) -> float:
        """Predicted makespan of the active plan at ``config.n_tasks``."""
        return self._active_result().makespan

    # -- serving integration --------------------------------------------------

    def _price_batch(self, batch_size: int) -> float:
        """Price the active operating point at ``batch_size`` concurrent
        tasks (closed form here; :class:`~repro_torch.core.placement.\
PlacementController` overrides with the shared-secondary multi-task DES).
        Mixed-scheme plans have no closed form: they price through the scheme
        DES at ``n_tasks=batch_size`` instead."""
        plan = self._active_result().plan
        if isinstance(plan, SchemePlan):
            return simulate_scheme(
                self.net,
                self.estimated_topology(),
                ratios=plan.ratios,
                overlap_rows=plan.overlap_rows,
                assignment=plan.assignment,
                n_tasks=batch_size,
            )["total"]
        return halp_closed_form(
            self.net,
            topology=self.estimated_topology(),
            plan=plan,
            n_tasks=batch_size,
        )["total"]

    def _raw_predicted_latency(self, batch_size: int) -> float:
        """Memoised :meth:`_price_batch`: pure in (fingerprint, active bucket
        key, batch size), because ``estimated_topology`` and the active plan
        are both functions of the active key alone."""
        key = (self._fingerprint, self._active, batch_size)
        hit = self._latency_memo.get(key)
        if hit is None:
            hit = self._price_batch(batch_size)
            self._latency_memo[key] = hit
        return hit

    def predicted_latency(self, batch_size: int) -> float:
        """Closed-form makespan of the *current* plan for a batch of
        ``batch_size`` tasks, scaled by the measured-latency calibration --
        the latency model ``choose_batch_size`` admits batches against."""
        return self._raw_predicted_latency(batch_size) * self._calibration

    def latency_table(self, max_batch: int) -> np.ndarray:
        """The calibrated latency curve ``table[b-1] = predicted_latency(b)``
        for ``b = 1..max_batch`` -- one ready-made ``lat_table`` row for
        ``repro_torch.runtime.serve.serve_trace``, priced at the controller's
        current operating point (re-extract after a bucket switch)."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        return np.array([self.predicted_latency(b) for b in range(1, max_batch + 1)])

    def observe_batch_latency(self, batch_size: int, elapsed_s: float) -> None:
        """Fold a measured batch latency back in: the ratio measured/predicted
        becomes an EWMA calibration factor on future predictions (clamped to
        [0.1, 10] so one outlier batch cannot poison admission control)."""
        if elapsed_s <= 0 or batch_size < 1:
            return
        predicted = self._raw_predicted_latency(batch_size)
        if predicted <= 0:
            return
        ratio = min(10.0, max(0.1, elapsed_s / predicted))
        a = self.config.alpha
        self._calibration = (1.0 - a) * self._calibration + a * ratio

    def stats(self) -> dict:
        out = dict(
            epochs=self.epochs,
            replans=self.replans,
            optimizer_calls=self.optimizer_calls,
            cache_hits=self.cache.hits,
            cache_misses=self.cache.misses,
            cache_entries=len(self.cache),
            cache_hit_rate=self.cache.hit_rate,
            calibration=self._calibration,
        )
        if self.cache.store is not None:
            # warm-start telemetry: how many plan requests the persistent
            # tier absorbed that would otherwise have been optimizer calls
            out["store_hits"] = self.cache.store_hits
            out["store_entries"] = len(self.cache.store)
        return out
