"""Per-task heterogeneous placement: one ES pool, one sub-topology per task
(the port's copy of ``repro/core/placement.py``, plain Python and numpy).

The paper's multi-task extension (§IV, eq. 22) deploys every task on an
identical clone of one secondary group and shares only the host; its
reliability results under time-variant channels -- and DistrEdge's per-device
adaptive splits (arXiv 2202.01699) -- show the win on a *heterogeneous*
cluster comes from matching each task's placement to current per-ES /
per-link conditions instead.  This module does that end to end:

* :class:`TaskPlacement` -- the assignment itself: a partition of the pool's
  secondaries into per-task groups, plus one :class:`~repro_torch.core.partition.HALPPlan`
  per task over its sub-topology (fastest ES first, so thin-layer
  auto-reduction sheds the weakest member).

* :func:`place_tasks` -- the placement optimizer: greedy capacity-weighted
  (LPT-style) assignment of secondaries to tasks, a local-search pass that
  swaps/moves ESs between tasks, and per-task plan-knob refinement via
  :func:`~repro_torch.core.optimizer.optimize_plan` (warm-started from the
  incumbent plan's knobs).  Candidates are scored by the discrete-event
  simulator through :func:`~repro_torch.core.events.build_multitask_dag`, which
  keys resources by *physical* ES/link names -- shared host and link
  contention across tasks is therefore modelled by construction, not
  estimated.  With ``engine="batched"`` (default) each pair-scan's swap/move
  neighbourhood is priced speculatively as one
  :class:`~repro_torch.core.events.MultitaskBatchEvaluator` sweep (plan layouts +
  cached multi-task DAG templates + ``Sim.run_batch``) with an
  assignment-keyed memo; ``engine="scalar"`` keeps the historical
  one-candidate-at-a-time pricing callable as the benchmark baseline.  The
  engines share the search loop and score bit-identically, so they return
  the same placement.

* :func:`shared_plan_placement` -- the paper-faithful baseline the benchmark
  compares against: secondaries grouped in pool order, every task running the
  same equal-split plan geometry (no capacity awareness anywhere).

* :class:`PlacementController` -- the online loop: the
  :class:`~repro_torch.core.replan.ReplanController` machinery (EWMA link-rate AND
  per-ES compute-rate estimates -> quantised buckets -> shared hysteresis ->
  cache), but a bucket switch -- whether a link band or a straggling ES's
  compute band moved -- re-*places* every task instead of re-optimising one
  shared plan.
  ``predicted_latency`` prices a batch by tiling the active placement's plans
  over the batch's tasks and simulating them on the shared pool, so
  :func:`~repro_torch.runtime.serve.plan_aware_batch_size` admits batches against
  the true contended makespan.

Plans are geometry-only row partitions, so every placement is lossless by
construction; ``tests/test_torch_placement.py`` executes random placements
through ``spatial/partition_apply.run_plan`` to prove it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

from .events import MultitaskBatchEvaluator, _layout_cached, build_multitask_dag
from .nets import ConvNetGeom
from .optimizer import optimize_plan
from .partition import HALPPlan, plan_halp_topology
from .replan import ReplanConfig, ReplanController
from .simulator import Sim
from .topology import CollabTopology

__all__ = [
    "TaskPlacement",
    "PlacementResult",
    "place_tasks",
    "shared_plan_placement",
    "simulate_placement",
    "PlacementController",
]


@dataclass(frozen=True)
class TaskPlacement:
    """A partition of one pool's secondaries into per-task sub-clusters.

    ``assignments[t]`` are the physical secondaries serving task ``t`` (row
    order = the order given; put faster ESs first), ``plans[t]`` the HALP plan
    over that sub-topology.  Slot names in every plan are physical ES names,
    so :func:`~repro_torch.core.events.build_multitask_dag` resolves contention on
    the shared host and links directly from the names."""

    pool: CollabTopology
    assignments: tuple[tuple[str, ...], ...]
    plans: tuple[HALPPlan, ...]

    def __post_init__(self) -> None:
        if len(self.assignments) != len(self.plans):
            raise ValueError("need exactly one plan per task assignment")
        if not self.assignments:
            raise ValueError("a placement needs at least one task")
        seen: set[str] = set()
        for t, (group, plan) in enumerate(zip(self.assignments, self.plans)):
            if plan.host != self.pool.host:
                raise ValueError(f"task {t}: plan host {plan.host!r} != pool host")
            if tuple(plan.secondary_slots) != tuple(group):
                raise ValueError(
                    f"task {t}: plan slots {plan.secondary_slots} != assignment {group}"
                )
            for s in group:
                if s not in self.pool.secondaries:
                    raise ValueError(f"task {t}: {s!r} is not in the pool")
                if s in seen:
                    raise ValueError(f"secondary {s!r} assigned to more than one task")
                seen.add(s)

    @property
    def n_tasks(self) -> int:
        return len(self.assignments)

    def sub_topology(self, task: int) -> CollabTopology:
        return self.pool.sub_topology(self.assignments[task])


@dataclass
class PlacementResult:
    """Outcome of :func:`place_tasks` (duck-typed like
    :class:`~repro_torch.core.optimizer.OptimizeResult` where the replan/cache
    machinery needs it: ``makespan`` is the cached score)."""

    placement: TaskPlacement
    makespan: float  # DES makespan of the whole batch on the shared pool
    avg_delay: float  # mean per-task finish time (the paper's Fig. 7 metric)
    per_task_finish: tuple[float, ...]
    knobs: tuple[tuple[tuple[float, ...], int], ...]  # per-task (ratios, overlap)
    evaluations: int = 0
    history: list[tuple[tuple[tuple[str, ...], ...], float]] = field(default_factory=list)


def _simulate_plans(
    net: ConvNetGeom,
    plans: Sequence[HALPPlan],
    topology: CollabTopology,
    slowdown: dict[str, float] | None = None,
) -> dict:
    """One DES run of a plan set on a shared pool -- the single source of the
    makespan / per-task-finish accounting for both the optimizer's candidate
    scores and the reported placement metrics."""
    sim = Sim()
    if slowdown:
        sim.slowdown.update(slowdown)
    heads = build_multitask_dag(sim, list(plans), topology)
    makespan = sim.run()
    finishes = [sim.finish_of(h) for h in heads]
    return dict(
        total=makespan,
        per_task_finish=finishes,
        avg_delay=sum(finishes) / len(finishes),
        sim=sim,
    )


def simulate_placement(
    net: ConvNetGeom,
    placement: TaskPlacement,
    topology: CollabTopology | None = None,
    slowdown: dict[str, float] | None = None,
) -> dict:
    """Exact DES of a placement on its (shared) pool.

    ``topology`` overrides the pool's rates (e.g. the bucket-representative
    estimates of a controller) without touching the geometry.  Returns the
    same record shape as :func:`~repro_torch.core.simulator.simulate_halp`."""
    return _simulate_plans(
        net, placement.plans, topology or placement.pool, slowdown=slowdown
    )


def _ranked(pool: CollabTopology) -> list[str]:
    """Pool secondaries fastest-first (ties keep pool order -- deterministic)."""
    order = {s: j for j, s in enumerate(pool.secondaries)}
    return sorted(pool.secondaries, key=lambda s: (-pool.platforms[s].eff_flops, order[s]))


def _greedy_groups(pool: CollabTopology, n_tasks: int, min_per_task: int) -> list[list[str]]:
    """LPT-style capacity balancing: walk ESs fastest-first, give each to the
    task with the least total effective FLOP/s -- under-filled tasks (below
    ``min_per_task``) take priority so every task ends up with a feasible
    sub-cluster.  Groups keep fastest-first internal order."""
    groups: list[list[str]] = [[] for _ in range(n_tasks)]
    cap = [0.0] * n_tasks
    for s in _ranked(pool):
        under = [t for t in range(n_tasks) if len(groups[t]) < min_per_task]
        t = min(under or range(n_tasks), key=lambda t: (cap[t], t))
        groups[t].append(s)
        cap[t] += pool.platforms[s].eff_flops
    return groups


def _plans_for(
    net: ConvNetGeom,
    pool: CollabTopology,
    groups: Sequence[Sequence[str]],
    overlap_rows: int,
) -> tuple[tuple[HALPPlan, ...], tuple[tuple[tuple[float, ...], int], ...]]:
    """Capacity-ratio plans for every group (the cheap scoring mode).
    Raises ValueError/AssertionError when any group is infeasible."""
    plans = []
    knobs = []
    for group in groups:
        sub = pool.sub_topology(group)
        ratios = sub.capacity_ratios()
        plans.append(plan_halp_topology(net, sub, overlap_rows=overlap_rows, ratios=ratios))
        knobs.append((ratios, overlap_rows))
    return tuple(plans), tuple(knobs)


def _score(net: ConvNetGeom, pool: CollabTopology, plans: Sequence[HALPPlan], objective: str) -> float:
    run = _simulate_plans(net, plans, pool)
    return run["total"] if objective == "makespan" else run["avg_delay"]


def place_tasks(
    net: ConvNetGeom,
    pool: CollabTopology,
    n_tasks: int,
    *,
    overlap_rows: int = 4,
    min_per_task: int = 2,
    swap_rounds: int = 4,
    objective: str = "avg_delay",
    optimize_final: bool = True,
    overlap_choices: Sequence[int] = (2, 4, 6, 8),
    max_rounds: int = 4,
    engine: str = "batched",
) -> PlacementResult:
    """Partition the pool's secondaries across ``n_tasks`` concurrent tasks.

    Three phases, all scored by the shared-contention DES
    (:func:`simulate_placement`), minimising ``objective`` (``"avg_delay"``,
    the paper's per-task mean, or ``"makespan"``):

    1. **Greedy capacity-weighted assignment** -- LPT over effective FLOP/s,
       every task guaranteed ``min_per_task`` secondaries.
    2. **Local-search swaps** -- for every task pair, try swapping each ES
       pair and moving single ESs from larger groups; accept strict
       improvements, repeat up to ``swap_rounds`` rounds or to convergence.
       This is where link asymmetry gets fixed: a fast ES behind a slow link
       migrates to the task that loads its uplink least.  With
       ``engine="batched"`` each pair's whole swap/move neighbourhood is
       priced speculatively in one vectorized DES sweep and memoised by
       assignment, so the sequential acceptance scan below is mostly memo
       hits; ``engine="scalar"`` prices one candidate at a time (the
       pre-template baseline the batched engine is held against).
       Both engines score bit-identically and return the same placement.
    3. **Per-task plan refinement** (``optimize_final``) -- each winner group's
       (ratios, overlap) knobs searched by
       :func:`~repro_torch.core.optimizer.optimize_plan` on its own sub-topology,
       warm-started from the incumbent plan's capacity-ratio knobs and using
       the same pricing ``engine``; the refined plan set is kept only if it
       improves the joint score (per-task refinement ignores host contention,
       so it is re-validated jointly).

    Requires ``len(pool.secondaries) >= n_tasks * min_per_task``."""
    if n_tasks < 1:
        raise ValueError(f"need at least one task, got {n_tasks}")
    if objective not in ("avg_delay", "makespan"):
        raise ValueError(f"objective must be 'avg_delay' or 'makespan', got {objective!r}")
    if engine not in ("batched", "scalar"):
        raise ValueError(f"engine must be 'batched' or 'scalar', got {engine!r}")
    if pool.n_secondaries < n_tasks * min_per_task:
        raise ValueError(
            f"pool has {pool.n_secondaries} secondaries; {n_tasks} tasks need "
            f">= {n_tasks * min_per_task} (min_per_task={min_per_task})"
        )
    evals = 0
    history: list[tuple[tuple[tuple[str, ...], ...], float]] = []
    evaluator = (
        MultitaskBatchEvaluator(net, pool, overlap_rows=overlap_rows)
        if engine == "batched"
        else None
    )
    # assignment-keyed score memo (batched engine only -- the scalar engine
    # keeps the historical price-every-candidate cost the benchmark measures)
    memo: dict[tuple, float] = {}

    def price_all(cands: Sequence[Sequence[Sequence[str]]]) -> list[float]:
        nonlocal evals
        keys = [tuple(tuple(g) for g in c) for c in cands]
        out: list[float | None] = [None] * len(cands)
        if evaluator is not None:
            for k, kk in enumerate(keys):
                if kk in memo:
                    out[k] = memo[kk]
            fresh = [(k, keys[k]) for k in range(len(cands)) if out[k] is None]
            if fresh:
                results = evaluator.evaluate([kk for _, kk in fresh])
                evals += len(fresh)
                for (k, kk), res in zip(fresh, results):
                    if res is None:
                        v = float("inf")
                    else:
                        v = res["total"] if objective == "makespan" else res["avg_delay"]
                        history.append((kk, v))
                    memo[kk] = v
                    out[k] = v
        else:
            for k, kk in enumerate(keys):
                evals += 1
                try:
                    plans, _knobs = _plans_for(net, pool, kk, overlap_rows)
                    v = _score(net, pool, plans, objective)
                    history.append((kk, v))
                except (AssertionError, ValueError):
                    v = float("inf")
                out[k] = v
        return [v if v is not None else float("inf") for v in out]

    rank = {s: j for j, s in enumerate(_ranked(pool))}  # invariant per call

    def apply_move(groups, t1: int, t2: int, s1, s2):
        """The move's resulting assignment, or None if it is no longer valid
        against the *current* groups (they mutate when accepts land mid-scan)."""
        if s1 is not None and s1 not in groups[t1]:
            return None
        if s2 is not None and s2 not in groups[t2]:
            return None
        if s1 is None and len(groups[t2]) <= min_per_task:
            return None
        if s2 is None and len(groups[t1]) <= min_per_task:
            return None
        cand = [list(g) for g in groups]
        if s1 is not None:
            cand[t1].remove(s1)
            cand[t2].append(s1)
        if s2 is not None:
            cand[t2].remove(s2)
            cand[t1].append(s2)
        # keep fastest-first order inside each group
        for g in cand:
            g.sort(key=lambda s: rank[s])
        return cand

    groups = _greedy_groups(pool, n_tasks, min_per_task)
    best = price_all([groups])[0]
    if not math.isfinite(best):
        raise ValueError(
            f"no feasible placement for {n_tasks} tasks on this pool "
            f"(greedy assignment {groups} has no valid HALP plan)"
        )

    for _ in range(swap_rounds):
        improved = False
        for t1 in range(n_tasks):
            for t2 in range(t1 + 1, n_tasks):
                candidates = []
                for s1 in groups[t1]:
                    for s2 in groups[t2]:
                        candidates.append((s1, s2))  # swap
                    if len(groups[t1]) > min_per_task:
                        candidates.append((s1, None))  # move t1 -> t2
                for s2 in groups[t2]:
                    if len(groups[t2]) > min_per_task:
                        candidates.append((None, s2))  # move t2 -> t1
                if evaluator is not None:
                    # speculative batch: the whole neighbourhood of the current
                    # assignment in one vectorized sweep; the acceptance scan
                    # below then runs on memo hits until the base moves
                    price_all(
                        [c for s1, s2 in candidates if (c := apply_move(groups, t1, t2, s1, s2))]
                    )
                for idx, (s1, s2) in enumerate(candidates):
                    cand = apply_move(groups, t1, t2, s1, s2)
                    if cand is None:
                        continue
                    score = price_all([cand])[0]
                    if score < best - 1e-15:
                        best = score
                        groups = cand
                        improved = True
                        if evaluator is not None:
                            price_all(
                                [
                                    c
                                    for m1, m2 in candidates[idx + 1 :]
                                    if (c := apply_move(groups, t1, t2, m1, m2))
                                ]
                            )
        if not improved:
            break

    best_plans, best_knobs = _plans_for(net, pool, groups, overlap_rows)

    def joint_score(plans: Sequence[HALPPlan], knobs) -> dict | None:
        """One shared-pool DES run of an explicit plan set: the batched engine
        prices it through the template path (bit-identical), the scalar
        engine through ``simulate_placement``'s machinery."""
        if evaluator is not None:
            layouts = [
                _layout_cached(net, tuple(g), pool.host, w, tuple(r))
                for g, (r, w) in zip(groups, knobs)
            ]
            if all(lay is not None for lay in layouts):
                return evaluator.evaluate_layout_sets([layouts])[0]
        run = _simulate_plans(net, plans, pool)
        return dict(
            total=run["total"],
            avg_delay=run["avg_delay"],
            per_task_finish=tuple(run["per_task_finish"]),
        )

    if optimize_final:
        refined_plans = []
        refined_knobs = []
        for group, (init_ratios, _w) in zip(groups, best_knobs):
            sub = pool.sub_topology(group)
            res = optimize_plan(
                net,
                sub,
                n_tasks=1,
                overlap_choices=overlap_choices,
                max_rounds=max_rounds,
                init_ratios=init_ratios,  # warm start: the incumbent plan's knobs
                engine=engine,
            )
            refined_plans.append(res.plan)
            refined_knobs.append((res.ratios, res.overlap_rows))
            evals += res.evaluations
        run = joint_score(refined_plans, refined_knobs)
        score = run["total"] if objective == "makespan" else run["avg_delay"]
        evals += 1
        if score < best:
            best, best_plans, best_knobs = score, tuple(refined_plans), tuple(refined_knobs)

    placement = TaskPlacement(
        pool=pool,
        assignments=tuple(tuple(g) for g in groups),
        plans=best_plans,
    )
    final = joint_score(best_plans, best_knobs)
    return PlacementResult(
        placement=placement,
        makespan=final["total"],
        avg_delay=final["avg_delay"],
        per_task_finish=tuple(final["per_task_finish"]),
        knobs=best_knobs,
        evaluations=evals,
        history=history,
    )


def shared_plan_placement(
    net: ConvNetGeom,
    pool: CollabTopology,
    n_tasks: int,
    overlap_rows: int = 4,
) -> TaskPlacement:
    """The paper's §IV.B multi-task deployment on a physical pool: secondaries
    grouped **in pool order** into equal-size groups, every task running the
    **same equal-split plan geometry** (eq. 22's assumption that all tasks
    share one partition over one cluster).  ESs beyond
    ``n_tasks * (M // n_tasks)`` stay unused, exactly as a symmetric
    deployment would leave them.  This is the baseline per-task placement
    is measured against."""
    if n_tasks < 1:
        raise ValueError(f"need at least one task, got {n_tasks}")
    group_size = pool.n_secondaries // n_tasks
    if group_size < 2:
        raise ValueError(
            f"pool has {pool.n_secondaries} secondaries; the shared-plan "
            f"baseline needs >= 2 per task for {n_tasks} tasks"
        )
    ratios = tuple(1.0 / group_size for _ in range(group_size))
    assignments = tuple(
        tuple(pool.secondaries[t * group_size : (t + 1) * group_size])
        for t in range(n_tasks)
    )
    plans = tuple(
        plan_halp_topology(
            net, pool.sub_topology(group), overlap_rows=overlap_rows, ratios=ratios
        )
        for group in assignments
    )
    return TaskPlacement(pool=pool, assignments=assignments, plans=plans)


class PlacementController(ReplanController):
    """Channel-adaptive *placement*: on every adopted bucket switch, re-place
    all tasks over the pool instead of re-optimising one shared plan.

    Inherits the full :class:`~repro_torch.core.replan.ReplanController` loop --
    EWMA per-link estimates over the pool's 2M host<->secondary links, EWMA
    per-ES compute estimates over all M+1 ESs (``observe_compute``),
    geometric rate buckets with shared hysteresis, LRU cache (namespaced via
    ``_cache_kind`` so both controller kinds can share a cache), telemetry --
    and swaps only the recompute step: a cache miss runs
    :func:`place_tasks` for ``config.n_tasks`` tasks against the
    bucket-representative rates and platforms.  A straggling ES therefore
    changes the *assignment* itself (capacity ranking, LPT balance, and the
    swap search all read the rebuilt ``eff_flops``), not just the row split
    within fixed groups.

    Serving integration: ``predicted_latency(b)`` tiles the active
    placement's plans over ``b`` tasks and runs the shared-pool DES -- tasks
    beyond ``config.n_tasks`` wrap onto the same physical secondaries, so the
    prediction includes the queueing a too-large batch would suffer.  Hand it
    to :func:`~repro_torch.runtime.serve.plan_aware_batch_size` unchanged, and wire
    ``observe_batch_latency`` as the serving engine's observer just like the
    plan controller."""

    _cache_kind = "placement"

    def __init__(
        self,
        net: ConvNetGeom,
        pool: CollabTopology,
        config: ReplanConfig = ReplanConfig(),
        cache=None,
        placement_options: dict | None = None,
        store=None,
    ):
        self.placement_options = dict(placement_options or {})
        super().__init__(net, pool, config=config, cache=cache, store=store)

    def _optimize(self, topology: CollabTopology) -> PlacementResult:
        return place_tasks(
            self.net, topology, self.config.n_tasks, **self.placement_options
        )

    # -- placement protocol ---------------------------------------------------

    def placement_for_epoch(self) -> TaskPlacement:
        """One control epoch: hysteresis step, then the (cached) placement."""
        self.step()
        return self.current().placement

    @property
    def placement(self) -> TaskPlacement:
        return self._active_result().placement

    def plan_for_epoch(self) -> HALPPlan:
        raise TypeError(
            "a PlacementController serves one plan per task, not one shared "
            "plan; use placement_for_epoch() / .placement"
        )

    @property
    def plan(self) -> HALPPlan:
        raise TypeError(
            "a PlacementController serves one plan per task, not one shared "
            "plan; use .placement (or .placement.plans[task])"
        )

    # -- serving integration --------------------------------------------------

    def _price_batch(self, batch_size: int) -> float:
        placement = self._active_result().placement
        plans = [placement.plans[t % placement.n_tasks] for t in range(batch_size)]
        sim = Sim()
        heads = build_multitask_dag(sim, plans, self.estimated_topology())
        sim.run()
        return max(sim.finish_of(h) for h in heads)
