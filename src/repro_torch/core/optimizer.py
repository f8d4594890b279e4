"""Latency-minimising search over HALP plan knobs (segment ratios, overlap;
the port's copy of ``repro/core/optimizer.py``, plain Python).

The paper fixes the partition a priori (equal halves, a 4-row zone); on a
heterogeneous cluster that leaves latency on the table -- a fast secondary
should own more rows (DistrEdge, arXiv 2202.01699) and the optimal overlap
width trades host work against host->secondary boundary traffic.  This module
searches those knobs directly against the discrete-event simulator (the ground
truth the paper's recursion approximates):

* decision variables: the N secondary segment ratios (a simplex point) and the
  overlap-zone width in output rows,
* objective: the simulated makespan of ``n_tasks`` concurrent tasks on the
  given :class:`~repro_torch.core.topology.CollabTopology`,
* method: steepest coordinate descent on the ratio simplex (move mass onto one
  secondary at a time, renormalise) joined with the overlap choices, with
  step-size halving -- the objective is piecewise constant in the ratios
  (segments are integer rows), so gradient-free moves with a shrinking step
  are the right tool.  Each round's whole perturbation neighbourhood
  (2N ratio moves + |W|-1 overlap switches) is priced as **one batched DES
  call** (:class:`~repro_torch.core.events.HalpBatchEvaluator`: plan layouts +
  cached DAG templates + ``Sim.run_batch``), with a ``(ratios, overlap)``
  memo so renormalisation collisions and revisited operating points are never
  re-priced.  ``engine="scalar"`` keeps the one-candidate-at-a-time pricing
  path (plan build + DAG build + scalar DES per candidate) callable: the two
  engines share the search loop and their scores are bit-identical, so they
  return the same plan -- the scalar engine exists as the baseline the
  batched engine is held and timed against.

Infeasible candidates (a plan whose messages would skip a slot, or more slots
than rows) are rejected by the partitioner's invariant checks and priced +inf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

from .events import HalpBatchEvaluator, SchemeBatchEvaluator, simulate_scheme
from .nets import ConvNetGeom
from .partition import (
    HALPPlan,
    SCHEME_HALO,
    SchemePlan,
    plan_halp_topology,
    plan_scheme,
    stage_scheme_options,
    stage_spans,
)
from .simulator import simulate_halp
from .topology import CollabTopology

__all__ = [
    "OptimizeResult",
    "optimize_plan",
    "evaluate_plan",
    "evaluate_scheme_assignment",
    "equal_ratios",
]


@dataclass
class OptimizeResult:
    ratios: tuple[float, ...]
    overlap_rows: int
    makespan: float
    plan: "HALPPlan | SchemePlan"
    evaluations: int
    history: list[tuple] = field(default_factory=list)
    # Per-stage scheme assignment of the winning plan; None for halo-only
    # searches (the legacy path, whose plans stay bit-identical plan_halp_n
    # output).  History entries are (ratios, overlap, score) on the legacy
    # path and (ratios, overlap, assignment, score) on the joint path.
    schemes: tuple[str, ...] | None = None


def equal_ratios(topology: CollabTopology) -> tuple[float, ...]:
    """The naive capacity-blind split (the paper's default)."""
    n = topology.n_secondaries
    return tuple(1.0 / n for _ in range(n))


def _verify_plan(plan, context: str) -> None:
    """Opt-in static verification gate (``verify=True``): raises
    :class:`repro_torch.analysis.AnalysisError` naming every violated invariant."""
    from ..analysis import check_plan

    check_plan(plan).raise_if_failed(context)


def evaluate_plan(
    net: ConvNetGeom,
    topology: CollabTopology,
    ratios: Sequence[float],
    overlap_rows: int,
    n_tasks: int = 1,
    auto_reduce: bool = True,
) -> float:
    """Simulated makespan of one candidate; +inf if the plan is infeasible.

    ``auto_reduce=False`` restricts the search to strictly-isolating plans
    (no per-layer secondary reduction); thin layers then price +inf."""
    try:
        plan = plan_halp_topology(
            net, topology, overlap_rows=overlap_rows, ratios=ratios,
            auto_reduce=auto_reduce,
        )
        return simulate_halp(net, topology=topology, n_tasks=n_tasks, plan=plan)["total"]
    except (AssertionError, ValueError):
        return float("inf")


def evaluate_scheme_assignment(
    net: ConvNetGeom,
    topology: CollabTopology,
    ratios: Sequence[float],
    overlap_rows: int,
    assignment: Sequence[str],
    n_tasks: int = 1,
    auto_reduce: bool = True,
) -> float:
    """Simulated makespan of one (ratios, overlap, scheme-assignment) candidate.

    The scheme-search analogue of :func:`evaluate_plan`: prices a mixed-scheme
    plan through the scheme DAG (one rate-independent DES sweep) and returns
    +inf when the candidate is infeasible (e.g. a halo stage whose segments
    cannot isolate, or a scheme invalid for a stage's layer kinds)."""
    try:
        return simulate_scheme(
            net,
            topology,
            ratios=tuple(ratios),
            overlap_rows=overlap_rows,
            assignment=tuple(assignment),
            n_tasks=n_tasks,
            auto_reduce=auto_reduce,
        )["total"]
    except (AssertionError, ValueError):
        return float("inf")


def optimize_plan(
    net: ConvNetGeom,
    topology: CollabTopology,
    n_tasks: int = 1,
    overlap_choices: Sequence[int] = (2, 4, 6, 8),
    init_ratios: Sequence[float] | None = None,
    step: float = 0.08,
    min_step: float = 0.005,
    min_ratio: float = 0.02,
    max_rounds: int = 12,
    objective: Callable[[tuple[float, ...], int], float] | None = None,
    auto_reduce: bool = True,
    engine: str = "batched",
    eval_budget: int | None = None,
    tol: float = 0.0,
    schemes: Sequence[str] = (SCHEME_HALO,),
    verify: bool = False,
) -> OptimizeResult:
    """Steepest coordinate-descent search for the fastest (ratios, overlap).

    Starts from the topology's capacity-weighted ratios (or ``init_ratios``)
    and the best of ``overlap_choices`` there, then per round prices the whole
    perturbation neighbourhood -- mass on/off each secondary at the current
    ``step`` plus every other overlap width -- and moves to the best strictly
    improving candidate, halving the step when none improves.  Terminates when
    the step falls below ``min_step``, after ``max_rounds`` rounds, when a
    round's improvement falls below ``tol`` (early exit -- lets controllers
    trade tail latency for plan quality), or when ``eval_budget`` priced
    evaluations have been spent (the hard cap on worst-case replan latency;
    ``max_rounds``/``min_step`` alone only bound the round *count*).

    ``engine="batched"`` (default) prices each neighbourhood as one
    :class:`~repro_torch.core.events.HalpBatchEvaluator` sweep and memoises scores
    by ``(ratios, overlap)`` so duplicate renormalised candidates are never
    re-priced; ``engine="scalar"`` prices candidates one at a time through
    :func:`evaluate_plan` (the pre-template path, kept callable as the
    benchmark baseline).  Both engines share this search loop and produce
    bit-identical scores, hence identical plans -- including under an
    ``eval_budget``, where the batched engine prices lazily (no speculative
    prefetch) so the budget cuts at the same candidate on both engines.

    ``objective`` may replace the default simulated-makespan objective (e.g.
    to optimise the closed form instead, or average delay for multi-task);
    the batched DES fast path then does not apply, but the memo still does.

    ``schemes`` is the per-stage partitioning-scheme vocabulary.  The default
    halo-only vocabulary on an attention-free net keeps the legacy search
    (bit-identical trajectory, plans, and ``history`` shape).  Any larger
    vocabulary -- or any net with attention layers, which halo segments cannot
    split -- routes to the *joint* (scheme-per-stage, ratios, overlap) search:
    the same speculative cyclic-descent skeleton with a scheme-flip pass per
    round, memoised by ``(ratios, overlap, assignment)`` and priced through
    the scheme DAG (:class:`~repro_torch.core.events.SchemeBatchEvaluator`).  A
    custom ``objective`` is incompatible with the joint space (its signature
    has no assignment argument) and raises ``ValueError`` there.

    ``verify=True`` runs the static verifier
    (:func:`repro_torch.analysis.check_plan`) on the winning plan before returning
    and raises :class:`repro_torch.analysis.AnalysisError` on any finding -- an
    opt-in guard for callers that ship plans to remote executors."""
    if engine not in ("batched", "scalar"):
        raise ValueError(f"engine must be 'batched' or 'scalar', got {engine!r}")
    if eval_budget is not None and eval_budget < 1:
        raise ValueError(f"eval_budget must be >= 1, got {eval_budget}")
    schemes = tuple(schemes)
    if schemes != (SCHEME_HALO,) or any(g.kind == "attn" for g in net.layers):
        if objective is not None:
            raise ValueError(
                "a custom objective is halo-only: the joint scheme search "
                "prices (ratios, overlap, assignment) candidates through the "
                "scheme DAG and cannot route them to an (ratios, overlap) "
                "objective; drop `objective` or use schemes=(SCHEME_HALO,)"
            )
        result = _optimize_scheme_plan(
            net,
            topology,
            schemes=schemes,
            n_tasks=n_tasks,
            overlap_choices=overlap_choices,
            init_ratios=init_ratios,
            step=step,
            min_step=min_step,
            min_ratio=min_ratio,
            max_rounds=max_rounds,
            auto_reduce=auto_reduce,
            engine=engine,
            eval_budget=eval_budget,
            tol=tol,
        )
        if verify:
            _verify_plan(result.plan, "optimize_plan")
        return result
    evals = 0
    history: list[tuple[tuple[float, ...], int, float]] = []
    batched = engine == "batched"
    evaluator = (
        HalpBatchEvaluator(net, topology, n_tasks=n_tasks, auto_reduce=auto_reduce)
        if batched and objective is None
        else None
    )

    def default_objective(ratios: tuple[float, ...], w: int) -> float:
        return evaluate_plan(
            net, topology, ratios, w, n_tasks=n_tasks, auto_reduce=auto_reduce
        )

    fn = objective or default_objective
    # Scores memo: the batched engine always consults it; the scalar engine
    # normally keeps the historical price-every-candidate behaviour (the cost
    # profile the benchmark compares against) -- scores are bit-identical
    # either way, so the unbudgeted trajectory cannot differ.  Under an
    # eval_budget BOTH engines memoise: re-priced duplicates would otherwise
    # consume the scalar engine's budget at different candidates than the
    # batched engine's, and the budget cut-off must land identically for the
    # engines to return the same plan.
    use_memo = batched or eval_budget is not None
    memo: dict[tuple[tuple[float, ...], int], float] = {}

    def price_all(cands: list[tuple[tuple[float, ...], int]]) -> list[float]:
        nonlocal evals
        out: list[float | None] = [None] * len(cands)
        if use_memo:
            for k, c in enumerate(cands):
                if c in memo:
                    out[k] = memo[c]
        fresh = [(k, c) for k, c in enumerate(cands) if out[k] is None]
        if eval_budget is not None:
            fresh = fresh[: max(0, eval_budget - evals)]
        if fresh:
            if evaluator is not None:
                scores = evaluator.evaluate([c for _, c in fresh])
            else:
                scores = [fn(r, w) for _, (r, w) in fresh]
            evals += len(fresh)
            for (k, c), v in zip(fresh, scores):
                memo[c] = v
                out[k] = v
                history.append((c[0], c[1], v))
        # candidates beyond an exhausted budget stay unpriced: +inf keeps them
        # unselectable without spending evaluations on them
        return [v if v is not None else float("inf") for v in out]

    def renorm(raw: Sequence[float]) -> tuple[float, ...]:
        clipped = [max(min_ratio, r) for r in raw]
        total = sum(clipped)
        return tuple(r / total for r in clipped)

    ratios = renorm(init_ratios or topology.capacity_ratios())
    n = len(ratios)
    scan = [(ratios, w) for w in overlap_choices]
    scores = price_all(scan)
    best = float("inf")
    best_w = overlap_choices[0]
    for (_, w), v in zip(scan, scores):
        if v < best:
            best, best_w = v, w

    moves = [(j, sign) for j in range(n) for sign in (1.0, -1.0)]
    # Speculative neighbourhood prefetch spends evaluations on candidates the
    # acceptance scan may never reach (a mid-scan accept shifts the base), so
    # under an eval_budget it would cut the budget at *different* candidates
    # than the scalar engine's lazy acceptance-order pricing -- breaking the
    # identical-plans guarantee the replan cache keying relies on.  Budgeted
    # searches therefore price lazily on both engines (the batched evaluator
    # and the memo still apply, per candidate).
    speculate = evaluator is not None and eval_budget is None

    def perturbed(base: tuple[float, ...], j: int, sign: float) -> tuple[float, ...]:
        raw = list(base)
        raw[j] = max(min_ratio, raw[j] + sign * step)
        return renorm(raw)

    rounds = 0
    converged = False
    while step >= min_step and rounds < max_rounds and not converged:
        if eval_budget is not None and evals >= eval_budget:
            break
        rounds += 1
        improved = False
        round_start = best
        # The acceptance order is the classic cyclic pass (identical plans to
        # the sequential optimizer); batching happens *speculatively*: the
        # whole remaining neighbourhood of the current base is priced in one
        # sweep, so the sequential scan below is all memo hits until an
        # accepted move shifts the base -- at which point the remainder is
        # re-batched from the new base.
        if speculate:
            price_all(
                [(c, best_w) for jj, ss in moves if (c := perturbed(ratios, jj, ss)) != ratios]
            )
        for idx, (j, sign) in enumerate(moves):
            cand = perturbed(ratios, j, sign)
            if cand == ratios:
                continue
            v = price_all([(cand, best_w)])[0]
            if v < best:
                best, ratios, improved = v, cand, True
                if speculate:
                    price_all(
                        [
                            (c, best_w)
                            for jj, ss in moves[idx + 1 :]
                            if (c := perturbed(ratios, jj, ss)) != ratios
                        ]
                    )
        if speculate:
            price_all([(ratios, w) for w in overlap_choices if w != best_w])
        for w in overlap_choices:
            if w == best_w:
                continue
            v = price_all([(ratios, w)])[0]
            if v < best:
                best, best_w, improved = v, w, True
        if not improved:
            step *= 0.5
        elif math.isfinite(best) and round_start - best < tol:
            converged = True  # tol early-exit: bound the controller's tail
    if not math.isfinite(best):
        raise ValueError(
            f"no feasible HALP plan for {topology.n_secondaries} secondaries on "
            f"{net.name} over overlap choices {tuple(overlap_choices)}; use fewer "
            f"secondaries or a larger input"
        )
    plan = plan_halp_topology(
        net, topology, overlap_rows=best_w, ratios=ratios, auto_reduce=auto_reduce
    )
    if verify:
        _verify_plan(plan, "optimize_plan")
    return OptimizeResult(
        ratios=ratios,
        overlap_rows=best_w,
        makespan=best,
        plan=plan,
        evaluations=evals,
        history=history,
    )


def _optimize_scheme_plan(
    net: ConvNetGeom,
    topology: CollabTopology,
    schemes: tuple[str, ...],
    n_tasks: int,
    overlap_choices: Sequence[int],
    init_ratios: Sequence[float] | None,
    step: float,
    min_step: float,
    min_ratio: float,
    max_rounds: int,
    auto_reduce: bool,
    engine: str,
    eval_budget: int | None,
    tol: float,
) -> OptimizeResult:
    """Joint (scheme-per-stage, ratios, overlap) coordinate descent.

    Same skeleton as the legacy halo-only loop -- initial overlap scan, cyclic
    ratio moves with speculative neighbourhood prefetch, step halving -- with a
    scheme-flip pass inserted between the ratio and overlap passes: each stage
    tries every alternative scheme from its vocabulary at the current
    (ratios, overlap), accepting strict improvements cyclically.  Candidates
    are memoised by the full ``(ratios, overlap, assignment)`` triple so a
    flip that returns to an already-priced operating point is free; the
    batched engine prices each neighbourhood as one
    :class:`~repro_torch.core.events.SchemeBatchEvaluator` sweep, and budget
    semantics mirror the legacy loop (lazy pricing when budgeted, so both
    engines cut at the same candidate).
    """
    evals = 0
    history: list[tuple] = []
    batched = engine == "batched"
    evaluator = (
        SchemeBatchEvaluator(net, topology, n_tasks=n_tasks, auto_reduce=auto_reduce)
        if batched
        else None
    )
    spans = stage_spans(net)
    options = [stage_scheme_options(net, sp, schemes) for sp in spans]
    assignment: tuple[str, ...] = tuple(opts[0] for opts in options)

    use_memo = batched or eval_budget is not None
    memo: dict[tuple[tuple[float, ...], int, tuple[str, ...]], float] = {}

    def price_all(
        cands: list[tuple[tuple[float, ...], int, tuple[str, ...]]]
    ) -> list[float]:
        nonlocal evals
        out: list[float | None] = [None] * len(cands)
        if use_memo:
            for k, c in enumerate(cands):
                if c in memo:
                    out[k] = memo[c]
        fresh = [(k, c) for k, c in enumerate(cands) if out[k] is None]
        if eval_budget is not None:
            fresh = fresh[: max(0, eval_budget - evals)]
        if fresh:
            if evaluator is not None:
                scores = evaluator.evaluate([c for _, c in fresh])
            else:
                scores = [
                    evaluate_scheme_assignment(
                        net, topology, r, w, a, n_tasks=n_tasks, auto_reduce=auto_reduce
                    )
                    for _, (r, w, a) in fresh
                ]
            evals += len(fresh)
            for (k, c), v in zip(fresh, scores):
                memo[c] = v
                out[k] = v
                history.append((c[0], c[1], c[2], v))
        return [v if v is not None else float("inf") for v in out]

    def renorm(raw: Sequence[float]) -> tuple[float, ...]:
        clipped = [max(min_ratio, r) for r in raw]
        total = sum(clipped)
        return tuple(r / total for r in clipped)

    ratios = renorm(init_ratios or topology.capacity_ratios())
    n = len(ratios)
    scan = [(ratios, w, assignment) for w in overlap_choices]
    scores = price_all(scan)
    best = float("inf")
    best_w = overlap_choices[0]
    for (_, w, _a), v in zip(scan, scores):
        if v < best:
            best, best_w = v, w

    moves = [(j, sign) for j in range(n) for sign in (1.0, -1.0)]
    flips = [(si, alt) for si, opts in enumerate(options) for alt in opts]
    speculate = evaluator is not None and eval_budget is None

    def perturbed(base: tuple[float, ...], j: int, sign: float) -> tuple[float, ...]:
        raw = list(base)
        raw[j] = max(min_ratio, raw[j] + sign * step)
        return renorm(raw)

    def flipped(
        base: tuple[str, ...], si: int, alt: str
    ) -> tuple[str, ...]:
        return base[:si] + (alt,) + base[si + 1 :]

    rounds = 0
    converged = False
    while step >= min_step and rounds < max_rounds and not converged:
        if eval_budget is not None and evals >= eval_budget:
            break
        rounds += 1
        improved = False
        round_start = best
        # --- ratio pass (cyclic accepts; speculative re-batch on accept) ---
        if speculate:
            price_all(
                [
                    (c, best_w, assignment)
                    for jj, ss in moves
                    if (c := perturbed(ratios, jj, ss)) != ratios
                ]
            )
        for idx, (j, sign) in enumerate(moves):
            cand = perturbed(ratios, j, sign)
            if cand == ratios:
                continue
            v = price_all([(cand, best_w, assignment)])[0]
            if v < best:
                best, ratios, improved = v, cand, True
                if speculate:
                    price_all(
                        [
                            (c, best_w, assignment)
                            for jj, ss in moves[idx + 1 :]
                            if (c := perturbed(ratios, jj, ss)) != ratios
                        ]
                    )
        # --- scheme-flip pass: one stage at a time over its vocabulary ---
        if speculate:
            price_all(
                [
                    (ratios, best_w, a)
                    for si, alt in flips
                    if (a := flipped(assignment, si, alt)) != assignment
                ]
            )
        for idx, (si, alt) in enumerate(flips):
            cand_a = flipped(assignment, si, alt)
            if cand_a == assignment:
                continue
            v = price_all([(ratios, best_w, cand_a)])[0]
            if v < best:
                best, assignment, improved = v, cand_a, True
                if speculate:
                    price_all(
                        [
                            (ratios, best_w, a)
                            for sj, a2 in flips[idx + 1 :]
                            if (a := flipped(assignment, sj, a2)) != assignment
                        ]
                    )
        # --- overlap pass ---
        if speculate:
            price_all(
                [(ratios, w, assignment) for w in overlap_choices if w != best_w]
            )
        for w in overlap_choices:
            if w == best_w:
                continue
            v = price_all([(ratios, w, assignment)])[0]
            if v < best:
                best, best_w, improved = v, w, True
        if not improved:
            step *= 0.5
        elif math.isfinite(best) and round_start - best < tol:
            converged = True
    if not math.isfinite(best):
        raise ValueError(
            f"no feasible plan for {topology.n_secondaries} secondaries on "
            f"{net.name} over schemes {schemes} and overlap choices "
            f"{tuple(overlap_choices)}; widen the vocabulary or use fewer "
            f"secondaries"
        )
    halo_only = all(a == SCHEME_HALO for a in assignment) and not any(
        g.kind == "attn" for g in net.layers
    )
    plan: HALPPlan | SchemePlan
    if halo_only:
        # All-halo winner on a halo-partitionable net: hand back the legacy
        # plan object so downstream executors/caches see bit-identical
        # plan_halp_n output regardless of which vocabulary was searched.
        plan = plan_halp_topology(
            net, topology, overlap_rows=best_w, ratios=ratios, auto_reduce=auto_reduce
        )
    else:
        plan = plan_scheme(
            net,
            topology,
            overlap_rows=best_w,
            ratios=ratios,
            assignment=assignment,
            schemes=schemes,
            auto_reduce=auto_reduce,
        )
    return OptimizeResult(
        ratios=ratios,
        overlap_rows=best_w,
        makespan=best,
        plan=plan,
        evaluations=evals,
        history=history,
        schemes=assignment,
    )
