"""Shared HALP event topology: one plan-walk feeding both latency engines
(the port's copy of ``repro/core/events.py``, plain Python and numpy).

The closed-form recursion (``repro_torch.core.schedule``) and the discrete-event
simulator (``repro_torch.core.simulator``) must price the *same* jobs and messages
or their cross-validation is meaningless.  Historically each engine re-derived
the message structure from the plan independently; this module centralises it:

* per-slot *dependent* rows (the boundary rows a secondary must compute first
  and ship to its adjacent host zones, paper eq. 16's t_cmp^dep),
* per-zone host chunks (rows each adjacent secondary is waiting for,
  eqs. 11-12 / 18), the initial image slices (eq. 10) and the final sub-output
  merge (eqs. 13-14), and
* :func:`build_halp_dag`, which lays the full job/message DAG onto any
  ``Sim``-compatible scheduler with per-ES platforms and per-link rates drawn
  from a :class:`~repro_torch.core.topology.CollabTopology`.

The closed form consumes the per-layer quantities; the simulator consumes the
DAG.  Both therefore see identical work and identical bytes by construction.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .nets import ConvNetGeom, DTYPE_BYTES
from .partition import (
    HALPPlan,
    PlanLayout,
    SCHEME_HALO,
    SCHEME_HOST,
    SCHEMES,
    SchemeLayout,
    Segment,
    plan_from_layout,
    plan_halp_topology,
    plan_layout,
    scheme_layout,
)
from .topology import CollabTopology

__all__ = [
    "SecStep",
    "ZoneStep",
    "init_bytes",
    "sec_step",
    "zone_step",
    "final_bytes",
    "resolve_halp_setup",
    "build_halp_dag",
    "build_multitask_dag",
    "build_scheme_dag",
    "DagTemplate",
    "HalpBatchEvaluator",
    "MultitaskBatchEvaluator",
    "SchemeBatchEvaluator",
    "simulate_scheme",
]


def resolve_halp_setup(
    net: ConvNetGeom,
    platform=None,
    link=None,
    overlap_rows: int | None = None,
    topology: CollabTopology | None = None,
    ratios=None,
    plan: HALPPlan | None = None,
    host_platform=None,
) -> tuple[CollabTopology, HALPPlan]:
    """Resolve the two calling conventions shared by both latency engines.

    Paper-style ``(platform, link)`` builds the symmetric two-secondary
    topology with the paper's equal split; topology-style takes an explicit
    :class:`CollabTopology` (capacity-weighted ratios by default).  Conflicting
    combinations raise ``TypeError`` instead of silently ignoring arguments."""
    if plan is not None and (ratios is not None or overlap_rows is not None):
        raise TypeError(
            "plan= already fixes the partition; do not also pass "
            "ratios/overlap_rows (they would be silently ignored)"
        )
    if topology is None:
        if platform is None or link is None:
            raise TypeError("pass either (platform, link) or topology=")
        topology = CollabTopology.symmetric(platform, link, host_platform=host_platform)
        if ratios is None:
            ratios = (0.5, 0.5)  # the paper's equal split, not capacity-weighted
    elif platform is not None or link is not None or host_platform is not None:
        raise TypeError(
            "topology= already carries platforms and links; do not also pass "
            "platform/link/host_platform (they would be silently ignored)"
        )
    if plan is None:
        plan = plan_halp_topology(
            net, topology, overlap_rows=4 if overlap_rows is None else overlap_rows,
            ratios=ratios,
        )
    return topology, plan


def init_bytes(plan: HALPPlan, sec_slot: str) -> float:
    """Eq. (10): bytes of the initial image slice sent to a secondary ES."""
    net = plan.net
    seg = plan.parts[0].inp[sec_slot]
    return DTYPE_BYTES * seg.rows * net.in_rows * net.in_channels


def final_bytes(plan: HALPPlan, sec_slot: str) -> float:
    """Eqs. (13)-(14): the g_N sub-output a secondary ships for the head merge."""
    return plan.message_bytes(len(plan.parts) - 1, sec_slot, plan.host)


@dataclass(frozen=True)
class SecStep:
    """One secondary slot's work at one layer."""

    slot: str
    own_rows: int
    dep_rows: int  # boundary rows computed first (sum over adjacent zones)
    sends: tuple[tuple[str, Segment, float], ...]  # (zone, rows, bytes) to host


@dataclass(frozen=True)
class ZoneStep:
    """One host zone's work at one layer: a chunk per adjacent secondary."""

    slot: str
    zone_rows: int
    above: str  # secondary above the zone (its rows are computed first)
    below: str
    rows_for_above: int
    rows_for_below: int
    bytes_to_above: float
    bytes_to_below: float


def _union_rows(segs: list[Segment]) -> int:
    """Distinct rows covered by possibly-overlapping segments (a 1-row middle
    secondary can owe the *same* row to both adjacent zones; it computes it
    once)."""
    rows = 0
    cur_hi = 0
    for seg in sorted((s for s in segs if s), key=lambda s: s.lo):
        lo = max(seg.lo, cur_hi + 1)
        if seg.hi >= lo:
            rows += seg.hi - lo + 1
            cur_hi = seg.hi
    return rows


def sec_step(plan: HALPPlan, layer: int, slot: str) -> SecStep:
    own = plan.parts[layer].out[slot]
    if layer + 1 >= len(plan.parts):
        # g_N: the whole sub-output is the boundary (eqs. 13-14).  The seed
        # convention -- kept for every N so cross-N accounting is uniform --
        # prices this send here AND in the final merge; the nominal zone key
        # is inert (no next layer to gate).
        zones = plan.adjacent_zones(slot)
        sends = (
            ((zones[0], own, plan.message_bytes(layer, slot, plan.host)),)
            if own and zones
            else ()
        )
        return SecStep(slot=slot, own_rows=own.rows, dep_rows=own.rows, sends=sends)
    # Adjacent zones are always listed (an empty send still orders the zone's
    # chunk behind the secondary's dep compute); non-adjacent zones appear
    # only when auto-reduced plans route rows into a widened host tail zone
    # (a direct uplink -- the no-secondary-exchange invariant is untouched).
    adjacent = plan.adjacent_zones(slot)
    targets = [*adjacent] + [
        z for z in plan.zone_slots if z not in adjacent and plan.message(layer, slot, z)
    ]
    sends = []
    for z in targets:
        seg = plan.message(layer, slot, z)
        sends.append((z, seg, plan.message_bytes(layer, slot, z)))
    return SecStep(
        slot=slot,
        own_rows=own.rows,
        dep_rows=min(own.rows, _union_rows([seg for _, seg, _ in sends])),
        sends=tuple(sends),
    )


def zone_step(plan: HALPPlan, layer: int, slot: str) -> ZoneStep:
    above, below = plan.adjacent_secondaries(slot)
    m_above = plan.message(layer, slot, above)
    return ZoneStep(
        slot=slot,
        zone_rows=plan.parts[layer].out[slot].rows,
        above=above,
        below=below,
        rows_for_above=m_above.rows,
        rows_for_below=plan.message(layer, slot, below).rows,
        bytes_to_above=plan.message_bytes(layer, slot, above),
        bytes_to_below=plan.message_bytes(layer, slot, below),
    )


def _row_flops(net: ConvNetGeom) -> list[float]:
    """Per-layer FLOPs per output row, hoisted once per DAG build (``sizes()``
    is O(layers), so calling it per job would be quadratic)."""
    sizes = net.sizes()
    return [g.flops_per_out_row(sizes[i + 1]) for i, g in enumerate(net.layers)]


def build_halp_dag(sim, plans: list[HALPPlan], topology: CollabTopology) -> list[int]:
    """Lay the full HALP job/message DAG for ``len(plans)`` concurrent tasks.

    Resources: the host ES name (host compute), ``{slot}^{t}`` (secondary
    compute, one instance per task), ``link:a->b`` (directed point-to-point
    links, full duplex).  The host serves the per-task zones in task order
    within each layer (paper §IV.B).  Returns the head job id of every task.

    This is the paper's §IV.B deployment: every task runs the *same* plan on
    its own clone of the secondary group (N x n_tasks distinct secondaries),
    so secondary resources are suffixed per task.  For *physically shared*
    secondaries with per-task plans, see :func:`build_multitask_dag`.
    """
    return _lay_halp_dag(sim, plans, topology, lambda t, s: f"{s}^{t}")


def build_multitask_dag(sim, plans: list[HALPPlan], topology: CollabTopology) -> list[int]:
    """Lay the job/message DAG for ``len(plans)`` tasks on ONE physical pool.

    Unlike :func:`build_halp_dag` (per-task secondary clones), every plan's
    slot names here are *physical* ES names of ``topology``: two tasks that
    name the same secondary contend for it (FIFO), all tasks contend for the
    host, and a directed link ``link:a->b`` is one resource no matter how
    many tasks route over it.  This is the engine behind per-task
    heterogeneous placement (the JAX package's ``core/placement.py``): tasks
    may carry different plans over different sub-topologies, and shared host/link
    contention falls out of the resource naming rather than being modelled
    separately.  Returns the head job id of every task."""
    if not plans:
        raise ValueError("need at least one task plan")
    net = plans[0].net
    host = plans[0].host
    for t, plan in enumerate(plans):
        if plan.net != net:
            raise ValueError(f"task {t}: all tasks must share one network geometry")
        if plan.host != host:
            raise ValueError(f"task {t}: host {plan.host!r} != task 0 host {host!r}")
        for s in plan.secondary_slots:
            if s not in topology.platforms:
                raise ValueError(f"task {t}: secondary {s!r} not in the topology pool")
    return _lay_halp_dag(sim, plans, topology, lambda t, s: s)


class _FloatPricer:
    """Default job pricing: exact floats, bit-identical to the historical
    inline pricing (``(num * rows) / den`` with integer-valued ``num * rows``
    products, so factorising the numerator out cannot change a single bit).

    ``num_cmp[i]`` is layer i's FLOPs per output row, ``num_msg[i]`` the
    *bits* per boundary row of layer i's output (8 x eq. 11's bytes-per-row),
    ``num_init`` the bits per input-image row slice (eq. 10) and ``num_head``
    the head FLOPs -- these are the template's duration *lanes*: every job
    duration is one of these numerators times a row count over a rate."""

    def __init__(self, net: ConvNetGeom, topology: CollabTopology | None):
        self.topology = topology
        self.num_cmp = _row_flops(net)
        sizes = net.sizes()
        self.num_msg = [
            8.0 * DTYPE_BYTES * sizes[i + 1] * g.c_out for i, g in enumerate(net.layers)
        ]
        self.num_init = 8.0 * DTYPE_BYTES * net.in_rows * net.in_channels
        self.num_head = net.head_flops

    def cmp(self, es: str, num: float, rows: float) -> float:
        return (num * rows) / self.topology.platform_of(es).eff_flops

    def com(self, src: str, dst: str, num: float, rows: float) -> float:
        return (num * rows) / self.topology.link_between(src, dst).rate_bps


class _RecordingPricer(_FloatPricer):
    """Prices like :class:`_FloatPricer` while recording each job's duration
    factorisation ``(numerator, rate-kind)`` in call order -- one record per
    ``sim.add`` (the builder prices every job exactly once, as its argument).
    The row counts themselves are *not* recorded: they are the per-candidate
    parameters a :class:`DagTemplate` fills in from plan layouts."""

    def __init__(self, net: ConvNetGeom, topology: CollabTopology):
        super().__init__(net, topology)
        self.nums: list[float] = []
        self.den_kinds: list[tuple] = []
        self.den_index: dict[tuple, int] = {}
        self.den_ids: list[int] = []

    def _record(self, num: float, kind: tuple) -> None:
        idx = self.den_index.get(kind)
        if idx is None:
            idx = self.den_index[kind] = len(self.den_kinds)
            self.den_kinds.append(kind)
        self.nums.append(num)
        self.den_ids.append(idx)

    def cmp(self, es: str, num: float, rows: float) -> float:
        self._record(num, ("es", es))
        return super().cmp(es, num, rows)

    def com(self, src: str, dst: str, num: float, rows: float) -> float:
        self._record(num, ("link", src, dst))
        return super().com(src, dst, num, rows)


def _lay_halp_dag(
    sim, plans: list[HALPPlan], topology: CollabTopology, sec_res, pricer=None,
    roots: Sequence[int | None] | None = None,
) -> list[int]:
    """Shared DAG builder behind both multi-task deployments.

    ``sec_res(task, slot)`` names the compute resource of a secondary slot
    (and its link endpoints).  Per layer, each secondary computes its
    dependent boundary rows first and ships them to the host zones that need
    them while computing the rest (eq. 16); the host computes each zone's
    rows-for-above chunk, sends it, then the rest, then sends below
    (eq. 18) -- a zone's chunks gate on the boundary messages it consumes
    from the previous layer.

    ``pricer`` turns (numerator lane, row count, resource) into a job
    duration; the default prices exact floats, a :class:`_RecordingPricer`
    additionally captures the factorisation for :class:`DagTemplate`.

    ``roots`` optionally gates each task's entry (initial slices and the
    host's first zone chunk) on an existing job -- mixed-scheme plans use
    this to chain a halo segment behind the previous segment's barrier.  The
    default (all None) is structurally identical to no gate (:meth:`Sim.add`
    drops None deps), so standalone builds are untouched bit-for-bit.
    """
    net = plans[0].net
    host = plans[0].host
    n_layers = len(net.layers)
    pr = pricer if pricer is not None else _FloatPricer(net, topology)
    num_cmp, num_msg = pr.num_cmp, pr.num_msg
    if roots is None:
        roots = [None] * len(plans)

    # Clone deployments pass the *same* plan object once per task; memoise the
    # step walks per distinct plan so n_tasks cost only one plan-walk each.
    step_cache: dict[tuple[int, int, str], SecStep | ZoneStep] = {}

    def sec_step_of(plan: HALPPlan, i: int, s: str) -> SecStep:
        key = (id(plan), i, s)
        step = step_cache.get(key)
        if step is None:
            step = step_cache[key] = sec_step(plan, i, s)
        return step

    def zone_step_of(plan: HALPPlan, i: int, z: str) -> ZoneStep:
        key = (id(plan), i, z)
        step = step_cache.get(key)
        if step is None:
            step = step_cache[key] = zone_step(plan, i, z)
        return step

    last_chunk: dict[tuple[int, str], int | None] = {}
    # (task, sec_slot, layer) -> message jobs the secondary needs before layer
    sec_gate: dict[tuple[int, str, int], list[int]] = {}
    # (task, layer, zone_slot) -> {src_sec: boundary message gating the zone}
    zone_in: dict[tuple[int, int, str], dict[str, int]] = {}

    # initial image distribution host -> secondaries (eq. 10)
    for t, plan in enumerate(plans):
        for s in plan.secondary_slots:
            jid = sim.add(
                f"int[{t}]{s}",
                f"link:{host}->{sec_res(t, s)}",
                pr.com(host, s, pr.num_init, plan.parts[0].inp[s].rows),
                [roots[t]],
            )
            sec_gate[(t, s, 0)] = [jid]
        if roots[t] is not None:
            last_chunk[(t, host)] = roots[t]

    for i in range(n_layers):
        # --- secondaries: dep chunk first, then rest; send dep while resting.
        for t, plan in enumerate(plans):
            for s in plan.secondary_slots:
                step = sec_step_of(plan, i, s)
                deps = [last_chunk.get((t, s))] + sec_gate.get((t, s, i), [])
                a = sim.add(
                    f"cmp[{t}]{s}.g{i}.dep",
                    sec_res(t, s),
                    pr.cmp(s, num_cmp[i], step.dep_rows),
                    deps,
                )
                for z, seg, _nbytes in step.sends:
                    m = sim.add(
                        f"msg[{t}]{s}->{host}.g{i}",
                        f"link:{sec_res(t, s)}->{host}",
                        pr.com(s, host, num_msg[i], seg.rows),
                        [a],
                    )
                    if i + 1 < n_layers:
                        zone_in.setdefault((t, i + 1, z), {})[s] = m
                b = sim.add(
                    f"cmp[{t}]{s}.g{i}.rest",
                    sec_res(t, s),
                    pr.cmp(s, num_cmp[i], step.own_rows - step.dep_rows),
                    [a],
                )
                last_chunk[(t, s)] = b
        # --- host: per task, zones in row order: chunk for the secondary above,
        # send; chunk the rest (gated on the below secondary's rows), send below.
        for t, plan in enumerate(plans):
            for z in plan.zone_slots:
                step = zone_step_of(plan, i, z)
                gates = zone_in.get((t, i, z), {})
                a = sim.add(
                    f"cmp[{t}]{z}.g{i}.for_{step.above}",
                    host,
                    pr.cmp(host, num_cmp[i], step.rows_for_above),
                    [last_chunk.get((t, host)), gates.get(step.above)],
                )
                s1 = sim.add(
                    f"msg[{t}]{z}->{step.above}.g{i}",
                    f"link:{host}->{sec_res(t, step.above)}",
                    pr.com(host, step.above, num_msg[i], step.rows_for_above),
                    [a],
                )
                b = sim.add(
                    f"cmp[{t}]{z}.g{i}.rest",
                    host,
                    pr.cmp(host, num_cmp[i], step.zone_rows - step.rows_for_above),
                    # the rest chunk consumes every other boundary message the
                    # zone received (positionally below, plus -- in reduced
                    # plans -- any dropped secondary routing into a tail zone)
                    [a] + [m for src, m in gates.items() if src != step.above],
                )
                s2 = sim.add(
                    f"msg[{t}]{z}->{step.below}.g{i}",
                    f"link:{host}->{sec_res(t, step.below)}",
                    pr.com(host, step.below, num_msg[i], step.rows_for_below),
                    [b],
                )
                last_chunk[(t, host)] = b
                if i + 1 < n_layers:
                    sec_gate.setdefault((t, step.above, i + 1), []).append(s1)
                    sec_gate.setdefault((t, step.below, i + 1), []).append(s2)
                # NOTE: zone rows stay on the host -- no job for the local move.

    # final merge: secondaries ship their g_N sub-outputs; host runs the head.
    heads = []
    for t, plan in enumerate(plans):
        merged = []
        for s in plan.secondary_slots:
            m = sim.add(
                f"final[{t}]{s}->{host}",
                f"link:{sec_res(t, s)}->{host}",
                pr.com(s, host, num_msg[n_layers - 1], plan.parts[-1].out[s].rows),
                [last_chunk[(t, s)]],
            )
            merged.append(m)
        h = sim.add(
            f"head[{t}]",
            host,
            pr.cmp(host, pr.num_head, 1),
            merged + [last_chunk[(t, host)]],
        )
        heads.append(h)
    return heads


# --------------------------------------------------------------------------
# Batched planning engine: DAG templates + layout-parameterised durations.
# --------------------------------------------------------------------------

def _layout_quantities(layouts: Sequence[PlanLayout]) -> np.ndarray:
    """Per-job row counts of one candidate, in the exact order
    :func:`_lay_halp_dag` prices jobs.

    This is the *parameter vector* of the template factorisation: job ``j``'s
    duration is ``nums[j] * q[j] / rate[j]`` where ``nums``/``rate`` live in
    the :class:`DagTemplate` (structure, shared across candidates) and ``q``
    is this walk (candidate-specific, pure integer arithmetic on the layout
    -- no Segment or HALPPlan objects).  The walk mirrors the builder:
    init slices, then per layer the secondary block (dep chunk, boundary
    sends, rest chunk) and the zone block (for-above chunk, send, rest chunk,
    send below), then the final merges and heads.  Any divergence from the
    builder is caught bit-exactly by :meth:`DagTemplate.from_layouts`'s
    build-time self-check."""
    walks = [lay.walk() for lay in layouts]
    vals: list[float] = []
    n_layers = layouts[0].n_layers
    for _sig, init_rows, _s, _z, _f in walks:
        vals += init_rows
    for i in range(n_layers):
        for _sig, _i, sec_layers, _z, _f in walks:
            vals += sec_layers[i]
        for _sig, _i, _s, zone_layers, _f in walks:
            vals += zone_layers[i]
    for _sig, _i, _s, _z, final_rows in walks:
        vals += final_rows
    return np.array(vals)


@dataclass
class DagTemplate:
    """The job/message DAG of one structural signature, durations factored out.

    ``sim`` holds the reference structure (job list, resources, dependencies)
    laid once by :func:`_lay_halp_dag`; ``nums``/``den_ids``/``den_kinds``
    factor every job's duration into ``num * rows / rate`` where ``num`` is a
    per-layer lane (FLOPs per output row for compute jobs, bits per boundary
    row for messages -- see :class:`_FloatPricer`), ``rows`` comes from a
    candidate's :func:`_layout_quantities` vector, and ``rate`` resolves
    against a topology at evaluation time (so one template serves every
    rate-drifted rebuild of the same cluster).  Scoring B candidates is then
    one :meth:`~repro_torch.core.simulator.Sim.run_batch` sweep -- bit-identical
    to B scalar builds + runs, enforced at build time by a self-check."""

    sim: object  # repro_torch.core.simulator.Sim
    heads: tuple[int, ...]
    nums: np.ndarray  # [J] duration-lane numerators
    den_ids: np.ndarray  # [J] index into den_kinds
    den_kinds: tuple[tuple, ...]  # ("es", name) | ("link", src, dst)

    @classmethod
    def from_layouts(
        cls,
        layouts: Sequence[PlanLayout],
        topology: CollabTopology,
        physical: bool,
    ) -> "DagTemplate":
        """Lay the DAG for ``layouts`` (one per task) and record the duration
        factorisation.  ``physical=False`` clones secondary resources per task
        (:func:`build_halp_dag`); ``physical=True`` keys them by ES name so
        tasks contend (:func:`build_multitask_dag`).  Raises AssertionError if
        the layout quantity walk does not reproduce the scalar builder's
        durations bit-for-bit."""
        from .simulator import Sim  # runtime import: simulator imports events

        plans = [plan_from_layout(lay) for lay in layouts]
        sim = Sim()
        pricer = _RecordingPricer(plans[0].net, topology)
        sec_res = (lambda t, s: s) if physical else (lambda t, s: f"{s}^{t}")
        heads = _lay_halp_dag(sim, plans, topology, sec_res, pricer=pricer)
        tmpl = cls(
            sim=sim,
            heads=tuple(heads),
            nums=np.array(pricer.nums),
            den_ids=np.array(pricer.den_ids),
            den_kinds=tuple(pricer.den_kinds),
        )
        quantities = _layout_quantities(layouts)
        if len(quantities) != len(sim.jobs):
            raise AssertionError(
                f"layout quantity walk produced {len(quantities)} entries for "
                f"{len(sim.jobs)} builder jobs -- the walks fell out of step"
            )
        ref = tmpl.durations(quantities, topology)[0]
        got = np.array([job.duration for job in sim.jobs])
        if not np.array_equal(ref, got):
            bad = int(np.flatnonzero(ref != got)[0])
            raise AssertionError(
                f"template durations diverge from the scalar builder at job "
                f"{bad} ({sim.jobs[bad].name}): {ref[bad]} != {got[bad]}"
            )
        return tmpl

    def rates(self, topology: CollabTopology) -> np.ndarray:
        """Per-den-kind rates (eff FLOP/s or link bps) under ``topology``."""
        return np.array(
            [
                topology.platform_of(kind[1]).eff_flops
                if kind[0] == "es"
                else topology.link_between(kind[1], kind[2]).rate_bps
                for kind in self.den_kinds
            ]
        )

    def durations(self, quantities: np.ndarray, topology: CollabTopology) -> np.ndarray:
        """[B, J] durations for B quantity vectors under ``topology``'s rates."""
        q = np.asarray(quantities, dtype=np.float64)
        if q.ndim == 1:
            q = q[None, :]
        return (self.nums * q) / self.rates(topology)[self.den_ids]

    def run(self, quantities: np.ndarray, topology: CollabTopology):
        """Score B candidates in one vectorized DES sweep (BatchRun)."""
        return self.sim.run_batch(self.durations(quantities, topology))


# Process-wide template cache: keyed on structure only (net, host, task
# structure, structural signature) -- never on rates, which resolve per call,
# so channel-drifting replans keep hitting the same templates.
_TEMPLATES: OrderedDict[tuple, DagTemplate] = OrderedDict()
_TEMPLATE_CAPACITY = 128


def _template_for(key: tuple, build) -> DagTemplate:
    tmpl = _TEMPLATES.get(key)
    if tmpl is None:
        tmpl = build()
        _TEMPLATES[key] = tmpl
        if len(_TEMPLATES) > _TEMPLATE_CAPACITY:
            _TEMPLATES.popitem(last=False)
    else:
        _TEMPLATES.move_to_end(key)
    return tmpl


# Process-wide layout cache.  A plan layout depends on (net, secondaries,
# host, overlap, ratios) but NOT on platform/link rates, so an online
# controller re-optimising the same cluster against drifting rate estimates
# revisits the same layouts over and over -- the dominant cost of a warm
# batched evaluation.  False stores infeasibility (also worth remembering).
_LAYOUTS: OrderedDict[tuple, "PlanLayout | bool"] = OrderedDict()
_LAYOUT_CAPACITY = 8192


def _layout_cached(
    net: ConvNetGeom,
    secondaries: tuple[str, ...],
    host: str,
    overlap_rows: int,
    ratios: tuple[float, ...],
    auto_reduce: bool = True,
) -> PlanLayout | None:
    key = (net, secondaries, host, overlap_rows, ratios, auto_reduce)
    hit = _LAYOUTS.get(key)
    if hit is None:
        try:
            hit = plan_layout(
                net,
                secondaries,
                host=host,
                overlap_rows=overlap_rows,
                ratios=ratios,
                auto_reduce=auto_reduce,
            )
        except (AssertionError, ValueError):
            hit = False
        _LAYOUTS[key] = hit
        if len(_LAYOUTS) > _LAYOUT_CAPACITY:
            _LAYOUTS.popitem(last=False)
    else:
        _LAYOUTS.move_to_end(key)
    return hit or None


class HalpBatchEvaluator:
    """Batched (ratios, overlap) candidate pricing for one cluster.

    The tentpole fast path of the planner: per candidate only the integer
    :class:`~repro_torch.core.partition.PlanLayout` and its row-count vector are
    computed; the DAG structure is laid once per structural signature
    (:class:`DagTemplate`, cached process-wide) and all candidates sharing a
    signature are priced in one vectorized :meth:`Sim.run_batch` sweep.
    Scores are bit-identical to :func:`~repro_torch.core.optimizer.evaluate_plan`'s
    scalar plan-build + DES path (pinned in ``tests/test_torch_engines.py``)."""

    def __init__(
        self,
        net: ConvNetGeom,
        topology: CollabTopology,
        n_tasks: int = 1,
        auto_reduce: bool = True,
    ):
        self.net = net
        self.topology = topology
        self.n_tasks = n_tasks
        self.auto_reduce = auto_reduce

    def layout_for(self, ratios, overlap_rows: int) -> PlanLayout | None:
        """The candidate's layout (process-wide cache), or None if infeasible."""
        return _layout_cached(
            self.net,
            self.topology.secondaries,
            self.topology.host,
            overlap_rows,
            tuple(ratios),
            self.auto_reduce,
        )

    def evaluate(self, candidates: Sequence[tuple]) -> list[float]:
        """DES makespans for ``(ratios, overlap_rows)`` candidates (+inf when
        infeasible), batched by structural signature."""
        scores = [float("inf")] * len(candidates)
        by_sig: dict[tuple, list[tuple[int, PlanLayout]]] = {}
        for k, (ratios, w) in enumerate(candidates):
            lay = self.layout_for(ratios, w)
            if lay is not None:
                by_sig.setdefault(lay.signature, []).append((k, lay))
        for sig, members in by_sig.items():
            key = ("clone", self.net, self.topology.host, self.n_tasks, sig)
            first = members[0][1]
            tmpl = _template_for(
                key,
                lambda lay=first: DagTemplate.from_layouts(
                    [lay] * self.n_tasks, self.topology, physical=False
                ),
            )
            q = np.stack(
                [_layout_quantities([lay] * self.n_tasks) for _k, lay in members]
            )
            run = tmpl.run(q, self.topology)
            for row, (k, _lay) in enumerate(members):
                scores[k] = float(run.makespan[row])
        return scores


class MultitaskBatchEvaluator:
    """Batched scoring of task -> secondaries assignments on one physical pool.

    Candidates are tuples of per-task secondary groups; each group gets the
    capacity-ratio plan layout over its sub-topology (the cheap scoring mode
    of per-task placement) and the whole assignment is
    priced on the shared-contention DAG (:func:`build_multitask_dag`
    semantics: host/links are physical resources) -- templated and batched
    exactly like the single-cluster evaluator."""

    def __init__(self, net: ConvNetGeom, pool: CollabTopology, overlap_rows: int = 4):
        self.net = net
        self.pool = pool
        self.overlap_rows = overlap_rows

    def layouts_for(self, groups: Sequence[Sequence[str]]) -> list[PlanLayout] | None:
        """Per-task layouts for one assignment, or None when any group is
        infeasible."""
        layouts = []
        for group in groups:
            try:
                sub = self.pool.sub_topology(group)
            except ValueError:
                return None
            lay = _layout_cached(
                self.net,
                sub.secondaries,
                self.pool.host,
                self.overlap_rows,
                sub.capacity_ratios(),
            )
            if lay is None:
                return None
            layouts.append(lay)
        return layouts

    def evaluate(self, candidates: Sequence[tuple]) -> list[dict | None]:
        """Shared-pool DES scores per assignment candidate: dicts with
        ``total`` / ``avg_delay`` / ``per_task_finish`` (None = infeasible),
        bit-identical to :func:`build_multitask_dag` + :meth:`Sim.run`."""
        return self.evaluate_layout_sets(
            [self.layouts_for(groups) for groups in candidates]
        )

    def evaluate_layout_sets(
        self, candidates: Sequence[list[PlanLayout] | None]
    ) -> list[dict | None]:
        """Score prepared per-task layout lists (None entries stay None) --
        the entry point for plan sets whose knobs differ from the capacity
        default, e.g. a placement's per-task refined (ratios, overlap)."""
        results: list[dict | None] = [None] * len(candidates)
        by_sig: dict[tuple, list[tuple[int, list[PlanLayout]]]] = {}
        for k, layouts in enumerate(candidates):
            if layouts is not None:
                sig = tuple(lay.signature for lay in layouts)
                by_sig.setdefault(sig, []).append((k, layouts))
        for sig, members in by_sig.items():
            key = ("multi", self.net, self.pool.host, sig)
            first = members[0][1]
            tmpl = _template_for(
                key,
                lambda lays=first: DagTemplate.from_layouts(
                    lays, self.pool, physical=True
                ),
            )
            q = np.stack([_layout_quantities(lays) for _k, lays in members])
            run = tmpl.run(q, self.pool)
            for row, (k, _lays) in enumerate(members):
                finishes = [float(run.finish_of(h)[row]) for h in tmpl.heads]
                results[k] = dict(
                    total=float(run.makespan[row]),
                    avg_delay=sum(finishes) / len(finishes),
                    per_task_finish=tuple(finishes),
                )
        return results


# --------------------------------------------------------------------------
# Mixed-scheme DAGs: halo segments + hub-relayed (NP / head-sequence) segments
# priced through the same template machinery.
# --------------------------------------------------------------------------

class _SegmentLanes:
    """Duration lanes of one halo *segment* (its sub-net), delegating the
    actual pricing to the outer pricer so a :class:`_RecordingPricer` keeps
    accumulating one factorisation across every segment of a scheme DAG."""

    def __init__(self, base, sub_net: ConvNetGeom):
        self._base = base
        self.num_cmp = _row_flops(sub_net)
        sizes = sub_net.sizes()
        self.num_msg = [
            8.0 * DTYPE_BYTES * sizes[i + 1] * g.c_out
            for i, g in enumerate(sub_net.layers)
        ]
        self.num_init = 8.0 * DTYPE_BYTES * sub_net.in_rows * sub_net.in_channels
        self.num_head = sub_net.head_flops  # 0.0: segment heads are barriers

    def cmp(self, es: str, num: float, rows: float) -> float:
        return self._base.cmp(es, num, rows)

    def com(self, src: str, dst: str, num: float, rows: float) -> float:
        return self._base.com(src, dst, num, rows)


def _lay_scheme_dag(
    sim,
    slayout: SchemeLayout,
    n_tasks: int,
    topology: CollabTopology,
    sec_res,
    pricer=None,
) -> list[int]:
    """Lay the job/message DAG of a mixed-scheme plan for ``n_tasks`` tasks.

    Segments chain through per-task *barriers* (the job after which the host
    holds the segment's full output):

    * **halo** segments re-enter :func:`_lay_halp_dag` on their sub-net with
      ``roots`` gating the entry -- identical structure and lanes to a
      standalone halo DAG of those layers, so the pure-halo scheme plan prices
      float-identically to the legacy path;
    * **host_solo** segments are one host job per layer per task;
    * **hub** segments (non_penetrative / head_sequence) lay, per relay layer,
      an upload per secondary (its held slice of the layer's input), a
      download per secondary (what it lacks), and a sliced compute job;
      transfer-free layers (``relay=False`` in
      :func:`~repro_torch.core.partition.hub_segment_fracs`) lay only the computes,
      so channel-local / row-local runs never synchronise across secondaries.
      A final gather + zero-duration host merge closes the segment.

    Job quantities are exactly mirrored by :func:`_scheme_quantities` (the
    template self-check enforces it bit-for-bit).  Returns the per-task head
    job ids."""
    net = slayout.net
    host = slayout.host
    secs = slayout.secondaries
    sizes = net.sizes()
    pr = pricer if pricer is not None else _FloatPricer(net, topology)
    cursor: list[int | None] = [None] * n_tasks
    for seg_idx, seg in enumerate(slayout.segments):
        if seg.scheme == SCHEME_HALO:
            lay = slayout.halo_layouts[seg_idx]
            sub_plan = plan_from_layout(lay)
            lanes = _SegmentLanes(pr, lay.net)
            heads = _lay_halp_dag(
                sim, [sub_plan] * n_tasks, topology, sec_res,
                pricer=lanes, roots=cursor,
            )
            cursor = list(heads)
            continue
        if seg.scheme == SCHEME_HOST:
            for i in range(seg.start, seg.stop + 1):
                flops = net.layer_flops(i)
                for t in range(n_tasks):
                    cursor[t] = sim.add(
                        f"solo[{t}].g{i}", host, pr.cmp(host, flops, 1.0), [cursor[t]]
                    )
            continue
        # hub segment (non_penetrative / head_sequence)
        fracs, final = slayout.hub_fracs[seg_idx]
        sec_prev: dict[tuple[int, int], int] = {}
        for off, (relay, up, down, share) in enumerate(fracs):
            i = seg.start + off
            g = net.layers[i]
            flops = net.layer_flops(i)
            bits_in = 8.0 * DTYPE_BYTES * sizes[i] * sizes[i] * g.c_in
            downs: dict[tuple[int, int], int] = {}
            if relay:
                ups: dict[int, list[int]] = {}
                for t in range(n_tasks):
                    for j, s in enumerate(secs):
                        ups.setdefault(t, []).append(
                            sim.add(
                                f"up[{t}]{s}.g{i}",
                                f"link:{sec_res(t, s)}->{host}",
                                pr.com(s, host, bits_in, up[j]),
                                [sec_prev.get((t, j))],
                            )
                        )
                for t in range(n_tasks):
                    for j, s in enumerate(secs):
                        downs[(t, j)] = sim.add(
                            f"down[{t}]{s}.g{i}",
                            f"link:{host}->{sec_res(t, s)}",
                            pr.com(host, s, bits_in, down[j]),
                            ups[t] + [cursor[t]],
                        )
            for t in range(n_tasks):
                for j, s in enumerate(secs):
                    sec_prev[(t, j)] = sim.add(
                        f"cmp[{t}]{s}.g{i}",
                        sec_res(t, s),
                        pr.cmp(s, flops, share[j]),
                        [downs.get((t, j)), sec_prev.get((t, j))],
                    )
        g = net.layers[seg.stop]
        bits_out = 8.0 * DTYPE_BYTES * sizes[seg.stop + 1] * sizes[seg.stop + 1] * g.c_out
        fins: dict[int, list[int]] = {}
        for t in range(n_tasks):
            for j, s in enumerate(secs):
                fins.setdefault(t, []).append(
                    sim.add(
                        f"gather[{t}]{s}.g{seg.stop}",
                        f"link:{sec_res(t, s)}->{host}",
                        pr.com(s, host, bits_out, final[j]),
                        [sec_prev.get((t, j))],
                    )
                )
        for t in range(n_tasks):
            cursor[t] = sim.add(
                f"merge[{t}].g{seg.stop}", host, pr.cmp(host, 0.0, 1.0),
                fins[t] + [cursor[t]],
            )
    heads = []
    for t in range(n_tasks):
        heads.append(
            sim.add(f"head[{t}]", host, pr.cmp(host, pr.num_head, 1.0), [cursor[t]])
        )
    return heads


def build_scheme_dag(
    sim, slayout: SchemeLayout, n_tasks: int, topology: CollabTopology
) -> list[int]:
    """Public mixed-scheme twin of :func:`build_halp_dag` (per-task secondary
    clones).  Returns the head job id of every task."""
    return _lay_scheme_dag(sim, slayout, n_tasks, topology, lambda t, s: f"{s}^{t}")


def _scheme_quantities(slayout: SchemeLayout, n_tasks: int) -> np.ndarray:
    """Per-job quantities of one mixed-scheme candidate, in the exact order
    :func:`_lay_scheme_dag` prices jobs (the scheme twin of
    :func:`_layout_quantities`; divergence is caught bit-exactly by the
    template self-check)."""
    vals: list[float] = []
    n_secs = len(slayout.secondaries)
    for seg_idx, seg in enumerate(slayout.segments):
        if seg.scheme == SCHEME_HALO:
            lay = slayout.halo_layouts[seg_idx]
            vals += _layout_quantities([lay] * n_tasks).tolist()
            # drop the sub-DAG's per-task head quantities? no: _layout_
            # quantities already includes them (the sub-head is a real job).
            continue
        if seg.scheme == SCHEME_HOST:
            vals += [1.0] * ((seg.stop - seg.start + 1) * n_tasks)
            continue
        fracs, final = slayout.hub_fracs[seg_idx]
        for relay, up, down, share in fracs:
            if relay:
                for _t in range(n_tasks):
                    vals += up
                for _t in range(n_tasks):
                    vals += down
            for _t in range(n_tasks):
                vals += share
        for _t in range(n_tasks):
            vals += final
        vals += [1.0] * n_tasks  # merge barriers
    vals += [1.0] * n_tasks  # heads
    return np.array(vals)


def _scheme_template(
    slayout: SchemeLayout, n_tasks: int, topology: CollabTopology
) -> DagTemplate:
    """Lay the scheme DAG once, record its duration factorisation, and verify
    the quantity walk reproduces the scalar builder bit-for-bit."""
    from .simulator import Sim  # runtime import: simulator imports events

    sim = Sim()
    pricer = _RecordingPricer(slayout.net, topology)
    heads = _lay_scheme_dag(
        sim, slayout, n_tasks, topology, lambda t, s: f"{s}^{t}", pricer=pricer
    )
    tmpl = DagTemplate(
        sim=sim,
        heads=tuple(heads),
        nums=np.array(pricer.nums),
        den_ids=np.array(pricer.den_ids),
        den_kinds=tuple(pricer.den_kinds),
    )
    quantities = _scheme_quantities(slayout, n_tasks)
    if len(quantities) != len(sim.jobs):
        raise AssertionError(
            f"scheme quantity walk produced {len(quantities)} entries for "
            f"{len(sim.jobs)} builder jobs -- the walks fell out of step"
        )
    ref = tmpl.durations(quantities, topology)[0]
    got = np.array([job.duration for job in sim.jobs])
    if not np.array_equal(ref, got):
        bad = int(np.flatnonzero(ref != got)[0])
        raise AssertionError(
            f"scheme template durations diverge from the scalar builder at "
            f"job {bad} ({sim.jobs[bad].name}): {ref[bad]} != {got[bad]}"
        )
    return tmpl


def _scheme_layout_cached(
    net: ConvNetGeom,
    secondaries: tuple[str, ...],
    host: str,
    overlap_rows: int,
    ratios: tuple[float, ...],
    assignment: tuple[str, ...],
    auto_reduce: bool = True,
) -> SchemeLayout | None:
    """Process-wide scheme-layout cache (rates never enter the key), sharing
    the halo layout cache's store and eviction.  False remembers infeasible
    assignments (a halo segment that cannot be realised)."""
    key = ("scheme", net, secondaries, host, overlap_rows, ratios, assignment, auto_reduce)
    hit = _LAYOUTS.get(key)
    if hit is None:
        try:
            hit = scheme_layout(
                net,
                secondaries,
                host=host,
                overlap_rows=overlap_rows,
                ratios=ratios,
                assignment=assignment,
                auto_reduce=auto_reduce,
            )
        except (AssertionError, ValueError):
            hit = False
        _LAYOUTS[key] = hit
        if len(_LAYOUTS) > _LAYOUT_CAPACITY:
            _LAYOUTS.popitem(last=False)
    else:
        _LAYOUTS.move_to_end(key)
    return hit or None


def simulate_scheme(
    net: ConvNetGeom,
    topology: CollabTopology,
    ratios=None,
    overlap_rows: int = 4,
    assignment: Sequence[str] | None = None,
    schemes: Sequence[str] = SCHEMES,
    n_tasks: int = 1,
    auto_reduce: bool = True,
) -> dict:
    """Scalar DES makespan of one mixed-scheme plan (the scheme twin of
    :func:`~repro_torch.core.simulator.simulate_halp`); the batched evaluator is
    pinned float-equal to this path in ``tests/test_torch_engines.py``."""
    from .simulator import Sim  # runtime import: simulator imports events

    if ratios is None:
        ratios = topology.capacity_ratios()
    slay = scheme_layout(
        net,
        topology.secondaries,
        host=topology.host,
        overlap_rows=overlap_rows,
        ratios=ratios,
        assignment=assignment,
        schemes=schemes,
        auto_reduce=auto_reduce,
    )
    sim = Sim()
    heads = _lay_scheme_dag(sim, slay, n_tasks, topology, lambda t, s: f"{s}^{t}")
    total = sim.run()
    return dict(total=total, sim=sim, layout=slay, heads=tuple(heads))


class SchemeBatchEvaluator:
    """Batched (ratios, overlap, scheme-assignment) candidate pricing.

    The joint-search twin of :class:`HalpBatchEvaluator`: candidates sharing a
    structural signature (same fused segments, same halo sub-signatures) share
    one :class:`DagTemplate` and are priced in one vectorized
    :meth:`Sim.run_batch` sweep.  Scores are float-identical to
    :func:`simulate_scheme`'s scalar path."""

    def __init__(
        self,
        net: ConvNetGeom,
        topology: CollabTopology,
        n_tasks: int = 1,
        auto_reduce: bool = True,
    ):
        self.net = net
        self.topology = topology
        self.n_tasks = n_tasks
        self.auto_reduce = auto_reduce

    def layout_for(self, ratios, overlap_rows: int, assignment) -> SchemeLayout | None:
        return _scheme_layout_cached(
            self.net,
            self.topology.secondaries,
            self.topology.host,
            overlap_rows,
            tuple(ratios),
            tuple(assignment),
            self.auto_reduce,
        )

    def evaluate(self, candidates: Sequence[tuple]) -> list[float]:
        """DES makespans for ``(ratios, overlap_rows, assignment)`` candidates
        (+inf when infeasible), batched by structural signature."""
        scores = [float("inf")] * len(candidates)
        by_sig: dict[tuple, list[tuple[int, SchemeLayout]]] = {}
        for k, (ratios, w, assignment) in enumerate(candidates):
            lay = self.layout_for(ratios, w, assignment)
            if lay is not None:
                by_sig.setdefault(lay.signature, []).append((k, lay))
        for sig, members in by_sig.items():
            key = ("scheme", self.net, self.topology.host, self.n_tasks, sig)
            first = members[0][1]
            tmpl = _template_for(
                key,
                lambda lay=first: _scheme_template(lay, self.n_tasks, self.topology),
            )
            q = np.stack(
                [_scheme_quantities(lay, self.n_tasks) for _k, lay in members]
            )
            run = tmpl.run(q, self.topology)
            for row, (k, _lay) in enumerate(members):
                scores[k] = float(run.makespan[row])
        return scores
