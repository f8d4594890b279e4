"""Static structural verification of partition plans (the port's copy of
``repro/analysis/plan_check.py``).

Proves -- by pure integer arithmetic on the plan, no torch, no execution --
the invariants the paper's correctness argument rests on:

* **Row coverage** (paper eq. 7): every layer's output rows ``1..O_i`` are
  owned exactly once across the slot sequence -- no gaps, no overlaps.
* **Receptive-field exactness** (eqs. 8-9, exact form in ``rf.py``): each
  slot's declared input range equals ``input_range_exact`` of its output
  segment -- too little means wrong output rows (a *short halo*), too much
  means unpriced communication.
* **Halo algebra** (eqs. 8-9 / ``spatial.halo.halo_sizes``): per conv layer
  ``lo = p`` and ``hi = k - p - s`` satisfy ``lo + hi == k - s`` and the
  geometry is one the aligned-shard exchange supports; per slot, needed rows
  beyond its own span must be donatable by *adjacent* owners only (halo <=
  shard height -- rows from two shards away cannot be exchanged).
* **Message legality** (``partition._check_layout`` contract): secondaries
  never exchange rows directly, and host zones only send to adjacent
  secondaries -- anything else would be unpriced by both latency engines.
* **Auto-reduce monotonicity** (``partition._reduced_slot_rows`` contract):
  once a trailing secondary is dropped at a conv layer it stays dropped --
  the active suffix can only shrink with depth.
* **Scheme-stage legality** (``stage_spans`` / ``SCHEMES``): a
  :class:`SchemePlan`'s spans match the net's stage structure, every
  per-stage scheme is legal for its layer kinds, segments are the exact
  fusion of the assignment, and halo segments carry sub-plans over the right
  sub-geometry.
* **Head-split divisibility**: head_sequence stages need ``d % heads == 0``
  (``run_plan`` slices per-head parameter blocks of width ``d // heads``).

The entry point is :func:`check_plan`; it accepts ``HALPPlan``,
``SchemePlan``, ``PlanLayout`` and ``SchemeLayout`` objects and returns a
:class:`~repro_torch.analysis.findings.Report`.
"""
from __future__ import annotations

from ..core.partition import (
    HALPPlan,
    PlanLayout,
    SchemeLayout,
    SchemePlan,
    SCHEME_HALO,
    SCHEME_HOST,
    SCHEME_HS,
    _scheme_valid,
    _segment_subnet,
    fuse_assignment,
    plan_from_layout,
    plan_from_scheme_layout,
    stage_spans,
)
from ..core.rf import input_range_exact
from .findings import Report

__all__ = ["check_plan"]


def check_plan(plan) -> Report:
    """Statically verify a plan object; returns a Report (never raises)."""
    rep = Report()
    if isinstance(plan, PlanLayout):
        plan = plan_from_layout(plan)
    if isinstance(plan, SchemeLayout):
        plan = plan_from_scheme_layout(plan)
    if isinstance(plan, SchemePlan):
        _check_scheme_plan(plan, rep)
    elif isinstance(plan, HALPPlan):
        _check_halp_plan(plan, rep)
    else:
        rep.add(
            "plan.type",
            type(plan).__name__,
            "not a HALPPlan / SchemePlan / PlanLayout / SchemeLayout",
        )
    return rep


# ---------------------------------------------------------------------------
# HALP (halo'd row-segment) plans
# ---------------------------------------------------------------------------


def _check_halp_plan(plan: HALPPlan, rep: Report, ctx: str = "") -> None:
    net = plan.net
    sizes = net.sizes()
    slots = plan.es_names
    hosted = bool(plan.slot_owner)
    n_layers = len(net.layers)

    rep.tick()
    if len(plan.parts) != n_layers:
        rep.add(
            "plan.coverage",
            f"{ctx}plan",
            f"{len(plan.parts)} layer partitions for {n_layers} layers",
        )
        return

    # trailing-empty-secondary suffix at the previous conv layer (auto-reduce
    # drops secondaries from the tail; the suffix may only grow with depth)
    prev_suffix = 0
    prev_suffix_layer = -1

    for i, g in enumerate(net.layers):
        o, rows_in = sizes[i + 1], sizes[i]
        part = plan.parts[i]
        where = f"{ctx}layer {i} ({g.name})"

        if g.kind == "attn":
            rep.tick()
            owners = [s for s in slots if part.out.get(s)]
            if len(owners) > 1:
                rep.add(
                    "plan.scheme",
                    where,
                    "attention layer row-partitioned across "
                    f"{len(owners)} slots; every output row of attention "
                    "depends on every input row, so no receptive-field row "
                    "split exists (use the head_sequence scheme)",
                )
            continue

        # --- exact row coverage: no gaps, no overlaps, full span 1..o
        rep.tick()
        cur = 0
        for slot in slots:
            seg = part.out.get(slot)
            if seg is None:
                rep.add("plan.coverage", f"{where}, slot {slot}", "slot missing from partition")
                continue
            if not seg:
                continue
            if seg.lo < 1 or seg.hi > o:
                rep.add(
                    "plan.coverage",
                    f"{where}, slot {slot}",
                    f"owns rows {seg.lo}..{seg.hi} outside the layer's 1..{o}",
                )
            if seg.lo <= cur:
                rep.add(
                    "plan.coverage",
                    f"{where}, slot {slot}",
                    f"rows {seg.lo}..{min(seg.hi, cur)} already owned by a "
                    f"preceding slot (overlap)",
                )
            elif seg.lo > cur + 1:
                rep.add(
                    "plan.coverage",
                    f"{where}, slot {slot}",
                    f"rows {cur + 1}..{seg.lo - 1} owned by nobody (gap)",
                )
            cur = max(cur, seg.hi)
        if cur < o:
            rep.add(
                "plan.coverage", where, f"rows {cur + 1}..{o} owned by nobody (gap at tail)"
            )

        # --- halo algebra of the layer geometry (eqs. 8-9 / halo_sizes)
        if g.kind in ("conv", "depthwise"):
            rep.tick()
            lo, hi = g.p, g.k - g.p - g.s
            if g.p < 0 or lo >= g.k or hi >= g.k:
                rep.add(
                    "plan.halo",
                    where,
                    f"unsupported halo geometry k={g.k} s={g.s} p={g.p} "
                    f"(need 0 <= p < k and k - p - s < k)",
                )
            # lo + hi == k - s holds identically for lo=p, hi=k-p-s; what can
            # break it is hi < 0 (p > k - s): the top halo then over-covers
            # and the aligned exchange clamps -- legal, priced, no finding.

        # --- receptive-field exactness of every declared input range
        for slot in slots:
            rep.tick()
            seg = part.out.get(slot)
            inp = part.inp.get(slot)
            sw = f"{where}, slot {slot}"
            if seg is None:
                continue  # already reported above
            if not seg:
                if inp:
                    rep.add(
                        "plan.rf",
                        sw,
                        f"owns no output rows but declares input rows "
                        f"{inp.lo}..{inp.hi} (unpriced transfer)",
                    )
                continue
            exp = input_range_exact(seg.lo, seg.hi, g.k, g.s, g.p, rows_in)
            got = (inp.lo, inp.hi) if inp else None
            if got != exp:
                if got is None or got[0] > exp[0] or got[1] < exp[1]:
                    rep.add(
                        "plan.rf",
                        sw,
                        f"short halo: output rows {seg.lo}..{seg.hi} need input "
                        f"rows {exp[0]}..{exp[1]} (eq. 8-9 exact) but the plan "
                        f"provides {got[0]}..{got[1]}" if got else
                        f"short halo: output rows {seg.lo}..{seg.hi} need input "
                        f"rows {exp[0]}..{exp[1]} but the plan provides none",
                    )
                else:
                    rep.add(
                        "plan.rf",
                        sw,
                        f"surplus input: rows {got[0]}..{got[1]} declared but the "
                        f"receptive field of output rows {seg.lo}..{seg.hi} is "
                        f"exactly {exp[0]}..{exp[1]} (unpriced transfer rows)",
                    )

        # --- halo reach / message legality between consecutive layers
        if i > 0 and net.layers[i - 1].kind != "attn":
            if hosted:
                _check_messages(plan, i - 1, rep, ctx)
            else:
                _check_flat_reach(plan, i, rep, ctx)

        # --- auto-reduce monotonicity (hosted plans, conv layers only:
        # pools inherit divided boundaries and may transiently zero a slot)
        if hosted and g.kind != "pool":
            rep.tick()
            secs = plan.secondary_slots
            empty = [not part.out.get(s) for s in secs]
            suffix = 0
            for e in reversed(empty):
                if not e:
                    break
                suffix += 1
            if suffix < prev_suffix:
                revived = secs[len(secs) - prev_suffix]
                rep.add(
                    "plan.reduce",
                    f"{where}, secondary {revived}",
                    f"re-activated after being auto-reduced away at layer "
                    f"{prev_suffix_layer}: a dropped secondary must stay idle "
                    f"for the rest of the net (monotone reduction)",
                )
            else:
                prev_suffix, prev_suffix_layer = suffix, i


def _msg_iv(need, own, got):
    """Interval twin of ``partition._message_iv`` that reports instead of
    asserting: returns (lo, hi, contiguous)."""
    lo = max(need[0], own[0])
    hi = min(need[1], own[1])
    if lo > hi:
        return 1, 0, True
    p1, p2 = lo < got[0], hi > got[1]
    if p1 and p2:
        return lo, hi, False
    if p1:
        return lo, min(hi, got[0] - 1), True
    if p2:
        return max(lo, got[1] + 1), hi, True
    return 1, 0, True


def _check_messages(plan: HALPPlan, i: int, rep: Report, ctx: str) -> None:
    """Port of ``partition._check_layout`` for one layer boundary, reporting
    findings instead of raising (works on corrupted plans)."""
    slots = plan.es_names
    host = plan.host
    out_i = plan.parts[i].out
    got_i = out_i  # dst's already-held rows live in the same layer's output
    inp_next = plan.parts[i + 1].inp
    where = f"{ctx}layer {i}"
    for pa, sa in enumerate(slots):
        own = out_i.get(sa)
        if not own:
            continue
        a_host = plan.owner_of(sa) == host
        for pb, sb in enumerate(slots):
            if pb == pa:
                continue
            rep.tick()
            b_host = plan.owner_of(sb) == host
            if a_host and b_host:
                continue  # zone-to-zone: host-local move
            if not a_host and b_host:
                continue  # sec -> any zone: direct uplink, priced
            if abs(pa - pb) <= 1 and a_host != b_host:
                continue  # adjacent host<->sec: the paper's boundary flow
            need = inp_next.get(sb)
            got = got_i.get(sb)
            if need is None or got is None:
                continue  # missing slots reported by the coverage pass
            lo, hi, contig = _msg_iv(
                (need.lo, need.hi), (own.lo, own.hi), (got.lo, got.hi)
            )
            if not contig:
                rep.add(
                    "plan.halo",
                    f"{where}, {sa}->{sb}",
                    f"non-contiguous message {lo}..{hi} minus held rows "
                    f"{got.lo}..{got.hi}: segment ordering violated",
                )
                continue
            if lo > hi:
                continue
            if not a_host and not b_host:
                rep.add(
                    "plan.halo",
                    f"{where}, {sa}->{sb}",
                    f"secondaries would exchange rows {lo}..{hi} directly; "
                    f"there is no secondary-secondary link (halo exceeds the "
                    f"neighbouring shard height)",
                )
            else:
                rep.add(
                    "plan.halo",
                    f"{where}, {sa}->{sb}",
                    f"zone would send rows {lo}..{hi} to a non-adjacent "
                    f"secondary; the zone-chunk schedule only prices sends to "
                    f"the two neighbours",
                )


def _check_flat_reach(plan: HALPPlan, i: int, rep: Report, ctx: str) -> None:
    """Flat (unhosted) plans -- the spatial shard_map deployment: a shard's
    input may only extend into the *adjacent* shards' previous-layer rows
    (halo <= shard height; ppermute exchanges one neighbour deep)."""
    slots = plan.es_names
    prev_out = plan.parts[i - 1].out
    inp = plan.parts[i].inp
    where = f"{ctx}layer {i}"
    for idx, slot in enumerate(slots):
        need = inp.get(slot)
        if not need:
            continue
        rep.tick()
        reach = [
            prev_out.get(slots[j])
            for j in (idx - 1, idx, idx + 1)
            if 0 <= j < len(slots)
        ]
        reach = [r for r in reach if r]
        if not reach:
            rep.add(
                "plan.halo",
                f"{where}, slot {slot}",
                f"needs input rows {need.lo}..{need.hi} but neither it nor its "
                f"neighbours own any previous-layer rows",
            )
            continue
        lo = min(r.lo for r in reach)
        hi = max(r.hi for r in reach)
        if need.lo < lo or need.hi > hi:
            rep.add(
                "plan.halo",
                f"{where}, slot {slot}",
                f"needs input rows {need.lo}..{need.hi} but adjacent shards "
                f"only cover {lo}..{hi}: halo exceeds shard height (rows from "
                f"two shards away cannot be exchanged)",
            )


# ---------------------------------------------------------------------------
# Mixed-scheme plans
# ---------------------------------------------------------------------------


def _check_scheme_plan(plan: SchemePlan, rep: Report) -> None:
    net = plan.net

    rep.tick()
    if plan.host in plan.secondaries:
        rep.add("plan.scheme", "topology", f"host {plan.host!r} is also a secondary")
    rep.tick()
    if len(plan.ratios) != len(plan.secondaries):
        rep.add(
            "plan.scheme",
            "ratios",
            f"{len(plan.ratios)} ratios for {len(plan.secondaries)} secondaries",
        )
    elif any(r < 0 for r in plan.ratios) or not sum(plan.ratios) > 0:
        rep.add("plan.scheme", "ratios", f"not a normalisable weighting: {plan.ratios}")

    # --- stage structure must match the net
    rep.tick()
    spans = stage_spans(net)
    if plan.spans != spans:
        rep.add(
            "plan.scheme",
            "stage spans",
            f"plan spans {plan.spans} != stage_spans(net) {spans}; the stage "
            f"structure is derived from pooling/attention boundaries and "
            f"cannot be chosen",
        )
        return  # everything below is relative to the true spans
    rep.tick()
    if len(plan.assignment) != len(spans):
        rep.add(
            "plan.scheme",
            "assignment",
            f"{len(plan.assignment)} schemes for {len(spans)} stages",
        )
        return

    # --- per-stage scheme legality
    for idx, (span, sch) in enumerate(zip(spans, plan.assignment)):
        rep.tick()
        try:
            ok = _scheme_valid(net, span, sch)
        except ValueError:
            ok = False
        if not ok:
            kinds = ",".join(g.kind for g in net.layers[span[0] : span[1] + 1])
            rep.add(
                "plan.scheme",
                f"stage {idx} (layers {span[0]}-{span[1]})",
                f"scheme {sch!r} is illegal for layer kinds [{kinds}]",
            )

    # --- segments must be the exact fusion of the assignment
    rep.tick()
    try:
        segs = fuse_assignment(spans, plan.assignment)
    except ValueError as exc:
        rep.add("plan.scheme", "segments", str(exc))
        return
    if plan.segments != segs:
        rep.add(
            "plan.scheme",
            "segments",
            f"plan segments do not fuse the assignment: {plan.segments} != {segs}",
        )
        return

    # --- per-segment payloads
    if len(plan.halo_plans) != len(plan.segments):
        rep.add(
            "plan.scheme",
            "segments",
            f"{len(plan.halo_plans)} halo sub-plans for {len(plan.segments)} segments",
        )
        return
    for idx, (seg, sub) in enumerate(zip(plan.segments, plan.halo_plans)):
        swhere = f"segment {idx} ({seg.scheme}, layers {seg.start}-{seg.stop})"
        rep.tick()
        if seg.scheme == SCHEME_HALO:
            if sub is None:
                rep.add("plan.scheme", swhere, "halo segment without a HALP sub-plan")
                continue
            ref = _segment_subnet(net, seg.start, seg.stop)
            if sub.net.layers != ref.layers or sub.net.in_rows != ref.in_rows:
                rep.add(
                    "plan.scheme",
                    swhere,
                    f"sub-plan geometry {sub.net.name!r} does not match the "
                    f"segment's layers of {net.name!r}",
                )
                continue
            _check_halp_plan(sub, rep, ctx=f"{swhere}, ")
        else:
            if sub is not None:
                rep.add(
                    "plan.scheme", swhere, f"{seg.scheme} segment carries a HALP sub-plan"
                )
            if seg.scheme == SCHEME_HS:
                for i in range(seg.start, seg.stop + 1):
                    g = net.layers[i]
                    if g.kind != "attn":
                        continue
                    rep.tick()
                    if g.heads < 1 or g.c_in % g.heads:
                        rep.add(
                            "plan.heads",
                            f"{swhere}, layer {i} ({g.name})",
                            f"d={g.c_in} not divisible by heads={g.heads}: the "
                            f"head-sequence executor slices per-head parameter "
                            f"blocks of width d // heads",
                        )
            elif seg.scheme == SCHEME_HOST:
                pass  # host computes alone: nothing to verify
