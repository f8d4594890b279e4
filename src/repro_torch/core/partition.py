"""Segment-based task partitioning (paper §III, eqs. 5-9) and the HALP plan.

The port's copy of the HALP-plan half of ``repro/core/partition.py``: the
Segment/plan data model, the N-way slot layout with auto-reduction, and the
materialised :class:`HALPPlan` that :func:`repro_torch.spatial.run_plan`
executes, the N-way contiguous split :func:`plan_even` whose row shares
the spatial engine deploys, and the per-stage scheme half (:func:`plan_scheme`
and the :class:`SchemePlan` it materialises), with the layout walk and
signatures the batched DES keys on and the per-stage communication
accounting.

The host ES partitions every layer's *output rows* into contiguous **slots**
along the row axis.  Slots alternate between secondary segments and host-owned
overlapping zones (paper Fig. 2 / eqs. 6-7); with N secondaries there are
K = N - 1 zones:

    s_0 | zone_0 | s_1 | zone_1 | ... | zone_{K-1} | s_K

Each slot's required *input rows* follow from the exact receptive-field
interval algebra, and all inter-slot messages follow from range intersections,
so the plan is lossless by construction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import TYPE_CHECKING, Sequence

from .nets import DTYPE_BYTES, ConvNetGeom
from .rf import input_range_exact

if TYPE_CHECKING:  # typing only
    from .topology import CollabTopology

__all__ = [
    "Segment",
    "LayerPartition",
    "HALPPlan",
    "PlanInfeasible",
    "PlanLayout",
    "plan_halp",
    "plan_even",
    "plan_halp_n",
    "plan_halp_topology",
    "plan_layout",
    "split_rows",
    "plan_from_layout",
    "SCHEME_HALO",
    "SCHEME_NP",
    "SCHEME_HS",
    "SCHEME_HOST",
    "SCHEMES",
    "stage_spans",
    "stage_scheme_options",
    "baseline_assignment",
    "SchemeSegment",
    "fuse_assignment",
    "hub_segment_fracs",
    "SchemeLayout",
    "scheme_layout",
    "SchemePlan",
    "plan_from_scheme_layout",
    "plan_scheme",
    "comm_bytes_per_stage",
]


class PlanInfeasible(ValueError):
    """A partition that cannot be realised under the HALP invariants.

    Carries the offending ``layer`` and the layers auto-reduction should try
    shrinking (``reduce_at``), so :func:`plan_halp_n` can degrade gracefully
    instead of giving up."""

    def __init__(self, layer: int, msg: str, reduce_at: tuple[int, ...] = ()):
        super().__init__(msg)
        self.layer = layer
        self.reduce_at = reduce_at or (layer,)


E1, E0, E2 = "e1", "e0", "e2"  # paper's ES names; e0 is the host


@dataclass(frozen=True)
class Segment:
    """1-indexed inclusive row range; empty iff lo > hi."""

    lo: int
    hi: int

    @property
    def rows(self) -> int:
        return max(0, self.hi - self.lo + 1)

    def __bool__(self) -> bool:  # truthy iff non-empty
        return self.rows > 0


EMPTY = Segment(1, 0)

# Interval twin of EMPTY for the layout layer (plain tuples, no dataclass).
EMPTY_IV = (1, 0)


def _message_iv(
    need: tuple[int, int], own: tuple[int, int], got: tuple[int, int]
) -> tuple[int, int]:
    """Rows of ``own`` that ``need`` covers and ``got`` does not already hold.
    Intervals are 1-indexed inclusive, empty iff lo > hi."""
    lo = max(need[0], own[0])
    hi = min(need[1], own[1])
    if lo > hi:
        return EMPTY_IV
    pieces = []
    if lo < got[0]:
        pieces.append((lo, min(hi, got[0] - 1)))
    if hi > got[1]:
        pieces.append((max(lo, got[1] + 1), hi))
    if not pieces:
        return EMPTY_IV
    if len(pieces) == 1:
        return pieces[0]
    # src on both sides of dst cannot happen with contiguous ordered segments
    raise AssertionError("non-contiguous message; segment ordering violated")


@dataclass(frozen=True)
class LayerPartition:
    """Partition of one layer: output segments and required input ranges per slot."""

    index: int
    out: dict[str, Segment]
    inp: dict[str, Segment]  # exact input rows each slot needs (eqs. 8-9, exact form)


@dataclass(frozen=True)
class HALPPlan:
    net: ConvNetGeom
    parts: tuple[LayerPartition, ...]
    es_names: tuple[str, ...]  # slot names in row order: (e1, e0, e2) or N-way
    host: str = E0  # the ES that owns every overlapping zone
    slot_owner: tuple[str, ...] = ()  # parallel to es_names; () -> slots own themselves

    def owner_of(self, slot: str) -> str:
        """The physical ES that computes ``slot`` (zones resolve to the host)."""
        if self.slot_owner:
            return self.slot_owner[self.es_names.index(slot)]
        return slot

    @property
    def secondary_slots(self) -> tuple[str, ...]:
        return tuple(s for s in self.es_names if self.owner_of(s) != self.host)

    @property
    def zone_slots(self) -> tuple[str, ...]:
        return tuple(s for s in self.es_names if self.owner_of(s) == self.host)

    def adjacent_zones(self, sec_slot: str) -> tuple[str, ...]:
        """Host zone slots bordering a secondary slot (above first, in row order)."""
        idx = self.es_names.index(sec_slot)
        out = []
        for j in (idx - 1, idx + 1):
            if 0 <= j < len(self.es_names) and self.owner_of(self.es_names[j]) == self.host:
                out.append(self.es_names[j])
        return tuple(out)

    def adjacent_secondaries(self, zone_slot: str) -> tuple[str, str]:
        """The (above, below) secondary slots bordering a host zone."""
        idx = self.es_names.index(zone_slot)
        return self.es_names[idx - 1], self.es_names[idx + 1]

    def active_secondaries(self, layer: int) -> tuple[str, ...]:
        """Secondary slots owning at least one row at ``layer``."""
        return tuple(s for s in self.secondary_slots if self.parts[layer].out[s])

    def message(self, layer: int, src: str, dst: str) -> Segment:
        """Rows of layer ``layer``'s *output* that src owns and dst needs as
        input for layer ``layer + 1`` (or for the head merge if last layer)."""
        if layer + 1 >= len(self.parts):
            # final layer: everything the secondaries own is sent to the host
            # to be merged as the FL input (paper eqs. 13-14, g_i = g_N case).
            if dst == self.host and self.owner_of(src) != self.host:
                return self.parts[layer].out[src]
            return EMPTY
        if src == dst:
            return EMPTY
        need = self.parts[layer + 1].inp[dst]
        own = self.parts[layer].out[src]
        got = self.parts[layer].out[dst]
        lo, hi = _message_iv((need.lo, need.hi), (own.lo, own.hi), (got.lo, got.hi))
        return Segment(lo, hi) if lo <= hi else EMPTY

    def message_bytes(self, layer: int, src: str, dst: str) -> float:
        seg = self.message(layer, src, dst)
        if not seg:
            return 0.0
        g = self.net.layers[layer]
        width = self.net.sizes()[layer + 1]
        return DTYPE_BYTES * seg.rows * width * g.c_out


# Cross-candidate cache of per-layer walk quantities (see PlanLayout.walk):
# a layer's priced rows are a pure function of (its slot boundaries, the next
# layer's input needs), and coordinate-descent candidates share most layers.
_WALK_LAYER_CACHE: dict[tuple, tuple] = {}


def _union_iv_rows(ivs: list[tuple[int, int]]) -> int:
    """Distinct rows covered by possibly-overlapping intervals (a 1-row middle
    secondary can owe the *same* row to two adjacent zones; it computes it
    once)."""
    rows = 0
    cur_hi = 0
    for lo, hi in sorted(iv for iv in ivs if iv[0] <= iv[1]):
        lo = max(lo, cur_hi + 1)
        if hi >= lo:
            rows += hi - lo + 1
            cur_hi = hi
    return rows


def _split_counts(total: int, ratios: Sequence[float]) -> list[int]:
    """Row counts of contiguous segments by cumulative ratio (paper eqs. 6-7
    generalised); rounding via the cumulative boundary keeps every segment
    within +-1 row of its exact share."""
    if total < 0:
        raise ValueError(f"total must be >= 0, got {total}")
    if abs(sum(ratios) - 1.0) > 1e-9:
        raise ValueError(f"ratios must sum to 1, got {sum(ratios)}")
    bounds = [0]
    acc = 0.0
    for r in ratios[:-1]:
        acc += r
        bounds.append(min(total, max(bounds[-1], int(round(acc * total)))))
    bounds.append(total)
    return [hi - lo for lo, hi in zip(bounds[:-1], bounds[1:])]


def _norm_ratios(n: int, ratios: Sequence[float] | None, per: str) -> list[float]:
    """``ratios`` (one per ``per``, e.g. worker or shard) scaled to sum to 1;
    None is the uniform split."""
    if ratios is None:
        return [1.0 / n] * n
    ratios = list(ratios)
    if len(ratios) != n:
        raise ValueError(f"need one ratio per {per}, got {len(ratios)} for n={n}")
    total = sum(ratios)
    if total <= 0 or any(r < 0 for r in ratios):
        raise ValueError(f"ratios must be non-negative with a positive sum, got {ratios}")
    return [r / total for r in ratios]


def split_rows(total: int, ratios: Sequence[float]) -> list[Segment]:
    """Contiguous segments covering rows 1..total by cumulative ratio, each
    within +-1 row of its exact share.  Heavily skewed ratios on small totals
    may give *empty* segments (lo > hi)."""
    segs = []
    lo = 0
    for c in _split_counts(total, ratios):
        segs.append(Segment(lo + 1, lo + c))
        lo += c
    return segs


def _pool_alignment(net: ConvNetGeom, i: int, o: int) -> int:
    """Product of pooling strides between layer i and the next conv, reduced
    until it is small relative to the feature map."""
    align = 1
    for h in net.layers[i + 1 :]:
        if h.kind != "pool":
            break
        align *= h.s
    while align > max(1, o // 4):
        align //= 2
    return max(1, align)


def _min_one_unit(counts: list[int], body_u: int) -> list[int]:
    """Give every secondary at least one unit when the body is large enough,
    taking units from the largest segment."""
    n = len(counts)
    if body_u < n:
        return counts
    counts = list(counts)
    while min(counts) < 1:
        counts[counts.index(max(counts))] -= 1
        counts[counts.index(min(counts))] += 1
    return counts


def _conv_slot_rows(
    o: int, overlap_rows: int, ratios: Sequence[float], align: int
) -> list[int]:
    """Row counts of the 2K+1 slots (sec, zone, sec, ..., sec) for one conv layer.

    Works in units of ``align`` so that both edges of every host zone land on
    pooling-stride multiples; the last secondary absorbs the remainder."""
    n_sec = len(ratios)
    k_zones = n_sec - 1
    w_eff = min(overlap_rows, max(1, o - 2))
    units = o // align
    w_u = max(1, -(-w_eff // align))  # ceil
    while units - k_zones * w_u < n_sec and w_u > 1:
        w_u -= 1
    body_u = units - k_zones * w_u
    if body_u < 0:
        raise ValueError(
            f"cannot fit {n_sec} secondaries + {k_zones} zones into {o} rows"
        )
    sec_u = _min_one_unit(_split_counts(body_u, ratios), body_u)
    counts = []
    for j in range(n_sec):
        counts.append(sec_u[j] * align)
        if j < k_zones:
            counts.append(w_u * align)
    counts[-1] += o - units * align  # remainder rows go to the last secondary
    return counts


def _reduced_slot_rows(
    o: int, overlap_rows: int, ratios: Sequence[float], align: int, n_active: int
) -> list[int]:
    """Slot row counts when only the first ``n_active`` secondaries stay active:

        s_0 | z_0 | ... | s_{n'-1} | tail (host) | 0 | 0 | ...

    The host-owned tail absorbs the combined ratio share of the dropped
    secondaries, so only sec->host transfers cross the reduction."""
    n_sec = len(ratios)
    if n_active >= n_sec:
        return _conv_slot_rows(o, overlap_rows, ratios, align)
    k_thin = n_active - 1
    w_eff = min(overlap_rows, max(1, o - 2))
    units = o // align
    w_u = max(1, -(-w_eff // align))  # ceil
    while units - k_thin * w_u < n_active + 1 and w_u > 1:
        w_u -= 1
    body_u = units - k_thin * w_u
    if body_u < n_active + 1:  # active secondaries + a non-empty host tail
        raise ValueError(
            f"cannot fit {n_active} active secondaries + a host tail into {o} rows"
        )
    shares = [*ratios[:n_active], sum(ratios[n_active:])]
    total = sum(shares)
    counts_u = _split_counts(body_u, [r / total for r in shares])
    # every active secondary and the tail need at least one unit each
    while min(counts_u) < 1:
        counts_u[counts_u.index(max(counts_u))] -= 1
        counts_u[counts_u.index(min(counts_u))] += 1
    counts = []
    for j in range(n_active):
        counts.append(counts_u[j] * align)
        if j < k_thin:
            counts.append(w_u * align)
    # host tail zone absorbs the dropped share and the alignment remainder
    counts.append(counts_u[-1] * align + (o - units * align))
    counts.extend([0] * (2 * (n_sec - n_active) - 1))
    return counts


def plan_halp(
    net: ConvNetGeom,
    overlap_rows: int = 4,
    es_names: tuple[str, str, str] = (E1, E0, E2),
    ratios: Sequence[float] | None = None,
    auto_reduce: bool = True,
) -> HALPPlan:
    """The paper's 2-secondary HALP partition (§IV.A) -- thin wrapper over
    :func:`plan_halp_n` with the ``(e1, e0, e2)`` interface."""
    lo_name, host, hi_name = es_names
    return plan_halp_n(
        net,
        secondaries=(lo_name, hi_name),
        host=host,
        overlap_rows=overlap_rows,
        ratios=ratios,
        auto_reduce=auto_reduce,
    )


def plan_halp_n(
    net: ConvNetGeom,
    secondaries: Sequence[str],
    host: str = E0,
    overlap_rows: int = 4,
    ratios: Sequence[float] | None = None,
    auto_reduce: bool = True,
) -> HALPPlan:
    """Build the N-way heterogeneous HALP partition.

    Per conv layer, K = N - 1 host zones of ``overlap_rows`` output rows are
    interleaved with N secondary segments whose sizes follow ``ratios``
    (default: equal).  Zone boundaries stay aligned to the strides of the
    pooling layers that follow before the next conv, so pools never cross a
    slot boundary; pool layers inherit the previous layer's boundaries divided
    by the stride.  Secondaries never exchange rows directly.  Layers too thin
    for every secondary first idle the smaller-ratio slots, then (with
    ``auto_reduce``) drop trailing secondaries from that depth on, the host
    absorbing their share in a widened tail zone; ``auto_reduce=False`` raises
    on any violation instead."""
    return plan_from_layout(
        plan_layout(
            net,
            secondaries,
            host=host,
            overlap_rows=overlap_rows,
            ratios=ratios,
            auto_reduce=auto_reduce,
        )
    )


def plan_halp_topology(
    net: ConvNetGeom,
    topology: "CollabTopology",
    overlap_rows: int = 4,
    ratios: Sequence[float] | None = None,
    auto_reduce: bool = True,
) -> HALPPlan:
    """HALP plan for a :class:`~repro_torch.core.topology.CollabTopology`.

    ``ratios`` defaults to the topology's compute-capacity weights (segment
    sizes proportional to effective FLOP/s)."""
    if ratios is None:
        ratios = topology.capacity_ratios()
    return plan_halp_n(
        net,
        secondaries=topology.secondaries,
        host=topology.host,
        overlap_rows=overlap_rows,
        ratios=ratios,
        auto_reduce=auto_reduce,
    )


def plan_even(net: ConvNetGeom, n: int, ratios: Sequence[float] | None = None) -> HALPPlan:
    """N-way contiguous split of every layer's output rows (workers
    ``w0..w{n-1}``, no host zones), the plan the spatial engine deploys.

    ``ratios`` weights the per-worker row shares (a capacity-weighted split
    for workers of unequal speed); the default is the uniform split.  Each
    worker's input rows follow from the exact receptive-field algebra, so any
    weighting is lossless."""
    ratios = _norm_ratios(n, ratios, "worker")
    names = tuple(f"w{j}" for j in range(n))
    sizes = net.sizes()
    parts = []
    for i, g in enumerate(net.layers):
        out = dict(zip(names, split_rows(sizes[i + 1], ratios)))
        inp = {
            es: Segment(*input_range_exact(seg.lo, seg.hi, g.k, g.s, g.p, sizes[i])) if seg else EMPTY
            for es, seg in out.items()
        }
        parts.append(LayerPartition(index=i, out=out, inp=inp))
    return HALPPlan(net=net, parts=tuple(parts), es_names=names)


def _reduce_caps(caps: list[int], exc: PlanInfeasible, conv_anchor: list[int]) -> bool:
    """Shrink the active-secondary cap at the first reducible layer the
    violation names; False when every candidate is already at one secondary."""
    for j in exc.reduce_at:
        if not 0 <= j < len(caps):
            continue
        j = conv_anchor[j]
        eff = min(caps[: j + 1])
        if eff > 1:
            caps[j] = eff - 1
            return True
    return False


def _slot_names(secondaries: tuple[str, ...], host: str) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """Slot names in row order (sec, zone, sec, ...) and their physical owners."""
    n_sec = len(secondaries)
    k_zones = n_sec - 1
    zone_names = (
        (host,) if k_zones == 1 else tuple(f"{host}#{j}" for j in range(k_zones))
    )
    slots: list[str] = []
    owners: list[str] = []
    for j, s in enumerate(secondaries):
        slots.append(s)
        owners.append(s)
        if j < k_zones:
            slots.append(zone_names[j])
            owners.append(host)
    return tuple(slots), tuple(owners)


@dataclass
class PlanLayout:
    """Integer skeleton of a HALP plan: slot boundaries + input ranges per layer.

    Slot ``p`` of layer ``i`` owns output rows ``bounds[i][p]+1 ..
    bounds[i][p+1]``; even positions are secondary segments, odd positions are
    host zones.  :func:`plan_from_layout` materialises it into a
    :class:`HALPPlan`.  ``signature`` fingerprints the *structure* of the
    job/message DAG the layout induces (which sends exist per secondary per
    layer) -- two layouts with equal signatures differ only in job
    durations, and the batched DES (``events.DagTemplate``) keys on it."""

    net: ConvNetGeom
    host: str
    secondaries: tuple[str, ...]
    overlap_rows: int
    ratios: tuple[float, ...]
    bounds: tuple[tuple[int, ...], ...]
    inp: tuple[tuple[tuple[int, int], ...], ...]
    slots: tuple[str, ...] = field(init=False)
    owners: tuple[str, ...] = field(init=False)

    def __post_init__(self) -> None:
        self.slots, self.owners = _slot_names(self.secondaries, self.host)
        self.n_slots = len(self.slots)
        self.n_layers = len(self.bounds)
        self.sec_pos = tuple(range(0, self.n_slots, 2))
        self.zone_pos = tuple(range(1, self.n_slots, 2))
        self._walked: tuple | None = None

    def walk(self) -> tuple:
        """One fused pass over the layout producing everything the batched
        DES evaluator needs, cached: ``(signature, init_rows, sec_rows_per_
        layer, zone_rows_per_layer, final_rows)``.

        The row lists follow the exact job order of the DAG builder's per-task
        blocks (``events._layout_quantities`` stitches them into the template
        parameter vector); the logic is the interval twin of
        ``events.sec_step`` / ``events.zone_step``, inlined for speed -- any
        divergence from those reference step functions is caught bit-exactly
        by the template build self-check."""
        if self._walked is not None:
            return self._walked
        bounds, inp = self.bounds, self.inp
        n_layers, n_slots = self.n_layers, self.n_slots
        sec_pos, zone_pos = self.sec_pos, self.zone_pos
        init_rows = tuple(
            max(0, inp[0][p][1] - inp[0][p][0] + 1) for p in sec_pos
        )
        sec_layers: list[tuple] = []
        zone_layers: list[tuple] = []
        sig_rows: list[tuple] = []
        if len(_WALK_LAYER_CACHE) > 8192:  # unbounded candidate streams
            _WALK_LAYER_CACHE.clear()
        for i in range(n_layers):
            b = bounds[i]
            last = i + 1 >= n_layers
            ninp = None if last else inp[i + 1]
            # layer quantities are a pure function of this layer's boundaries
            # and the next layer's input needs; candidates overlap heavily
            # (coordinate descent moves a few boundary rows per step), so the
            # cache short-circuits most layers of most candidates
            ckey = (b, ninp)
            cached = _WALK_LAYER_CACHE.get(ckey)
            if cached is not None:
                svals, zvals, sig_row = cached
                sec_layers.append(svals)
                zone_layers.append(zvals)
                sig_rows.append(sig_row)
                continue
            svals: list[float] = []
            sig_row: list[tuple] = []
            for p in sec_pos:
                own_lo, own_hi = b[p] + 1, b[p + 1]
                own = own_hi - own_lo + 1
                if last:
                    targets = ()
                    if own > 0 and n_slots > 1:
                        targets = ((p - 1 if p else p + 1, (own_lo, own_hi)),)
                    dep = own
                else:
                    adjacent = []
                    extra = []
                    for z in zone_pos:
                        # inline _message_iv(ninp[z], own, got)
                        need = ninp[z]
                        lo = max(need[0], own_lo)
                        hi = min(need[1], own_hi)
                        if lo > hi:
                            iv = EMPTY_IV
                        else:
                            got_lo, got_hi = b[z] + 1, b[z + 1]
                            p1, p2 = lo < got_lo, hi > got_hi
                            if p1 and p2:
                                raise AssertionError(
                                    "non-contiguous message; segment ordering violated"
                                )
                            if p1:
                                iv = (lo, min(hi, got_lo - 1))
                            elif p2:
                                iv = (max(lo, got_hi + 1), hi)
                            else:
                                iv = EMPTY_IV
                        if z == p - 1 or z == p + 1:
                            adjacent.append((z, iv))
                        elif iv != EMPTY_IV:
                            extra.append((z, iv))
                    targets = tuple(adjacent + extra)
                    dep = min(own, _union_iv_rows([iv for _, iv in targets]))
                svals.append(dep)
                for _z, iv in targets:
                    svals.append(max(0, iv[1] - iv[0] + 1))
                svals.append(own - dep)
                sig_row.append(tuple(z for z, _ in targets))
            zvals: list[float] = []
            for z in zone_pos:
                if last:
                    above = below = 0
                else:
                    zone_iv = (b[z] + 1, b[z + 1])
                    iva = _message_iv(ninp[z - 1], zone_iv, (b[z - 1] + 1, b[z]))
                    above = iva[1] - iva[0] + 1 if iva[0] <= iva[1] else 0
                    ivb = _message_iv(ninp[z + 1], zone_iv, (b[z + 1] + 1, b[z + 2]))
                    below = ivb[1] - ivb[0] + 1 if ivb[0] <= ivb[1] else 0
                zrows = b[z + 1] - b[z]
                zvals += [above, above, zrows - above, below]
            entry = (tuple(svals), tuple(zvals), tuple(sig_row))
            _WALK_LAYER_CACHE[ckey] = entry
            sec_layers.append(entry[0])
            zone_layers.append(entry[1])
            sig_rows.append(entry[2])
        lb = bounds[-1]
        final_rows = tuple(lb[p + 1] - lb[p] for p in sec_pos) + (1.0,)
        signature = (self.secondaries, tuple(sig_rows))
        self._walked = (signature, init_rows, sec_layers, zone_layers, final_rows)
        return self._walked

    @property
    def signature(self) -> tuple:
        return self.walk()[0]


def plan_layout(
    net: ConvNetGeom,
    secondaries: Sequence[str],
    host: str = E0,
    overlap_rows: int = 4,
    ratios: Sequence[float] | None = None,
    auto_reduce: bool = True,
) -> PlanLayout:
    """Compute the N-way HALP layout (validation + auto-reduction + invariant
    check, identical to :func:`plan_halp_n`, which materialises this result)."""
    secondaries = tuple(secondaries)
    n_sec = len(secondaries)
    if n_sec < 2:
        raise ValueError("HALP needs at least two secondaries around the host")
    if host in secondaries:
        raise ValueError(f"host {host!r} cannot also be a secondary")
    if ratios is None:
        ratios = [1.0 / n_sec] * n_sec
    if len(ratios) != n_sec:
        raise ValueError("need one ratio per secondary")
    total_ratio = sum(ratios)
    if total_ratio <= 0 or any(r < 0 for r in ratios):
        raise ValueError(f"ratios must be non-negative with a positive sum, got {ratios}")
    ratios = [r / total_ratio for r in ratios]
    for i, g in enumerate(net.layers):
        if g.kind == "attn":
            raise PlanInfeasible(
                i,
                f"layer {i} ({g.name}) is attention: every output row depends on "
                f"every input row, so no receptive-field row partition exists",
                reduce_at=(i,),
            )
    n_layers = len(net.layers)
    # a cap only changes the layout of a *conv* layer; pools inherit, so a
    # reduction aimed at a pool must land on the conv it inherits from
    conv_anchor: list[int] = []
    for i, g in enumerate(net.layers):
        conv_anchor.append(i if g.kind != "pool" or i == 0 else conv_anchor[i - 1])
    caps = [n_sec] * n_layers
    for _ in range(n_sec * n_layers + 1):
        try:
            layout = _build_layout(net, secondaries, host, overlap_rows, ratios, caps, auto_reduce)
            _check_layout(layout)
            return layout
        except PlanInfeasible as exc:
            if not auto_reduce or not _reduce_caps(caps, exc, conv_anchor):
                raise
    raise AssertionError("auto-reduce failed to converge")  # pragma: no cover


def _build_layout(
    net: ConvNetGeom,
    secondaries: tuple[str, ...],
    host: str,
    overlap_rows: int,
    ratios: Sequence[float],
    caps: Sequence[int],
    auto_reduce: bool,
) -> PlanLayout:
    n_sec = len(secondaries)
    n_slots = 2 * n_sec - 1
    sizes = net.sizes()
    bounds: list[tuple[int, ...]] = []
    inp: list[tuple[tuple[int, int], ...]] = []
    active = n_sec
    for i, g in enumerate(net.layers):
        o = sizes[i + 1]
        if auto_reduce:
            # monotone: a cap at any earlier layer (pools included) holds on
            active = min(active, caps[i])
        if g.kind == "pool":
            # pools inherit the previous layer's boundaries (divided by stride).
            prev = bounds[-1]
            bt = (0, *(prev[j] // g.s for j in range(1, n_slots)), o)
        else:
            align = _pool_alignment(net, i, o)
            if not auto_reduce:
                counts = _conv_slot_rows(o, overlap_rows, ratios, align)
            else:
                while True:
                    try:
                        counts = _reduced_slot_rows(o, overlap_rows, ratios, align, active)
                        break
                    except ValueError as err:
                        if active <= 1:
                            raise PlanInfeasible(
                                i,
                                f"layer {i} ({o} output rows): {err}; even a single "
                                f"active secondary does not fit -- use a larger input "
                                f"or run this layer on one ES",
                                reduce_at=(i,),
                            ) from err
                        active -= 1
            b = [0]
            for c in counts:
                b.append(b[-1] + c)
            bt = tuple(b)
        bounds.append(bt)
        # exact input rows per slot (input_range_exact, inlined: bounds are
        # valid by construction)
        inp.append(tuple(
            (max(bt[p] * g.s + 1 - g.p, 1), min((bt[p + 1] - 1) * g.s + g.k - g.p, sizes[i]))
            if bt[p + 1] > bt[p]
            else EMPTY_IV
            for p in range(n_slots)
        ))
    return PlanLayout(
        net=net,
        host=host,
        secondaries=secondaries,
        overlap_rows=overlap_rows,
        ratios=tuple(ratios),
        bounds=tuple(bounds),
        inp=tuple(inp),
    )


def plan_from_layout(layout: PlanLayout) -> HALPPlan:
    """Materialise a :class:`PlanLayout` into the full Segment-based plan."""
    parts: list[LayerPartition] = []
    for i in range(layout.n_layers):
        b = layout.bounds[i]
        out = {
            slot: Segment(b[p] + 1, b[p + 1]) for p, slot in enumerate(layout.slots)
        }
        inp = {
            slot: Segment(*layout.inp[i][p]) for p, slot in enumerate(layout.slots)
        }
        parts.append(LayerPartition(index=i, out=out, inp=inp))
    return HALPPlan(
        net=layout.net,
        parts=tuple(parts),
        es_names=layout.slots,
        host=layout.host,
        slot_owner=layout.owners,
    )


def _check_layout(layout: PlanLayout) -> None:
    """Enforce the message invariants of the scheme.

    * Secondaries never exchange rows directly (there is no
      secondary-secondary link).
    * Host-zone -> secondary messages must come from an adjacent slot.
    * Secondary -> host messages may target any zone, and rows moving between
      two host-owned zones never leave the host."""
    slots = layout.slots
    n_slots = layout.n_slots
    for i in range(layout.n_layers - 1):
        b = layout.bounds[i]
        ninp = layout.inp[i + 1]
        for pa in range(n_slots):
            a_host = pa % 2 == 1  # odd positions are host-owned zones
            own_lo, own_hi = b[pa] + 1, b[pa + 1]
            if own_lo > own_hi:
                continue  # empty source slot sends nothing
            for pb in range(n_slots):
                if pb == pa:
                    continue
                b_host = pb % 2 == 1
                if a_host and b_host:
                    continue  # zone-to-zone: host-local move
                if not a_host and b_host:
                    continue  # sec -> any host zone: direct uplink
                if abs(pa - pb) <= 1 and a_host != b_host:
                    continue  # adjacent host<->sec: the paper's boundary flow
                lo, hi = _message_iv(ninp[pb], (own_lo, own_hi), (b[pb] + 1, b[pb + 1]))
                if lo > hi:
                    continue
                if not a_host and not b_host:
                    raise PlanInfeasible(
                        i,
                        f"layer {i}: secondaries {slots[pa]} and {slots[pb]} would "
                        f"exchange rows {lo}..{hi} directly; widen the overlap zone, "
                        f"rebalance the segment ratios, or enable auto_reduce",
                        reduce_at=(i + 1, i),
                    )
                raise PlanInfeasible(
                    i,
                    f"layer {i}: zone {slots[pa]} would need to send rows "
                    f"{lo}..{hi} to non-adjacent secondary {slots[pb]}; widen "
                    f"the overlap zone or rebalance the segment ratios",
                    reduce_at=(i + 1, i),
                )


# ---------------------------------------------------------------------------
# Per-stage partitioning schemes (copied from the JAX planner)
#
# A plan may choose a scheme per **stage** (the layer groups between pooling
# boundaries, plus one stage per attention block):
#
# * ``halo_segment``    -- the receptive-field row split above.
# * ``non_penetrative`` -- output-channel splits: no overlap zones and no halo
#   edges.  Channel-local layers (pool/depthwise) keep their partition; dense
#   convs re-gather the full input through the host hub.
# * ``head_sequence``   -- attention stages: heads split across secondaries
#   (each head attends over the full token grid), the pointwise convs between
#   them split by token rows.  The only scheme that partitions attention.
# * ``host_solo``       -- implicit fallback: the host computes the stage alone.
#
# Non-halo schemes use a **hub model**: the host holds the full feature map at
# segment boundaries and relays every redistribution; it computes nothing
# inside hub segments.
# ---------------------------------------------------------------------------

SCHEME_HALO = "halo_segment"
SCHEME_NP = "non_penetrative"
SCHEME_HS = "head_sequence"
SCHEME_HOST = "host_solo"
SCHEMES = (SCHEME_HALO, SCHEME_NP, SCHEME_HS)


def _is_pointwise(g) -> bool:
    return g.kind == "conv" and g.k == 1 and g.s == 1 and g.p == 0


def stage_spans(net: ConvNetGeom) -> tuple[tuple[int, int], ...]:
    """Inclusive (start, stop) layer spans of the scheme stages.

    A new stage starts at layer 0, after every pooling layer, and at every
    attention layer (pointwise layers following an attention stay in its
    stage, so ViT blocks are one stage)."""
    starts = [
        i
        for i, g in enumerate(net.layers)
        if i == 0 or g.kind == "attn" or net.layers[i - 1].kind == "pool"
    ]
    stops = [s - 1 for s in starts[1:]] + [len(net.layers) - 1]
    return tuple(zip(starts, stops))


def _scheme_valid(net: ConvNetGeom, span: tuple[int, int], scheme: str) -> bool:
    layers = net.layers[span[0] : span[1] + 1]
    if scheme in (SCHEME_HALO, SCHEME_NP):
        return all(g.kind != "attn" for g in layers)
    if scheme == SCHEME_HS:
        return all(g.kind == "attn" or _is_pointwise(g) for g in layers)
    if scheme == SCHEME_HOST:
        return True
    raise ValueError(f"unknown partitioning scheme {scheme!r}")


def stage_scheme_options(
    net: ConvNetGeom, span: tuple[int, int], schemes: Sequence[str] = SCHEMES
) -> tuple[str, ...]:
    """Vocabulary members legal for one stage, in vocabulary order; stages no
    scheme can partition fall back to the host computing them alone."""
    opts = tuple(s for s in schemes if _scheme_valid(net, span, s))
    return opts or (SCHEME_HOST,)


def baseline_assignment(
    net: ConvNetGeom, schemes: Sequence[str] = SCHEMES
) -> tuple[str, ...]:
    """First legal vocabulary member per stage (halo-first under the default
    vocabulary)."""
    return tuple(
        stage_scheme_options(net, span, schemes)[0] for span in stage_spans(net)
    )


@dataclass(frozen=True)
class SchemeSegment:
    """A maximal run of consecutive same-scheme stages, planned as one unit."""

    scheme: str
    start: int  # first layer index (inclusive)
    stop: int  # last layer index (inclusive)
    stages: tuple[int, ...]  # stage indices fused into this segment


def fuse_assignment(
    spans: Sequence[tuple[int, int]], assignment: Sequence[str]
) -> tuple[SchemeSegment, ...]:
    if len(spans) != len(assignment):
        raise ValueError(
            f"need one scheme per stage: {len(assignment)} schemes, {len(spans)} stages"
        )
    segs: list[SchemeSegment] = []
    for idx, (span, sch) in enumerate(zip(spans, assignment)):
        if segs and segs[-1].scheme == sch:
            last = segs[-1]
            segs[-1] = SchemeSegment(sch, last.start, span[1], last.stages + (idx,))
        else:
            segs.append(SchemeSegment(sch, span[0], span[1], (idx,)))
    return tuple(segs)


@lru_cache(maxsize=512)
def _segment_subnet(net: ConvNetGeom, start: int, stop: int) -> ConvNetGeom:
    """The layers of one segment as a standalone geometry (head_flops = 0: the
    overall head runs once, after the whole net)."""
    sizes = net.sizes()
    return ConvNetGeom(
        name=f"{net.name}[{start}:{stop}]",
        in_rows=sizes[start],
        in_channels=net.layers[start].c_in,
        layers=net.layers[start : stop + 1],
        head_flops=0.0,
    )


def hub_segment_fracs(
    net: ConvNetGeom, seg: SchemeSegment, ratios: Sequence[float]
) -> tuple[tuple, tuple[float, ...]]:
    """Work fractions of one hub-relayed (non_penetrative / head_sequence)
    segment: per layer a ``(relay, up, down, cmp)`` entry -- ``relay`` says
    whether the layer redistributes through the host at all (it depends only
    on the layer kinds), and the tuples are per-secondary fractions of the
    layer's input uploaded to the host, the input downloaded from the host,
    and the layer's FLOPs computed -- plus the final per-secondary fractions
    of the last layer's output gathered back.

    Channel-local layers (pool/depthwise under NP; consecutive pointwise convs
    under HS) keep the previous partition (up = down = 0); a change of
    partition axis re-gathers through the host (dense convs and attention need
    the full input: down = 1 - held); at the segment's first layer the host
    already holds the full map (up = 0)."""
    n = len(ratios)
    sizes = net.sizes()
    zeros = (0.0,) * n
    held: tuple[float, ...] | None = None
    held_axis: str | None = None  # "channel" | "heads" | "rows"
    per_layer = []
    for i in range(seg.start, seg.stop + 1):
        g = net.layers[i]
        relay = True
        if seg.scheme == SCHEME_NP:
            counts = _split_counts(g.c_out, ratios)
            share = tuple(c / g.c_out for c in counts)
            if g.kind == "conv":  # dense: every filter needs the full input
                up = held if held is not None else zeros
                down = tuple(1.0 - h for h in (held or zeros))
            else:  # pool/depthwise: channel-local, partition carries over
                if held_axis == "channel":
                    relay, up, down = False, zeros, zeros
                else:
                    up, down = zeros, share
            held, held_axis = share, "channel"
        elif seg.scheme == SCHEME_HS:
            if g.kind == "attn":
                counts = _split_counts(g.heads, ratios)
                share = tuple(c / g.heads for c in counts)
                up = held if held is not None else zeros
                down = tuple(1.0 - h for h in (held or zeros))
                held, held_axis = share, "heads"
            else:  # pointwise conv: token-row split
                o = sizes[i + 1]
                counts = _split_counts(o, ratios)
                share = tuple(c / o for c in counts)
                if held_axis == "rows":
                    # same row partition carries over: transfer-free
                    relay, up, down = False, zeros, zeros
                elif held is None:
                    up, down = zeros, share
                else:  # scatter after a head split: upload heads, download rows
                    up, down = held, share
                held, held_axis = share, "rows"
        else:
            raise ValueError(f"{seg.scheme!r} is not a hub scheme")
        per_layer.append((relay, up, down, share))
    return tuple(per_layer), (held if held is not None else zeros)


@dataclass
class SchemeLayout:
    """Integer/fraction skeleton of a mixed-scheme plan (the scheme twin of
    :class:`PlanLayout`): per segment either a halo sub-layout or the hub
    fraction table."""

    net: ConvNetGeom
    host: str
    secondaries: tuple[str, ...]
    overlap_rows: int
    ratios: tuple[float, ...]
    assignment: tuple[str, ...]
    spans: tuple[tuple[int, int], ...]
    segments: tuple[SchemeSegment, ...]
    halo_layouts: tuple[PlanLayout | None, ...]  # parallel to segments
    hub_fracs: tuple  # parallel to segments; None for halo/host_solo segments

    @property
    def signature(self) -> tuple:
        """Structure fingerprint: two layouts with equal signatures induce the
        same job/message DAG and differ only in durations."""
        return (
            self.secondaries,
            tuple(
                (seg.scheme, seg.start, seg.stop, lay.signature if lay else None)
                for seg, lay in zip(self.segments, self.halo_layouts)
            ),
        )


def scheme_layout(
    net: ConvNetGeom,
    secondaries: Sequence[str],
    host: str = E0,
    overlap_rows: int = 4,
    ratios: Sequence[float] | None = None,
    assignment: Sequence[str] | None = None,
    schemes: Sequence[str] = SCHEMES,
    auto_reduce: bool = True,
) -> SchemeLayout:
    """Build the mixed-scheme layout for one per-stage scheme assignment.

    Raises :class:`PlanInfeasible` (via the halo sub-planner) when a halo
    segment cannot be realised; hub segments are always feasible."""
    secondaries = tuple(secondaries)
    if len(secondaries) < 2:
        raise ValueError("scheme plans need at least two secondaries around the host")
    if host in secondaries:
        raise ValueError(f"host {host!r} cannot also be a secondary")
    ratios = tuple(_norm_ratios(len(secondaries), ratios, "secondary"))
    spans = stage_spans(net)
    if assignment is None:
        assignment = baseline_assignment(net, schemes)
    assignment = tuple(assignment)
    for span, sch in zip(spans, assignment):
        if not _scheme_valid(net, span, sch):
            raise ValueError(
                f"scheme {sch!r} is not valid for stage {span} of {net.name}"
            )
    segments = fuse_assignment(spans, assignment)
    halo_layouts: list[PlanLayout | None] = []
    hub: list = []
    for seg in segments:
        if seg.scheme == SCHEME_HALO:
            sub = _segment_subnet(net, seg.start, seg.stop)
            halo_layouts.append(
                plan_layout(
                    sub,
                    secondaries,
                    host=host,
                    overlap_rows=overlap_rows,
                    ratios=ratios,
                    auto_reduce=auto_reduce,
                )
            )
            hub.append(None)
        elif seg.scheme == SCHEME_HOST:
            halo_layouts.append(None)
            hub.append(None)
        else:
            halo_layouts.append(None)
            hub.append(hub_segment_fracs(net, seg, ratios))
    return SchemeLayout(
        net=net,
        host=host,
        secondaries=secondaries,
        overlap_rows=overlap_rows,
        ratios=ratios,
        assignment=assignment,
        spans=spans,
        segments=segments,
        halo_layouts=tuple(halo_layouts),
        hub_fracs=tuple(hub),
    )


@dataclass(frozen=True)
class SchemePlan:
    """Materialised mixed-scheme plan: halo segments carry full
    :class:`HALPPlan`\\ s over their sub-net.
    :func:`repro_torch.spatial.run_plan` executes it scheme by scheme."""

    net: ConvNetGeom
    host: str
    secondaries: tuple[str, ...]
    ratios: tuple[float, ...]
    overlap_rows: int
    assignment: tuple[str, ...]
    spans: tuple[tuple[int, int], ...]
    segments: tuple[SchemeSegment, ...]
    halo_plans: tuple[HALPPlan | None, ...]  # parallel to segments


def plan_from_scheme_layout(layout: SchemeLayout) -> SchemePlan:
    return SchemePlan(
        net=layout.net,
        host=layout.host,
        secondaries=layout.secondaries,
        ratios=layout.ratios,
        overlap_rows=layout.overlap_rows,
        assignment=layout.assignment,
        spans=layout.spans,
        segments=layout.segments,
        halo_plans=tuple(
            plan_from_layout(lay) if lay is not None else None
            for lay in layout.halo_layouts
        ),
    )


def plan_scheme(
    net: ConvNetGeom,
    topology: "CollabTopology",
    overlap_rows: int = 4,
    ratios: Sequence[float] | None = None,
    assignment: Sequence[str] | None = None,
    schemes: Sequence[str] = SCHEMES,
    auto_reduce: bool = True,
) -> SchemePlan:
    """Mixed-scheme plan for a topology.  ``ratios`` defaults to capacity
    weights; ``assignment`` to the first legal vocabulary member per stage."""
    if ratios is None:
        ratios = topology.capacity_ratios()
    return plan_from_scheme_layout(
        scheme_layout(
            net,
            topology.secondaries,
            host=topology.host,
            overlap_rows=overlap_rows,
            ratios=ratios,
            assignment=assignment,
            schemes=schemes,
            auto_reduce=auto_reduce,
        )
    )


def _halo_plan_comm_bytes(plan: HALPPlan) -> list[float]:
    """Per-layer link bytes of a halo plan: initial input scatter (charged to
    the first layer), boundary messages, and the final merge (charged to the
    last layer).  Host-zone-to-host-zone moves are host-local (no link)."""
    net = plan.net
    sizes = net.sizes()
    out = [0.0] * len(net.layers)
    for s in plan.secondary_slots:
        seg = plan.parts[0].inp[s]
        out[0] += DTYPE_BYTES * seg.rows * sizes[0] * net.in_channels
    host = plan.host
    for i in range(len(net.layers)):
        for src in plan.es_names:
            for dst in plan.es_names:
                if src == dst:
                    continue
                if plan.owner_of(src) == host and plan.owner_of(dst) == host:
                    continue
                out[i] += plan.message_bytes(i, src, dst)
    return out


def comm_bytes_per_stage(plan: "HALPPlan | SchemePlan") -> list[float]:
    """Link bytes (host<->secondary, both directions) attributed to each stage
    of :func:`stage_spans`, for halo-only and mixed-scheme plans alike."""
    net = plan.net
    spans = stage_spans(net)
    stage_of = [0] * len(net.layers)
    for si, (lo, hi) in enumerate(spans):
        for i in range(lo, hi + 1):
            stage_of[i] = si
    out = [0.0] * len(spans)
    if isinstance(plan, HALPPlan):
        for i, b in enumerate(_halo_plan_comm_bytes(plan)):
            out[stage_of[i]] += b
        return out
    sizes = net.sizes()
    for seg, hp in zip(plan.segments, plan.halo_plans):
        if seg.scheme == SCHEME_HOST:
            continue
        if seg.scheme == SCHEME_HALO:
            for off, b in enumerate(_halo_plan_comm_bytes(hp)):
                out[stage_of[seg.start + off]] += b
            continue
        fracs, final = hub_segment_fracs(net, seg, plan.ratios)
        for off, (_relay, up, down, _cmp) in enumerate(fracs):
            i = seg.start + off
            g = net.layers[i]
            in_bytes = DTYPE_BYTES * sizes[i] * sizes[i] * g.c_in
            out[stage_of[i]] += in_bytes * (sum(up) + sum(down))
        g = net.layers[seg.stop]
        out_bytes = DTYPE_BYTES * sizes[seg.stop + 1] * sizes[seg.stop + 1] * g.c_out
        out[stage_of[seg.stop]] += out_bytes * sum(final)
    return out
