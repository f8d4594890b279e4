"""Execute a HALP or mixed-scheme plan segment by segment (twin of
``repro/spatial/partition_apply.py``).

Each slot's feature rows are materialised separately, and the input of every
layer segment is rebuilt strictly from (a) rows the slot computed itself and
(b) the inter-slot messages the plan prescribes.  If the plan's messages were
insufficient, reconstruction fails loudly, so equality with the single-device
forward proves both the receptive-field partitioning and the message algebra.
A :class:`~repro_torch.core.partition.SchemePlan` runs each segment under its
own scheme: halo segments through the HALP executor, hub segments
(non_penetrative, head_sequence, host_solo) from exactly the slice of
parameters and input each secondary's scheme prescribes.

Runs on one device: this is the semantic model of the collaboration, with the
slots' work issued one after another on the current stream.  ``verify=True``
checks the plan statically (:func:`repro_torch.analysis.check_plan`) before
any tensor is touched.
"""
from __future__ import annotations

import time
from typing import Callable

import torch
import torch.nn.functional as F

from ..core.nets import ConvNetGeom
from ..core.partition import (
    SCHEME_HALO,
    SCHEME_HOST,
    SCHEME_HS,
    SCHEME_NP,
    HALPPlan,
    SchemePlan,
    Segment,
    _split_counts,
)
from ..models.common import tree_map

__all__ = ["run_plan", "segment_forward"]


def _raw_range(o_lo: int, o_hi: int, k: int, s: int, p: int) -> tuple[int, int]:
    """Unclipped input range (may extend into the zero padding)."""
    return (o_lo - 1) * s + 1 - p, (o_hi - 1) * s + k - p


def segment_forward(apply_layer, params, geom, x_rows: torch.Tensor, seg: Segment,
                    avail: Segment, in_rows: int) -> torch.Tensor:
    """Compute output rows ``seg`` of one layer given input rows ``avail``
    (a contiguous, 1-indexed slice of the layer input held in ``x_rows``)."""
    raw_lo, raw_hi = _raw_range(seg.lo, seg.hi, geom.k, geom.s, geom.p)
    lo, hi = max(raw_lo, 1), min(raw_hi, in_rows)
    if not (avail.lo <= lo and hi <= avail.hi):
        raise AssertionError(
            f"insufficient rows: need {lo}..{hi}, have {avail.lo}..{avail.hi}"
        )
    sl = x_rows[:, lo - avail.lo : hi - avail.lo + 1]
    pad_top = lo - raw_lo
    pad_bot = raw_hi - hi
    padw = geom.p if geom.kind != "pool" else 0
    if pad_top or pad_bot or padw:
        # NHWC: F.pad's pairs run from the last axis back -- (C, W, H)
        sl = F.pad(sl, (0, 0, padw, padw, pad_top, pad_bot))
    y = apply_layer(params, geom, sl)
    if y.shape[1] != seg.rows:
        raise AssertionError(f"segment produced {y.shape[1]} rows, plan says {seg}")
    return y


def run_plan(
    plan: HALPPlan | SchemePlan,
    layer_params: list,
    apply_layer,
    x: torch.Tensor,
    time_observer: Callable[[str, float, float], None] | None = None,
    verify: bool = False,
) -> torch.Tensor:
    """Run the full plan; returns the merged final feature map (host side).

    ``apply_layer(params, geom, x_slice)`` must be the VALID-padding layer
    primitive (``repro_torch.models.vgg.apply_layer`` or compatible).

    ``time_observer(es, flops, elapsed_s)``: when set, every slot's segments
    run synchronously (``torch.cuda.synchronize`` on a CUDA tensor, once
    before the first slot too, so its sample does not absorb work still
    queued ahead of the call) and, once per call, the observer receives that
    slot's total FLOP count and measured wall-clock.

    ``plan`` may also be a :class:`~repro_torch.core.partition.SchemePlan`:
    each segment then executes under its own scheme (halo segments recurse
    through this very function on their sub-plan) and the observer receives
    samples attributed to physical ES names across all segments.

    ``verify=True`` statically verifies the plan
    (:func:`repro_torch.analysis.check_plan` -- coverage, receptive-field
    halos, message legality) before touching any tensor, raising
    :class:`repro_torch.analysis.AnalysisError` instead of producing a
    silently wrong feature map from a corrupted plan: no kernel is launched
    for a plan that fails."""
    if verify:
        from ..analysis import check_plan  # here: the analysis package imports spatial.halo

        check_plan(plan).raise_if_failed("run_plan")
    if time_observer and x.is_cuda:
        torch.cuda.synchronize(x.device)
    if isinstance(plan, SchemePlan):
        return _run_scheme_plan(plan, layer_params, apply_layer, x, time_observer)
    net: ConvNetGeom = plan.net
    sizes = net.sizes()
    es_names = plan.es_names

    # initial distribution: each ES receives its eq.-(10) image slice
    avail: dict[str, tuple[Segment, torch.Tensor | None]] = {}
    for es in es_names:
        seg = plan.parts[0].inp[es]
        avail[es] = (seg, x[:, seg.lo - 1 : seg.hi])

    flops_acc = {es: 0.0 for es in es_names}
    secs_acc = {es: 0.0 for es in es_names}

    outs: dict[str, torch.Tensor | None] = {}
    for i, g in enumerate(net.layers):
        part = plan.parts[i]
        outs = {}
        for es in es_names:
            if not part.out[es]:
                outs[es] = None
                continue
            t0 = time.perf_counter() if time_observer else 0.0
            y = segment_forward(
                apply_layer, layer_params[i], g, avail[es][1], part.out[es],
                avail[es][0], sizes[i],
            )
            if time_observer:
                if y.is_cuda:
                    torch.cuda.synchronize(y.device)
                secs_acc[es] += time.perf_counter() - t0
                flops_acc[es] += net.layer_flops(i, part.out[es].rows)
            outs[es] = y
        if i + 1 == len(net.layers):
            break
        # message exchange: every ES's next-layer input = own rows + messages
        new_avail = {}
        for dst in es_names:
            pieces: list[tuple[Segment, torch.Tensor]] = []
            own = part.out[dst]
            if own:
                pieces.append((own, outs[dst]))
            for src in es_names:
                seg = plan.message(i, src, dst)
                if seg:
                    src_seg = part.out[src]
                    sl = outs[src][:, seg.lo - src_seg.lo : seg.hi - src_seg.lo + 1]
                    pieces.append((seg, sl))
            if not pieces:  # ES owns no rows at this depth (tiny feature map)
                new_avail[dst] = (Segment(1, 0), None)
                continue
            pieces.sort(key=lambda t: t[0].lo)
            for (a, _), (b, _) in zip(pieces, pieces[1:]):
                if b.lo != a.hi + 1:
                    raise AssertionError(f"non-contiguous input for {dst} at layer {i}")
            seg_all = Segment(pieces[0][0].lo, pieces[-1][0].hi)
            new_avail[dst] = (seg_all, torch.cat([t[1] for t in pieces], dim=1))
        avail = new_avail

    if time_observer:
        for es in es_names:
            if flops_acc[es] > 0 and secs_acc[es] > 0:
                time_observer(es, flops_acc[es], secs_acc[es])

    # final merge on the host (paper: sub-outputs -> FL input)
    ordered = sorted(es_names, key=lambda es: plan.parts[-1].out[es].lo)
    return torch.cat([outs[es] for es in ordered if plan.parts[-1].out[es]], dim=1)


def _slice_last_axis(params, lo: int, hi: int):
    """Every tensor leaf's last axis restricted to ``[lo, hi)`` -- the shared
    shard selector for output-channel splits (conv ``w``/``b``) and head-major
    Q/K/V splits (slicing ``[lo*dh, hi*dh)`` picks whole heads).  The leaves
    are views."""
    return tree_map(lambda a: a[..., lo:hi], params)


def _filter_slice(params, lo: int, hi: int):
    """:func:`_slice_last_axis` copied to contiguous leaves, once per call:
    the conv kernel takes dense weights, and an HWIO slice of the output
    channels is not."""
    return tree_map(torch.Tensor.contiguous, _slice_last_axis(params, lo, hi))


def _bounds(counts: list[int]) -> list[int]:
    out = [0]
    for c in counts:
        out.append(out[-1] + c)
    return out


def _run_scheme_plan(
    plan: SchemePlan,
    layer_params: list,
    apply_layer,
    x: torch.Tensor,
    time_observer: Callable[[str, float, float], None] | None,
) -> torch.Tensor:
    """Execute a mixed-scheme plan segment by segment (hub model).

    The host holds the full feature map at every segment boundary.  Halo
    segments recurse through :func:`run_plan` on their sub-plan; hub segments
    materialise each secondary's shard from exactly the slice of parameters
    and input its scheme prescribes -- a non-penetrative secondary sees only
    its filter slice, a head/sequence secondary its head or token-row range --
    and concatenation along the split axis rebuilds the layer output."""
    net: ConvNetGeom = plan.net
    sizes = net.sizes()
    host = plan.host
    all_es = (*plan.secondaries, host)
    flops_acc = {es: 0.0 for es in all_es}
    secs_acc = {es: 0.0 for es in all_es}

    def acc(es: str, fl: float, dt: float) -> None:
        flops_acc[es] += fl
        secs_acc[es] += dt

    def timed(es: str, fl: float, fn):
        if time_observer is None:
            return fn()
        t0 = time.perf_counter()
        y = fn()
        if y.is_cuda:
            torch.cuda.synchronize(y.device)
        acc(es, fl, time.perf_counter() - t0)
        return y

    for seg, hp in zip(plan.segments, plan.halo_plans):
        if seg.scheme == SCHEME_HALO:
            sub_obs = (
                (lambda slot, fl, dt, _hp=hp: acc(_hp.owner_of(slot), fl, dt))
                if time_observer
                else None
            )
            x = run_plan(hp, layer_params[seg.start : seg.stop + 1], apply_layer, x,
                         time_observer=sub_obs)
            continue
        for i in range(seg.start, seg.stop + 1):
            g = net.layers[i]
            avail = Segment(1, sizes[i])
            full_out = Segment(1, sizes[i + 1])
            if seg.scheme == SCHEME_HOST:
                x = timed(host, net.layer_flops(i), lambda: segment_forward(
                    apply_layer, layer_params[i], g, x, full_out, avail, sizes[i]))
                continue
            pieces: list[torch.Tensor] = []
            if seg.scheme == SCHEME_NP:
                b = _bounds(_split_counts(g.c_out, plan.ratios))
                for j, es in enumerate(plan.secondaries):
                    lo, hi = b[j], b[j + 1]
                    if lo == hi:
                        continue
                    frac = (hi - lo) / g.c_out
                    p = _filter_slice(layer_params[i], lo, hi) if layer_params[i] else layer_params[i]
                    # dense conv: full input, a slice of the filters;
                    # channel-local (pool/depthwise): a slice of the channels
                    xin = x if g.kind == "conv" else x[..., lo:hi]
                    pieces.append(timed(es, net.layer_flops(i) * frac, lambda: segment_forward(
                        apply_layer, p, g, xin, full_out, avail, sizes[i])))
                x = torch.cat(pieces, dim=-1)
            elif seg.scheme == SCHEME_HS:
                if g.kind == "attn":
                    dh = g.c_in // g.heads
                    b = _bounds(_split_counts(g.heads, plan.ratios))
                    for j, es in enumerate(plan.secondaries):
                        lo, hi = b[j] * dh, b[j + 1] * dh
                        if lo == hi:
                            continue
                        frac = (b[j + 1] - b[j]) / g.heads
                        pieces.append(timed(es, net.layer_flops(i) * frac, lambda: apply_layer(
                            _slice_last_axis(layer_params[i], lo, hi), g, x)))
                    x = torch.cat(pieces, dim=-1)
                else:
                    b = _bounds(_split_counts(sizes[i + 1], plan.ratios))
                    for j, es in enumerate(plan.secondaries):
                        rows = Segment(b[j] + 1, b[j + 1])
                        if not rows:
                            continue
                        pieces.append(timed(es, net.layer_flops(i, rows.rows), lambda: segment_forward(
                            apply_layer, layer_params[i], g, x, rows, avail, sizes[i])))
                    x = torch.cat(pieces, dim=1)
            else:
                raise AssertionError(f"unknown scheme {seg.scheme!r}")

    if time_observer:
        for es in all_es:
            if flops_acc[es] > 0 and secs_acc[es] > 0:
                time_observer(es, flops_acc[es], secs_acc[es])
    return x
