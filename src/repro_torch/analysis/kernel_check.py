"""Shape-only check of the fused halo-conv path (twin of
``repro/analysis/kernel_check.py``).

``spatial.halo.conv2d_spatial(engine="fused")`` routes a geometry to the
halo-conv kernel K2 iff ``_fused_supported`` says so; a divergence between
that predicate and what ``halo_conv2d_cuda`` accepts surfaces as an error in
the middle of a sharded forward (or as a forfeited fused path).  This
analyzer catches the divergence from shapes alone:

* **Support agreement** (``kernel.support``): for a geometry, the predicate's
  claim must match whether the wrapper accepts it.  The probe is
  ``kernels/halo_conv/ops.py: probe``, the wrapper's own argument check run
  on ``meta`` tensors (no data, no device, no launch), so the predicate is
  held against exactly the code that refuses on both devices.  Both
  directions are findings.
* **Output shape** (``kernel.shape``): an accepted geometry must produce
  exactly ``[B, Hs // s, W_out, Cout]`` with ``W_out = (W + 2p - k) // s + 1``
  -- the shard's contribution to eq. 7's row partition.

The JAX analyzer's third check, ``kernel.tiles``, forces a tile height that
does not divide the shard's output rows.  K2 takes no tile height: its M
tiles are masked inside the kernel, and its ragged tail is held against the
plain version on the card (``chip_smoke.py`` phase 3b) and through the
emulated kernel on the CPU.  So a geometry with ``n_out >= 2`` counts one
check fewer here than in the JAX package.

:func:`check_plan_kernels` walks a plan and probes every distinct conv
geometry x shard height it would deploy.
"""
from __future__ import annotations

import torch

from ..core.partition import SCHEME_HALO, HALPPlan, SchemePlan
from ..kernels.halo_conv.ops import probe
from ..spatial.halo import _fused_supported
from .findings import Report

__all__ = ["check_kernel_geometry", "check_plan_kernels", "geometry_shapes", "plan_kernel_calls"]


def geometry_shapes(
    k: int,
    s: int = 1,
    p: int = 0,
    *,
    groups: int = 1,
    c_in: int = 8,
    c_out: int = 8,
    hs: int = 8,
    w: int = 16,
    batch: int = 1,
) -> dict:
    """Shapes of one geometry's K2 call: ``x`` (the shard), ``top`` and
    ``bottom`` (the halos, ``lo = p`` and ``hi = k - p - s`` rows, ``None``
    when empty), ``weights`` (HWIO; ``[k, k, 1, C]`` depthwise) and ``out``,
    the ``[B, Hs // s, W_out, Cout]`` the shard's rows must come to."""
    lo, hi = p, max(0, k - p - s)
    return dict(
        x=(batch, hs, w, c_in),
        top=(batch, lo, w, c_in) if lo else None,
        bottom=(batch, hi, w, c_in) if hi else None,
        weights=(k, k, 1 if groups > 1 else c_in, c_out),
        out=(batch, hs // s, (w + 2 * p - k) // s + 1, c_out),
    )


def _probe(shapes: dict, s: int, p: int, groups: int) -> tuple[tuple | None, Exception | None]:
    """K2's output shape for operands of ``shapes`` (``geometry_shapes``)
    by the probe, or ``(None, the wrapper's refusal)``."""
    x, top, bot, wts = (None if shapes[name] is None else torch.empty(shapes[name], device="meta")
                        for name in ("x", "top", "bottom", "weights"))
    try:
        return tuple(probe(x, top, bot, wts, stride=s, padding=p, groups=groups)), None
    except (ValueError, TypeError) as exc:  # the wrapper's refusals
        return None, exc


def check_kernel_geometry(
    k: int,
    s: int = 1,
    p: int = 0,
    *,
    groups: int = 1,
    c_in: int = 8,
    c_out: int = 8,
    hs: int = 8,
    w: int = 16,
    batch: int = 1,
    supported: bool | None = None,
) -> Report:
    """Verify predicate/kernel agreement for one geometry by the shape probe.

    ``supported`` overrides the ``_fused_supported`` claim (mutation tests
    use it to prove a wrong predicate is caught)."""
    rep = Report()
    if hs % s:
        raise ValueError(f"shard rows {hs} not divisible by stride {s} (caller contract)")
    where = f"k={k} s={s} p={p} groups={groups} c={c_in}->{c_out} hs={hs} w={w}"
    shapes = geometry_shapes(k, s, p, groups=groups, c_in=c_in, c_out=c_out, hs=hs, w=w, batch=batch)
    wts = torch.empty(shapes["weights"], device="meta")
    claim = supported if supported is not None else _fused_supported(k, s, p, groups, c_in, wts, w)

    rep.tick()
    out, err = _probe(shapes, s, p, groups)
    accepted = out is not None

    if claim and not accepted:
        rep.add(
            "kernel.support",
            where,
            f"_fused_supported claims the fused kernel handles this geometry "
            f"but halo_conv2d_cuda refuses it: {type(err).__name__}: {err}",
        )
        return rep
    if not claim and accepted:
        rep.add(
            "kernel.support",
            where,
            "halo_conv2d_cuda accepts this geometry but _fused_supported rejects "
            "it: the fused path is forfeited for a supported shape",
        )
    if not accepted:
        return rep

    rep.tick()
    if out != shapes["out"]:
        rep.add(
            "kernel.shape",
            where,
            f"fused kernel output shape {out} != expected "
            f"[B, Hs//s, W_out, Cout] = {shapes['out']}",
        )
    return rep


def _plan_geometries(plan: HALPPlan) -> set[tuple]:
    """Distinct (k, s, p, groups, c_in, c_out, hs, w) the plan would deploy."""
    geoms: set[tuple] = set()
    sizes = plan.net.sizes()
    for i, g in enumerate(plan.net.layers):
        if g.kind not in ("conv", "depthwise"):
            continue
        groups = g.c_in if g.kind == "depthwise" else 1
        width = sizes[i]  # square maps: input width == input rows
        for slot in plan.es_names:
            seg = plan.parts[i].out.get(slot)
            if not seg:
                continue
            hs = seg.rows * g.s  # aligned shard: hs input rows per output row
            geoms.add((g.k, g.s, g.p, groups, g.c_in, g.c_out, hs, width))
    return geoms


def plan_kernel_calls(plan: HALPPlan, batch: int = 1) -> dict[tuple, dict | None]:
    """Every distinct conv geometry ``(k, s, p, groups, c_in, c_out, hs, w)``
    a HALP plan deploys (the ones :func:`check_plan_kernels` probes), mapped
    to the operand shapes of its K2 call (:func:`geometry_shapes`, ``out``
    the probe's output shape) where the probe accepts it, else to ``None``:
    what a caller launches to hold the probe against the kernel."""
    calls: dict[tuple, dict | None] = {}
    for geom in sorted(_plan_geometries(plan)):
        k, s, p, groups, c_in, c_out, hs, w = geom
        shapes = geometry_shapes(k, s, p, groups=groups, c_in=c_in, c_out=c_out, hs=hs, w=w, batch=batch)
        out, _ = _probe(shapes, s, p, groups)
        calls[geom] = None if out is None else dict(shapes, out=out)
    return calls


def check_plan_kernels(plan) -> Report:
    """Probe every conv geometry x shard height a plan deploys.

    A finding here means deploying the plan through the fused engine would
    either fail mid-forward (support divergence) or shard a layer the kernel
    cannot express."""
    rep = Report()
    if isinstance(plan, SchemePlan):
        for seg, sub in zip(plan.segments, plan.halo_plans):
            if seg.scheme == SCHEME_HALO and sub is not None:
                rep.extend(check_plan_kernels(sub))
        return rep
    if not isinstance(plan, HALPPlan):
        rep.add("plan.type", type(plan).__name__, "not a HALPPlan / SchemePlan")
        return rep
    for k, s, p, groups, c_in, c_out, hs, w in sorted(_plan_geometries(plan)):
        rep.extend(
            check_kernel_geometry(
                k, s, p, groups=groups, c_in=c_in, c_out=c_out, hs=hs, w=w
            )
        )
    return rep
