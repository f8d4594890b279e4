"""Spatial parallelism over height shards with receptive-field-exact halo
exchange (twin of ``repro/spatial/halo.py``, the SPMD form of HALP).

The image height is cut into ``n`` shards.  Each conv layer computes a shard's
rows after the thin halo its receptive field needs arrives from the
neighbours (``lo = p`` rows from the shard above, ``hi = k - p - s`` from the
shard below).  Every function takes and returns the list of shards this
process holds; a :class:`~repro_torch.spatial.comm.Comm` moves the halos
(``LocalComm``: every shard in one process on one card; ``DistComm``: one
shard per rank).  Edge shards receive zeros, the conv's zero padding.

Two schedules (``overlap``), as in the JAX package: exchange then one VALID
conv over the extended slab, or the HALP split into top-boundary, interior
and bottom-boundary convs, where the interior needs no remote row.  Two
engines:

* ``engine="direct"`` (JAX ``"lax"``) -- the convs run through the direct-conv
  kernel K1 (:func:`~repro_torch.kernels.conv2d.conv2d_cuda`, its plain
  version on the CPU);
* ``engine="fused"`` (JAX ``"pallas"``) -- one launch of the HALP-fused
  kernel K2 per shard (:func:`~repro_torch.kernels.halo_conv.halo_conv2d_cuda`),
  which reads the shard and both halos in place; geometries it cannot express
  take the direct engine.

Capacity-weighted shards (``heights=...``): shard ``j`` holds ``heights[j]``
valid rows top-aligned in a ``max(heights)``-row block, and every row past the
valid region is zero (:func:`to_padded_shards` builds the layout; every
weighted op keeps the invariant by zeroing its output past the valid rows).
Halo donations come from each shard's *valid* edge, the bottom one at row
``heights[j] - lo``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..core.nets import ConvNetGeom
from ..core.partition import _min_one_unit, _norm_ratios, _split_counts
from ..kernels.conv2d import conv2d_cuda
from ..kernels.halo_conv import halo_conv2d_cuda
from ..models.layers import max_pool
from .comm import Comm, LocalComm

__all__ = [
    "halo_sizes",
    "exchange_halos",
    "conv2d_spatial",
    "max_pool_spatial",
    "features_spatial",
    "shard_heights",
    "plan_shard_heights",
    "spatial_alignment",
    "to_padded_shards",
    "merge_padded_shards",
]

ENGINES = ("direct", "fused")


def halo_sizes(k: int, s: int, p: int) -> tuple[int, int]:
    """Rows needed from the neighbour above / below for an aligned shard."""
    lo, hi = p, k - p - s
    if lo < 0 or lo >= k or hi >= k:
        raise ValueError(f"unsupported geometry k={k} s={s} p={p}")
    return lo, max(0, hi)


def _check_halo_fits(hs: int, lo: int, hi: int) -> None:
    """A neighbour can only donate rows it owns: a halo taller than the shard
    would need rows from two shards away, so fail instead of shipping a
    truncated (shifted) donation."""
    if lo > hs or hi > hs:
        raise ValueError(
            f"halo exceeds shard height: need lo={lo}/hi={hi} rows from the "
            f"neighbouring shards but each shard holds only {hs} rows; use "
            f"fewer/taller shards (or run this layer unsharded)"
        )


# ---------------------------------------------------------------------------
# capacity-weighted shard layout
# ---------------------------------------------------------------------------


def shard_heights(
    total: int, n: int, ratios: Sequence[float] | None = None, align: int = 1
) -> tuple[int, ...]:
    """Capacity-weighted shard heights: ``n`` positive row counts summing to
    ``total``, each a multiple of ``align`` (the product of the strides the
    deployment steps through, so every later layer keeps per-shard stride
    alignment), shares within one ``align`` unit of the ratio split."""
    if total % align:
        raise ValueError(f"total rows {total} not divisible by alignment {align}")
    units = total // align
    if units < n:
        raise ValueError(f"cannot give {n} shards at least {align} rows each from {total}")
    counts = _min_one_unit(_split_counts(units, _norm_ratios(n, ratios, "shard")), units)
    return tuple(c * align for c in counts)


def spatial_alignment(net: ConvNetGeom) -> int:
    """Product of all layer strides of ``net``: the ``align`` that keeps
    weighted shard heights stride-divisible at every depth."""
    align = 1
    for g in net.layers:
        align *= g.s
    return align


def plan_shard_heights(plan, align: int = 1) -> tuple[int, ...]:
    """Input-shard heights deploying an N-way ``plan_even(ratios=...)`` plan:
    the plan's first-layer row shares (its capacity weighting), re-quantised
    to ``align``."""
    rows = [plan.parts[0].out[es].rows for es in plan.es_names]
    return shard_heights(plan.net.in_rows, len(rows), ratios=rows, align=align)


def to_padded_shards(x: torch.Tensor, heights: Sequence[int]) -> list[torch.Tensor]:
    """Cut a global [B, H, ...] tensor (H == sum(heights)) into the padded
    weighted-shard layout: ``n`` blocks of ``max(heights)`` rows, block ``j``
    holding its ``heights[j]`` rows top-aligned and zeros below.  The blocks
    concatenated are the JAX package's [B, n * max(heights), ...] layout."""
    heights = tuple(int(h) for h in heights)
    if x.shape[1] != sum(heights):
        raise ValueError(f"rows {x.shape[1]} != sum of shard heights {sum(heights)}")
    hmax = max(heights)
    blocks, off = [], 0
    for h in heights:
        blk = x[:, off : off + h]
        if h < hmax:
            blk = torch.cat([blk, blk.new_zeros((blk.shape[0], hmax - h, *blk.shape[2:]))], dim=1)
        blocks.append(blk.contiguous())
        off += h
    return blocks


def merge_padded_shards(blocks: Sequence[torch.Tensor], heights: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`to_padded_shards`: the valid rows of every block,
    concatenated (``heights`` are the *output* heights of the layer stack,
    e.g. the input heights divided by the total stride)."""
    heights = tuple(int(h) for h in heights)
    hmax = max(heights)
    if len(blocks) != len(heights) or any(b.shape[1] != hmax for b in blocks):
        raise ValueError(
            f"rows {[b.shape[1] for b in blocks]} are not {len(heights)} blocks of {hmax} padded rows"
        )
    return torch.cat([b[:, :h] for b, h in zip(blocks, heights)], dim=1)


def _heights_setup(heights, comm: Comm, lo: int, hi: int, s: int):
    """Validate a weighted layout against the shard count and the geometry;
    returns the heights and the valid height of each local shard."""
    heights = tuple(int(h) for h in heights)
    if any(h <= 0 for h in heights):
        raise ValueError(f"shard heights must be positive, got {heights}")
    if s > 1 and any(h % s for h in heights):
        raise ValueError(f"shard heights {heights} not all divisible by stride {s}")
    _check_halo_fits(min(heights), lo, hi)
    if len(heights) != comm.n:
        raise ValueError(f"got {len(heights)} shard heights for {comm.n} shards")
    return heights, [heights[j] for j in comm.indices]


def _weighted_ext(x, top, bot, lo, hi, hs_j):
    """[top halo; x; bottom halo] in the weighted layout: the bottom halo is
    spliced at row ``lo + hs_j`` (right below the valid region); rows between
    it and the block's end stay zero."""
    ext = torch.cat([top, x], dim=1) if lo else x
    if hi:
        ext = torch.cat([ext, torch.zeros_like(bot)], dim=1)
        ext[:, lo + hs_j : lo + hs_j + hi] = bot
    return ext


def _mask_rows(y: torch.Tensor, o_j: int) -> torch.Tensor:
    """Zero the rows past the shard's valid output height (the layout
    invariant), in place: ``y`` is always a tensor the caller just made."""
    y[:, o_j:] = 0
    return y


def _wpad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Zero-pad the width (NHWC) by ``p`` columns on each side."""
    return F.pad(x, (0, 0, p, p)) if p else x


def _local(xs, comm: Comm | None) -> tuple[list[torch.Tensor], Comm]:
    """The local shards as a list, and the comm (all shards local by default)."""
    xs = list(xs)
    comm = comm if comm is not None else LocalComm(len(xs), xs[0].device)
    if len(xs) != len(comm.indices):
        raise ValueError(f"{len(xs)} shards for a comm holding {len(comm.indices)} locally")
    if len({tuple(x.shape) for x in xs}) != 1:
        raise ValueError(f"shards differ in shape: {[tuple(x.shape) for x in xs]}")
    return xs, comm


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------


def exchange_halos(
    xs: Sequence[torch.Tensor], lo: int, hi: int, comm: Comm | None = None,
    heights: Sequence[int] | None = None,
) -> list[torch.Tensor]:
    """Each shard extended with ``lo`` rows from above and ``hi`` from below.

    Edge shards receive zeros.  Raises when a shard is too thin to donate the
    halo.  With ``heights`` (capacity-weighted layout) the donations come from
    each shard's valid edge and the bottom halo lands at row
    ``lo + heights[j]`` of the returned block (zeros in between)."""
    xs, comm = _local(xs, comm)
    if heights is not None:
        heights, hs_js = _heights_setup(heights, comm, lo, hi, 1)
        if xs[0].shape[1] != max(heights):
            raise ValueError(f"block height {xs[0].shape[1]} != max shard height {max(heights)}")
        tops, bots = _shift_halos(xs, lo, hi, comm, hs_js)
        return [_weighted_ext(x, t, b, lo, hi, h) for x, t, b, h in zip(xs, tops, bots, hs_js)]
    _check_halo_fits(xs[0].shape[1], lo, hi)
    if not lo and not hi:
        return xs
    tops, bots = _shift_halos(xs, lo, hi, comm)
    return [torch.cat([q for q in (t, x, b) if q is not None], dim=1)
            for x, t, b in zip(xs, tops, bots)]


def _shift_halos(xs, lo, hi, comm: Comm, valid: Sequence[int] | None = None):
    """Each shard's top halo (the last ``lo`` rows of the shard above) and
    bottom halo (the first ``hi`` rows of the shard below); zeros at the
    edges.  With ``valid`` (the weighted layout's valid heights) the top
    donation is the last ``lo`` *valid* rows, starting at ``valid[j] - lo``.
    The JAX package's overlap schedule gets the same halos from wrapping
    perms masked at the edges."""
    ends = valid if valid is not None else [x.shape[1] for x in xs]
    tops = bots = [None] * len(xs)
    if lo:
        tops = comm.shift([x[:, h - lo : h] for x, h in zip(xs, ends)], 1)
    if hi:
        bots = comm.shift([x[:, :hi] for x in xs], -1)
    return tops, bots


def _conv_valid(x, params, s, groups=1):
    """VALID conv through the direct-conv kernel K1 (bias in its f32 sum)."""
    return conv2d_cuda(x, params["w"], params.get("b"), stride=s, padding=0, groups=groups)


def _fused_supported(k: int, s: int, p: int, groups: int, c: int, wts, w: int | None = None) -> bool:
    """Which geometries the fused kernel K2 takes (counterpart of the JAX
    package's ``_pallas_supported``): exact halos (p <= k - s), groups either
    trivial or depthwise, and -- given the shard width ``w`` -- a positive
    output width (``w + 2p >= k``)."""
    if k - p - s < 0:
        return False
    if w is not None and w + 2 * p < k:
        return False
    return groups == 1 or (groups == c == wts.shape[-1] and wts.shape[2] == 1)


def conv2d_spatial(
    xs: Sequence[torch.Tensor],
    params,
    k: int,
    s: int = 1,
    p: int = 0,
    *,
    comm: Comm | None = None,
    overlap: bool = True,
    groups: int = 1,
    engine: str = "direct",
    heights: Sequence[int] | None = None,
) -> list[torch.Tensor]:
    """Height-sharded conv: each local shard's output rows.

    ``xs`` are the local shards [B, Hs, W, C] (``comm`` defaults to all of
    them in this process).  The shard height must be a multiple of ``s``; the
    width uses ordinary SAME padding.  ``engine="fused"`` runs one K2 launch
    per shard (interior rows never read a halo); geometries K2 cannot express
    take the direct engine.  ``heights`` switches to the capacity-weighted
    padded layout (module docstring)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use 'direct' or 'fused'")
    xs, comm = _local(xs, comm)
    if heights is not None:
        return _conv2d_spatial_weighted(xs, params, k, s, p, comm, overlap, groups, engine, heights)
    b, hs, w, c = xs[0].shape
    if hs % s:
        raise ValueError(f"shard rows {hs} not divisible by stride {s}")
    lo, hi = halo_sizes(k, s, p)

    if engine == "fused" and _fused_supported(k, s, p, groups, c, params["w"], w):
        # one kernel per shard, reading the halos where they lie
        _check_halo_fits(hs, lo, hi)
        tops, bots = _shift_halos(xs, lo, hi, comm)
        return [halo_conv2d_cuda(x, t, bt, params["w"], params.get("b"),
                                 stride=s, padding=p, groups=groups)
                for x, t, bt in zip(xs, tops, bots)]

    # width padding; the height padding is the edge shards' zero halos
    xs = [_wpad(x, p) for x in xs]

    if not overlap or (lo == 0 and hi == 0):
        return [_conv_valid(e, params, s, groups)[:, : hs // s]
                for e in exchange_halos(xs, lo, hi, comm)]

    # HALP schedule: halos first, then the interior rows (which read no halo)
    # and the boundary rows.  (xs are already width-padded, so the halos
    # carry the width padding too.)
    _check_halo_fits(hs, lo, hi)
    tops, bots = _shift_halos(xs, lo, hi, comm)
    # output row t reads extended rows [t*s - lo, t*s - lo + k); interior rows
    # touch no halo
    nrows = hs // s
    t_lo = -(-lo // s)  # ceil(lo / s)
    t_hi = (hs + lo - k) // s
    out = []
    for x, top, bot in zip(xs, tops, bots):
        if t_hi < t_lo:  # shard too thin for an interior: plain exchanged conv
            ext = torch.cat([q for q in (top, x, bot) if q is not None], dim=1)
            out.append(_conv_valid(ext, params, s, groups)[:, :nrows])
            continue
        pieces = []
        if t_lo > 0:  # top boundary rows 0..t_lo-1 need the top halo
            slab = torch.cat([top, x[:, : (t_lo - 1) * s - lo + k]], dim=1)
            pieces.append(_conv_valid(slab, params, s, groups)[:, :t_lo])
        pieces.append(_conv_valid(x[:, t_lo * s - lo : t_hi * s - lo + k], params, s, groups))
        if t_hi + 1 < nrows:  # bottom boundary rows
            slab = x[:, (t_hi + 1) * s - lo :]
            if bot is not None:
                slab = torch.cat([slab, bot], dim=1)
            pieces.append(_conv_valid(slab, params, s, groups)[:, : nrows - t_hi - 1])
        out.append(torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0])
    return out


def _conv2d_spatial_weighted(xs, params, k, s, p, comm, overlap, groups, engine, heights):
    """Capacity-weighted conv over padded blocks (see module docstring)."""
    b, hmax, w, c = xs[0].shape
    lo, hi = halo_sizes(k, s, p)
    heights, hs_js = _heights_setup(heights, comm, lo, hi, s)
    if hmax != max(heights):
        raise ValueError(f"block height {hmax} != max shard height {max(heights)}")
    o_max = hmax // s
    wts, bias = params["w"], params.get("b")

    # halos are exchanged from the unpadded shards, before anything else
    tops, bots = _shift_halos(xs, lo, hi, comm, hs_js)

    if engine == "fused" and _fused_supported(k, s, p, groups, c, wts, w):
        n_fix = -(-hi // s)  # valid output rows whose window crosses the bottom edge
        fix_up = hi and min(heights) >= n_fix * s + lo
        out = []
        for x, top, bot, hs_j in zip(xs, tops, bots, hs_js):
            o_j = hs_j // s
            if fix_up:
                # Overlapped bottom halo: K2 reads zeros below the block (its
                # bottom operand is absent, so never materialised, and the
                # rows below the valid region are the layout's zeros); then a
                # thin fix-up conv, the only reader of the bottom halo,
                # overwrites the last n_fix valid rows.  K2 computes the
                # block's o_max rows; the JAX package's zero-padded slab
                # gives the same rows and slices them off.
                y = halo_conv2d_cuda(x, top, None, wts, bias, stride=s, padding=p,
                                     groups=groups, hi=hi)
                slab = torch.cat([x[:, hs_j - n_fix * s - lo : hs_j], bot], dim=1)
                y[:, o_j - n_fix : o_j] = _conv_valid(_wpad(slab, p), params, s, groups)
                out.append(_mask_rows(y, o_j))
                continue
            # Shards too thin to source the fix-up slab (or hi == 0): the
            # bottom halo is spliced in at row hs_j before the kernel.
            if hi:
                pad_rows = hi + (-(hmax + hi)) % s
                x = torch.cat([x, x.new_zeros((b, pad_rows, w, c))], dim=1)
                x[:, hs_j : hs_j + hi] = bot
            y = halo_conv2d_cuda(x, top, None, wts, bias, stride=s, padding=p,
                                 groups=groups, hi=hi)
            out.append(_mask_rows(y[:, :o_max], o_j))
        return out

    xws = [_wpad(x, p) for x in xs]
    topws = [_wpad(t, p) if t is not None else None for t in tops]
    botws = [_wpad(bt, p) if bt is not None else None for bt in bots]
    t_lo = -(-lo // s)  # ceil(lo / s)
    t_hi = (min(heights) + lo - k) // s  # interior rows valid on EVERY shard
    out = []
    for xw, topw, botw, hs_j in zip(xws, topws, botws, hs_js):
        ext = _weighted_ext(xw, topw, botw, lo, hi, hs_j)
        o_j = hs_j // s
        if not overlap or (lo == 0 and hi == 0) or t_hi < t_lo:
            out.append(_mask_rows(_conv_valid(ext, params, s, groups)[:, :o_max], o_j))
            continue
        # HALP schedule, weighted: the interior slab is bounded by the
        # thinnest shard; rows past it come off the spliced ext buffer
        pieces = []
        if t_lo > 0:
            slab = torch.cat([topw, xw[:, : (t_lo - 1) * s - lo + k]], dim=1)
            pieces.append(_conv_valid(slab, params, s, groups)[:, :t_lo])
        pieces.append(_conv_valid(xw[:, t_lo * s - lo : t_hi * s - lo + k], params, s, groups))
        if t_hi + 1 < o_max:
            pieces.append(_conv_valid(ext[:, (t_hi + 1) * s :], params, s, groups)[:, : o_max - t_hi - 1])
        y = torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]
        out.append(_mask_rows(y, o_j))
    return out


def max_pool_spatial(
    xs: Sequence[torch.Tensor], k: int = 2, s: int = 2, *, comm: Comm | None = None,
    heights: Sequence[int] | None = None,
) -> list[torch.Tensor]:
    """Height-sharded max pool (aligned shards need no halo when k == s).

    With ``heights`` it runs on the capacity-weighted padded layout: the
    output heights are the input heights divided by the stride."""
    xs, comm = _local(xs, comm)
    hs = xs[0].shape[1]
    lo, hi = halo_sizes(k, s, 0)
    if heights is not None:
        heights, hs_js = _heights_setup(heights, comm, lo, hi, s)
        if hs != max(heights):
            raise ValueError(f"block height {hs} != max shard height {max(heights)}")
        tops, bots = _shift_halos(xs, lo, hi, comm, hs_js)
        return [_mask_rows(max_pool(_weighted_ext(x, t, b, lo, hi, h), k, s)[:, : hs // s], h // s)
                for x, t, b, h in zip(xs, tops, bots, hs_js)]
    if hs % s:
        raise ValueError("shard not aligned to pool stride")
    return [max_pool(e, k, s)[:, : hs // s] for e in exchange_halos(xs, lo, hi, comm)]


def features_spatial(
    feats: Sequence, net: ConvNetGeom, xs: Sequence[torch.Tensor], *,
    comm: Comm | None = None, heights: Sequence[int] | None = None,
    engine: str = "direct", overlap: bool = True,
) -> list[torch.Tensor]:
    """A VGG-style feature stack (each conv followed by ReLU, pools between)
    over height shards: the layers of ``net`` with parameters ``feats``, as
    the JAX package's multi-device checks drive ``conv2d_spatial`` and
    ``max_pool_spatial``.  With ``heights`` the shards are in the padded
    weighted layout and stay so; the output heights are ``heights`` divided
    by :func:`spatial_alignment`."""
    for params, g in zip(feats, net.layers):
        if g.kind == "pool":
            xs = max_pool_spatial(xs, g.k, g.s, comm=comm, heights=heights)
        else:
            xs = conv2d_spatial(xs, params, g.k, g.s, g.p, comm=comm, overlap=overlap,
                                engine=engine, heights=heights)
            xs = [torch.relu_(x) for x in xs]
        if heights is not None:
            heights = tuple(h // g.s for h in heights)
    return xs
