"""Receptive-field arithmetic for segment-based partitioning (paper §II, eqs. 1-4, 8-9).

The port's own copy of ``repro/core/rf.py``: the layer geometry
(convolution, pooling and the attention layer of the ViT geometry), the
cumulative receptive-field chain of eqs. (1)-(4) and two range calculators.

* ``input_range_exact`` -- exact sliding-window interval algebra (used by the
  partitioner and the plan executor).  For output rows ``[o_lo, o_hi]``
  (1-indexed, inclusive) of a layer with kernel ``k``, stride ``s``, padding
  ``p``: ``in_lo = (o_lo-1)*s + 1 - p`` and ``in_hi = (o_hi-1)*s + k - p``,
  clipped to the valid input rows (out-of-range rows are the zero padding).
* ``input_range_paper`` -- the paper's eqs. (8)-(9) verbatim, driven by the
  chain of eqs. (2)-(4).  Its end formula uses ``(OE+1)*j``, slightly
  conservative for strided layers: the exact range lies inside it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Sequence

__all__ = [
    "LayerGeom",
    "RFState",
    "out_size",
    "rf_chain",
    "input_range_exact",
    "input_range_paper",
    "propagate_range",
    "attn",
    "conv",
    "pool",
]


@dataclass(frozen=True)
class LayerGeom:
    """Geometry of one layer: sliding-window (conv/pool/depthwise) or attention.

    Row/column symmetric (the paper partitions along rows of square tensors).
    ``c_in``/``c_out`` are carried for FLOP accounting.  An ``attn`` layer can
    never be row-split; the planner refuses it."""

    name: str
    kind: str  # "conv" | "pool" | "depthwise" | "attn"
    k: int
    s: int = 1
    p: int = 0
    c_in: int = 1
    c_out: int = 1
    heads: int = 1

    def flops_per_out_row(self, out_width: int) -> float:
        """FLOPs to produce one output row (2 FLOPs per MAC), paper convention."""
        if self.kind == "conv":
            return 2.0 * self.k * self.k * self.c_in * self.c_out * out_width
        if self.kind == "depthwise":
            return 2.0 * self.k * self.k * self.c_out * out_width
        if self.kind == "attn":
            d, tokens = self.c_in, out_width * out_width
            return out_width * (6.0 * d * d + 4.0 * tokens * d)
        # pooling: one compare/add per window element
        return float(self.k * self.k * self.c_out * out_width)


def conv(name: str, c_in: int, c_out: int, k: int = 3, s: int = 1, p: int = 1) -> LayerGeom:
    return LayerGeom(name=name, kind="conv", k=k, s=s, p=p, c_in=c_in, c_out=c_out)


def attn(name: str, d: int, heads: int) -> LayerGeom:
    """Multi-head self-attention over the spatial token grid (d = model width)."""
    if d % heads:
        raise ValueError(f"model width {d} not divisible by {heads} heads")
    return LayerGeom(name=name, kind="attn", k=1, s=1, p=0, c_in=d, c_out=d, heads=heads)


def pool(name: str, c: int, k: int = 2, s: int = 2, p: int = 0) -> LayerGeom:
    return LayerGeom(name=name, kind="pool", k=k, s=s, p=p, c_in=c, c_out=c)


def out_size(i: int, k: int, s: int, p: int) -> int:
    """Paper eq. (1): O = floor((I + 2p - k)/s) + 1."""
    o = (i + 2 * p - k) // s + 1
    if o < 1:
        raise ValueError(f"non-positive output size for I={i}, k={k}, s={s}, p={p}")
    return o


def input_range_exact(
    o_lo: int, o_hi: int, k: int, s: int, p: int, in_rows: int
) -> tuple[int, int]:
    """Exact input rows (1-indexed inclusive, clipped) needed for output rows [o_lo, o_hi]."""
    if not 1 <= o_lo <= o_hi:
        raise ValueError(f"bad output range [{o_lo}, {o_hi}]")
    lo = (o_lo - 1) * s + 1 - p
    hi = (o_hi - 1) * s + k - p
    return max(lo, 1), min(hi, in_rows)


@dataclass(frozen=True)
class RFState:
    """Cumulative receptive-field state after a layer (paper eqs. 1-4).

    ``sigma`` is the (possibly fractional) input-row index of the centre of the
    receptive field of the *first* output row; kept exact as a Fraction.
    """

    out: int  # O_{g_i}: output rows
    jump: int  # j_{g_i}: cumulative stride
    rf: int  # r_{g_i}: receptive-field extent in input rows
    sigma: Fraction  # σ_{g_i}: centre row of first output's receptive field

    @staticmethod
    def for_input(in_rows: int) -> "RFState":
        # identity "layer 0": each input row is its own receptive field.
        return RFState(out=in_rows, jump=1, rf=1, sigma=Fraction(1))


def _advance(state: RFState, g: LayerGeom) -> RFState:
    """Apply eqs. (1)-(4) for one layer."""
    o = out_size(state.out, g.k, g.s, g.p)
    j = state.jump * g.s  # eq. (2)
    r = state.rf + (g.k - 1) * state.jump  # eq. (3)
    sigma = state.sigma + (Fraction(g.k - 1, 2) - g.p) * state.jump  # eq. (4)
    return RFState(out=o, jump=j, rf=r, sigma=sigma)


def rf_chain(in_rows: int, layers: Sequence[LayerGeom]) -> list[RFState]:
    """Cumulative receptive-field states for every layer (index i == after layer i)."""
    states = []
    st = RFState.for_input(in_rows)
    for g in layers:
        st = _advance(st, g)
        states.append(st)
    return states


def input_range_paper(
    o_lo: int, o_hi: int, state: RFState, in_rows: int
) -> tuple[int, int]:
    """Paper eqs. (8)-(9) verbatim, with the cumulative state of the layer.

    Maps output rows of layer g_i to rows of the *original input* of the chain
    whose state is ``state``.  For a single layer pass a chain of length 1.
    """
    half = (state.rf - 1) // 2  # floor((r-1)/2)
    is_ = state.sigma + (o_lo - 1) * state.jump - half  # eq. (8)
    ie = state.sigma + (o_hi + 1) * state.jump - half  # eq. (9)
    return max(math.floor(is_), 1), min(math.ceil(ie), in_rows)


def propagate_range(
    layers: Sequence[LayerGeom],
    in_rows: int,
    layer_idx: int,
    o_range: tuple[int, int],
) -> list[tuple[int, int]]:
    """Back-propagate an output-row range of layer ``layer_idx`` through the chain.

    Returns one (lo, hi) per level: index 0 is the range on the original input,
    index i (1-based) is the range on the output of layer i-1 ... ending with
    ``o_range`` itself at index ``layer_idx + 1``.  Exact algebra (lossless).
    """
    sizes = [in_rows]
    for g in layers:
        sizes.append(out_size(sizes[-1], g.k, g.s, g.p))
    lo, hi = o_range
    if not 1 <= lo <= hi <= sizes[layer_idx + 1]:
        raise ValueError(f"range {o_range} invalid for layer {layer_idx} (O={sizes[layer_idx + 1]})")
    ranges = [o_range]
    for i in range(layer_idx, -1, -1):
        g = layers[i]
        lo, hi = input_range_exact(lo, hi, g.k, g.s, g.p, sizes[i])
        ranges.append((lo, hi))
    ranges.reverse()
    return ranges
