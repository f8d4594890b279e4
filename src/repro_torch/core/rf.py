"""Receptive-field arithmetic for segment-based partitioning (paper §II, eqs. 1, 8-9).

The port's own copy of the part of ``repro/core/rf.py`` the planners and
the plan executor need: the layer geometry (convolution, pooling and the
attention layer of the ViT geometry) and the exact input-row range of a range
of output rows.  For output rows ``[o_lo, o_hi]`` (1-indexed, inclusive)
of a layer with kernel ``k``, stride ``s``, padding ``p``:
``in_lo = (o_lo-1)*s + 1 - p`` and ``in_hi = (o_hi-1)*s + k - p``, clipped to
the valid input rows (out-of-range rows are the zero padding).
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["LayerGeom", "out_size", "input_range_exact", "attn", "conv", "pool"]


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
