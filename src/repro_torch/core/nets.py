"""Network geometry for the planner: the port's copy of ``ConvNetGeom``,
``vgg16_geom`` and ``vit_l16_geom`` from ``repro/core/nets.py`` (analytical layer geometry, FLOP
and byte accounting, kept apart from the runnable models in ``repro_torch.models``)."""
from __future__ import annotations

from dataclasses import dataclass

from .rf import LayerGeom, attn, conv, out_size, pool

__all__ = ["ConvNetGeom", "vgg16_geom", "vit_l16_geom", "DTYPE_BYTES"]

DTYPE_BYTES = 4  # paper assumes float32 tensors (eq. 10 note)


@dataclass(frozen=True)
class ConvNetGeom:
    """A conv backbone: sliding-window layers + a fused 'head' FLOP count.

    The head runs after the final merge on the host (paper §IV.A), so only its
    FLOP count matters to the schedule."""

    name: str
    in_rows: int  # input height == width (square inputs, paper §II)
    in_channels: int
    layers: tuple[LayerGeom, ...]
    head_flops: float = 0.0

    def sizes(self) -> list[int]:
        """Spatial size before each layer; sizes()[i] is the input rows of layer i,
        and sizes()[-1] the final feature rows.  Memoised per instance; the
        returned list is a fresh copy."""
        cached = self.__dict__.get("_sizes")
        if cached is None:
            out = [self.in_rows]
            for g in self.layers:
                out.append(out_size(out[-1], g.k, g.s, g.p))
            cached = tuple(out)
            object.__setattr__(self, "_sizes", cached)
        return list(cached)

    def layer_flops(self, i: int, rows: int | None = None) -> float:
        """FLOPs of layer i restricted to ``rows`` output rows (None = all)."""
        g = self.layers[i]
        o = self.sizes()[i + 1]
        r = o if rows is None else rows
        return g.flops_per_out_row(out_width=o) * r

    def total_flops(self) -> float:
        return sum(self.layer_flops(i) for i in range(len(self.layers))) + self.head_flops

    def feature_bytes(self, i: int, rows: int | None = None) -> float:
        """Bytes of the *output* tensor of layer i restricted to ``rows`` rows."""
        g = self.layers[i]
        o = self.sizes()[i + 1]
        r = o if rows is None else rows
        return DTYPE_BYTES * r * o * g.c_out


def vgg16_geom(in_rows: int = 224) -> ConvNetGeom:
    """VGG-16 (Simonyan & Zisserman, ICLR'15) -- the paper's evaluation model.

    13 conv layers (3x3, s1, p1) in 5 blocks separated by 2x2/s2 max-pools,
    followed by FC 25088->4096->4096->1000 (the head).
    """
    cfg = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
    layers: list[LayerGeom] = []
    c_in = 3
    for b, (reps, c_out) in enumerate(cfg, start=1):
        for r in range(1, reps + 1):
            layers.append(conv(f"conv{b}_{r}", c_in, c_out, k=3, s=1, p=1))
            c_in = c_out
        layers.append(pool(f"pool{b}", c_in))
    fc = [(512 * 7 * 7, 4096), (4096, 4096), (4096, 1000)]
    head = sum(2.0 * a * b for a, b in fc)
    return ConvNetGeom(
        name="vgg16", in_rows=in_rows, in_channels=3, layers=tuple(layers), head_flops=head
    )


def vit_l16_geom(
    in_rows: int = 224,
    patch: int = 16,
    n_blocks: int = 24,
    d: int = 1024,
    heads: int = 16,
    d_ff: int = 4096,
    num_classes: int = 1000,
    name: str = "vit_l16",
) -> ConvNetGeom:
    """ViT-L/16 as a spatial geometry: a patch-embedding conv (k=s=patch)
    followed by ``n_blocks`` of [attn, 1x1 out-projection, 1x1 MLP-up, 1x1
    MLP-down] over the H/patch x W/patch token grid, plus a classifier head.

    Residual adds and layernorms are left out, as in the JAX geometry; the
    runnable counterpart ``repro_torch.models.vit_spatial`` matches it layer
    for layer.  The attention layers leave no row partition: the net runs
    under the head_sequence scheme."""
    layers: list[LayerGeom] = [conv("patch", 3, d, k=patch, s=patch, p=0)]
    for b in range(n_blocks):
        layers.append(attn(f"attn{b}", d, heads))
        layers.append(conv(f"proj{b}", d, d, k=1, s=1, p=0))
        layers.append(conv(f"mlp{b}_up", d, d_ff, k=1, s=1, p=0))
        layers.append(conv(f"mlp{b}_dn", d_ff, d, k=1, s=1, p=0))
    head = 2.0 * d * num_classes
    return ConvNetGeom(
        name=name, in_rows=in_rows, in_channels=3, layers=tuple(layers), head_flops=head
    )
