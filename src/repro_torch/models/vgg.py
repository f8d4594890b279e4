"""VGG-16 (Simonyan & Zisserman, ICLR'15) -- the paper's evaluation model.

Twin of ``repro/models/vgg.py``: the feature extractor is an explicit layer
list aligned with :meth:`VGGConfig.geom`, so the HALP plan executor
(:func:`repro_torch.spatial.run_plan`) drives it layer by layer; the
classifier head runs after the final merge.  NHWC activations throughout.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.nets import ConvNetGeom
from ..core.rf import LayerGeom, conv as geom_conv, pool as geom_pool
from .common import Params, conv_params, dense_params
from .layers import conv2d, dense, max_pool, relu


@dataclass(frozen=True)
class VGGConfig:
    name: str = "vgg16"
    img_res: int = 224
    in_channels: int = 3
    num_classes: int = 1000
    width_mult: float = 1.0  # reduced configs for CPU tests
    blocks: tuple[tuple[int, int], ...] = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
    fc_dims: tuple[int, ...] = (4096, 4096)

    def widths(self) -> list[tuple[int, int]]:
        return [(reps, max(8, int(c * self.width_mult))) for reps, c in self.blocks]

    def geom(self) -> ConvNetGeom:
        layers: list[LayerGeom] = []
        c_in = self.in_channels
        for b, (reps, c_out) in enumerate(self.widths(), start=1):
            for r in range(1, reps + 1):
                layers.append(geom_conv(f"conv{b}_{r}", c_in, c_out, k=3, s=1, p=1))
                c_in = c_out
            layers.append(geom_pool(f"pool{b}", c_in))
        final_rows = self.img_res // (2 ** len(self.blocks))
        c_last = self.widths()[-1][1]
        dims = [c_last * final_rows * final_rows, *self.fc_dims, self.num_classes]
        head = sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))
        return ConvNetGeom(
            name=self.name,
            in_rows=self.img_res,
            in_channels=self.in_channels,
            layers=tuple(layers),
            head_flops=head,
        )


# The configurations of repro/configs/vgg16.py.
FULL = VGGConfig()
SMOKE = VGGConfig(img_res=64, width_mult=0.125, num_classes=10)


def init(gen: torch.Generator, cfg: VGGConfig) -> Params:
    """Random float32 parameters from ``gen``, on the generator's device."""
    feats: list[Params] = []
    c_in = cfg.in_channels
    for reps, c_out in cfg.widths():
        for _ in range(reps):
            feats.append(conv_params(gen, 3, c_in, c_out))
            c_in = c_out
        feats.append({})  # pool layer: no params (keeps indices aligned w/ geom)
    final_rows = cfg.img_res // (2 ** len(cfg.blocks))
    dims = [c_in * final_rows * final_rows, *cfg.fc_dims, cfg.num_classes]
    head = [dense_params(gen, a, b) for a, b in zip(dims[:-1], dims[1:])]
    return {"features": feats, "head": head}


def apply_layer(params: Params, geom: LayerGeom, x: torch.Tensor) -> torch.Tensor:
    """One feature layer on (a slice of) the input -- 'VALID' padded.

    The caller supplies exactly the input rows the receptive field requires
    (plus explicit zero padding at true tensor edges), so the layer itself uses
    VALID padding.  The single-device reference and every distributed
    execution path share this primitive."""
    if geom.kind == "pool":
        return max_pool(x, k=geom.k, s=geom.s)
    y = conv2d(x, params, stride=geom.s, padding="VALID")
    return relu(y)


def features(params: Params, cfg: VGGConfig, x: torch.Tensor) -> torch.Tensor:
    geom = cfg.geom()
    for p, g in zip(params["features"], geom.layers):
        if g.kind != "pool" and g.p:
            x = F.pad(x, (0, 0, g.p, g.p, g.p, g.p))  # NHWC: (C, W, H) pairs
        x = apply_layer(p, g, x)
    return x


def head(params: Params, x: torch.Tensor) -> torch.Tensor:
    # flatten NHWC in H, W, C order, as the JAX package does, so the
    # [H*W*C, 4096] weights carry over unchanged
    x = x.reshape(x.shape[0], -1)
    hs = params["head"]
    for p in hs[:-1]:
        x = relu(dense(x, p))
    return dense(x, hs[-1])


def apply(params: Params, cfg: VGGConfig, x: torch.Tensor) -> torch.Tensor:
    """Full forward: feature extractor + classifier logits."""
    return head(params, features(params, cfg, x))
