"""ViT-L/16 as a *spatial* layer stack runnable by the plan executor.

Twin of ``repro/models/vit_spatial.py``: a patch-embedding conv followed by
blocks of [multi-head self-attention, 1x1 out-projection, 1x1 MLP-up, 1x1
MLP-down] over the H/patch x W/patch token grid, NHWC, aligned layer for layer
with :func:`repro_torch.core.nets.vit_l16_geom`, so a mixed-scheme plan
(:func:`repro_torch.core.plan_scheme`) drives it through
:func:`repro_torch.spatial.run_plan`:

* the 1x1 convs are row-splittable (head_sequence's token-row shards) and
  channel-splittable (non_penetrative's filter shards);
* the attention layer is head-splittable: Q/K/V projections are stored
  head-major in their last axis, so slicing every param's last axis by a head
  range yields exactly that shard of the concatenated attention output.

The convs go through the direct-conv kernel's wrapper and the attention
through the flash-attention kernel's; the Q/K/V products stay ``x @ w``, as
the JAX package left them to XLA.  Residual adds, layernorms and the softmax
head's centering are omitted, and each conv is followed by a ReLU, exactly as
in the JAX model.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.nets import ConvNetGeom, vit_l16_geom
from ..core.rf import LayerGeom
from ..kernels.attention import flash_attention
from .common import Params, conv_params, dense_params
from .layers import conv2d, dense, global_avg_pool, relu

__all__ = ["ViTSpatialConfig", "FULL", "SMOKE", "init", "apply_layer", "features", "head", "apply"]


@dataclass(frozen=True)
class ViTSpatialConfig:
    name: str = "vit_l16"
    img_res: int = 224
    patch: int = 16
    in_channels: int = 3
    n_blocks: int = 24
    d: int = 1024
    heads: int = 16
    d_ff: int = 4096
    num_classes: int = 1000

    def geom(self) -> ConvNetGeom:
        return vit_l16_geom(
            in_rows=self.img_res,
            patch=self.patch,
            n_blocks=self.n_blocks,
            d=self.d,
            heads=self.heads,
            d_ff=self.d_ff,
            num_classes=self.num_classes,
            name=self.name,
        )


# Full-width ViT-L/16, and the widths of repro/configs/vit_l16.py SMOKE.
FULL = ViTSpatialConfig()
SMOKE = ViTSpatialConfig(name="vit_l16_smoke", img_res=64, patch=8, n_blocks=2, d=64,
                         heads=4, d_ff=128, num_classes=10)


def init(gen: torch.Generator, cfg: ViTSpatialConfig) -> Params:
    """Random float32 parameters from ``gen``, on the generator's device."""
    feats: list[Params] = [conv_params(gen, cfg.patch, cfg.in_channels, cfg.d)]
    for _ in range(cfg.n_blocks):
        feats.append({n: dense_params(gen, cfg.d, cfg.d) for n in ("q", "k", "v")})
        feats.append(conv_params(gen, 1, cfg.d, cfg.d))
        feats.append(conv_params(gen, 1, cfg.d, cfg.d_ff))
        feats.append(conv_params(gen, 1, cfg.d_ff, cfg.d))
    return {"features": feats, "head": [dense_params(gen, cfg.d, cfg.num_classes)]}


def _mhsa(params: Params, geom: LayerGeom, x: torch.Tensor) -> torch.Tensor:
    """Self-attention over the token grid; the local head count comes from the
    param shapes, so head-range-sliced params (the head_sequence scheme's
    shards) run through the same code as the full layer."""
    b, h, w, _ = x.shape
    dh = geom.c_in // geom.heads
    s = h * w
    tokens = x.reshape(b, s, -1)
    q, k, v = (dense(tokens, params[n]) for n in ("q", "k", "v"))
    n_local = q.shape[-1] // dh
    # [B, T, H, D] -> [B, H, T, D] as views: the kernel reads them through strides
    q, k, v = (t.reshape(b, s, n_local, dh).transpose(1, 2) for t in (q, k, v))
    y = flash_attention(q, k, v, causal=False)
    return y.transpose(1, 2).reshape(b, h, w, n_local * dh)


def apply_layer(params: Params, geom: LayerGeom, x: torch.Tensor) -> torch.Tensor:
    """One feature layer on (a slice of) the input -- 'VALID' padded, the same
    primitive contract as :func:`repro_torch.models.vgg.apply_layer`."""
    if geom.kind == "attn":
        return _mhsa(params, geom, x)
    return relu(conv2d(x, params, stride=geom.s, padding="VALID"))


def features(params: Params, cfg: ViTSpatialConfig, x: torch.Tensor) -> torch.Tensor:
    geom = cfg.geom()
    for p, g in zip(params["features"], geom.layers):
        if g.kind != "pool" and g.p:
            x = F.pad(x, (0, 0, g.p, g.p, g.p, g.p))  # NHWC: (C, W, H) pairs
        x = apply_layer(p, g, x)
    return x


def head(params: Params, x: torch.Tensor) -> torch.Tensor:
    return dense(global_avg_pool(x), params["head"][0])


def apply(params: Params, cfg: ViTSpatialConfig, x: torch.Tensor) -> torch.Tensor:
    """Full forward: patch embed + transformer blocks + pooled classifier."""
    return head(params, features(params, cfg, x))
