"""ConvNeXt (Liu et al., arXiv:2201.03545) -- convnext-b (twin of
``repro/models/convnext.py``).

Every conv goes to K1: the k = s = 4 stem and the k = s = 2 downsamples its
dense route, the 7x7 depthwise convs its depthwise branch.  JAX scans the
blocks of a stage of depth >= 6, each under ``jax.checkpoint`` where
``cfg.remat`` is set, and unrolls the others; here every stage is a Python
loop over per-block views of the stacked ``[depth, ...]`` tree, and each
block of a stage of depth >= 6 runs under activation checkpointing
(:func:`~.common.checkpointed`) where ``cfg.remat`` is set and autograd
records the forward.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .common import Params, checkpointed, conv_params, dense_params, layer, norm_params, stack_layers
from .layers import conv2d, dense, gelu, global_avg_pool, layernorm, softmax_xent

__all__ = ["ConvNeXtConfig", "init", "apply", "loss_fn"]


@dataclass(frozen=True)
class ConvNeXtConfig:
    name: str = "convnext-b"
    img_res: int = 224
    depths: tuple[int, ...] = (3, 3, 27, 3)
    dims: tuple[int, ...] = (128, 256, 512, 1024)
    num_classes: int = 1000
    in_channels: int = 3
    layer_scale: float = 1e-6
    remat: bool = True  # recompute the deep stages' activations in the backward (training)


def _block_init(gen: torch.Generator, dim: int, dtype, layer_scale: float, device=None) -> Params:
    device = device or gen.device
    kw = dict(dtype=dtype, device=device)
    return {
        "dw": conv_params(gen, 7, dim, dim, groups=dim, **kw),
        "ln": norm_params(dim, **kw),
        "pw1": dense_params(gen, dim, 4 * dim, **kw),
        "pw2": dense_params(gen, 4 * dim, dim, **kw),
        "gamma": torch.full((dim,), layer_scale, **kw),
    }


def _block_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(x, p["dw"], padding=3, groups=x.shape[-1])
    h = layernorm(h, p["ln"])
    h = dense(gelu(dense(h, p["pw1"])), p["pw2"])
    return x + p["gamma"] * h


def init(gen: torch.Generator, cfg: ConvNeXtConfig, dtype=torch.float32, device=None) -> Params:
    """Random parameters from ``gen``, on its device unless ``device`` is
    given (``"meta"``: shapes only)."""
    device = device or gen.device
    kw = dict(dtype=dtype, device=device)
    stages = []
    for si, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        stage = {"blocks": stack_layers(
            lambda g, dev, out, dim=dim: _block_init(g, dim, dtype, cfg.layer_scale, dev), gen, depth, device)}
        if si + 1 < len(cfg.depths):
            stage["down_norm"] = norm_params(dim, **kw)
            stage["down"] = conv_params(gen, 2, dim, cfg.dims[si + 1], **kw)
        stages.append(stage)
    return {
        "stem": conv_params(gen, 4, cfg.in_channels, cfg.dims[0], **kw),
        "stem_norm": norm_params(cfg.dims[0], **kw),
        "stages": stages,
        "ln": norm_params(cfg.dims[-1], **kw),
        "head": dense_params(gen, cfg.dims[-1], cfg.num_classes, **kw),
    }


def apply(params: Params, cfg: ConvNeXtConfig, x: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C] -> logits [B, classes]."""
    x = conv2d(x, params["stem"], stride=4, padding="VALID")
    x = layernorm(x, params["stem_norm"])
    for si, stage in enumerate(params["stages"]):
        remat = cfg.remat and cfg.depths[si] >= 6  # the stages JAX scans
        for li in range(cfg.depths[si]):
            x = checkpointed(remat, _block_apply, layer(stage["blocks"], li), x)
        if "down" in stage:
            x = layernorm(x, stage["down_norm"])
            x = conv2d(x, stage["down"], stride=2, padding="VALID")
    x = layernorm(global_avg_pool(x), params["ln"])
    return dense(x, params["head"])


def loss_fn(params: Params, cfg: ConvNeXtConfig, images: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy of the logits (:func:`~.layers.softmax_xent`);
    returns (loss, {"logits": logits})."""
    logits = apply(params, cfg, images)
    return softmax_xent(logits, labels), {"logits": logits}
