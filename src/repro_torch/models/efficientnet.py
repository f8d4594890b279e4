"""EfficientNet (Tan & Le, arXiv:1905.11946) -- efficientnet-b7 (twin of
``repro/models/efficientnet.py``: width_mult=2.0, depth_mult=3.1,
img_res=600).

MBConv blocks with squeeze-excitation.  The stem, the 1x1 expand and
project convs and the head conv go to K1's dense route; the 3x3 / 5x5
depthwise convs (stride 1 or 2, symmetric padding (k - 1) // 2) to its
depthwise branch.  Squeeze-excitation stays plain.  The batch norms use
their folded running statistics, or under ``train=True`` (the loss) the
batch's own.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .common import Params, conv_params, dense_params
from .layers import (batchnorm_inference, batchnorm_train, conv2d, dense, global_avg_pool, sigmoid, silu,
                     softmax_xent)

__all__ = ["EfficientNetConfig", "init", "apply", "loss_fn", "block_meta", "B0_STAGES"]

# B0 baseline: (expand, channels, repeats, stride, kernel)
B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


@dataclass(frozen=True)
class EfficientNetConfig:
    name: str = "efficientnet-b7"
    img_res: int = 600
    width_mult: float = 2.0
    depth_mult: float = 3.1
    num_classes: int = 1000
    in_channels: int = 3
    se_ratio: float = 0.25
    stem_ch: int = 32
    head_ch: int = 1280

    def round_ch(self, c: int) -> int:
        c = c * self.width_mult
        new = max(8, int(c + 4) // 8 * 8)
        if new < 0.9 * c:
            new += 8
        return new

    def round_reps(self, r: int) -> int:
        return int(math.ceil(self.depth_mult * r))

    def stages(self):
        return [(e, self.round_ch(c), self.round_reps(r), s, k) for e, c, r, s, k in B0_STAGES]


def _bn_params(c: int, dtype, device) -> Params:
    kw = dict(dtype=dtype, device=device)
    return {"scale": torch.ones((c,), **kw), "b": torch.zeros((c,), **kw),
            "mean": torch.zeros((c,), **kw), "var": torch.ones((c,), **kw)}


def _mbconv_init(gen: torch.Generator, c_in: int, c_out: int, expand: int, k: int, se_ratio: float, dtype,
                 device) -> Params:
    kw = dict(dtype=dtype, device=device)
    c_mid = c_in * expand
    p: Params = {}
    if expand != 1:
        p["expand"] = conv_params(gen, 1, c_in, c_mid, bias=False, **kw)
        p["bn0"] = _bn_params(c_mid, **kw)
    p["dw"] = conv_params(gen, k, c_mid, c_mid, bias=False, groups=c_mid, **kw)
    p["bn1"] = _bn_params(c_mid, **kw)
    c_se = max(1, int(c_in * se_ratio))
    p["se_reduce"] = dense_params(gen, c_mid, c_se, **kw)
    p["se_expand"] = dense_params(gen, c_se, c_mid, **kw)
    p["project"] = conv_params(gen, 1, c_mid, c_out, bias=False, **kw)
    p["bn2"] = _bn_params(c_out, **kw)
    return p


def _bn(x: torch.Tensor, p: Params, train: bool) -> torch.Tensor:
    return batchnorm_train(x, p) if train else batchnorm_inference(x, p)


def _mbconv_apply(p: Params, x: torch.Tensor, stride: int, k: int, train: bool) -> torch.Tensor:
    c_in = x.shape[-1]
    h = x
    if "expand" in p:
        h = silu(_bn(conv2d(h, p["expand"], padding="VALID"), p["bn0"], train))
    pad = (k - 1) // 2
    h = silu(_bn(conv2d(h, p["dw"], stride=stride, padding=pad, groups=h.shape[-1]), p["bn1"], train))
    # squeeze-excitation (the global pool is the cross-segment sync point)
    se = global_avg_pool(h)
    se = sigmoid(dense(silu(dense(se, p["se_reduce"])), p["se_expand"]))
    h = h * se[:, None, None, :]
    h = _bn(conv2d(h, p["project"], padding="VALID"), p["bn2"], train)
    if stride == 1 and h.shape[-1] == c_in:
        h = h + x
    return h


def init(gen: torch.Generator, cfg: EfficientNetConfig, dtype=torch.float32, device=None) -> Params:
    """Random parameters from ``gen``, on its device unless ``device`` is
    given (``"meta"``: shapes only)."""
    device = device or gen.device
    kw = dict(dtype=dtype, device=device)
    stem_c = cfg.round_ch(cfg.stem_ch)
    p: Params = {"stem": conv_params(gen, 3, cfg.in_channels, stem_c, bias=False, **kw),
                 "stem_bn": _bn_params(stem_c, **kw)}
    c_in = stem_c
    blocks = []
    # static metadata (stride / kernel) lives in block_meta(cfg); params are tensors
    for e, c_out, reps, _, k in cfg.stages():
        for _ in range(reps):
            blocks.append(_mbconv_init(gen, c_in, c_out, e, k, cfg.se_ratio, **kw))
            c_in = c_out
    p["blocks"] = blocks
    head_c = cfg.round_ch(cfg.head_ch)
    p["head_conv"] = conv_params(gen, 1, c_in, head_c, bias=False, **kw)
    p["head_bn"] = _bn_params(head_c, **kw)
    p["fc"] = dense_params(gen, head_c, cfg.num_classes, **kw)
    return p


def block_meta(cfg: EfficientNetConfig) -> list[tuple[int, int]]:
    """Static (stride, kernel) per block, aligned with params['blocks']."""
    return [(s if r == 0 else 1, k) for _, _, reps, s, k in cfg.stages() for r in range(reps)]


def apply(params: Params, cfg: EfficientNetConfig, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """x [B, H, W, C] -> logits [B, classes]; ``train=True`` normalises
    with the batch's own statistics (:func:`~.layers.batchnorm_train`)."""
    x = silu(_bn(conv2d(x, params["stem"], stride=2, padding=1), params["stem_bn"], train))
    for p_b, (s, k) in zip(params["blocks"], block_meta(cfg)):
        x = _mbconv_apply(p_b, x, s, k, train)
    x = silu(_bn(conv2d(x, params["head_conv"], padding="VALID"), params["head_bn"], train))
    return dense(global_avg_pool(x), params["fc"])


def loss_fn(params: Params, cfg: EfficientNetConfig, images: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy (:func:`~.layers.softmax_xent`) of the logits of
    ``apply(train=True)``; returns (loss, {"logits": logits})."""
    logits = apply(params, cfg, images, train=True)
    return softmax_xent(logits, labels), {"logits": logits}
