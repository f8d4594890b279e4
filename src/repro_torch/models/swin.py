"""Swin Transformer (Liu et al., arXiv:2103.14030) -- swin-b (twin of
``repro/models/swin.py``).

The k = s = 4 patch embedding is K1.  Window attention stays plain PyTorch --
the matmuls, the relative-position bias, the ``-1e9`` shift mask and a
float32 softmax -- as the JAX package left it to XLA: the flash-attention
kernel takes no additive bias.  Blocks alternate unshifted and shifted
windows (odd blocks shift), which is also the order of JAX's scanned pairs;
each stage is a Python loop over per-block views of the stacked tree.  In a
stage of even depth >= 6, which JAX scans by (regular, shifted) pairs under
``jax.checkpoint`` where ``cfg.remat`` is set, each pair runs under
activation checkpointing (:func:`~.common.checkpointed`) where ``cfg.remat``
is set and autograd records the forward.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from .common import Params, checkpointed, conv_params, dense_params, layer, norm_params, stack_layers, trunc_normal
from .layers import conv2d, dense, gelu, global_avg_pool, layernorm, scalar_like, softmax_xent

__all__ = ["SwinConfig", "init", "apply", "loss_fn"]


@dataclass(frozen=True)
class SwinConfig:
    name: str = "swin-b"
    img_res: int = 224
    patch: int = 4
    window: int = 7
    depths: tuple[int, ...] = (2, 2, 18, 2)
    dims: tuple[int, ...] = (128, 256, 512, 1024)
    n_heads: tuple[int, ...] = (4, 8, 16, 32)
    mlp_ratio: int = 4
    num_classes: int = 1000
    in_channels: int = 3
    remat: bool = True  # recompute the deep stages' activations in the backward (training)


def _block_init(gen: torch.Generator, dim: int, heads: int, window: int, mlp_ratio: int, dtype,
                device=None) -> Params:
    device = device or gen.device
    kw = dict(dtype=dtype, device=device)
    return {
        "ln1": norm_params(dim, **kw),
        "wqkv": dense_params(gen, dim, 3 * dim, **kw),
        "wo": dense_params(gen, dim, dim, **kw),
        "rel_bias": trunc_normal(gen, ((2 * window - 1) ** 2, heads), **kw),
        "ln2": norm_params(dim, **kw),
        "fc1": dense_params(gen, dim, mlp_ratio * dim, **kw),
        "fc2": dense_params(gen, mlp_ratio * dim, dim, **kw),
    }


@functools.lru_cache(maxsize=16)
def _rel_index(window: int, device: str = "cpu") -> torch.Tensor:
    """Relative-position index table [n, n] of a window (n = window**2)."""
    r = torch.arange(window, device=device)
    coords = torch.stack(torch.meshgrid(r, r, indexing="ij"), 0).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)  # [2, n, n]
    return rel[0] * (2 * window - 1) + rel[1]


def _window_attention(p: Params, x: torch.Tensor, heads: int, window: int,
                      attn_mask: torch.Tensor | None = None) -> torch.Tensor:
    """x: [B, nW, n, C] windows -> same shape.  The logits in x's type, the
    softmax in float32, the probabilities rounded to x's type, as JAX."""
    b, nw, n, c = x.shape
    qkv = dense(x, p["wqkv"]).reshape(b, nw, n, 3, heads, c // heads)
    q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
    logits = torch.einsum("bwnhd,bwmhd->bwhnm", q, k) / scalar_like(math.sqrt(c / heads), x)
    bias = p["rel_bias"][_rel_index(window, str(x.device)).reshape(-1)].reshape(n, n, heads)
    logits = logits + bias.permute(2, 0, 1)[None, None]
    if attn_mask is not None:  # [nW, n, n] boolean (True = keep)
        logits = torch.where(attn_mask[None, :, None], logits, scalar_like(-1e9, x))
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bwhnm,bwmhd->bwnhd", probs, v).reshape(b, nw, n, c)
    return dense(out, p["wo"])


def _to_windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, nW, window*window, C]"""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // window) * (w // window), window * window, c)


def _from_windows(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, h // window, w // window, window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@functools.lru_cache(maxsize=16)
def _shift_mask(h: int, w: int, window: int, shift: int, device: str = "cpu") -> torch.Tensor:
    """Attention mask [nW, n, n] for shifted windows: tokens attend only
    within their original region."""
    img = torch.zeros((h, w), dtype=torch.int32, device=device)
    bounds = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hb in bounds:
        for wb in bounds:
            img[hb, wb] = cnt
            cnt += 1
    win = _to_windows(img[None, :, :, None], window)[0, :, :, 0]
    return win[:, :, None] == win[:, None, :]


def _swin_block(p: Params, x: torch.Tensor, heads: int, window: int, shift: int) -> torch.Tensor:
    """x: [B, H, W, C]."""
    b, h, w, c = x.shape
    shortcut = x
    x = layernorm(x, p["ln1"])
    mask = None
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = _shift_mask(h, w, window, shift, str(x.device))
    x = _from_windows(_window_attention(p, _to_windows(x, window), heads, window, mask), window, h, w)
    if shift:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = shortcut + x
    h2 = layernorm(x, p["ln2"])
    return x + dense(gelu(dense(h2, p["fc1"])), p["fc2"])


def _swin_pair(p0: Params, p1: Params, x: torch.Tensor, heads: int, window: int, shift: int) -> torch.Tensor:
    """A regular block, then a shifted one: one checkpoint of a deep stage."""
    return _swin_block(p1, _swin_block(p0, x, heads, window, 0), heads, window, shift)


def init(gen: torch.Generator, cfg: SwinConfig, dtype=torch.float32, device=None) -> Params:
    """Random parameters from ``gen``, on its device unless ``device`` is
    given (``"meta"``: shapes only)."""
    device = device or gen.device
    kw = dict(dtype=dtype, device=device)
    stages = []
    for si, (depth, dim, heads) in enumerate(zip(cfg.depths, cfg.dims, cfg.n_heads)):
        stage = {"blocks": stack_layers(
            lambda g, dev, out, dim=dim, heads=heads: _block_init(g, dim, heads, cfg.window, cfg.mlp_ratio,
                                                                  dtype, dev),
            gen, depth, device)}
        if si + 1 < len(cfg.depths):
            stage["merge_norm"] = norm_params(4 * dim, **kw)
            stage["merge"] = dense_params(gen, 4 * dim, cfg.dims[si + 1], bias=False, **kw)
        stages.append(stage)
    return {
        "patch_embed": conv_params(gen, cfg.patch, cfg.in_channels, cfg.dims[0], **kw),
        "patch_norm": norm_params(cfg.dims[0], **kw),
        "stages": stages,
        "ln": norm_params(cfg.dims[-1], **kw),
        "head": dense_params(gen, cfg.dims[-1], cfg.num_classes, **kw),
    }


def apply(params: Params, cfg: SwinConfig, x: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C] -> logits [B, classes]."""
    x = conv2d(x, params["patch_embed"], stride=cfg.patch, padding="VALID")
    x = layernorm(x, params["patch_norm"])
    for si, stage in enumerate(params["stages"]):
        heads = cfg.n_heads[si]
        hcur = x.shape[1]
        shift = cfg.window // 2 if hcur > cfg.window else 0
        win = min(cfg.window, hcur)
        depth = cfg.depths[si]
        if depth >= 6 and depth % 2 == 0:  # the stages JAX scans by pairs
            for li in range(0, depth, 2):
                x = checkpointed(cfg.remat, _swin_pair, layer(stage["blocks"], li), layer(stage["blocks"], li + 1), x,
                                 heads, win, shift)
        else:
            for li in range(depth):
                x = _swin_block(layer(stage["blocks"], li), x, heads, win, shift if li % 2 else 0)
        if "merge" in stage:  # patch merging: 2x2 neighbourhood -> next dim, channels in (dh, dw, c) order
            bb, h, w, c = x.shape
            x = x.reshape(bb, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(bb, h // 2, w // 2, 4 * c)
            x = dense(layernorm(x, stage["merge_norm"]), stage["merge"])
    x = layernorm(x, params["ln"])
    return dense(global_avg_pool(x), params["head"])


def loss_fn(params: Params, cfg: SwinConfig, images: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy of the logits (:func:`~.layers.softmax_xent`);
    returns (loss, {"logits": logits})."""
    logits = apply(params, cfg, images)
    return softmax_xent(logits, labels), {"logits": logits}
