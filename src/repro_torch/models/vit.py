"""ViT (Dosovitskiy et al., arXiv:2010.11929) -- vit-l16 and friends (twin of
``repro/models/vit.py``).

The patch embedding is a k = s = patch conv (K1); each encoder block's
attention goes through the flash-attention kernel (K3, not causal, scale
1/sqrt(D)); the Q/K/V, output and MLP products stay ``x @ w``, as the JAX
package left them to XLA.  The blocks keep JAX's stacked layout (every leaf
``[n_layers, ...]``) and run as a Python loop over per-layer views where JAX
scans; where ``cfg.remat`` is set and autograd records the forward, each
block runs under activation checkpointing (:func:`~.common.checkpointed`),
as JAX's ``jax.checkpoint`` over the scanned block.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.attention import flash_attention
from .common import Params, checkpointed, conv_params, dense_params, layer, norm_params, stack_layers, trunc_normal
from .layers import conv2d, dense, gelu, layernorm, softmax_xent

__all__ = ["ViTConfig", "init", "embed", "head", "apply", "loss_fn", "vit_block_init", "vit_block_apply"]


@dataclass(frozen=True)
class ViTConfig:
    name: str = "vit-l16"
    img_res: int = 224
    patch: int = 16
    n_layers: int = 24
    d_model: int = 1024
    n_heads: int = 16
    d_ff: int = 4096
    num_classes: int = 1000
    in_channels: int = 3
    remat: bool = True  # recompute each block's activations in the backward (training)

    @property
    def n_tokens(self) -> int:
        return (self.img_res // self.patch) ** 2 + 1  # + cls token


def vit_block_init(gen: torch.Generator, d_model: int, n_heads: int, d_ff: int, dtype=torch.float32,
                   device=None) -> Params:
    kw = dict(dtype=dtype, device=device or gen.device)
    return {
        "ln1": norm_params(d_model, **kw),
        "wqkv": dense_params(gen, d_model, 3 * d_model, **kw),
        "wo": dense_params(gen, d_model, d_model, **kw),
        "ln2": norm_params(d_model, **kw),
        "fc1": dense_params(gen, d_model, d_ff, **kw),
        "fc2": dense_params(gen, d_ff, d_model, **kw),
    }


def vit_block_apply(p: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Pre-LN transformer encoder block; x [B, N, D]."""
    b, n, d = x.shape
    h = layernorm(x, p["ln1"])
    qkv = dense(h, p["wqkv"]).reshape(b, n, 3, n_heads, d // n_heads)
    # [B, N, H, Dh] slices seen as [B, H, N, Dh]: the kernel reads them through strides
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    a = flash_attention(q, k, v, causal=False).transpose(1, 2).reshape(b, n, d)
    x = x + dense(a, p["wo"])
    h = layernorm(x, p["ln2"])
    return x + dense(gelu(dense(h, p["fc1"])), p["fc2"])


def init(gen: torch.Generator, cfg: ViTConfig, dtype=torch.float32, device=None) -> Params:
    """Random parameters from ``gen``, on its device unless ``device`` is
    given (``"meta"``: shapes only)."""
    device = device or gen.device
    kw = dict(dtype=dtype, device=device)
    return {
        "patch_embed": conv_params(gen, cfg.patch, cfg.in_channels, cfg.d_model, **kw),
        "cls": trunc_normal(gen, (1, 1, cfg.d_model), **kw),
        "pos": trunc_normal(gen, (1, cfg.n_tokens, cfg.d_model), **kw),
        "blocks": stack_layers(
            lambda g, dev, out: vit_block_init(g, cfg.d_model, cfg.n_heads, cfg.d_ff, dtype, dev),
            gen, cfg.n_layers, device),
        "ln": norm_params(cfg.d_model, **kw),
        "head": dense_params(gen, cfg.d_model, cfg.num_classes, **kw),
    }


def embed(params: Params, cfg: ViTConfig, x: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C] -> tokens [B, N, D]: the patch embedding (K1), the
    cls token and the position table."""
    b = x.shape[0]
    x = conv2d(x, params["patch_embed"], stride=cfg.patch, padding="VALID")
    x = x.reshape(b, -1, cfg.d_model)
    x = torch.cat([params["cls"].expand(b, 1, cfg.d_model), x], dim=1)
    return x + params["pos"]


def head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The encoder's tokens [B, N, D] -> logits [B, classes]: the final
    norm, then the cls token's classifier."""
    x = layernorm(x, params["ln"])
    return dense(x[:, 0], params["head"])


def apply(params: Params, cfg: ViTConfig, x: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C] -> logits [B, classes]."""
    x = embed(params, cfg, x)
    for i in range(cfg.n_layers):
        x = checkpointed(cfg.remat, vit_block_apply, layer(params["blocks"], i), x, cfg.n_heads)
    return head(params, x)


def loss_fn(params: Params, cfg: ViTConfig, images: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy of the logits (:func:`~.layers.softmax_xent`);
    returns (loss, {"logits": logits})."""
    logits = apply(params, cfg, images)
    return softmax_xent(logits, labels), {"logits": logits}
