"""DiT (Peebles & Xie, arXiv:2212.09748) -- dit-xl2 (twin of
``repro/models/dit.py``).

Latent-space diffusion transformer with adaLN-zero conditioning, on an
8x-downsampled latent (img_res / 8) with patch size 2.  The patch embedding
is a k = s = 2 conv (K1); each block's attention goes through the
flash-attention kernel (K3, not causal, scale 1/sqrt(D), D = 72 at
DiT-XL/2's widths) where JAX writes two einsums; the products stay ``x @ w``.
The blocks keep JAX's stacked layout (every leaf ``[n_layers, ...]``) and run
as a Python loop over per-layer views where JAX scans, each block under
activation checkpointing where ``cfg.remat`` is set and autograd records the
forward (JAX's ``jax.checkpoint`` over the scan's body).  A sampler is
``steps`` forwards of this backbone (``configs.steps._diffusion_gen``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..kernels.attention import flash_attention
from .common import Params, checkpointed, conv_params, dense_params, layer, stack_layers, trunc_normal
from .layers import conv2d, dense, gelu, standardize

__all__ = ["DiTConfig", "init", "apply", "timestep_embedding"]


@dataclass(frozen=True)
class DiTConfig:
    name: str = "dit-xl2"
    img_res: int = 256
    patch: int = 2
    n_layers: int = 28
    d_model: int = 1152
    n_heads: int = 16
    mlp_ratio: int = 4
    latent_ch: int = 4
    num_classes: int = 1000
    learn_sigma: bool = True
    remat: bool = True  # recompute each block's activations in the backward (training)

    @property
    def latent_res(self) -> int:
        return self.img_res // 8

    @property
    def n_tokens(self) -> int:
        return (self.latent_res // self.patch) ** 2

    @property
    def out_ch(self) -> int:
        return self.latent_ch * (2 if self.learn_sigma else 1)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal embedding of timesteps ``t`` [B] -> [B, dim], in float32
    (the caller casts): ``[cos(t f), sin(t f)]``, ``f = exp(-ln(max_period) i / half)``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _block_init(gen: torch.Generator, d: int, mlp_ratio: int, dtype, device) -> Params:
    kw = dict(dtype=dtype, device=device)
    return {
        "wqkv": dense_params(gen, d, 3 * d, **kw),
        "wo": dense_params(gen, d, d, **kw),
        "fc1": dense_params(gen, d, mlp_ratio * d, **kw),
        "fc2": dense_params(gen, mlp_ratio * d, d, **kw),
        # adaLN-zero modulation: 6 per-channel (shift, scale, gate) vectors;
        # zero at init, so every block starts as the identity
        "ada": {"w": torch.zeros((d, 6 * d), **kw), "b": torch.zeros((6 * d,), **kw)},
    }


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale[:, None]) + shift[:, None]


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free layer norm (adaLN supplies scale and shift)."""
    return standardize(x, -1, eps)


def _block_apply(p: Params, x: torch.Tensor, c: torch.Tensor, n_heads: int) -> torch.Tensor:
    """x [B, N, D], c [B, D] conditioning."""
    b, n, d = x.shape
    mod = dense(gelu(c), p["ada"])  # [B, 6D]
    sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
    h = _modulate(_ln(x), sh1, sc1)
    qkv = dense(h, p["wqkv"]).reshape(b, n, 3, n_heads, d // n_heads)
    # [B, N, H, Dh] slices seen as [B, H, N, Dh]: the kernel reads them through strides
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    a = flash_attention(q, k, v, causal=False).transpose(1, 2).reshape(b, n, d)
    x = x + g1[:, None] * dense(a, p["wo"])
    h = _modulate(_ln(x), sh2, sc2)
    return x + g2[:, None] * dense(gelu(dense(h, p["fc1"])), p["fc2"])


def init(gen: torch.Generator, cfg: DiTConfig, dtype=torch.float32, device=None) -> Params:
    """Random parameters from ``gen``, on its device unless ``device`` is
    given (``"meta"``: shapes only); ``ada`` / ``final_ada`` zero, as JAX's."""
    device = device or gen.device
    kw = dict(dtype=dtype, device=device)
    d = cfg.d_model
    return {
        "patch_embed": conv_params(gen, cfg.patch, cfg.latent_ch, d, **kw),
        "pos": trunc_normal(gen, (1, cfg.n_tokens, d), **kw),
        "t_mlp1": dense_params(gen, 256, d, **kw),
        "t_mlp2": dense_params(gen, d, d, **kw),
        "label_embed": trunc_normal(gen, (cfg.num_classes + 1, d), 0.02, **kw),
        "blocks": stack_layers(lambda g, dev, out: _block_init(g, d, cfg.mlp_ratio, dtype, dev),
                               gen, cfg.n_layers, device),
        "final_ada": {"w": torch.zeros((d, 2 * d), **kw), "b": torch.zeros((2 * d,), **kw)},
        "final": dense_params(gen, d, cfg.patch * cfg.patch * cfg.out_ch, **kw),
    }


def apply(params: Params, cfg: DiTConfig, x_latent: torch.Tensor, t: torch.Tensor,
          y: torch.Tensor) -> torch.Tensor:
    """x_latent [B, H, W, C_lat], t [B] timesteps, y [B] int32 class labels
    -> predicted noise (+ sigma) [B, H, W, out_ch]."""
    b = x_latent.shape[0]
    x = conv2d(x_latent, params["patch_embed"], stride=cfg.patch, padding="VALID")
    gh, gw = x.shape[1], x.shape[2]
    x = x.reshape(b, gh * gw, cfg.d_model) + params["pos"][:, : gh * gw]
    t_emb = timestep_embedding(t, 256).to(x.dtype)
    temb = dense(gelu(dense(t_emb, params["t_mlp1"])), params["t_mlp2"])
    c = (temb + params["label_embed"][y.long()]).to(x.dtype)
    for i in range(cfg.n_layers):
        x = checkpointed(cfg.remat, _block_apply, layer(params["blocks"], i), x, c, cfg.n_heads)
    mod = dense(gelu(c), params["final_ada"])
    sh, sc = mod.chunk(2, dim=-1)
    x = _modulate(_ln(x), sh, sc)
    x = dense(x, params["final"])  # [B, N, p*p*out]
    p_ = cfg.patch
    x = x.reshape(b, gh, gw, p_, p_, cfg.out_ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * p_, gw * p_, cfg.out_ch)
