"""Core layers on NHWC tensors and [B, T, D] sequences (twin of the VGG, ViT
and dense-LM subset of ``repro/models/layers.py``).

The conv goes to the hand-written kernel's wrapper (which takes its plain
version for CPU tensors); pooling, the activations, the norms and the dense
layers stay plain PyTorch, as the JAX package left them to XLA.
"""
from __future__ import annotations

import torch

from ..kernels.conv2d import conv2d_cuda
from .common import Params


def conv2d(x: torch.Tensor, p: Params, stride: int = 1, padding: int | str = "SAME",
           groups: int = 1) -> torch.Tensor:
    """NHWC x HWIO -> NHWC convolution with symmetric zero padding.

    ``padding`` is an int, ``"VALID"`` (0) or ``"SAME"`` (odd kernels at
    stride 1 only, where SAME is symmetric)."""
    k = p["w"].shape[0]
    if padding == "VALID":
        padding = 0
    elif padding == "SAME":
        if stride != 1 or k % 2 == 0:
            raise ValueError(f"SAME padding is asymmetric for k={k}, stride={stride}")
        padding = (k - 1) // 2
    return conv2d_cuda(x, p["w"], p.get("b"), stride=stride, padding=padding, groups=groups)


def max_pool(x: torch.Tensor, k: int = 2, s: int = 2, padding: str = "VALID") -> torch.Tensor:
    """NHWC max pool over k x k windows at stride s, VALID (``lax.reduce_window``
    with a ``-inf`` init: every window lies inside the input)."""
    if padding != "VALID":
        raise ValueError(f"only VALID pooling is supported, got {padding!r}")
    # [N, Ho, Wo, C, k, k] windows as a view, reduced over the last two axes
    return x.unfold(1, k, s).unfold(2, k, s).amax(dim=(-2, -1))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NC mean over the spatial axes."""
    return x.mean(dim=(1, 2))


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis: the mean square in float32, then
    ``(x * rsqrt(var + eps).to(x.dtype)) * scale`` -- two products in x's
    type, rounded in JAX's order."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * p["scale"]


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each step
    rounded to x's type: the expansion XLA gives ``jax.nn.silu``, so bfloat16
    rounds where JAX's does (``F.silu`` rounds once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))
