"""Core layers on NHWC tensors and [B, T, D] sequences (twin of the VGG,
vision-zoo, diffusion and dense-LM subset of ``repro/models/layers.py``).

The conv, dense or depthwise, goes to the hand-written kernel's wrapper
(which takes its plain version for CPU tensors); pooling, the activations,
the norms and the dense layers stay plain PyTorch, as the JAX package left
them to XLA.  Where bfloat16 parity needs it, an elementwise function rounds
in the order XLA's expansion of the JAX function rounds (each step in x's
type; a Python constant first rounded to x's type, as JAX's weak types are).
"""
from __future__ import annotations

import functools
import math

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


def depthwise_conv2d(x: torch.Tensor, p: Params, stride: int = 1, padding: int | str = "SAME") -> torch.Tensor:
    """Depthwise conv (weights [k, k, 1, C]): K1's depthwise branch."""
    return conv2d(x, p, stride=stride, padding=padding, groups=x.shape[-1])


def max_pool(x: torch.Tensor, k: int = 2, s: int = 2, padding: str = "VALID") -> torch.Tensor:
    """NHWC max pool over k x k windows at stride s, VALID (``lax.reduce_window``
    with a ``-inf`` init: every window lies inside the input)."""
    if padding != "VALID":
        raise ValueError(f"only VALID pooling is supported, got {padding!r}")
    # [N, Ho, Wo, C, k, k] windows as a view, reduced over the last two axes
    return x.unfold(1, k, s).unfold(2, k, s).amax(dim=(-2, -1))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NC mean over the spatial axes, as ``jnp.mean`` takes it:
    summed in float32, divided, rounded to x's type."""
    return (x.float().sum(dim=(1, 2)) / (x.shape[1] * x.shape[2])).to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def scalar_like(v: float, x: torch.Tensor) -> float:
    """A Python constant as JAX's weak type combines it with ``x``: rounded
    to x's type first.  A Python float, so no tensor (and, on the card, no
    copy to the device) is made."""
    return _rounded(v, x.dtype)


@functools.lru_cache(maxsize=64)
def _rounded(v: float, dtype: torch.dtype) -> float:
    return torch.tensor(v, dtype=dtype).item()


def _rsqrt(v: torch.Tensor) -> torch.Tensor:
    """``rsqrt`` correctly rounded to v's type: taken in float32 (PyTorch's
    bfloat16 ``rsqrt`` on the CPU is off by a step where XLA's is not)."""
    return torch.rsqrt(v.float()).to(v.dtype)


def standardize(x: torch.Tensor, dim, eps: float) -> torch.Tensor:
    """``(x - mu) * rsqrt(var + eps)`` over ``dim`` in JAX's order for
    ``jnp.mean`` / ``jnp.var``: the mean and the variance (about the
    unrounded mean) in float32, each rounded to x's type; then each step in
    x's type, eps rounded to it first."""
    xf = x.float()
    mean = xf.mean(dim=dim, keepdim=True)
    mu = mean.to(x.dtype)
    var = (xf - mean).square().mean(dim=dim, keepdim=True).to(x.dtype)
    return (x - mu) * _rsqrt(var + scalar_like(eps, x))


def layernorm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    """Layer norm over the last axis in JAX's order (:func:`standardize`),
    then ``* scale (+ b)`` in x's type."""
    y = standardize(x, -1, eps) * p["scale"]
    if "b" in p:
        y = y + p["b"]
    return y


def groupnorm(x: torch.Tensor, p: Params, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """NHWC group norm (the U-Net's): ``g = min(groups, C)``, lowered until it
    divides C; each group's (H, W, C / g) values standardized in JAX's order
    (:func:`standardize`), then ``* scale (+ b)`` per channel in x's type."""
    b, h, w, c = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    y = standardize(x.reshape(b, h, w, g, c // g), (1, 2, 4), eps).reshape(b, h, w, c) * p["scale"]
    if "b" in p:
        y = y + p["b"]
    return y


def batchnorm_inference(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode batch norm with folded running statistics:
    ``(x - mean) * rsqrt(var + eps) * scale + b``, each step in x's type."""
    return (x - p["mean"]) * _rsqrt(p["var"] + scalar_like(eps, x)) * p["scale"] + p["b"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation, as XLA expands ``jax.nn.gelu(approximate=True)``:
    ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3))))``, each step
    rounded to x's type (``F.gelu`` rounds once)."""
    cube = x * x * x
    inner = scalar_like(math.sqrt(2 / math.pi), x) * (x + scalar_like(0.044715, x) * cube)
    return x * (scalar_like(0.5, x) * (scalar_like(1.0, x) + torch.tanh(inner)))


def rmsnorm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis: the mean square in float32, then
    ``(x * rsqrt(var + eps).to(x.dtype)) * scale`` -- two products in x's
    type, rounded in JAX's order."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * p["scale"]


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, each step rounded to x's type: the expansion XLA
    gives ``jax.nn.sigmoid``."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each step
    rounded to x's type: the expansion XLA gives ``jax.nn.silu``, so bfloat16
    rounds where JAX's does (``F.silu`` rounds once)."""
    return x * sigmoid(x)


def batchnorm_train(x: torch.Tensor, p: Params, eps: float = 1e-5, axes=(0, 1, 2)) -> torch.Tensor:
    """Batch norm over the batch's own statistics (no running-average
    update, as JAX's smoke trainer): the population variance (``jnp.var``
    has ddof 0) about the batch mean, in JAX's order (:func:`standardize`),
    then ``* scale + b`` in x's type."""
    return standardize(x, axes, eps) * p["scale"] + p["b"]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with integer labels, taken in float32.  The cast's
    backward returns the cotangent in the logits' type, as the transpose of
    JAX's ``astype`` does, so a bfloat16 model's backward stays bfloat16."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (logz - gold).mean()


def drop_path(x: torch.Tensor, gen: torch.Generator, rate: float) -> torch.Tensor:
    """Stochastic depth: each sample's residual kept with probability
    ``1 - rate`` (a draw from ``gen``, on its device) and scaled by
    ``1 / (1 - rate)``, else zeroed.  The draw is not JAX's bits for a key."""
    if rate <= 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    keep = torch.rand(shape, generator=gen, device=gen.device) < 1.0 - rate
    return x * keep.to(device=x.device, dtype=x.dtype) / (1.0 - rate)
