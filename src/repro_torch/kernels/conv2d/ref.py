"""Plain PyTorch version of the direct conv (explicit tap sum, no F.conv2d).

Mirrors ``repro/kernels/conv2d/ref.py: conv2d_ref``: NHWC x HWIO, a sum of k*k
shifted (strided) channel contractions accumulated in float32, cast to the
input dtype, then the bias added in that dtype -- the order of JAX
``models/layers.py: conv2d`` and ``conv2d_pallas`` (round the conv output, add
the bias), which the kernels' epilogue follows.  It is what
:func:`~repro_torch.kernels.conv2d.ops.conv2d_cuda` runs for a CPU tensor and
what the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_ref(
    x: torch.Tensor,
    weights: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """NHWC x [k,k,Cin,Cout] conv; ``groups > 1`` is the depthwise case
    (weights [k, k, 1, C])."""
    k = weights.shape[0]
    s = stride
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    n, h, w, cin = x.shape
    ho, wo = (h - k) // s + 1, (w - k) // s + 1
    if groups > 1 and not (groups == cin == weights.shape[-1] and weights.shape[2] == 1):
        raise ValueError(f"only depthwise groups supported, got groups={groups}")
    acc = torch.zeros((n, ho, wo, weights.shape[-1]), dtype=torch.float32, device=x.device)
    for ky in range(k):
        for kx in range(k):
            patch = x[
                :, ky : ky + (ho - 1) * s + 1 : s, kx : kx + (wo - 1) * s + 1 : s, :
            ].float()
            if groups > 1:
                acc = acc + patch * weights[ky, kx, 0].float()
            else:
                acc = acc + torch.einsum("nhwc,cd->nhwd", patch, weights[ky, kx].float())
    y = acc.to(x.dtype)
    if bias is not None:
        y = y + bias
    return y
