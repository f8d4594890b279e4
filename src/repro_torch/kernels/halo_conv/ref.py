"""Plain PyTorch version of the halo conv: concatenate, then convolve.

Mirrors ``repro/kernels/halo_conv/ref.py: halo_conv2d_ref``: the shard and its
halos are concatenated along the rows, the width is zero-padded, and the
port's plain conv (:func:`~repro_torch.kernels.conv2d.conv2d_ref`) runs VALID
over the slab (its float32 sum rounded to the input dtype, then the bias
added, as ``halo_conv2d`` does).  It is what
:func:`~repro_torch.kernels.halo_conv.halo_conv2d_cuda` runs for a CPU tensor
and what the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..conv2d.ref import conv2d_ref


def halo_conv2d_ref(
    x_shard: torch.Tensor,
    top_halo: torch.Tensor | None,
    bot_halo: torch.Tensor | None,
    weights: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    parts = [p for p in (top_halo, x_shard, bot_halo) if p is not None]
    ext = torch.cat(parts, dim=1) if len(parts) > 1 else x_shard
    # the height is already extended by the halos; only the width is padded
    if padding:
        ext = F.pad(ext, (0, 0, padding, padding))
    return conv2d_ref(ext, weights, bias, stride=stride, padding=0, groups=groups)
