"""Gradient compression (twin of ``repro/optim/grad_compress.py``):
stateless compressors of gradient trees for a slow reduction boundary.

* bf16 compression: cast the gradients to bfloat16 before the reduction
  (half the bytes), and back to float32 after it.
* top-k magnitude sparsification per tensor, in dense mask form, with
  tensors under ``min_size`` elements left dense.
"""
from __future__ import annotations

import torch

from ..models.common import tree_map


def compress_bf16(grads):
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def decompress_bf16(grads, like=None):
    return tree_map(lambda g: g.float(), grads)


def topk_sparsify(g: torch.Tensor, frac: float = 0.05, min_size: int = 4096) -> torch.Tensor:
    """Keep the entries whose magnitude is at least the k-th largest's
    (k = ``frac`` of the size, at least 1; ties at the threshold are kept),
    zero the rest."""
    if g.numel() < min_size:
        return g
    k = max(1, int(g.numel() * frac))
    thresh = torch.topk(g.abs().reshape(-1), k).values[-1]
    return torch.where(g.abs() >= thresh, g, torch.zeros((), dtype=g.dtype, device=g.device))


def compress_topk(grads, frac: float = 0.05):
    return tree_map(lambda g: topk_sparsify(g, frac), grads)
