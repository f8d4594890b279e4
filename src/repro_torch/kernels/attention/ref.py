"""Plain PyTorch version of flash attention (twin of ``repro/kernels/attention/ref.py``).

f32 math: scores ``q k^T / sqrt(D)``, the causal mask aligned top-left (query
``t`` sees keys ``0..t`` whatever ``S`` is), a softmax over the keys, the
weighted sum of ``v``, one cast to q's dtype.  It is what
:func:`~repro_torch.kernels.attention.ops.flash_attention` runs for a CPU
tensor and what the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q/k [B,H,T,D] / [B,H,S,D], v [B,H,S,DV] -> [B,H,T,DV] (f32 math; the
    scale 1/sqrt(D) of the query/key width)."""
    t, d = q.shape[2], q.shape[3]
    s = k.shape[2]
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = torch.arange(t, device=q.device)[:, None] >= torch.arange(s, device=q.device)[None, :]
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", probs, v.float()).to(q.dtype)
