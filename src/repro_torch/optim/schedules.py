"""Learning-rate schedules (twin of ``repro/optim/schedules.py``): pure
functions of the step count, in float32, on the step's device."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 1000, total: int = 100_000, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor`` of peak; returns a scale."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(1.0, warmup)
    frac = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, cos)


def constant(step) -> torch.Tensor:
    return torch.ones_like(torch.as_tensor(step, dtype=torch.float32))
