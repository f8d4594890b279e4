"""AdamW on parameter trees (twin of ``repro/optim/adamw.py``), with
optional low-precision moments.

It is functional, as JAX's: :func:`adamw_update` returns new parameter and
state trees and never writes into the ones it is given, so a caller that
keeps an earlier state (the fault-tolerant trainer's entry snapshot) keeps
it intact.  The update math runs in float32 whatever the moments' type
(``moment_dtype=torch.bfloat16`` halves the optimizer's memory, as
DeepSeek's config takes it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..models.common import Params, tree_leaves, tree_map, tree_unflatten


# elements of a leaf's slice in one pass of the update (256 MB of float32)
CHUNK = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = None  # None = the parameter's type


def adamw_init(params: Params, cfg: AdamWConfig) -> Params:
    """Zero moments beside each leaf (in ``moment_dtype`` when set) and a
    0-dim int32 step count, on the leaves' device."""
    def zeros_like(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype or p.dtype, device=p.device)

    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return {"mu": tree_map(zeros_like, params), "nu": tree_map(zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares,
    added leaf by leaf in tree order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_update(grads: Params, state: Params, params: Params, cfg: AdamWConfig,
                 lr_scale: torch.Tensor | float = 1.0) -> tuple[Params, Params]:
    """Returns (new_params, new_state): the gradients clipped to a global
    norm of ``grad_clip`` (0: no clip), float32 moments with JAX's float32
    bias corrections ``1 - b ** count``, decoupled weight decay, and a step
    of ``lr * lr_scale``; each new leaf in its old one's type."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip else 1.0
    c32 = count.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=c32.device), c32)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=c32.device), c32)
    lr = cfg.lr * lr_scale

    def upd_slice(g, mu, nu, p):
        g = g.float() * clip
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g.square()
        step = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), mu32.to(mu.dtype), nu32.to(nu.dtype)

    def upd(g, mu, nu, p):
        # elementwise, so a large leaf (a stacked [L, ...] one, an
        # embedding) goes a slice of its leading axis at a time into its new
        # leaves: its float32 temporaries stay near CHUNK elements, and the
        # bits are the same
        if p.dim() == 0 or p.numel() <= CHUNK:
            return upd_slice(g, mu, nu, p)
        out = (torch.empty_like(p), torch.empty_like(mu), torch.empty_like(nu))
        rows = max(1, CHUNK // p[0].numel())
        for i in range(0, p.shape[0], rows):
            for o, v in zip(out, upd_slice(*(t[i:i + rows] for t in (g, mu, nu, p)))):
                o[i:i + rows] = v
        return out

    out = []  # in params' order, the other trees' leaves found by key (JAX's trees sort dict keys)
    tree_map(lambda p, g, mu, nu: out.append(upd(g, mu, nu, p)), params, grads, state["mu"], state["nu"])
    new_p, new_mu, new_nu = (tree_unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, {"mu": new_mu, "nu": new_nu, "count": count}
