"""Mixture-of-Experts FFN with capacity-based top-k routing, GShard style
(twin of ``repro/models/moe.py``).

The dispatch gathers tokens into an [E, C] slot table, so each expert matrix
is one batched product over the experts (``torch.bmm``, JAX's
``einsum('ecd,edf->ecf')``).  Routing follows JAX's integers exactly: the
top k by a stable descending sort (``lax.top_k`` breaks ties by the lower
index, ``torch.topk`` does not), each (token, choice) pair's position in its
expert by a stable sort of the token-major ids, and pairs past an expert's
capacity dropped, first come first kept.  Token counts up to
``dropless_below`` (decode steps) route drop-free.  Nothing here reads a
device value on the host, so a forward enqueues without a sync.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..parallel import hints
from .common import Params, _normal, dense_params
from .layers import dense, silu

__all__ = ["MoEConfig", "moe_init", "moe_apply", "router_topk"]


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    n_shared: int = 0  # always-on shared experts (DeepSeek-V3: 1)
    capacity_factor: float = 1.25
    router_bias: bool = False  # aux-loss-free bias (DeepSeek-V3)
    dropless_below: int = 256  # token counts <= this route drop-free (decode)


def moe_init(gen: torch.Generator, cfg: MoEConfig, dtype=torch.float32, device=None,
             out: Params | None = None) -> Params:
    """The router ``[D, E]``, the experts stacked ``w1``/``w3`` ``[E, D, F]``
    and ``w2`` ``[E, F, D]`` (normal, std 1/sqrt(fan-in)), the zero
    ``router_b`` and the shared experts where the config asks for them.

    The experts are drawn one expert at a time, in float32, and written into
    their slots rounded to ``dtype``: into ``out["experts"]`` where ``out``
    is given (a layer's slot of a stacked tree, :func:`~.common.stack_layers`),
    else into tensors allocated once here.  So a draw never holds more than
    one expert's matrix in float32 beside the parameters (DeepSeek-V3's
    ``w1`` is 15.0 GB in float32 a layer)."""
    device = device or gen.device
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(bias=False, dtype=dtype, device=device)
    shapes = {"w1": ((d, f), d), "w3": ((d, f), d), "w2": ((f, d), f)}  # matrix, fan-in
    experts = out["experts"] if out is not None else {
        name: torch.empty((e,) + shape, dtype=dtype, device=device) for name, (shape, _) in shapes.items()}
    p = {"router": dense_params(gen, d, e, std=0.02, **kw), "experts": experts}
    if torch.device(device).type != "meta":
        for name, (shape, fan_in) in shapes.items():
            for j in range(e):
                experts[name][j].copy_(_normal(gen, shape, (1.0 / fan_in) ** 0.5, device))
    if cfg.router_bias:
        p["router_b"] = torch.zeros((e,), dtype=dtype, device=device)
    if cfg.n_shared:
        fs = cfg.d_ff * cfg.n_shared
        p["shared"] = {"w1": dense_params(gen, d, fs, **kw), "w3": dense_params(gen, d, fs, **kw),
                       "w2": dense_params(gen, fs, d, **kw)}
    return p


def router_topk(p: Params, cfg: MoEConfig, x: torch.Tensor):
    """x: [T, D] -> (gates [T, k] renormalised, ids [T, k], router probs [T, E]).

    The router product runs in x's type and only then goes to float32; the
    softmax and the renormalisation are float32, the gates cast back to x's
    type.  Ties go to the lower expert index, as ``lax.top_k``."""
    logits = dense(x, p["router"]).float()
    if "router_b" in p:
        logits = logits + p["router_b"]
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :cfg.top_k], ids[:, :cfg.top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gates.to(x.dtype), ids, probs


def _dispatch(ids: torch.Tensor, e: int, capacity: int):
    """ids: [T, k] expert assignment -> (slot_expert [T, k], slot_pos [T, k], keep).

    A stable argsort groups the token-major (token, choice) pairs by expert;
    a pair's position in its expert is its rank minus its expert's first
    rank, so earlier tokens win the capacity."""
    t, k = ids.shape
    flat = ids.reshape(-1)  # [N = T*k], token-major order
    n = flat.shape[0]
    order = torch.argsort(flat, stable=True)  # pairs grouped by expert
    ranks = torch.empty_like(flat).index_copy_(0, order, torch.arange(n, device=ids.device))
    first_rank = torch.searchsorted(flat[order], torch.arange(e, device=ids.device, dtype=flat.dtype))
    pos = ranks - first_rank[flat]  # position within expert
    keep = pos < capacity
    return flat.reshape(t, k), pos.reshape(t, k), keep.reshape(t, k)


def moe_apply(p: Params, cfg: MoEConfig, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """x: [T, D] -> (y [T, D], aux dict with load-balancing stats)."""
    tkn, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    capacity = max(1, int(cfg.capacity_factor * tkn * k / e))
    # dropless for small token counts (decode steps): per-expert load can never
    # exceed the token count, so capacity = tkn makes routing exact.
    if tkn <= cfg.dropless_below:
        capacity = max(capacity, tkn)
    gates, ids, probs = router_topk(p, cfg, x)
    flat_e, pos, keep = _dispatch(ids, e, capacity)

    # gather tokens into [E, C, D] slots; dropped (token, choice) pairs all go
    # to one dummy row, past the table, so every kept slot has exactly one
    # writer (the dummy row's among its duplicates is undefined on the card,
    # and it is discarded).  The hints name the dispatch boundary, as JAX's:
    # tokens batch-sharded in, slots expert-sharded out.
    x = hints.constrain(x, "moe_tokens")
    dummy = e * capacity
    slot = torch.where(keep, flat_e * capacity + pos, dummy).reshape(-1)  # [T*k]
    token_idx = torch.arange(tkn, device=x.device).repeat_interleave(k)
    xs = x.new_zeros((e * capacity + 1, d)).index_copy_(0, slot, x.index_select(0, token_idx))
    xs = hints.constrain(xs[:-1].reshape(e, capacity, d), "moe_slots")

    w = p["experts"]
    h = torch.bmm(xs, w["w1"])
    g = torch.bmm(xs, w["w3"])
    y_e = torch.bmm(silu(h) * g, w["w2"]).reshape(e * capacity, d)

    # combine back with gates (dropped choices contribute zero): the products
    # in x's type, their sum over k in float32 and rounded once, as JAX's
    # reduction of a 16-bit type
    y_pad = torch.cat([y_e, y_e.new_zeros((1, d))], dim=0)
    picked = y_pad.index_select(0, slot).reshape(tkn, k, d)
    y = hints.constrain((picked * (gates * keep)[..., None]).sum(dim=1, dtype=torch.float32).to(x.dtype),
                        "moe_tokens")

    if cfg.n_shared:
        s = p["shared"]
        y = y + dense(silu(dense(x, s["w1"])) * dense(x, s["w3"]), s["w2"])

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e, with f_e the
    # share of kept pairs per expert (exact integer counts, then / T / k)
    me = probs.mean(dim=0)
    counts = torch.zeros(e, device=x.device).index_add_(0, flat_e.reshape(-1), keep.reshape(-1).float())
    ce = counts / tkn / k
    aux = {
        "load_balance_loss": e * torch.sum(me * ce),
        "dropped_frac": 1.0 - keep.float().mean(),
    }
    return y, aux
