"""Decoder-only LM, the LM family (twin of ``repro/models/transformer_lm.py``):

* qwen3-4b        -- dense, GQA (32q/8kv, head 128), qk-norm
* codeqwen1.5-7b  -- dense, MHA (32/32)
* moonshot-v1-16b-a3b -- MoE 64e top-6, GQA 16/16
* deepseek-v3-671b    -- MLA + MoE (1 shared + 256 routed top-8) + MTP

Prefill (:func:`forward`, tokens -> logits), KV-cache decode
(:func:`init_cache`, :func:`decode_step`) and the training loss
(:func:`loss_fn`: cross-entropy, the MoE load balance and DeepSeek-V3's MTP
loss).  The layer stacks keep JAX's
stacked layout (every leaf ``[L, ...]``): ``first_k_dense`` leading dense
layers, then the MoE layers (:mod:`.moe`), so a JAX parameter tree converts
by ``params_from_jax`` alone; each stack runs as a Python loop over
per-layer views where JAX scans, each layer under activation checkpointing
where ``cfg.remat`` is set and autograd records the forward (JAX's
``jax.checkpoint`` over the scan's body).  Every attention call goes through
:func:`~repro_torch.models.attention.gqa_apply` or, for MLA,
:func:`~repro_torch.models.attention.mla_apply`, so to the flash-attention
kernel on the card.  DeepSeek's MTP head (``mtp``) is read by
:func:`loss_fn` only; ``forward`` and ``decode_step`` ignore it, as JAX's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import resolve_device
from ..parallel import hints
from .attention import GQAConfig, MLAConfig, gqa_apply, gqa_init, mla_apply, mla_init
from .common import Params, checkpointed, dense_params, layer, norm_params, stack_layers, trunc_normal
from .layers import dense, rmsnorm, silu, softmax_xent
from .moe import MoEConfig, moe_apply, moe_init

__all__ = ["LMConfig", "init", "forward", "loss_fn", "decode_step", "init_cache"]


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int  # dense-FFN hidden size (used by dense layers)
    vocab: int
    qk_norm: bool = False
    rope_theta: float = 1e6
    attn: str = "gqa"  # "gqa" | "mla"
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    first_k_dense: int = 0
    mtp_depth: int = 0  # DeepSeek multi-token prediction heads
    remat: bool = True

    @property
    def gqa(self) -> GQAConfig:
        return GQAConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            d_head=self.d_head,
            qk_norm=self.qk_norm,
            rope_theta=self.rope_theta,
        )

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense if self.moe else 0

    @property
    def n_dense_layers(self) -> int:
        return self.first_k_dense if self.moe else self.n_layers


def _stacks(cfg: LMConfig):
    """(parameter key, cache key, depth, MoE layers?) of each layer stack the
    config has, in the order the trunk runs them."""
    for stack in (("dense_layers", "dense", cfg.n_dense_layers, False),
                  ("moe_layers", "moe", cfg.n_moe_layers, True)):
        if stack[2]:
            yield stack


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _ffn_init(gen, d, f, dtype, device):
    kw = dict(bias=False, dtype=dtype, device=device)
    return {"w1": dense_params(gen, d, f, **kw), "w3": dense_params(gen, d, f, **kw),
            "w2": dense_params(gen, f, d, **kw)}


def _block_init(gen, cfg: LMConfig, moe_layer: bool, dtype, device, out=None) -> Params:
    """One block; ``out``, a slot of a stacked tree, takes an MoE layer's
    experts in place (:func:`~.common.stack_layers`)."""
    return {
        "ln1": norm_params(cfg.d_model, bias=False, dtype=dtype, device=device),
        "attn": (mla_init(gen, cfg.mla, dtype, device) if cfg.attn == "mla"
                 else gqa_init(gen, cfg.gqa, dtype, device)),
        "ln2": norm_params(cfg.d_model, bias=False, dtype=dtype, device=device),
        "ffn": (moe_init(gen, cfg.moe, dtype, device, out=None if out is None else out["ffn"]) if moe_layer
                else _ffn_init(gen, cfg.d_model, cfg.d_ff, dtype, device)),
    }


def _mtp_init(gen, cfg: LMConfig, dtype, device, out=None) -> Params:
    """One MTP module (JAX's ``init``: DeepSeek-V3's multi-token prediction
    head): the projection of [h | embedding], a full block, two norms."""
    return {
        "proj": dense_params(gen, 2 * cfg.d_model, cfg.d_model, bias=False, dtype=dtype, device=device),
        "block": _block_init(gen, cfg, bool(cfg.moe), dtype, device, None if out is None else out["block"]),
        "norm_h": norm_params(cfg.d_model, bias=False, dtype=dtype, device=device),
        "norm_e": norm_params(cfg.d_model, bias=False, dtype=dtype, device=device),
    }


def init(gen: torch.Generator, cfg: LMConfig, dtype=torch.float32, device=None) -> Params:
    """Random parameters from ``gen``, on its device unless ``device`` is
    given (``"meta"``: shapes only)."""
    device = device or gen.device
    p: Params = {
        "embed": trunc_normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype, device),
        "final_norm": norm_params(cfg.d_model, bias=False, dtype=dtype, device=device),
        "lm_head": dense_params(gen, cfg.d_model, cfg.vocab, bias=False, std=0.02, dtype=dtype,
                                device=device),
    }
    # each stack is allocated once and drawn layer by layer into its
    # [L, ...] slots, an MoE layer's experts one expert at a time
    for key, _, n, moe_layer in _stacks(cfg):
        p[key] = stack_layers(lambda g, dev, out, m=moe_layer: _block_init(g, cfg, m, dtype, dev, out),
                              gen, n, device)
    if cfg.mtp_depth:
        p["mtp"] = stack_layers(lambda g, dev, out: _mtp_init(g, cfg, dtype, dev, out), gen, cfg.mtp_depth,
                                device)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _block_apply(p: Params, cfg: LMConfig, moe_layer: bool, x, positions, cache=None, cache_index=None):
    """One block -> (x, load-balance loss of its MoE layer, or None for a
    dense one); with a cache (GQA: (k, v); MLA: the latent), the new token's
    entries are written into it."""
    h = rmsnorm(x, p["ln1"])
    if cfg.attn == "mla":
        a, _ = mla_apply(p["attn"], cfg.mla, h, positions, cache, cache_index)
    else:
        a, _ = gqa_apply(p["attn"], cfg.gqa, h, positions, cache, cache_index)
    x = x + a
    h = rmsnorm(x, p["ln2"])
    if moe_layer:
        b, t, d = h.shape
        y, aux = moe_apply(p["ffn"], cfg.moe, h.reshape(b * t, d))
        return x + y.reshape(b, t, d), aux["load_balance_loss"]
    y = dense(silu(dense(h, p["ffn"]["w1"])) * dense(h, p["ffn"]["w3"]), p["ffn"]["w2"])
    return x + y, None


def _scan_stack(p_stack, n, cfg, moe_layer, x, positions, lb):
    # JAX scans the stack, each layer under remat where cfg.remat is set, and
    # names the residual's sharding after each block (``lm_residual``): the
    # loop walks the layers, each checkpointed as JAX's (only where autograd
    # records it), summing the MoE layers' load-balance losses in JAX's order.
    def block(p, x):
        return _block_apply(p, cfg, moe_layer, x, positions)

    for i in range(n):
        x, lb_l = checkpointed(cfg.remat, block, layer(p_stack, i), x)
        x = hints.constrain(x, "lm_residual")
        if lb_l is not None:
            lb = lb + lb_l
    return x, lb


def trunk(params: Params, cfg: LMConfig, tokens: torch.Tensor):
    """tokens [B, T] -> (pre-head hidden [B, T, D], load_balance_loss)."""
    b, t = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    lb = torch.zeros((), device=x.device)
    for key, _, n, moe_layer in _stacks(cfg):
        x, lb = _scan_stack(params[key], n, cfg, moe_layer, x, positions, lb)
    return x, lb


def forward(params: Params, cfg: LMConfig, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, T] (int32 or int64) -> (logits [B, T, V], load_balance_loss)."""
    x, lb = trunk(params, cfg, tokens)
    x = rmsnorm(x, params["final_norm"])
    logits = dense(x, params["lm_head"])
    return logits, lb


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    b, t = tokens.shape
    return params["embed"].index_select(0, tokens.reshape(-1)).reshape(b, t, -1)


def loss_fn(params: Params, cfg: LMConfig, tokens: torch.Tensor, labels: torch.Tensor,
            lb_coef: float = 0.01, mtp_coef: float = 0.3) -> tuple[torch.Tensor, dict]:
    """tokens, labels [B, T] -> (loss, metrics): the float32 cross-entropy of
    the next token (``ce``), the MoE layers' load balance (``load_balance``,
    times ``lb_coef`` in the loss), DeepSeek-V3's MTP loss (``mtp``, times
    ``mtp_coef``) where the config and the tree have the head, and the sum
    (``total``), as JAX's.  The MTP module (depth 1) predicts token t + 2
    from the trunk's state at t and the embedding of label t (token t + 1):
    ``rmsnorm(h) | rmsnorm(embed[labels])`` -> ``proj`` -> one block (an MoE
    block where the config has MoE; its load balance is not counted) -> the
    shared final norm and ``lm_head``, scored against ``labels`` shifted left
    by one."""
    h, lb = trunk(params, cfg, tokens)
    logits = dense(rmsnorm(h, params["final_norm"]), params["lm_head"])
    loss = softmax_xent(logits, labels)
    metrics = {"ce": loss, "load_balance": lb}
    if cfg.mtp_depth and "mtp" in params:
        b, t = tokens.shape
        positions = torch.arange(t, device=tokens.device).expand(b, t)
        mtp = layer(params["mtp"], 0)
        merged = dense(torch.cat([rmsnorm(h, mtp["norm_h"]), rmsnorm(_embed(params, labels), mtp["norm_e"])], -1),
                       mtp["proj"])
        h2, _ = _block_apply(mtp["block"], cfg, bool(cfg.moe), merged, positions)
        logits2 = dense(rmsnorm(h2, params["final_norm"]), params["lm_head"])
        mtp_loss = softmax_xent(logits2[:, :-1], labels[:, 1:])
        metrics["mtp"] = mtp_loss
        loss = loss + mtp_coef * mtp_loss
    loss = loss + lb_coef * lb
    metrics["total"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=torch.float32, device="cuda") -> Params:
    """Stacked per-layer caches, one per layer stack ("dense", "moe"), zeros,
    on the card unless ``device`` says ``"cpu"`` (or ``"meta"``: shapes
    only).  GQA: k/v [L, B, S, Hkv, dh]; MLA: the compressed latent
    [L, B, S, kv_lora + rope] (MLA's memory advantage)."""
    device = torch.device(device)
    if device.type != "meta":
        device = resolve_device(device)
    cache: Params = {}
    for _, key, n, _ in _stacks(cfg):
        if cfg.attn == "mla":
            shape = (n, batch, max_seq, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)
            cache[key] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        shape = (n, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
        cache[key] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
    return cache


def _decode_stack(p_stack, cache_stack, n, cfg, moe_layer, x, positions, index):
    for i in range(n):
        # views of layer i's cache, written in place
        kv = cache_stack[i] if cfg.attn == "mla" else (cache_stack["k"][i], cache_stack["v"][i])
        x, _ = _block_apply(layer(p_stack, i), cfg, moe_layer, x, positions, kv, index)
    return x


def decode_step(params: Params, cfg: LMConfig, cache: Params, tokens: torch.Tensor, index: int):
    """One decode step: tokens [B, 1] at position ``index`` against a cache of
    length max_seq.  Returns (logits [B, vocab], cache): the new keys and
    values (MLA: latents) are written into ``cache`` in place, and it is
    returned."""
    b = tokens.shape[0]
    x = params["embed"].index_select(0, tokens.reshape(-1)).reshape(b, 1, -1)
    positions = torch.full((b, 1), index, dtype=torch.int32, device=tokens.device)
    for key, cache_key, n, moe_layer in _stacks(cfg):
        x = _decode_stack(params[key], cache[cache_key], n, cfg, moe_layer, x, positions, index)
    x = rmsnorm(x, params["final_norm"])
    logits = dense(x, params["lm_head"])[:, 0]
    return logits, cache
