"""Grouped-query attention for the LM family, with RoPE, qk-norm and a KV cache
(twin of the GQA half of ``repro/models/attention.py``; MLA waits, see
``ROADMAP.md``).  Shapes: x [B, T, D]; caches [B, S, Hkv, dh].

The attention itself goes to the flash-attention kernel's wrapper
(:func:`~repro_torch.kernels.attention.gqa_flash`), which reads a KV head
shared by several query heads by index and takes its plain version for CPU
tensors.  JAX runs the plain ``_sdpa`` here (or ``_sdpa_chunked_causal`` at
T >= 4096) and names the Pallas kernel its on-device analogue; the kernel
computes the same function.  The mask is therefore not an argument: without a
cache the attention is causal (JAX's :func:`causal_mask`), and with one the
single new token sees the keys ``0..index`` (JAX's :func:`decode_mask`), which
the kernel reads as the cache's prefix, a strided view.  The plain
:func:`_sdpa` and :func:`_sdpa_chunked_causal` are kept, with the masks, as
the reference the tests hold the kernel's path to.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.attention import gqa_flash
from .common import Params, dense_params, norm_params
from .layers import dense, rmsnorm

__all__ = ["GQAConfig", "rope_freqs", "apply_rope", "gqa_init", "gqa_apply", "causal_mask",
           "decode_mask", "CHUNK_MIN_T", "Q_CHUNK"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(d: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, H, d]; positions: [B, T] (absolute).  The angles are float32
    positions times float32 frequencies, the rotation is in float32 and the
    result is cast to x's type, as JAX."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # [d/2]
    ang = positions[..., None].float() * freqs  # [B, T, d/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GQAConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qk_norm: bool = False
    rope_theta: float = 1e6


def gqa_init(gen: torch.Generator, cfg: GQAConfig, dtype=torch.float32, device=None) -> Params:
    device = device or gen.device
    kw = dict(bias=False, dtype=dtype, device=device)
    p = {
        "wq": dense_params(gen, cfg.d_model, cfg.n_heads * cfg.d_head, **kw),
        "wk": dense_params(gen, cfg.d_model, cfg.n_kv_heads * cfg.d_head, **kw),
        "wv": dense_params(gen, cfg.d_model, cfg.n_kv_heads * cfg.d_head, **kw),
        "wo": dense_params(gen, cfg.n_heads * cfg.d_head, cfg.d_model, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_params(cfg.d_head, bias=False, dtype=dtype, device=device)
        p["k_norm"] = norm_params(cfg.d_head, bias=False, dtype=dtype, device=device)
    return p


CHUNK_MIN_T = 4096  # JAX's query lengths >= this use its O(S)-memory chunked path
Q_CHUNK = 1024


def _sdpa(q, k, v, mask, scale):
    """Plain attention, JAX's rounding: q [B,T,H,d], k/v [B,S,Hkv,d], mask
    broadcastable to [B,Hkv,G,T,S] -> [B,T,H,d]; the logits in q's type,
    masked to its lowest finite value, the softmax in float32, the
    probabilities cast back."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q = q.reshape(b, t, hkv, g, d)
    logits = torch.einsum("bthgd,bshd->bhgts", q, k) * scale
    logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return out.reshape(b, t, h, d)


def _sdpa_chunked_causal(q, k, v, scale, chunk=Q_CHUNK):
    """Causal :func:`_sdpa` over blocks of ``chunk`` queries (T a multiple
    of ``chunk``): one [B, H, chunk, S] logits block at a time, as JAX's
    scan."""
    kv_pos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for blk in range(q.shape[1] // chunk):
        q_pos = blk * chunk + torch.arange(chunk, device=q.device)
        mask = (q_pos[:, None] >= kv_pos[None, :])[None, None, None]
        outs.append(_sdpa(q[:, blk * chunk:(blk + 1) * chunk], k, v, mask, scale))
    return torch.cat(outs, dim=1)


def gqa_apply(
    p: Params,
    cfg: GQAConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_index: int | None = None,
):
    """Returns (out, (k, v)).

    Prefill: ``kv=None``, causal attention over the T tokens; (k, v) are this
    call's keys and values.  Decode: ``kv`` the full caches [B, S_max, Hkv,
    dh], ``cache_index`` the write position of the one new token (T = 1);
    its keys and values are written into the caches in place, and the caches
    are returned."""
    b, t, _ = x.shape
    q = dense(x, p["wq"]).reshape(b, t, cfg.n_heads, cfg.d_head)
    k = dense(x, p["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    v = dense(x, p["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv is None:
        out = gqa_flash(q, k, v, causal=True)
    else:
        if t != 1:
            raise NotImplementedError(f"decode takes one token per step, got {t}")
        k_cache, v_cache = kv
        k_cache[:, cache_index] = k[:, 0]
        v_cache[:, cache_index] = v[:, 0]
        # the keys 0..cache_index: a strided view of the caches, no copy
        n = cache_index + 1
        out = gqa_flash(q, k_cache[:, :n], v_cache[:, :n], causal=False)
        k, v = k_cache, v_cache
    out = dense(out.reshape(b, t, cfg.n_heads * cfg.d_head), p["wo"])
    return out, (k, v)


def causal_mask(t: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))[None, None, None]  # [1,1,1,T,T]


def decode_mask(s_max: int, cache_index: int, device=None) -> torch.Tensor:
    """[1,1,1,1,S]: positions <= cache_index are visible."""
    return (torch.arange(s_max, device=device) <= cache_index)[None, None, None, None]
