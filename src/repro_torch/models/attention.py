"""Attention for the LM family (twin of ``repro/models/attention.py``):
grouped-query attention with RoPE, qk-norm and a KV cache, and DeepSeek-V3's
multi-head latent attention (MLA) with its compressed-latent cache.  Shapes:
x [B, T, D]; GQA caches [B, S, Hkv, dh]; the MLA cache [B, S, kv_lora + rope].

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

MLA goes to the same kernel, with a query/key width (no-RoPE + RoPE dims,
192 in DeepSeek-V3) other than its value width (128): JAX adds two logits
einsums, one over the no-RoPE dims and one over the RoPE dims against a key
shared by every head; one dot product over the concatenated dims is the same
function.  :func:`_mla_attend` and :func:`_mla_chunked_causal`, JAX's plain
branches, are kept as the reference; on the CPU they also take the widths
the kernel has no pair for (the smoke config's 24 / 16), which the kernel's
wrapper refuses on both devices.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.attention import gqa_flash
from ..kernels.attention.ops import HEAD_DIMS
from .common import Params, dense_params, norm_params
from .layers import dense, rmsnorm

__all__ = ["GQAConfig", "MLAConfig", "rope_freqs", "apply_rope", "gqa_init", "gqa_apply", "mla_init",
           "mla_apply", "causal_mask", "decode_mask", "CHUNK_MIN_T", "Q_CHUNK"]


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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3, arXiv:2412.19437)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 1e4

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def mla_init(gen: torch.Generator, cfg: MLAConfig, dtype=torch.float32, device=None) -> Params:
    device = device or gen.device
    kw = dict(bias=False, dtype=dtype, device=device)
    h = cfg.n_heads
    return {
        "wdq": dense_params(gen, cfg.d_model, cfg.q_lora_rank, **kw),
        "q_norm": norm_params(cfg.q_lora_rank, bias=False, dtype=dtype, device=device),
        "wuq": dense_params(gen, cfg.q_lora_rank, h * cfg.qk_head_dim, **kw),
        "wdkv": dense_params(gen, cfg.d_model, cfg.kv_lora_rank, **kw),
        "kv_norm": norm_params(cfg.kv_lora_rank, bias=False, dtype=dtype, device=device),
        "wukv": dense_params(gen, cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim), **kw),
        "wkr": dense_params(gen, cfg.d_model, cfg.qk_rope_head_dim, **kw),
        "wo": dense_params(gen, h * cfg.v_head_dim, cfg.d_model, **kw),
    }


def mla_apply(
    p: Params,
    cfg: MLAConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: torch.Tensor | None = None,
    cache_index: int | None = None,
):
    """Multi-head latent attention -> (out, cache).  The cache holds only
    the compressed latent, ``kv_lora + rope`` values a token.

    Prefill: ``cache=None``, causal attention over the T tokens.  Decode:
    ``cache`` the latent [B, S_max, kv_lora + rope] and ``cache_index`` the
    write position of the one new token (T = 1): its latent is written into
    the cache in place, and only the prefix 0..cache_index is expanded
    through ``wukv`` and attended (JAX expands and masks all S_max rows; a
    masked row's weight is exactly 0, so the outputs are equal)."""
    b, t, _ = x.shape
    h, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = rmsnorm(dense(x, p["wdq"]), p["q_norm"])
    q = dense(cq, p["wuq"]).reshape(b, t, h, cfg.qk_head_dim)
    # [q_nope | q_rope]: the rotation written over the RoPE dims in place
    # (q is this call's own tensor), so q goes to the kernel without a copy
    q[..., nope:] = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    ckv = rmsnorm(dense(x, p["wdkv"]), p["kv_norm"])  # [B, T, kv_lora]
    k_rope_new = apply_rope(dense(x, p["wkr"])[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    latent = torch.cat([ckv, k_rope_new], dim=-1)  # [B, T, kv_lora + rope]
    if cache is not None:
        if t != 1:
            raise NotImplementedError(f"decode takes one token per step, got {t}")
        cache[:, cache_index] = latent[:, 0]
        latent = cache[:, :cache_index + 1]  # the prefix: a view, no copy
    s = latent.shape[1]
    kv = dense(latent[..., :cfg.kv_lora_rank], p["wukv"]).reshape(b, s, h, nope + cfg.v_head_dim)
    if x.device.type == "cpu" and (cfg.qk_head_dim, cfg.v_head_dim) not in HEAD_DIMS:
        # widths the kernel has no pair for (the smoke config's 24 / 16): JAX's
        # plain branches, on the CPU only -- a CUDA tensor goes to the
        # kernel's wrapper below, which refuses them
        out = _mla_plain(q[..., :nope], q[..., nope:], kv[..., :nope], latent[..., cfg.kv_lora_rank:],
                         kv[..., nope:], cfg.qk_head_dim ** -0.5, causal=cache is None)
    else:
        # keys [k_nope | k_rope], the RoPE key shared by every head; the
        # values a strided view of the expansion's value half
        k_rope = latent[:, :, None, cfg.kv_lora_rank:].expand(b, s, h, rope)
        k = torch.cat([kv[..., :nope], k_rope], dim=-1)
        out = gqa_flash(q, k, kv[..., nope:], causal=cache is None)
    out = dense(out.reshape(b, t, h * cfg.v_head_dim), p["wo"])
    return out, cache


def _mla_plain(q_nope, q_rope, k_nope, k_rope, v, scale, *, causal: bool):
    """JAX's plain MLA attention as its ``mla_apply`` picks it: causal
    (chunked at T >= ``CHUNK_MIN_T``, T a multiple of ``Q_CHUNK``), or one
    query that sees every key given (a decode step over the cache's prefix)."""
    t, s = q_nope.shape[1], k_nope.shape[1]
    if causal and t >= CHUNK_MIN_T and t % Q_CHUNK == 0:
        return _mla_chunked_causal(q_nope, q_rope, k_nope, k_rope, v, scale)
    mask = causal_mask(t, q_nope.device) if causal else decode_mask(s, s - 1, q_nope.device)
    return _mla_attend(q_nope, q_rope, k_nope, k_rope, v, mask, scale)


def _mla_attend(q_nope, q_rope, k_nope, k_rope, v, mask, scale):
    """JAX's plain MLA attention: q_nope [B,T,H,n], q_rope [B,T,H,r],
    k_nope [B,S,H,n], k_rope [B,S,r] (shared by the heads), v [B,S,H,dv],
    mask as JAX's (causal_mask [1,1,1,T,T] or decode_mask [1,1,1,1,S]) ->
    [B,T,H,dv]; the logits in q's type, the softmax in float32, the
    probabilities cast back."""
    logits = (torch.einsum("bthd,bshd->bhts", q_nope, k_nope)
              + torch.einsum("bthd,bsd->bhts", q_rope, k_rope)) * scale
    logits = torch.where(mask[:, :, 0] if mask.dim() == 5 else mask, logits, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q_nope.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _mla_chunked_causal(q_nope, q_rope, k_nope, k_rope, v, scale, chunk=Q_CHUNK):
    """Causal :func:`_mla_attend` over blocks of ``chunk`` queries (T a
    multiple of ``chunk``), as JAX's scan."""
    kv_pos = torch.arange(k_nope.shape[1], device=q_nope.device)
    outs = []
    for blk in range(q_nope.shape[1] // chunk):
        rows = slice(blk * chunk, (blk + 1) * chunk)
        q_pos = blk * chunk + torch.arange(chunk, device=q_nope.device)
        mask = (q_pos[:, None] >= kv_pos[None, :])[None, None]
        outs.append(_mla_attend(q_nope[:, rows], q_rope[:, rows], k_nope, k_rope, v, mask, scale))
    return torch.cat(outs, dim=1)


def causal_mask(t: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))[None, None, None]  # [1,1,1,T,T]


def decode_mask(s_max: int, cache_index: int, device=None) -> torch.Tensor:
    """[1,1,1,1,S]: positions <= cache_index are visible."""
    return (torch.arange(s_max, device=device) <= cache_index)[None, None, None, None]
