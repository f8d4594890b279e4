"""Stable-Diffusion-1.5 U-Net (Rombach et al., arXiv:2112.10752) -- unet-sd15
(twin of ``repro/models/unet.py``).

Latent-space U-Net: ch=320, ch_mult=(1,2,4,4), 2 res blocks per level,
self + cross attention (ctx_dim=768) at downsample factors 1/2/4, timestep
conditioning.  Every conv -- 3x3 pad 1, the 1x1 skips, the stride-2
downsamples, conv_in and conv_out -- goes through K1; every attention,
self (T = S = h w) and cross (S = ``ctx_len``), through K3 (not causal,
scale 1/sqrt(D); D = 40 / 80 / 160 at SD-1.5's widths) where JAX writes two
einsums; group norms, layer norms, the GEGLU and the products stay plain.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.attention import attention_ref, flash_attention
from ..kernels.attention.ops import HEAD_DIMS
from .common import Params, conv_params, dense_params, norm_params
from .dit import timestep_embedding
from .layers import conv2d, dense, gelu, groupnorm, layernorm, silu

__all__ = ["UNetConfig", "init", "apply"]


@dataclass(frozen=True)
class UNetConfig:
    name: str = "unet-sd15"
    img_res: int = 512
    latent_ch: int = 4
    ch: int = 320
    ch_mult: tuple[int, ...] = (1, 2, 4, 4)
    n_res_blocks: int = 2
    attn_down: tuple[int, ...] = (1, 2, 4)  # downsample factors with attention
    ctx_dim: int = 768
    ctx_len: int = 77
    n_heads: int = 8
    groups: int = 32
    attn_f32: bool = True  # JAX: f32 softmax; False keeps it in bf16 (K3's is always f32)

    @property
    def latent_res(self) -> int:
        return self.img_res // 8


def _res_init(gen, c_in, c_out, temb_dim, dtype, device) -> Params:
    kw = dict(dtype=dtype, device=device)
    p = {
        "n1": norm_params(c_in, **kw),
        "c1": conv_params(gen, 3, c_in, c_out, **kw),
        "temb": dense_params(gen, temb_dim, c_out, **kw),
        "n2": norm_params(c_out, **kw),
        "c2": conv_params(gen, 3, c_out, c_out, **kw),
    }
    if c_in != c_out:
        p["skip"] = conv_params(gen, 1, c_in, c_out, **kw)
    return p


def _res_apply(p: Params, x: torch.Tensor, temb: torch.Tensor, groups: int) -> torch.Tensor:
    h = conv2d(silu(groupnorm(x, p["n1"], groups)), p["c1"], padding=1)
    h = h + dense(silu(temb), p["temb"])[:, None, None, :]
    h = conv2d(silu(groupnorm(h, p["n2"], groups)), p["c2"], padding=1)
    skip = conv2d(x, p["skip"], padding="VALID") if "skip" in p else x
    return skip + h


def _attn_init(gen, c, ctx_dim, dtype, device) -> Params:
    kw = dict(dtype=dtype, device=device)
    return {
        "norm": norm_params(c, **kw),
        "proj_in": dense_params(gen, c, c, **kw),
        # self-attention
        "sq": dense_params(gen, c, c, bias=False, **kw),
        "sk": dense_params(gen, c, c, bias=False, **kw),
        "sv": dense_params(gen, c, c, bias=False, **kw),
        "so": dense_params(gen, c, c, **kw),
        "n1": norm_params(c, **kw),
        # cross-attention to the text context
        "cq": dense_params(gen, c, c, bias=False, **kw),
        "ck": dense_params(gen, ctx_dim, c, bias=False, **kw),
        "cv": dense_params(gen, ctx_dim, c, bias=False, **kw),
        "co": dense_params(gen, c, c, **kw),
        "n2": norm_params(c, **kw),
        # geglu ffn
        "ff1": dense_params(gen, c, 8 * c, **kw),
        "ff2": dense_params(gen, 4 * c, c, **kw),
        "n3": norm_params(c, **kw),
        "proj_out": dense_params(gen, c, c, **kw),
    }


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, f32: bool = True) -> torch.Tensor:
    """Multi-head attention of q [B, N, C] over k / v [B, M, C], heads of
    C / heads: K3 on [B, H, N, D] views (no copy), not causal.  ``f32`` is
    JAX's softmax precision; K3's softmax is float32 either way (P rounded
    to bf16 before PV in bf16), held to JAX's bf16 softmax at bf16's
    tolerance.  On a CPU tensor whose width K3 has no pair for (the SMOKE
    config's D = 8) the plain version runs directly; no full-width path
    takes this route, and on the card the wrapper refuses such a width."""
    b, n, c = q.shape
    m = k.shape[1]
    d = c // heads
    qh = q.reshape(b, n, heads, d).transpose(1, 2)
    kh, vh = (x.reshape(b, m, heads, d).transpose(1, 2) for x in (k, v))
    if q.device.type == "cpu" and (d, d) not in HEAD_DIMS:
        out = attention_ref(qh, kh, vh, causal=False)
    else:
        out = flash_attention(qh, kh, vh, causal=False)
    return out.transpose(1, 2).reshape(b, n, c)


def _ln(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    return layernorm(x, p, eps)


def _attn_apply(p: Params, x: torch.Tensor, ctx: torch.Tensor, heads: int, groups: int,
                f32: bool = True) -> torch.Tensor:
    b, h, w, c = x.shape
    res = x
    xn = groupnorm(x, p["norm"], groups)
    t = dense(xn.reshape(b, h * w, c), p["proj_in"])
    # self
    tn = _ln(t, p["n1"])
    t = t + dense(_mha(dense(tn, p["sq"]), dense(tn, p["sk"]), dense(tn, p["sv"]), heads, f32), p["so"])
    # cross
    tn = _ln(t, p["n2"])
    t = t + dense(_mha(dense(tn, p["cq"]), dense(ctx, p["ck"]), dense(ctx, p["cv"]), heads, f32), p["co"])
    # geglu
    tn = _ln(t, p["n3"])
    a, g = dense(tn, p["ff1"]).chunk(2, dim=-1)
    t = t + dense(a * gelu(g), p["ff2"])
    return res + dense(t, p["proj_out"]).reshape(b, h, w, c)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of NHWC x (``jax.image.resize(..., "nearest")``):
    output row i reads input row i // 2, and so for columns; one copy."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def init(gen: torch.Generator, cfg: UNetConfig, dtype=torch.float32, device=None) -> Params:
    """Random parameters from ``gen``, on its device unless ``device`` is
    given (``"meta"``: shapes only), in JAX's tree."""
    device = device or gen.device
    kw = dict(dtype=dtype, device=device)
    ch = cfg.ch
    temb_dim = 4 * ch
    p: Params = {
        "t1": dense_params(gen, ch, temb_dim, **kw),
        "t2": dense_params(gen, temb_dim, temb_dim, **kw),
        "conv_in": conv_params(gen, 3, cfg.latent_ch, ch, **kw),
        "down": [],
        "mid": {},
        "up": [],
        "norm_out": norm_params(ch, **kw),
        "conv_out": conv_params(gen, 3, ch, cfg.latent_ch, **kw),
    }
    chans = [ch]  # skip-connection channel bookkeeping
    c_cur = ch
    for li, mult in enumerate(cfg.ch_mult):
        c_out = ch * mult
        level = {"res": [], "attn": []}
        has_attn = 2**li in cfg.attn_down
        for _ in range(cfg.n_res_blocks):
            level["res"].append(_res_init(gen, c_cur, c_out, temb_dim, dtype, device))
            level["attn"].append(_attn_init(gen, c_out, cfg.ctx_dim, dtype, device) if has_attn else {})
            c_cur = c_out
            chans.append(c_cur)
        if li + 1 < len(cfg.ch_mult):
            level["downsample"] = conv_params(gen, 3, c_cur, c_cur, **kw)
            chans.append(c_cur)
        p["down"].append(level)
    p["mid"] = {
        "res1": _res_init(gen, c_cur, c_cur, temb_dim, dtype, device),
        "attn": _attn_init(gen, c_cur, cfg.ctx_dim, dtype, device),
        "res2": _res_init(gen, c_cur, c_cur, temb_dim, dtype, device),
    }
    for li, mult in reversed(list(enumerate(cfg.ch_mult))):
        c_out = ch * mult
        level = {"res": [], "attn": []}
        has_attn = 2**li in cfg.attn_down
        for _ in range(cfg.n_res_blocks + 1):
            c_skip = chans.pop()
            level["res"].append(_res_init(gen, c_cur + c_skip, c_out, temb_dim, dtype, device))
            level["attn"].append(_attn_init(gen, c_out, cfg.ctx_dim, dtype, device) if has_attn else {})
            c_cur = c_out
        if li > 0:
            level["upsample"] = conv_params(gen, 3, c_cur, c_cur, **kw)
        p["up"].append(level)
    return p


def apply(params: Params, cfg: UNetConfig, x: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    """x [B, h, w, latent_ch] (latent), t [B], ctx [B, ctx_len, ctx_dim] -> eps."""
    t_emb = timestep_embedding(t, cfg.ch).to(x.dtype)
    temb = dense(silu(dense(t_emb, params["t1"])), params["t2"])
    h = conv2d(x, params["conv_in"], padding=1)
    skips = [h]
    for level in params["down"]:
        for p_res, p_attn in zip(level["res"], level["attn"]):
            h = _res_apply(p_res, h, temb, cfg.groups)
            if p_attn:
                h = _attn_apply(p_attn, h, ctx, cfg.n_heads, cfg.groups, cfg.attn_f32)
            skips.append(h)
        if "downsample" in level:
            h = conv2d(h, level["downsample"], stride=2, padding=1)
            skips.append(h)
    m = params["mid"]
    h = _res_apply(m["res1"], h, temb, cfg.groups)
    h = _attn_apply(m["attn"], h, ctx, cfg.n_heads, cfg.groups, cfg.attn_f32)
    h = _res_apply(m["res2"], h, temb, cfg.groups)
    for level in params["up"]:
        for p_res, p_attn in zip(level["res"], level["attn"]):
            # the channel axis dense, as K1 takes it
            h = torch.cat([h, skips.pop()], dim=-1)
            h = _res_apply(p_res, h, temb, cfg.groups)
            if p_attn:
                h = _attn_apply(p_attn, h, ctx, cfg.n_heads, cfg.groups, cfg.attn_f32)
        if "upsample" in level:
            h = conv2d(_upsample2(h), level["upsample"], padding=1)
    h = silu(groupnorm(h, params["norm_out"], cfg.groups))
    return conv2d(h, params["conv_out"], padding=1)
