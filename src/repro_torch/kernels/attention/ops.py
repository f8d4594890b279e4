"""Wrappers of the Hopper flash-attention kernel (``attention.cu``), the
counterparts of ``repro/kernels/attention/attention.py: flash_attention`` and
``repro/kernels/attention/ops.py: gqa_flash``.

For CPU tensors they run the plain version (:func:`.ref.attention_ref`); for
CUDA tensors they launch the kernel or raise -- there is no fallback.  The
operands are read in place through their batch/head/row strides (the head
dimension must be dense), so the model layout [B, T, H, D] goes to the kernel
as a transposed view, without a copy, and a KV head shared by several query
heads is indexed, never repeated.  v may be narrower than q and k (MLA: a
query/key width of 192, a value width of 128); the output has v's width and
is allocated here, in q's memory layout where q is dense.  Under autograd
both go through :class:`FlashAttentionFunction`: K3 forward, and a plain
float32 backward chunked over query rows (:func:`attention_backward`); JAX's
models differentiate einsums with XLA and have no Pallas backward.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .._build import load_library
from .ref import attention_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's block shapes, by its index: (query rows, key groups)
BLOCK_SHAPES = ((16, 4), (32, 4), (64, 1))
# the kernel's (query/key, value) head widths: attention.cu's K3_PAIRS, then
# attention_diffusion.cu's (its own library) -- UNet-SD1.5's 8 heads over
# 320 / 640 / 1280 channels (40, 80, 160) and DiT-XL/2's 16 heads over 1152 (72)
DIFFUSION_HEAD_DIMS = ((40, 40), (72, 72), (80, 80), (160, 160))
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128)) + DIFFUSION_HEAD_DIMS
MAX_GRID_Y = 65535  # B*H blocks along the grid's second axis
INT32_MAX = 2**31 - 1


def _lib_for(d: int, dv: int) -> ctypes.CDLL:
    """The library that compiles the width pair (d, dv)."""
    return _lib("attention_diffusion" if (d, dv) in DIFFUSION_HEAD_DIMS else "attention")


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    lib = load_library(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [
        p, p, p, p, i,                          # q, k, v, o, dtype
        i, i, i, i, i, i, i,                    # b, h, hkv, t, s, d, dv
        ctypes.POINTER(ctypes.c_longlong),      # strides [12]
        ctypes.c_float, i, i, p,                # scale, causal, device, stream
    ]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_shape.argtypes = [
        p, p, p, i, i, i, i, i, i, i, i,        # q, k, v, dtype, b, h, hkv, t, s, d, dv
        ctypes.POINTER(ctypes.c_longlong), i, i,  # strides [12], causal, device
    ]
    lib.flash_attention_shape.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn: str, q, k, v) -> None:
    """Raise on operands the kernel does not take ([B,H,T,D] q, [B,Hkv,S,D]
    k, [B,Hkv,S,DV] v, (D, DV) one of ``HEAD_DIMS``); checked alike on both
    devices, so a CPU call shows what the card would refuse."""
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{fn} takes CPU, CUDA or meta tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{fn} needs 4-d q, k, v, got {q.dim()}, {k.dim()}, {v.dim()}")
    b, h, t, d = q.shape
    dv = v.shape[3]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{fn}: k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    hkv = k.shape[1]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{fn}: {h} query heads are not a multiple of {hkv} KV heads")
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"{fn}: head widths (query/key {d}, value {dv}) are not one of the kernel's "
                         f"pairs {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{fn} takes float32 or bfloat16, got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise TypeError(f"{name} is {x.dtype} on {x.device}, q is {q.dtype} on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or min(x.stride()) < 0:
            raise ValueError(f"the head dimension of {name} must be dense, got strides {x.stride()}")
    if b * h > MAX_GRID_Y or max(t, k.shape[2]) > INT32_MAX:
        raise ValueError(f"{fn}: B*H = {b * h} exceeds {MAX_GRID_Y} or T/S the 32-bit range")


def launch_config(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True) -> dict:
    """The block shape the kernel takes for ``flash_attention(q, k, v)`` on
    the card ([B, H, T, D] operands, read through their strides): query rows
    x key groups and the grid's blocks.  Launches nothing."""
    _check("launch_config", q, k, v)
    if q.device.type != "cuda":
        raise ValueError("launch_config describes a launch on the card")
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 12)(*[st for x in (q, k, v, q) for st in x.stride()[:3]])
    lib = _lib_for(d, v.shape[3])
    c = lib.flash_attention_shape(q.data_ptr(), k.data_ptr(), v.data_ptr(), DTYPE_CODES[q.dtype], b, h,
                                  k.shape[1], t, k.shape[2], d, v.shape[3], strides, int(causal),
                                  q.device.index or 0)
    if c < 0:
        raise RuntimeError(f"flash attention has no block shape here: {lib.kernel_error_string(-c).decode()}")
    rows, groups = BLOCK_SHAPES[c]
    return {"block": f"{rows}x{groups}", "blocks": -(-t // rows) * b * h}


def _output(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An empty [B, H, T, DV] output, dense, its dimensions in the order of
    q's strides (a transposed view of the model layout stays one)."""
    order = sorted(range(4), key=lambda i: -q.stride(i))
    o = q.new_empty([(tuple(q.shape[:3]) + (dv,))[i] for i in order])
    return o.permute([order.index(i) for i in range(4)])


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    """Allocate the output and enqueue the kernel (arguments checked, output
    not empty); raises if the launch is refused."""
    b, h, t, d = q.shape
    dv = v.shape[3]
    o = _output(q, dv)
    strides = (ctypes.c_longlong * 12)(*[st for x in (q, k, v, o) for st in x.stride()[:3]])
    lib = _lib_for(d, dv)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), DTYPE_CODES[q.dtype],
        b, h, k.shape[1], t, k.shape[2], d, dv, strides, 1.0 / math.sqrt(d), int(causal),
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: {lib.kernel_error_string(err).decode()}")
    flash_attention.launches += 1
    return o


def _attend(q, k, v, causal: bool) -> torch.Tensor:
    """Attention on checked [B, H, T, D] operands whose KV heads divide H:
    the plain version on the CPU (KV heads repeated), an empty output of
    the kernel's shape on ``meta`` (the dry run: shapes only), else the
    kernel."""
    if q.device.type == "cpu":
        g = q.shape[1] // k.shape[1]
        if g > 1:
            k, v = (x.repeat_interleave(g, dim=1) for x in (k, v))
        return attention_ref(q, k, v, causal=causal)
    if q.numel() == 0 or q.device.type == "meta":  # nothing to compute: no launch, no count
        return _output(q, v.shape[3])
    return _launch(q, k, v, causal)


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention(
    q: torch.Tensor,  # [B, H, T, D]
    k: torch.Tensor,  # [B, H, S, D]
    v: torch.Tensor,  # [B, H, S, DV]
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Online-softmax attention, scale 1/sqrt(D), the causal mask aligned
    top-left; output [B, H, T, DV] in q's dtype.  Any T and S (no block
    multiples); (D, DV) one of ``HEAD_DIMS``.  Where grad is enabled and an
    operand requires it, through :class:`FlashAttentionFunction`."""
    _check("flash_attention", q, k, v)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"flash_attention: k has {k.shape[1]} heads, q {q.shape[1]} (use gqa_flash)")
    if _needs_grad(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, causal)
    return _attend(q, k, v, causal)


def gqa_flash(
    q: torch.Tensor,  # [B, T, H, D]  (model layout)
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, DV]
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Grouped-query flash attention in the model layout: query head ``h``
    reads KV head ``h // (H / Hkv)``; output [B, T, H, DV]."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, T, D] views
    _check("gqa_flash", qt, kt, vt)
    if _needs_grad(q, k, v):
        return FlashAttentionFunction.apply(qt, kt, vt, causal).transpose(1, 2)
    return _attend(qt, kt, vt, causal).transpose(1, 2)


# float32 scores (and as many probabilities and score gradients) that one
# chunk of query rows of the backward holds at once
BACKWARD_SCORE_BYTES = 256 * 2**20


def attention_backward(q, k, v, o, do, causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of K3's attention for the output cotangent ``do``, plain
    PyTorch in float32, a chunk of query rows at a time (at most
    ``BACKWARD_SCORE_BYTES`` of scores).  q [B, H, T, D], k [B, Hkv, S, D],
    v [B, Hkv, S, DV], the saved output o and do [B, H, T, DV]; query head
    ``h`` reads KV head ``h // (H / Hkv)``, so dk and dv sum over each KV
    head's group.  P is recomputed with K3's scale 1/sqrt(D) and top-left
    causal mask; dV = P^T dO, dS = P * (dO V^T - rowsum(dO * O)),
    dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D).  Each gradient in its
    operand's type."""
    b, h, t, d = q.shape
    hkv, s, dv_ = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, hkv, g, t, d)
    of, dof = (x.float().reshape(b, hkv, g, t, dv_) for x in (o, do))
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(qf)
    dk = torch.zeros((b, hkv, s, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, hkv, s, dv_), dtype=torch.float32, device=q.device)
    rows = max(1, BACKWARD_SCORE_BYTES // (4 * b * h * s))
    keys = torch.arange(s, device=q.device)
    for t0 in range(0, t, rows):
        t1 = min(t, t0 + rows)
        qc, oc, doc = qf[:, :, :, t0:t1], of[:, :, :, t0:t1], dof[:, :, :, t0:t1]
        scores = torch.einsum("bhgtd,bhsd->bhgts", qc, kf) * scale
        if causal:
            seen = torch.arange(t0, t1, device=q.device)[:, None] >= keys[None, :]
            scores = scores.masked_fill(~seen, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        del scores
        dv += torch.einsum("bhgts,bhgtd->bhsd", p, doc)
        dp = torch.einsum("bhgtd,bhsd->bhgts", doc, vf)
        ds = p * (dp - (doc * oc).sum(dim=-1, keepdim=True))
        del p, dp
        dq[:, :, :, t0:t1] = torch.einsum("bhgts,bhsd->bhgtd", ds, kf) * scale
        dk += torch.einsum("bhgts,bhgtd->bhsd", ds, qc) * scale
    return dq.reshape(b, h, t, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """K3 under autograd on [B, H, T, D] operands (KV heads dividing H): the
    forward is the kernel (the plain version on the CPU), the backward
    :func:`attention_backward` on the saved output."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o = _attend(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        with torch.profiler.record_function("K3 backward"):
            dq, dk, dv = attention_backward(q, k, v, o, do, ctx.causal)
        return dq, dk, dv, None


# Kernel launches so far in this process, by either wrapper (CPU calls do not count).
flash_attention.launches = 0
