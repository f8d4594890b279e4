"""Wrappers of the Hopper flash-attention kernel (``attention.cu``), the
counterparts of ``repro/kernels/attention/attention.py: flash_attention`` and
``repro/kernels/attention/ops.py: gqa_flash``.

For CPU tensors they run the plain version (:func:`.ref.attention_ref`); for
CUDA tensors they launch the kernel or raise -- there is no fallback.  The
operands are read in place through their batch/head/row strides (the head
dimension must be dense), so the model layout [B, T, H, D] goes to the kernel
as a transposed view, without a copy, and a KV head shared by several query
heads is indexed, never repeated.  The output is allocated here, in q's memory
layout where q is dense.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .._build import load_library
from .ref import attention_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_GRID_Y = 65535  # B*H blocks along the grid's second axis
INT32_MAX = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [
        p, p, p, p, i,                          # q, k, v, o, dtype
        i, i, i, i, i, i,                       # b, h, hkv, t, s, d
        ctypes.POINTER(ctypes.c_longlong),      # strides [12]
        ctypes.c_float, i, i, p,                # scale, causal, device, stream
    ]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn: str, q, k, v) -> None:
    """Raise on operands the kernel does not take ([B,H,T,D] q, [B,Hkv,S,D]
    k and v); checked alike on both devices."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} takes CPU or CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{fn} needs 4-d q, k, v, got {q.dim()}, {k.dim()}, {v.dim()}")
    b, h, t, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{fn}: k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    hkv = k.shape[1]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{fn}: {h} query heads are not a multiple of {hkv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dimension {d} not in {HEAD_DIMS}")
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


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    """Allocate the output and enqueue the kernel (arguments checked, output
    not empty); raises if the launch is refused."""
    b, h, t, d = q.shape
    o = torch.empty_like(q)  # q's strides where q is dense (a transposed view stays one)
    strides = (ctypes.c_longlong * 12)(*[st for x in (q, k, v, o) for st in x.stride()[:3]])
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), DTYPE_CODES[q.dtype],
        b, h, k.shape[1], t, k.shape[2], d, strides, 1.0 / math.sqrt(d), int(causal),
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: {lib.kernel_error_string(err).decode()}")
    flash_attention.launches += 1
    return o


def flash_attention(
    q: torch.Tensor,  # [B, H, T, D]
    k: torch.Tensor,  # [B, H, S, D]
    v: torch.Tensor,  # [B, H, S, D]
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Online-softmax attention, scale 1/sqrt(D), the causal mask aligned
    top-left; output [B, H, T, D] in q's dtype.  Any T and S (no block
    multiples); D in {16, 32, 64, 128}."""
    _check("flash_attention", q, k, v)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"flash_attention: k has {k.shape[1]} heads, q {q.shape[1]} (use gqa_flash)")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if q.numel() == 0:  # nothing to compute: no launch, no count
        return torch.empty_like(q)
    return _launch(q, k, v, causal)


def gqa_flash(
    q: torch.Tensor,  # [B, T, H, D]  (model layout)
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Grouped-query flash attention in the model layout: query head ``h``
    reads KV head ``h // (H / Hkv)``; output [B, T, H, D]."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, T, D] views
    _check("gqa_flash", qt, kt, vt)
    if q.device.type == "cpu":
        g = qt.shape[1] // kt.shape[1]
        kt, vt = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
        return attention_ref(qt, kt, vt, causal=causal).transpose(1, 2)
    if q.numel() == 0:
        return torch.empty_like(q)
    return _launch(qt, kt, vt, causal).transpose(1, 2)


# Kernel launches so far in this process, by either wrapper (CPU calls do not count).
flash_attention.launches = 0
