"""Wrapper of the Hopper halo-conv kernel (``halo_conv.cu``), the counterpart of
``repro/kernels/halo_conv/halo_conv.py: halo_conv2d``.

For a CPU tensor it runs the plain version (:func:`.ref.halo_conv2d_ref`); for
a CUDA tensor it launches the kernel or raises -- there is no fallback.  The
shard and both halos are read in place (each with its own batch/row/column
strides, dense channels); nothing is concatenated, and the output is
allocated here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import load_library
from ..conv2d.ops import (
    DTYPE_CODES,
    GATHER_NAMES,
    INT32_MAX,
    bind_splits,
    check_operands,
    depthwise_config,
    split_count,
    workspace,
)
from .ref import halo_conv2d_ref


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(load_library("halo_conv"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``halo_conv.cu`` on a loaded library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.halo_conv2d_fwd.argtypes = [
        p, p, p, ctypes.POINTER(ctypes.c_longlong),  # top, shard, bottom, strides [9]
        i, i, i,                                     # lo, hs, hi
        p, p, p, p, i, i,                            # w, bias, y, workspace, splits, dtype
        i, i, i, i, i, i, i, i, i,                   # n, w, cin, cout, k, stride, pad, ho, wo
        i, i, p,                                     # depthwise, device, stream
    ]
    lib.halo_conv2d_fwd.restype = ctypes.c_int
    lib.halo_conv2d_gather.argtypes = [p, p, p, ctypes.POINTER(ctypes.c_longlong), p, i, i, i]
    lib.halo_conv2d_gather.restype = ctypes.c_int
    lib.halo_conv2d_dw_config.argtypes = [p, p, p, ctypes.POINTER(ctypes.c_longlong), p, i, i, i, i, i, i,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.halo_conv2d_dw_config.restype = None
    bind_splits(lib)
    return lib


def _halo_rows(name: str, halo, rows: int | None, x) -> int:
    """Rows of one halo: its height, or ``rows`` zero rows when it is absent."""
    if halo is None:
        rows = rows or 0
        if rows < 0:
            raise ValueError(f"{name} must be >= 0, got {rows}")
        return rows
    b, _, w, c = x.shape
    if halo.dim() != 4 or (halo.shape[0], halo.shape[2], halo.shape[3]) != (b, w, c):
        raise ValueError(f"{name} halo {tuple(halo.shape)} does not fit the shard {tuple(x.shape)}")
    if halo.dtype != x.dtype or halo.device != x.device:
        raise TypeError(f"{name} halo is {halo.dtype} on {halo.device}, x is {x.dtype} on {x.device}")
    if halo.stride(3) != 1 or min(halo.stride()) < 0:
        raise ValueError(f"the channel axis of the {name} halo must be dense, got strides {halo.stride()}")
    if rows is not None and rows != halo.shape[1]:
        raise ValueError(f"{name}={rows} but the {name} halo has {halo.shape[1]} rows")
    return halo.shape[1]


def _check_args(x, top, bot, weights, bias, stride, padding, groups, lo, hi):
    """Raise on what the kernel does not take, as ``halo_conv2d`` does;
    returns (lo, hi, Ho, Wo)."""
    k, cout = check_operands("halo_conv2d_cuda", x, weights, bias, groups)
    lo = _halo_rows("lo", top, lo, x)
    hi = _halo_rows("hi", bot, hi, x)
    if stride < 1 or padding < 0:
        raise ValueError(f"bad stride={stride} / padding={padding}")
    s = stride
    if lo + hi != k - s:
        raise ValueError(
            f"halos must cover the receptive field: need lo + hi == k - s "
            f"(= {k - s}), got lo={lo} hi={hi} for k={k} stride={s}"
        )
    n, hs, w, cin = x.shape
    if hs % s:
        raise ValueError(f"shard rows {hs} not divisible by stride {s}")
    if w + 2 * padding < k:
        raise ValueError(
            f"non-positive output width: padded width {w + 2 * padding} (w={w} + 2*p="
            f"{2 * padding}) < kernel {k}; the map is too narrow to convolve"
        )
    if max(n, lo + hs + hi, w + 2 * padding, cout, k * k * cin) > INT32_MAX:
        raise ValueError("a dimension exceeds the kernel's 32-bit index range")
    return lo, hi, hs // s, (w + 2 * padding - k) // s + 1


def halo_conv2d_cuda(
    x_shard: torch.Tensor,  # [B, Hs, W, C]
    top_halo: torch.Tensor | None,  # [B, lo, W, C]
    bot_halo: torch.Tensor | None,  # [B, hi, W, C]
    weights: torch.Tensor,  # [k, k, Cin, Cout] ([k, k, 1, C] depthwise)
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 1,
    groups: int = 1,
    lo: int | None = None,
    hi: int | None = None,
) -> torch.Tensor:
    """Conv over a height shard with explicit halos; returns the shard's
    ``[B, Hs // stride, W_out, Cout]`` output rows (width zero-padded by
    ``padding`` on each side).

    An absent halo is zero rows: none by default, or ``lo`` / ``hi`` of them
    when given (the capacity-weighted path's zero bottom operand, which then
    never exists in memory).  Raises unless ``lo + hi == k - stride``, unless
    the shard height is a stride multiple, and on a non-positive output width,
    as ``halo_conv2d`` does; the checks run alike on both devices."""
    lo, hi, ho, wo = _check_args(x_shard, top_halo, bot_halo, weights, bias,
                                 stride, padding, groups, lo, hi)
    y, launched = _halo(x_shard, top_halo, bot_halo, weights, bias, stride, padding, groups, lo, hi, ho, wo)
    if launched:
        halo_conv2d_cuda.launches += 1
    return y


def _halo(x_shard, top_halo, bot_halo, weights, bias, stride: int, padding: int, groups: int, lo: int, hi: int,
          ho: int, wo: int) -> tuple[torch.Tensor, bool]:
    """(the conv, whether the kernel launched) on checked operands: the
    plain version for CPU tensors, an empty output of the kernel's shape
    for ``meta`` ones (the dry run: shapes only), the kernel for CUDA ones
    (not counted here)."""
    b, hs, w, c = x_shard.shape
    if x_shard.device.type == "cpu":
        top = top_halo if top_halo is not None or not lo else x_shard.new_zeros((b, lo, w, c))
        bot = bot_halo if bot_halo is not None or not hi else x_shard.new_zeros((b, hi, w, c))
        return halo_conv2d_ref(x_shard, top, bot, weights, bias,
                               stride=stride, padding=padding, groups=groups), False
    if x_shard.device.type == "meta":
        return x_shard.new_empty((b, ho, wo, weights.shape[-1])), False
    if x_shard.device.type != "cuda":
        raise ValueError(f"halo_conv2d_cuda takes CPU, CUDA or meta tensors, got {x_shard.device}")
    if not b * ho * wo * weights.shape[-1]:  # nothing to compute: no launch, no count
        return x_shard.new_empty((b, ho, wo, weights.shape[-1])), False
    return launch(_lib(), x_shard, top_halo, bot_halo, weights, bias, stride, padding, groups,
                  lo, hi, ho, wo, torch.cuda.current_stream(x_shard.device).cuda_stream), True


def probe(
    x_shard: torch.Tensor,
    top_halo: torch.Tensor | None,
    bot_halo: torch.Tensor | None,
    weights: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 1,
    groups: int = 1,
    lo: int | None = None,
    hi: int | None = None,
) -> tuple[int, int, int, int]:
    """The output shape ``(B, Ho, Wo, Cout)`` that :func:`halo_conv2d_cuda`
    returns for operands of these shapes, from the shapes alone: the
    wrapper's own argument check run on ``meta`` tensors, so it raises
    exactly where the wrapper raises.  Takes ``meta`` tensors only, and
    launches nothing."""
    if x_shard.device.type != "meta":
        raise ValueError(f"probe takes meta tensors, got {x_shard.device}")
    _, _, ho, wo = _check_args(x_shard, top_halo, bot_halo, weights, bias,
                               stride, padding, groups, lo, hi)
    return x_shard.shape[0], ho, wo, weights.shape[-1]


def launch(lib, x, top, bot, weights, bias, stride, padding, groups, lo, hi, ho, wo, stream):
    """Allocate the output and enqueue the kernel of ``lib`` on ``stream``
    (arguments already checked, output not empty); raises if the launch is
    refused."""
    b, hs, w, c = x.shape
    k, cout = weights.shape[0], weights.shape[-1]
    y = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    splits, ws = workspace(lib, x, b * ho * wo, cout, k, c, groups)
    err = lib.halo_conv2d_fwd(
        None if top is None else top.data_ptr(), x.data_ptr(),
        None if bot is None else bot.data_ptr(), _strides(x, top, bot), lo, hs, hi,
        weights.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), splits,
        DTYPE_CODES[x.dtype], b, w, c, cout, k, stride, padding, ho, wo,
        int(groups > 1), x.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"halo_conv2d kernel launch failed: {lib.kernel_error_string(err).decode()}")
    return y


def _strides(x, top, bot):
    """The (batch, row, column) strides of top, shard and bottom, (0, 0, 0)
    for an absent halo, as the C interface takes them."""
    return (ctypes.c_longlong * 9)(*[
        v for t in (top, x, bot) for v in ((0, 0, 0) if t is None else t.stride()[:3])
    ])


def launch_config(x_shard, top_halo, bot_halo, weights, *, stride: int = 1, padding: int = 1,
                  groups: int = 1, lo: int | None = None, hi: int | None = None) -> dict:
    """How the kernel would run this halo conv on the card: the split count
    of K, the gather variant ("a16/b16": shard, halos and weights copied as
    16-byte vectors; "a4": the slab element by element; "depthwise") and,
    for a depthwise conv, its launch shape (``conv2d.ops.depthwise_config``;
    else None).  Launches nothing."""
    return configure(_lib(), x_shard, top_halo, bot_halo, weights, stride=stride, padding=padding,
                     groups=groups, lo=lo, hi=hi)


def configure(lib, x_shard, top_halo, bot_halo, weights, *, stride: int = 1, padding: int = 1,
              groups: int = 1, lo: int | None = None, hi: int | None = None) -> dict:
    """:func:`launch_config` through the kernel library ``lib``."""
    lo, hi, ho, wo = _check_args(x_shard, top_halo, bot_halo, weights, None,
                                 stride, padding, groups, lo, hi)
    b, _, _, c = x_shard.shape
    k, cout = weights.shape[0], weights.shape[-1]
    splits = split_count(lib, x_shard, b * ho * wo, cout, k, c, groups)
    ptrs = (None if top_halo is None else top_halo.data_ptr(), x_shard.data_ptr(),
            None if bot_halo is None else bot_halo.data_ptr(), _strides(x_shard, top_halo, bot_halo))
    if groups > 1:
        dw = depthwise_config(lib.halo_conv2d_dw_config, *ptrs, weights.data_ptr(),
                              DTYPE_CODES[x_shard.dtype], c, k, stride, ho, wo)
        return dict(splits=splits, gather="depthwise", depthwise=dw)
    gather = lib.halo_conv2d_gather(*ptrs, weights.data_ptr(), DTYPE_CODES[x_shard.dtype], c, cout)
    return dict(splits=splits, gather=GATHER_NAMES[gather], depthwise=None)


# Kernel launches so far in this process (CPU calls do not count).
halo_conv2d_cuda.launches = 0
