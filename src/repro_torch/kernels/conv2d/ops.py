"""Wrapper of the Hopper direct-conv kernel (``conv2d.cu``), the counterpart of
``repro/kernels/conv2d/ops.py: conv2d_pallas``.

For a CPU tensor it runs the plain version (:func:`.ref.conv2d_ref`); for a
CUDA tensor it launches the kernel or raises -- there is no fallback.  The
input is read in place (any batch/row/column strides, dense channels), the
padding is applied inside the kernel, and the output is allocated here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import load_library
from .ref import conv2d_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INT32_MAX = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("conv2d")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.conv2d_fwd.argtypes = [
        p, p, p, p, i,          # x, w, bias, y, dtype
        i, i, i, i,             # n, h, w, cin
        i64, i64, i64,          # input strides (batch, row, column)
        i, i, i, i, i, i,       # cout, k, stride, pad, ho, wo
        i, i, p,                # depthwise, device, stream
    ]
    lib.conv2d_fwd.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check_operands(fn: str, x, weights, bias, groups) -> tuple[int, int]:
    """Raise on an input, weights or bias that the conv core does not take
    (shared by both conv kernels' wrappers; ``fn`` names the caller in the
    messages); returns (k, Cout)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} takes CPU or CUDA tensors, got {x.device}")
    if x.dim() != 4 or weights.dim() != 4:
        raise ValueError(f"need NHWC x and HWIO weights, got {tuple(x.shape)} and {tuple(weights.shape)}")
    cin = x.shape[3]
    k, k2, w_cin, cout = weights.shape
    if k != k2:
        raise ValueError(f"square kernels only, got {k}x{k2}")
    if groups > 1:
        if not (groups == cin == cout and w_cin == 1):
            raise ValueError(
                f"grouped conv supported only for depthwise (groups == Cin == "
                f"Cout); got groups={groups} Cin={cin} Cout={cout}"
            )
    elif groups != 1 or w_cin != cin:
        raise ValueError(f"weights {tuple(weights.shape)} do not match Cin={cin}, groups={groups}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{fn} takes float32 or bfloat16, got {x.dtype}")
    for name, t in (("weights", weights), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, x is {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias must be [{cout}], got {tuple(bias.shape)}")
    if x.stride(3) != 1 or min(x.stride()) < 0:
        raise ValueError(f"the channel axis of x must be dense, got strides {x.stride()}")
    return k, cout


def _check_args(x, weights, bias, stride, padding, groups) -> tuple[int, int]:
    """Raise on what the kernel does not take; returns the output (Ho, Wo)."""
    k, cout = check_operands("conv2d_cuda", x, weights, bias, groups)
    n, h, w, cin = x.shape
    if stride < 1 or padding < 0:
        raise ValueError(f"bad stride={stride} / padding={padding}")
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"non-positive output size for H={h}, W={w}, k={k}, s={stride}, p={padding}")
    if max(n, h + 2 * padding, w + 2 * padding, cout, k * k * cin) > INT32_MAX:
        raise ValueError("a dimension exceeds the kernel's 32-bit index range")
    return ho, wo


def conv2d_cuda(
    x: torch.Tensor,  # [N, H, W, Cin]  (NHWC)
    weights: torch.Tensor,  # [k, k, Cin, Cout]  ([k, k, 1, C] depthwise)
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """NHWC x HWIO conv with symmetric zero ``padding`` (k = weights.shape[0]).

    ``groups`` is 1 (dense) or ``Cin == Cout`` (depthwise); anything else
    raises, as in ``conv2d_pallas``.  The arguments are checked alike on both
    devices, so the plain version keeps the kernel's contract."""
    ho, wo = _check_args(x, weights, bias, stride, padding, groups)
    if x.device.type == "cpu":
        return conv2d_ref(x, weights, bias, stride=stride, padding=padding, groups=groups)
    n, h, w, cin = x.shape
    k, cout = weights.shape[0], weights.shape[-1]
    y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    err = lib.conv2d_fwd(
        x.data_ptr(), weights.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), DTYPE_CODES[x.dtype],
        n, h, w, cin, x.stride(0), x.stride(1), x.stride(2),
        cout, k, stride, padding, ho, wo,
        int(groups > 1), x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"conv2d kernel launch failed: {lib.kernel_error_string(err).decode()}")
    conv2d_cuda.launches += 1
    return y


# Kernel launches so far in this process (CPU calls do not count).
conv2d_cuda.launches = 0
