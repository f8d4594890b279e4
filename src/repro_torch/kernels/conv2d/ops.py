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
    return bind(load_library("conv2d"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``conv2d.cu`` on a loaded library."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.conv2d_fwd.argtypes = [
        p, p, p, p, p, i, i,    # x, w, bias, y, workspace, splits, dtype
        i, i, i, i,             # n, h, w, cin
        i64, i64, i64,          # input strides (batch, row, column)
        i, i, i, i, i, i,       # cout, k, stride, pad, ho, wo
        i, i, p,                # depthwise, device, stream
    ]
    lib.conv2d_fwd.restype = ctypes.c_int
    lib.conv2d_gather.argtypes = [p, p, i, i, i64, i64, i64, i]  # x, w, dtype, cin, strides, cout
    lib.conv2d_gather.restype = ctypes.c_int
    bind_splits(lib)
    return lib


def bind_splits(lib: ctypes.CDLL) -> None:
    """Declare the shared core's split count and error string on ``lib``
    (both conv libraries export them)."""
    lib.conv_splits.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.conv_splits.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p


def split_count(lib, x: torch.Tensor, m: int, cout: int, k: int, cin: int, groups: int) -> int:
    """The core's split count of K for a conv of ``m`` output pixels on
    ``x``'s device (1 for depthwise)."""
    return 1 if groups > 1 else _splits(lib, x.device.index or 0, m, cout, k, cin)


@functools.lru_cache(maxsize=4096)
def _splits(lib, device: int, m: int, cout: int, k: int, cin: int) -> int:
    # a pure function of the shape and the card, so asked once per shape
    splits = lib.conv_splits(m, cout, k, cin, device)
    if splits < 1:
        raise RuntimeError(f"conv_splits returned {splits}")
    return splits


def workspace(lib, x: torch.Tensor, m: int, cout: int, k: int, cin: int, groups: int):
    """(splits, workspace): the split count and, when it is > 1, room for the
    ``splits * m * cout`` float32 partials the core writes, allocated here
    (else None)."""
    splits = split_count(lib, x, m, cout, k, cin, groups)
    ws = torch.empty(splits * m * cout, dtype=torch.float32, device=x.device) if splits > 1 else None
    return splits, ws


GATHER_NAMES = {0: "a4/b4", 1: "a16/b4", 2: "a4/b16", 3: "a16/b16"}


def check_operands(fn: str, x, weights, bias, groups) -> tuple[int, int]:
    """Raise on an input, weights or bias that the conv core does not take
    (shared by both conv kernels' wrappers and by the halo conv's shape
    probe; ``fn`` names the caller in the messages); returns (k, Cout).
    Shapes, types and layout only: each caller refuses the devices it does
    not take where it dispatches."""
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
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_cuda takes CPU or CUDA tensors, got {x.device}")
    y = torch.empty((x.shape[0], ho, wo, weights.shape[-1]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    launch(_lib(), x, weights, bias, y, stride, padding, groups,
           torch.cuda.current_stream(x.device).cuda_stream)
    conv2d_cuda.launches += 1
    return y


def launch(lib, x, weights, bias, y, stride, padding, groups, stream) -> None:
    """Enqueue the kernel of ``lib`` on ``stream`` into the allocated,
    non-empty output ``y`` (arguments already checked), with the split-K
    workspace allocated here; raises if the launch is refused."""
    n, h, w, cin = x.shape
    k, cout = weights.shape[0], weights.shape[-1]
    ho, wo = y.shape[1], y.shape[2]
    splits, ws = workspace(lib, x, n * ho * wo, cout, k, cin, groups)
    err = lib.conv2d_fwd(
        x.data_ptr(), weights.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), None if ws is None else ws.data_ptr(), splits, DTYPE_CODES[x.dtype],
        n, h, w, cin, x.stride(0), x.stride(1), x.stride(2),
        cout, k, stride, padding, ho, wo,
        int(groups > 1), x.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"conv2d kernel launch failed: {lib.kernel_error_string(err).decode()}")


def launch_config(x: torch.Tensor, weights: torch.Tensor, *, stride: int = 1, padding: int = 1,
                  groups: int = 1) -> dict:
    """How the kernel would run this conv on the card: the split count of K
    and the gather variant ("a16/b16": input and weights copied as 16-byte
    vectors; "a4": the input element by element).  Launches nothing."""
    ho, wo = _check_args(x, weights, None, stride, padding, groups)
    n, cin = x.shape[0], x.shape[3]
    k, cout = weights.shape[0], weights.shape[-1]
    lib = _lib()
    splits = split_count(lib, x, n * ho * wo, cout, k, cin, groups)
    gather = lib.conv2d_gather(x.data_ptr(), weights.data_ptr(), DTYPE_CODES[x.dtype], cin,
                               x.stride(0), x.stride(1), x.stride(2), cout)
    return dict(splits=splits, gather="depthwise" if groups > 1 else GATHER_NAMES[gather])


# Kernel launches so far in this process (CPU calls do not count).
conv2d_cuda.launches = 0
