"""Wrapper of the Hopper direct-conv kernel (``conv2d.cu``), the counterpart of
``repro/kernels/conv2d/ops.py: conv2d_pallas``.

For a CPU tensor it runs the plain version (:func:`.ref.conv2d_ref`); for a
CUDA tensor it launches the kernel or raises -- there is no fallback.  The
input is read in place (any batch/row/column strides, dense channels), the
padding is applied inside the kernel, and the output is allocated here.
Under autograd the call is :class:`Conv2dFunction`, whose backward
(:func:`conv2d_backward`) runs a stride-1 conv's input gradient through the
kernel again; JAX differentiates ``lax.conv_general_dilated`` with XLA and
has no Pallas backward.
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
    lib.conv2d_dw_config.argtypes = [p, p, i, i, i64, i64, i64, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.conv2d_dw_config.restype = None
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
# the depthwise branch's staging copies, by bytes a copy
DW_COPIES = {16: "16-byte", 4: "4-byte", 2: "element"}


def depthwise_config(fn, *args) -> dict:
    """The depthwise launch shape that a C interface's ``*_dw_config``
    (``fn``, called with ``args`` and an out array) reports: the staging
    copies, the output tile (rows, columns, outputs a thread along W), the
    channels of a slab, threads and shared memory bytes of a block."""
    out = (ctypes.c_int * 7)()
    fn(*args, out)
    copy, th, tw, r, cb, threads, smem = out
    return dict(copies=DW_COPIES[copy], tile=[th, tw, r], slab=cb, threads=threads, smem=smem)


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
    devices, so the plain version keeps the kernel's contract.  Where grad is
    enabled and an operand requires it, the call goes through
    :class:`Conv2dFunction` (same forward, and a backward); else straight to
    the kernel."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, weights, bias)):
        return Conv2dFunction.apply(x, weights, bias, stride, padding, groups)
    y, launched = _conv(x, weights, bias, stride, padding, groups)
    _count_forward(launched, groups)
    return y


def _count_forward(launched: bool, groups: int) -> None:
    if launched:
        conv2d_cuda.launches += 1
        if groups > 1:
            conv2d_cuda.depthwise_launches += 1


def _conv(x, weights, bias, stride: int, padding: int, groups: int) -> tuple[torch.Tensor, bool]:
    """(the conv, whether the kernel launched): the plain version for a CPU
    tensor, an empty output of the kernel's shape for a ``meta`` one (the
    dry run: shapes only, after the kernel's argument checks), the kernel
    for a CUDA one (not counted here)."""
    ho, wo = _check_args(x, weights, bias, stride, padding, groups)
    if x.device.type == "cpu":
        return conv2d_ref(x, weights, bias, stride=stride, padding=padding, groups=groups), False
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"conv2d_cuda takes CPU, CUDA or meta tensors, got {x.device}")
    y = torch.empty((x.shape[0], ho, wo, weights.shape[-1]), dtype=x.dtype, device=x.device)
    if y.numel() == 0 or x.device.type == "meta":
        return y, False
    launch(_lib(), x, weights, bias, y, stride, padding, groups,
           torch.cuda.current_stream(x.device).cuda_stream)
    return y, True


def library_flags(allow_tf32: bool = False):
    """cuDNN as the backward's library calls take it: deterministic (a
    replayed step is bit-identical), no autotuning, and float32 kept float32
    (no TF32) unless ``allow_tf32``."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=allow_tf32)


def conv2d_backward(dy: torch.Tensor, x: torch.Tensor, weights: torch.Tensor, stride: int, padding: int,
                    groups: int, needs: tuple[bool, bool, bool]) -> tuple:
    """(dx, dW, db) of the conv for the output cotangent ``dy``, each None
    unless ``needs`` asks for it.

    At stride 1 (and ``padding <= k - 1``) dx is itself a stride-1 conv that
    K1 computes: dy at padding ``k - 1 - padding`` with the filter flipped in
    H and W (dense: I and O swapped), H x W again; those launches count in
    ``conv2d_cuda.backward_launches``.  dx at a larger stride and dW come
    from the library (``aten.convolution_backward`` on channels-last views,
    one call each, under :func:`library_flags`; bfloat16 and float16
    operands go to it as float32 copies with TF32 on, which holds their
    values exactly: cuDNN's own bfloat16 weight gradient rounds its partial
    sums, up to 24x the bfloat16 tolerance off at EfficientNet-B7's 1x1
    convs on the H100), except a dense float32 dW: that is k^2 matrix
    products (:func:`_wgrad_taps`), since cuDNN's deterministic choice for
    3x3 stride-1 convs, a Winograd transform, is 1.6-3.3x the float32
    rounding scale off (2^-20 x the sum of |terms|) at the U-Net's widths
    on the H100.  db is dy summed in float32.  JAX takes all of these from
    XLA, outside any Pallas kernel.  Each part runs in a
    ``torch.profiler.record_function`` range of its name, so a profile of a
    step tells them apart: "K1 dgrad", "conv dgrad (library)", "conv wgrad
    (library)"."""
    need_x, need_w, need_b = needs
    k = weights.shape[0]
    dy = dy if dy.stride(3) == 1 else dy.contiguous()
    dx = dw = db = None
    k1_dgrad = need_x and stride == 1 and padding <= k - 1
    if k1_dgrad:
        flipped = weights.flip(0, 1) if groups > 1 else weights.flip(0, 1).transpose(2, 3)
        with torch.profiler.record_function("K1 dgrad"):
            dx, launched = _conv(dy, flipped.contiguous(), None, 1, k - 1 - padding, groups)
        conv2d_cuda.backward_launches += launched

    def library(name: str, mask: list[bool], i: int, order: list[int]):
        wide = dy.dtype != torch.float32
        with library_flags(allow_tf32=wide), torch.profiler.record_function(name):
            d, a, w = (t.float() if wide else t for t in (dy, x, weights))
            out = torch.ops.aten.convolution_backward(
                d.permute(0, 3, 1, 2), a.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
                [stride] * 2, [padding] * 2, [1, 1], False, [0, 0], groups, mask)[i]
            return out.permute(order).to(dy.dtype).contiguous()

    if need_x and not k1_dgrad:
        dx = library("conv dgrad (library)", [True, False, False], 0, [0, 2, 3, 1])
    if need_w and groups == 1 and dy.dtype == torch.float32:
        with torch.profiler.record_function("conv wgrad (library)"):
            dw = _wgrad_taps(dy, x, k, stride, padding)
    elif need_w:
        dw = library("conv wgrad (library)", [False, True, False], 1, [2, 3, 1, 0])
    if need_b:
        db = dy.float().sum(dim=(0, 1, 2)).to(dy.dtype)
    return dx, dw, db


def _wgrad_taps(dy: torch.Tensor, x: torch.Tensor, k: int, stride: int, padding: int) -> torch.Tensor:
    """A dense float32 conv's weight gradient [k, k, Cin, Cout] as one
    matrix product a tap (cuBLAS, deterministic, TF32 off): the tap's window
    of the padded input, [N*Ho*Wo, Cin], transposed, times dy [N*Ho*Wo,
    Cout]."""
    n, ho, wo, cout = dy.shape
    cin = x.shape[3]
    xp = torch.nn.functional.pad(x, (0, 0, padding, padding, padding, padding)) if padding else x
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        d = dy.reshape(-1, cout)
        taps = [xp[:, ky:ky + (ho - 1) * stride + 1:stride, kx:kx + (wo - 1) * stride + 1:stride].reshape(-1, cin)
                .t() @ d for ky in range(k) for kx in range(k)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.stack(taps).reshape(k, k, cin, cout)


class Conv2dFunction(torch.autograd.Function):
    """K1 under autograd: the forward is the kernel (the plain version on the
    CPU), the backward :func:`conv2d_backward`."""

    @staticmethod
    def forward(ctx, x, weights, bias, stride: int, padding: int, groups: int):
        y, launched = _conv(x, weights, bias, stride, padding, groups)
        _count_forward(launched, groups)
        ctx.save_for_backward(x, weights)
        ctx.conv = (stride, padding, groups)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weights = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:3])
        return conv2d_backward(dy, x, weights, *ctx.conv, needs) + (None, None, None)


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
    """How the kernel would run this conv on the card: the split count of K,
    the gather variant ("a16/b16": input and weights copied as 16-byte
    vectors; "a4": the input element by element; "depthwise") and, for a
    depthwise conv, its launch shape (:func:`depthwise_config`; else None).
    Launches nothing."""
    return configure(_lib(), x, weights, stride=stride, padding=padding, groups=groups)


def configure(lib, x, weights, *, stride: int = 1, padding: int = 1, groups: int = 1) -> dict:
    """:func:`launch_config` through the kernel library ``lib``."""
    ho, wo = _check_args(x, weights, None, stride, padding, groups)
    n, cin = x.shape[0], x.shape[3]
    k, cout = weights.shape[0], weights.shape[-1]
    splits = split_count(lib, x, n * ho * wo, cout, k, cin, groups)
    strides = x.stride(0), x.stride(1), x.stride(2)
    if groups > 1:
        dw = depthwise_config(lib.conv2d_dw_config, x.data_ptr(), weights.data_ptr(), DTYPE_CODES[x.dtype],
                              cin, *strides, k, stride, ho, wo)
        return dict(splits=splits, gather="depthwise", depthwise=dw)
    gather = lib.conv2d_gather(x.data_ptr(), weights.data_ptr(), DTYPE_CODES[x.dtype], cin, *strides, cout)
    return dict(splits=splits, gather=GATHER_NAMES[gather], depthwise=None)


# Kernel launches so far in this process (CPU calls do not count): the
# forward's, of those the depthwise branch's, and the backward's input
# gradients (``conv2d_backward``).
conv2d_cuda.launches = 0
conv2d_cuda.depthwise_launches = 0
conv2d_cuda.backward_launches = 0
