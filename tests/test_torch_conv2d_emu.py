"""The CUDA source of the direct conv, run on the CPU through an emulation.

``src/repro_torch/kernels/conv2d/conv2d.cu``, with the shared core
``conv_igemm.cuh`` inlined, is compiled as C++20 by ``g++`` with
``tests/cuda_emu/cuda_shim.h`` (threads for CUDA threads, a barrier for
``__syncthreads``) and called through the same C interface the wrapper uses.
This covers the kernel's index math -- masking of ragged tiles, strided and
padded taps, batch strides of row-slice views, the depthwise branch and the
bfloat16 rounding -- where there is no card; timing, the real compiler and
the real memory model are checked only on the card (``chip_smoke.py``).
Tolerances as in tests/test_torch_conv2d.py: 2e-5 (float32, summation order)
and 2e-2 (bfloat16).
"""
import ctypes

import numpy as np
import pytest
import torch

from _torch_emu import KERNELS, build_emulated
from repro_torch.kernels.conv2d import conv2d_ref

SOURCE = KERNELS / "conv2d" / "conv2d.cu"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    # the two launches of the shared core (conv_igemm.cuh), inlined
    lib = build_emulated(SOURCE, tmp_path_factory.mktemp("emu"), launches=2)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.conv2d_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i64, i64, i64, i, i, i, i, i, i, i, i, p]
    lib.conv2d_fwd.restype = ctypes.c_int
    return lib


def _emulated(lib, x, w, b, stride, pad, groups):
    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    ho, wo = (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1
    y = torch.empty((n, ho, wo, cout), dtype=x.dtype)
    err = lib.conv2d_fwd(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
        0 if x.dtype == torch.float32 else 1, n, h, wd, cin,
        x.stride(0), x.stride(1), x.stride(2), cout, k, stride, pad, ho, wo,
        int(groups > 1), 0, None)
    assert err == 0
    return y


# (N, H, W, Cin, Cout, k, stride, pad, groups, dtype, bias, row-slice view)
CASES = [
    (1, 16, 16, 8, 16, 3, 1, 1, 1, torch.float32, True, False),
    (2, 12, 10, 16, 32, 3, 1, 1, 1, torch.float32, True, True),  # ragged M tile, view
    (1, 8, 8, 4, 8, 1, 1, 0, 1, torch.float32, False, False),
    (1, 11, 9, 8, 16, 5, 1, 2, 1, torch.float32, True, False),
    (1, 17, 13, 3, 70, 3, 1, 1, 1, torch.float32, True, False),  # Cin=3, two N tiles
    (1, 17, 13, 3, 8, 3, 1, 1, 1, torch.bfloat16, True, False),
    (2, 13, 11, 5, 7, 3, 2, 1, 1, torch.float32, True, True),
    (1, 14, 10, 6, 6, 7, 2, 3, 1, torch.float32, False, False),
    (2, 9, 9, 20, 20, 3, 1, 0, 1, torch.bfloat16, True, True),
    (1, 24, 20, 8, 8, 3, 1, 1, 8, torch.float32, True, False),  # depthwise
    (2, 15, 13, 12, 12, 3, 2, 1, 12, torch.bfloat16, True, True),
    (1, 10, 10, 8, 8, 7, 1, 3, 8, torch.float32, False, False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:9])) + f"-{str(c[9])[6:]}"
                         + ("-bias" if c[10] else "") + ("-view" if c[11] else ""))
def test_emulated_kernel_matches_plain(lib, case):
    n, h, wd, cin, cout, k, s, pad, g, dt, has_bias, view = case
    rng = np.random.default_rng(len(CASES) + sum(case[:9]))
    x = torch.from_numpy(rng.standard_normal((n, h + 5, wd, cin), dtype=np.float32)).to(dt)
    x = x[:, 2:2 + h] if view else x[:, :h].contiguous()
    w = torch.from_numpy(0.1 * rng.standard_normal((k, k, 1 if g > 1 else cin, cout),
                                                   dtype=np.float32)).to(dt)
    b = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32)).to(dt) if has_bias else None
    got = _emulated(lib, x, w, b, s, pad, g)
    want = conv2d_ref(x, w, b, stride=s, padding=pad, groups=g)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
