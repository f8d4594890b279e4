"""The CUDA source of the direct conv, run on the CPU through an emulation.

``src/repro_torch/kernels/conv2d/conv2d.cu``, with the shared core
``conv_igemm.cuh`` and the PTX wrappers ``sm90_ops.cuh`` inlined, is compiled
as C++20 by ``g++`` with ``tests/cuda_emu/cuda_shim.h`` (threads for CUDA
threads, barriers for ``__syncthreads`` and the warps, the tensor-core
products, TF32 rounding and deferred ``cp.async`` copies emulated) and driven
through the wrapper's own launch code (``conv2d/ops.py: launch``, which
allocates the split-K workspace).  This covers the kernel's index math --
tap-row K steps, masking of ragged M/N/K tiles, strided and padded taps,
batch strides of row-slice views, the 16-byte and element-wise gathers,
split-K and its reduction, the 3xTF32 split, the depthwise branch and the
bfloat16 epilogue -- where there is no card.  The emulated ``mma.sync``
follows the PTX ISA's fragment layouts as the shim reads them: a layout the
shim and the kernel got wrong together would pass here, and only the card
(``chip_smoke.py`` phases 3 / 3b, ``tests/test_torch_cuda.py``) catches that.
Timing, the real compiler and the real memory model are checked only there.
Tolerances as in tests/test_torch_conv2d.py: 2e-5 (float32, summation order)
and 2e-2 (bfloat16).
"""
import numpy as np
import pytest
import torch

from _torch_emu import KERNELS, build_emulated
from repro_torch.kernels.conv2d import conv2d_ref
from repro_torch.kernels.conv2d.ops import GATHER_NAMES, _check_args, bind, launch, split_count

SOURCE = KERNELS / "conv2d" / "conv2d.cu"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    # the three launches of the shared core (conv_igemm.cuh), inlined: the
    # implicit GEMM, split-K's reduction and the depthwise branch
    return bind(build_emulated(SOURCE, tmp_path_factory.mktemp("emu"), launches=3))


def _emulated(lib, x, w, b, stride, pad, groups):
    ho, wo = _check_args(x, w, b, stride, pad, groups)
    y = torch.empty((x.shape[0], ho, wo, w.shape[-1]), dtype=x.dtype)
    launch(lib, x, w, b, y, stride, pad, groups, None)
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


# The core's paths, each named: (N, H, W, Cin, Cout, k, stride, pad, dtype,
# input kind, splits, gather).  Input kinds: "dense"; "rows", a row slice of a
# taller batch; "chan", a channel slice starting at channel 1 of a wider
# tensor (dense channels, a base 4 bytes off 16-byte alignment).
CORE_CASES = {
    "splitk-f32": (1, 4, 4, 64, 16, 3, 1, 1, torch.float32, "dense", 4, "a16/b16"),
    "splitk-bf16": (1, 4, 4, 64, 16, 3, 1, 1, torch.bfloat16, "rows", 4, "a16/b16"),
    "ragged-mnk-splitk": (2, 5, 5, 40, 72, 3, 1, 1, torch.float32, "rows", 3, "a16/b16"),
    "cin3-a4": (1, 9, 7, 3, 16, 3, 1, 1, torch.float32, "dense", 1, "a4/b16"),
    "cin3-a4-bf16": (1, 9, 7, 3, 16, 3, 1, 1, torch.bfloat16, "dense", 1, "a4/b16"),
    "chan-view-a4": (1, 6, 6, 8, 16, 3, 1, 1, torch.float32, "chan", 1, "a4/b16"),
    "cout19-b4": (1, 6, 6, 8, 19, 3, 1, 1, torch.float32, "dense", 1, "a16/b4"),
    "cin12-bf16-a4": (1, 6, 6, 12, 16, 3, 2, 1, torch.bfloat16, "dense", 1, "a4/b16"),
    "patch-k4s4": (2, 8, 8, 3, 8, 4, 4, 0, torch.float32, "rows", 1, "a4/b16"),
}


@pytest.mark.parametrize("name", list(CORE_CASES))
def test_emulated_core_path_matches_plain(lib, name):
    n, h, wd, cin, cout, k, s, pad, dt, kind, splits, gather = CORE_CASES[name]
    rng = np.random.default_rng(list(CORE_CASES).index(name))
    big = torch.tensor(rng.standard_normal((n, h + 3, wd, cin + 5), dtype=np.float32), dtype=dt)
    if kind == "rows":
        x = big[..., :cin].contiguous()[:, 1:1 + h]
    elif kind == "chan":
        x = big[:, :h, :, 1:1 + cin]
    else:
        x = big[:, :h, :, :cin].contiguous()
    w = torch.tensor(0.1 * rng.standard_normal((k, k, cin, cout), dtype=np.float32), dtype=dt)
    b = torch.tensor(rng.standard_normal(cout, dtype=np.float32), dtype=dt)
    ho, wo = _check_args(x, w, b, s, pad, 1)
    assert split_count(lib, x, n * ho * wo, cout, k, cin, 1) == splits
    variant = lib.conv2d_gather(x.data_ptr(), w.data_ptr(), int(dt == torch.bfloat16), cin,
                                x.stride(0), x.stride(1), x.stride(2), cout)
    assert GATHER_NAMES[variant] == gather
    got = _emulated(lib, x, w, b, s, pad, 1)
    want = conv2d_ref(x, w, b, stride=s, padding=pad)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
