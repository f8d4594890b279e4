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
split-K and its reduction, the 3xTF32 split, the depthwise branch (its
output tiles, channel slabs, staged rows and copy variants) and the bfloat16
epilogue -- where there is no card.  The emulated ``mma.sync``
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
from repro_torch.kernels.conv2d.ops import GATHER_NAMES, _check_args, bind, configure, launch, split_count

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


# The vision models' new K1 geometries, reduced in size: (N, H, W, Cin, Cout,
# k, stride, pad, groups, dtype, bias).  ConvNeXt's 7x7 depthwise at stride 1
# (with a bias), EfficientNet's 5x5 and 3x3 depthwise at stride 2 (without);
# the patch convs k = s = 4 from 3 channels (Swin's and ConvNeXt's stems) and
# ConvNeXt's k = s = 2 downsamples.
VISION_CASES = [
    (2, 14, 13, 24, 24, 7, 1, 3, 24, dt, bias)
    for dt in (torch.float32, torch.bfloat16) for bias in (True, False)
] + [
    (2, 15, 12, 20, 20, 5, 2, 2, 20, dt, bias)
    for dt in (torch.float32, torch.bfloat16) for bias in (True, False)
] + [
    (2, 13, 16, 12, 12, 3, 2, 1, 12, dt, bias)
    for dt in (torch.float32, torch.bfloat16) for bias in (True, False)
] + [
    (2, 32, 28, 3, 32, 4, 4, 0, 1, torch.float32, True),
    (2, 32, 28, 3, 32, 4, 4, 0, 1, torch.bfloat16, True),
    (2, 14, 14, 32, 64, 2, 2, 0, 1, torch.float32, True),
    (2, 14, 14, 32, 64, 2, 2, 0, 1, torch.bfloat16, True),
]


@pytest.mark.parametrize("case", VISION_CASES, ids=lambda c: "x".join(map(str, c[:9])) + f"-{str(c[9])[6:]}"
                         + ("-bias" if c[10] else ""))
def test_emulated_vision_shapes_match_plain(lib, case):
    _held_against_plain(lib, case)


def _held_against_plain(lib, case):
    """One (N, H, W, Cin, Cout, k, stride, pad, groups, dtype, bias) case
    through the emulated kernel against the plain version."""
    n, h, wd, cin, cout, k, s, pad, g, dt, has_bias = case
    rng = np.random.default_rng(sum(case[:9]))
    x = torch.from_numpy(rng.standard_normal((n, h, wd, cin), dtype=np.float32)).to(dt)
    w = torch.from_numpy(0.1 * rng.standard_normal((k, k, 1 if g > 1 else cin, cout), dtype=np.float32)).to(dt)
    b = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32)).to(dt) if has_bias else None
    got = _emulated(lib, x, w, b, s, pad, g)
    want = conv2d_ref(x, w, b, stride=s, padding=pad, groups=g)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# The diffusion models' geometries (UNet-SD1.5, DiT-XL/2), H/W reduced as
# VISION_CASES': conv_in's Cin = 4, a 3x3 stride-2 downsample, an up block's
# 3x3 from Cin = 2560 (its two skips concatenated: K = 23,040; Cout cut from
# 1280 to 32, as the emulation runs 1280 in minutes), conv_out's Cout = 4,
# and DiT's k = s = 2 patch embedding from Cin = 4 to 1152.
DIFFUSION_CASES = [
    case
    for dt in (torch.float32, torch.bfloat16)
    for case in (
        (1, 10, 9, 4, 32, 3, 1, 1, 1, dt, True),
        (1, 10, 9, 32, 32, 3, 2, 1, 1, dt, True),
        (1, 2, 2, 2560, 32, 3, 1, 1, 1, dt, True),
        (1, 10, 9, 32, 4, 3, 1, 1, 1, dt, True),
        (2, 8, 8, 4, 1152, 2, 2, 0, 1, dt, True),
    )
]


@pytest.mark.parametrize("case", DIFFUSION_CASES, ids=lambda c: "x".join(map(str, c[:9])) + f"-{str(c[9])[6:]}")
def test_emulated_diffusion_shapes_match_plain(lib, case):
    _held_against_plain(lib, case)


# The depthwise branch's tiles, slabs and copy variants, each named: (N, H, W,
# C, k, stride, pad, dtype, bias, input kind, copies, tile, slab).  Input
# kinds as CORE_CASES'; tile: output rows, columns and outputs a thread along
# W, as the launcher picks them for the shape (conv_igemm.cuh: dw_tile).  The
# "tiles" cases span two output-row tiles, two column tiles and two channel
# slabs, each ragged (19 rows in tiles of 10, 13 columns in tiles of 8, 12 of
# 32 f32 / 24 of 64 bf16 channels in the second slab), at the window shapes
# the vision models unroll (k3 s2, k5 s2, k7 s1); "c32" is a bfloat16 slab
# of 32 channels (C < 64, four 16-byte vectors a pixel);
# "c20" and "c12" take the element / 4-byte copies; k7 s2 has no unrolled
# window.  In bfloat16 the output must equal the plain version bit for bit
# (exact products, the same f32 sum order); its inputs are scaled by powers
# of two from 2^-8 to 2^8 (exactly), so that the f32 sums round and another
# order of the taps would show.
DW_CASES = {
    **{f"k{k}s{s}-{str(dt)[6:]}-tiles": (1, h, w, c, k, s, k // 2, dt, True, "dense", "16-byte", [10, 8, 4], cb)
       for k, s, h, w in ((3, 2, 38, 26), (5, 2, 38, 26), (7, 1, 19, 13))
       for dt, c, cb in ((torch.float32, 44, 32), (torch.bfloat16, 88, 64))},
    "c32-bf16-rows": (2, 9, 13, 32, 3, 1, 1, torch.bfloat16, False, "rows", "16-byte", [9, 16, 4], 32),
    "c20-bf16-element": (1, 9, 11, 20, 5, 1, 2, torch.bfloat16, True, "dense", "element", [9, 12, 4], 32),
    "c12-bf16-element-s2": (2, 15, 13, 12, 3, 2, 1, torch.bfloat16, True, "rows", "element", [8, 8, 4], 16),
    "c12-f32-chan-4byte": (1, 9, 11, 12, 3, 2, 1, torch.float32, False, "chan", "4-byte", [5, 8, 4], 16),
    "c6-f32-4byte": (1, 10, 9, 6, 5, 1, 2, torch.float32, True, "dense", "4-byte", [10, 12, 4], 8),
    "k7s2-f32-any-window": (1, 13, 18, 8, 7, 2, 3, torch.float32, True, "rows", "16-byte", [7, 12, 4], 8),
    "c520-f32-k7": (1, 7, 7, 520, 7, 1, 3, torch.float32, True, "dense", "16-byte", [7, 8, 4], 32),
}


@pytest.mark.parametrize("name", list(DW_CASES))
def test_emulated_depthwise_tiles_match_plain(lib, name):
    _depthwise_held(lib, name)


def _depthwise_held(lib, name):
    """DW_CASES[name] through the emulated kernel: its launch shape, and the
    output against the plain version (bit for bit in bfloat16)."""
    n, h, wd, c, k, s, pad, dt, has_bias, kind, copies, tile, slab = DW_CASES[name]
    rng = np.random.default_rng(200 + list(DW_CASES).index(name))
    big = rng.standard_normal((n, h + 3, wd, c + 5), dtype=np.float32)
    if dt == torch.bfloat16:
        big = big * np.exp2(rng.integers(-8, 9, big.shape)).astype(np.float32)
    big = torch.tensor(big, dtype=dt)
    if kind == "rows":
        x = big[..., :c].contiguous()[:, 1:1 + h]
    elif kind == "chan":
        x = big[:, :h, :, 1:1 + c]
    else:
        x = big[:, :h, :, :c].contiguous()
    w = torch.tensor(0.3 * rng.standard_normal((k, k, 1, c), dtype=np.float32), dtype=dt)
    b = torch.tensor(rng.standard_normal(c, dtype=np.float32), dtype=dt) if has_bias else None
    config = configure(lib, x, w, stride=s, padding=pad, groups=c)
    assert (config["gather"], config["depthwise"]["copies"]) == ("depthwise", copies)
    assert (config["depthwise"]["tile"], config["depthwise"]["slab"]) == (tile, slab)
    if name.endswith("tiles"):  # ragged tiles in rows, columns and channels
        ho, wo = _check_args(x, w, b, s, pad, c)
        assert ho > tile[0] and ho % tile[0] and wo > tile[1] and wo % tile[1] and c > slab and c % slab
    got = _emulated(lib, x, w, b, s, pad, c)
    want = conv2d_ref(x, w, b, stride=s, padding=pad, groups=c)
    if dt == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
