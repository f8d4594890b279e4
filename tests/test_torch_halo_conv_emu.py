"""The CUDA source of the halo conv (K2), run on the CPU through an emulation.

``src/repro_torch/kernels/halo_conv/halo_conv.cu``, with the shared core
``conv_igemm.cuh`` inlined, is compiled as C++20 by ``g++`` with
``tests/cuda_emu/cuda_shim.h`` and driven through the wrapper's own launch
code (``halo_conv/ops.py: launch``), so the strides it passes, the kernel's
row resolution (top halo, shard, bottom halo, zero), the width masking, the
absent-halo zero rows, the depthwise branch and the bfloat16 rounding all run
where there is no card.  Timing, the real compiler and the real memory model
are checked only on the card (``chip_smoke.py``).  Held against the plain
version, ``halo_conv2d_ref``, at 2e-5 (float32, summation order) and 2e-2
(bfloat16: both round one float32 sum).
"""
import numpy as np
import pytest
import torch

from _torch_emu import KERNELS, build_emulated
from repro_torch.kernels.halo_conv import halo_conv2d_ref
from repro_torch.kernels.halo_conv.ops import _check_args, bind, launch

SOURCE = KERNELS / "halo_conv" / "halo_conv.cu"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    # the two launches of the shared core (conv_igemm.cuh), inlined
    return bind(build_emulated(SOURCE, tmp_path_factory.mktemp("emu"), launches=2))


# (B, Hs, W, Cin, Cout, k, stride, pad, groups, dtype, bias, halos)
# halos: "views" -- row slices of neighbouring shards (strided); "absent" --
# None halos standing for zero rows; "dense" -- contiguous tensors
CASES = [
    (2, 16, 12, 8, 16, 3, 1, 1, 1, torch.float32, False, "dense"),
    (2, 16, 11, 4, 8, 5, 1, 2, 1, torch.float32, True, "views"),
    (2, 16, 11, 4, 8, 3, 2, 1, 1, torch.float32, True, "views"),    # lo = 1, hi = 0
    (1, 16, 11, 4, 8, 5, 2, 3, 1, torch.float32, False, "dense"),   # lo = 3, hi = 0
    (2, 16, 11, 4, 8, 7, 2, 3, 1, torch.float32, True, "views"),    # lo = 3, hi = 2
    (1, 10, 9, 4, 8, 3, 1, 1, 1, torch.float32, True, "absent"),    # edge shards
    (2, 7, 9, 3, 70, 3, 1, 1, 1, torch.float32, True, "views"),     # Cin 3, two Cout tiles
    (2, 9, 13, 5, 7, 1, 1, 0, 1, torch.float32, True, "dense"),     # no halo at all
    (2, 12, 10, 8, 8, 7, 1, 3, 8, torch.float32, True, "views"),    # depthwise k7
    (1, 12, 10, 8, 8, 3, 2, 1, 8, torch.bfloat16, True, "absent"),  # depthwise, strided
    (2, 8, 12, 8, 16, 3, 1, 1, 1, torch.bfloat16, True, "views"),
    (1, 4, 6, 16, 16, 3, 1, 1, 1, torch.float32, True, "absent"),   # thin shard
]


def _case_id(c):
    return "x".join(map(str, c[:9])) + f"-{str(c[9])[6:]}" + ("-bias" if c[10] else "") + f"-{c[11]}"


def _inputs(case, seed):
    b, hs, w, cin, cout, k, s, pad, g, dt, has_bias, halos = case
    lo, hi = pad, k - pad - s
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).to(dt)

    x = arr(b, hs, w, cin)
    if halos == "views":  # the neighbours' shards, of which the halos are row slices
        above, below = arr(b, hs, w, cin), arr(b, hs, w, cin)
        top = above[:, hs - lo:] if lo else None
        bot = below[:, :hi] if hi else None
        assert top is None or not top.is_contiguous()
    elif halos == "dense":
        top = arr(b, lo, w, cin) if lo else None
        bot = arr(b, hi, w, cin) if hi else None
    else:
        top = bot = None
    wts = arr(k, k, 1 if g > 1 else cin, cout, scale=0.1)
    bias = arr(cout) if has_bias else None
    return x, top, bot, wts, bias, lo, hi


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_emulated_kernel_matches_plain(lib, case):
    b, hs, w, cin, cout, k, s, pad, g, dt = case[:10]
    x, top, bot, wts, bias, lo, hi = _inputs(case, CASES.index(case))
    args = _check_args(x, top, bot, wts, bias, s, pad, g, lo, hi)
    got = launch(lib, x, top, bot, wts, bias, s, pad, g, *args, None)
    zeros = x.new_zeros((b, max(lo, hi), w, cin))
    want = halo_conv2d_ref(x, zeros[:, :lo] if top is None else top,
                           zeros[:, :hi] if bot is None else bot, wts, bias,
                           stride=s, padding=pad, groups=g)
    assert got.shape == want.shape == (b, hs // s, (w + 2 * pad - k) // s + 1, cout)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
