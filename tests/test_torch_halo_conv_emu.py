"""The CUDA source of the halo conv (K2), run on the CPU through an emulation.

``src/repro_torch/kernels/halo_conv/halo_conv.cu``, with the shared core
``conv_igemm.cuh`` and the PTX wrappers ``sm90_ops.cuh`` inlined, is compiled
as C++20 by ``g++`` with ``tests/cuda_emu/cuda_shim.h`` and driven through
the wrapper's own launch code (``halo_conv/ops.py: launch``), so the strides
it passes, the source's row resolution once per pixel and tap row (top halo,
shard, bottom halo, zero), the zero-filled copies of the width padding and
of absent halos, the 16-byte and element-wise gathers, split-K, the 3xTF32
products, the depthwise branch (rows staged once per output tile through
the source) and the bfloat16 epilogue all run where there is no card.  The emulated ``mma.sync`` follows the PTX ISA's fragment
layouts as the shim reads them: a layout the shim and the kernel got wrong
together would pass here, and only the card (``chip_smoke.py`` phase 3b,
``tests/test_torch_cuda.py``) catches that.  Timing, the real compiler and
the real memory model are checked only there.  Held against the plain
version, ``halo_conv2d_ref``, at 2e-5 (float32, summation order) and 2e-2
(bfloat16: both round one float32 sum).
"""
import numpy as np
import pytest
import torch

from _torch_emu import KERNELS, build_emulated
from repro_torch.kernels.halo_conv import halo_conv2d_ref
from repro_torch.kernels.conv2d.ops import GATHER_NAMES, split_count
from repro_torch.kernels.halo_conv.ops import _check_args, _strides, bind, configure, launch

SOURCE = KERNELS / "halo_conv" / "halo_conv.cu"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    # the three launches of the shared core (conv_igemm.cuh), inlined: the
    # implicit GEMM, split-K's reduction and the depthwise branch
    return bind(build_emulated(SOURCE, tmp_path_factory.mktemp("emu"), launches=3))


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


def _check_emulated(lib, case, seed):
    """Run ``case`` through the emulated kernel against the plain version;
    returns the inputs and the wrapper's (lo, hi, Ho, Wo)."""
    b, hs, w, cin, cout, k, s, pad, g, dt = case[:10]
    x, top, bot, wts, bias, lo, hi = _inputs(case, seed)
    args = _check_args(x, top, bot, wts, bias, s, pad, g, lo, hi)
    got = launch(lib, x, top, bot, wts, bias, s, pad, g, *args, None)
    zeros = x.new_zeros((b, max(lo, hi), w, cin))
    want = halo_conv2d_ref(x, zeros[:, :lo] if top is None else top,
                           zeros[:, :hi] if bot is None else bot, wts, bias,
                           stride=s, padding=pad, groups=g)
    assert got.shape == want.shape == (b, hs // s, (w + 2 * pad - k) // s + 1, cout)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    return (x, top, bot, wts), args


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_emulated_kernel_matches_plain(lib, case):
    _check_emulated(lib, case, CASES.index(case))


# The core's paths, each named: a case as above, the split count and the
# gather variant it must take.
CORE_CASES = {
    "splitk-views": ((2, 4, 4, 64, 16, 3, 1, 1, 1, torch.float32, True, "views"), 4, "a16/b16"),
    "splitk-absent-bf16": ((1, 4, 4, 64, 16, 3, 1, 1, 1, torch.bfloat16, True, "absent"), 4, "a16/b16"),
    "ragged-mnk-splitk": ((2, 5, 5, 40, 72, 3, 1, 1, 1, torch.float32, True, "views"), 3, "a16/b16"),
    "cin3-a4-bf16": ((2, 7, 9, 3, 16, 3, 1, 1, 1, torch.bfloat16, True, "views"), 1, "a4/b16"),
    "cout19-b4-absent": ((1, 6, 6, 8, 19, 3, 1, 1, 1, torch.float32, True, "absent"), 1, "a16/b4"),
    "k5-s2-splitk-dense": ((2, 8, 9, 8, 16, 5, 2, 2, 1, torch.float32, False, "dense"), 2, "a16/b16"),
}


@pytest.mark.parametrize("name", list(CORE_CASES))
def test_emulated_core_path_matches_plain(lib, name):
    case, splits, gather = CORE_CASES[name]
    (x, top, bot, wts), (lo, hi, ho, wo) = _check_emulated(lib, case, 100 + list(CORE_CASES).index(name))
    b, cin, cout, k = x.shape[0], x.shape[3], wts.shape[-1], wts.shape[0]
    assert split_count(lib, x, b * ho * wo, cout, k, cin, 1) == splits
    variant = lib.halo_conv2d_gather(
        None if top is None else top.data_ptr(), x.data_ptr(),
        None if bot is None else bot.data_ptr(), _strides(x, top, bot), wts.data_ptr(),
        int(x.dtype == torch.bfloat16), cin, cout)
    assert GATHER_NAMES[variant] == gather


# The depthwise branch over several output tiles and two channel slabs, each
# ragged (as test_torch_conv2d_emu.py's DW_CASES), with its staged rows
# resolved through the halo source: strided-view halos at k7 s1 (lo = hi = 3)
# and k3 s2 (lo = 1, hi = 0), absent halos (zero rows) at k5 s2 in bfloat16,
# whose output must equal the plain version bit for bit, also with the shard
# scaled by powers of two from 2^-8 to 2^8, where the f32 sums round.
# (case, tile)
DW_CASES = {
    "k7s1-views": ((2, 19, 13, 44, 44, 7, 1, 3, 44, torch.float32, True, "views"), [10, 8, 4]),
    "k3s2-views": ((2, 38, 26, 44, 44, 3, 2, 1, 44, torch.float32, True, "views"), [10, 8, 4]),
    "k5s2-absent-bf16": ((1, 38, 26, 88, 88, 5, 2, 2, 88, torch.bfloat16, False, "absent"), [10, 8, 4]),
}


@pytest.mark.parametrize("name", list(DW_CASES))
def test_emulated_depthwise_tiles_match_plain(lib, name):
    case, tile = DW_CASES[name]
    seed = 300 + list(DW_CASES).index(name)
    (x, top, bot, wts), (lo, hi, ho, wo) = _check_emulated(lib, case, seed)
    k, s, pad, g = case[5:9]
    config = configure(lib, x, top, bot, wts, stride=s, padding=pad, groups=g, lo=lo, hi=hi)
    assert (config["gather"], config["depthwise"]["copies"], config["depthwise"]["tile"]) == (
        "depthwise", "16-byte", tile)
    slab = config["depthwise"]["slab"]
    assert ho > tile[0] and ho % tile[0] and wo > tile[1] and wo % tile[1] and x.shape[3] % slab \
        and x.shape[3] > slab
    if x.dtype == torch.bfloat16:
        x, top, bot, wts, bias, lo, hi = _inputs(case, seed)
        x = x * torch.from_numpy(np.exp2(np.random.default_rng(seed).integers(-8, 9, x.shape))).to(x.dtype)
        got = launch(lib, x, top, bot, wts, bias, s, pad, g, lo, hi, ho, wo, None)
        zeros = x.new_zeros((x.shape[0], max(lo, hi), x.shape[2], x.shape[3]))
        want = halo_conv2d_ref(x, zeros[:, :lo] if top is None else top,
                               zeros[:, :hi] if bot is None else bot, wts, bias,
                               stride=s, padding=pad, groups=g)
        assert torch.equal(got, want)
