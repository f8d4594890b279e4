"""The CUDA source of flash attention, run on the CPU through an emulation.

``src/repro_torch/kernels/attention/attention.cu`` is compiled as C++20 by
``g++`` with ``tests/cuda_emu/cuda_shim.h`` (threads for CUDA threads, a
barrier for ``__syncthreads``) and called through the same C interface the
wrapper uses.  This covers the kernel's own arithmetic -- ragged query and
key tiles, the top-left causal mask with T != S, the tensor-core fragment
layouts (3xTF32 and bf16, P handed from S's accumulators to PV's operands),
the merge of the four key quarters' partial softmaxes of a row, GQA head
indexing through the model layout's strides, the 16-byte and the unaligned
copies, the head widths and the bfloat16 rounding -- where there is no card;
timing and the real compiler are checked only on the card
(``chip_smoke.py``).  The shim's warp shuffle, which the row maxima and sums
go through, is checked on its own.  Tolerances as in tests/test_torch_attention.py: 2e-5
(float32, summation order) and 2e-2 (bfloat16).
"""
import ctypes
import math

import numpy as np
import pytest
import torch

from _torch_emu import KERNELS, build_emulated
from repro_torch.kernels.attention import attention_ref

SOURCE = KERNELS / "attention" / "attention.cu"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_emulated(SOURCE, tmp_path_factory.mktemp("emu"), launches=1)
    p, i = ctypes.c_void_p, ctypes.c_int
    args = [p, p, p, p, i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, i, p]
    lib.flash_attention_fwd.argtypes = args
    lib.flash_attention_fwd_shape.argtypes = args + [i]
    lib.flash_attention_shape.argtypes = [p, p, p, i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong), i, i]
    return lib


def _args(q, k, v, o):
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 12)(*[st for x in (q, k, v, o) for st in x.stride()[:3]])
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 0 if q.dtype == torch.float32 else 1,
            b, h, k.shape[1], t, k.shape[2], d, strides)


def _emulated(lib, q, k, v, causal, shape=None):
    """q [B,H,T,D], k/v [B,Hkv,S,D], any strides with a dense head dimension;
    the block shape the launcher picks, or the one given."""
    o = torch.empty_like(q)
    args = _args(q, k, v, o) + (1.0 / math.sqrt(q.shape[3]), int(causal), 0, None)
    err = lib.flash_attention_fwd(*args) if shape is None else lib.flash_attention_fwd_shape(*args, shape)
    assert err == 0
    return o


# (B, H, Hkv, T, S, D, causal, dtype, model layout [B, T, H, D] as a view)
CASES = [
    (1, 2, 2, 36, 36, 16, False, torch.float32, False),   # ragged T = S = 36
    (1, 2, 2, 36, 36, 64, True, torch.float32, False),
    (1, 1, 1, 70, 100, 16, True, torch.float32, False),   # top-left causal, T < S, two query tiles
    (1, 1, 1, 100, 40, 16, True, torch.float32, False),   # T > S: rows past S see every key
    (2, 4, 2, 20, 30, 16, True, torch.float32, True),     # GQA through the model layout's strides
    (1, 3, 3, 49, 49, 64, False, torch.float32, True),    # a head-split ViT shape, 7x7 tokens
    (1, 2, 1, 33, 65, 64, False, torch.bfloat16, True),
    (1, 1, 1, 16, 0, 16, False, torch.float32, False),    # no keys: zeros, as the plain version
    # the ViT path's head shards over the 14x14 grid: 13 query tiles, 13 key steps split 3/3/3/4
    (1, 3, 3, 196, 196, 64, False, torch.float32, True),
    (1, 5, 5, 196, 196, 64, False, torch.float32, True),
    # causal: the first tiles' rows see one or two key steps, so two or three
    # of the four key quarters are wholly masked (empty) and weigh 0 in the merge
    (1, 2, 2, 100, 100, 32, True, torch.float32, False),
    (1, 4, 2, 40, 56, 128, True, torch.float32, True),    # GQA at D = 128
    (1, 2, 2, 196, 196, 64, False, torch.bfloat16, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:6])) + ("-causal" if c[6] else "")
                         + f"-{str(c[7])[6:]}" + ("-model" if c[8] else ""))
def test_emulated_kernel_matches_plain(lib, case):
    b, h, hkv, t, s, d, causal, dt, model = case
    rng = np.random.default_rng(sum(case[:6]))

    def arr(n, heads):
        x = torch.from_numpy(rng.standard_normal((b, n, heads, d), dtype=np.float32)).to(dt)
        # [B, n, heads, D] memory seen as [B, heads, n, D], or a dense [B, heads, n, D]
        return x.transpose(1, 2) if model else x.transpose(1, 2).contiguous()

    q, k, v = arr(t, h), arr(s, hkv), arr(s, hkv)
    got = _emulated(lib, q, k, v, causal)
    g = h // hkv
    want = attention_ref(q, k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1), causal=causal)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_emulated_kernel_with_unaligned_kv(lib, dt):
    """K and V one element into a wider buffer: neither the bases nor the
    row strides are 16-byte aligned, so the kernel stages them element by
    element (4-byte cp.async for float32, plain loads for bfloat16)."""
    b, h, t, s, d = 1, 2, 40, 50, 32
    rng = np.random.default_rng(7)

    def arr(n, width):
        x = torch.from_numpy(rng.standard_normal((b, n, h, width), dtype=np.float32)).to(dt)
        return x[..., width - d:].transpose(1, 2)  # [B, H, n, D] view, dense head dimension

    q, k, v = arr(t, d), arr(s, d + 1), arr(s, d + 1)
    assert k.data_ptr() % 16 and k.stride(2) * k.element_size() % 16
    got = _emulated(lib, q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


SHUFFLE_SOURCE = """
template <typename V>
__global__ void quad(const V* x, V* y) {
  const int i = threadIdx.x;
  y[2 * i] = __shfl_xor_sync(0xffffffffu, x[i], 1);
  y[2 * i + 1] = __shfl_xor_sync(0xffffffffu, x[i], 2);
}
extern "C" int shuffle_f32(const float* x, float* y, int n) {
  quad<float><<<1, n, 0, nullptr>>>(x, y);
  return 0;
}
extern "C" int shuffle_i32(const int* x, int* y, int n) {
  quad<int><<<1, n, 0, nullptr>>>(x, y);
  return 0;
}
"""


@pytest.mark.parametrize("dt", [torch.float32, torch.int32], ids=["float32", "int32"])
def test_shim_shuffle_returns_partner_lane(tmp_path, dt):
    """``__shfl_xor_sync`` in the shim is a warp collective: over two warps,
    each lane gets the value of lane ^ 1 and then of lane ^ 2 -- the partners
    of its quad, where the kernel's row max and row sum meet."""
    src = tmp_path / "shuffle.cu"
    src.write_text(SHUFFLE_SOURCE)
    lib = build_emulated(src, tmp_path, launches=2)
    n = 64
    x = (torch.arange(n) * 3 + 1).to(dt)
    y = torch.zeros(2 * n, dtype=dt)
    fn = lib.shuffle_f32 if dt == torch.float32 else lib.shuffle_i32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    assert fn(x.data_ptr(), y.data_ptr(), n) == 0
    lanes = torch.arange(n)
    torch.testing.assert_close(y[0::2], x[lanes ^ 1], rtol=0, atol=0)
    torch.testing.assert_close(y[1::2], x[lanes ^ 2], rtol=0, atol=0)


# (B, H, Hkv, T, S, D, causal, dtype): ragged top-left causal both ways, GQA, bf16, no keys
SHAPE_CASES = [
    (1, 2, 2, 70, 100, 16, True, torch.float32),
    (2, 4, 2, 100, 40, 32, True, torch.float32),
    (1, 2, 1, 49, 49, 64, False, torch.bfloat16),
    (1, 1, 1, 20, 0, 16, False, torch.float32),
]


@pytest.mark.parametrize("shape", [0, 1, 2], ids=["16x4", "32x4", "64x1"])
@pytest.mark.parametrize("case", SHAPE_CASES, ids=lambda c: "x".join(map(str, c[:6])) + ("-causal" if c[6] else "")
                         + f"-{str(c[7])[6:]}")
def test_emulated_block_shape_matches_plain(lib, shape, case):
    """Each block shape the launcher picks from (16 query rows x 4 key groups,
    32 x 4, 64 x 1), forced, against the plain version through the model
    layout's strides."""
    b, h, hkv, t, s, d, causal, dt = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, heads, d), dtype=np.float32)).to(dt).transpose(1, 2)
               for n, heads in ((t, h), (s, hkv), (s, hkv)))
    got = _emulated(lib, q, k, v, causal, shape=shape)
    g = h // hkv
    want = attention_ref(q, k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1), causal=causal)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_emulated_launcher_picks_fewest_waves(lib):
    """The launcher's pick over the shim's occupancy (threads and shared
    memory only; 132 SMs): the 64-row blocks once the key-split grids need a
    second wave, else the shape with the most warps in flight."""
    def pick(b, h, t, d=64):
        x = torch.zeros((b, t, h, d)).transpose(1, 2)
        return lib.flash_attention_shape(*_args(x, x, x, x)[:3], *_args(x, x, x, x)[4:], 0, 0)

    assert pick(1, 3, 196) == 1      # 7 x 3 blocks of 32 rows: the most warps, one wave
    assert pick(4, 16, 196) == 2     # 13 x 64 / 7 x 64 blocks need three / two waves, 4 x 64 one
