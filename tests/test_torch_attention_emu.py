"""The CUDA source of flash attention, run on the CPU through an emulation.

``src/repro_torch/kernels/attention/attention.cu`` is compiled as C++20 by
``g++`` with ``tests/cuda_emu/cuda_shim.h`` (threads for CUDA threads, a
barrier for ``__syncthreads``) and called through the same C interface the
wrapper uses.  This covers the kernel's own arithmetic -- ragged query and
key tiles, the top-left causal mask with T != S, the tensor-core fragment
layouts (3xTF32 and bf16, P handed from S's accumulators to PV's operands),
the merge of the four key quarters' partial softmaxes of a row, GQA head
indexing through the model layout's strides, the 16-byte and the unaligned
copies, the head widths (MLA's query/key width 192 with value width 128
among them) and the bfloat16 rounding -- where there is no card;
timing and the real compiler are checked only on the card
(``chip_smoke.py``).  The shim's warp shuffle, which the row maxima and sums
go through, is checked on its own.  Tolerances as in tests/test_torch_attention.py: 2e-5
(float32, summation order) and 2e-2 (bfloat16).
"""
import ctypes
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_emu import KERNELS, build_emulated
from repro_torch.kernels.attention import attention_ref
from repro_torch.kernels.attention.ops import DIFFUSION_HEAD_DIMS, HEAD_DIMS

SOURCE = KERNELS / "attention" / "attention.cu"
DIFFUSION_SOURCE = KERNELS / "attention" / "attention_diffusion.cu"


class _Libraries:
    """The two libraries of K3 (attention.cu, and attention_diffusion.cu: the
    same source with the diffusion models' width pairs) behind the one C
    interface, each call sent to the library that compiles its (d, dv) --
    as ``ops._lib_for`` sends the wrapper's; a pair of neither goes to
    attention.cu's, which refuses it."""

    def __init__(self, main, diffusion):
        self.main, self.diffusion = main, diffusion

    def _of(self, d, dv):
        return self.diffusion if (d, dv) in DIFFUSION_HEAD_DIMS else self.main

    def flash_attention_fwd(self, *args):
        return self._of(*args[10:12]).flash_attention_fwd(*args)

    def flash_attention_fwd_shape(self, *args):
        return self._of(*args[10:12]).flash_attention_fwd_shape(*args)

    def flash_attention_shape(self, *args):
        return self._of(*args[9:11]).flash_attention_shape(*args)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("emu")
    with ThreadPoolExecutor(2) as pool:  # the two g++ builds side by side
        libs = list(pool.map(lambda src: build_emulated(src, out, launches=1), (SOURCE, DIFFUSION_SOURCE)))
    p, i = ctypes.c_void_p, ctypes.c_int
    args = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, i, p]
    for one in libs:
        one.flash_attention_fwd.argtypes = args
        one.flash_attention_fwd_shape.argtypes = args + [i]
        one.flash_attention_shape.argtypes = [p, p, p, i, i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong),
                                              i, i]
    return _Libraries(*libs)


def _args(q, k, v, o):
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 12)(*[st for x in (q, k, v, o) for st in x.stride()[:3]])
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 0 if q.dtype == torch.float32 else 1,
            b, h, k.shape[1], t, k.shape[2], d, v.shape[3], strides)


def _emulated(lib, q, k, v, causal, shape=None):
    """q [B,H,T,D], k [B,Hkv,S,D], v [B,Hkv,S,DV], any strides with a dense
    head dimension; the block shape the launcher picks, or the one given."""
    o = q.new_empty(q.shape[:3] + (v.shape[3],))
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
    # the LM's prefill (Qwen3-4B: causal T = S, 4 query heads per KV head, D = 128), heads reduced
    (1, 8, 2, 80, 80, 128, True, torch.float32, True),
    (1, 8, 2, 80, 80, 128, True, torch.bfloat16, True),
    # moonshot-v1-16b-a3b's prefill: causal T = S, group 1 (16 query heads over 16 KV heads), D = 128,
    # heads reduced
    (1, 4, 4, 80, 80, 128, True, torch.float32, True),
    (1, 4, 4, 80, 80, 128, True, torch.bfloat16, True),
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


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_emulated_decode_over_cache_prefix(lib, dt):
    """The LM's decode step: one query row (T = 1: 15 of the smallest
    block's 16 rows dead) of 8 heads over 2 KV heads at D = 128, against the
    first S = 37 keys of a 64-slot KV cache [B, S_max, Hkv, D] -- K and V are
    the prefix view ``cache[:, :37]``, whose batch stride is the longer
    cache's -- non-causal, as ``gqa_apply`` hands it over."""
    b, h, hkv, s, s_max, d = 2, 8, 2, 37, 64, 128
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d), dtype=np.float32)).to(dt).transpose(1, 2)
    k_cache, v_cache = (torch.from_numpy(rng.standard_normal((b, s_max, hkv, d), dtype=np.float32)).to(dt)
                        for _ in range(2))
    k, v = (c[:, :s].transpose(1, 2) for c in (k_cache, v_cache))  # [B, Hkv, S, D] views
    assert k.stride(0) == s_max * hkv * d and not k.is_contiguous()
    got = _emulated(lib, q, k, v, causal=False)
    want = attention_ref(q, k.repeat_interleave(h // hkv, dim=1), v.repeat_interleave(h // hkv, dim=1),
                         causal=False)
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


@pytest.mark.parametrize("pair", HEAD_DIMS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_emulated_kernel_takes_the_wrappers_pairs(lib, pair):
    """Every (query/key, value) width pair the wrapper lets through
    (``ops.HEAD_DIMS``) is compiled: it launches, and matches the plain
    version over one ragged query tile."""
    d, dv = pair
    rng = np.random.default_rng(d + dv)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, n, w), dtype=np.float32)) for n, w in
               ((20, d), (24, d), (24, dv)))
    torch.testing.assert_close(_emulated(lib, q, k, v, causal=True), attention_ref(q, k, v, causal=True),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("pair", [(24, 16), (24, 24), (8, 8), (192, 64), (128, 192), (128, 64)],
                         ids=lambda p: f"{p[0]}-{p[1]}")
def test_emulated_kernel_refuses_other_pairs(lib, pair):
    """A width pair outside ``HEAD_DIMS`` -- the DeepSeek-V3 smoke config's
    (24, 16) among them -- is refused with cudaErrorInvalidValue (1), by the
    launch and by the block-shape query, and nothing is written."""
    d, dv = pair
    q, v = torch.zeros((1, 2, 8, d)), torch.zeros((1, 2, 8, dv))
    o = torch.full((1, 2, 8, dv), 7.0)
    args = _args(q, q, v, o)
    assert lib.flash_attention_fwd(*args, 1.0, 1, 0, None) == 1
    assert lib.flash_attention_shape(*args[:3], *args[4:], 1, 0) == -1
    assert bool((o == 7.0).all())


def _mla_operands(rng, b, h, t, s, dt, s_max=None):
    """MLA's operands as ``mla_apply`` hands them to K3, as [B, H, n, D]
    views: q [B, T, H, 192] and k [B, S, H, 192] in the model layout (k the
    first S rows of an S_max-row buffer, a cache prefix's view, where
    ``s_max`` is given), and v the value half of a [B, S, H, 256]
    expansion (k_nope | v), a strided slice."""
    q = torch.from_numpy(rng.standard_normal((b, t, h, 192), dtype=np.float32)).to(dt)
    k = torch.from_numpy(rng.standard_normal((b, s_max or s, h, 192), dtype=np.float32)).to(dt)[:, :s]
    kv = torch.from_numpy(rng.standard_normal((b, s, h, 256), dtype=np.float32)).to(dt)
    v = kv[..., 128:]
    assert v.stride(2) == 256 and not v.is_contiguous()
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


@pytest.mark.parametrize("shape", [None, 0, 1, 2], ids=["auto", "16x4", "32x4", "64x1"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_emulated_mla_prefill_matches_plain(lib, dt, shape):
    """MLA's causal prefill at (DQK, DV) = (192, 128): ragged T = S = 40,
    two heads (H = Hkv), the value a strided slice of the wider expansion;
    the launcher's pick and each block shape forced."""
    q, k, v = _mla_operands(np.random.default_rng(40), 1, 2, 40, 40, dt)
    got = _emulated(lib, q, k, v, causal=True, shape=shape)
    assert tuple(got.shape) == (1, 2, 40, 128)
    want = attention_ref(q, k, v, causal=True)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [None, 0, 1, 2], ids=["auto", "16x4", "32x4", "64x1"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_emulated_mla_decode_over_cache_prefix(lib, dt, shape):
    """An MLA decode step: one query row of 4 heads at (192, 128) over the
    first 37 keys -- k the prefix view of a 64-slot buffer, v a strided
    slice of the 256-wide expansion of those 37 rows -- non-causal; the
    launcher's pick and each block shape forced."""
    q, k, v = _mla_operands(np.random.default_rng(41), 2, 4, 1, 37, dt, s_max=64)
    assert k.stride(0) == 64 * 4 * 192
    got = _emulated(lib, q, k, v, causal=False, shape=shape)
    want = attention_ref(q, k, v, causal=False)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [None, 0, 1, 2], ids=["auto", "16x4", "32x4", "64x1"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_emulated_mla_with_unaligned_kv(lib, dt, shape):
    """MLA's (192, 128) with K and V one element into wider buffers: neither
    their bases nor their row strides are 16-byte aligned, so the element
    copies' instantiation runs (its float32 stages take 170 KB at the
    4-group shapes); causal T = S = 24, the launcher's pick and each block
    shape forced."""
    rng = np.random.default_rng(42)
    q = torch.from_numpy(rng.standard_normal((1, 24, 2, 192), dtype=np.float32)).to(dt)
    k = torch.from_numpy(rng.standard_normal((1, 24, 2, 193), dtype=np.float32)).to(dt)[..., 1:]
    kv = torch.from_numpy(rng.standard_normal((1, 24, 2, 257), dtype=np.float32)).to(dt)[..., 1:]
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), kv[..., 128:].transpose(1, 2)
    assert k.data_ptr() % 16 and v.data_ptr() % 16 and (v.stride(2) * v.element_size()) % 16
    got = _emulated(lib, q, k, v, causal=True, shape=shape)
    want = attention_ref(q, k, v, causal=True)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_emulated_launcher_pick_at_mla_widths(lib):
    """At (192, 128) a float32 K/V stage is 21.2 KB, so the 4-group shapes
    take 170 KB and one block fits on an SM: the launcher (through the
    shim's occupancy of threads and shared memory) takes 64x1 for MLA's
    prefill (B 4, 128 heads, T = 512) and a decode step (T = 1), and the
    shape with the most warps where every grid fits one wave."""
    def pick(b, h, t, dt=torch.float32):
        q = torch.zeros((b, t, h, 192), dtype=dt).transpose(1, 2)
        v = torch.zeros((b, t, h, 128), dtype=dt).transpose(1, 2)
        return lib.flash_attention_shape(*_args(q, q, v, v)[:3], *_args(q, q, v, v)[4:], 1, 0)

    assert pick(4, 128, 512) == 2
    assert pick(4, 128, 1) == 2
    assert pick(1, 2, 40) == 1      # 2 / 3 / 6 blocks, one wave each: 32x4 has the most warps
    assert pick(4, 128, 512, torch.bfloat16) == 2


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_emulated_vit_l16_attention(lib, dt):
    """ViT-L/16's attention (``models/vit.py: vit_block_apply``): 16 heads
    over T = S = 197 tokens (196 patches and the cls token), D = 64, not
    causal, q, k and v the three slices of one [B, T, 3, H, D] projection
    (a row stride of 3 H D).  The last query and key tiles hold 5 rows, and
    the rows of a K/V tile start at odd token offsets."""
    b, h, t, d = 1, 16, 197, 64
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3, h, d), dtype=np.float32)).to(dt)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, T, D] views
    got = _emulated(lib, q, k, v, causal=False)
    want = attention_ref(q, k, v, causal=False)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# -- the diffusion models' widths: attention_diffusion.cu's library ----------

_SHAPES = [None, 0, 1, 2]
_SHAPE_IDS = ["auto", "16x4", "32x4", "64x1"]
_DTYPES = [torch.float32, torch.bfloat16]


def _held(got, want, dt):
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", _DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("pair", DIFFUSION_HEAD_DIMS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_emulated_diffusion_pairs_in_both_types(lib, pair, dt):
    """Each diffusion width pair in float32 and bfloat16 over one ragged
    query tile, causal: at 40 and 72 a dim dropped past the last whole
    16-dim slice, or a stale padded one, would show here."""
    d, dv = pair
    rng = np.random.default_rng(d + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, n, w), dtype=np.float32)).to(dt) for n, w in
               ((20, d), (24, d), (24, dv)))
    _held(_emulated(lib, q, k, v, causal=True), attention_ref(q, k, v, causal=True), dt)


@pytest.mark.parametrize("shape", _SHAPES, ids=_SHAPE_IDS)
@pytest.mark.parametrize("dt", _DTYPES, ids=["float32", "bfloat16"])
def test_emulated_unet_cross_attention(lib, dt, shape):
    """UNet-SD1.5's cross-attention at its first level (``models/unet.py:
    _mha``): 8 heads of D = 40 over T = 64 latent positions and the text
    context's S = 77 keys, not causal, q [B, T, H, D] and k / v [B, S, H, D]
    in the model layout; the launcher's pick and each block shape forced."""
    b, h, t, s, d = 1, 8, 64, 77, 40
    rng = np.random.default_rng(77)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, d), dtype=np.float32)).to(dt).transpose(1, 2)
               for n in (t, s, s))
    _held(_emulated(lib, q, k, v, causal=False, shape=shape), attention_ref(q, k, v, causal=False), dt)


@pytest.mark.parametrize("shape", _SHAPES, ids=_SHAPE_IDS)
@pytest.mark.parametrize("dt", _DTYPES, ids=["float32", "bfloat16"])
def test_emulated_dit_self_attention(lib, dt, shape):
    """DiT-XL/2's attention (``models/dit.py: _block_apply``): D = 72, q, k
    and v the slices of one [B, T, 3, H, D] projection, ragged T = S = 40,
    not causal; the launcher's pick and each block shape forced."""
    b, h, t, d = 1, 4, 40, 72
    rng = np.random.default_rng(72)
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3, h, d), dtype=np.float32)).to(dt)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    _held(_emulated(lib, q, k, v, causal=False, shape=shape), attention_ref(q, k, v, causal=False), dt)


@pytest.mark.parametrize("shape", _SHAPES, ids=_SHAPE_IDS)
@pytest.mark.parametrize("dt", _DTYPES, ids=["float32", "bfloat16"])
def test_emulated_unaligned_kv_at_d40(lib, dt, shape):
    """D = 40 with K and V one element into wider buffers: the element
    copies' instantiation (10 of a row's elements per thread at most), and
    the 16-byte copies' remainder path is bypassed; causal T = 30, S = 45."""
    rng = np.random.default_rng(41)
    q = torch.from_numpy(rng.standard_normal((1, 30, 2, 40), dtype=np.float32)).to(dt)
    k, v = (torch.from_numpy(rng.standard_normal((1, 45, 2, 41), dtype=np.float32)).to(dt)[..., 1:]
            for _ in range(2))
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    assert k.data_ptr() % 16 and (k.stride(2) * k.element_size()) % 16
    _held(_emulated(lib, q, k, v, causal=True, shape=shape), attention_ref(q, k, v, causal=True), dt)


def test_emulated_libraries_refuse_each_others_pairs(lib):
    """Each library compiles only its own pairs: attention.cu's refuses 40
    and attention_diffusion.cu's 64 (cudaErrorInvalidValue, 1)."""
    for one, d in ((lib.main, 40), (lib.diffusion, 64), (lib.diffusion, 8)):
        q = torch.zeros((1, 2, 8, d))
        args = _args(q, q, q, torch.zeros_like(q))
        assert one.flash_attention_fwd(*args, 1.0, 1, 0, None) == 1
