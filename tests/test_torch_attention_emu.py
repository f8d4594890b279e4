"""The CUDA source of flash attention, run on the CPU through an emulation.

``src/repro_torch/kernels/attention/attention.cu`` is compiled as C++20 by
``g++`` with ``tests/cuda_emu/cuda_shim.h`` (threads for CUDA threads, a
barrier for ``__syncthreads``) and called through the same C interface the
wrapper uses.  This covers the kernel's own arithmetic -- ragged query and
key tiles, the top-left causal mask with T != S, the merge of the four
partial softmaxes of a row, GQA head indexing through the model layout's
strides, the head widths and the bfloat16 rounding -- where there is no
card; timing and the real compiler are checked only on the card
(``chip_smoke.py``).  Tolerances as in tests/test_torch_attention.py: 2e-5
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
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, i, p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _emulated(lib, q, k, v, causal):
    """q [B,H,T,D], k/v [B,Hkv,S,D], any strides with a dense head dimension."""
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*[st for x in (q, k, v, o) for st in x.stride()[:3]])
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        0 if q.dtype == torch.float32 else 1, b, h, k.shape[1], t, k.shape[2], d,
        strides, 1.0 / math.sqrt(d), int(causal), 0, None)
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
