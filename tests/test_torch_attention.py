"""The port's flash attention against the JAX package's Pallas kernel K3.

On the CPU the wrappers ``flash_attention`` / ``gqa_flash`` run their plain
version; they are held against ``flash_attention(..., interpret=True)`` and
``gqa_flash(..., interpret=True)`` and against the oracle ``attention_ref``.
Inputs come from numpy with a seed and go to both packages.  Tolerances are
``tests/test_kernels.py: _tol``: 2e-5 for float32 (the same products summed
in another order) and 2e-2 for bfloat16 (rounding at other places).  The CUDA
kernel's own arithmetic is run on the CPU by
``tests/test_torch_attention_emu.py`` and held against the plain version on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import attention_ref as jax_attention_ref
from repro.kernels.attention import flash_attention as jax_flash_attention
from repro.kernels.attention import gqa_flash as jax_gqa_flash
from repro_torch.kernels.attention import attention_ref, flash_attention, gqa_flash

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, H, T, S, D, causal): tests/test_kernels.py ATTN_CASES
ATTN_CASES = [
    (1, 2, 128, 128, 32, True),
    (2, 4, 256, 256, 64, True),
    (1, 2, 128, 128, 32, False),
    (1, 1, 64, 64, 16, True),
]


def _qkv(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "x".join(map(str, c[:5])) + ("-causal" if c[5] else ""))
def test_flash_attention_matches_jax(case, dtype):
    b, h, t, s, d, causal = case
    (jq, jk, jv), (q, k, v) = _both(_qkv(sum(case), (b, h, t, d), (b, h, s, d), (b, h, s, d)), dtype)
    got = flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype
    _close(got, jax_flash_attention(jq, jk, jv, causal=causal, q_block=64, kv_block=64,
                                    interpret=True), dtype)
    _close(got, jax_attention_ref(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,s", [(64, 128), (128, 64)], ids=["T<S", "T>S"])
def test_causal_mask_is_top_left_when_t_differs_from_s(t, s, dtype):
    """Query t sees keys 0..t whatever S is (the Pallas kernel's
    q_pos >= kv_pos), not FlashAttention-2's bottom-right alignment."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(t + s, (2, 2, t, 32), (2, 2, s, 32), (2, 2, s, 32)), dtype)
    got = flash_attention(q, k, v, causal=True)
    _close(got, jax_flash_attention(jq, jk, jv, causal=True, q_block=32, kv_block=32,
                                    interpret=True), dtype)
    # row 0 attends to key 0 alone: its output is v[0]
    np.testing.assert_allclose(got[:, :, 0].float().numpy(), v[:, :, 0].float().numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_flash_matches_jax(causal, dtype):
    """H = 8 query heads over Hkv = 2 KV heads, model layout [B, T, H, D]."""
    b, t, h, hkv, d = 2, 64, 8, 2, 32
    (jq, jk, jv), (q, k, v) = _both(_qkv(7, (b, t, h, d), (b, t, hkv, d), (b, t, hkv, d)), dtype)
    got = gqa_flash(q, k, v, causal=causal)
    assert tuple(got.shape) == (b, t, h, d)
    _close(got, jax_gqa_flash(jq, jk, jv, causal=causal, interpret=True), dtype)


def test_plain_version_matches_jax_ref_at_the_vit_shape():
    """T = S = 196 (the 14x14 token grid of ViT-L/16): no block multiple, and
    the port needs none; non-causal, float32."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(196, *[(1, 3, 196, 64)] * 3), "float32")
    _close(flash_attention(q, k, v, causal=False), jax_attention_ref(jq, jk, jv, causal=False), "float32")
    assert torch.equal(flash_attention(q, k, v, causal=False), attention_ref(q, k, v, causal=False))


@pytest.mark.parametrize(
    "shapes,err",
    [(((1, 2, 8, 24), (1, 2, 8, 24)), ValueError),   # D = 24 is not a kernel width
     (((1, 3, 8, 16), (1, 2, 8, 16)), ValueError),   # 3 heads over 2 KV heads
     (((1, 2, 8, 16), (1, 2, 8, 32)), ValueError),   # head dims differ
     (((2, 8, 16), (2, 8, 16)), ValueError)],        # not 4-d
)
def test_rejects_what_the_kernel_does_not_take(shapes, err):
    """Shapes in [B, H, T, D]; gqa_flash gets them as [B, T, H, D] views."""
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(err):
        gqa_flash(q.transpose(1, 2), k.transpose(1, 2), k.transpose(1, 2))
    with pytest.raises(err):
        flash_attention(q, k, k)


def test_flash_attention_needs_equal_heads_and_dense_head_dim():
    q = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError, match="gqa_flash"):
        flash_attention(q, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="dense"):
        flash_attention(q, q, torch.zeros((1, 4, 16, 8)).transpose(2, 3))
    with pytest.raises(TypeError):
        flash_attention(q, q, q.double())
