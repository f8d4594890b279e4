"""Gradients of the port's training path against the JAX package's, on the CPU.

The same seeded numpy inputs and cotangents go through ``jax.vjp`` (or
``jax.value_and_grad``) of the JAX function and through PyTorch's autograd
of its twin: ``batchnorm_train`` and ``softmax_xent``; K1's autograd
``Function`` (``conv2d_cuda`` with operands that require grad: on the CPU
its forward is the plain version, its backward ``conv2d_backward`` -- the
stride-1 input gradient as a conv of the flipped filter through the
wrapper, the rest the library's); K3's (``flash_attention`` / ``gqa_flash``
and ``FlashAttentionFunction``: the plain forward, the chunked float32
backward).  The vision models' ``loss_fn`` gradients are
``tests/test_torch_train_loss.py``'s.

Tolerances: per function ``tests/test_kernels.py: _tol`` (2e-5 x (1 + |g|)
in float32, 2e-2 x (1 + |g|) in bfloat16).  A function's bfloat16 values
are held to JAX's bfloat16 ones, its bfloat16 gradients to JAX's float32
``vjp`` at the bfloat16-rounded inputs and cotangent (the gradient of the
same bfloat16 numbers): XLA's CPU sums a broadcast's transpose in
bfloat16, PyTorch in float32 (batchnorm_train's shift gradient, 60 terms of
~13: JAX's bfloat16 0.47 off, the port's 0.03).  A conv's gradients may also
miss by ``SUM_RTOL`` x the same gradient of the operands' absolute values
(each element's sum of |terms|): where the terms of a 1536-term sum cancel,
two float32 orders part by more than 2e-5 x (1 + |g|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ref import attention_ref as jattention_ref
from repro.models import layers as jlayers
from repro_torch.kernels.attention import flash_attention, gqa_flash
from repro_torch.kernels.attention.ops import FlashAttentionFunction
from repro_torch.kernels.conv2d import conv2d_cuda
from repro_torch.models import layers

SUM_RTOL = 2.0 ** -20  # chip_smoke.py's: the scale of a float32 sum's rounding


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, slack=0.0):
    """|got - want| <= _tol x (1 + |want|) + ``slack`` elementwise."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    tol = _tol(dtype)["rtol"]
    excess = np.abs(got - want) - (tol * (1 + np.abs(want)) + slack)
    assert excess.max() <= 0, (excess.max(), np.abs(got - want).max())


def _pair(a, dtype):
    """A float32 numpy array as the JAX array and the leaf tensor (requiring
    grad) of ``dtype``."""
    return jnp.asarray(a).astype(jnp.dtype(dtype)), torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()


def _jax_vjp(fn, args, ct, dtype):
    """(fn(*args), the cotangent ``ct``'s gradients) in JAX: in ``dtype``'s
    float32 ``vjp`` at the ``dtype``-rounded numpy ``args`` and ``ct``."""
    r = [jnp.asarray(a).astype(jnp.dtype(dtype)).astype(jnp.float32) for a in (*args, ct)]
    out, vjp = jax.vjp(fn, *r[:-1])
    return out, vjp(r[-1])


# -- batchnorm_train, softmax_xent, drop_path ---------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_and_softmax_xent_match_jax(dtype):
    rng = np.random.default_rng(11)
    x = 3 * rng.standard_normal((2, 5, 6, 16), dtype=np.float32) + 0.5
    scale = 1 + 0.1 * rng.standard_normal(16, dtype=np.float32)
    b = 0.1 * rng.standard_normal(16, dtype=np.float32)
    ct = rng.standard_normal(x.shape, dtype=np.float32)
    (jx, tx), (js, ts), (jb, tb) = _pair(x, dtype), _pair(scale, dtype), _pair(b, dtype)

    def jbn(x, s, b):
        return jlayers.batchnorm_train(x, {"scale": s, "b": b})

    got = layers.batchnorm_train(tx, {"scale": ts, "b": tb})
    assert got.dtype == tx.dtype
    _close(got, jbn(jx, js, jb), dtype)
    _, want = _jax_vjp(jbn, (x, scale, b), ct, dtype)
    for g, w in zip(torch.autograd.grad(got, (tx, ts, tb), _pair(ct, dtype)[1].detach()), want):
        assert g.dtype == tx.dtype
        _close(g, w, dtype)

    logits = 3 * rng.standard_normal((6, 10), dtype=np.float32)
    labels = rng.integers(0, 10, 6).astype(np.int32)
    jl, tl = _pair(logits, dtype)
    want, vjp = jax.vjp(lambda lg: jlayers.softmax_xent(lg, jnp.asarray(labels)), jl)
    got = layers.softmax_xent(tl, torch.from_numpy(labels))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, "float32")
    (g,), (w,) = torch.autograd.grad(got, (tl,)), vjp(jnp.float32(1.0))
    assert g.dtype == tl.dtype and w.dtype == jl.dtype  # the cotangent comes back in the logits' type
    _close(g, w, dtype)  # one cast of a float32 softmax: no bfloat16 sum on either side


def test_drop_path_contract():
    """Rate 0 is the identity; otherwise each sample is either zeroed or
    scaled by 1 / (1 - rate), the draw a function of the generator's seed,
    the share kept near 1 - rate, the type kept."""
    x = torch.randn(4000, 3, 2).to(torch.bfloat16)
    assert layers.drop_path(x, torch.Generator().manual_seed(0), 0.0) is x
    rate = 0.25
    y = layers.drop_path(x, torch.Generator().manual_seed(1), rate)
    assert y.dtype == x.dtype and y.shape == x.shape
    kept = (y != 0).flatten(1).any(dim=1)
    scaled = x / (1.0 - rate)
    assert torch.equal(y[kept], scaled[kept]) and not y[~kept].any()
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.03
    assert torch.equal(y, layers.drop_path(x, torch.Generator().manual_seed(1), rate))
    assert not torch.equal(y, layers.drop_path(x, torch.Generator().manual_seed(2), rate))


# -- K1 under autograd --------------------------------------------------------

# tests/test_kernels.py's CONV_CASES (N, H, W, Cin, Cout, k, pad) at stride 1
# with a bias, then stride 2, depthwise at stride 1 and 2, VALID and no bias:
# (N, H, W, Cin, Cout, k, stride, pad, groups, bias)
CONV_CASES = [
    (1, 16, 16, 8, 16, 3, 1, 1, 1, True),
    (2, 32, 24, 16, 32, 3, 1, 1, 1, True),
    (1, 8, 8, 4, 8, 1, 1, 0, 1, True),
    (1, 20, 20, 8, 16, 5, 1, 2, 1, True),
    (2, 14, 14, 32, 64, 3, 1, 1, 1, True),
    (1, 17, 13, 3, 8, 3, 1, 1, 1, True),
    (2, 15, 11, 4, 8, 3, 2, 1, 1, True),
    (1, 16, 16, 8, 16, 16, 16, 0, 1, True),  # ViT's patch embedding: k = s
    (2, 12, 10, 16, 16, 3, 1, 1, 16, False),
    (2, 13, 11, 16, 16, 5, 2, 2, 16, False),
    (2, 9, 9, 8, 12, 3, 1, 0, 1, True),
    (2, 9, 7, 8, 12, 1, 1, 0, 1, False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c[:9])) + ("b" if c[9] else ""))
def test_conv_function_grads_match_jax_vjp(case, dtype):
    n, h, w, cin, cout, k, s, pad, g, has_bias = case
    rng = np.random.default_rng(sum(case[:9]))
    x = rng.standard_normal((n, h, w, cin), dtype=np.float32)
    wt = 0.1 * rng.standard_normal((k, k, 1 if g > 1 else cin, cout), dtype=np.float32)
    b = rng.standard_normal(cout, dtype=np.float32)
    (jx, tx), (jw, tw), (jb, tb) = _pair(x, dtype), _pair(wt, dtype), _pair(b, dtype)

    def jconv(x, w, *bias):
        p = {"w": w, **({"b": bias[0]} if bias else {})}
        return jlayers.conv2d(x, p, stride=s, padding=pad, groups=g)

    args, targs = ((x, wt, b), (tx, tw, tb)) if has_bias else ((x, wt), (tx, tw))
    got = conv2d_cuda(tx, tw, tb if has_bias else None, stride=s, padding=pad, groups=g)
    _close(got, jconv(*((jx, jw, jb) if has_bias else (jx, jw))), dtype)
    ct = rng.standard_normal(got.shape, dtype=np.float32)
    _, want = _jax_vjp(jconv, args, ct, dtype)
    _, sums = _jax_vjp(jconv, [np.abs(a) for a in args], np.abs(ct), dtype)  # each gradient's sum of |terms|
    grads = torch.autograd.grad(got, targs, _pair(ct, dtype)[1].detach())
    for gt, gj, gs, t in zip(grads, want, sums, targs):
        assert gt.dtype == t.dtype and gt.shape == t.shape
        _close(gt, gj, dtype, SUM_RTOL * _np(gs))


def test_conv_function_takes_only_the_gradients_asked_for():
    """Images need no gradient: with only the weights requiring one, the
    input gradient is never formed; without grad the wrapper is the plain
    call (no graph)."""
    x = torch.randn(2, 8, 8, 4)
    w = torch.randn(3, 3, 4, 8, requires_grad=True)
    y = conv2d_cuda(x, w, None, stride=1, padding=1)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "Conv2dFunctionBackward"
    (gw,) = torch.autograd.grad(y.sum(), (w,))
    assert gw.shape == w.shape
    with torch.no_grad():
        assert conv2d_cuda(x, w, None, stride=1, padding=1).grad_fn is None


# -- K3 under autograd --------------------------------------------------------

# (B, H, Hkv, T, S, D, DV, causal)
ATTN_CASES = [
    (2, 4, 4, 9, 9, 16, 16, False),
    (2, 4, 4, 9, 9, 16, 16, True),
    (1, 2, 2, 6, 13, 32, 32, True),   # top-left causal, T < S
    (1, 2, 2, 13, 6, 32, 32, True),   # T > S
    (1, 2, 2, 7, 11, 32, 32, False),
    (2, 8, 2, 10, 10, 16, 16, True),  # GQA: 4 query heads a KV head
    (1, 4, 4, 5, 7, 24, 16, True),    # a value narrower than the query/key width
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_function_grads_match_jax_vjp(case, monkeypatch):
    """In one chunk of query rows, then (the score budget of two rows) in
    several."""
    from repro_torch.kernels.attention import ops

    b, h, hkv, t, s, d, dv, causal = case
    rng = np.random.default_rng(sum(case))
    q = rng.standard_normal((b, h, t, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, dv), dtype=np.float32)
    ct = rng.standard_normal((b, h, t, dv), dtype=np.float32)
    g = h // hkv

    def jattn(q, k, v):
        return jattention_ref(q, jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1), causal=causal)

    want, vjp = jax.vjp(jattn, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(ct))
    for budget in (ops.BACKWARD_SCORE_BYTES, 4 * b * h * s * 2):
        monkeypatch.setattr(ops, "BACKWARD_SCORE_BYTES", budget)
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        if (d, dv) == (24, 16):  # no kernel pair: the Function itself, as the card's would run it
            got = FlashAttentionFunction.apply(tq, tk, tv, causal)
        elif g > 1:  # the model layout [B, T, H, D]
            got = gqa_flash(*(x.transpose(1, 2) for x in (tq, tk, tv)), causal=causal).transpose(1, 2)
        else:
            got = flash_attention(tq, tk, tv, causal=causal)
        assert type(got.grad_fn).__name__ in ("FlashAttentionFunctionBackward", "TransposeBackward0")
        _close(got, want, "float32")
        for gt, gj in zip(torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(ct)), want_grads):
            _close(gt, gj, "float32")
