"""The port's halo conv (K2) against the JAX package's fused Pallas kernel.

On the CPU the wrapper ``halo_conv2d_cuda`` runs its plain version; both are
held against ``halo_conv2d(..., interpret=True)`` and the oracle
``halo_conv2d_ref`` over the cases of ``tests/test_kernels.py`` (k and pad,
the stride sweep, remainder tiles, the inexact-halo rejection, equality with
the unsharded conv), plus depthwise, the other two rejections and the
weighted path's call pattern (an absent bottom halo read as zero rows).
Inputs come from numpy with a seed and go to both packages.  Tolerances are
``tests/test_kernels.py: _tol``: 2e-5 for float32 and 2e-2 for bfloat16.  The
CUDA source itself runs on the CPU in ``tests/test_torch_halo_conv_emu.py``
and on the card in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d import conv2d_ref as jax_conv2d_ref
from repro.kernels.halo_conv import halo_conv2d
from repro.kernels.halo_conv import halo_conv2d_ref as jax_halo_conv2d_ref
from repro_torch.kernels.halo_conv import halo_conv2d_cuda, halo_conv2d_ref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, b, hs, w, cin, cout, k, lo, hi, depthwise=False, bias=True):
    """Numpy shard, halos (None where empty), weights and bias."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hs, w, cin), dtype=np.float32)
    top = rng.standard_normal((b, lo, w, cin), dtype=np.float32) if lo else None
    bot = rng.standard_normal((b, hi, w, cin), dtype=np.float32) if hi else None
    wts = 0.1 * rng.standard_normal((k, k, 1 if depthwise else cin, cout), dtype=np.float32)
    bb = rng.standard_normal((cout,), dtype=np.float32) if bias else None
    return x, top, bot, wts, bb


def _both(arrays, dtype="float32"):
    jdt, tdt = DTYPES[dtype]
    jx = [None if a is None else jnp.asarray(a).astype(jdt) for a in arrays]
    tx = [None if a is None else torch.from_numpy(a).to(tdt) for a in arrays]
    return jx, tx


def _close(got: torch.Tensor, want, dtype="float32"):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,pad", [(3, 1), (5, 2)])
def test_halo_conv_matches_jax(k, pad, dtype):
    """tests/test_kernels.py:145: the wrapper and the plain version against
    the Pallas kernel (interpret) and the JAX oracle."""
    b, hs, w, cin, cout = 2, 16, 12, 8, 16
    (jx, jt, jb_, jw, jbias), (tx, tt, tb_, tw, tbias) = _both(
        _inputs(0, b, hs, w, cin, cout, k, pad, k - 1 - pad), dtype)
    got = halo_conv2d_cuda(tx, tt, tb_, tw, tbias, padding=pad)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, halo_conv2d(jx, jt, jb_, jw, jbias, padding=pad, interpret=True), dtype)
    _close(halo_conv2d_ref(tx, tt, tb_, tw, tbias, padding=pad),
           jax_halo_conv2d_ref(jx, jt, jb_, jw, jbias, padding=pad), dtype)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (5, 1, 2), (3, 2, 1), (5, 2, 3), (7, 2, 3)])
def test_halo_conv_stride_sweep(k, stride, pad):
    """tests/test_kernels.py:205: k in {3, 5, 7}, stride in {1, 2}, exact
    halos lo + hi == k - s (hi = 0 for k3 s2 p1 and k5 s2 p3)."""
    b, hs, w, cin, cout = 1, 16, 11, 4, 8
    (jx, jt, jb_, jw, _), (tx, tt, tb_, tw, _) = _both(
        _inputs(2, b, hs, w, cin, cout, k, pad, k - pad - stride, bias=False))
    got = halo_conv2d_cuda(tx, tt, tb_, tw, stride=stride, padding=pad)
    _close(got, halo_conv2d(jx, jt, jb_, jw, stride=stride, padding=pad, interpret=True))
    _close(got, jax_halo_conv2d_ref(jx, jt, jb_, jw, stride=stride, padding=pad))


@pytest.mark.parametrize("hs,tile_h", [(10, 4), (16, 6), (7, 3)])
def test_halo_conv_remainder_tiles(hs, tile_h):
    """tests/test_kernels.py:222: shard heights that are no multiple of the
    TPU kernel's row tile keep every output row (the port has no row tiles;
    its pixel tiles of 128 are ragged here too)."""
    b, w, cin, cout, k, pad = 1, 9, 4, 8, 3, 1
    (jx, jt, jb_, jw, _), (tx, tt, tb_, tw, _) = _both(
        _inputs(3, b, hs, w, cin, cout, k, pad, k - 1 - pad, bias=False))
    got = halo_conv2d_cuda(tx, tt, tb_, tw, padding=pad)
    assert got.shape[1] == hs
    _close(got, halo_conv2d(jx, jt, jb_, jw, padding=pad, tile_h=tile_h, interpret=True))


@pytest.mark.parametrize("k,stride", [(3, 1), (7, 1), (3, 2)])
def test_halo_conv_depthwise(k, stride):
    c, pad = 8, k // 2
    (jx, jt, jb_, jw, jbias), (tx, tt, tb_, tw, tbias) = _both(
        _inputs(4, 1, 12, 10, c, c, k, pad, k - pad - stride, depthwise=True))
    got = halo_conv2d_cuda(tx, tt, tb_, tw, tbias, stride=stride, padding=pad, groups=c)
    _close(got, jax_halo_conv2d_ref(jx, jt, jb_, jw, jbias, stride=stride, padding=pad, groups=c))
    if k == 3:  # interpret mode is slow: one depthwise case through the Pallas kernel
        _close(got, halo_conv2d(jx, jt, jb_, jw, jbias, stride=stride, padding=pad, groups=c,
                                interpret=True))


def test_halo_conv_equals_unsharded_conv():
    """tests/test_kernels.py:249: two half shards with exchanged halos are the
    unsharded conv."""
    b, h, w, cin, cout = 1, 32, 16, 4, 8
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin), dtype=np.float32))
    wts = torch.from_numpy(0.1 * rng.standard_normal((3, 3, cin, cout), dtype=np.float32))
    want = jax_conv2d_ref(jnp.asarray(x.numpy()), jnp.asarray(wts.numpy()), padding=1)
    top_shard, bot_shard = x[:, : h // 2], x[:, h // 2 :]
    zeros = torch.zeros((b, 1, w, cin))
    y_top = halo_conv2d_cuda(top_shard, zeros, bot_shard[:, :1], wts, padding=1)
    y_bot = halo_conv2d_cuda(bot_shard, top_shard[:, -1:], zeros, wts, padding=1)
    _close(torch.cat([y_top, y_bot], dim=1), want)
    # an absent edge halo of lo / hi rows is the same zero padding
    y_top = halo_conv2d_cuda(top_shard, None, bot_shard[:, :1], wts, padding=1, lo=1)
    y_bot = halo_conv2d_cuda(bot_shard, top_shard[:, -1:], None, wts, padding=1, hi=1)
    _close(torch.cat([y_top, y_bot], dim=1), want)


@pytest.mark.parametrize("k,s,p,hmax", [(3, 1, 1, 8), (5, 1, 2, 6), (7, 2, 3, 8), (3, 2, 1, 6)])
def test_absent_bottom_is_the_weighted_zero_padding(k, s, p, hmax):
    """The capacity-weighted fused path: JAX convolves the block followed by
    ``pad_rows`` zero rows with a zero bottom operand and keeps the first
    ``hmax // s`` rows (repro/spatial/halo.py l.418-423, l.455-459); the port
    passes no bottom operand, ``hi`` zero rows that never exist in memory."""
    lo, hi = p, k - p - s
    (jx, jt, _, jw, jbias), (tx, tt, _, tw, tbias) = _both(
        _inputs(6, 2, hmax, 9, 4, 8, k, lo, 0))
    pad_rows = hi + (-(hmax + hi)) % s
    x_ext = jnp.concatenate([jx, jnp.zeros((2, pad_rows, 9, 4))], axis=1) if pad_rows else jx
    zero_bot = jnp.zeros((2, hi, 9, 4)) if hi else None
    want = halo_conv2d(x_ext, jt, zero_bot, jw, jbias, stride=s, padding=p,
                       interpret=True)[:, : hmax // s]
    _close(halo_conv2d_cuda(tx, tt, None, tw, tbias, stride=s, padding=p, hi=hi), want)


@pytest.mark.parametrize(
    "xs,top,bot,k,s,kw,match",
    [
        ((1, 8, 8, 4), (1, 1, 8, 4), (1, 2, 8, 4), 3, 1, {}, "lo \\+ hi"),  # l.52, inexact halos
        ((1, 7, 8, 4), (1, 1, 8, 4), None, 3, 2, {}, "not divisible by stride"),  # l.58
        ((1, 8, 2, 4), (1, 2, 2, 4), (1, 2, 2, 4), 5, 1, {"padding": 1}, "non-positive output width"),
        ((1, 8, 8, 4), None, None, 3, 1, {"lo": 1}, "lo \\+ hi"),  # absent halos still counted
        ((1, 8, 8, 4), (1, 1, 8, 4), None, 3, 1, {"lo": 2, "hi": 1}, "lo=2"),  # count != rows
        ((1, 8, 8, 4), (1, 1, 9, 4), (1, 1, 8, 4), 3, 1, {}, "does not fit"),
    ],
    ids=["inexact-halos", "stride-multiple", "output-width", "absent-inexact",
         "count-mismatch", "halo-shape"],
)
def test_halo_conv_rejections(xs, top, bot, k, s, kw, match):
    """The checks of ``halo_conv2d`` (and the port's own on ``lo``/``hi``);
    JAX's own three raise alike."""
    x = torch.zeros(xs)
    t = None if top is None else torch.zeros(top)
    bt = None if bot is None else torch.zeros(bot)
    wts = torch.zeros((k, k, xs[3], 8))
    with pytest.raises(ValueError, match=match):
        halo_conv2d_cuda(x, t, bt, wts, stride=s, **kw)
    if not set(kw) & {"lo", "hi"} and match != "does not fit":
        with pytest.raises(ValueError, match=match):
            halo_conv2d(jnp.zeros(xs), None if top is None else jnp.zeros(top),
                        None if bot is None else jnp.zeros(bot), jnp.zeros((k, k, xs[3], 8)),
                        stride=s, interpret=True, **kw)
