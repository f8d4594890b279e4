"""The port's direct conv against the JAX package's Pallas kernel K1.

On the CPU the wrapper ``conv2d_cuda`` runs its plain version; it is held
against ``conv2d_pallas(..., interpret=True)`` (few cases: interpret mode is
slow) and against the oracle ``conv2d_ref``.  Inputs come from numpy with a
seed and go to both packages.  Tolerances are ``tests/test_kernels.py: _tol``:
2e-5 for float32 (the same products summed in another order) and 2e-2 for
bfloat16 (the frameworks round to bfloat16 at different places).  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d import conv2d_pallas
from repro.kernels.conv2d import conv2d_ref as jax_conv2d_ref
from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (N, H, W, Cin, Cout, k, pad): tests/test_kernels.py CONV_CASES
CONV_CASES = [
    (1, 16, 16, 8, 16, 3, 1),
    (2, 32, 24, 16, 32, 3, 1),
    (1, 8, 8, 4, 8, 1, 0),
    (1, 20, 20, 8, 16, 5, 2),
    (2, 14, 14, 32, 64, 3, 1),  # VGG-16 deep-layer-like
    (1, 17, 13, 3, 8, 3, 1),  # odd sizes, Cin = 3 as in conv1_1
]


def _inputs(seed, n, h, w, cin, cout, k, depthwise=False, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin), dtype=np.float32)
    wts = 0.1 * rng.standard_normal((k, k, 1 if depthwise else cin, cout), dtype=np.float32)
    b = rng.standard_normal((cout,), dtype=np.float32) if bias else None
    return x, wts, b


def _both(arrays, dtype):
    """The same numpy arrays as JAX and as torch tensors of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    jx = [None if a is None else jnp.asarray(a).astype(jdt) for a in arrays]
    tx = [None if a is None else torch.from_numpy(a).to(tdt) for a in arrays]
    return jx, tx


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv2d_plain_matches_jax_ref(case, dtype):
    n, h, w, cin, cout, k, pad = case
    (jx, jw, jb), (tx, tw, tb) = _both(_inputs(0, n, h, w, cin, cout, k), dtype)
    got = conv2d_cuda(tx, tw, tb, padding=pad)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, jax_conv2d_ref(jx, jw, jb, padding=pad), dtype)


@pytest.mark.parametrize(
    "case,dtype",
    [((1, 17, 13, 3, 8, 3, 1), "float32"), ((2, 14, 14, 32, 64, 3, 1), "bfloat16")],
)
def test_conv2d_plain_matches_pallas_interpret(case, dtype):
    n, h, w, cin, cout, k, pad = case
    (jx, jw, jb), (tx, tw, tb) = _both(_inputs(1, n, h, w, cin, cout, k), dtype)
    _close(conv2d_cuda(tx, tw, tb, padding=pad),
           conv2d_pallas(jx, jw, jb, padding=pad, interpret=True), dtype)


# (N, H, W, Cin, Cout, k, stride, pad): a subset of tests/test_kernels.py STRIDED_CASES
@pytest.mark.parametrize("case", [(1, 16, 16, 8, 16, 3, 2, 1), (2, 15, 11, 4, 8, 3, 2, 1),
                                  (1, 16, 16, 3, 8, 7, 2, 3)])
def test_conv2d_plain_strided(case):
    n, h, w, cin, cout, k, s, pad = case
    (jx, jw, _), (tx, tw, _) = _both(_inputs(2, n, h, w, cin, cout, k, bias=False), "float32")
    _close(conv2d_cuda(tx, tw, stride=s, padding=pad),
           jax_conv2d_ref(jx, jw, stride=s, padding=pad), "float32")


def test_conv2d_plain_strided_matches_pallas_interpret():
    (jx, jw, jb), (tx, tw, tb) = _both(_inputs(3, 1, 13, 11, 4, 8, 3), "float32")
    _close(conv2d_cuda(tx, tw, tb, stride=2, padding=1),
           conv2d_pallas(jx, jw, jb, stride=2, padding=1, interpret=True), "float32")


@pytest.mark.parametrize("k,stride", [(3, 1), (7, 1), (3, 2)])
def test_conv2d_plain_depthwise(k, stride):
    c, pad = 8, k // 2
    (jx, jw, jb), (tx, tw, tb) = _both(_inputs(4, 1, 24, 20, c, c, k, depthwise=True), "float32")
    _close(conv2d_cuda(tx, tw, tb, stride=stride, padding=pad, groups=c),
           jax_conv2d_ref(jx, jw, jb, stride=stride, padding=pad, groups=c), "float32")


def test_conv2d_plain_depthwise_matches_pallas_interpret():
    c = 8
    (jx, jw, _), (tx, tw, _) = _both(_inputs(5, 1, 12, 10, c, c, 3, depthwise=True, bias=False),
                                     "float32")
    _close(conv2d_cuda(tx, tw, padding=1, groups=c),
           conv2d_pallas(jx, jw, padding=1, groups=c, interpret=True), "float32")


def test_conv2d_rejects_grouped_non_depthwise():
    x = torch.zeros((1, 8, 8, 8))
    wts = torch.zeros((3, 3, 4, 8))  # groups=2: neither dense nor depthwise
    with pytest.raises(ValueError, match="depthwise"):
        conv2d_cuda(x, wts, padding=1, groups=2)
    with pytest.raises(ValueError, match="depthwise"):
        conv2d_pallas(jnp.zeros((1, 8, 8, 8)), jnp.zeros((3, 3, 4, 8)), padding=1, groups=2,
                      interpret=True)


@pytest.mark.parametrize(
    "x,w,b,kw,err",
    [
        (torch.zeros(1, 8, 8, 8, dtype=torch.float64), torch.zeros(3, 3, 8, 4, dtype=torch.float64),
         None, {}, TypeError),  # dtype
        (torch.zeros(1, 8, 8, 8), torch.zeros(3, 3, 8, 4).bfloat16(), None, {}, TypeError),  # mixed
        (torch.zeros(1, 8, 8, 8), torch.zeros(3, 3, 6, 4), None, {}, ValueError),  # Cin mismatch
        (torch.zeros(1, 8, 8, 8), torch.zeros(3, 3, 8, 4), torch.zeros(5), {}, ValueError),  # bias
        (torch.zeros(1, 8, 8, 8).transpose(2, 3), torch.zeros(3, 3, 8, 4), None, {}, ValueError),
        (torch.zeros(1, 2, 2, 8), torch.zeros(3, 3, 8, 4), None, {"padding": 0}, ValueError),
        (torch.zeros(1, 8, 8, 8), torch.zeros(3, 3, 8, 4), None, {"stride": 0}, ValueError),
    ],
    ids=["float64", "mixed-dtype", "cin", "bias-shape", "channels-strided", "too-small",
         "stride-0"],
)
def test_conv2d_wrapper_rejects(x, w, b, kw, err):
    """The wrapper checks its arguments alike on both devices: what the kernel
    does not take raises instead of reading garbage."""
    with pytest.raises(err):
        conv2d_cuda(x, w, b, **kw)


def test_conv2d_plain_reads_row_slices_of_a_batch():
    """Row slices of a batch (run_plan's segments) are views with a batch
    stride other than H*W*C; the result equals that of a contiguous copy."""
    x, w, b = _inputs(6, 2, 20, 9, 5, 7, 3)
    xt = torch.from_numpy(x)[:, 3:15]
    assert not xt.is_contiguous()
    args = (torch.from_numpy(w), torch.from_numpy(b))
    torch.testing.assert_close(conv2d_cuda(xt, *args, padding=0),
                               conv2d_ref(xt.contiguous(), *args, padding=0), rtol=0, atol=0)


def test_conv2d_cpu_does_not_count_launches():
    before = conv2d_cuda.launches
    conv2d_cuda(torch.zeros(1, 4, 4, 2), torch.zeros(3, 3, 2, 2))
    assert conv2d_cuda.launches == before
