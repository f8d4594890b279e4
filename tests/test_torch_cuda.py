"""Tests of the port that need the card (marker ``cuda``; they skip without
one).  They import neither JAX nor the JAX package, so they run on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 for float32 (the kernel and the plain version sum the same
products in another order; TF32 is off for the plain version's matmuls) and
2e-2 for bfloat16 (both round one float32 sum), as tests/test_kernels.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref
from repro_torch.launch.serve import serve
from repro_torch.models import vgg
from repro_torch.models.common import tree_map

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# (N, H, W, Cin, Cout, k, stride, pad, groups, row-slice view)
CASES = [
    (1, 16, 16, 8, 16, 3, 1, 1, 1, False),
    (2, 32, 24, 16, 32, 3, 1, 1, 1, True),
    (1, 8, 8, 4, 8, 1, 1, 0, 1, False),
    (1, 20, 20, 8, 16, 5, 1, 2, 1, False),
    (2, 14, 14, 32, 64, 3, 1, 1, 1, False),
    (1, 17, 13, 3, 8, 3, 1, 1, 1, False),
    (2, 15, 11, 4, 8, 3, 2, 1, 1, True),
    (1, 24, 20, 8, 8, 7, 2, 3, 8, False),
]


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_conv2d_kernel_matches_plain_on_card(card, dtype):
    for seed, (n, h, w, cin, cout, k, s, pad, g, view) in enumerate(CASES):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal((n, h + 4, w, cin), dtype=np.float32))
        x = x.to(card, dtype)[:, 2:2 + h]
        x = x if view else x.contiguous()
        wts = torch.from_numpy(0.1 * rng.standard_normal((k, k, 1 if g > 1 else cin, cout),
                                                         dtype=np.float32)).to(card, dtype)
        b = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32)).to(card, dtype)
        before = conv2d_cuda.launches
        got = conv2d_cuda(x, wts, b, stride=s, padding=pad, groups=g)
        assert conv2d_cuda.launches == before + 1
        want = conv2d_ref(x, wts, b, stride=s, padding=pad, groups=g)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_served_smoke_logits_on_card_match_cpu(card):
    """The smoke configuration served on the card through the kernel equals
    the same parameters and images served on the CPU through the plain conv."""
    out = serve(vgg.SMOKE, n_requests=4, max_batch=2, device="cuda", seed=1)
    params = tree_map(lambda t: t.cpu(), out["params"])
    want = vgg.apply(params, vgg.SMOKE, out["images"].cpu())
    torch.testing.assert_close(out["logits"].cpu(), want, rtol=2e-5, atol=2e-5)
