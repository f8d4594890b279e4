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

from repro_torch.core import partition, plan_even
from repro_torch.kernels.attention import attention_ref, flash_attention, gqa_flash
from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref
from repro_torch.kernels.halo_conv import halo_conv2d_cuda, halo_conv2d_ref
from repro_torch.launch.mesh import make_spatial_comm
from repro_torch.launch.serve import serve
from repro_torch.models import vgg, vit_spatial
from repro_torch.models.common import tree_map
from repro_torch.parallel import weighted_spatial_inputs
from repro_torch.spatial import features_spatial, merge_padded_shards, run_plan, spatial_alignment

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


# (B, Hs, W, Cin, Cout, k, stride, pad, groups, halos as row-slice views)
HALO_CASES = [
    (2, 16, 12, 8, 16, 3, 1, 1, 1, True),
    (1, 16, 11, 4, 8, 5, 1, 2, 1, False),
    (2, 16, 11, 4, 8, 3, 2, 1, 1, True),   # lo = 1, hi = 0
    (2, 16, 11, 4, 8, 7, 2, 3, 1, True),   # lo = 3, hi = 2
    (2, 7, 9, 3, 70, 3, 1, 1, 1, True),    # Cin 3, two Cout tiles, ragged pixel tile
    (2, 12, 10, 8, 8, 7, 1, 3, 8, True),   # depthwise k7
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_halo_conv_kernel_matches_plain_on_card(card, dtype):
    for seed, (b, hs, w, cin, cout, k, s, pad, g, view) in enumerate(HALO_CASES):
        lo, hi = pad, k - pad - s
        rng = np.random.default_rng(seed)

        def arr(*shape, scale=1.0):
            return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).to(card, dtype)

        x = arr(b, hs, w, cin)
        above, below = arr(b, hs, w, cin), arr(b, hs, w, cin)
        top = above[:, hs - lo:] if lo else None
        bot = below[:, :hi] if hi else None
        if not view:
            top = None if top is None else top.contiguous()
            bot = None if bot is None else bot.contiguous()
        wts = arr(k, k, 1 if g > 1 else cin, cout, scale=0.1)
        bias = arr(cout)
        before = halo_conv2d_cuda.launches
        got = halo_conv2d_cuda(x, top, bot, wts, bias, stride=s, padding=pad, groups=g)
        assert halo_conv2d_cuda.launches == before + 1
        want = halo_conv2d_ref(x, top, bot, wts, bias, stride=s, padding=pad, groups=g)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
        if hi:  # an absent bottom halo reads as hi zero rows
            got = halo_conv2d_cuda(x, top, None, wts, bias, stride=s, padding=pad, groups=g, hi=hi)
            want = halo_conv2d_ref(x, top, torch.zeros_like(bot), wts, bias,
                                   stride=s, padding=pad, groups=g)
            torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_empty_output_launches_nothing_on_card(card):
    """A shard of 0 rows (or a batch of 0) has an empty output: no kernel
    starts, and neither launch count moves."""
    halo = torch.ones((2, 1, 9, 4), device=card)
    wts, bias = torch.ones((3, 3, 4, 8), device=card), torch.ones(8, device=card)
    before = halo_conv2d_cuda.launches, conv2d_cuda.launches
    y = halo_conv2d_cuda(torch.zeros((2, 0, 9, 4), device=card), halo, halo, wts, bias)
    z = conv2d_cuda(torch.zeros((0, 5, 5, 4), device=card), wts, bias)
    assert (halo_conv2d_cuda.launches, conv2d_cuda.launches) == before
    assert y.shape == (2, 0, 9, 8) and z.shape == (0, 5, 5, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["direct", "fused"])
def test_spatial_smoke_vgg_on_card_matches_single_device(card, engine):
    """The smoke VGG's first two blocks (stride alignment 4) over 4
    capacity-weighted shards on the card equal the single-device features
    through the direct conv."""
    cfg = vgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10, blocks=((2, 64), (2, 128)))
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = vgg.init(gen, cfg)
    x = torch.randn((2, 64, 64, 3), generator=gen, device="cuda")
    net = cfg.geom()
    comm = make_spatial_comm(4, device="cuda")
    plan = plan_even(net, 4, ratios=(1.0, 0.55, 0.35, 0.8))
    xs, heights = weighted_spatial_inputs(x, plan, comm, align=spatial_alignment(net))
    before = halo_conv2d_cuda.launches
    ys = features_spatial(params["features"], net, xs, comm=comm, heights=heights, engine=engine)
    n_convs = sum(g.kind == "conv" for g in net.layers)
    assert halo_conv2d_cuda.launches - before == (4 * n_convs if engine == "fused" else 0)
    got = merge_padded_shards(ys, [h // spatial_alignment(net) for h in heights])
    want = vgg.features(params, cfg, x)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# (B, H, Hkv, T, S, D, causal): the ViT path's head-split shape (8 of 16
# heads over the 14x14 grid), top-left causal T != S both ways, GQA at D=128
ATTN_CASES = [
    (4, 8, 8, 196, 196, 64, False),
    (2, 4, 4, 100, 260, 32, True),
    (2, 4, 4, 260, 100, 16, True),
    (2, 16, 4, 130, 130, 128, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain_on_card(card, dtype):
    for seed, (b, h, hkv, t, s, d, causal) in enumerate(ATTN_CASES):
        rng = np.random.default_rng(seed)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, n, heads, d), dtype=np.float32)).to(card, dtype)
                   for n, heads in ((t, h), (s, hkv), (s, hkv)))
        before = flash_attention.launches
        got = gqa_flash(q, k, v, causal=causal)  # model layout, read through strides
        assert flash_attention.launches == before + 1
        g = h // hkv
        want = attention_ref(q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(g, dim=1),
                             v.transpose(1, 2).repeat_interleave(g, dim=1), causal=causal).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_empty_batch_launches_nothing_on_card(card):
    q = torch.zeros((0, 4, 10, 16), device=card)
    before = flash_attention.launches
    y = flash_attention(q, q, q, causal=False)
    z = gqa_flash(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    assert flash_attention.launches == before
    assert y.shape == q.shape and z.shape == (0, 10, 4, 16)


@pytest.mark.cuda
def test_non_penetrative_plan_on_card_matches_single_device(card):
    """Every dense conv of the smoke VGG under filter splits: the executor
    hands K1 contiguous copies of the non-contiguous HWIO slices (the kernel
    takes dense weights only), and the features equal the single-device ones."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    params = vgg.init(gen, vgg.SMOKE)
    x = torch.randn((2, 64, 64, 3), generator=gen, device="cuda")
    w = params["features"][0]["w"]
    with pytest.raises(ValueError, match="contiguous"):
        conv2d_cuda(x, w[..., 2:5], None)
    net = vgg.SMOKE.geom()
    plan = partition.plan_from_scheme_layout(partition.scheme_layout(
        net, ("e1", "e2", "e3"), ratios=(0.5, 0.3, 0.2),
        assignment=(partition.SCHEME_NP,) * len(partition.stage_spans(net))))
    before = conv2d_cuda.launches
    got = run_plan(plan, params["features"], vgg.apply_layer, x)
    assert conv2d_cuda.launches - before == 3 * sum(g.kind == "conv" for g in net.layers)
    torch.testing.assert_close(got, vgg.features(params, vgg.SMOKE, x), rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_vit_scheme_plan_on_card_matches_single_device(card):
    """The smoke ViT under its baseline plan (head_sequence blocks): K3 once
    per head shard and K1 per conv slot, equal to the single-device forward."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    cfg = vit_spatial.SMOKE
    params = vit_spatial.init(gen, cfg)
    x = torch.randn((2, 64, 64, 3), generator=gen, device="cuda")
    plan = partition.plan_from_scheme_layout(partition.scheme_layout(
        cfg.geom(), ("e1", "e2", "e3"), ratios=(0.5, 0.3, 0.2)))
    before = flash_attention.launches
    got = run_plan(plan, params["features"], vit_spatial.apply_layer, x)
    assert flash_attention.launches - before == 3 * cfg.n_blocks
    torch.testing.assert_close(got, vit_spatial.features(params, cfg, x), rtol=2e-5, atol=2e-5)
