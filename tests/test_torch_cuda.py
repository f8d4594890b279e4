"""Tests of the port that need the card (marker ``cuda``; they skip without
one).  They import neither JAX nor the JAX package, so they run on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 for float32 (the kernel and the plain version sum the same
products in another order; TF32 is off for the plain version's matmuls) and
2e-2 for bfloat16 (both round one float32 sum), as tests/test_kernels.py.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import partition, plan_even
from repro_torch.kernels.attention import attention_ref, flash_attention, gqa_flash
from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref
from repro_torch.kernels.conv2d.ops import launch_config
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


def _int_view(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "x".join(map(str, c[:6])) + ("-causal" if c[6] else ""))
def test_flash_attention_repeats_bitwise_on_card(card, dtype, case):
    """Two calls on the same inputs give the same bits: the key split is a
    pure function of the shape and its partial softmaxes merge in a fixed
    order, with no atomics."""
    b, h, hkv, t, s, d, causal = case
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, heads, d), dtype=np.float32)).to(card, dtype)
               for n, heads in ((t, h), (s, hkv), (s, hkv)))
    got = gqa_flash(q, k, v, causal=causal)
    again = gqa_flash(q, k, v, causal=causal)
    assert torch.equal(_int_view(got), _int_view(again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_flash_attention_head_shards_match_full_call_on_card(card, dtype):
    """The ViT's head_sequence shards: 8, 5 and 3 of 16 heads over the 14x14
    grid (batch 4, D = 64), each a column slice of the [B, T, 16*D]
    projections, agree with one 16-head call on the same q, k, v within
    TOL * (1 + |y|): the launcher may pick another block shape for each grid,
    so the sums run in other orders (float32: 2e-5; bfloat16: one rounding of
    the output, 2e-2)."""
    b, t, heads, d = 4, 196, 16, 64
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, heads * d), dtype=np.float32)).to(card, dtype)
               .view(b, t, heads, d) for _ in range(3))
    full = gqa_flash(q, k, v, causal=False)
    parts, lo = [], 0
    for n in (8, 5, 3):
        parts.append(gqa_flash(q[:, :, lo:lo + n], k[:, :, lo:lo + n], v[:, :, lo:lo + n], causal=False))
        lo += n
    got, want = torch.cat(parts, dim=2).float(), full.float()
    assert bool(((got - want).abs() <= TOL[dtype] * (1 + want.abs())).all())


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


# (N, H, W, Cin, Cout, k): thin grids that split K -- a 1-row fix-up conv of
# conv5 (M = 56, K = 4608, Cout = 512) and the ViT's row-split MLP-down conv
# (M = 392, K = 4096, Cout = 1024)
SPLIT_CASES = [(4, 3, 16, 512, 512, 3), (4, 7, 14, 4096, 1024, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_split_k_kernel_matches_plain_and_repeats_on_card(card, dtype):
    """Thin shapes take split-K (S > 1): the kernel agrees with its plain
    version, and two calls give byte-identical outputs (fixed split count,
    partials summed in a fixed order, no atomics)."""
    for seed, (n, h, w, cin, cout, k) in enumerate(SPLIT_CASES):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal((n, h, w, cin), dtype=np.float32)).to(card, dtype)
        wts = torch.from_numpy((1 / np.sqrt(k * k * cin)) * rng.standard_normal(
            (k, k, cin, cout), dtype=np.float32)).to(card, dtype)
        b = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32)).to(card, dtype)
        config = launch_config(x, wts, padding=0)
        assert config["splits"] > 1 and config["gather"] == "a16/b16", config
        got = conv2d_cuda(x, wts, b, padding=0)
        again = conv2d_cuda(x, wts, b, padding=0)
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           again.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
        want = conv2d_ref(x, wts, b, padding=0)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_spatial_forward_with_other_split_counts_on_card(card):
    """Full-width VGG blocks (64 and 128 channels) over 4 weighted shards:
    a shard's K2 call and the single-device K1 call of a layer take
    different split counts, so they sum in other orders; the features still
    agree within 2e-5 * (1 + |y|)."""
    cfg = vgg.VGGConfig(img_res=64, width_mult=1.0, num_classes=10, blocks=((1, 64), (2, 128)))
    gen = torch.Generator(device="cuda").manual_seed(6)
    params = vgg.init(gen, cfg)
    x = torch.randn((2, 64, 64, 3), generator=gen, device="cuda")
    net = cfg.geom()
    comm = make_spatial_comm(4, device="cuda")
    plan = plan_even(net, 4, ratios=(1.0, 0.55, 0.35, 0.8))
    xs, heights = weighted_spatial_inputs(x, plan, comm, align=spatial_alignment(net))
    # conv2_2 (Cin 128 on the 32x32 map): the full map and the shards (each
    # asked for the tallest shard's rows) differ
    wts = [layer for layer in params["features"] if "w" in layer][-1]["w"]
    full = launch_config(torch.empty((2, 32, 32, 128), device=card), wts)["splits"]
    shard = launch_config(torch.empty((2, max(heights) // 2, 32, 128), device=card), wts)["splits"]
    assert full != shard, (full, shard)
    ys = features_spatial(params["features"], net, xs, comm=comm, heights=heights, engine="fused")
    got = merge_padded_shards(ys, [h // spatial_alignment(net) for h in heights])
    want = vgg.features(params, cfg, x)
    assert bool(((got - want).abs() <= 2e-5 * (1 + want.abs())).all())


# (B, H, Hkv, T, S, D, causal, cache slots): Qwen3-4B's two K3 shapes in
# chip_smoke.py's phase 3c -- the causal prefill of 512 tokens, and a decode
# step's one query over the first 64 keys of a 512-slot KV cache (a view)
LM_ATTN_CASES = [
    (4, 32, 8, 512, 512, 128, True, None),
    (4, 32, 8, 1, 64, 128, False, 512),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", LM_ATTN_CASES, ids=["prefill", "decode"])
def test_flash_attention_lm_shapes_match_plain_on_card(card, dtype, case):
    b, h, hkv, t, s, d, causal, slots = case
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.standard_normal((b, t, h, d), dtype=np.float32)).to(card, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((b, slots or s, hkv, d), dtype=np.float32)).to(card, dtype)
            [:, :s] for _ in range(2))
    got = gqa_flash(q, k, v, causal=causal)
    g = h // hkv
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(g, dim=1),
                         v.transpose(1, 2).repeat_interleave(g, dim=1), causal=causal).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_gqa_decode_step_matches_plain_sdpa_on_card(card):
    """Six decode steps of one GQA layer (8 query heads over 2 KV heads, D =
    128, qk-norm): the kernel's call over the cache's prefix view gives what
    JAX's plain ``_sdpa`` under ``decode_mask`` gives over the whole cache."""
    from repro_torch.models import attention

    cfg = attention.GQAConfig(d_model=256, n_heads=8, n_kv_heads=2, d_head=128, qk_norm=True)
    gen = torch.Generator(device="cuda").manual_seed(14)
    p = attention.gqa_init(gen, cfg)
    x = torch.randn((2, 6, cfg.d_model), generator=gen, device=card)
    k_cache, v_cache = (torch.zeros((2, 16, 2, 128), device=card) for _ in range(2))
    calls = []

    def recording(q, k, v, *, causal):
        calls.append((q, k, v, causal, gqa_flash(q, k, v, causal=causal)))
        return calls[-1][-1]

    attention.gqa_flash = recording
    try:
        for i in range(6):
            before = flash_attention.launches
            attention.gqa_apply(p, cfg, x[:, i:i + 1], torch.full((2, 1), i, device=card),
                                (k_cache, v_cache), i)
            assert flash_attention.launches == before + 1
            q, k, v, causal, got = calls[-1]
            assert not causal and k.shape[1] == i + 1 and k.data_ptr() == k_cache.data_ptr()
            want = attention._sdpa(q, k_cache, v_cache, attention.decode_mask(16, i, card), 128 ** -0.5)
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    finally:
        attention.gqa_flash = gqa_flash


@pytest.mark.cuda
def test_lm_decode_matches_forward_on_card(card):
    """Two GQA layers at D = 128: 8 decode steps (one K3 call per layer and
    step, over the cache's prefix) give the causal prefill's logits at each
    position, within 1e-4 of the largest |logit| (float32, the two paths sum
    in other orders)."""
    from repro_torch.models import transformer_lm as lm

    cfg = lm.LMConfig(name="gqa-d128", n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_head=128,
                      d_ff=256, vocab=512, qk_norm=True)
    gen = torch.Generator(device="cuda").manual_seed(15)
    params = lm.init(gen, cfg)
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=gen, device=card, dtype=torch.int32)
    full, _ = lm.forward(params, cfg, toks)
    cache = lm.init_cache(cfg, 2, 16, device=card)
    for i in range(8):
        before = flash_attention.launches
        got, cache = lm.decode_step(params, cfg, cache, toks[:, i:i + 1], i)
        assert flash_attention.launches == before + cfg.n_layers
        assert (got - full[:, i]).abs().max() <= 1e-4 * full.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("t,capacity_factor", [(24, 1.25), (320, 1.0)], ids=["dropless", "drop"])
def test_moe_apply_on_card_matches_cpu(card, t, capacity_factor):
    """The MoE layer on the card (sort, search, scatter and gather on the
    device, the expert products in cuBLAS) against the same call on the CPU,
    float32: equal routes (ids, positions, keep) and y within 2e-5.  Above
    ``dropless_below`` (T = 320) pairs past an expert's capacity drop."""
    from repro_torch.models import moe

    cfg = moe.MoEConfig(d_model=64, n_experts=8, top_k=2, d_ff=96, n_shared=1, router_bias=True,
                        capacity_factor=capacity_factor)
    gen = torch.Generator(device="cuda").manual_seed(16)
    p = moe.moe_init(gen, cfg)
    # a router at std 1/sqrt(D) and a bias, so that routing is decided by the input
    p["router"]["w"] = torch.randn((64, 8), generator=gen, device=card) / 8
    p["router_b"] = 0.1 * torch.randn((8,), generator=gen, device=card)
    x = torch.randn((t, 64), generator=gen, device=card)
    cpu_p = tree_map(lambda a: a.cpu(), p)
    got, aux = moe.moe_apply(p, cfg, x)
    want, want_aux = moe.moe_apply(cpu_p, cfg, x.cpu())
    _, ids, _ = moe.router_topk(p, cfg, x)
    _, want_ids, _ = moe.router_topk(cpu_p, cfg, x.cpu())
    capacity = t if t <= cfg.dropless_below else int(capacity_factor * t * 2 / 8)  # as moe_apply
    for g, w in zip(moe._dispatch(ids, 8, capacity), moe._dispatch(want_ids, 8, capacity)):
        assert torch.equal(g.cpu(), w)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    for key in ("load_balance_loss", "dropped_frac"):
        torch.testing.assert_close(aux[key].cpu(), want_aux[key], rtol=2e-5, atol=2e-5)
    assert (float(want_aux["dropped_frac"]) > 0) == (t > cfg.dropless_below)


@pytest.mark.cuda
def test_mla_apply_on_card_matches_cpu(card):
    """MLA at DeepSeek-V3's head widths (K3's (192, 128) pair: 128 no-RoPE +
    64 RoPE query/key dims, value 128, the value a strided view of the
    expansion) on the card against the same call on the CPU, float32: a
    causal prefill of 40 tokens (one K3 launch), then 6 decode steps over
    the latent cache (one launch each), each step also against the prefill
    at its position."""
    from repro_torch.models import attention

    cfg = attention.MLAConfig(d_model=256, n_heads=8, q_lora_rank=64, kv_lora_rank=32)
    gen = torch.Generator(device="cuda").manual_seed(17)
    p = attention.mla_init(gen, cfg)
    cpu_p = tree_map(lambda a: a.cpu(), p)
    x = torch.randn((2, 40, cfg.d_model), generator=gen, device=card)
    pos = torch.arange(40, device=card).expand(2, 40)
    before = flash_attention.launches
    got, _ = attention.mla_apply(p, cfg, x, pos)
    assert flash_attention.launches == before + 1
    want, _ = attention.mla_apply(cpu_p, cfg, x.cpu(), pos.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    cache = torch.zeros((2, 16, cfg.kv_lora_rank + cfg.qk_rope_head_dim), device=card)
    cpu_cache = cache.cpu()
    for i in range(6):
        before = flash_attention.launches
        step, _ = attention.mla_apply(p, cfg, x[:, i:i + 1], pos[:, i:i + 1], cache, i)
        assert flash_attention.launches == before + 1
        want_step, _ = attention.mla_apply(cpu_p, cfg, x[:, i:i + 1].cpu(), pos[:, i:i + 1].cpu(), cpu_cache, i)
        torch.testing.assert_close(step.cpu(), want_step, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(cache.cpu(), cpu_cache, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(step[:, 0], got[:, i], rtol=2e-5, atol=2e-5)


# geometries of the analysers' probe (k, s, p, groups, c_in, c_out, hs, w):
# VGG's 3x3 rows, a stride-2 shard, a 1x1, a depthwise 5x5 and a ragged one
PROBE_GEOMETRIES = [(3, 1, 1, 1, 64, 64, 37, 224), (3, 2, 1, 1, 32, 64, 10, 31), (1, 1, 0, 1, 16, 8, 3, 9),
                    (5, 1, 2, 24, 24, 24, 7, 20), (3, 1, 1, 1, 3, 64, 1, 224)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", PROBE_GEOMETRIES, ids=lambda g: "k{}s{}p{}g{}c{}-{}hs{}w{}".format(*g))
def test_halo_conv_probe_agrees_with_a_launch_on_card(card, geom):
    """The shape probe of ``analysis.kernel_check`` (the wrapper's argument
    check on ``meta`` tensors) predicts the shape of a real K2 launch at the
    same geometry, and the launch agrees with the plain version."""
    from repro_torch.analysis import check_kernel_geometry
    from repro_torch.analysis.kernel_check import geometry_shapes
    from repro_torch.kernels.halo_conv.ops import probe

    k, s, p, groups, cin, cout, hs, w = geom
    assert check_kernel_geometry(k, s, p, groups=groups, c_in=cin, c_out=cout, hs=hs, w=w, batch=2).ok
    shapes = geometry_shapes(k, s, p, groups=groups, c_in=cin, c_out=cout, hs=hs, w=w, batch=2)
    rng = np.random.default_rng(sum(geom))
    ops = {n: None if v is None else torch.from_numpy(rng.standard_normal(v, dtype=np.float32)).to(card)
           for n, v in shapes.items() if n != "out"}
    # fan-in scaled, |y| ~ 1, as phase 3b's holds.  With unit weights |y| reaches 117, and
    # float32 rounding alone (K2's and the plain version's, each within 2 u x sum |x||w| of
    # float64) puts a few elements near y = 0 past 2e-5 x (1 + |y|): tools/k2_rounding.py
    ops["weights"] *= (2.0 / (k * k * shapes["weights"][2])) ** 0.5
    meta = {n: None if v is None else v.to("meta") for n, v in ops.items()}
    kw = dict(stride=s, padding=p, groups=groups)
    want_shape = probe(meta["x"], meta["top"], meta["bottom"], meta["weights"], **kw)
    before = halo_conv2d_cuda.launches
    y = halo_conv2d_cuda(ops["x"], ops["top"], ops["bottom"], ops["weights"], **kw)
    assert halo_conv2d_cuda.launches == before + 1
    assert tuple(y.shape) == want_shape == shapes["out"]
    ref = halo_conv2d_ref(ops["x"], ops["top"], ops["bottom"], ops["weights"], None, **kw)
    assert bool(((y - ref).abs() <= TOL[torch.float32] * (1 + ref.abs())).all())


@pytest.mark.cuda
def test_run_plan_verify_launches_nothing_for_a_corrupt_plan_on_card(card):
    """``run_plan(verify=True)`` refuses the row-gap plan of the analysers'
    tests before any kernel starts, and passes a valid plan."""
    from repro_torch.analysis import AnalysisError

    gen = torch.Generator(device="cuda").manual_seed(6)
    params = vgg.init(gen, vgg.SMOKE)
    x = torch.randn((2, 64, 64, 3), generator=gen, device="cuda")
    plan = partition.plan_halp(vgg.SMOKE.geom(), overlap_rows=4)
    slot = next(s for s in plan.es_names if plan.parts[0].out[s])
    seg = plan.parts[0].out[slot]
    part = plan.parts[0]
    bad_part = type(part)(index=0, out=dict(part.out, **{slot: partition.Segment(seg.lo + 1, seg.hi)}),
                          inp=part.inp)
    bad = type(plan)(net=plan.net, parts=(bad_part,) + plan.parts[1:], es_names=plan.es_names,
                     host=plan.host, slot_owner=plan.slot_owner)
    before = (conv2d_cuda.launches, halo_conv2d_cuda.launches)
    with pytest.raises(AnalysisError, match="plan.coverage"):
        run_plan(bad, params["features"], vgg.apply_layer, x, verify=True)
    torch.cuda.synchronize()
    assert (conv2d_cuda.launches, halo_conv2d_cuda.launches) == before
    got = run_plan(plan, params["features"], vgg.apply_layer, x, verify=True)
    assert conv2d_cuda.launches > before[0]
    torch.testing.assert_close(got, vgg.features(params, vgg.SMOKE, x), rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_run_plan_first_slot_sample_excludes_queued_work_on_card(card):
    """``run_plan(time_observer=...)`` synchronises before its first slot:
    a large matmul queued just before the call does not land in the first
    ES's sample."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = vgg.init(gen, vgg.SMOKE)
    x = torch.randn((1, 64, 64, 3), generator=gen, device="cuda")
    plan = partition.plan_halp(vgg.SMOKE.geom(), overlap_rows=4)
    first = next(es for es in plan.es_names if plan.parts[0].out[es])
    a = torch.randn((8192, 8192), generator=gen, device="cuda")
    run_plan(plan, params["features"], vgg.apply_layer, x)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        a @ a
    torch.cuda.synchronize()
    queued_s = time.perf_counter() - t0
    samples = {}
    for _ in range(4):
        a @ a
    out = run_plan(plan, params["features"], vgg.apply_layer, x,
                   time_observer=lambda es, fl, dt: samples.setdefault(es, dt))
    want = run_plan(plan, params["features"], vgg.apply_layer, x)
    assert torch.equal(out, want)
    assert samples[first] < queued_s / 2, (samples, queued_s)
