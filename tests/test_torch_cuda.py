"""Tests of the port that need the card (marker ``cuda``; they skip without
one).  They import neither JAX nor the JAX package, so they run on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 for float32 (the kernel and the plain version sum the same
products in another order; TF32 is off for the plain version's matmuls) and
2e-2 for bfloat16 (both round one float32 sum), as tests/test_kernels.py.
"""
import importlib.util
import time
from pathlib import Path

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


def chip_smoke():
    """The repo's ``chip_smoke.py`` as a module: its checks' helpers (it
    runs nothing on import)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

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
    out = serve("vgg16", n_requests=4, max_batch=2, device="cuda", seed=1, smoke=True)
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


# The vision models' K1 geometries at their full widths (batch 2): ConvNeXt's
# 7x7 depthwise with a bias, EfficientNet-B7's 3x3 / 5x5 depthwise at stride 1
# and 2 without one (up to 3840 channels), the k = s = 4 stems from 3
# channels and ConvNeXt's k = s = 2 downsamples: (N, H, W, Cin, Cout, k,
# stride, pad, groups, bias)
VISION_CONV_CASES = [
    (2, 56, 56, 128, 128, 7, 1, 3, 128, True),
    (2, 7, 7, 1024, 1024, 7, 1, 3, 1024, True),
    (2, 300, 300, 192, 192, 3, 2, 1, 192, False),
    (2, 38, 38, 1344, 1344, 5, 2, 2, 1344, False),
    (2, 19, 19, 3840, 3840, 3, 1, 1, 3840, False),
    (2, 224, 224, 3, 128, 4, 4, 0, 1, True),
    (2, 56, 56, 128, 256, 2, 2, 0, 1, True),
    (2, 14, 14, 512, 1024, 2, 2, 0, 1, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", VISION_CONV_CASES, ids=lambda c: "x".join(map(str, c[:9])))
def test_conv2d_vision_shapes_match_plain_on_card(card, dtype, case):
    n, h, w, cin, cout, k, s, pad, g, has_bias = case
    rng = np.random.default_rng(sum(case[:9]))
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin), dtype=np.float32)).to(card, dtype)
    wts = torch.from_numpy((2.0 / (k * k * (1 if g > 1 else cin))) ** 0.5 * rng.standard_normal(
        (k, k, 1 if g > 1 else cin, cout), dtype=np.float32)).to(card, dtype)
    b = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32)).to(card, dtype) if has_bias else None
    before = conv2d_cuda.launches, conv2d_cuda.depthwise_launches
    got = conv2d_cuda(x, wts, b, stride=s, padding=pad, groups=g)
    assert (conv2d_cuda.launches, conv2d_cuda.depthwise_launches) == (before[0] + 1, before[1] + (g > 1))
    want = conv2d_ref(x, wts, b, stride=s, padding=pad, groups=g)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in VISION_CONV_CASES if c[8] > 1], ids=lambda c: "x".join(map(str, c[:9])))
def test_conv2d_depthwise_bfloat16_is_bit_equal_to_plain_on_card(card, case):
    """K1's depthwise branch in bfloat16 at the vision models' full widths:
    16-byte channel vectors, and the output equal to the plain version bit
    for bit (exact products, the same f32 sum order), also with inputs
    scaled by powers of two from 2^-8 to 2^8, where the f32 sums round."""
    n, h, w, cin, cout, k, s, pad, g, has_bias = case
    rng = np.random.default_rng(sum(case[:9]))
    x = rng.standard_normal((n, h, w, cin), dtype=np.float32) * np.exp2(rng.integers(-8, 9, (n, h, w, cin)))
    x = torch.from_numpy(x.astype(np.float32)).to(card, torch.bfloat16)
    wts = torch.from_numpy((2.0 / (k * k)) ** 0.5 * rng.standard_normal((k, k, 1, cout), dtype=np.float32))
    wts = wts.to(card, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32)).to(card, torch.bfloat16) if has_bias else None
    assert launch_config(x, wts, stride=s, padding=pad, groups=g)["depthwise"]["copies"] == "16-byte"
    got = conv2d_cuda(x, wts, b, stride=s, padding=pad, groups=g)
    assert torch.equal(got, conv2d_ref(x, wts, b, stride=s, padding=pad, groups=g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_flash_attention_vit_l16_shape_matches_plain_on_card(card, dtype):
    """ViT-L/16's attention: 16 heads over T = S = 197 tokens, D = 64, the
    slices of one [B, T, 3, H, D] projection, not causal."""
    rng = np.random.default_rng(12)
    qkv = torch.from_numpy(rng.standard_normal((4, 197, 3, 16, 64), dtype=np.float32)).to(card, dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=False)
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["vit-l16", "swin-b", "convnext-b", "efficientnet-b7"])
def test_served_vision_smoke_logits_on_card_match_cpu(card, arch):
    """Each vision arch's smoke configuration served on the card (K1, and K3
    for ViT) equals its forward on the CPU through the plain versions."""
    from repro_torch.configs import get

    out = serve(arch, n_requests=4, max_batch=2, device="cuda", seed=1, smoke=True)
    a = get(arch)
    params = tree_map(lambda t: t.cpu(), out["params"])
    want = a.module.apply(params, a.smoke_cfg, out["images"].cpu())
    got = out["logits"].cpu()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_conv2d_float32_sum_is_not_biased_toward_zero_on_card(card):
    """The tensor cores add to their accumulator truncating toward zero, so
    K1's 3xTF32 core sums each 8-deep K slice into a fresh partial.  On
    positive-mean inputs (K = 3 x 3 x 512) the signed error toward |y|, over
    sum |y|, stays below 1e-7: one partial per 32-deep stage gave 1.9e-7,
    the fresh partials 3.9e-8 (NVIDIA H100 80GB HBM3, 700 W)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand((4, 28, 28, 512), generator=g, device="cuda")
    w = 0.05 * torch.randn((3, 3, 512, 256), generator=g, device="cuda") + 0.01
    got, want = conv2d_cuda(x, w, None, stride=1, padding=1), conv2d_ref(x, w, None, stride=1, padding=1)
    d = (got - want).double()
    bias = ((d * want.sign()).sum() / want.abs().sum()).item()
    assert abs(bias) < 1e-7, bias
    torch.testing.assert_close(got, want, rtol=TOL[torch.float32], atol=TOL[torch.float32])


def _forced_shape(q, k, v, causal, shape):
    """K3 through ``flash_attention_fwd_shape`` (the C interface's call with
    the block shape given: 0 = 16x4, 1 = 32x4, 2 = 64x1), as the wrapper
    launches it."""
    import ctypes
    import math

    from repro_torch.kernels.attention import ops

    lib = ops._lib_for(q.shape[3], v.shape[3])
    fn = lib.flash_attention_fwd_shape
    fn.argtypes, fn.restype = list(lib.flash_attention_fwd.argtypes) + [ctypes.c_int], ctypes.c_int
    b, h, t, d = q.shape
    o = q.new_empty((b, h, t, v.shape[3]))
    strides = (ctypes.c_longlong * 12)(*[st for x in (q, k, v, o) for st in x.stride()[:3]])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), ops.DTYPE_CODES[q.dtype], b, h, k.shape[1],
             t, k.shape[2], d, v.shape[3], strides, 1.0 / math.sqrt(d), int(causal), q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream, shape)
    assert err == 0, lib.kernel_error_string(err)
    return o


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("d", [40, 72, 80, 160])
def test_flash_attention_diffusion_widths_match_plain_on_card(card, dtype, d):
    """K3 at the diffusion models' head widths (UNet-SD1.5: 40 / 80 / 160,
    DiT-XL/2: 72; 40 and 72 run QK^T over a padded last slice in bf16)
    against the plain version: the model layout's strides, T != S both ways
    (a cross-attention's 77 keys among them), causal and not, the launcher's
    pick and each block shape forced."""
    for seed, (b, h, t, s) in enumerate(((2, 8, 100, 77), (1, 4, 130, 260), (2, 4, 260, 33))):
        rng = np.random.default_rng(seed + d)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, d), dtype=np.float32)).to(card, dtype)
                   .transpose(1, 2) for n in (t, s, s))
        for causal in (False, True):
            want = attention_ref(q, k, v, causal=causal).float()
            before = flash_attention.launches
            got = [flash_attention(q, k, v, causal=causal)]
            assert flash_attention.launches == before + 1
            got += [_forced_shape(q, k, v, causal, shape) for shape in range(3)]
            for g in got:
                torch.testing.assert_close(g.float(), want, rtol=TOL[dtype], atol=TOL[dtype])


# (N, H, W, Cin, Cout, k, stride, pad, groups): a dense stride-1 conv (its
# input gradient is K1 on the flipped filter), a depthwise one (the same, on
# K1's depthwise branch), a strided one (the library's input gradient), and
# one of EfficientNet-B7's 1x1 convs at batch 64 (where cuDNN's own bfloat16
# weight gradient is far off: the library takes float32 copies)
GRAD_CONVS = [(2, 28, 28, 64, 96, 3, 1, 1, 1), (2, 28, 28, 96, 96, 5, 1, 2, 96), (2, 29, 29, 32, 64, 3, 2, 1, 1),
              (64, 28, 28, 80, 480, 1, 1, 0, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [(c, dt) for dt in (torch.float32, torch.bfloat16) for c in GRAD_CONVS],
                         ids=[f"{n}{dt}" for dt in ("", "-bfloat16") for n in ("dense", "depthwise", "strided", "pointwise")])
def test_conv2d_function_grads_match_plain_autograd_on_card(card, case, dtype):
    """K1's autograd Function in float32 (TF32 off) or bfloat16: dx, dW and
    db against autograd through the plain version in float32 on the card on
    the same values, within TOL x (1 + |g|) plus 2^-20 of each gradient's
    sum of |terms| (large sums cancel; in bfloat16 the plain version's own
    autograd rounds each tap's share of dx to bfloat16 and sums them so);
    dx at stride 1 launches K1 once in the backward; two backward runs are
    bit-identical (the library calls run deterministic)."""
    n, h, w, cin, cout, k, s, pad, g = case
    rng = np.random.default_rng(sum(case))

    def arr(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).to(card, dtype)

    x, wts, b = arr(n, h, w, cin), arr(k, k, 1 if g > 1 else cin, cout, scale=0.1), arr(cout)
    kw = dict(stride=s, padding=pad, groups=g)
    leaves = [t.float().detach().requires_grad_() for t in (x, wts, b)]
    y = conv2d_ref(*leaves, **kw)
    dy = arr(*y.shape)
    want = torch.autograd.grad(y, leaves, dy.float())
    abs_leaves = [t.float().abs().requires_grad_() for t in (x, wts, b)]
    sums = torch.autograd.grad(conv2d_ref(*abs_leaves, **kw), abs_leaves, dy.float().abs())
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (x, wts, b)]
        before = conv2d_cuda.launches, conv2d_cuda.backward_launches
        got = torch.autograd.grad(conv2d_cuda(*leaves, **kw), leaves, dy)
        torch.cuda.synchronize()
        assert conv2d_cuda.launches == before[0] + 1
        assert conv2d_cuda.backward_launches == before[1] + (s == 1)
        runs.append(got)
    for a, c in zip(*runs):
        assert torch.equal(a, c)
    for gt, wt, sm in zip(runs[0], want, sums):
        assert gt.dtype == dtype
        gt = gt.float()
        assert bool(((gt - wt).abs() <= TOL[dtype] * (1 + wt.abs()) + 2.0 ** -20 * sm).all())


@pytest.mark.cuda
def test_flash_attention_function_grads_match_plain_autograd_on_card(card):
    """K3's autograd Function at ViT-L/16's shape ([4, 16, 197, 64], the
    model layout's strides, not causal) and a causal GQA one: dq, dk, dv
    against autograd through the plain version on the card, float32, at
    2e-5 x (1 + |g|); two backward runs are bit-identical."""
    rng = np.random.default_rng(7)
    for (b, t, h, hkv, d, causal) in ((4, 197, 16, 16, 64, False), (2, 130, 8, 2, 128, True)):
        q, k, v = (torch.from_numpy(rng.standard_normal((b, t, n, d), dtype=np.float32)).to(card)
                   for n in (h, hkv, hkv))
        do = torch.from_numpy(rng.standard_normal((b, t, h, d), dtype=np.float32)).to(card)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        g = h // hkv
        qt, kt, vt = (x.transpose(1, 2) for x in leaves)
        ref = attention_ref(qt, kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1), causal=causal)
        want = torch.autograd.grad(ref.transpose(1, 2), leaves, do)
        runs = []
        for _ in range(2):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            before = flash_attention.launches
            if g > 1:
                out = gqa_flash(*leaves, causal=causal)
            else:
                out = flash_attention(*(x.transpose(1, 2) for x in leaves), causal=causal).transpose(1, 2)
            runs.append(torch.autograd.grad(out, leaves, do))
            assert flash_attention.launches == before + 1
        for a, c in zip(*runs):
            assert torch.equal(a, c)
        for gt, wt in zip(runs[0], want):
            torch.testing.assert_close(gt, wt, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,hkv,d,dv", [(1, 4096, 32, 8, 128, 128), (1, 512, 128, 128, 192, 128)],
                         ids=["qwen3-gqa-t4096", "mla-192-128"])
def test_flash_attention_function_at_lm_train_shapes_on_card(card, b, t, h, hkv, d, dv):
    """K3's autograd Function at the LM train cells' shapes, causal, float32:
    Qwen3-4B's [1, 32, 4096, 128] with 8 KV heads (``gqa_flash``: dk and dv
    summed over each KV head's 4 query heads) and DeepSeek-V3's MLA widths
    (192, 128) over 128 heads at 512 tokens.  o, dq, dk and dv against the
    plain version's autograd on the card within 2e-5 x (1 + |g|) plus 2^-20
    x the sum of the absolute terms (``attention_abs_sums``: 4096-term sums
    cancel); one K3 launch."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((b, t, h, d), dtype=np.float32)).to(card)
    k = torch.from_numpy(rng.standard_normal((b, t, hkv, d), dtype=np.float32)).to(card)
    v = torch.from_numpy(rng.standard_normal((b, t, hkv, dv), dtype=np.float32)).to(card)
    do = torch.from_numpy(rng.standard_normal((b, t, h, dv), dtype=np.float32)).to(card)
    g = h // hkv
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    qt, kt, vt = (x.transpose(1, 2) for x in leaves)
    ref = attention_ref(qt, kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1), causal=True).transpose(1, 2)
    want = [ref.detach(), *torch.autograd.grad(ref, leaves, do)]
    del ref
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = flash_attention.launches
    out = gqa_flash(*leaves, causal=True)
    got = [out.detach(), *torch.autograd.grad(out, leaves, do)]
    assert flash_attention.launches == before + 1
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sums = chip_smoke().attention_abs_sums(torch, qt, kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1),
                                           do.transpose(1, 2))
    o_s, dq_s, dk_s, dv_s = (x.transpose(1, 2) for x in sums)
    fold = lambda x: x.reshape(b, t, hkv, g, -1).sum(3)  # noqa: E731 -- a KV head's query heads
    for name, gt, wt, sm in zip(("o", "dq", "dk", "dv"), got, want, (o_s, dq_s, fold(dk_s), fold(dv_s))):
        limit = 2e-5 * (1 + wt.abs()) + 2.0 ** -20 * sm
        assert bool(((gt - wt).abs() <= limit).all()), (name, ((gt - wt).abs() / limit).max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout", [(4, 16, 1280, 1280), (4, 32, 320, 320), (4, 8, 1280, 1280)],
                         ids=["unet-l2", "unet-l0", "unet-mid"])
def test_conv2d_function_weight_gradient_is_within_float32_rounding_on_card(card, n, h, cin, cout):
    """K1's Function's weight gradient at the U-Net's 3x3 stride-1 widths,
    float32, against the same gradient in float64: within 2^-20 x the sum of
    the absolute terms.  (cuDNN's deterministic weight gradient, a Winograd
    transform for these convs, missed this by 1.6-3.3x on the H100.)"""
    import torch.nn.functional as F

    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((n, h, h, cin), generator=g, device=card)
    w = (2.0 / (9 * cin)) ** 0.5 * torch.randn((3, 3, cin, cout), generator=g, device=card)
    dy = torch.randn((n, h, h, cout), generator=g, device=card)
    wl = w.clone().requires_grad_()
    got = torch.autograd.grad(conv2d_cuda(x.requires_grad_(), wl, None, padding=1), wl, dy)[0]

    def dw64(x, dy):
        wd = w.double().permute(3, 2, 0, 1).requires_grad_()
        y = F.conv2d(x.double().permute(0, 3, 1, 2), wd, padding=1)
        return torch.autograd.grad(y, wd, dy.double().permute(0, 3, 1, 2))[0].permute(2, 3, 1, 0)

    want, sums = dw64(x, dy), dw64(x.abs(), dy.abs())
    err = (got.double() - want).abs()
    assert bool((err <= 2.0 ** -20 * sums).all()), (err / (2.0 ** -20 * sums)).max().item()
