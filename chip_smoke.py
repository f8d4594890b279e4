#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. needs CUDA; prints the card's name and power limit;
2. builds every CUDA source of ``src/repro_torch`` (``nvcc``, sm_90a);
3. holds the direct-conv kernel (K1's port) against its plain PyTorch version
   on the card, at every conv shape the served plan, the weighted spatial
   layout's fix-up convs (phase 5) and the two scheme plans of phase 6 hand
   it (the ViT's 16x16/s16 patch-embed slots and row-split 1x1 convs, VGG's
   filter slices) plus a strided, a depthwise and a strided-view case, in
   float32 (TF32 off) and bfloat16,
   timing the kernel, the plain version and ``F.conv2d`` (a yardstick the
   port never calls) beside the least time the card could take;
4. serves full-width VGG-16 (224x224, width 1.0, 1000 classes, seeded random
   weights) through ``plan_halp(overlap_rows=4)`` and the port's
   ``BatchingEngine``, counts the kernel's launches in that run, and checks
   the logits: finite, lossless against the single-device forward through
   the same kernel, and equal within float32 summation-order error to the
   single-device forward through the plain conv on the CPU; then times
   steady-state forwards of one batch and profiles one for the device's busy
   time by kernel.

3b. holds the halo-conv kernel (K2's port) against its plain version on the
   card at every shape the spatial path (phase 5) hands it, plus stride 2,
   k7 s2, depthwise k7, row-slice-view halos and a ragged shard, in float32
   and bfloat16, timing it beside its plain version, ``F.conv2d`` on the
   concatenated slab (a yardstick the port never calls) and its bound;
5. runs full-width VGG-16 (batch 4, phase 4's weights and images) through
   the spatial engine with the fused engine on one card, in two layouts:
   (a) capacity-weighted, 4 shards of (96, 32, 32, 64) rows from
   ``plan_even(ratios=(1.0, 0.55, 0.35, 0.8))``, and (b) equal, 7 shards of
   32 rows; counts both kernels' launches in one forward of each, checks the
   logits against the single-device forward and the plain conv on the CPU,
   then times steady forwards and profiles one of each.

3c. holds the flash-attention kernel (K3's port) against its plain version on
   the card at every attention shape phase 6's ViT forward hands it (heads
   8 / 5 / 3 of 16 over the 14x14 token grid, read through the model layout's
   strides, non-causal) plus causal T = S = 256, top-left causal T = 128 with
   S = 256 and with S = 64, and GQA (16 query heads over 4 KV heads, D = 128),
   in float32 and bfloat16, timing it beside its plain version,
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls) and
   its bound;
6. (a) runs full-width ViT-L/16 (224x224, patch 16, 24 blocks, d 1024, 16
   heads, seeded random weights, batch 4) through ``plan_scheme`` on a
   topology of three secondaries with capacities 5:3:2 (halo_segment for the
   patch conv, head_sequence for every block), counts K1's and K3's launches
   in one forward against the plan's, checks the logits (finite, not all
   zero, lossless against the single-device forward through the same
   kernels, within ``DEPTH_RTOL`` of the plain versions' forward on the CPU),
   then times steady forwards and profiles one; (b) runs full-width VGG-16
   (phase 4's weights and images) under a plan that gives non_penetrative to
   every stage with the same ratios, lossless against the single-device
   forward: K1 then takes contiguous copies of the filter slices.

The last two lines of standard output are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``; the per-shape table is also written to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense: float32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12

N_REQUESTS = 16
MAX_BATCH = 4
# |kernel - plain| <= TOL * (1 + |plain|) per element: the _tol values of
# tests/test_kernels.py.  float32: the two sum the same products in another
# order; bfloat16: both round one float32 sum, which may land one bf16 step
# apart (2^-8 relative).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# logits through the kernel vs the plain conv on the CPU, relative to the
# largest |logit|: float32 summation order compounds over 13 convs (K up to
# 4608) and 3 dense layers (K up to 25088).
DEPTH_RTOL = 1e-4

# Phase 5's layouts of full-width VGG-16 over height shards of one card:
# (a) capacity-weighted from plan_even(ratios=...), re-quantised to the
# stride alignment 32; (b) the one equal split of 224 rows into shards of 32.
WEIGHTED_RATIOS = (1.0, 0.55, 0.35, 0.8)
WEIGHTED_HEIGHTS = (96, 32, 32, 64)
EQUAL_HEIGHTS = (32,) * 7


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def conv_shapes(plan, batch: int) -> Counter:
    """(N, H, W, Cin, Cout, k, stride) of every conv call one forward of a
    HALP plan makes: each non-empty slot of each conv layer gets its
    receptive-field rows plus the zero padding, and runs the kernel VALID."""
    net = plan.net
    sizes = net.sizes()
    shapes: Counter = Counter()
    for i, g in enumerate(net.layers):
        if g.kind != "conv":
            continue
        for es in plan.es_names:
            seg = plan.parts[i].out[es]
            if seg:
                rows = (seg.hi - seg.lo) * g.s + g.k  # raw input range, padding included
                shapes[(batch, rows, sizes[i] + 2 * g.p, g.c_in, g.c_out, g.k, g.s)] += 1
    return shapes


def scheme_calls(plan, batch: int) -> tuple[Counter, Counter]:
    """The kernel calls one forward of a mixed-scheme plan of halo_segment,
    non_penetrative and head_sequence segments makes, as ``run_plan`` issues
    them: K1 calls keyed (N, H, W, Cin, Cout, k, stride), run VALID, and K3
    calls keyed (B, H, T, S, D).  Halo segments are HALP plans over their
    sub-net; a non_penetrative conv takes the whole padded map and a slice of
    the filters; head_sequence splits an attention layer's heads and a
    pointwise conv's output rows."""
    from repro_torch.core.partition import SCHEME_HALO, SCHEME_HS, SCHEME_NP, _split_counts

    net = plan.net
    sizes = net.sizes()
    convs: Counter = Counter()
    attns: Counter = Counter()
    for seg, hp in zip(plan.segments, plan.halo_plans):
        check(seg.scheme in (SCHEME_HALO, SCHEME_NP, SCHEME_HS), f"no call count for {seg.scheme}")
        if seg.scheme == SCHEME_HALO:
            convs.update(conv_shapes(hp, batch))
            continue
        for i in range(seg.start, seg.stop + 1):
            g = net.layers[i]
            full = sizes[i] + 2 * g.p
            if g.kind == "attn":  # head_sequence: every head attends over all tokens
                t = sizes[i] * sizes[i]
                for heads in filter(None, _split_counts(g.heads, plan.ratios)):
                    attns[(batch, heads, t, t, g.c_in // g.heads)] += 1
            elif g.kind != "conv":
                continue  # pools run no kernel
            elif seg.scheme == SCHEME_HS:  # token rows of a pointwise conv
                for rows in filter(None, _split_counts(sizes[i + 1], plan.ratios)):
                    convs[(batch, rows, full, g.c_in, g.c_out, g.k, g.s)] += 1
            else:  # non_penetrative: the whole map, a slice of the filters
                for cout in filter(None, _split_counts(g.c_out, plan.ratios)):
                    convs[(batch, full, full, g.c_in, cout, g.k, g.s)] += 1
    return convs, attns


def spatial_calls(net, heights, batch: int, weighted: bool) -> list[dict]:
    """Every kernel call one forward of the fused spatial engine makes over
    ``len(heights)`` shards: per conv layer and shard one K2 call on the
    shard's block ([batch, block rows, W, Cin], halos of lo / hi rows) and,
    in the weighted layout, one K1 fix-up conv on a slab of
    n_fix*s + lo + hi rows, width-padded, run VALID."""
    sizes = net.sizes()
    hmax, n = max(heights), len(heights)
    calls = []
    for i, g in enumerate(net.layers):
        if g.kind == "conv":
            lo, hi = g.p, g.k - g.p - g.s
            w = sizes[i]
            calls.append(dict(kernel="halo_conv2d", layer=g.name, per_forward=n,
                              shape=(batch, hmax, w, g.c_in, g.c_out), k=g.k, stride=g.s,
                              pad=g.p, lo=lo, hi=hi, bottom="absent" if weighted else "view",
                              valid_rows=sum(heights) // g.s, groups=1))
            if weighted and hi:
                n_fix = -(-hi // g.s)
                check(min(heights) >= n_fix * g.s + lo, f"{g.name} would not take the fix-up branch")
                calls.append(dict(kernel="conv2d", layer=g.name, per_forward=n,
                                  shape=(batch, n_fix * g.s + lo + hi, w + 2 * g.p, g.c_in, g.c_out),
                                  k=g.k, stride=g.s, pad=0, groups=1))
        hmax //= g.s
        heights = [h // g.s for h in heights]
    return calls


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, float]:
    """(ms the operations need at the peak rate of ``dtype``, ms the bytes
    need at the HBM rate); the bound is the larger."""
    return flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3


def steady_and_profiled(torch, forward, label: str) -> tuple[float, float, list]:
    """Mean host-clock ms of 5 steady calls of ``forward`` (after one warm
    call), then one call under the profiler: (ms, device busy ms, the top
    device rows).  Prints both."""
    forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        forward()
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / 5 * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        forward()
        torch.cuda.synchronize()
    # device-side rows only (kernels, copies): operator rows repeat their kernels' time
    by_kernel = sorted((a for a in prof.key_averages()
                        if a.device_type == torch.autograd.DeviceType.CUDA),
                       key=lambda a: -a.self_device_time_total)
    busy_ms = sum(a.self_device_time_total for a in by_kernel) / 1e3
    top = [dict(name=a.key, ms=a.self_device_time_total / 1e3, count=a.count)
           for a in by_kernel[:8] if a.self_device_time_total > 0]
    busy = (f"device busy in one profiled forward: {busy_ms:.3f} ms (idle share "
            f"{1 - busy_ms / fwd_ms:.3f} of the steady forward)" if busy_ms > 0
            else "the profiler traced no device time: idle share not measured")
    print(f"{label}: steady forward of one batch of {MAX_BATCH} (host clock, 5 runs): "
          f"{fwd_ms:.3f} ms; {busy}")
    for t in top:
        print(f"  {t['ms']:.3f} ms x{t['count']}  {t['name'][:90]}")
    return fwd_ms, busy_ms, top


def hold_halo_conv(torch, F, gen, case: dict) -> dict:
    """One K2 shape on the card, float32 (TF32 off) and bfloat16: the kernel
    against its plain version (an error beyond TOL is fatal), then the mean
    times of the kernel, the plain version and F.conv2d on the concatenated
    slab, beside the bound.  Returns the float32 row, with the bfloat16
    error and time in it."""
    from repro_torch.kernels.halo_conv import halo_conv2d_cuda, halo_conv2d_ref

    n, hs, w, cin, cout = case["shape"]
    k, s, p, lo, hi, groups = (case[key] for key in ("k", "stride", "pad", "lo", "hi", "groups"))
    w_cin = 1 if groups > 1 else cin
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).removeprefix("torch.")
        # the shard and its neighbours; the halos are row-slice views of them
        x, above, below = (torch.randn((n, hs, w, cin), generator=gen, device="cuda").to(dt)
                           for _ in range(3))
        top = above[:, hs - lo:] if lo else None
        bot = below[:, :hi] if hi else None
        absent = case["bottom"] == "absent" and hi
        if absent:  # the weighted layout's zero bottom, never materialised
            bot = None
        wt = (math.sqrt(2.0 / (k * k * w_cin))
              * torch.randn((k, k, w_cin, cout), generator=gen, device="cuda")).to(dt)
        b = (0.1 * torch.randn((cout,), generator=gen, device="cuda")).to(dt)
        kw = dict(stride=s, padding=p, groups=groups, hi=hi)
        got = halo_conv2d_cuda(x, top, bot, wt, b, **kw)
        ref_bot = torch.zeros((n, hi, w, cin), dtype=dt, device="cuda") if absent else bot
        slab = torch.cat([q for q in (top, x, ref_bot) if q is not None], dim=1)
        want = halo_conv2d_ref(x, top, ref_bot, wt, b, stride=s, padding=p, groups=groups)
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        check(torch.isfinite(got.float()).all().item(), f"non-finite halo-conv output at {case}")
        check(bool((diff <= TOL[dname] * (1 + want.float().abs())).all()),
              f"halo conv disagrees with its plain version ({dname}, max err {err}): {case}")
        sn, wn = slab.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)  # NCHW / OIHW views
        t_kernel = time_ms(torch, lambda: halo_conv2d_cuda(x, top, bot, wt, b, **kw))
        t_plain = time_ms(torch, lambda: halo_conv2d_ref(x, top, ref_bot, wt, b, stride=s,
                                                         padding=p, groups=groups))
        t_lib = time_ms(torch, lambda: F.conv2d(sn, wn, b, stride=s, padding=(0, p), groups=groups))
        flops = 2.0 * k * k * w_cin * cout * n * got.shape[1] * got.shape[2]
        read = x.numel() + sum(q.numel() for q in (top, bot) if q is not None)
        nbytes = (read + wt.numel() + b.numel() + got.numel()) * x.element_size()
        ops_ms, bytes_ms = bound_ms(flops, nbytes, dname)
        t_bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"halo {dname:8s} {case.get('layer', '-')} {case['layout'] or 'extra'} "
              f"x{[n, hs, w, cin]} -> {cout} k{k} s{s} p{p} g{groups} lo{lo} hi{hi}"
              f"{' bottom-absent' if absent else ''} x{case['per_forward']}/fwd: max_err {err:.3g} "
              f"kernel {t_kernel:.4f} ms ({flops / t_kernel / 1e9:.1f} TFLOP/s) plain {t_plain:.4f} ms "
              f"F.conv2d {t_lib:.4f} ms bound {t_bound:.4f} ms ({by})")
        out[dname] = dict(shape=[n, hs, w, cin, cout], k=k, stride=s, pad=p, groups=groups, lo=lo,
                          hi=hi, bottom_absent=bool(absent), layer=case.get("layer"),
                          layout=case["layout"], valid_rows=case.get("valid_rows"),
                          dtype=dname, per_forward=case["per_forward"], max_abs_err=err, ms=t_kernel,
                          plain_ms=t_plain, library_ms=t_lib, bound_ms=t_bound, ops_ms=ops_ms,
                          bytes_ms=bytes_ms, bound_by=by, tflops=flops / t_kernel / 1e9)
    return dict(out["float32"], bf16_max_abs_err=out["bfloat16"]["max_abs_err"],
                bf16_ms=out["bfloat16"]["ms"], bf16_library_ms=out["bfloat16"]["library_ms"],
                bf16_bound_ms=out["bfloat16"]["bound_ms"])


def attention_pairs(t: int, s: int, causal: bool) -> int:
    """(query, key) pairs the softmax weighs: T*S, or under the top-left
    causal mask sum_t min(S, t + 1)."""
    if not causal:
        return t * s
    return sum(min(s, q + 1) for q in range(t))


def hold_attention(torch, F, gen, case: dict) -> dict:
    """One K3 shape on the card, float32 (TF32 off) and bfloat16: the kernel
    against its plain version (an error beyond TOL is fatal), then the mean
    times of the kernel, the plain version and F.scaled_dot_product_attention
    (on the repeated KV heads where Hkv < H), beside the bound.  q, k and v
    are [B, T, H*D] buffers seen as [B, H, T, D] through strides, the layout
    the ViT's attention hands the kernel.  Returns the float32 row, with the
    bfloat16 error and time in it."""
    from repro_torch.kernels.attention import attention_ref, flash_attention, gqa_flash

    b, h, hkv, t, s, d, causal = (case[key] for key in ("b", "h", "hkv", "t", "s", "d", "causal"))
    g = h // hkv
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).removeprefix("torch.")
        q, k, v = (torch.randn((b, n, heads * d), generator=gen, device="cuda").to(dt)
                   .view(b, n, heads, d).transpose(1, 2)
                   for n, heads in ((t, h), (s, hkv), (s, hkv)))
        kr, vr = (x.repeat_interleave(g, dim=1) for x in (k, v))

        def kernel():
            if g == 1:
                return flash_attention(q, k, v, causal=causal)
            # gqa_flash takes the model layout [B, T, H, D]
            return gqa_flash(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=causal).transpose(1, 2)

        got = kernel()
        want = attention_ref(q, kr, vr, causal=causal)
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        check(torch.isfinite(got.float()).all().item(), f"non-finite attention output at {case}")
        check(bool((diff <= TOL[dname] * (1 + want.float().abs())).all()),
              f"flash attention disagrees with its plain version ({dname}, max err {err}): {case}")
        t_kernel = time_ms(torch, kernel)
        t_plain = time_ms(torch, lambda: attention_ref(q, kr, vr, causal=causal))
        t_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=causal))
        flops = 4.0 * b * h * attention_pairs(t, s, causal) * d
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()  # q, k, v in; o out
        ops_ms, bytes_ms = bound_ms(flops, nbytes, dname)
        t_bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"attn {dname:8s} {case['path'] or 'extra'} B{b} H{h}/{hkv} T{t} S{s} D{d}"
              f"{' causal' if causal else ''} x{case['per_forward']}/fwd: max_err {err:.3g} "
              f"kernel {t_kernel:.4f} ms ({flops / t_kernel / 1e9:.2f} TFLOP/s) plain {t_plain:.4f} ms "
              f"SDPA {t_lib:.4f} ms bound {t_bound:.4f} ms ({by})")
        out[dname] = dict(b=b, h=h, hkv=hkv, t=t, s=s, d=d, causal=causal, path=case["path"],
                          dtype=dname, per_forward=case["per_forward"], max_abs_err=err, ms=t_kernel,
                          plain_ms=t_plain, library_ms=t_lib, bound_ms=t_bound, ops_ms=ops_ms,
                          bytes_ms=bytes_ms, bound_by=by, tflops=flops / t_kernel / 1e9)
    return dict(out["float32"], bf16_max_abs_err=out["bfloat16"]["max_abs_err"],
                bf16_ms=out["bfloat16"]["ms"], bf16_library_ms=out["bfloat16"]["library_ms"],
                bf16_bound_ms=out["bfloat16"]["bound_ms"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core import (
        SCHEME_HALO,
        SCHEME_HS,
        SCHEME_NP,
        CollabTopology,
        Platform,
        plan_even,
        plan_from_scheme_layout,
        plan_halp,
        plan_scheme,
        scheme_layout,
        stage_spans,
        vit_l16_geom,
    )
    from repro_torch.core.partition import _split_counts
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref
    from repro_torch.kernels.halo_conv import halo_conv2d_cuda
    from repro_torch.launch.mesh import make_spatial_comm
    from repro_torch.launch.serve import serve
    from repro_torch.models import vgg, vit_spatial
    from repro_torch.models.common import tree_map
    from repro_torch.parallel import weighted_spatial_inputs
    from repro_torch.spatial import (
        features_spatial,
        merge_padded_shards,
        plan_shard_heights,
        run_plan,
        spatial_alignment,
    )

    # every float32 reference below runs in full float32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"device: {kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi)

    # -- 2. build ------------------------------------------------------------
    build_s = _build.build_all()
    print(f"build: {sorted(_build.sources())} in {build_s:.1f} s")
    for name, log in _build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- 3. the kernel against its plain version, on the card -----------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan = plan_halp(vgg.FULL.geom(), overlap_rows=4)
    path_shapes = conv_shapes(plan, MAX_BATCH)
    net = vgg.FULL.geom()
    weighted_heights = plan_shard_heights(
        plan_even(net, len(WEIGHTED_RATIOS), ratios=WEIGHTED_RATIOS), align=spatial_alignment(net))
    check(weighted_heights == WEIGHTED_HEIGHTS,
          f"plan_even(ratios={WEIGHTED_RATIOS}) gives heights {weighted_heights}, expected {WEIGHTED_HEIGHTS}")
    layouts = {"weighted": spatial_calls(net, WEIGHTED_HEIGHTS, MAX_BATCH, weighted=True),
               "equal": spatial_calls(net, EQUAL_HEIGHTS, MAX_BATCH, weighted=False)}
    # phase 6's scheme plans: ViT-L/16 on secondaries of capacities 5:3:2
    # (the baseline assignment), and VGG-16 with every stage non_penetrative
    topo = CollabTopology(host="e0", secondaries=("e1", "e2", "e3"),
                          platforms={es: Platform(es, c * 1e12, c * 1e12)
                                     for es, c in (("e0", 1.0), ("e1", 5.0), ("e2", 3.0), ("e3", 2.0))})
    vit_plan = plan_scheme(vit_l16_geom(), topo)
    vgg_np_plan = plan_from_scheme_layout(scheme_layout(
        net, topo.secondaries, ratios=vit_plan.ratios,
        assignment=(SCHEME_NP,) * len(stage_spans(net))))
    vit_convs, vit_attns = scheme_calls(vit_plan, MAX_BATCH)
    np_convs, _ = scheme_calls(vgg_np_plan, MAX_BATCH)
    # path: the main path whose forward makes per_forward such calls
    cases = [dict(shape=s[:5], k=s[5], per_forward=c, stride=s[6], pad=0, groups=1, view=False,
                  path="run_plan") for s, c in sorted(path_shapes.items())]
    cases += [dict(shape=c["shape"], k=c["k"], per_forward=c["per_forward"], stride=c["stride"],
                   pad=c["pad"], groups=c["groups"], view=False, path="weighted-fixup", layer=c["layer"])
              for c in layouts["weighted"] if c["kernel"] == "conv2d"]
    # the ViT's convs are row slices of the host's map (views), VGG-NP's the padded map
    cases += [dict(shape=s[:5], k=s[5], per_forward=c, stride=s[6], pad=0, groups=1, view=True,
                   path="vit") for s, c in sorted(vit_convs.items())]
    cases += [dict(shape=s[:5], k=s[5], per_forward=c, stride=s[6], pad=0, groups=1, view=False,
                   path="vgg-np") for s, c in sorted(np_convs.items())]
    cases += [
        dict(shape=(MAX_BATCH, 56, 56, 128, 256), k=3, per_forward=0, stride=2, pad=1, groups=1, view=False),
        dict(shape=(MAX_BATCH, 56, 56, 256, 256), k=3, per_forward=0, stride=1, pad=1, groups=256, view=False),
        dict(shape=(MAX_BATCH, 30, 58, 64, 128), k=3, per_forward=0, stride=1, pad=0, groups=1, view=True),
    ]
    rows = []
    for case in cases:
        n, h, w, cin, cout = case["shape"]
        k, s, p, groups = case["k"], case["stride"], case["pad"], case["groups"]
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).removeprefix("torch.")
            if case["view"]:  # a row slice of a taller batch: batch stride != H*W*C
                x = torch.randn((n, h + 8, w, cin), generator=gen, device="cuda").to(dt)[:, 4:4 + h]
                check(not x.is_contiguous(), "the view case must not be contiguous")
            else:
                x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(dt)
            w_cin = 1 if groups > 1 else cin
            wt = (math.sqrt(2.0 / (k * k * w_cin))
                  * torch.randn((k, k, w_cin, cout), generator=gen, device="cuda")).to(dt)
            b = (0.1 * torch.randn((cout,), generator=gen, device="cuda")).to(dt)
            kw = dict(stride=s, padding=p, groups=groups)
            got = conv2d_cuda(x, wt, b, **kw)
            want = conv2d_ref(x, wt, b, **kw)
            torch.cuda.synchronize()
            check(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            ok = bool((diff <= TOL[dname] * (1 + want.float().abs())).all())
            check(torch.isfinite(got.float()).all().item(), f"non-finite kernel output at {case}")
            xn = x.permute(0, 3, 1, 2)  # NHWC memory seen as NCHW (channels_last), a view
            wn = wt.permute(3, 2, 0, 1)  # HWIO -> OIHW, a view
            t_kernel = time_ms(torch, lambda: conv2d_cuda(x, wt, b, **kw))
            t_plain = time_ms(torch, lambda: conv2d_ref(x, wt, b, **kw))
            t_lib = time_ms(torch, lambda: F.conv2d(xn, wn, b, stride=s, padding=p, groups=groups))
            ho, wo = got.shape[1], got.shape[2]
            flops = 2.0 * k * k * w_cin * cout * n * ho * wo
            nbytes = (x.numel() + wt.numel() + b.numel() + got.numel()) * x.element_size()
            ops_ms, bytes_ms = bound_ms(flops, nbytes, dname)
            t_bound = max(ops_ms, bytes_ms)
            by = "operations" if ops_ms >= bytes_ms else "bytes"
            row = dict(shape=[n, h, w, cin, cout], k=k, stride=s, pad=p, groups=groups,
                       view=case["view"], path=case.get("path"), layer=case.get("layer"),
                       dtype=dname, per_forward=case["per_forward"], max_abs_err=err,
                       within_tol=ok, ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                       bound_ms=t_bound, ops_ms=ops_ms, bytes_ms=bytes_ms, bound_by=by,
                       tflops=flops / t_kernel / 1e9)
            rows.append(row)
            print(f"conv {dname:8s} {case.get('path') or 'extra'} {case.get('layer') or ''} "
                  f"x{[n, h, w, cin]} -> {cout} k{k} s{s} p{p} g{groups}"
                  f"{' view' if case['view'] else ''} x{case['per_forward']}/fwd: "
                  f"max_err {err:.3g} kernel {t_kernel:.4f} ms ({row['tflops']:.1f} TFLOP/s) "
                  f"plain {t_plain:.4f} ms F.conv2d {t_lib:.4f} ms bound {t_bound:.4f} ms ({by})")
            check(ok, f"kernel disagrees with its plain version: {row}")

    # -- 3b. the halo conv against its plain version, on the card -------------
    halo_cases = [dict(c, layout=name) for name, calls in layouts.items() for c in calls
                  if c["kernel"] == "halo_conv2d"]
    halo_cases += [  # beyond the path: stride 2, k7 s2, depthwise k7, a ragged shard
        dict(shape=(MAX_BATCH, 56, 56, 128, 256), k=3, stride=2, pad=1, lo=1, hi=0, groups=1),
        dict(shape=(MAX_BATCH, 64, 64, 3, 64), k=7, stride=2, pad=3, lo=3, hi=2, groups=1),
        dict(shape=(MAX_BATCH, 28, 56, 256, 256), k=7, stride=1, pad=3, lo=3, hi=3, groups=256),
        dict(shape=(MAX_BATCH, 13, 14, 512, 512), k=3, stride=1, pad=1, lo=1, hi=1, groups=1),
    ]
    halo_rows = [hold_halo_conv(torch, F, gen, dict(dict(per_forward=0, layout=None, bottom="view"), **c))
                 for c in halo_cases]

    # -- 3c. flash attention against its plain version, on the card ----------
    attn_cases = [dict(b=b, h=h, hkv=h, t=t, s=s, d=d, causal=False, per_forward=c, path="vit")
                  for (b, h, t, s, d), c in sorted(vit_attns.items(), reverse=True)]
    attn_cases += [dict(dict(b=MAX_BATCH, causal=True, per_forward=0, path=None), **c) for c in (
        dict(h=16, hkv=16, t=256, s=256, d=64),
        dict(h=16, hkv=16, t=128, s=256, d=64),   # top-left causal, T < S
        dict(h=16, hkv=16, t=128, s=64, d=64),    # T > S: rows past S see every key
        dict(h=16, hkv=4, t=256, s=256, d=128),   # GQA, 4 query heads per KV head
    )]
    attn_rows = [hold_attention(torch, F, gen, c) for c in attn_cases]

    # -- 4. the main path: full-width VGG-16 served through the HALP plan -----
    conv2d_cuda.launches = 0
    out = serve(vgg.FULL, n_requests=N_REQUESTS, max_batch=MAX_BATCH, device="cuda", seed=0)
    launches = conv2d_cuda.launches
    n_batches = -(-N_REQUESTS // MAX_BATCH)
    per_forward = sum(path_shapes.values())
    stats = out["stats"]
    print(f"served {stats['completed']} requests in {n_batches} batches of {MAX_BATCH}: "
          f"p50 {stats['p50_latency_s'] * 1e3:.3f} ms p99 {stats['p99_latency_s'] * 1e3:.3f} ms "
          f"{out['requests_per_s']:.3f} req/s (wall {out['wall_s']:.3f} s); "
          f"conv2d launches {launches} (plan: {per_forward} per forward)")
    reqs = out["requests"]
    first = min(r.arrival for r in reqs) - out["start_s"]
    batch_done = sorted({round((r.done - out["start_s"]) * 1e3, 3) for r in reqs})
    print(f"  first submission at +{first * 1e3:.3f} ms; batches done at +{batch_done} ms "
          f"(from the start of the serving clock)")
    check(stats["completed"] == N_REQUESTS, "not every request completed")
    check(per_forward == 39, f"plan_halp gives {per_forward} conv segments per forward, expected 39")
    check(launches >= per_forward * n_batches, f"{launches} launches < {per_forward} x {n_batches}")

    logits = out["logits"]
    check(tuple(logits.shape) == (N_REQUESTS, vgg.FULL.num_classes), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    params, images = out["params"], out["images"][:MAX_BATCH]
    single = vgg.apply(params, vgg.FULL, images)  # one device, same kernel
    lossless_err = (logits[:MAX_BATCH] - single).abs().max().item()
    print(f"run_plan vs single-device apply (both through the kernel): max |diff| {lossless_err:.3g}")
    check(torch.allclose(logits[:MAX_BATCH], single, rtol=2e-5, atol=2e-5), "HALP plan is not lossless")
    plain = vgg.apply(tree_map(lambda t: t.cpu(), params), vgg.FULL, images.cpu())  # plain conv
    depth_err = (logits[:MAX_BATCH].cpu() - plain).abs().max().item()
    scale = plain.abs().max().item()
    print(f"run_plan vs plain-conv apply on the CPU: max |diff| {depth_err:.3g} "
          f"(max |logit| {scale:.3g}, limit {DEPTH_RTOL} x that)")
    check(depth_err <= DEPTH_RTOL * scale, "kernel drifts from the plain conv at depth")

    # -- where the time goes: steady-state forwards of one batch, then one
    # forward under the profiler for the device's busy time by kernel -------
    def forward(batch):
        return vgg.head(params, run_plan(out["plan"], params["features"], vgg.apply_layer, batch))

    fwd_ms, busy_ms, top = steady_and_profiled(torch, lambda: forward(images), "run_plan")

    # -- 5. the spatial engine: full-width VGG-16 over height shards of one
    # card, fused engine, in the weighted and the equal layout ----------------
    spatial = {}
    for name, heights in (("weighted", WEIGHTED_HEIGHTS), ("equal", EQUAL_HEIGHTS)):
        comm = make_spatial_comm(len(heights), device="cuda")
        xs, hts = weighted_spatial_inputs(images, heights, comm)
        weighted = name == "weighted"
        align = spatial_alignment(net)

        def spatial_forward(xs=xs, comm=comm, weighted=weighted, heights=heights):
            ys = features_spatial(params["features"], net, xs, comm=comm,
                                  heights=heights if weighted else None, engine="fused")
            return vgg.head(params, merge_padded_shards(ys, [h // align for h in heights]))

        calls = layouts[name]
        want = {k: sum(c["per_forward"] for c in calls if c["kernel"] == k)
                for k in ("halo_conv2d", "conv2d")}
        conv2d_cuda.launches = halo_conv2d_cuda.launches = 0
        logits_sp = spatial_forward()
        torch.cuda.synchronize()
        got = {"halo_conv2d": halo_conv2d_cuda.launches, "conv2d": conv2d_cuda.launches}
        print(f"spatial {name} {heights}: launches {got} (expected {want})")
        check(got == want, f"spatial {name}: launches {got}, expected {want}")
        check(got["halo_conv2d"] > 0, f"spatial {name} never launched the halo conv")
        check(tuple(logits_sp.shape) == (MAX_BATCH, vgg.FULL.num_classes), f"logits {tuple(logits_sp.shape)}")
        check(bool(torch.isfinite(logits_sp).all()), f"spatial {name}: non-finite logits")
        sp_err = (logits_sp - single).abs()
        sp_ok = bool((sp_err <= 2e-5 * (1 + single.abs())).all())
        sp_depth = (logits_sp.cpu() - plain).abs().max().item()
        print(f"  vs single-device apply (K1): max |diff| {sp_err.max().item():.3g}; vs plain conv "
              f"on the CPU: max |diff| {sp_depth:.3g} (limit {DEPTH_RTOL} x {scale:.3g})")
        check(sp_ok, f"spatial {name} is not lossless against the single-device forward")
        check(sp_depth <= DEPTH_RTOL * scale, f"spatial {name} drifts from the plain conv at depth")
        asked = sum(c["shape"][1] * c["per_forward"] for c in calls if c["kernel"] == "halo_conv2d")
        useful = sum(c["valid_rows"] for c in calls if c["kernel"] == "halo_conv2d")
        print(f"  K2 output rows asked for per forward: {asked}, of which valid: {useful} "
              f"(useful share {useful / asked:.4f})")
        fwd_sp, busy_sp, top_sp = steady_and_profiled(torch, spatial_forward, f"spatial {name}")
        spatial[name] = dict(heights=list(heights), launches=got, lossless_max_abs=sp_err.max().item(),
                             plain_depth_max_abs=sp_depth, k2_rows_asked=asked, k2_rows_valid=useful,
                             steady_forward_ms=fwd_sp, device_busy_ms=busy_sp, top_device=top_sp)

    # -- 6a. full-width ViT-L/16 through the mixed-scheme plan ----------------
    check(vit_plan.assignment == (SCHEME_HALO,) + (SCHEME_HS,) * 24,
          f"plan_scheme gives ViT-L/16 the assignment {vit_plan.assignment}")
    check(_split_counts(16, vit_plan.ratios) == [8, 5, 3] and _split_counts(14, vit_plan.ratios) == [7, 4, 3],
          f"ratios {vit_plan.ratios} do not split heads 8/5/3 and token rows 7/4/3")
    vcfg = vit_spatial.FULL
    vgen = torch.Generator(device="cuda").manual_seed(1)
    vparams = vit_spatial.init(vgen, vcfg)
    vimages = torch.randn((MAX_BATCH, vcfg.img_res, vcfg.img_res, vcfg.in_channels),
                          generator=vgen, device="cuda")

    def vit_forward():
        feats = run_plan(vit_plan, vparams["features"], vit_spatial.apply_layer, vimages)
        return vit_spatial.head(vparams, feats)

    want_vit = {"conv2d": sum(vit_convs.values()), "flash_attention": sum(vit_attns.values())}
    conv2d_cuda.launches = flash_attention.launches = 0
    vlogits = vit_forward()
    torch.cuda.synchronize()
    got_vit = {"conv2d": conv2d_cuda.launches, "flash_attention": flash_attention.launches}
    print(f"vit run_plan {[(sg.scheme, sg.start, sg.stop) for sg in vit_plan.segments]}: "
          f"launches {got_vit} (plan: {want_vit})")
    check(got_vit == want_vit, f"ViT launches {got_vit}, the plan predicts {want_vit}")
    check(got_vit["flash_attention"] == 3 * vcfg.n_blocks, "K3 is not launched once per head shard")
    check(tuple(vlogits.shape) == (MAX_BATCH, vcfg.num_classes), f"ViT logits {tuple(vlogits.shape)}")
    check(bool(torch.isfinite(vlogits).all()), "non-finite ViT logits")
    check(bool((vlogits != 0).any()), "ViT logits are all zero")
    vsingle = vit_spatial.apply(vparams, vcfg, vimages)  # one device, same kernels
    v_err = (vlogits - vsingle).abs()
    v_share = (v_err / (2e-5 * (1 + vsingle.abs()))).max().item()
    print(f"  vs single-device apply (K1, K3): max |diff| {v_err.max().item():.3g} (at most "
          f"{v_share:.3f} of the limit 2e-5 x (1 + |y|))")
    check(v_share <= 1, "the ViT scheme plan is not lossless")
    vplain = vit_spatial.apply(tree_map(lambda t: t.cpu(), vparams), vcfg, vimages.cpu())  # plain, f32
    v_depth = (vlogits.cpu() - vplain).abs().max().item()
    v_scale = vplain.abs().max().item()
    print(f"  vs the plain versions' forward on the CPU (float32, all {MAX_BATCH} images): max |diff| "
          f"{v_depth:.3g} (max |logit| {v_scale:.3g}, limit {DEPTH_RTOL} x that)")
    check(v_depth <= DEPTH_RTOL * v_scale, "the ViT drifts from the plain versions at depth")
    vit_ms, vit_busy, vit_top = steady_and_profiled(torch, vit_forward, "vit run_plan")

    # -- 6b. full-width VGG-16 with every stage non_penetrative ---------------
    def np_forward():
        return vgg.head(params, run_plan(vgg_np_plan, params["features"], vgg.apply_layer, images))

    conv2d_cuda.launches = 0
    np_logits = np_forward()
    torch.cuda.synchronize()
    np_launches = conv2d_cuda.launches
    print(f"vgg non_penetrative run_plan: conv2d launches {np_launches} (plan: {sum(np_convs.values())})")
    check(np_launches == sum(np_convs.values()) == 39, f"VGG-NP launches {np_launches}")
    check(bool(torch.isfinite(np_logits).all()), "non-finite VGG-NP logits")
    np_err = (np_logits - single).abs()
    np_depth = (np_logits.cpu() - plain).abs().max().item()
    print(f"  vs single-device apply (K1): max |diff| {np_err.max().item():.3g}; vs plain conv on the "
          f"CPU: max |diff| {np_depth:.3g} (limit {DEPTH_RTOL} x {scale:.3g})")
    check(bool((np_err <= 2e-5 * (1 + single.abs())).all()), "the VGG non_penetrative plan is not lossless")
    check(np_depth <= DEPTH_RTOL * scale, "VGG-NP drifts from the plain conv at depth")
    np_ms, np_busy, np_top = steady_and_profiled(torch, np_forward, "vgg non_penetrative run_plan")

    # -- result --------------------------------------------------------------
    # each kernel's numbers summed over one forward of every main path that
    # launches it: run_plan (phase 4) and the two spatial layouts (phase 5)
    main_rows = [r for r in rows if r["per_forward"] and r["dtype"] == "float32"]
    fix_rows = [r for r in main_rows if r["path"] == "weighted-fixup"]
    halo_main = [r for r in halo_rows if r["per_forward"]]

    def per_fwd(rs, key: str) -> float:
        return sum(r[key] * r["per_forward"] for r in rs)

    def entry(name, source, replaces, rs, n_launches):
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": n_launches,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": per_fwd(rs, "ms"),
            "plain_ms": per_fwd(rs, "plain_ms"),
            "bound_ms": per_fwd(rs, "bound_ms"),
            "bound_by": "operations" if per_fwd(rs, "ops_ms") >= per_fwd(rs, "bytes_ms") else "bytes",
            "library_ms": per_fwd(rs, "library_ms"),
        }

    attn_main = [r for r in attn_rows if r["per_forward"]]
    kernels = [
        entry("conv2d", "src/repro_torch/kernels/conv2d/conv2d.cu",
              "src/repro/kernels/conv2d/conv2d.py:39", main_rows,
              launches + sum(v["launches"]["conv2d"] for v in spatial.values())
              + got_vit["conv2d"] + np_launches),
        entry("halo_conv2d", "src/repro_torch/kernels/halo_conv/halo_conv.cu",
              "src/repro/kernels/halo_conv/halo_conv.py:30", halo_main,
              sum(v["launches"]["halo_conv2d"] for v in spatial.values())),
        entry("flash_attention", "src/repro_torch/kernels/attention/attention.cu",
              "src/repro/kernels/attention/attention.py:20", attn_main, got_vit["flash_attention"]),
    ]
    per_path = {path: {key: per_fwd([r for r in main_rows if r["path"] == path], key)
                       for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
                for path in ("run_plan", "weighted-fixup", "vit", "vgg-np")}
    per_path["vit"]["flash_attention"] = {key: per_fwd(attn_main, key)
                                          for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    for name, v in per_path.items():
        print(f"K1 per forward of {name}: {json.dumps(v)}")
    by_layout = {name: {key: per_fwd([r for r in halo_main if r["layout"] == name], key)
                        for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
                 for name in spatial}
    by_layout["weighted"]["fixup_conv2d"] = {key: per_fwd(fix_rows, key)
                                             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    for name, v in by_layout.items():
        print(f"per forward of spatial {name}: {json.dumps(v)}")
    report = {
        "device": kind, "nvidia_smi": smi, "build_s": build_s, "conv_cases": rows,
        "serve": dict(stats, wall_s=out["wall_s"], requests_per_s=out["requests_per_s"],
                      n_requests=N_REQUESTS, max_batch=MAX_BATCH, launches=launches,
                      batch_done_ms=batch_done, first_submission_ms=first * 1e3,
                      lossless_max_abs=lossless_err, plain_depth_max_abs=depth_err,
                      steady_forward_ms=fwd_ms, device_busy_ms=busy_ms, top_device=top),
        "halo_cases": halo_rows, "spatial": spatial,
        "spatial_per_forward": by_layout, "attention_cases": attn_rows,
        "vit": dict(segments=[(sg.scheme, sg.start, sg.stop) for sg in vit_plan.segments],
                    ratios=vit_plan.ratios, launches=got_vit, lossless_max_abs=v_err.max().item(),
                    lossless_limit_share=v_share,
                    plain_depth_max_abs=v_depth, max_abs_logit=v_scale, steady_forward_ms=vit_ms,
                    device_busy_ms=vit_busy, top_device=vit_top),
        "vgg_np": dict(launches=np_launches, lossless_max_abs=np_err.max().item(),
                       plain_depth_max_abs=np_depth, steady_forward_ms=np_ms,
                       device_busy_ms=np_busy, top_device=np_top),
        "k1_per_forward": per_path, "kernels": kernels,
        "note": "in kernels, ms, plain_ms, library_ms and bound_ms are float32 sums over one "
                "forward of each main path that launches the kernel (batch 4): conv2d over a "
                "run_plan forward (39 calls), the weighted spatial forward's 52 fix-up convs, "
                "a ViT-L/16 scheme-plan forward (221 calls) and a VGG-16 non_penetrative "
                "forward (39 calls); halo_conv2d over one weighted (52 calls) and one equal "
                "(91 calls) spatial forward; flash_attention over a ViT-L/16 forward (72 "
                "calls).  launches count every main-path run: the 4 served batches, one "
                "forward of each spatial layout, one ViT forward and one VGG-NP forward.",
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
