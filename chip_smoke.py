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
   printing the core's split count of K (S) and gather variant per shape,
   timing the kernel, the plain version and ``F.conv2d`` (a yardstick the
   port never calls) beside the least time the card could take (float32 at
   the 3xTF32 rate the kernel runs, with the CUDA cores' FMA bound beside it);
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
   and bfloat16, with its split count and gather variant, timing it beside
   its plain version, ``F.conv2d`` on the concatenated slab (a yardstick the
   port never calls) and its bounds, as phase 3;
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
   and the LM's two shapes of phase 7 (32 query heads over 8 KV heads, D =
   128: causal T = S = 512, and T = 1 over the first 64 keys of a 512-slot
   KV cache, a strided view), in float32 and bfloat16, timing it beside its
   plain version,
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls) and
   its bound (float32 at the 3xTF32 rate the kernel runs, with the FFMA bound
   beside it); at the ViT's and the LM's shapes also the kernel's and SDPA's
   device us per call from a ``torch.profiler`` window over back-to-back launches, the
   wrapper's host us per call and the largest |score|;
6. (a) runs full-width ViT-L/16 (224x224, patch 16, 24 blocks, d 1024, 16
   heads, seeded random weights, batch 4) through ``plan_scheme`` on a
   topology of three secondaries with capacities 5:3:2 (halo_segment for the
   patch conv, head_sequence for every block), counts K1's and K3's launches
   in one forward against the plan's, checks the logits (finite, not all
   zero, lossless against the single-device forward through the same
   kernels, within ``DEPTH_RTOL`` of the plain versions' forward on the CPU),
   prints the largest |score| K3 sees in it, runs the same forward in
   bfloat16 (K3's launches counted; logits within 2e-2 of the largest |logit|
   of the float32 card forward of the same bf16-rounded weights and images,
   with the gap to the float32 weights' forward printed beside, for the
   kernels and for the plain versions), then times steady forwards and
   profiles one; (b) runs full-width VGG-16
   (phase 4's weights and images) under a plan that gives non_penetrative to
   every stage with the same ratios, lossless against the single-device
   forward: K1 then takes contiguous copies of the filter slices.
7. runs full-width Qwen3-4B (36 layers, d_model 2560, 32 query heads over 8
   KV heads, d_head 128, d_ff 9728, vocab 151936, qk-norm; seeded random
   weights, 4.41 B parameters) through the port's step builders
   (``configs.steps.build``) for its ``prefill_32k`` and ``decode_32k`` cells
   at batch 4 x 512 tokens: (1) a float32 prefill, K3 launched once per layer
   and no ``scaled_dot_product_attention`` in its profile, logits finite;
   (2) the same forward with the plain attention on the card, and (3) the
   plain versions' forward on the CPU over the first 16 tokens of batch
   element 0 (weights copied to the host), both within ``DEPTH_RTOL`` of the
   largest |logit|; (4) 64 teacher-forced KV-cache decode steps from
   ``init_cache``, 36 K3 launches each, every step's logits within
   ``DEPTH_RTOL`` of the prefill's at its position; then times and profiles
   a steady float32 prefill and decode step; (5) frees the float32 weights
   and runs the prefill in bfloat16, held to the float32 forward of the same
   bf16-rounded weights (within ``BF16_RTOL`` of its largest |logit|, or 1.25x
   the plain versions' own bfloat16 gap where that is larger), then times
   and profiles it.  Phase 3c holds K3 at the LM's two shapes (the causal
   GQA prefill, and a decode step over a 64-key prefix of a 512-slot cache).
8. runs full-width moonshot-v1-16b-a3b (48 MoE layers, d_model 2048, 16
   query heads over 16 KV heads at d_head 128, 64 experts top-6 of d_ff
   1408, capacity factor 1.25, vocab 163840; seeded random weights, 28.06 B
   parameters) through ``configs.steps.build`` at batch 4 x 512 tokens
   (``phase_moe``): (a) in float32 at 6 of its 48 layers (the 48 are 112 GB
   in float32), a prefill with K3 once per layer and no SDPA operator, then
   the same forward with the plain attention on the card, the plain
   versions on the CPU over 16 tokens, and 64 teacher-forced decode steps,
   each held route by route (``hold_routed``: a flipped expert choice must
   be a near-tie, ``NEAR_TIE``; the logits are held within ``DEPTH_RTOL``
   where no routing difference, and for decode no dropped route, reaches);
   the same depth in bf16 held to the float32 forward of its rounded
   weights by the median and p99 of |diff|; (b) in bf16 at all 48 layers
   (56.1 GB), a prefill and 16 decode steps, 48 K3 launches each, with the
   plain attention's forward as a record; (c) steady timing and a profile of
   each, the device ms split into GEMM, K3, routing and other.  Phase 3c
   holds K3 at this model's two shapes (16 heads over 16, D = 128).
9. runs full-width DeepSeek-V3 (d_model 7168, MLA with 128 heads at a
   query/key width of 192 and a value width of 128, q_lora 1536, kv_lora
   512; 3 dense layers of d_ff 18432, then MoE layers of 256 experts top-8
   of d_ff 2048 and a shared expert, router bias, capacity factor 1.25;
   vocab 129280; seeded random weights) through ``configs.steps.build``
   at batch 4 x 512 tokens, cut to 4 of its 61 layers (the 3 dense and the
   first MoE layer: 15.11 B parameters, 60.4 GB in float32) and no MTP
   head (``phase_mla``): (a) float32 with the weights rounded to bf16
   values, a prefill with K3 once a layer and no SDPA operator, held route
   by route against the plain attention on the card, the 3 dense layers
   against the plain versions on the CPU (16 tokens), 64 decode steps from
   the latent cache against a drop-free prefill; (b) the same weights in
   bf16, a prefill (held to (a)'s by the median and p99 of |diff|) and 16
   decode steps; steady timing and profiles of each; peak device memory
   below the card's.  Phase 3c holds K3 at MLA's two shapes, (DQK, DV) =
   (192, 128); phase 2 prints each K3 instantiation's registers and spill
   bytes.
10. runs the plan analysers and the paper's deadline-aware serving (§V.D)
   over full-width VGG-16 under ``plan_halp(overlap_rows=4)`` with phase 4's
   weights and images (``phase_serving``): (1) ``check_plan`` on phase 4's,
   phase 5's ``plan_even`` and phase 6's two scheme plans, and
   ``check_plan_kernels`` on the first two, each clean, with its host ms and
   checks; one K2 launch at every conv geometry the probe accepts, of the
   probe's shape and within ``TOL`` of the plain version; a row-gap copy of
   the plan refused by ``run_plan(verify=True)`` with no K1 launch; (2) the
   latency curve of ``run_plan`` + head at batch 1..8 (host clock,
   synchronised, mean of 5 after 3 warm-up calls; K1 launches per forward;
   device busy ms at 4 and 8); (3) ``choose_batch_size`` over that curve and
   the reliability at batch 4, D = 4/30 s, at Table III's seven channel
   states and targets 0.999 / 0.99999; (4) a burst of 32 requests through
   ``BatchingEngine`` at the width admitted at 100 Mbps, sigma 2 ms (fatal if
   0), each request's logits equal to its single-request forward within
   2e-5 x (1 + |y|), the first 4 within ``DEPTH_RTOL`` of the plain conv on
   the CPU; (5) ``serve_trace`` over the curve with the serving sweep's
   classes, channel and three arrival processes at its 3,600 s horizon,
   admission on and off: every request completed or shed, nothing shed with
   admission off, the Poisson trace's fast path equal to the scalar loop.
11. prices the paper's latency engines on the card (``phase_engines``, fed
   phase 10's curve and phase 4's weights and images): (1) a ``Platform``
   calibrated to the card's b = 1 forward (``schedule._calibrated``), the
   DES's per-layer compute time beside K1's (or the pool's) device time at
   the single-device shape; (2) the single-ES chain ``b x t_pre`` beside the
   curve, b = 1..8 (a record); (3) Figs. 6-7 and Table II on card-class ESs
   at 40-100 Gbps (``simulate_halp`` at 1 and 4 tasks, ``simulate_modnn``,
   ``enhanced_modnn_delay``, ``halp_closed_form``, ``modnn_time``), the
   closed form an upper bound on the DES within its pinned slack and never
   looser than eq. 22, ``check_dag`` clean on every DAG built; (4)
   ``optimize_plan(n_tasks=4, verify=True)`` on Table IV's heterogeneous
   pair, ``check_template`` clean on its template, K1 held against its plain
   version (and timed) at every conv shape of the searched plan, the plan
   through ``run_plan(verify=True)`` at batch 4 -- its K1 launches equal to the
   plan's, its logits within 2e-5 x (1 + |y|) of phase 4's single-device
   forward and within ``DEPTH_RTOL`` of the plain conv on the CPU -- timed
   and profiled beside the DES's compute jobs for the same work; (5)
   ``serve_latency_table`` for card ESs at 100 Gbps beside the curve and
   ``serve_trace`` over both (phase 10's traces, admission on; every request
   completed or shed); (6) ``replay_trace`` of the searched plan over a
   ``GaussMarkovTrace`` of the fast secondary's link (100 Gbps fading to as
   low as 10).
12. closes the paper's §V.D time-variant channel on the card
   (``phase_replan``, fed phase 11's card platform and phase 4's weights and
   images): (1) a ``ReplanController(n_tasks=4)`` on Table IV's pair feeds a
   ``BatchingEngine`` (its batch latencies into ``observe_batch_latency``,
   ``run_plan``'s per-ES times into ``observe_compute``) whose forward runs
   the controller's current plan through ``run_plan(verify=True)`` (K1);
   between batches the e0<->fast link collapses (a seeded
   ``GaussMarkovTrace`` fed through ``observe_transfer``), once with
   ``adapt_compute=True`` and once link-only: each adopted plan's ratios and
   overlap, what switched it (link or compute bands), ``stats()``, each ES's
   compute estimate beside its nominal, ``plan_aware_batch_size`` before and
   after the collapse; (2) ``replay_trace`` of the controller beside the
   static plan (``optimize_static``) over phase 11's fading link and a
   straggling fast ES; (3) a ``PlanStore`` under a temporary directory primed
   with the loop's operating points, then a restarted controller serving its
   first plan with no optimizer call, equal to the loop's first and
   bit-identical through K1; ``check_keying()`` clean on the port's sources;
   (4) ``place_tasks(n_tasks=4)`` against ``shared_plan_placement`` on the
   DES over ``benchmarks/multitask_placement.py``'s 1 + 8 pool (per-task
   placement must win), and a ``PlacementController`` under a link collapse
   with ``plan_aware_batch_size`` over it.  Every distinct plan served has K1
   held against its plain version at each new conv shape, one forward
   lossless (2e-5 x (1 + |y|) of phase 4's single-device forward, within
   ``DEPTH_RTOL`` of the plain conv on the CPU) and a steady time; every
   forward's K1 launches equal its plan's.

The last two lines of standard output are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``; the per-shape table is also written to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense, HBM3 bandwidth.  The kernels (K1, K2,
# K3) run float32 as 3xTF32 on the tensor cores: three TF32 products per
# product, a third of the 495 TFLOP/s TF32 peak; bf16 at the tensor cores'
# 989.  Beside every bound the CUDA cores' float32 FMA rate (67 TFLOP/s) is
# printed as the old yardstick.
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
FFMA_FLOPS = 67e12
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
# the bfloat16 ViT forward's logits vs the float32 card forward of the same
# (bf16-rounded) weights and images, relative to the largest |logit| (bf16 _tol)
BF16_RTOL = 2e-2

# Phase 7: Qwen3-4B prefill of LM_BATCH x LM_LEN tokens (the prefill_32k
# cell cut from 32 x 32768), DECODE_STEPS teacher-forced decode steps against
# a cache of LM_LEN slots, and the CPU check over the first CPU_TOKENS tokens.
LM_BATCH, LM_LEN, DECODE_STEPS, CPU_TOKENS = 4, 512, 64, 16
# operators of F.scaled_dot_product_attention, none of which the port calls
SDPA_OPS = ("scaled_dot_product", "_flash_attention", "_efficient_attention", "_cudnn_attention")

# Phase 8: moonshot-v1-16b-a3b at full width, float32 at MOE_F32_LAYERS of
# its 48 layers (all 48 are 112 GB in float32, over the card's 80 GB) and
# bfloat16 at all 48 (56.1 GB), prefill of LM_BATCH x LM_LEN tokens;
# MOE_BF16_STEPS decode steps at 48 layers (DECODE_STEPS at 6).
MOE_F32_LAYERS, MOE_BF16_STEPS = 6, 16
# Routing is discontinuous: two float32 forwards may choose other experts
# only at a near-tie, the two experts' router probabilities on the reference
# side less than NEAR_TIE apart; logits are held where no routing difference
# reaches.  Decode against prefill fails past MAX_EXCLUDED of its positions
# excluded.
NEAR_TIE, MAX_EXCLUDED = 1e-5, 0.25

# Phase 9: DeepSeek-V3 at full width, MLA_LAYERS of its 61 layers (the 3
# dense layers and the first MoE layer: 15.11 B parameters, 60.4 GB in
# float32; a second MoE layer would add 46.0 GB) and no MTP head (only
# training reads it); MLA_BF16_STEPS bf16 decode steps.
MLA_LAYERS, MLA_BF16_STEPS = 4, 16

# Phase 10: deadline-aware serving (paper §V.D) of full-width VGG-16 under
# HALP.  D = 4 frames at 30 FPS; the admission targets; Table III's channel
# states (Mbps, ms of sigma; benchmarks/paper_tables.py l.172-175); the
# latency curve's widths; the live burst, admitted at examples/serve_halp.py's
# target; benchmarks/serve_sweep.py's --smoke horizon.
DEADLINE_S = 4.0 / 30.0
ADMISSION_TARGETS = (0.999, 0.99999)
TABLE3_STATES = ((40, 1), (40, 5), (60, 5), (60, 9), (60, 14), (100, 14), (100, 18))
CURVE_MAX_BATCH, BURST_REQUESTS, BURST_TARGET = 8, 32, 0.999
SWEEP_HORIZON_S = 3_600.0

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


def device_us(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of ``fn`` in us per call: the traced kernels' time in a
    ``torch.profiler`` window over ``reps`` back-to-back calls, per call; nan
    if the profiler traced no device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA]
    total, count = sum(a.self_device_time_total for a in rows), sum(a.count for a in rows)
    # a window may drop events: the mean kernel's time x the kernels a call launches
    return total / count * max(1, round(count / reps)) if total > 0 else float("nan")


def host_us(torch, fn, reps: int = 50) -> float:
    """Host time of ``fn`` in us per call: the enqueue of ``reps`` calls on
    the host clock, the device not waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


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


def dict_leaves(tree) -> list:
    """The leaves of a nested dict, in order."""
    return [x for v in tree.values() for x in (dict_leaves(v) if isinstance(v, dict) else [v])]


# K3's instantiations in ptxas's log: flash_fwd<T, DQK, DV, VEC, WQ, WK> mangled
K3_ENTRY = re.compile(r"flash_fwdI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELb([01])ELi(\d)ELi(\d)E")


def k3_ptxas(log: str) -> list[dict]:
    """Registers and spill bytes of each K3 instantiation, from ``nvcc
    -Xptxas=-v``'s log of attention.cu (a function's stack and spill line
    and its register line follow its "Compiling entry function" line)."""
    rows, cur = [], None
    for line in log.splitlines():
        m = K3_ENTRY.search(line) if "Compiling entry function" in line else None
        if m:
            t, dqk, dv, vec, wq, wk = m.groups()
            cur = dict(dtype="float32" if t == "f" else "bfloat16", dqk=int(dqk), dv=int(dv),
                       copies="16-byte" if vec == "1" else "element", block=f"{16 * int(wq)}x{wk}")
            rows.append(cur)
        elif cur is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            cur.update(stack_bytes=nums[0], spill_store_bytes=nums[1], spill_load_bytes=nums[2])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return rows


def bound_ms(flops: float, nbytes: float, dtype: str, ffma: bool = False) -> tuple[float, float]:
    """(ms the operations need at the peak rate of ``dtype`` -- or, with
    ``ffma``, at the CUDA cores' float32 FMA rate -- ms the bytes need at the
    HBM rate); the bound is the larger."""
    rate = FFMA_FLOPS if ffma else PEAK_FLOPS[dtype]
    return flops / rate * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3


# The port's kernels in a profile, by a substring of the device kernel's name
# (the split-K reduction is one kernel for K1 and K2 alike), cuBLAS's
# matrix products (the LM's dense layers and the experts' batched products;
# nvjet is its bf16 family on Hopper), and the MoE routing's sorts, searches,
# scatters and gathers (the embedding's row gather falls there too).
KERNEL_FAMILIES = (("conv2d_igemm<float, (anonymous namespace)::DenseRows", "K1"),
                   ("conv2d_igemm<float, (anonymous namespace)::HaloRows", "K2"),
                   ("splitk_reduce", "K1/K2 split-K reduction"), ("flash_fwd", "K3"),
                   ("conv2d_igemm", "K1/K2 (bf16)"), ("gemm", "GEMM (cuBLAS)"), ("gemv", "GEMM (cuBLAS)"),
                   ("splitKreduce", "GEMM (cuBLAS)"), ("nvjet", "GEMM (cuBLAS)"),
                   ("sort", "routing"), ("Sort", "routing"), ("search", "routing"), ("index", "routing"),
                   ("Index", "routing"), ("scatter", "routing"), ("gather", "routing"))


def kernel_family(name: str) -> str:
    return next((fam for key, fam in KERNEL_FAMILIES if key in name), "other")


def profile_device(torch, fn) -> tuple[float, list]:
    """One call of ``fn`` under the profiler: (device busy ms, its device-side
    rows -- kernels, copies -- longest first).  Operator rows are left out:
    they repeat their kernels' time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = sorted((a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA),
                       key=lambda a: -a.self_device_time_total)
    return sum(a.self_device_time_total for a in by_kernel) / 1e3, by_kernel


def steady_and_profiled(torch, forward, label: str) -> tuple[float, float, list, dict]:
    """Mean host-clock ms of 5 steady calls of ``forward`` (after one warm
    call), then one call under the profiler: (ms, device busy ms, the top
    device rows, device ms by kernel family).  Prints them."""
    forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        forward()
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / 5 * 1e3
    busy_ms, by_kernel = profile_device(torch, forward)
    top = [dict(name=a.key, ms=a.self_device_time_total / 1e3, count=a.count)
           for a in by_kernel[:8] if a.self_device_time_total > 0]
    families: dict = {}
    for a in by_kernel:
        fam = families.setdefault(kernel_family(a.key), dict(ms=0.0, count=0))
        fam["ms"] += a.self_device_time_total / 1e3
        fam["count"] += a.count
    busy = (f"device busy in one profiled forward: {busy_ms:.3f} ms (idle share "
            f"{1 - busy_ms / fwd_ms:.3f} of the steady forward)" if busy_ms > 0
            else "the profiler traced no device time: idle share not measured")
    print(f"{label}: steady forward of one batch of {MAX_BATCH} (host clock, 5 runs): "
          f"{fwd_ms:.3f} ms; {busy}")
    for t in top:
        print(f"  {t['ms']:.3f} ms x{t['count']}  {t['name'][:90]}")
    print("  device ms by kernel: " + "; ".join(f"{fam} {v['ms']:.3f} (x{v['count']})"
                                                 for fam, v in sorted(families.items())))
    return fwd_ms, busy_ms, top, families


def hold_halo_conv(torch, F, gen, case: dict) -> dict:
    """One K2 shape on the card, float32 (TF32 off) and bfloat16: the kernel
    against its plain version (an error beyond TOL is fatal), then the mean
    times of the kernel, the plain version and F.conv2d on the concatenated
    slab, beside the bound.  Returns the float32 row, with the bfloat16
    error and time in it."""
    from repro_torch.kernels.halo_conv import halo_conv2d_cuda, halo_conv2d_ref
    from repro_torch.kernels.halo_conv.ops import launch_config

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
        config = launch_config(x, top, bot, wt, **kw)
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
        t_ffma = max(bound_ms(flops, nbytes, dname, ffma=True))
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"halo {dname:8s} {case.get('layer', '-')} {case['layout'] or 'extra'} "
              f"x{[n, hs, w, cin]} -> {cout} k{k} s{s} p{p} g{groups} lo{lo} hi{hi}"
              f"{' bottom-absent' if absent else ''} x{case['per_forward']}/fwd "
              f"S={config['splits']} {config['gather']}: max_err {err:.3g} "
              f"kernel {t_kernel:.4f} ms ({flops / t_kernel / 1e9:.1f} TFLOP/s) plain {t_plain:.4f} ms "
              f"F.conv2d {t_lib:.4f} ms bound {t_bound:.4f} ms ({by}; FFMA {t_ffma:.4f})")
        out[dname] = dict(shape=[n, hs, w, cin, cout], k=k, stride=s, pad=p, groups=groups, lo=lo,
                          hi=hi, bottom_absent=bool(absent), layer=case.get("layer"),
                          layout=case["layout"], valid_rows=case.get("valid_rows"),
                          dtype=dname, per_forward=case["per_forward"], max_abs_err=err, ms=t_kernel,
                          plain_ms=t_plain, library_ms=t_lib, bound_ms=t_bound, ops_ms=ops_ms,
                          bytes_ms=bytes_ms, bound_by=by, ffma_bound_ms=t_ffma, **config,
                          tflops=flops / t_kernel / 1e9)
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
    the ViT's and the LM's attention hand the kernel; with ``cache`` slots,
    k and v are the first S rows of a [B, cache, Hkv*D] KV cache (a decode
    step's view).  With ``dv`` (MLA: query/key width 192, value width 128)
    v is the last dv of each head's ``v_width`` values (the value half of
    MLA's [k_nope | v] expansion, a strided view).  At a main path's shapes
    the kernel's and SDPA's device us per call (a profiler window), SDPA's
    backend, the wrapper's host us per call and the largest |score| are
    added.  Returns the float32 row, with the bfloat16 error and times in it."""
    from repro_torch.kernels.attention import attention_ref, flash_attention, gqa_flash
    from repro_torch.kernels.attention.ops import launch_config

    b, h, hkv, t, s, d, causal = (case[key] for key in ("b", "h", "hkv", "t", "s", "d", "causal"))
    dv = case.get("dv", d)
    vw = case.get("v_width", dv)
    g = h // hkv
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).removeprefix("torch.")
        q, k, v = (torch.randn((b, rows, heads * w), generator=gen, device="cuda").to(dt)[:, :n]
                   .view(b, n, heads, w)[..., w - width:].transpose(1, 2)
                   for n, rows, heads, w, width in ((t, t, h, d, d), (s, case.get("cache") or s, hkv, d, d),
                                                    (s, case.get("cache") or s, hkv, vw, dv)))
        kr, vr = (x.repeat_interleave(g, dim=1) for x in (k, v))

        def kernel():
            if g == 1:
                return flash_attention(q, k, v, causal=causal)
            # gqa_flash takes the model layout [B, T, H, D]
            return gqa_flash(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=causal).transpose(1, 2)

        config = launch_config(q, k, v, causal=causal)
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
        flops = 2.0 * b * h * attention_pairs(t, s, causal) * (d + dv)
        nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) * q.element_size()  # q, k, v in; o out
        ops_ms, bytes_ms = bound_ms(flops, nbytes, dname)
        t_bound = max(ops_ms, bytes_ms)
        t_ffma = max(bound_ms(flops, nbytes, dname, ffma=True))
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        extra = {}
        if case["path"]:
            scores = torch.einsum("bhtd,bhsd->bhts", q.float(), kr.float()) / math.sqrt(d)
            extra = dict(device_us=device_us(torch, kernel), host_us=host_us(torch, kernel),
                         library_device_us=device_us(
                             torch, lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=causal)),
                         library_backend=sdpa_backend(
                             torch, lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=causal)),
                         max_abs_score=scores.abs().max().item())
            del scores
        print(f"attn {dname:8s} {case['path'] or 'extra'} B{b} H{h}/{hkv} T{t} S{s} D{d}"
              f"{f' DV{dv} (of {vw})' if dv != d else ''}"
              f"{' causal' if causal else ''}{' cache ' + str(case['cache']) if case.get('cache') else ''} "
              f"x{case['per_forward']}/fwd [{config['block']}, "
              f"{config['blocks']} blocks]: max_err {err:.3g} "
              f"kernel {t_kernel:.4f} ms ({flops / t_kernel / 1e9:.2f} TFLOP/s) plain {t_plain:.4f} ms "
              f"SDPA {t_lib:.4f} ms bound {t_bound:.4f} ms ({by}; FFMA {t_ffma:.4f})"
              + (f"; device us/call kernel {extra['device_us']:.2f} SDPA {extra['library_device_us']:.2f} "
                 f"({extra['library_backend']}), "
                 f"wrapper host us/call {extra['host_us']:.2f}, max |score| {extra['max_abs_score']:.3g}"
                 if extra else ""))
        out[dname] = dict(b=b, h=h, hkv=hkv, t=t, s=s, d=d, dv=dv, causal=causal, path=case["path"],
                          cache=case.get("cache"),
                          dtype=dname, per_forward=case["per_forward"], max_abs_err=err, ms=t_kernel,
                          plain_ms=t_plain, library_ms=t_lib, bound_ms=t_bound, ops_ms=ops_ms,
                          bytes_ms=bytes_ms, bound_by=by, ffma_bound_ms=t_ffma,
                          tflops=flops / t_kernel / 1e9, **config, **extra)
    bf16 = out["bfloat16"]
    return dict(out["float32"], bf16_max_abs_err=bf16["max_abs_err"], bf16_ms=bf16["ms"],
                bf16_library_ms=bf16["library_ms"], bf16_bound_ms=bf16["bound_ms"],
                **{f"bf16_{key}": bf16[key] for key in ("device_us", "library_device_us", "host_us")
                   if key in bf16})


def sdpa_ops(prof) -> list:
    """The rows of a profile that are operators of F.scaled_dot_product_attention."""
    return [a.key for a in prof.key_averages() if any(op in a.key for op in SDPA_OPS)]


def sdpa_backend(torch, fn) -> str:
    """Which of SDPA's backends one call of ``fn`` ran: the names of its
    operators in a profile, past the dispatcher's own (``math`` when it
    launched none of the fused ones)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({n.removeprefix("aten::") for n in sdpa_ops(prof)} - {"scaled_dot_product_attention"})
    fused = [n for n in names if "math" not in n]
    return ", ".join(fused) if fused else "math"


def with_plain_attention(fn):
    """``fn()`` with the LM's attention through K3's plain version on the
    same device (the KV heads repeated), then K3 restored."""
    from repro_torch.kernels.attention import attention_ref, gqa_flash
    from repro_torch.models import attention as lm_attention

    def plain_gqa(q, k, v, *, causal):
        g = q.shape[2] // k.shape[2]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return attention_ref(qt, kt.repeat_interleave(g, dim=1), vt.repeat_interleave(g, dim=1),
                             causal=causal).transpose(1, 2)

    lm_attention.gqa_flash = plain_gqa
    try:
        return fn()
    finally:
        lm_attention.gqa_flash = gqa_flash


class RouteRecorder:
    """Records the routing of every MoE layer that runs while it is entered,
    in order: the router's ids [T, k] and probabilities [T, E] and the
    dispatch's keep mask [T, k].  It wraps the port's ``moe.router_topk`` and
    ``moe._dispatch``, as phase 7 swaps ``gqa_flash``: the port's API does
    not grow for it, and nothing is read back during the run."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.layers = moe, []

    def __enter__(self):
        topk, dispatch = self.saved = self.moe.router_topk, self.moe._dispatch

        def router_topk(p, cfg, x):
            gates, ids, probs = topk(p, cfg, x)
            self.layers.append({"ids": ids, "probs": probs})
            return gates, ids, probs

        def _dispatch(ids, e, capacity):
            out = dispatch(ids, e, capacity)
            self.layers[-1]["keep"] = out[2]
            return out

        self.moe.router_topk, self.moe._dispatch = router_topk, _dispatch
        return self

    def __exit__(self, *exc):
        self.moe.router_topk, self.moe._dispatch = self.saved
        return False

    def host(self) -> list:
        """The records as numpy arrays, one dict per layer."""
        return [{k: v.cpu().numpy() for k, v in rec.items()} for rec in self.layers]


def route_rows(records: list, shape: tuple, rows) -> list:
    """Records over [B*T] tokens (token-major) cut to ``rows``, an index into
    the [B, T] grid (e.g. ``np.s_[:1, :16]``), flattened again."""
    return [{k: v.reshape(shape + v.shape[1:])[rows].reshape((-1,) + v.shape[1:]) for k, v in rec.items()}
            for rec in records]


def compare_routes(ref: list, got: list, b: int, t: int) -> dict:
    """Two runs' routes over the same B x T tokens (token-major), layer by
    layer.  A position's output differs after a layer where its chosen or
    its kept experts (as sets) differ, or where a position of its causal
    past differed after the layer before (attention carries it).  A chosen
    expert that differs at a position whose input did not differ is a first
    flip; its gap is the reference's probability of the expert it chose
    minus that of the one the other run chose (a near-tie below NEAR_TIE).
    Returns the count of differing (layer, token, choice) routes, the first
    flips, their largest gap, and the [B, T] mask ``held`` of the positions
    no difference reaches."""
    out = np.zeros((b, t), bool)  # the output differs after this layer
    n_routes, gaps = 0, []
    for r, g in zip(ref, got):
        chose = (np.sort(r["ids"], 1) != np.sort(g["ids"], 1)).any(1)
        kept = (np.sort(np.where(r["keep"], r["ids"], -1), 1)
                != np.sort(np.where(g["keep"], g["ids"], -1), 1)).any(1)
        tainted = np.maximum.accumulate(out, axis=1).reshape(-1)
        for n in np.flatnonzero(chose):
            only_ref = np.setdiff1d(r["ids"][n], g["ids"][n])
            only_got = np.setdiff1d(g["ids"][n], r["ids"][n])
            n_routes += len(only_ref)
            if not tainted[n]:
                gaps.append(float(r["probs"][n, only_ref].max() - r["probs"][n, only_got].min()))
        out = np.maximum.accumulate(out, axis=1) | (chose | kept).reshape(b, t)
    return dict(routes=n_routes, first_flips=len(gaps), worst_gap=max(gaps, default=0.0), held=~out)


def route_agreement(ref: list, got: list) -> float:
    """The share of (layer, token) whose chosen experts (as sets) agree."""
    same = [(np.sort(r["ids"], 1) == np.sort(g["ids"], 1)).all(1) for r, g in zip(ref, got)]
    return float(np.concatenate(same).mean())


def abs_quantiles(torch, diff, qs=(0.5, 0.99)) -> list:
    """Quantiles of the elements of ``diff`` (every logit), by a sort on the card."""
    s = torch.sort(diff.flatten()).values
    return [s[round(q * (s.numel() - 1))].item() for q in qs]



def hold_routed(torch, label: str, err_bt, ref: list, got: list, b: int, t: int, scale: float) -> dict:
    """Holds a float32 comparison of two runs over B x T positions route by
    route: every first flip must be a near-tie, and the largest of
    ``err_bt`` ([B, T], each position's max |logit diff|) over the positions
    no routing difference reaches must be within DEPTH_RTOL x ``scale``.
    Prints the counts; returns them with the held mask."""
    cmp = compare_routes(ref, got, b, t)
    held = torch.from_numpy(cmp["held"])
    check(bool(held.any()), f"{label}: routing differences reach every position")
    err = err_bt[held].max().item()
    excluded = int((~held).sum())
    print(f"  {label}: routes differing {cmp['routes']} (first flips {cmp['first_flips']}, largest gap "
          f"{cmp['worst_gap']:.3g}, limit {NEAR_TIE}); positions excluded {excluded} of {b * t}; max |diff| "
          f"at the held positions {err:.4g} (max |logit| {scale:.4g}, limit {DEPTH_RTOL} x that)")
    check(cmp["worst_gap"] < NEAR_TIE, f"{label}: a route flipped that is no near-tie")
    check(err <= DEPTH_RTOL * scale, f"{label}: the logits drift")
    return dict(routes_differing=cmp["routes"], first_flips=cmp["first_flips"], worst_gap=cmp["worst_gap"],
                excluded=excluded, positions=b * t, max_abs=err, max_abs_logit=scale, held=cmp["held"])


def hold_decode(torch, prefill, decode, params, cfg, cache, tokens, logits, routes: list, scale: float):
    """DECODE_STEPS teacher-forced decode steps of an MoE LM from its empty
    ``cache``, K3 once a layer a step, held route by route.  A decode step's
    LM_BATCH tokens route drop-free (<= dropless_below), and so does a
    prefill of the first DECODE_STEPS tokens (LM_BATCH x DECODE_STEPS
    tokens, at the limit): the reference the decode is held to.  The
    LM_LEN-token prefill (``logits``, ``routes``) drops pairs past an
    expert's capacity, and the decode agrees with it only where no dropped
    route reaches: that comparison is printed with the positions whose
    causal past had a dropped route, its held positions gated all the same.
    Returns the two holds and the K3 launches."""
    from repro_torch.kernels.attention import flash_attention

    n_moe = cfg.n_moe_layers
    check(LM_BATCH * DECODE_STEPS <= cfg.moe.dropless_below, "the short prefill would drop routes")
    with RouteRecorder() as rec:
        short = prefill.fn(params, tokens[:, :DECODE_STEPS])
    short_routes = rec.host()
    check(all(r["keep"].all() for r in short_routes), "the short prefill dropped a route")
    flash_attention.launches = 0
    errs, errs_full = [], []
    with RouteRecorder() as rec:
        for i in range(DECODE_STEPS):
            step_logits, cache = decode.fn(params, cache, tokens[:, i:i + 1], i)
            errs.append((step_logits - short[:, i]).abs().amax(-1))
            errs_full.append((step_logits - logits[:, i]).abs().amax(-1))
        torch.cuda.synchronize()
    n_decode = flash_attention.launches
    print(f"  {DECODE_STEPS} decode steps: K3 launches {n_decode} ({cfg.n_layers} per step)")
    check(n_decode == cfg.n_layers * DECODE_STEPS, f"MoE decode launched K3 {n_decode} times")
    steps = rec.host()  # step-major: DECODE_STEPS x n_moe records over [LM_BATCH] tokens
    dec_routes = [{key: np.stack([steps[i * n_moe + layer][key] for i in range(DECODE_STEPS)], axis=1)
                   .reshape((LM_BATCH * DECODE_STEPS,) + steps[layer][key].shape[1:]) for key in steps[layer]}
                  for layer in range(n_moe)]
    vs_short = hold_routed(torch, f"decode vs the drop-free prefill of tokens 0..{DECODE_STEPS - 1}",
                           torch.stack(errs, dim=1).cpu(), short_routes, dec_routes, LM_BATCH, DECODE_STEPS,
                           short.abs().max().item())
    check(vs_short["excluded"] <= MAX_EXCLUDED * LM_BATCH * DECODE_STEPS,
          f"decode vs the drop-free prefill excluded {vs_short['excluded']} positions")
    prefill_first = route_rows(routes, (LM_BATCH, LM_LEN), np.s_[:, :DECODE_STEPS])
    vs_prefill = hold_routed(torch, f"decode vs the {LM_LEN}-token prefill (held where no difference reaches)",
                             torch.stack(errs_full, dim=1).cpu(), prefill_first, dec_routes, LM_BATCH,
                             DECODE_STEPS, scale)
    dropped_past = np.maximum.accumulate(
        np.stack([~r["keep"].all(1) for r in prefill_first]).any(0).reshape(LM_BATCH, DECODE_STEPS), axis=1)
    print(f"    positions whose causal past had a route the {LM_LEN}-token prefill dropped: "
          f"{int(dropped_past.sum())} of {LM_BATCH * DECODE_STEPS} (per batch element "
          f"{dropped_past.sum(1).tolist()})")
    check(not dropped_past[0].any(), "the prefill dropped a route of batch element 0's first tokens")
    vs_prefill["dropped_past"] = int(dropped_past.sum())
    return vs_short, vs_prefill, n_decode


def moe_bounds(cfg, n_params: int, capacity: int, elem_bytes: int) -> dict:
    """What one prefill of LM_BATCH x LM_LEN tokens and one decode step of
    LM_BATCH tokens at position DECODE_STEPS must do in JAX's design, which
    runs every slot of the [E, C] table (C = ``capacity`` in the prefill,
    the batch in a decode step): the operations of the dense products,
    the attention and the head, and the bytes of every weight read once
    (the embedding: its rows only)."""
    e, d, f, k = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff, cfg.moe.top_k
    hd = cfg.n_heads * cfg.d_head

    def flops(tokens, slots, pairs):
        per_layer = (2 * tokens * d * (hd + 2 * cfg.n_kv_heads * cfg.d_head + hd)  # q, k, v, o
                     + 4 * LM_BATCH * cfg.n_heads * pairs * cfg.d_head  # scores and PV
                     + 2 * tokens * d * e  # the router
                     + 3 * 2 * e * slots * d * f)  # w1, w3, w2 over the slot table
        return cfg.n_layers * per_layer + 2 * tokens * d * cfg.vocab

    weight_bytes = (n_params - cfg.vocab * d) * elem_bytes
    return dict(prefill_flops=flops(LM_BATCH * LM_LEN, capacity, attention_pairs(LM_LEN, LM_LEN, True)),
                decode_flops=flops(LM_BATCH, LM_BATCH, DECODE_STEPS + 1),
                decode_bytes=weight_bytes + LM_BATCH * d * elem_bytes)


def phase_moe(torch) -> tuple[dict, int]:
    """Phase 8: full-width moonshot-v1-16b-a3b (48 layers, d_model 2048, 16
    heads at d_head 128, 64 experts top-6 of d_ff 1408, vocab 163840; seeded
    random weights, 28.06 B parameters) through ``configs.steps.build`` at
    LM_BATCH x LM_LEN tokens.  (a) float32 at MOE_F32_LAYERS layers, every
    comparison route-aware (``hold_routed``): the prefill (K3 once a layer,
    no SDPA operator), the same forward with the plain attention on the
    card, the plain versions on the CPU over tokens 0..CPU_TOKENS-1 of batch
    element 0, DECODE_STEPS teacher-forced decode steps against the prefill
    (dropped routes excluded too), steady timing; then the bf16 forward at
    the same depth through K3 and through the plain attention, each held by
    the median and p99 of |diff| to the float32 forward of the same
    bf16-rounded weights.  (b) bfloat16 at all 48 layers: prefill and
    MOE_BF16_STEPS decode steps (48 K3 launches each, no SDPA operator,
    finite logits), the plain attention's forward as a record, peak device
    memory below the card's, steady timing.  Returns the report and the K3
    launches of its counted runs."""
    import dataclasses

    from repro_torch.configs import get as get_arch
    from repro_torch.configs.steps import build
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.models import transformer_lm as lm
    from repro_torch.models.common import tree_map

    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    arch = get_arch("moonshot-v1-16b-a3b")
    full = arch.cfg
    check((full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.d_head, full.vocab, full.first_k_dense,
           full.moe.n_experts, full.moe.top_k, full.moe.d_ff, full.moe.n_shared)
          == (48, 2048, 16, 16, 128, 163840, 0, 64, 6, 1408, 0), f"moonshot is not full width: {full}")
    cfg = dataclasses.replace(full, n_layers=MOE_F32_LAYERS)
    prefill = build(dataclasses.replace(arch, cfg=cfg), "prefill_32k", dtype=torch.float32)
    decode = build(dataclasses.replace(arch, cfg=cfg), "decode_32k", dtype=torch.float32)
    capacity = int(full.moe.capacity_factor * LM_BATCH * LM_LEN * full.moe.top_k / full.moe.n_experts)
    gen = torch.Generator(device="cuda").manual_seed(3)
    t0 = time.perf_counter()
    params = lm.init(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = dict_leaves(params)
    check([(tuple(x.shape), x.dtype) for x in leaves] == dict_leaves(prefill.state),
          "the weights do not match the bundle's shapes")
    n_params = sum(x.numel() for x in leaves)
    del leaves
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_LEN), generator=gen, device="cuda", dtype=torch.int32)
    print(f"moonshot-v1-16b-a3b at {cfg.n_layers} of {full.n_layers} layers, float32: {n_params / 1e9:.4f} B "
          f"parameters ({n_params * 4 / 1e9:.2f} GB) drawn on the card in {init_s:.2f} s; prefill of "
          f"{LM_BATCH} x {LM_LEN} tokens (capacity {capacity} slots per expert), {DECODE_STEPS} decode steps")
    launches = 0

    # (a1) the float32 prefill: K3 once per layer, no SDPA operator
    flash_attention.launches = 0
    with RouteRecorder() as rec, torch.profiler.profile(activities=acts) as prof:
        logits = prefill.fn(params, tokens)
        torch.cuda.synchronize()
    n_prefill = flash_attention.launches
    launches += n_prefill
    sdpa = sdpa_ops(prof)
    del prof
    routes = rec.host()
    dropped = [1 - float(r["keep"].mean()) for r in routes]
    print(f"  float32 prefill: K3 launches {n_prefill} (one per layer: {cfg.n_layers}); SDPA operators in its "
          f"profile: {sdpa or 'none'}; dropped share of (token, choice) pairs per layer: "
          f"{[round(x, 5) for x in dropped]}")
    check(n_prefill == cfg.n_layers, f"the MoE prefill launched K3 {n_prefill} times")
    check(not sdpa, f"the MoE prefill ran {sdpa}")
    check(len(routes) == cfg.n_layers, f"{len(routes)} MoE layers recorded")
    check(tuple(logits.shape) == (LM_BATCH, LM_LEN, cfg.vocab), f"MoE logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite MoE logits")
    scale = logits.abs().max().item()

    # (a2) the same forward with the plain attention on the card
    with RouteRecorder() as rec:
        plain = with_plain_attention(lambda: prefill.fn(params, tokens))
    vs_plain = hold_routed(torch, "vs the same forward with the plain attention on the card",
                           (logits - plain).abs().amax(-1).cpu(), rec.host(), routes, LM_BATCH, LM_LEN, scale)
    del plain

    # (a3) the plain versions on the CPU over tokens 0..CPU_TOKENS-1 of batch
    # element 0: below the capacity in token-major order, so never dropped
    t0 = time.perf_counter()
    cparams = tree_map(lambda x: x.cpu(), params)
    with RouteRecorder() as rec:
        clogits = lm.forward(cparams, cfg, tokens[:1, :CPU_TOKENS].cpu())[0]
    cpu_s = time.perf_counter() - t0
    del cparams
    first = route_rows(routes, (LM_BATCH, LM_LEN), np.s_[:1, :CPU_TOKENS])
    check(all(r["keep"].all() for r in first), "the prefill dropped a route of the CPU check's tokens")
    vs_cpu = hold_routed(torch, f"vs the plain versions on the CPU (float32, tokens 0..{CPU_TOKENS - 1} of "
                                f"batch element 0; {cpu_s:.1f} s with the host copy)",
                         (logits[:1, :CPU_TOKENS].cpu() - clogits).abs().amax(-1), rec.host(), first, 1,
                         CPU_TOKENS, clogits.abs().max().item())
    vs_cpu["cpu_s"] = cpu_s

    # (a4) teacher-forced decode from init_cache, held route by route
    cache = lm.init_cache(cfg, LM_BATCH, LM_LEN, device="cuda")
    check(sorted(cache) == ["moe"] and tuple(cache["moe"]["k"].shape)
          == (cfg.n_layers, LM_BATCH, LM_LEN, cfg.n_kv_heads, cfg.d_head), "the MoE cache's layout")
    vs_short, vs_prefill, n_decode = hold_decode(torch, prefill, decode, params, cfg, cache, tokens, logits,
                                                 routes, scale)
    launches += n_decode
    for r in (vs_plain, vs_cpu, vs_short, vs_prefill):
        del r["held"]

    # where the time goes: a steady float32 prefill and decode step
    bounds32 = moe_bounds(cfg, n_params, capacity, 4)
    pre_ms, pre_busy, pre_top, pre_fams = steady_and_profiled(
        torch, lambda: prefill.fn(params, tokens), f"moonshot float32 prefill ({cfg.n_layers} layers)")
    step_tok = tokens[:, DECODE_STEPS:DECODE_STEPS + 1]
    dec_ms, dec_busy, dec_top, dec_fams = steady_and_profiled(
        torch, lambda: decode.fn(params, cache, step_tok, DECODE_STEPS),
        f"moonshot float32 decode step ({cfg.n_layers} layers)")
    with torch.profiler.profile(activities=acts) as prof:
        decode.fn(params, cache, step_tok, DECODE_STEPS)
        torch.cuda.synchronize()
    check(not sdpa_ops(prof), f"the MoE decode step ran {sdpa_ops(prof)}")
    del prof, cache, logits
    print(f"  tokens/s: prefill {LM_BATCH * LM_LEN / pre_ms * 1e3:.1f}, decode {LM_BATCH / dec_ms * 1e3:.1f}; "
          f"bounds: prefill {bounds32['prefill_flops'] / 1e12:.3f} TFLOP, {bounds32['prefill_flops'] / FFMA_FLOPS * 1e3:.2f} "
          f"ms at the FFMA rate; decode step {bounds32['decode_bytes'] / 1e9:.2f} GB of weights, "
          f"{bounds32['decode_bytes'] / PEAK_BYTES_PER_S * 1e3:.2f} ms at the HBM rate")

    # (a5) bfloat16 at the same depth, held to the float32 forward of the
    # same bf16-rounded weights by the median and p99 of |diff| over every
    # logit: flips make a max meaningless here (it is printed all the same)
    bparams = tree_map(lambda x: x.to(torch.bfloat16), params)
    del params
    torch.cuda.empty_cache()
    rparams = tree_map(lambda x: x.float(), bparams)
    with RouteRecorder() as rec:
        rl = prefill.fn(rparams, tokens)
    r_routes = rec.host()
    del rparams
    torch.cuda.empty_cache()
    flash_attention.launches = 0
    with RouteRecorder() as rec:
        bl = prefill.fn(bparams, tokens)
        torch.cuda.synchronize()
    n_bf6 = flash_attention.launches
    launches += n_bf6
    check(n_bf6 == cfg.n_layers, f"the bf16 MoE prefill launched K3 {n_bf6} times")
    check(bl.dtype == torch.bfloat16 and bool(torch.isfinite(bl.float()).all()), "bad bf16 MoE logits")
    k_routes = rec.host()
    with RouteRecorder() as rec:
        bp = with_plain_attention(lambda: prefill.fn(bparams, tokens))
    p_routes = rec.host()
    r_scale = rl.abs().max().item()
    bf6 = {}
    for name, x, rts in (("k3", bl, k_routes), ("plain", bp, p_routes)):
        diff = (x.float() - rl).abs()
        med, p99 = abs_quantiles(torch, diff)
        bf6[name] = dict(median=med, p99=p99, max=diff.max().item(), route_agreement=route_agreement(r_routes, rts))
        del diff
    del bl, bp, rl, bparams
    torch.cuda.empty_cache()
    limits = {q: max(1.25 * bf6["plain"][q], BF16_RTOL * r_scale) for q in ("median", "p99")}
    print(f"  bfloat16 prefill at {cfg.n_layers} layers: K3 launches {n_bf6}; vs the float32 forward of the "
          f"bf16-rounded weights (max |logit| {r_scale:.4g}): K3 median {bf6['k3']['median']:.4g} p99 "
          f"{bf6['k3']['p99']:.4g} max {bf6['k3']['max']:.4g} routes agreeing {bf6['k3']['route_agreement']:.5f}; "
          f"plain attention median {bf6['plain']['median']:.4g} p99 {bf6['plain']['p99']:.4g} max "
          f"{bf6['plain']['max']:.4g} routes agreeing {bf6['plain']['route_agreement']:.5f}; limits (the larger "
          f"of 1.25 x the plain's and {BF16_RTOL} x max |logit|) median {limits['median']:.4g} p99 "
          f"{limits['p99']:.4g}")
    for q in ("median", "p99"):
        check(bf6["k3"][q] <= limits[q], f"the bf16 MoE forward's {q} |diff| exceeds its limit")
    bf6.update(limits=limits, max_abs_logit=r_scale, launches=n_bf6)

    # (b) bfloat16 at all 48 layers, drawn layer by layer in bf16 (the float32
    # expert stack alone would be 35 GB per matrix)
    prefill48 = build(arch, "prefill_32k", dtype=torch.bfloat16)
    decode48 = build(arch, "decode_32k", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = lm.init(gen, full, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init48_s = time.perf_counter() - t0
    leaves = dict_leaves(params)
    check([(tuple(x.shape), x.dtype) for x in leaves] == dict_leaves(prefill48.state),
          "the 48-layer weights do not match the bundle's shapes")
    n48 = sum(x.numel() for x in leaves)
    del leaves
    print(f"moonshot-v1-16b-a3b, all {full.n_layers} layers, bfloat16: {n48 / 1e9:.4f} B parameters "
          f"({n48 * 2 / 1e9:.2f} GB) drawn on the card in {init48_s:.2f} s")
    check(round(n48 / 1e9, 2) == 28.06, f"{n48} parameters, expected 28.06 B")
    flash_attention.launches = 0
    with RouteRecorder() as rec, torch.profiler.profile(activities=acts) as prof:
        bl48 = prefill48.fn(params, tokens)
        torch.cuda.synchronize()
    n_bf_prefill = flash_attention.launches
    launches += n_bf_prefill
    sdpa48 = sdpa_ops(prof)
    del prof
    routes48 = rec.host()
    dropped48 = [1 - float(r["keep"].mean()) for r in routes48]
    print(f"  bf16 prefill: K3 launches {n_bf_prefill} (one per layer: {full.n_layers}); SDPA operators in its "
          f"profile: {sdpa48 or 'none'}; dropped share per layer: min {min(dropped48):.5f} mean "
          f"{sum(dropped48) / len(dropped48):.5f} max {max(dropped48):.5f}")
    check(n_bf_prefill == full.n_layers, f"the 48-layer prefill launched K3 {n_bf_prefill} times")
    check(not sdpa48, f"the 48-layer prefill ran {sdpa48}")
    check(tuple(bl48.shape) == (LM_BATCH, LM_LEN, full.vocab), f"48-layer logits {tuple(bl48.shape)}")
    check(bool(torch.isfinite(bl48.float()).all()), "non-finite 48-layer logits")
    with RouteRecorder() as rec:
        bp48 = with_plain_attention(lambda: prefill48.fn(params, tokens))
    diff = (bl48.float() - bp48.float()).abs()
    med48, p9948 = abs_quantiles(torch, diff)
    rec48 = dict(route_agreement=route_agreement(rec.host(), routes48), median=med48, p99=p9948,
                 max=diff.max().item(), max_abs_logit=bl48.abs().max().item())
    del diff, bp48
    print(f"  bf16 prefill vs the plain attention's bf16 prefill (a record, no gate): routes agreeing "
          f"{rec48['route_agreement']:.5f}; |diff| median {med48:.4g} p99 {p9948:.4g} max {rec48['max']:.4g} "
          f"(max |logit| {rec48['max_abs_logit']:.4g})")
    cache = lm.init_cache(full, LM_BATCH, LM_LEN, dtype=torch.bfloat16, device="cuda")
    flash_attention.launches = 0
    outs = []
    for i in range(MOE_BF16_STEPS):
        step_logits, cache = decode48.fn(params, cache, tokens[:, i:i + 1], i)
        outs.append(step_logits)
    torch.cuda.synchronize()
    n_bf_decode = flash_attention.launches
    launches += n_bf_decode
    outs = torch.stack(outs, dim=1).float()  # [LM_BATCH, MOE_BF16_STEPS, V]
    # records: the gap to the 512-token prefill, which drops routes, and to
    # a drop-free prefill of the decoded tokens alone
    gaps = (outs - bl48[:, :MOE_BF16_STEPS].float()).abs().amax(-1).cpu()
    short_gaps = (outs - prefill48.fn(params, tokens[:, :MOE_BF16_STEPS]).float()).abs().amax(-1).cpu()
    print(f"  {MOE_BF16_STEPS} bf16 decode steps: K3 launches {n_bf_decode} ({full.n_layers} per step); "
          f"max |decode - prefill| per position (records): against the {LM_LEN}-token prefill median "
          f"{gaps.median().item():.4g} max {gaps.max().item():.4g}; against a drop-free prefill of the "
          f"{MOE_BF16_STEPS} tokens median {short_gaps.median().item():.4g} max {short_gaps.max().item():.4g}")
    check(n_bf_decode == full.n_layers * MOE_BF16_STEPS, f"the 48-layer decode launched K3 {n_bf_decode} times")
    check(bool(torch.isfinite(outs).all()), "non-finite 48-layer decode logits")
    with torch.profiler.profile(activities=acts) as prof:
        decode48.fn(params, cache, step_tok, DECODE_STEPS)
        torch.cuda.synchronize()
    check(not sdpa_ops(prof), f"the 48-layer decode step ran {sdpa_ops(prof)}")
    del prof, bl48, outs

    # (c) where the time goes at 48 layers
    bounds16 = moe_bounds(full, n48, capacity, 2)
    bf_ms, bf_busy, bf_top, bf_fams = steady_and_profiled(
        torch, lambda: prefill48.fn(params, tokens), f"moonshot bfloat16 prefill ({full.n_layers} layers)")
    bd_ms, bd_busy, bd_top, bd_fams = steady_and_profiled(
        torch, lambda: decode48.fn(params, cache, step_tok, DECODE_STEPS),
        f"moonshot bfloat16 decode step ({full.n_layers} layers)")
    print(f"  tokens/s: bf16 prefill {LM_BATCH * LM_LEN / bf_ms * 1e3:.1f}, decode {LM_BATCH / bd_ms * 1e3:.1f}; "
          f"bounds: prefill {bounds16['prefill_flops'] / 1e12:.3f} TFLOP, "
          f"{bounds16['prefill_flops'] / PEAK_FLOPS['bfloat16'] * 1e3:.2f} ms at the bf16 rate; decode step "
          f"{bounds16['decode_bytes'] / 1e9:.2f} GB of weights, "
          f"{bounds16['decode_bytes'] / PEAK_BYTES_PER_S * 1e3:.2f} ms at the HBM rate")
    del params, cache
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    phase_s = time.perf_counter() - t_start
    print(f"  phase 8: {phase_s:.1f} s, peak device memory allocated {peak / 1e9:.2f} GB of {total / 1e9:.2f}")
    check(peak < total, "phase 8 peaked above the card's memory")

    def timing(ms, busy, top, fams, tokens_per_call):
        return dict(steady_ms=ms, device_busy_ms=busy, top_device=top, device_ms_by_kernel=fams,
                    tokens_per_s=tokens_per_call / ms * 1e3)

    report = dict(
        phase_s=phase_s, peak_device_gb=peak / 1e9, capacity=capacity, f32_layers=cfg.n_layers,
        n_params_f32=n_params, n_params=n48, init_s=init_s, init48_s=init48_s, batch=LM_BATCH, seq_len=LM_LEN,
        decode_steps=DECODE_STEPS, bf16_decode_steps=MOE_BF16_STEPS, prefill_launches=n_prefill,
        decode_launches=n_decode, bf16_prefill_launches=n_bf_prefill, bf16_decode_launches=n_bf_decode,
        sdpa_ops=sdpa + sdpa48, dropped_frac=dropped, dropped_frac_48=dropped48, max_abs_logit=scale,
        vs_plain=vs_plain, vs_cpu=vs_cpu, vs_short_prefill=vs_short, vs_prefill=vs_prefill, bf16_6=bf6, bf16_48_vs_plain=rec48,
        bf16_48_decode_gap_max=gaps.max().item(), bf16_48_decode_short_gap_max=short_gaps.max().item(), bounds_f32=bounds32, bounds_bf16=bounds16,
        prefill=timing(pre_ms, pre_busy, pre_top, pre_fams, LM_BATCH * LM_LEN),
        decode=timing(dec_ms, dec_busy, dec_top, dec_fams, LM_BATCH),
        bf16_prefill=timing(bf_ms, bf_busy, bf_top, bf_fams, LM_BATCH * LM_LEN),
        bf16_decode=timing(bd_ms, bd_busy, bd_top, bd_fams, LM_BATCH),
    )
    return report, launches


def round_to_bf16_(torch, x, chunk: int = 1 << 26) -> None:
    """Round a float32 tensor to bfloat16-representable values in place, a
    chunk at a time (one expert leaf of DeepSeek-V3 is 15.0 GB)."""
    for part in x.view(-1).split(chunk):
        part.copy_(part.to(torch.bfloat16))


def mla_bounds(cfg, n_params: int, capacity: int, elem_bytes: int) -> dict:
    """What one prefill of LM_BATCH x LM_LEN tokens and one decode step at
    position DECODE_STEPS of DeepSeek-V3's cut must do in JAX's design (the
    MoE layers run every slot of the [E, C] table): the operations of the
    products, the attention and the head, and the bytes of every weight
    read once (the embedding: its rows only)."""
    m, d = cfg.mla, cfg.d_model
    h = cfg.n_heads
    attn_macs = (d * m.q_lora_rank + m.q_lora_rank * h * m.qk_head_dim + d * m.kv_lora_rank
                 + d * m.qk_rope_head_dim + h * m.v_head_dim * d)  # per token; + wukv per key row
    ukv_macs = m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
    e, f = cfg.moe.n_experts, cfg.moe.d_ff

    def flops(tokens, keys, pairs, slots):
        per_layer = 2 * tokens * attn_macs + 2 * keys * ukv_macs + 2 * LM_BATCH * h * pairs * (
            m.qk_head_dim + m.v_head_dim)
        dense = per_layer + 2 * tokens * 3 * d * cfg.d_ff
        moe_layer = per_layer + 2 * tokens * d * e + 2 * 3 * d * f * (e * slots + tokens * cfg.moe.n_shared)
        return cfg.n_dense_layers * dense + cfg.n_moe_layers * moe_layer + 2 * tokens * d * cfg.vocab

    weight_bytes = (n_params - cfg.vocab * d) * elem_bytes
    return dict(prefill_flops=flops(LM_BATCH * LM_LEN, LM_BATCH * LM_LEN, attention_pairs(LM_LEN, LM_LEN, True),
                                    capacity),
                decode_flops=flops(LM_BATCH, LM_BATCH * (DECODE_STEPS + 1), DECODE_STEPS + 1, LM_BATCH),
                decode_bytes=weight_bytes + LM_BATCH * d * elem_bytes)


def phase_mla(torch) -> tuple[dict, dict]:
    """Phase 9: full-width DeepSeek-V3 (d_model 7168, MLA with 128 heads,
    q_lora 1536, kv_lora 512, no-RoPE 128 / RoPE 64 / value 128; d_ff 18432
    in the 3 dense layers; 256 routed experts top-8 of d_ff 2048 and 1
    shared expert, router bias, capacity factor 1.25; vocab 129280; seeded
    random weights) through ``configs.steps.build`` at LM_BATCH x LM_LEN
    tokens, cut to MLA_LAYERS layers (3 dense + 1 MoE) and no MTP head.
    (a) float32, its weights first rounded to bf16 values in place: the
    prefill (K3 once a layer, no SDPA operator, the MoE layer's dropped
    share), held route by route against the same forward with the plain
    attention on the card; the 3 dense layers alone against the plain
    versions on the CPU over tokens 0..CPU_TOKENS-1 of batch element 0;
    DECODE_STEPS teacher-forced decode steps from the latent cache
    (``hold_decode``); steady timing.  (b) bfloat16, the weights converted
    leaf by leaf: a prefill and MLA_BF16_STEPS decode steps (K3 once a layer
    each, no SDPA operator, finite logits), the prefill held to (a)'s by the
    median and p99 of |diff|; steady timing.  (c) peak device memory below
    the card's.  Returns the report and the K3 launches of its counted runs
    by run."""
    import dataclasses

    from repro_torch.configs import get as get_arch
    from repro_torch.configs.steps import build
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.models import transformer_lm as lm
    from repro_torch.models.common import tree_map

    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    arch = get_arch("deepseek-v3-671b")
    full = arch.cfg
    m, moe_cfg = full.mla, full.moe
    check((full.n_layers, full.d_model, full.n_heads, m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
           m.qk_rope_head_dim, m.v_head_dim, full.d_ff, moe_cfg.n_experts, moe_cfg.top_k, moe_cfg.d_ff,
           moe_cfg.n_shared, moe_cfg.router_bias, moe_cfg.capacity_factor, full.vocab, full.first_k_dense,
           full.mtp_depth)
          == (61, 7168, 128, 1536, 512, 128, 64, 128, 18432, 256, 8, 2048, 1, True, 1.25, 129280, 3, 1),
          f"deepseek-v3-671b is not full width: {full}")
    cfg = dataclasses.replace(full, n_layers=MLA_LAYERS, mtp_depth=0)
    print(f"deepseek-v3-671b cut: n_layers {full.n_layers} -> {cfg.n_layers} ({cfg.n_dense_layers} dense + "
          f"{cfg.n_moe_layers} MoE), mtp_depth {full.mtp_depth} -> 0 (read by training only); every width full")
    cut = dataclasses.replace(arch, cfg=cfg)
    prefill = build(cut, "prefill_32k", dtype=torch.float32)
    decode = build(cut, "decode_32k", dtype=torch.float32)
    check(decode.inputs["cache"] == {
        key: ((n, 128, 32768, m.kv_lora_rank + m.qk_rope_head_dim), torch.float32)
        for key, n in (("dense", cfg.n_dense_layers), ("moe", cfg.n_moe_layers))}, "the latent cache spec")
    capacity = int(moe_cfg.capacity_factor * LM_BATCH * LM_LEN * moe_cfg.top_k / moe_cfg.n_experts)
    gen = torch.Generator(device="cuda").manual_seed(4)
    t0 = time.perf_counter()
    params = lm.init(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = dict_leaves(params)
    check([(tuple(x.shape), x.dtype) for x in leaves] == dict_leaves(prefill.state),
          "the weights do not match the bundle's shapes")
    n_params = sum(x.numel() for x in leaves)
    check(round(n_params / 1e9, 2) == 15.11, f"{n_params} parameters, expected 15.11 B")
    # bf16-representable float32 weights: (b) is then held to (a)'s forward
    for x in leaves:
        round_to_bf16_(torch, x)
    del leaves
    peak_init = torch.cuda.max_memory_allocated()
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_LEN), generator=gen, device="cuda", dtype=torch.int32)
    print(f"deepseek-v3-671b at {cfg.n_layers} of {full.n_layers} layers, float32: {n_params / 1e9:.4f} B "
          f"parameters ({n_params * 4 / 1e9:.2f} GB) drawn on the card in {init_s:.2f} s (peak "
          f"{peak_init / 1e9:.2f} GB), rounded to bf16 values; prefill of {LM_BATCH} x {LM_LEN} tokens "
          f"(capacity {capacity} slots per expert), {DECODE_STEPS} decode steps")
    launches = {}

    # (a1) the float32 prefill: K3 once per layer, no SDPA operator
    flash_attention.launches = 0
    with RouteRecorder() as rec, torch.profiler.profile(activities=acts) as prof:
        logits = prefill.fn(params, tokens)
        torch.cuda.synchronize()
    launches["prefill"] = flash_attention.launches
    sdpa = sdpa_ops(prof)
    del prof
    routes = rec.host()
    dropped = [1 - float(r["keep"].mean()) for r in routes]
    print(f"  float32 prefill: K3 launches {launches['prefill']} (one per layer: {cfg.n_layers}); SDPA operators "
          f"in its profile: {sdpa or 'none'}; dropped share of the MoE layer's (token, choice) pairs: "
          f"{[round(x, 5) for x in dropped]}")
    check(launches["prefill"] == cfg.n_layers, f"the MLA prefill launched K3 {launches['prefill']} times")
    check(not sdpa, f"the MLA prefill ran {sdpa}")
    check(len(routes) == cfg.n_moe_layers, f"{len(routes)} MoE layers recorded")
    check(tuple(logits.shape) == (LM_BATCH, LM_LEN, cfg.vocab), f"MLA logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite MLA logits")
    scale = logits.abs().max().item()

    # (a2) the same forward with the plain attention on the card
    with RouteRecorder() as rec:
        plain = with_plain_attention(lambda: prefill.fn(params, tokens))
    vs_plain = hold_routed(torch, "vs the same forward with the plain attention on the card",
                           (logits - plain).abs().amax(-1).cpu(), rec.host(), routes, LM_BATCH, LM_LEN, scale)
    del plain

    # (a3) the 3 dense layers alone: the card's forward of that cut against
    # the plain versions on the CPU over tokens 0..CPU_TOKENS-1 of batch element 0
    cfg3 = dataclasses.replace(cfg, n_layers=cfg.first_k_dense)
    p3 = {k: params[k] for k in ("embed", "final_norm", "lm_head", "dense_layers")}
    dense_logits = lm.forward(p3, cfg3, tokens[:1, :CPU_TOKENS])[0].cpu()
    t0 = time.perf_counter()
    cparams = tree_map(lambda x: x.cpu(), p3)
    clogits = lm.forward(cparams, cfg3, tokens[:1, :CPU_TOKENS].cpu())[0]
    cpu_s = time.perf_counter() - t0
    del cparams, p3
    c_err = (dense_logits - clogits).abs().max().item()
    c_scale = clogits.abs().max().item()
    print(f"  the {cfg3.n_layers} dense layers vs the plain versions on the CPU (float32, tokens 0..{CPU_TOKENS - 1} "
          f"of batch element 0; {cpu_s:.1f} s with the host copy): max |diff| {c_err:.4g} (max |logit| "
          f"{c_scale:.4g}, limit {DEPTH_RTOL} x that)")
    check(c_err <= DEPTH_RTOL * c_scale, "the dense MLA layers drift from the plain versions on the CPU")
    vs_cpu = dict(max_abs=c_err, max_abs_logit=c_scale, cpu_s=cpu_s, layers=cfg3.n_layers)

    # (a4) teacher-forced decode from the latent cache, held route by route
    cache = lm.init_cache(cfg, LM_BATCH, LM_LEN, device="cuda")
    width = m.kv_lora_rank + m.qk_rope_head_dim
    check({k: tuple(v.shape) for k, v in cache.items()}
          == {"dense": (3, LM_BATCH, LM_LEN, width), "moe": (1, LM_BATCH, LM_LEN, width)}, "the latent cache")
    vs_short, vs_prefill, launches["decode"] = hold_decode(torch, prefill, decode, params, cfg, cache, tokens,
                                                           logits, routes, scale)
    for r in (vs_plain, vs_short, vs_prefill):
        del r["held"]

    # where the time goes: a steady float32 prefill and decode step
    bounds32 = mla_bounds(cfg, n_params, capacity, 4)
    step_tok = tokens[:, DECODE_STEPS:DECODE_STEPS + 1]
    timing = {}
    timing["prefill"] = steady_and_profiled(torch, lambda: prefill.fn(params, tokens),
                                            f"deepseek-v3 float32 prefill ({cfg.n_layers} layers)")
    timing["decode"] = steady_and_profiled(torch, lambda: decode.fn(params, cache, step_tok, DECODE_STEPS),
                                           f"deepseek-v3 float32 decode step ({cfg.n_layers} layers)")
    with torch.profiler.profile(activities=acts) as prof:
        decode.fn(params, cache, step_tok, DECODE_STEPS)
        torch.cuda.synchronize()
    check(not sdpa_ops(prof), f"the MLA decode step ran {sdpa_ops(prof)}")
    del prof, cache
    print(f"  tokens/s: prefill {LM_BATCH * LM_LEN / timing['prefill'][0] * 1e3:.1f}, decode "
          f"{LM_BATCH / timing['decode'][0] * 1e3:.1f}; bounds: prefill {bounds32['prefill_flops'] / 1e12:.3f} "
          f"TFLOP, {bounds32['prefill_flops'] / PEAK_FLOPS['float32'] * 1e3:.2f} ms at the 3xTF32 rate, "
          f"{bounds32['prefill_flops'] / FFMA_FLOPS * 1e3:.2f} at the FFMA rate; decode step "
          f"{bounds32['decode_bytes'] / 1e9:.2f} GB of weights, "
          f"{bounds32['decode_bytes'] / PEAK_BYTES_PER_S * 1e3:.2f} ms at the HBM rate")

    # (b) bfloat16: each leaf converted, its float32 tensor freed before the
    # next (the peak stays near the float32 weights plus one leaf)
    def to_bf16(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                to_bf16(v)
            else:
                tree[k] = v.to(torch.bfloat16)
                del v

    to_bf16(params)
    torch.cuda.empty_cache()
    flash_attention.launches = 0
    with RouteRecorder() as rec, torch.profiler.profile(activities=acts) as prof:
        bl = prefill.fn(params, tokens)
        torch.cuda.synchronize()
    launches["bf16_prefill"] = flash_attention.launches
    sdpa_bf = sdpa_ops(prof)
    del prof
    k_routes = rec.host()
    check(launches["bf16_prefill"] == cfg.n_layers, f"the bf16 MLA prefill launched K3 "
                                                    f"{launches['bf16_prefill']} times")
    check(not sdpa_bf, f"the bf16 MLA prefill ran {sdpa_bf}")
    check(bl.dtype == torch.bfloat16 and bool(torch.isfinite(bl.float()).all()), "bad bf16 MLA logits")
    with RouteRecorder() as rec:
        bp = with_plain_attention(lambda: prefill.fn(params, tokens))
    p_routes = rec.host()
    bf = {}
    for name, x, rts in (("k3", bl, k_routes), ("plain", bp, p_routes)):
        diff = (x.float() - logits).abs()
        med, p99 = abs_quantiles(torch, diff)
        bf[name] = dict(median=med, p99=p99, max=diff.max().item(), route_agreement=route_agreement(routes, rts))
        del diff
    del bp
    limits = {q: max(1.25 * bf["plain"][q], BF16_RTOL * scale) for q in ("median", "p99")}
    print(f"  bfloat16 prefill: K3 launches {launches['bf16_prefill']}; vs the float32 forward of the same "
          f"(bf16-valued) weights (max |logit| {scale:.4g}): K3 median {bf['k3']['median']:.4g} p99 "
          f"{bf['k3']['p99']:.4g} max {bf['k3']['max']:.4g} routes agreeing {bf['k3']['route_agreement']:.5f}; "
          f"plain attention median {bf['plain']['median']:.4g} p99 {bf['plain']['p99']:.4g} max "
          f"{bf['plain']['max']:.4g} routes agreeing {bf['plain']['route_agreement']:.5f}; limits (the larger of "
          f"1.25 x the plain's and {BF16_RTOL} x max |logit|) median {limits['median']:.4g} p99 "
          f"{limits['p99']:.4g}")
    for q in ("median", "p99"):
        check(bf["k3"][q] <= limits[q], f"the bf16 MLA forward's {q} |diff| exceeds its limit")
    bf.update(limits=limits, max_abs_logit=scale)
    del logits
    prefill16 = build(cut, "prefill_32k", dtype=torch.bfloat16)
    decode16 = build(cut, "decode_32k", dtype=torch.bfloat16)
    cache = lm.init_cache(cfg, LM_BATCH, LM_LEN, dtype=torch.bfloat16, device="cuda")
    flash_attention.launches = 0
    outs = []
    for i in range(MLA_BF16_STEPS):
        step_logits, cache = decode16.fn(params, cache, tokens[:, i:i + 1], i)
        outs.append(step_logits)
    torch.cuda.synchronize()
    launches["bf16_decode"] = flash_attention.launches
    outs = torch.stack(outs, dim=1).float()
    # records: the gap to the 512-token bf16 prefill (which drops routes)
    # and to a drop-free bf16 prefill of the decoded tokens alone
    gaps = (outs - bl[:, :MLA_BF16_STEPS].float()).abs().amax(-1).cpu()
    short_gaps = (outs - prefill16.fn(params, tokens[:, :MLA_BF16_STEPS]).float()).abs().amax(-1).cpu()
    print(f"  {MLA_BF16_STEPS} bf16 decode steps: K3 launches {launches['bf16_decode']} ({cfg.n_layers} per step); "
          f"max |decode - prefill| per position (records): against the {LM_LEN}-token prefill median "
          f"{gaps.median().item():.4g} max {gaps.max().item():.4g}; against a drop-free prefill of the "
          f"{MLA_BF16_STEPS} tokens median {short_gaps.median().item():.4g} max {short_gaps.max().item():.4g}")
    check(launches["bf16_decode"] == cfg.n_layers * MLA_BF16_STEPS,
          f"the bf16 MLA decode launched K3 {launches['bf16_decode']} times")
    check(bool(torch.isfinite(outs).all()), "non-finite bf16 MLA decode logits")
    with torch.profiler.profile(activities=acts) as prof:
        decode16.fn(params, cache, step_tok, DECODE_STEPS)
        torch.cuda.synchronize()
    check(not sdpa_ops(prof), f"the bf16 MLA decode step ran {sdpa_ops(prof)}")
    del prof, bl, outs
    bounds16 = mla_bounds(cfg, n_params, capacity, 2)
    timing["bf16_prefill"] = steady_and_profiled(torch, lambda: prefill16.fn(params, tokens),
                                                 f"deepseek-v3 bfloat16 prefill ({cfg.n_layers} layers)")
    timing["bf16_decode"] = steady_and_profiled(
        torch, lambda: decode16.fn(params, cache, step_tok, DECODE_STEPS),
        f"deepseek-v3 bfloat16 decode step ({cfg.n_layers} layers)")
    print(f"  tokens/s: bf16 prefill {LM_BATCH * LM_LEN / timing['bf16_prefill'][0] * 1e3:.1f}, decode "
          f"{LM_BATCH / timing['bf16_decode'][0] * 1e3:.1f}; bounds: prefill "
          f"{bounds16['prefill_flops'] / PEAK_FLOPS['bfloat16'] * 1e3:.2f} ms at the bf16 rate; decode step "
          f"{bounds16['decode_bytes'] / 1e9:.2f} GB of weights, "
          f"{bounds16['decode_bytes'] / PEAK_BYTES_PER_S * 1e3:.2f} ms at the HBM rate")
    del params, cache
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    phase_s = time.perf_counter() - t_start
    print(f"  phase 9: {phase_s:.1f} s, peak device memory allocated {peak / 1e9:.2f} GB of {total / 1e9:.2f}")
    check(peak < total, "phase 9 peaked above the card's memory")
    tokens_per_call = {"prefill": LM_BATCH * LM_LEN, "decode": LM_BATCH, "bf16_prefill": LM_BATCH * LM_LEN,
                       "bf16_decode": LM_BATCH}
    report = dict(
        phase_s=phase_s, peak_device_gb=peak / 1e9, peak_init_gb=peak_init / 1e9, capacity=capacity,
        layers=cfg.n_layers, cut={"n_layers": [full.n_layers, cfg.n_layers], "mtp_depth": [full.mtp_depth, 0]},
        n_params=n_params, init_s=init_s, batch=LM_BATCH, seq_len=LM_LEN, decode_steps=DECODE_STEPS,
        bf16_decode_steps=MLA_BF16_STEPS, launches=launches, sdpa_ops=sdpa + sdpa_bf, dropped_frac=dropped,
        max_abs_logit=scale, vs_plain=vs_plain, vs_cpu=vs_cpu, vs_short_prefill=vs_short, vs_prefill=vs_prefill,
        bf16=bf, bf16_decode_gap_max=gaps.max().item(), bf16_decode_short_gap_max=short_gaps.max().item(),
        bounds_f32=bounds32, bounds_bf16=bounds16,
        **{name: dict(steady_ms=ms, device_busy_ms=busy, top_device=top, device_ms_by_kernel=fams,
                      tokens_per_s=tokens_per_call[name] / ms * 1e3)
           for name, (ms, busy, top, fams) in timing.items()},
    )
    return report, launches


def scheme_plans():
    """Phase 6's scheme plans: ViT-L/16 on secondaries of capacities 5:3:2
    (the baseline assignment), and VGG-16 with every stage non_penetrative
    at the same ratios."""
    from repro_torch.core import (SCHEME_NP, CollabTopology, Platform, plan_from_scheme_layout,
                                  plan_scheme, scheme_layout, stage_spans, vgg16_geom, vit_l16_geom)

    topo = CollabTopology(host="e0", secondaries=("e1", "e2", "e3"),
                          platforms={es: Platform(es, c * 1e12, c * 1e12)
                                     for es, c in (("e0", 1.0), ("e1", 5.0), ("e2", 3.0), ("e3", 2.0))})
    vit_plan = plan_scheme(vit_l16_geom(), topo)
    net = vgg16_geom()
    vgg_np_plan = plan_from_scheme_layout(scheme_layout(
        net, topo.secondaries, ratios=vit_plan.ratios, assignment=(SCHEME_NP,) * len(stage_spans(net))))
    return vit_plan, vgg_np_plan


def sweep_trace_inputs():
    """``benchmarks/serve_sweep.py``'s ``--smoke`` settings in the port's
    types: the three deadline classes, its channel, and its three arrival
    processes at the 3,600 s horizon."""
    from repro_torch.core import OffloadChannel
    from repro_torch.runtime import DeadlineClass, DiurnalProcess, FlashCrowdProcess, PoissonProcess

    classes = (DeadlineClass("premium", 0.15, target=0.999, share=0.2),
               DeadlineClass("standard", 0.4, target=0.99, share=0.5),
               DeadlineClass("bulk", 2.0, target=0.9, share=0.3))
    h = SWEEP_HORIZON_S
    processes = {
        "poisson": PoissonProcess(rate_hz=5.8, seed=101),
        "diurnal": DiurnalProcess(base_rate_hz=4.0, amplitude=0.8, period_s=h, seed=202),
        "flash_crowd": FlashCrowdProcess(base_rate_hz=3.0, bursts=((0.25 * h, 0.05 * h, 300.0),), seed=303),
    }
    return classes, OffloadChannel(rate_bps=100e6, sigma_s=2e-3), processes


def phase_serving(torch, params=None, images=None, plain=None) -> tuple[dict, dict]:
    """Phase 10: the plan analysers and deadline-aware serving (paper §V.D)
    over full-width VGG-16 under ``plan_halp(overlap_rows=4)``, with phase
    4's weights and images (drawn here as ``serve`` draws them when run
    alone; ``plain`` is phase 4's plain-conv forward of the first MAX_BATCH
    images on the CPU, computed here when not given).  Returns the report
    and the launches of K1 and K2 on its path: the probe's K2 launches, the
    latency curve's and the burst's forwards."""
    import dataclasses

    from repro_torch.analysis import AnalysisError, check_plan, check_plan_kernels
    from repro_torch.analysis.kernel_check import plan_kernel_calls
    from repro_torch.core import (OffloadChannel, Segment, plan_even, plan_halp, rate_fluctuation,
                                  service_reliability)
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.kernels.halo_conv import halo_conv2d_cuda, halo_conv2d_ref
    from repro_torch.models import vgg
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import (BatchingEngine, ServeConfig, ServeLoopConfig, choose_batch_size,
                                     make_trace, serve_trace)
    from repro_torch.spatial import run_plan

    t_start = time.perf_counter()
    if params is None:
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = vgg.init(gen, vgg.FULL)
        res = vgg.FULL.img_res
        images = torch.randn((N_REQUESTS, res, res, vgg.FULL.in_channels), generator=gen, device="cuda")
    if plain is None:
        plain = vgg.apply(tree_map(lambda t: t.cpu(), params), vgg.FULL, images[:MAX_BATCH].cpu())
    net = vgg.FULL.geom()
    plan = plan_halp(net, overlap_rows=4)
    even = plan_even(net, len(WEIGHTED_RATIOS), ratios=WEIGHTED_RATIOS)
    vit_plan, np_plan = scheme_plans()
    conv2d_cuda.launches = halo_conv2d_cuda.launches = 0

    # (1) the analysers at full width: every plan the card runs is clean
    analysis = {}
    for name, p in (("halp", plan), ("plan_even", even), ("vit head_sequence", vit_plan),
                    ("vgg non_penetrative", np_plan)):
        t0 = time.perf_counter()
        rep = check_plan(p)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"check_plan {name}: {rep} in {ms:.3f} ms (host clock)")
        check(rep.ok, f"check_plan refuses the {name} plan: {rep}")
        analysis[name] = dict(checks=rep.checks, ms=ms)
    calls = {}
    for name, p in (("halp", plan), ("plan_even", even)):
        t0 = time.perf_counter()
        rep = check_plan_kernels(p)
        ms = (time.perf_counter() - t0) * 1e3
        deployed = plan_kernel_calls(p)
        print(f"check_plan_kernels {name}: {rep} over {len(deployed)} conv geometries in {ms:.3f} ms "
              "(host clock)")
        check(rep.ok, f"check_plan_kernels refuses the {name} plan: {rep}")
        analysis[name].update(kernel_checks=rep.checks, kernel_ms=ms, geometries=len(deployed))
        calls.update(deployed)
    # one K2 launch at every geometry the probe accepts, held to the probe's
    # shape and to the plain version
    pgen = torch.Generator(device="cuda").manual_seed(10)
    probed = []
    for (k, s, p, groups, cin, cout, hs, w), shapes in sorted(calls.items()):
        if shapes is None:  # not a K2 geometry (check_plan_kernels agreed with the predicate)
            continue
        kw = dict(stride=s, padding=p, groups=groups)
        want = shapes["out"]
        x, top, bot, wt = (None if shapes[n] is None else torch.randn(shapes[n], generator=pgen, device="cuda")
                           for n in ("x", "top", "bottom", "weights"))
        wt *= math.sqrt(2.0 / (k * k * shapes["weights"][2]))
        before = halo_conv2d_cuda.launches
        y = halo_conv2d_cuda(x, top, bot, wt, **kw)
        ref = halo_conv2d_ref(x, top, bot, wt, None, **kw)
        torch.cuda.synchronize()
        check(halo_conv2d_cuda.launches == before + 1, f"K2 did not launch at {shapes}")
        check(tuple(y.shape) == want, f"K2 gave {tuple(y.shape)}, the probe {want}")
        err = (y - ref).abs().max().item()
        check(bool(((y - ref).abs() <= TOL["float32"] * (1 + ref.abs())).all()),
              f"K2 disagrees with its plain version at {shapes} (max err {err})")
        probed.append(dict(geometry=[k, s, p, groups, cin, cout, hs, w], shape=list(want), max_abs_err=err))
    probe_launches = halo_conv2d_cuda.launches
    print(f"  K2 launched once at each of the {len(probed)} of {len(calls)} geometries the probe accepts "
          f"({probe_launches} launches); "
          f"each gave the probe's shape, max |err| against the plain version "
          f"{max(r['max_abs_err'] for r in probed):.3g}")
    check(probed and probe_launches == len(probed), f"{probe_launches} K2 launches for {len(probed)} geometries")
    # a corrupt plan (tests/test_analysis.py's row gap) is refused before any kernel
    slot = next(sl for sl in plan.es_names if plan.parts[0].out[sl])
    seg, part = plan.parts[0].out[slot], plan.parts[0]
    bad_part = dataclasses.replace(part, out=dict(part.out, **{slot: Segment(seg.lo + 1, seg.hi)}))
    bad = dataclasses.replace(plan, parts=(bad_part,) + plan.parts[1:])
    before = conv2d_cuda.launches
    try:
        run_plan(bad, params["features"], vgg.apply_layer, images[:MAX_BATCH], verify=True)
        refused = None
    except AnalysisError as exc:
        refused = exc.report
    torch.cuda.synchronize()
    check(refused is not None, "run_plan(verify=True) ran a plan with a row gap")
    print(f"  row-gap plan (layer 0, slot {slot}: rows {seg.lo + 1}..{seg.hi}): run_plan(verify=True) "
          f"raised AnalysisError {[(f.check, f.where) for f in refused.findings]}; K1 launches "
          f"{conv2d_cuda.launches - before}")
    check(any(f.check == "plan.coverage" for f in refused.findings), f"the row gap gave {refused}")
    check(conv2d_cuda.launches == before, "K1 launched for a plan that failed verification")

    # (2) the latency curve of the HALP forward (run_plan + head), b = 1..8;
    # the plan was verified above, once, not per forward
    def forward(batch):
        return vgg.head(params, run_plan(plan, params["features"], vgg.apply_layer, batch))

    curve, k1_per_fwd, busy, outs = {}, {}, {}, {}
    for b in range(1, CURVE_MAX_BATCH + 1):
        xb = images[:b]
        for _ in range(3):
            forward(xb)
        torch.cuda.synchronize()
        before = conv2d_cuda.launches
        t0 = time.perf_counter()
        for _ in range(5):
            outs[b] = forward(xb)  # held below, after the burst
            torch.cuda.synchronize()
        curve[b] = (time.perf_counter() - t0) / 5
        k1_per_fwd[b] = (conv2d_cuda.launches - before) / 5
        if b in (4, 8):
            busy[b] = profile_device(torch, lambda: forward(xb))[0] or float("nan")  # nan: nothing traced
    print("latency curve of run_plan + head (host clock, mean of 5 after 3 warm-up, synchronised): "
          + "; ".join(f"b={b} {curve[b] * 1e3:.3f} ms ({k1_per_fwd[b]:.0f} K1)" for b in curve))
    print("  device busy in one profiled forward: "
          + "; ".join(f"b={b} {ms:.3f} ms (idle share {1 - ms / (curve[b] * 1e3):.3f})" for b, ms in busy.items()))
    check(all(n == k1_per_fwd[1] for n in k1_per_fwd.values()), f"K1 launches per forward vary: {k1_per_fwd}")

    # (3) admission over the measured curve at Table III's channel states
    admission = []
    for mbps, sigma_ms in TABLE3_STATES:
        ch = OffloadChannel(rate_bps=mbps * 1e6, sigma_s=sigma_ms * 1e-3)
        widths = {t: choose_batch_size(lambda b: curve[b], DEADLINE_S, ch, target=t, max_batch=CURVE_MAX_BATCH)
                  for t in ADMISSION_TARGETS}
        r4 = service_reliability(ch, curve[4], DEADLINE_S)
        admission.append(dict(rate_mbps=mbps, sigma_ms=sigma_ms, mu_ms=ch.mu_s * 1e3,
                              phi_mbps=rate_fluctuation(ch) / 1e6, widths=widths, reliability_b4=r4))
        print(f"  admission at {mbps} Mbps, sigma {sigma_ms} ms (mu {ch.mu_s * 1e3:.1f} ms of D "
              f"{DEADLINE_S * 1e3:.1f} ms): choose_batch_size " + ", ".join(
                  f"{w} at {t}" for t, w in widths.items()) + f"; reliability at b=4 {r4:.6f}")

    # (4) a live burst through BatchingEngine at the admitted width
    ch = OffloadChannel(rate_bps=100e6, sigma_s=2e-3)
    width = choose_batch_size(lambda b: curve[b], DEADLINE_S, ch, target=BURST_TARGET, max_batch=CURVE_MAX_BATCH)
    check(width >= 1, f"admission sheds everything at 100 Mbps, sigma 2 ms (curve {curve})")
    eng = BatchingEngine(forward, ServeConfig(max_batch=width))
    t0 = time.monotonic()
    for i in range(BURST_REQUESTS):
        eng.submit(images[i % len(images)], deadline_s=DEADLINE_S)
    stats = eng.run_until_drained()
    wall = time.monotonic() - t0
    launches = {"conv2d": conv2d_cuda.launches, "halo_conv2d": halo_conv2d_cuda.launches}
    check(stats["completed"] == BURST_REQUESTS, f"the burst completed {stats['completed']} requests")
    print(f"live burst: {BURST_REQUESTS} requests at max_batch {width} (choose_batch_size at 100 Mbps, sigma 2 ms, "
          f"target {BURST_TARGET}): p50 {stats['p50_latency_s'] * 1e3:.3f} ms p99 "
          f"{stats['p99_latency_s'] * 1e3:.3f} ms, deadline met {stats['deadline_met_frac']:.4f} (engine clock, "
          f"no offload), {BURST_REQUESTS / wall:.3f} req/s (wall {wall:.3f} s)")
    # each request's logits against the single-request forward of its image
    # (phase 4's lossless tolerance), and the first MAX_BATCH against the
    # plain conv on the CPU
    reqs = sorted(eng.completed, key=lambda r: r.rid)
    single = torch.cat([forward(images[i:i + 1]) for i in range(len(images))])
    got = torch.stack([r.result for r in reqs])
    want = single[torch.arange(BURST_REQUESTS) % len(images)]
    check(bool(torch.isfinite(got).all()), "non-finite logits in the burst")
    share = ((got - want).abs() / (2e-5 * (1 + want.abs()))).max().item()
    depth = (got[:MAX_BATCH].cpu() - plain).abs().max().item()
    scale = plain.abs().max().item()
    print(f"  served logits vs the single-request forward: max |diff| {(got - want).abs().max().item():.3g} "
          f"({share:.3f} of the limit 2e-5 x (1 + |y|)); first {MAX_BATCH} vs the plain conv on the CPU: "
          f"{depth:.3g} (limit {DEPTH_RTOL} x {scale:.3g})")
    check(share <= 1, "a served request's logits differ from its single-request forward")
    check(depth <= DEPTH_RTOL * scale, "the served logits drift from the plain conv at depth")
    # every width of the latency curve: its logits against the single-request
    # forwards of the same images, and its first MAX_BATCH against the plain
    # conv on the CPU
    curve_share = {b: ((y - single[:b]).abs() / (2e-5 * (1 + single[:b].abs()))).max().item()
                   for b, y in outs.items()}
    curve_depth = {b: (y[:MAX_BATCH].cpu() - plain[:min(b, MAX_BATCH)]).abs().max().item()
                   for b, y in outs.items()}
    print("  latency curve's logits vs the single-request forwards (share of the limit 2e-5 x (1 + |y|)) "
          "and vs the plain conv on the CPU (max |diff|, limit "
          f"{DEPTH_RTOL} x {scale:.3g}): " + "; ".join(
              f"b={b} {curve_share[b]:.3f}, {curve_depth[b]:.3g}" for b in outs))
    check(all(torch.isfinite(y).all().item() for y in outs.values()), "non-finite logits in the latency curve")
    check(all(v <= 1 for v in curve_share.values()),
          f"a width of the latency curve differs from the single-request forwards: {curve_share}")
    check(all(v <= DEPTH_RTOL * scale for v in curve_depth.values()),
          f"a width of the latency curve drifts from the plain conv at depth: {curve_depth}")

    # (5) trace-scale serving in virtual time over the measured curve
    classes, sweep_ch, processes = sweep_trace_inputs()
    lat_table = np.array([curve[b] for b in range(1, CURVE_MAX_BATCH + 1)])
    traces = {}
    for name, proc in processes.items():
        trace = make_trace(proc, classes, SWEEP_HORIZON_S, seed=17)
        rec = dict(n=len(trace), process=type(proc).__name__)
        for policy, admit in (("shed", True), ("noshed", False)):
            cfg = ServeLoopConfig(max_batch=CURVE_MAX_BATCH, max_delay_s=0.002, admission=admit,
                                  channel=sweep_ch, seed=23)
            t0 = time.perf_counter()
            served = serve_trace(trace, lat_table, cfg)
            wall_s = time.perf_counter() - t0
            st, cs = served.stats(), served.class_stats()
            check(st["completed"] + st["shed"] == len(trace), f"{name} {policy}: requests lost")
            check(admit or st["shed"] == 0, f"{name}: shed {st['shed']} with admission off")
            if name == "poisson":  # the vectorised fast path against the scalar event loop
                slow = serve_trace(trace, lat_table, dataclasses.replace(cfg, fast_path=False))
                same = (np.array_equal(served.fin, slow.fin, equal_nan=True)
                        and np.array_equal(served.shed, slow.shed) and np.array_equal(served.met, slow.met)
                        and np.array_equal(served.batch_size_counts, slow.batch_size_counts))
                check(same, f"poisson {policy}: the fast path differs from the scalar loop")
            rec[policy] = dict(overall=st, classes=cs, serve_wall_s=wall_s)
            print(f"serve_trace {name} {policy}: n {len(trace)} p50 {st['p50_latency_s'] * 1e3:.3f} ms "
                  f"p99 {st['p99_latency_s'] * 1e3:.3f} ms met {st['deadline_met_frac']:.4f} shed "
                  f"{st['shed_rate']:.4f} mean batch {st['mean_batch']:.3f} ({wall_s:.2f} s of host)"
                  + "".join(f"; {c} p50 {v['p50_latency_s'] * 1e3:.2f} p99 {v['p99_latency_s'] * 1e3:.2f} "
                            f"met {v['deadline_met_frac']:.4f} shed {v['shed_rate']:.4f}" for c, v in cs.items()))
        traces[name] = rec
    fc = traces["flash_crowd"]
    premium = {p: fc[p]["classes"]["premium"]["deadline_met_frac"] for p in ("shed", "noshed")}
    print(f"  flash-crowd premium deadline met: shed {premium['shed']:.4f} vs no-shed {premium['noshed']:.4f}; "
          f"poisson fast path == scalar loop")
    phase_s = time.perf_counter() - t_start
    print(f"  phase 10: {phase_s:.1f} s; launches {launches}")
    report = dict(
        phase_s=phase_s, analysis=analysis, probed=probed, probe_launches=probe_launches,
        refused=[(f.check, f.where) for f in refused.findings],
        curve_ms={b: v * 1e3 for b, v in curve.items()}, k1_per_forward=k1_per_fwd, device_busy_ms=busy,
        curve_lossless_limit_share=curve_share, curve_plain_depth_max_abs=curve_depth,
        deadline_s=DEADLINE_S, admission=admission,
        burst=dict(stats, max_batch=width, target=BURST_TARGET, n=BURST_REQUESTS, wall_s=wall,
                   requests_per_s=BURST_REQUESTS / wall, lossless_limit_share=share, plain_depth_max_abs=depth),
        traces=traces, flash_premium_met=premium, launches=launches,
    )
    return report, launches


# Phase 11: the latency engines priced on the card.  The paper's link rates
# (benchmarks/paper_tables.py: RATES) and the closed form's pinned slack on
# the DES for the symmetric pair (tests/test_conformance.py: UPPER_SLACK);
# Table IV's cluster (benchmarks/hetero_sweep.py: the "slow x0.35 @ 10 Gbps"
# pair); the channel replay: the fast secondary's link starts at 100 Gbps
# and wanders down to the slow one's 10, its epochs and seed.
PAPER_RATES = (40e9, 60e9, 80e9, 100e9)
CF_SLACK = {1: 1.05, 4: 1.11}
SLOW_FACTOR, SLOW_GBPS, FAST_GBPS = 0.35, 10.0, 40.0
REPLAY_BAND, REPLAY_EPOCHS, REPLAY_SEED = (10e9, 100e9), 200, 31


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def table4_topology(card):
    """``benchmarks/hetero_sweep.py``'s heterogeneous pair on card-class ESs:
    the host and "fast" at the card's platform, "slow" at 0.35x of it behind
    10 Gbps, "fast" at 40 Gbps."""
    from repro_torch.core import CollabTopology, Link

    fast, slow = Link(FAST_GBPS * 1e9), Link(SLOW_GBPS * 1e9)
    return CollabTopology(
        host="e0", secondaries=("fast", "slow"),
        platforms={"e0": card, "fast": card, "slow": card.scaled(SLOW_FACTOR, f"slow x{SLOW_FACTOR:g}")},
        links={("e0", "fast"): fast, ("fast", "e0"): fast, ("e0", "slow"): slow, ("slow", "e0"): slow},
    )


def hold_k1(torch, gen, shapes: Counter, path: str, timed: bool = True) -> list[dict]:
    """K1 against its plain version, float32, at every conv shape of
    ``shapes`` (``conv_shapes``: shape -> calls a forward), on seeded inputs;
    fatal where it disagrees.  With ``timed``, each shape is also timed as
    phase 3 times it (kernel, plain version, ``F.conv2d``) beside its bounds.
    K1's launch count is left as it was: these launches compare, they are no
    path's.  Returns one row per shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref

    launches = conv2d_cuda.launches
    holds = []
    for (n, h, w, cin, cout, k, st), per_forward in sorted(shapes.items()):
        x = torch.randn((n, h, w, cin), generator=gen, device="cuda")
        wt = math.sqrt(2.0 / (k * k * cin)) * torch.randn((k, k, cin, cout), generator=gen, device="cuda")
        b = 0.1 * torch.randn((cout,), generator=gen, device="cuda")
        kw = dict(stride=st, padding=0, groups=1)
        got, ref = conv2d_cuda(x, wt, b, **kw), conv2d_ref(x, wt, b, **kw)
        diff = (got - ref).abs()
        ok = bool((diff <= TOL["float32"] * (1 + ref.abs())).all()) and bool(torch.isfinite(got).all())
        row = dict(shape=[n, h, w, cin, cout], k=k, stride=st, dtype="float32", path=path,
                   per_forward=per_forward, max_abs_err=diff.max().item(), within_tol=ok)
        if timed:
            xn, wn = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
            flops = 2.0 * k * k * cin * cout * n * got.shape[1] * got.shape[2]
            nbytes = (x.numel() + wt.numel() + b.numel() + got.numel()) * 4
            ops_ms, bytes_ms = bound_ms(flops, nbytes, "float32")
            row.update(ms=time_ms(torch, lambda: conv2d_cuda(x, wt, b, **kw)),
                       plain_ms=time_ms(torch, lambda: conv2d_ref(x, wt, b, **kw)),
                       library_ms=time_ms(torch, lambda: F.conv2d(xn, wn, b, stride=st)),
                       bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms,
                       ffma_bound_ms=max(bound_ms(flops, nbytes, "float32", ffma=True)))
        holds.append(row)
        check(ok, f"K1 disagrees with its plain version at a {path} shape {row}")
    torch.cuda.synchronize()
    conv2d_cuda.launches = launches
    return holds


def phase_engines(torch, curve_ms: dict, params=None, images=None, plain=None,
                  single=None) -> tuple[dict, dict, list]:
    """Phase 11: the paper's latency engines and plan search, priced on a
    platform calibrated to the card (``curve_ms`` is phase 10's latency curve
    in ms by batch width), and the searched plan run through ``run_plan``
    (K1) at batch MAX_BATCH with phase 4's weights and images (drawn as
    ``serve`` draws them when not given; ``plain`` and ``single`` are phase
    4's plain-conv forward on the CPU and single-device forward on the card).
    Returns the report, K1's launches on its path and its per-shape holds
    of K1 (rows as phase 3's)."""
    import dataclasses

    from repro_torch.analysis import check_dag, check_template
    from repro_torch.core import (Link, Sim, StaticPlanner, enhanced_modnn_delay, equal_ratios, evaluate_plan,
                                  halp_closed_form, modnn_time, optimize_plan, plan_halp_topology,
                                  replay_trace, serve_latency_table, simulate_halp, simulate_modnn,
                                  speedup_ratio, standalone_time, vgg16_geom)
    from repro_torch.core.events import DagTemplate, HalpBatchEvaluator, _layout_quantities, build_halp_dag
    from repro_torch.core.schedule import _calibrated
    from repro_torch.core.simulator import GaussMarkovTrace
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.models import vgg
    from repro_torch.models.common import tree_map
    from repro_torch.models.layers import max_pool
    from repro_torch.runtime import ServeLoopConfig, make_trace, serve_trace
    from repro_torch.spatial import run_plan

    t_start = time.perf_counter()
    if params is None:
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = vgg.init(gen, vgg.FULL)
        res = vgg.FULL.img_res
        images = torch.randn((N_REQUESTS, res, res, vgg.FULL.in_channels), generator=gen, device="cuda")
    x4 = images[:MAX_BATCH]
    if single is None:
        single = vgg.apply(params, vgg.FULL, x4)
    if plain is None:
        plain = vgg.apply(tree_map(lambda t: t.cpu(), params), vgg.FULL, x4.cpu())
    net = vgg.FULL.geom()
    sizes = net.sizes()
    smi = nvidia_smi()
    dags = {}

    # (1) the card as a Platform: _calibrated fed with the b = 1 forward
    card = _calibrated(smi.split(",")[0].strip(), PEAK_FLOPS["float32"], curve_ms[1] / 1e3)
    print(f"card platform ({smi}): {card.name}, peak {card.peak_flops / 1e12:.3f} TFLOP/s (3xTF32), "
          f"eff {card.eff_flops / 1e12:.4f} TFLOP/s = {vgg16_geom().total_flops() / 1e9:.3f} GFLOP / "
          f"{curve_ms[1]:.3f} ms (phase 10's b = 1 forward)")
    # per layer: the DES's compute time at b = 1 beside the device time of
    # K1 (convs) or the pool at the single-device shape, from profiler
    # windows; a window may trace nothing (nan), so it is taken up to three
    # times, then the CUDA-event mean stands in (host-bound where the wrapper
    # outlasts the kernel) and the row says so
    def layer_us(fn) -> tuple[float, str]:
        for _ in range(3):
            us = device_us(torch, fn)
            if math.isfinite(us):
                return us, "profiler"
        return time_ms(torch, fn) * 1e3, "events"

    lgen = torch.Generator(device="cuda").manual_seed(11)
    layers = []
    for i, g in enumerate(net.layers):
        if g.kind == "conv":
            x = torch.randn((1, sizes[i] + 2 * g.p, sizes[i] + 2 * g.p, g.c_in), generator=lgen, device="cuda")
            p = params["features"][i]
            meas, src = layer_us(lambda x=x, p=p, g=g: conv2d_cuda(x, p["w"], p["b"], stride=g.s, padding=0))
        else:
            x = torch.randn((1, sizes[i], sizes[i], g.c_in), generator=lgen, device="cuda")
            meas, src = layer_us(lambda x=x, g=g: max_pool(x, k=g.k, s=g.s))
        des = card.compute_time(net.layer_flops(i)) * 1e6
        layers.append(dict(layer=g.name, kind=g.kind, gflop=net.layer_flops(i) / 1e9, des_us=des,
                           device_us=meas, source=src, des_over_device=des / meas))
    print("per layer at b = 1, DES us (layer_flops / eff) vs device us (K1, or the pool; * CUDA events) and "
          "their ratio: " + "; ".join(
              f"{r['layer']} {r['des_us']:.1f} / {r['device_us']:.1f}{'*' if r['source'] == 'events' else ''} = "
              f"{r['des_over_device']:.3f}" for r in layers))
    conv_dev = sum(r["device_us"] for r in layers if r["kind"] == "conv") / 1e3
    pool_dev = sum(r["device_us"] for r in layers if r["kind"] == "pool") / 1e3
    print(f"  K1 device ms summed over the 13 convs {conv_dev:.3f}, pools {pool_dev:.3f}; the DES's features "
          f"{sum(r['des_us'] for r in layers) / 1e3:.3f} ms, head {card.compute_time(net.head_flops) * 1e3:.3f} ms; "
          f"the features' FLOPs over that device time: "
          f"{(net.total_flops() - net.head_flops) / (conv_dev + pool_dev) / 1e9:.4f} TFLOP/s")
    check(all(math.isfinite(r["device_us"]) and r["device_us"] > 0 for r in layers),
          f"no device time for a layer: {layers}")

    # (2) the single-ES chain against the measured curve (a record, not a gate)
    t_pre = standalone_time(net, card)
    widths = [dict(batch=b, des_ms=b * t_pre * 1e3, measured_ms=curve_ms[b], ratio=b * t_pre * 1e3 / curve_ms[b])
              for b in range(1, CURVE_MAX_BATCH + 1)]
    print("single-ES chain b x t_pre vs the measured curve (ms, ratio): "
          + "; ".join(f"b={w['batch']} {w['des_ms']:.3f} / {w['measured_ms']:.3f} = {w['ratio']:.3f}" for w in widths))

    # (3) the paper's figures on card-class ESs
    figs = []
    for rate in PAPER_RATES:
        link = Link(rate)
        one = simulate_halp(net, card, link)
        four = simulate_halp(net, card, link, n_tasks=4)
        m3 = simulate_modnn(net, card, link, 3)
        m9 = simulate_modnn(net, card, link, 9)
        enh = enhanced_modnn_delay(net, card, link)
        cf = {n: halp_closed_form(net, card, link, n_tasks=n)["total"] for n in (1, 4)}
        cf22 = {n: halp_closed_form(net, card, link, n_tasks=n, multitask_bound="eq22")["total"] for n in (1, 4)}
        ev = {1: one["total"], 4: four["total"]}
        for n in (1, 4):
            check(cf[n] >= ev[n] * (1 - 1e-9), f"closed form {cf[n]} below the DES {ev[n]} at {rate:g} b/s")
            check(cf[n] <= ev[n] * CF_SLACK[n], f"closed form {cf[n] / ev[n]:.4f}x the DES past {CF_SLACK[n]}")
            check(cf[n] <= cf22[n] + 1e-15 and (n > 1 or cf[n] == cf22[n]), f"tightened bound looser than eq. 22")
        for key, sim in ((f"halp1@{rate:g}", one["sim"]), (f"halp4@{rate:g}", four["sim"]),
                         (f"modnn3@{rate:g}", m3["sim"]), (f"modnn9@{rate:g}", m9["sim"])):
            dags[key] = check_dag(sim)
        row = dict(rate_gbps=rate / 1e9, t_pre_ms=t_pre * 1e3, halp_ms=one["total"] * 1e3,
                   speedup=t_pre / one["total"], rho=speedup_ratio(one["total"], t_pre),
                   modnn3_rho=speedup_ratio(m3["total"], t_pre),
                   modnn3_closed_form_ms=modnn_time(net, card, link, 3) * 1e3,
                   avg_delay4_ms=four["avg_delay"] * 1e3, speedup4=t_pre / four["avg_delay"],
                   halp_fps=4.0 / four["total"], modnn9_fps=1.0 / m9["total"], enh_modnn_fps=enh["throughput"],
                   closed_form_ms={n: cf[n] * 1e3 for n in cf}, cf_over_des={n: cf[n] / ev[n] for n in cf},
                   eq22_ms=cf22[4] * 1e3)
        figs.append(row)
        print(f"  {rate / 1e9:.0f} Gbps: Fig. 6 HALP {row['halp_ms']:.4f} ms, t_pre/T {row['speedup']:.3f}x "
              f"(rho {row['rho']:.4f}; MoDNN-3 rho {row['modnn3_rho']:.4f}, closed form "
              f"{row['modnn3_closed_form_ms']:.4f} ms); Fig. 7 4-task avg delay {row['avg_delay4_ms']:.4f} ms "
              f"({row['speedup4']:.3f}x); Table II fps HALP {row['halp_fps']:.1f}, MoDNN-9 {row['modnn9_fps']:.1f}, "
              f"enhanced MoDNN {row['enh_modnn_fps']:.1f}; closed form / DES {row['cf_over_des'][1]:.4f} (1 task), "
              f"{row['cf_over_des'][4]:.4f} (4; eq. 22 {row['eq22_ms']:.4f} ms)")

    # (4) search the Table IV cluster, then run the searched plan through K1
    topo = table4_topology(card)
    t0 = time.perf_counter()
    res = optimize_plan(net, topo, n_tasks=4, verify=True)
    search_s = time.perf_counter() - t0
    equal = evaluate_plan(net, topo, equal_ratios(topo), 4, n_tasks=4)
    print(f"optimize_plan on Table IV's cluster (fast {FAST_GBPS:g} Gbps, slow x{SLOW_FACTOR:g} @ {SLOW_GBPS:g} "
          f"Gbps), 4 tasks, verify=True: equal split {equal * 1e3:.4f} ms, optimum {res.makespan * 1e3:.4f} ms "
          f"(gain {1 - res.makespan / equal:.4f}) at ratios {[round(r, 4) for r in res.ratios]}, overlap "
          f"{res.overlap_rows}, {res.evaluations} evaluations in {search_s:.3f} s of host")
    check(res.makespan <= equal, "the search returned a plan slower than the equal split")
    lay = HalpBatchEvaluator(net, topo, n_tasks=4).layout_for(res.ratios, res.overlap_rows)
    tmpl = DagTemplate.from_layouts([lay] * 4, topo, physical=False)
    tmpl_rep = check_template(tmpl, _layout_quantities([lay] * 4), topo)
    print(f"  check_template on its template: {tmpl_rep}")
    check(tmpl_rep.ok, f"check_template refuses the searched plan's template: {tmpl_rep}")
    dags["template"] = check_dag(tmpl.sim)
    plan = plan_halp_topology(net, topo, overlap_rows=res.overlap_rows, ratios=res.ratios)
    check(plan == res.plan, "the port's planner gives another plan than the search returned")
    shapes = conv_shapes(plan, MAX_BATCH)
    want = sum(shapes.values())
    # K1 against its plain version at every conv shape the searched plan
    # gives it (phase 3 held phase 4's plan's), timed as phase 3 times
    holds = hold_k1(torch, lgen, shapes, "engines")
    per_fwd = {key: sum(r[key] * r["per_forward"] for r in holds)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"  K1 at the searched plan's {len(holds)} conv shapes ({want} calls a forward): max |err| "
          f"{max(r['max_abs_err'] for r in holds):.3g}; per forward (CUDA events) kernel {per_fwd['ms']:.3f} ms, "
          f"plain {per_fwd['plain_ms']:.3f}, F.conv2d {per_fwd['library_ms']:.3f}, bound {per_fwd['bound_ms']:.3f}")

    def forward(batch):
        return vgg.head(params, run_plan(plan, params["features"], vgg.apply_layer, batch))

    conv2d_cuda.launches = 0
    y = vgg.head(params, run_plan(plan, params["features"], vgg.apply_layer, x4, verify=True))
    torch.cuda.synchronize()
    first_launches = conv2d_cuda.launches
    fwd_ms, busy_ms, top, fams = steady_and_profiled(torch, lambda: forward(x4), "searched plan run_plan")
    torch.cuda.synchronize()
    launches = {"conv2d": conv2d_cuda.launches}
    check(first_launches == want, f"the searched plan launched K1 {first_launches} times, the plan implies {want}")
    check(launches["conv2d"] == 8 * want, f"{launches['conv2d']} K1 launches in 8 forwards of {want}")
    check(bool(torch.isfinite(y).all()), "non-finite logits from the searched plan")
    share = ((y - single).abs() / (2e-5 * (1 + single.abs()))).max().item()
    depth = (y.cpu() - plain).abs().max().item()
    scale = plain.abs().max().item()
    print(f"  searched plan through run_plan(verify=True): {first_launches} K1 launches (the plan implies {want}); "
          f"logits vs phase 4's single-device forward {share:.3f} of the limit 2e-5 x (1 + |y|), vs the plain conv "
          f"on the CPU {depth:.3g} (limit {DEPTH_RTOL} x {scale:.3g})")
    check(share <= 1, "the searched plan is not lossless against the single-device forward")
    check(depth <= DEPTH_RTOL * scale, "the searched plan drifts from the plain conv at depth")
    # the same work priced: the plan's compute jobs for MAX_BATCH tasks with
    # every ES at the card's platform, summed (one card runs every slot)
    one_card = table4_topology(card)
    one_card = dataclasses.replace(one_card, platforms={es: card for es in one_card.platforms})
    sim = Sim()
    build_halp_dag(sim, [plan] * MAX_BATCH, one_card)
    dags["searched plan on one card"] = check_dag(sim)
    priced_ms = sum(j.duration for j in sim.jobs if not j.resource.startswith("link:")) * 1e3
    print(f"  steady {fwd_ms:.3f} ms, device busy {busy_ms:.3f} ms; the DES's compute jobs of the same work on "
          f"the card platform {priced_ms:.3f} ms (busy / priced {busy_ms / priced_ms:.3f})")
    for name, rep in dags.items():
        check(rep.ok, f"check_dag refuses the {name} DAG: {rep}")
    print(f"  check_dag clean on all {len(dags)} DAGs built "
          f"({sum(r.checks for r in dags.values())} checks)")

    # (5) serve_latency_table for card ESs at 100 Gbps beside the curve, and
    # serve_trace over both with phase 10's traces, admission on
    table = serve_latency_table(net, card, Link(100e9), max_batch=CURVE_MAX_BATCH)[0]
    curve = np.array([curve_ms[b] / 1e3 for b in range(1, CURVE_MAX_BATCH + 1)])
    print("serve_latency_table (card ESs, 100 Gbps) vs the measured curve (ms): "
          + "; ".join(f"b={b} {table[b - 1] * 1e3:.3f} / {curve[b - 1] * 1e3:.3f}"
                      for b in range(1, CURVE_MAX_BATCH + 1)))
    classes, sweep_ch, processes = sweep_trace_inputs()
    cfg = ServeLoopConfig(max_batch=CURVE_MAX_BATCH, max_delay_s=0.002, admission=True, channel=sweep_ch, seed=23)
    served = {}
    for name, proc in processes.items():
        trace = make_trace(proc, classes, SWEEP_HORIZON_S, seed=17)
        for tname, tab in (("des", table), ("curve", curve)):
            out_t = serve_trace(trace, tab, cfg)
            st, cs = out_t.stats(), out_t.class_stats()
            check(st["completed"] + st["shed"] == len(trace), f"{name} over the {tname} table: requests lost")
            served[f"{name}/{tname}"] = dict(overall=st, classes=cs)
            print(f"  serve_trace {name} over the {tname} table: n {len(trace)} p50 {st['p50_latency_s'] * 1e3:.3f} "
                  f"ms p99 {st['p99_latency_s'] * 1e3:.3f} ms met {st['deadline_met_frac']:.4f} shed "
                  f"{st['shed_rate']:.4f}" + "".join(
                      f"; {c} met {v['deadline_met_frac']:.4f} shed {v['shed_rate']:.4f}" for c, v in cs.items()))

    # (6) the searched plan, held static, replayed over a fading fast link
    lo, hi = REPLAY_BAND
    rates = GaussMarkovTrace(lo=lo, hi=hi, start=hi, seed=REPLAY_SEED).rates(REPLAY_EPOCHS)
    recs = replay_trace(net, topo, StaticPlanner(plan), link_rates={("e0", "fast"): rates, ("fast", "e0"): rates})
    spans = np.array([r["makespan"] for r in recs])
    p50, p99 = np.percentile(spans, 50) * 1e3, np.percentile(spans, 99) * 1e3
    print(f"replay_trace of the searched plan, {REPLAY_EPOCHS} epochs of GaussMarkovTrace({lo / 1e9:g}-"
          f"{hi / 1e9:g} Gbps, start {hi / 1e9:g}, seed {REPLAY_SEED}; mean {np.mean(rates) / 1e9:.2f} Gbps) on "
          f"the e0<->fast link: makespan p50 {p50:.4f} ms p99 {p99:.4f} ms (nominal {res.makespan * 1e3:.4f} ms "
          f"at {FAST_GBPS:g} Gbps)")
    check(np.isfinite(spans).all() and len(recs) == REPLAY_EPOCHS, "the replay lost epochs")

    phase_s = time.perf_counter() - t_start
    print(f"  phase 11: {phase_s:.1f} s; launches {launches}")
    report = dict(
        phase_s=phase_s, nvidia_smi=smi, card=dataclasses.asdict(card), layers=layers,
        k1_conv_device_ms=conv_dev, pool_device_ms=pool_dev, widths=widths, figures=figs,
        search=dict(ratios=res.ratios, overlap_rows=res.overlap_rows, makespan_ms=res.makespan * 1e3,
                    equal_ms=equal * 1e3, evaluations=res.evaluations, host_s=search_s,
                    template_checks=tmpl_rep.checks),
        k1_holds=holds, k1_per_forward_ms=per_fwd,
        searched_run=dict(k1_per_forward=want, lossless_limit_share=share, plain_depth_max_abs=depth,
                          steady_forward_ms=fwd_ms, device_busy_ms=busy_ms, priced_ms=priced_ms,
                          top_device=top, device_ms_by_kernel=fams),
        dag_checks={k: r.checks for k, r in dags.items()},
        serve_latency_table_ms=(table * 1e3).tolist(), served=served,
        replay=dict(band_bps=REPLAY_BAND, epochs=REPLAY_EPOCHS, seed=REPLAY_SEED, p50_ms=p50, p99_ms=p99),
        launches=launches,
    )
    return report, launches, holds


# Phase 12: online re-planning (core/replan.py, planstore.py, placement.py)
# on phase 11's card platform.  The closed loop serves REPLAN_EPOCHS batches
# on Table IV's pair while the e0<->fast link collapses: a GaussMarkovTrace
# from 40 Gbps reverting fast toward 5 (COLLAPSE); the straggler replay slows
# "fast" to STRAGGLER_FACTOR of its nominal from epoch STRAGGLER_AT of
# STRAGGLER_EPOCHS; the placement pool is benchmarks/multitask_placement.py's
# 1 + 8 ESs (ES_SCALES, 40 Gbps at scale >= 0.6, else 10), whose controller
# sees e1's link collapse to PLACEMENT_COLLAPSE_GBPS.
REPLAN_EPOCHS = 8
COLLAPSE = dict(lo=4e9, hi=40e9, mean=5e9, corr=0.5, sigma_frac=0.1, start=40e9, seed=7)
STRAGGLER_FACTOR, STRAGGLER_AT, STRAGGLER_EPOCHS = 0.3, 20, 60
ES_SCALES = (1.0, 1.0, 0.6, 0.6, 0.35, 0.35, 0.2, 0.2)
POOL_FAST_GBPS, POOL_SLOW_GBPS, PLACEMENT_COLLAPSE_GBPS = 40.0, 10.0, 4.0


def placement_pool(card):
    """``benchmarks/multitask_placement.py: build_pool`` on card-class ESs:
    the host and 8 secondaries at ES_SCALES of the card's platform, the
    faster half behind 40 Gbps links, the slower behind 10."""
    from repro_torch.core import CollabTopology, Link

    secs = tuple(f"e{j}" for j in range(1, len(ES_SCALES) + 1))
    platforms, links = {"e0": card}, {}
    for s, scale in zip(secs, ES_SCALES):
        platforms[s] = card.scaled(scale, f"es x{scale:g}")
        link = Link((POOL_FAST_GBPS if scale >= 0.6 else POOL_SLOW_GBPS) * 1e9)
        links[("e0", s)] = links[(s, "e0")] = link
    return CollabTopology(host="e0", secondaries=secs, platforms=platforms, links=links,
                          default_link=Link(POOL_FAST_GBPS * 1e9))


def phase_replan(torch, engines: dict, params=None, images=None, plain=None,
                 single=None) -> tuple[dict, dict, list]:
    """Phase 12: online re-planning, the plan store and per-task placement
    on phase 11's card-calibrated platform (``engines`` is phase 11's
    report), every plan they serve run through ``run_plan(verify=True)`` (K1)
    at batch MAX_BATCH with phase 4's weights and images (drawn as ``serve``
    draws them when not given; ``plain`` and ``single`` as in phase 11).
    Returns the report, K1's launches on its path and its per-shape holds of
    K1 (untimed)."""
    import shutil
    import tempfile

    from repro_torch.analysis import check_keying
    from repro_torch.core import (GaussMarkovTrace, OffloadChannel, PlacementController, Platform, PlanStore,
                                  ReplanConfig, ReplanController, StaticPlanner, optimize_static, place_tasks,
                                  replay_trace, shared_plan_placement, simulate_placement)
    from repro_torch.core.reliability import IMAGE_BYTES
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.models import vgg
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import BatchingEngine, ServeConfig, plan_aware_batch_size
    from repro_torch.spatial import run_plan

    t_start = time.perf_counter()
    if params is None:
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = vgg.init(gen, vgg.FULL)
        res = vgg.FULL.img_res
        images = torch.randn((N_REQUESTS, res, res, vgg.FULL.in_channels), generator=gen, device="cuda")
    x4 = images[:MAX_BATCH]
    if single is None:
        single = vgg.apply(params, vgg.FULL, x4)
    if plain is None:
        plain = vgg.apply(tree_map(lambda t: t.cpu(), params), vgg.FULL, x4.cpu())
    net = vgg.FULL.geom()
    card = Platform(**engines["card"])
    topo = table4_topology(card)
    smi = nvidia_smi()
    scale = plain.abs().max().item()
    hgen = torch.Generator(device="cuda").manual_seed(12)
    held, holds, served = set(), [], []
    channels = [OffloadChannel(rate_bps=mbps * 1e6, sigma_s=sigma_ms * 1e-3) for mbps, sigma_ms in TABLE3_STATES]
    print(f"phase 12 on {smi}: card platform eff {card.eff_flops / 1e12:.4f} TFLOP/s (phase 11's)")
    conv2d_cuda.launches = 0

    def forward(plan, batch, observer=None):
        """run_plan(verify=True) + head, its K1 launches held to the plan's."""
        before = conv2d_cuda.launches
        y = vgg.head(params, run_plan(plan, params["features"], vgg.apply_layer, batch,
                                      time_observer=observer, verify=True))
        torch.cuda.synchronize()
        want = sum(conv_shapes(plan, batch.shape[0]).values())
        check(conv2d_cuda.launches - before == want,
              f"a phase 12 forward launched K1 {conv2d_cuda.launches - before} times, its plan implies {want}")
        return y

    def lossless(y, what: str) -> tuple[float, float]:
        check(bool(torch.isfinite(y).all()), f"non-finite logits from {what}")
        share = ((y - single).abs() / (2e-5 * (1 + single.abs()))).max().item()
        depth = (y.cpu() - plain).abs().max().item()
        check(share <= 1, f"{what} is not lossless against the single-device forward ({share:.3f} of the limit)")
        check(depth <= DEPTH_RTOL * scale, f"{what} drifts from the plain conv at depth ({depth:.3g})")
        return share, depth

    def serve_plan(plan, knobs, what: str) -> int:
        """The index of ``plan`` among the distinct plans served; a new one
        has K1 held at the conv shapes no earlier plan of this phase gave it,
        one lossless forward and a steady time (host clock, synchronised,
        mean of 5 after one warm-up)."""
        for i, rec in enumerate(served):
            if rec["plan"] == plan:
                return i
        shapes = conv_shapes(plan, MAX_BATCH)
        new = Counter({sh: c for sh, c in shapes.items() if sh not in held})
        holds.extend(hold_k1(torch, hgen, new, "replan", timed=False))
        held.update(new)
        y = forward(plan, x4)
        share, depth = lossless(y, what)
        forward(plan, x4)
        t0 = time.perf_counter()
        for _ in range(5):
            forward(plan, x4)
        ms = (time.perf_counter() - t0) / 5 * 1e3
        served.append(dict(plan=plan, logits=y, what=what, ratios=[round(r, 4) for r in knobs[0]],
                           overlap_rows=knobs[1], k1_per_forward=sum(shapes.values()), new_shapes=len(new),
                           lossless_limit_share=share, plain_depth_max_abs=depth, steady_ms=ms))
        print(f"  plan {len(served) - 1} ({what}): ratios {served[-1]['ratios']}, overlap {knobs[1]}; "
              f"{served[-1]['k1_per_forward']} K1 a forward, K1 held at {len(new)} new shapes; logits "
              f"{share:.3f} of the lossless limit, {depth:.3g} from the CPU plain conv; steady {ms:.3f} ms")
        return len(served) - 1

    def admitted(ctl) -> list[int]:
        return [plan_aware_batch_size(ctl, DEADLINE_S, ch, target=ADMISSION_TARGETS[0]) for ch in channels]

    # (1) the closed loop: the controller re-plans between batches from the
    # executor's per-ES times, the engine's batch latencies and a measured
    # collapse of the e0<->fast link
    collapse = GaussMarkovTrace(**COLLAPSE).rates(REPLAN_EPOCHS)

    def closed_loop(adapt: bool) -> dict:
        ctl = ReplanController(net, topo, ReplanConfig(n_tasks=4, adapt_compute=adapt))
        samples = []

        def observe_compute(es, flops, secs):
            samples.append(dict(es=es, gflop=flops / 1e9, ms=secs * 1e3, tflops=flops / secs / 1e12))
            ctl.observe_compute(es, flops, secs)

        eng = BatchingEngine(lambda batch: forward(ctl.plan, batch, observer=eng.observe_es_time),
                             ServeConfig(max_batch=MAX_BATCH), observer=ctl.observe_batch_latency,
                             es_observer=observe_compute)
        label = "joint" if adapt else "link-only"
        keys, epochs, causes, admit = [], [], Counter(), {}
        for e in range(REPLAN_EPOCHS):
            prev = ctl._active
            plan = ctl.plan_for_epoch()
            result = ctl._active_result()
            if ctl._active not in keys:
                keys.append(ctl._active)
            cause = [side for side, j in (("link", 0), ("compute", 1)) if ctl._active[j] != prev[j]]
            causes.update(cause)
            index = serve_plan(plan, (result.ratios, result.overlap_rows), f"{label}, epoch {e}")
            n0 = len(samples)
            for i in range(MAX_BATCH):
                eng.submit(images[i], deadline_s=DEADLINE_S)
            eng.run_until_drained()
            batch = sorted(eng.completed[-MAX_BATCH:], key=lambda r: r.rid)
            lossless(torch.stack([r.result for r in batch]), f"the {label} loop's batch {e}")
            if e == 0:
                admit["before"] = admitted(ctl)
            rate = collapse[e]
            if e + 1 < REPLAN_EPOCHS:
                for pair in (("e0", "fast"), ("fast", "e0")):
                    ctl.observe_transfer(*pair, IMAGE_BYTES, 8.0 * IMAGE_BYTES / rate)
            epochs.append(dict(epoch=e, switched_by=cause, plan=index, ratios=served[index]["ratios"],
                               overlap_rows=result.overlap_rows, predicted_ms=result.makespan * 1e3,
                               link_fed_gbps=rate / 1e9 if e + 1 < REPLAN_EPOCHS else None,
                               batch_ms=(batch[0].done - batch[0].arrival) * 1e3,
                               samples=samples[n0:]))
            print(f"  {label} epoch {e}: plan {index} ratios {served[index]['ratios']} overlap "
                  f"{result.overlap_rows}" + (f" (switched by {'+'.join(cause)})" if cause else "")
                  + "; per-ES samples " + ", ".join(f"{s['es']} {s['tflops']:.3f} TFLOP/s ({s['ms']:.3f} ms)"
                                                    for s in samples[n0:])
                  + (f"; then e0<->fast at {rate / 1e9:.2f} Gbps" if e + 1 < REPLAN_EPOCHS else ""))
        admit["after"] = admitted(ctl)
        stats = ctl.stats()
        estimates = {es: dict(estimate_tflops=ctl.compute_estimator.rate(es) / 1e12,
                              nominal_tflops=ctl._nominal_flops[es] / 1e12,
                              ratio=ctl.compute_estimator.rate(es) / ctl._nominal_flops[es])
                     for es in topo.es_names}
        print(f"  {label} loop: {stats}; switches by link {causes['link']}, by compute {causes['compute']}; "
              "compute estimates vs nominal eff (TFLOP/s): " + ", ".join(
                  f"{es} {v['estimate_tflops']:.3f} / {v['nominal_tflops']:.3f} = {v['ratio']:.2f}x"
                  for es, v in estimates.items()))
        print(f"  {label} loop: plan_aware_batch_size at D = {DEADLINE_S * 1e3:.1f} ms, target "
              f"{ADMISSION_TARGETS[0]}, Table III's states {TABLE3_STATES}: before the collapse "
              f"{admit['before']}, after {admit['after']}")
        check(stats["epochs"] == REPLAN_EPOCHS, f"{label} loop: {stats['epochs']} epochs")
        return dict(stats=stats, switches=dict(causes), estimates=estimates, admitted=admit, epochs=epochs,
                    keys=keys, first=ctl.cache.peek((ctl._fingerprint, keys[0])))

    loops = {"joint": closed_loop(True), "link-only": closed_loop(False)}
    check(loops["link-only"]["switches"].get("compute", 0) == 0, "the link-only loop switched on compute")

    # (2) the adaptive replay beside the static plan: phase 11's fading fast
    # link, and a straggling fast ES
    cfg = ReplanConfig(n_tasks=4)
    static_plan = optimize_static(net, topo, cfg).plan
    lo, hi = REPLAY_BAND
    fading = GaussMarkovTrace(lo=lo, hi=hi, start=hi, seed=REPLAY_SEED).rates(REPLAY_EPOCHS)
    nom = topo.platform_of("fast").eff_flops
    straggler = [nom] * STRAGGLER_AT + [STRAGGLER_FACTOR * nom] * (STRAGGLER_EPOCHS - STRAGGLER_AT)
    replays = {}
    for name, kw in (("fading link", dict(link_rates={("e0", "fast"): fading, ("fast", "e0"): fading})),
                     ("straggler", dict(compute_rates={"fast": straggler}))):
        t0 = time.perf_counter()
        static = np.array([r["makespan"] for r in replay_trace(net, topo, StaticPlanner(static_plan), **kw)])
        actl = ReplanController(net, topo, cfg)
        adaptive = np.array([r["makespan"] for r in replay_trace(net, topo, actl, **kw)])
        host_s = time.perf_counter() - t0
        check(np.isfinite(static).all() and np.isfinite(adaptive).all() and len(static) == len(adaptive),
              f"the {name} replay lost epochs")
        st = actl.stats()
        replays[name] = dict(epochs=len(static), static_p50_ms=np.percentile(static, 50) * 1e3,
                             static_p99_ms=np.percentile(static, 99) * 1e3, static_mean_ms=static.mean() * 1e3,
                             adaptive_p50_ms=np.percentile(adaptive, 50) * 1e3,
                             adaptive_p99_ms=np.percentile(adaptive, 99) * 1e3,
                             adaptive_mean_ms=adaptive.mean() * 1e3, replans=st["replans"],
                             optimizer_calls=st["optimizer_calls"], hit_rate=st["cache_hit_rate"], host_s=host_s)
        r = replays[name]
        print(f"replay_trace, {name} ({len(static)} epochs): static p50 {r['static_p50_ms']:.4f} ms p99 "
              f"{r['static_p99_ms']:.4f}; adaptive p50 {r['adaptive_p50_ms']:.4f} p99 {r['adaptive_p99_ms']:.4f}; "
              f"{st['replans']} replans, {st['optimizer_calls']} optimizer calls, hit rate "
              f"{st['cache_hit_rate']:.3f} ({host_s:.2f} s of host)")

    # (3) the plan store: the joint loop's operating points into a fresh
    # file, then a restarted controller serves its first plan warm
    joint = loops["joint"]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_plans_"))
    try:
        path = tmp / "plans.sqlite"
        with PlanStore(path) as store:
            sctl = ReplanController(net, topo, cfg, store=store)
            miss_ms = []
            for key in joint["keys"]:
                t0 = time.perf_counter()
                sctl.prime(key)
                miss_ms.append((time.perf_counter() - t0) * 1e3)
            check(sctl.optimizer_calls == len(joint["keys"]) == len(store),
                  f"{sctl.optimizer_calls} optimizer calls for {len(joint['keys'])} operating points")
        with PlanStore(path) as store:
            warm = ReplanController(net, topo, cfg, store=store)
            t0 = time.perf_counter()
            first = warm.current()
            hit_ms = (time.perf_counter() - t0) * 1e3
            wstats = warm.stats()
        check(wstats["optimizer_calls"] == 0 and wstats["store_hits"] == 1, f"the restart was not warm: {wstats}")
        check(first == joint["first"] and first.plan == joint["first"].plan,
              "the store served another result than the closed loop's first")
        y = forward(first.plan, x4)
        check(torch.equal(y, served[0]["logits"]), "the store's plan gave other logits than the first plan's")
        keying = check_keying()
        check(keying.ok, f"check_keying refuses the port's sources: {keying}")
    finally:
        shutil.rmtree(tmp)
    store_rec = dict(points=len(joint["keys"]), miss_ms=miss_ms, hit_ms=hit_ms, warm_stats=wstats,
                     keying_checks=keying.checks)
    print(f"plan store: {len(joint['keys'])} operating points of the joint loop primed (misses, host ms "
          f"{[round(v, 3) for v in miss_ms]}); a restarted controller served its first plan as a store hit in "
          f"{hit_ms:.3f} ms, optimizer calls 0, the result == the loop's first, its forward bit-identical; "
          f"check_keying on the port's sources: {keying}")

    # (4) per-task placement over the 1 + 8 pool against the shared plan
    pool = placement_pool(card)
    sh = simulate_placement(net, shared_plan_placement(net, pool, 4))
    t0 = time.perf_counter()
    placed = place_tasks(net, pool, 4)
    place_s = time.perf_counter() - t0
    print(f"placement on the 1 + 8 pool (x{'/'.join(f'{s:g}' for s in ES_SCALES)}; {POOL_FAST_GBPS:g} / "
          f"{POOL_SLOW_GBPS:g} Gbps), 4 tasks, DES: shared plan avg delay {sh['avg_delay'] * 1e3:.4f} ms, makespan "
          f"{sh['total'] * 1e3:.4f}; place_tasks avg delay {placed.avg_delay * 1e3:.4f} ms, makespan "
          f"{placed.makespan * 1e3:.4f} (gain {1 - placed.avg_delay / sh['avg_delay']:.4f}), groups "
          f"{placed.placement.assignments}, {placed.evaluations} evaluations in {place_s:.3f} s of host")
    check(placed.avg_delay < sh["avg_delay"] and placed.makespan < sh["total"],
          "place_tasks does not beat the shared plan on the DES")
    task_plans = [serve_plan(p, k, f"place_tasks task {t}")
                  for t, (p, k) in enumerate(zip(placed.placement.plans, placed.knobs))]
    pctl = PlacementController(net, pool, cfg, placement_options=dict(optimize_final=False, swap_rounds=1))
    pctl.placement_for_epoch()
    results = {"before": pctl._active_result()}
    admit = {"before": admitted(pctl)}
    rate = PLACEMENT_COLLAPSE_GBPS * 1e9
    for _ in range(cfg.hysteresis + 2):
        for pair in (("e0", "e1"), ("e1", "e0")):
            pctl.observe_transfer(*pair, IMAGE_BYTES, 8.0 * IMAGE_BYTES / rate)
        pctl.placement_for_epoch()
    results["after"] = pctl._active_result()
    admit["after"] = admitted(pctl)
    controller_plans = {when: [serve_plan(p, k, f"PlacementController {when} the collapse, task {t}")
                               for t, (p, k) in enumerate(zip(r.placement.plans, r.knobs))]
                        for when, r in results.items()}
    pstats = pctl.stats()
    print(f"  PlacementController, e1's link collapsing to {PLACEMENT_COLLAPSE_GBPS:g} Gbps: {pstats}; groups "
          f"{results['before'].placement.assignments} -> {results['after'].placement.assignments}; predicted "
          f"b = 4 {results['before'].makespan * 1e3:.4f} -> {results['after'].makespan * 1e3:.4f} ms; "
          f"plan_aware_batch_size over it {admit['before']} -> {admit['after']}")
    check(pstats["replans"] >= 1, "the placement controller never re-placed under the collapse")

    launches = {"conv2d": conv2d_cuda.launches}
    phase_s = time.perf_counter() - t_start
    print(f"  phase 12: {phase_s:.1f} s; {len(served)} distinct plans served, K1 held at {len(holds)} shapes "
          f"(max |err| {max(r['max_abs_err'] for r in holds):.3g}); launches {launches}")
    for rec in served:
        del rec["plan"], rec["logits"]
    for loop in loops.values():
        del loop["keys"], loop["first"]
    report = dict(
        phase_s=phase_s, nvidia_smi=smi, loops=loops, replays=replays, store=store_rec,
        placement=dict(shared_avg_delay_ms=sh["avg_delay"] * 1e3, shared_makespan_ms=sh["total"] * 1e3,
                       avg_delay_ms=placed.avg_delay * 1e3, makespan_ms=placed.makespan * 1e3,
                       assignments=placed.placement.assignments, knobs=placed.knobs,
                       evaluations=placed.evaluations, host_s=place_s, plans=task_plans,
                       controller=dict(stats=pstats, admitted=admit, plans=controller_plans,
                                       assignments={w: r.placement.assignments for w, r in results.items()},
                                       predicted_ms={w: r.makespan * 1e3 for w, r in results.items()})),
        served=served, k1_holds=len(holds), k1_max_abs_err=max(r["max_abs_err"] for r in holds),
        launches=launches,
    )
    return report, launches, holds


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core import SCHEME_HALO, SCHEME_HS, plan_even, plan_halp
    from repro_torch.configs import get as get_arch
    from repro_torch.configs.steps import build
    from repro_torch.core.partition import _split_counts
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref
    from repro_torch.kernels.conv2d.ops import launch_config
    from repro_torch.kernels.halo_conv import halo_conv2d_cuda
    from repro_torch.launch.mesh import make_spatial_comm
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer_lm as lm
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
    smi = nvidia_smi()
    print(f"device: {kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi)

    # -- 2. build ------------------------------------------------------------
    build_s = _build.build_all()
    print(f"build: {sorted(_build.sources())} in {build_s:.1f} s")
    for name, log in _build.build_logs().items():
        if name == "attention":
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    k3_regs = k3_ptxas(_build.build_logs().get("attention", ""))
    check(len(k3_regs) == 60, f"ptxas reported {len(k3_regs)} K3 instantiations, expected 60")
    for r in k3_regs:
        print(f"  attention: flash_fwd {r['dtype']:8s} ({r['dqk']}, {r['dv']}) {r['copies']:7s} {r['block']}: "
              f"{r['registers']} registers, {r['spill_store_bytes']} / {r['spill_load_bytes']} bytes spill "
              f"stores / loads")

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
    vit_plan, vgg_np_plan = scheme_plans()
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
            config = launch_config(x, wt, **kw)
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
            t_ffma = max(bound_ms(flops, nbytes, dname, ffma=True))
            by = "operations" if ops_ms >= bytes_ms else "bytes"
            row = dict(shape=[n, h, w, cin, cout], k=k, stride=s, pad=p, groups=groups,
                       view=case["view"], path=case.get("path"), layer=case.get("layer"),
                       dtype=dname, per_forward=case["per_forward"], max_abs_err=err,
                       within_tol=ok, ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                       bound_ms=t_bound, ops_ms=ops_ms, bytes_ms=bytes_ms, bound_by=by,
                       ffma_bound_ms=t_ffma, **config, tflops=flops / t_kernel / 1e9)
            rows.append(row)
            print(f"conv {dname:8s} {case.get('path') or 'extra'} {case.get('layer') or ''} "
                  f"x{[n, h, w, cin]} -> {cout} k{k} s{s} p{p} g{groups}"
                  f"{' view' if case['view'] else ''} x{case['per_forward']}/fwd "
                  f"S={config['splits']} {config['gather']}: "
                  f"max_err {err:.3g} kernel {t_kernel:.4f} ms ({row['tflops']:.1f} TFLOP/s) "
                  f"plain {t_plain:.4f} ms F.conv2d {t_lib:.4f} ms bound {t_bound:.4f} ms ({by}; "
                  f"FFMA {t_ffma:.4f})")
            check(ok, f"kernel disagrees with its plain version: {row}")
    # K1 at the other widths of phase 10's latency curve (run_plan at batch
    # 1..CURVE_MAX_BATCH, float32): the split count follows M = b x Ho x Wo,
    # so every width's calls are held, not only MAX_BATCH's
    curve_rows = []
    for bw in range(1, CURVE_MAX_BATCH + 1):
        if bw == MAX_BATCH:
            continue
        for (n, h, w, cin, cout, k, s), c in sorted(conv_shapes(plan, bw).items()):
            x = torch.randn((n, h, w, cin), generator=gen, device="cuda")
            wt = math.sqrt(2.0 / (k * k * cin)) * torch.randn((k, k, cin, cout), generator=gen, device="cuda")
            b = 0.1 * torch.randn((cout,), generator=gen, device="cuda")
            kw = dict(stride=s, padding=0, groups=1)
            config = launch_config(x, wt, **kw)
            got, want = conv2d_cuda(x, wt, b, **kw), conv2d_ref(x, wt, b, **kw)
            diff = (got - want).abs()
            ok = bool((diff <= TOL["float32"] * (1 + want.abs())).all()) and bool(torch.isfinite(got).all())
            curve_rows.append(dict(batch=bw, shape=[n, h, w, cin, cout], k=k, stride=s, per_forward=c,
                                   max_abs_err=diff.max().item(), within_tol=ok, **config))
            check(ok, f"K1 disagrees with its plain version at batch {bw}: {curve_rows[-1]}")
    by_width = {bw: [r for r in curve_rows if r["batch"] == bw] for bw in range(1, CURVE_MAX_BATCH + 1)}
    by_width[MAX_BATCH] = [r for r in rows if r["path"] == "run_plan" and r["dtype"] == "float32"]
    print("conv float32 run_plan at every width of the latency curve: "
          + "; ".join(f"b={bw} {len(rs)} shapes, split counts {sorted({r['splits'] for r in rs})}, "
                      f"max_err {max(r['max_abs_err'] for r in rs):.3g}" for bw, rs in by_width.items()))

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
    # phase 7's Qwen3-4B: one call per layer of a prefill forward (causal)
    # and of a decode step (one query over the cache's first 64 keys)
    qcfg = get_arch("qwen3-4b").cfg
    lm_attn = dict(b=LM_BATCH, h=qcfg.n_heads, hkv=qcfg.n_kv_heads, d=qcfg.d_head, per_forward=qcfg.n_layers)
    attn_cases += [dict(lm_attn, t=LM_LEN, s=LM_LEN, causal=True, path="lm-prefill"),
                   dict(lm_attn, t=1, s=DECODE_STEPS, causal=False, path="lm-decode", cache=LM_LEN)]
    # phase 8's moonshot-v1-16b-a3b: 16 query heads over 16 KV heads (group
    # 1), D = 128, once per layer of its float32 forward and decode step
    mcfg = get_arch("moonshot-v1-16b-a3b").cfg
    moe_attn = dict(b=LM_BATCH, h=mcfg.n_heads, hkv=mcfg.n_kv_heads, d=mcfg.d_head, per_forward=MOE_F32_LAYERS)
    attn_cases += [dict(moe_attn, t=LM_LEN, s=LM_LEN, causal=True, path="moe-prefill"),
                   dict(moe_attn, t=1, s=DECODE_STEPS, causal=False, path="moe-decode", cache=LM_LEN)]
    # phase 9's DeepSeek-V3: MLA's 128 heads at query/key width 192 and value
    # width 128, v the value half of the [k_nope | v] expansion (a strided
    # view), once per layer of its float32 forward and of a decode step at
    # position DECODE_STEPS (its 65 keys)
    dm = get_arch("deepseek-v3-671b").cfg.mla
    mla_attn = dict(b=LM_BATCH, h=dm.n_heads, hkv=dm.n_heads, d=dm.qk_head_dim, dv=dm.v_head_dim,
                    v_width=dm.qk_nope_head_dim + dm.v_head_dim, per_forward=MLA_LAYERS)
    attn_cases += [dict(mla_attn, t=LM_LEN, s=LM_LEN, causal=True, path="mla-prefill"),
                   dict(mla_attn, t=1, s=DECODE_STEPS + 1, causal=False, path="mla-decode")]
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

    fwd_ms, busy_ms, top, fams = steady_and_profiled(torch, lambda: forward(images), "run_plan")

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
        fwd_sp, busy_sp, top_sp, fams_sp = steady_and_profiled(torch, spatial_forward, f"spatial {name}")
        spatial[name] = dict(heights=list(heights), launches=got, lossless_max_abs=sp_err.max().item(),
                             plain_depth_max_abs=sp_depth, k2_rows_asked=asked, k2_rows_valid=useful,
                             steady_forward_ms=fwd_sp, device_busy_ms=busy_sp, top_device=top_sp,
                             device_ms_by_kernel=fams_sp)

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
    # the largest |score| K3 meets at depth: one forward with the attention
    # layer's call recorded (outside the counted run)
    depth_scores = []

    def recording(q, k, v, *, causal):
        depth_scores.append((torch.einsum("bhtd,bhsd->bhts", q, k) / math.sqrt(q.shape[-1]))
                            .abs().max().item())
        return flash_attention(q, k, v, causal=causal)

    vit_spatial.flash_attention = recording
    try:
        vit_forward()
    finally:
        vit_spatial.flash_attention = flash_attention
    print(f"  largest |score| in the forward's {len(depth_scores)} K3 calls: {max(depth_scores):.4g} "
          f"(per block, largest first: {sorted(depth_scores, reverse=True)[:3]})")
    # the same forward in bfloat16: K3's bf16 path at depth.  It is held to
    # the float32 card forward of the same, bf16-rounded, weights and images
    # (the model it runs); beside that, its gap to the float32 forward of the
    # float32 weights and the gap of a bf16 forward through the plain
    # versions (patched in for one run): what rounding the weights costs
    # without the kernels.
    from repro_torch.kernels.attention import attention_ref
    from repro_torch.models import layers

    bparams = tree_map(lambda t: t.to(torch.bfloat16), vparams)
    bimages = vimages.to(torch.bfloat16)

    def vit_forward_bf16():
        return vit_spatial.head(bparams, run_plan(vit_plan, bparams["features"], vit_spatial.apply_layer,
                                                  bimages))

    flash_attention.launches = 0
    blogits = vit_forward_bf16()
    torch.cuda.synchronize()
    b_launches = flash_attention.launches
    check(b_launches == want_vit["flash_attention"], f"bf16 ViT launched K3 {b_launches} times")
    check(blogits.dtype == torch.bfloat16, f"bf16 ViT logits are {blogits.dtype}")
    check(bool(torch.isfinite(blogits.float()).all()), "non-finite bf16 ViT logits")
    rparams = tree_map(lambda t: t.to(torch.bfloat16).float(), vparams)
    rlogits = vit_spatial.head(rparams, run_plan(vit_plan, rparams["features"], vit_spatial.apply_layer,
                                                 bimages.float()))
    layers.conv2d_cuda, vit_spatial.flash_attention = conv2d_ref, attention_ref
    try:
        bplain = vit_forward_bf16()
    finally:
        layers.conv2d_cuda, vit_spatial.flash_attention = conv2d_cuda, flash_attention
    b_err = (blogits.float() - rlogits).abs().max().item()
    b_scale = rlogits.abs().max().item()
    b_f32w = (blogits.float() - vlogits).abs().max().item()
    b_plain = (bplain.float() - vlogits).abs().max().item()
    print(f"  bfloat16 forward: K3 launches {b_launches}; vs the float32 forward of the bf16-rounded "
          f"weights and images: max |diff| {b_err:.4g} (max |logit| {b_scale:.4g}, limit {BF16_RTOL} x "
          f"that); vs the float32 weights' forward: {b_f32w:.4g} (the plain versions in bf16: "
          f"{b_plain:.4g})")
    check(b_err <= BF16_RTOL * b_scale, "the bfloat16 ViT drifts from the float32 forward")
    vit_ms, vit_busy, vit_top, vit_fams = steady_and_profiled(torch, vit_forward, "vit run_plan")

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
    np_ms, np_busy, np_top, np_fams = steady_and_profiled(torch, np_forward, "vgg non_penetrative run_plan")

    # -- 7. full-width Qwen3-4B: prefill and KV-cache decode ------------------
    phase7_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    arch = get_arch("qwen3-4b")
    check((qcfg.n_layers, qcfg.d_model, qcfg.n_heads, qcfg.n_kv_heads, qcfg.d_head, qcfg.d_ff, qcfg.vocab,
           qcfg.qk_norm) == (36, 2560, 32, 8, 128, 9728, 151936, True), f"qwen3-4b is not full width: {qcfg}")
    prefill = build(arch, "prefill_32k", dtype=torch.float32)
    decode = build(arch, "decode_32k", dtype=torch.float32)
    check((prefill.kind, decode.kind) == ("prefill", "decode"), f"kinds {prefill.kind}, {decode.kind}")
    lgen = torch.Generator(device="cuda").manual_seed(2)
    t0 = time.perf_counter()
    lparams = lm.init(lgen, qcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = dict_leaves(lparams)
    check([(tuple(t.shape), t.dtype) for t in leaves] == dict_leaves(prefill.state),
          "the weights do not match the bundle's shapes")
    n_params = sum(t.numel() for t in leaves)
    tokens = torch.randint(0, qcfg.vocab, (LM_BATCH, LM_LEN), generator=lgen, device="cuda", dtype=torch.int32)
    print(f"qwen3-4b: {n_params / 1e9:.4f} B parameters ({n_params * 4 / 1e9:.2f} GB float32) drawn on the "
          f"card in {init_s:.2f} s; prefill of {LM_BATCH} x {LM_LEN} tokens (cell prefill_32k: "
          f"{prefill.inputs['tokens'][0]}), {DECODE_STEPS} decode steps")

    # (1) float32 prefill: K3 once per layer, no SDPA operator in the profile
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    flash_attention.launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        llogits = prefill.fn(lparams, tokens)
        torch.cuda.synchronize()
    lm_launches = flash_attention.launches
    sdpa_rows = sdpa_ops(prof)
    print(f"  float32 prefill: K3 launches {lm_launches} (one per layer: {qcfg.n_layers}); "
          f"SDPA operators in its profile: {sdpa_rows or 'none'}")
    check(lm_launches == qcfg.n_layers, f"the prefill launched K3 {lm_launches} times")
    check(not sdpa_rows, f"the prefill ran {sdpa_rows}")
    check(tuple(llogits.shape) == (LM_BATCH, LM_LEN, qcfg.vocab), f"LM logits {tuple(llogits.shape)}")
    check(bool(torch.isfinite(llogits).all()), "non-finite LM logits")
    l_scale = llogits.abs().max().item()

    # (2) the same forward with the plain attention on the card
    lplain = with_plain_attention(lambda: prefill.fn(lparams, tokens))
    l_plain_err = (llogits - lplain).abs().max().item()
    print(f"  vs the same forward with the plain attention on the card: max |diff| {l_plain_err:.4g} "
          f"(max |logit| {l_scale:.4g}, limit {DEPTH_RTOL} x that)")
    check(l_plain_err <= DEPTH_RTOL * l_scale, "the LM through K3 drifts from its plain attention")
    del lplain

    # (3) the plain versions on the CPU, float32, the first CPU_TOKENS tokens
    # of batch element 0 (the mask is causal, so a prefix gives the same logits)
    t0 = time.perf_counter()
    cparams = tree_map(lambda t: t.cpu(), lparams)
    ctokens = tokens[:1, :CPU_TOKENS].cpu()
    clogits = lm.forward(cparams, qcfg, ctokens)[0][0]
    cpu_s = time.perf_counter() - t0
    del cparams
    c_err = (llogits[0, :CPU_TOKENS].cpu() - clogits).abs().max().item()
    c_scale = clogits.abs().max().item()
    print(f"  vs the plain versions' forward on the CPU (float32, all {qcfg.n_layers} layers, tokens "
          f"0..{CPU_TOKENS - 1} of batch element 0; {cpu_s:.1f} s with the host copy): max |diff| "
          f"{c_err:.4g} (max |logit| {c_scale:.4g}, limit {DEPTH_RTOL} x that)")
    check(c_err <= DEPTH_RTOL * c_scale, "the LM drifts from the plain versions on the CPU")

    # (4) teacher-forced KV-cache decode: each step's logits against the
    # prefill's at its position
    cache = lm.init_cache(qcfg, LM_BATCH, LM_LEN, device="cuda")
    check(tuple(cache["dense"]["k"].shape) == (qcfg.n_layers, LM_BATCH, LM_LEN, qcfg.n_kv_heads, qcfg.d_head),
          f"cache {tuple(cache['dense']['k'].shape)}")
    flash_attention.launches = 0
    d_errs = []
    for i in range(DECODE_STEPS):
        step_logits, cache = decode.fn(lparams, cache, tokens[:, i:i + 1], i)
        d_errs.append((step_logits - llogits[:, i]).abs().max())
    torch.cuda.synchronize()
    decode_launches = flash_attention.launches
    d_errs = torch.stack(d_errs).cpu()
    print(f"  {DECODE_STEPS} decode steps: K3 launches {decode_launches} ({qcfg.n_layers} per step); "
          f"largest |decode - prefill| {d_errs.max().item():.4g} at step {int(d_errs.argmax())} "
          f"(limit {DEPTH_RTOL} x {l_scale:.4g})")
    check(decode_launches == qcfg.n_layers * DECODE_STEPS, f"decode launched K3 {decode_launches} times")
    check(d_errs.max().item() <= DEPTH_RTOL * l_scale, "decode drifts from the prefill's logits")

    # where the time goes: a steady float32 prefill and decode step
    lm_ms, lm_busy, lm_top, lm_fams = steady_and_profiled(
        torch, lambda: prefill.fn(lparams, tokens), "qwen3-4b float32 prefill")
    step_tok = tokens[:, DECODE_STEPS:DECODE_STEPS + 1]
    dec_ms, dec_busy, dec_top, dec_fams = steady_and_profiled(
        torch, lambda: decode.fn(lparams, cache, step_tok, DECODE_STEPS), "qwen3-4b float32 decode step")
    print(f"  tokens/s: prefill {LM_BATCH * LM_LEN / lm_ms * 1e3:.1f}, decode {LM_BATCH / dec_ms * 1e3:.1f} "
          f"(batch {LM_BATCH}, step at position {DECODE_STEPS})")
    del cache

    # (5) bfloat16: the float32 weights are freed first; the reference is the
    # float32 forward of the same bf16-rounded weights
    bparams = tree_map(lambda t: t.to(torch.bfloat16), lparams)
    del lparams, leaves
    torch.cuda.empty_cache()
    flash_attention.launches = 0
    bl = prefill.fn(bparams, tokens)
    torch.cuda.synchronize()
    bl_launches = flash_attention.launches
    check(bl_launches == qcfg.n_layers, f"the bf16 prefill launched K3 {bl_launches} times")
    check(bl.dtype == torch.bfloat16 and bool(torch.isfinite(bl.float()).all()), "bad bf16 LM logits")
    bl_plain = with_plain_attention(lambda: prefill.fn(bparams, tokens))
    rparams = tree_map(lambda t: t.float(), bparams)
    rl = prefill.fn(rparams, tokens)
    del rparams
    torch.cuda.empty_cache()
    bl_err = (bl.float() - rl).abs().max().item()
    bl_plain_err = (bl_plain.float() - rl).abs().max().item()
    bl_scale = rl.abs().max().item()
    bl_f32w = (bl.float() - llogits).abs().max().item()
    bl_plain_f32w = (bl_plain.float() - llogits).abs().max().item()
    bl_limit = max(BF16_RTOL * bl_scale, 1.25 * bl_plain_err)
    print(f"  bfloat16 prefill: K3 launches {bl_launches}; vs the float32 forward of the bf16-rounded "
          f"weights: max |diff| {bl_err:.4g} (max |logit| {bl_scale:.4g}; the plain versions in bf16: "
          f"{bl_plain_err:.4g}; limit {bl_limit:.4g} = the larger of {BF16_RTOL} x max |logit| and 1.25 x "
          f"the plain gap); vs the float32 weights' forward: {bl_f32w:.4g} (plain: {bl_plain_f32w:.4g})")
    check(bl_err <= bl_limit, "the bfloat16 LM drifts from the float32 forward")
    del bl, bl_plain, rl
    bf_ms, bf_busy, bf_top, bf_fams = steady_and_profiled(
        torch, lambda: prefill.fn(bparams, tokens), "qwen3-4b bfloat16 prefill")
    print(f"  tokens/s: bf16 prefill {LM_BATCH * LM_LEN / bf_ms * 1e3:.1f}")
    del bparams, llogits
    torch.cuda.empty_cache()
    peak_gb, phase7_s = torch.cuda.max_memory_allocated() / 1e9, time.perf_counter() - phase7_t0
    print(f"  phase 7: {phase7_s:.1f} s, peak device memory allocated {peak_gb:.2f} GB")
    lm_report = dict(phase_s=phase7_s, peak_device_gb=peak_gb,
        config={k: getattr(qcfg, k) for k in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
                                               "d_ff", "vocab", "qk_norm", "rope_theta")},
        n_params=n_params, init_s=init_s, batch=LM_BATCH, seq_len=LM_LEN, decode_steps=DECODE_STEPS,
        prefill_launches=lm_launches, decode_launches=decode_launches, bf16_launches=bl_launches,
        sdpa_ops=sdpa_rows, max_abs_logit=l_scale, plain_attention_max_abs=l_plain_err,
        cpu_tokens=CPU_TOKENS, cpu_max_abs=c_err, cpu_s=cpu_s, decode_max_abs=d_errs.max().item(),
        bf16_max_abs=bl_err, bf16_plain_max_abs=bl_plain_err, bf16_max_abs_logit=bl_scale,
        bf16_limit=bl_limit, bf16_vs_f32_weights=bl_f32w, bf16_plain_vs_f32_weights=bl_plain_f32w,
        prefill=dict(steady_ms=lm_ms, device_busy_ms=lm_busy, top_device=lm_top, device_ms_by_kernel=lm_fams,
                     tokens_per_s=LM_BATCH * LM_LEN / lm_ms * 1e3),
        decode=dict(steady_ms=dec_ms, device_busy_ms=dec_busy, top_device=dec_top, device_ms_by_kernel=dec_fams,
                    tokens_per_s=LM_BATCH / dec_ms * 1e3, index=DECODE_STEPS),
        bf16_prefill=dict(steady_ms=bf_ms, device_busy_ms=bf_busy, top_device=bf_top,
                          device_ms_by_kernel=bf_fams, tokens_per_s=LM_BATCH * LM_LEN / bf_ms * 1e3),
    )

    # -- 8. full-width moonshot-v1-16b-a3b: the MoE layer, prefill and decode -
    moe_report, moe_launches = phase_moe(torch)

    # -- 9. full-width DeepSeek-V3 at 4 layers: MLA, prefill and latent-cache decode
    mla_report, mla_launches = phase_mla(torch)

    # -- 10. the plan analysers and deadline-aware serving of VGG-16 ----------
    serving_report, serving_launches = phase_serving(torch, params, out["images"], plain)

    # -- 11. the latency engines and plan search, priced on the card ---------
    engines_report, engines_launches, engines_holds = phase_engines(
        torch, serving_report["curve_ms"], params, out["images"], plain, single)

    # -- 12. online re-planning, the plan store and per-task placement -------
    replan_report, replan_launches, replan_holds = phase_replan(
        torch, engines_report, params, out["images"], plain, single)

    # -- result --------------------------------------------------------------
    # each kernel's numbers summed over one forward of every main path that
    # launches it: run_plan (phase 4) and the two spatial layouts (phase 5);
    # launches also count phase 10's path
    main_rows = [r for r in rows if r["per_forward"] and r["dtype"] == "float32"]
    fix_rows = [r for r in main_rows if r["path"] == "weighted-fixup"]
    main_rows += engines_holds
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
              + got_vit["conv2d"] + np_launches + serving_launches["conv2d"] + engines_launches["conv2d"]
              + replan_launches["conv2d"]),
        entry("halo_conv2d", "src/repro_torch/kernels/halo_conv/halo_conv.cu",
              "src/repro/kernels/halo_conv/halo_conv.py:30", halo_main,
              sum(v["launches"]["halo_conv2d"] for v in spatial.values()) + serving_launches["halo_conv2d"]),
        entry("flash_attention", "src/repro_torch/kernels/attention/attention.cu",
              "src/repro/kernels/attention/attention.py:20", attn_main,
              got_vit["flash_attention"] + lm_launches + decode_launches + moe_launches
              + sum(mla_launches.values())),
    ]
    # phase 12's holds are untimed: they add to K1's error, not to its times
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], max(r["max_abs_err"] for r in replan_holds))
    per_path = {path: {key: per_fwd([r for r in main_rows if r["path"] == path], key)
                       for key in ("ms", "plain_ms", "library_ms", "bound_ms", "ffma_bound_ms")}
                for path in ("run_plan", "weighted-fixup", "vit", "vgg-np", "engines")}
    # K3 per forward of each path (the LM's decode: per step), and device ms
    # per forward from the profiler windows (us per call x calls per forward)
    k3_per_path = {}
    for path in ("vit", "lm-prefill", "lm-decode", "moe-prefill", "moe-decode", "mla-prefill", "mla-decode"):
        rs = [r for r in attn_main if r["path"] == path]
        k3_per_path[path] = {key: per_fwd(rs, key) for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "ffma_bound_ms", "bf16_ms", "bf16_library_ms",
            "bf16_bound_ms")}
        k3_per_path[path].update({key.replace("us", "ms"): per_fwd(rs, key) / 1e3
                                  for key in ("device_us", "library_device_us", "host_us",
                                              "bf16_device_us", "bf16_library_device_us")})
    per_path["vit"]["flash_attention"] = k3_per_path["vit"]
    for name, v in per_path.items():
        print(f"K1 per forward of {name}: {json.dumps(v)}")
    for name in ("lm-prefill", "lm-decode", "moe-prefill", "moe-decode", "mla-prefill", "mla-decode"):
        print(f"K3 per {'step' if name.endswith('decode') else 'forward'} of {name}: "
              f"{json.dumps(k3_per_path[name])}")
    conv_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ffma_bound_ms")
    by_layout = {name: {key: per_fwd([r for r in halo_main if r["layout"] == name], key)
                        for key in conv_keys}
                 for name in spatial}
    by_layout["weighted"]["fixup_conv2d"] = {key: per_fwd(fix_rows, key) for key in conv_keys}
    for name, v in by_layout.items():
        print(f"per forward of spatial {name}: {json.dumps(v)}")
    report = {
        "device": kind, "nvidia_smi": smi, "build_s": build_s, "k3_ptxas": k3_regs, "conv_cases": rows,
        "serve": dict(stats, wall_s=out["wall_s"], requests_per_s=out["requests_per_s"],
                      n_requests=N_REQUESTS, max_batch=MAX_BATCH, launches=launches,
                      batch_done_ms=batch_done, first_submission_ms=first * 1e3,
                      lossless_max_abs=lossless_err, plain_depth_max_abs=depth_err,
                      steady_forward_ms=fwd_ms, device_busy_ms=busy_ms, top_device=top,
                      device_ms_by_kernel=fams),
        "curve_conv_cases": curve_rows, "halo_cases": halo_rows, "spatial": spatial,
        "spatial_per_forward": by_layout, "attention_cases": attn_rows,
        "vit": dict(segments=[(sg.scheme, sg.start, sg.stop) for sg in vit_plan.segments],
                    ratios=vit_plan.ratios, launches=got_vit, lossless_max_abs=v_err.max().item(),
                    lossless_limit_share=v_share, max_abs_score=max(depth_scores),
                    bf16_max_abs_diff=b_err, bf16_vs_f32_weights=b_f32w, bf16_plain_vs_f32_weights=b_plain,
                    bf16_launches=b_launches,
                    plain_depth_max_abs=v_depth, max_abs_logit=v_scale, steady_forward_ms=vit_ms,
                    device_busy_ms=vit_busy, top_device=vit_top, device_ms_by_kernel=vit_fams),
        "vgg_np": dict(launches=np_launches, lossless_max_abs=np_err.max().item(),
                       plain_depth_max_abs=np_depth, steady_forward_ms=np_ms,
                       device_busy_ms=np_busy, top_device=np_top, device_ms_by_kernel=np_fams),
        "lm": lm_report, "moe": moe_report, "mla": mla_report, "serving": serving_report,
        "engines": engines_report, "replan": replan_report,
        "k3_per_forward": k3_per_path,
        "k1_per_forward": per_path, "kernels": kernels,
        "note": "in kernels, ms, plain_ms, library_ms and bound_ms are float32 sums over one "
                "forward of each main path that launches the kernel (batch 4): conv2d over a "
                "run_plan forward (39 calls), the weighted spatial forward's 52 fix-up convs, "
                "a ViT-L/16 scheme-plan forward (221 calls), a VGG-16 non_penetrative "
                "forward (39 calls) and a forward of phase 11's searched plan (39 calls); halo_conv2d over one weighted (52 calls) and one equal "
                "(91 calls) spatial forward; flash_attention over a ViT-L/16 forward (72 "
                "calls), a Qwen3-4B prefill forward of 4 x 512 tokens (36 calls) and one of its "
                "decode steps at position 64 (36 calls), and a 6-layer float32 moonshot-v1-16b-a3b "
                "prefill (6 calls) and decode step at position 64 (6 calls), and a 4-layer float32 "
                "DeepSeek-V3 prefill (4 calls, MLA: query/key width 192, value width 128) and decode step "
                "at position 64 (4 calls).  launches count every "
                "main-path run: the 4 served batches, one forward of each spatial layout, one ViT "
                "forward, one VGG-NP forward, one float32 Qwen3-4B prefill and its 64 decode steps, "
                "and moonshot's 6-layer float32 prefill, its 64 decode steps and its bf16 prefill "
                "(6 + 384 + 6), its 48-layer bf16 prefill and 16 decode steps (48 + 768), and "
                "DeepSeek-V3's 4-layer float32 prefill and 64 decode steps and bf16 prefill and 16 decode "
                "steps (4 + 256 + 4 + 64); phase 10 adds K1's launches in its latency curve (9 forwards "
                "at each batch width 1..8, two profiled) and its live burst, and one K2 launch per conv "
                "geometry its probe accepted; phase 11 adds K1's launches in 8 forwards of the searched "
                "plan (one under run_plan(verify=True), one warm-up, 5 steady calls and one profiled); "
                "phase 12 adds K1's launches in the forwards of every plan its controllers serve (per "
                "distinct plan one lossless, one warm-up and 5 steady forwards; one served batch per "
                "closed-loop epoch; the warm restart's forward).  conv2d's max_abs_err also covers "
                "phase 12's untimed holds at every shape its plans give K1.",
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
