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
13. serves the vision family at full width (``phase_vision``): ViT-L/16,
   Swin-B, ConvNeXt-B (224) and EfficientNet-B7 (600), seeded random
   weights, each (1) through ``launch.serve.serve`` (16 requests at
   ``max_batch=4``; p50, p99, req/s); (2) one float32 and one bfloat16
   forward at batch 4 whose K1 launches (depthwise apart) and K3 launches
   must be ``VISION_LAUNCHES`` (1 / 1 / 40 / 163, 0 / 0 / 36 / 55
   depthwise; ViT 24 K3), with no SDPA operator in the float32 profile;
   (3) ``configs.steps.build``'s ``serve_b1`` (bfloat16 at 224) held to the
   float32 forward of the same bf16-rounded weights within ``BF16_RTOL`` of
   its largest |logit|, or 1.25x the plain versions' own bfloat16 gap where
   that is larger (phase 7's rule), and ``serve_b128`` counted, then timed
   (ms, images/s); (4) every K1 / K3 call of the float32 forward held to
   its plain version on the same activations (``held_on_path``), and image 0
   held to the plain versions' float32 forward on the CPU within
   ``DEPTH_RTOL`` (the plain versions on the card printed beside) --
   ConvNeXt also with every gamma 1 (layer_scale 1.0), since 1e-6 would
   hide a wrong depthwise conv; EfficientNet-B7 with its batch norms'
   statistics taken from the batch (``calibrated_bn``: at JAX's init
   statistics its activations grow to ~1e6 and two correct float32
   forwards part, which is printed as a record); (5) K1 (dense and
   depthwise) and K3 held against their plain versions at every call
   signature those forwards made, the batch-4 float32 ones timed beside
   ``F.conv2d`` / SDPA (never on the path), device us from profiler
   windows and the bound, each depthwise signature's copy variant and
   tile recorded (``launch_config``) and required to take 16-byte channel
   vectors; (6) steady float32 and bfloat16 forwards at batch
   4 timed and profiled (device ms by family: K1, K1 depthwise, K3, GEMM,
   other) and the peak device memory.
14. generates with the diffusion family at full width (``phase_diffusion``):
   UNet-SD1.5 and DiT-XL/2, seeded random weights (DiT's adaLN-zero
   weights drawn, else every block is the identity), each (1) one float32
   forward at batch 4 at ``gen_fast``'s 512 (latent 64) whose K1 and K3
   launches must be ``DIFFUSION_LAUNCHES`` (66 / 32; 1 / 28), with no SDPA
   operator in its profile and every K1 / K3 call held to its plain version
   on the path's own activations, then the same in bfloat16, counted; (2)
   image 0 of a float32 forward at 256 held to the plain versions' forward
   on the CPU within ``DEPTH_RTOL`` (the plain versions on the card
   beside); (3) ``configs.steps.build``'s ``gen_fast`` whole (bfloat16,
   batch 16, 4 DDIM steps): counted, timed (s a call, latents/s) and held to
   the float32 sampler of the same bf16-rounded weights by phase 7's rule;
   (4) ``gen_1024`` (bfloat16, batch 4, latent 128) with its 50 steps cut to
   ``GEN_1024_STEPS``: counted, timed, every kernel call held on its own
   activations (K3's plain version one (batch, head) slice at a time past
   ``PLAIN_LOGITS_BYTES``: T = 16384 at D = 40); (5) K1 and K3 held at every
   call signature of those runs, the batch-4 float32 ones timed beside
   ``F.conv2d`` / SDPA with device us and the bound; (6) steady float32 and
   bfloat16 forwards at batch 4 timed and profiled (device ms by family),
   peak device memory.  Phase 2 prints the registers and spills of K3's
   second library (``attention_diffusion.cu``: D = 40, 72, 80, 160).
15. trains the vision family through ``configs.steps``' cls_224 and
   cls_384 cells (``phase_train``): ViT-L/16, Swin-B, ConvNeXt-B and
   EfficientNet-B7 at full width, seeded random weights, TF32 off, each
   rematerialised as JAX's ``jax.checkpoint`` runs it (ViT every block,
   Swin-B the pairs of its depth-18 stage, ConvNeXt-B the blocks of its
   depth-27 stage): (a) K1 and its autograd Function held against the
   plain version and autograd through it in float32 on the same values at
   every K1 signature of a batch-4 step of each cell (the output, dx where
   the input needs one, dW, db within 2e-5 x (1 + |g|) plus ``SUM_RTOL`` x
   the sum of |terms|), and K3's Function at ViT's [4, 16, 197, 64] and
   [4, 16, 577, 64], with K3's forward and plain backward device us; (b)
   one float32 step of each at cls_224 and batch 4 from a warm state
   (``warm_state``) held to the same step through the plain versions: the
   loss within ``DEPTH_RTOL``, and leaf by leaf each new first moment (the
   clipped gradient / 10) and each update within ``TRAIN_LEAF_RTOL`` of
   that leaf's own largest (``leaf_shares``), a control step with one K1
   call's output gradient scaled by ``TRAIN_CONTROL`` breaking that hold,
   the same step with remat off bit-identical; K1's launches (forward and
   recompute), its backward ones (each stride-1 conv whose input needs a
   gradient, once) and K3's counted against the recorded calls, phase 13's
   ``VISION_LAUNCHES`` plus ``REMAT_LAUNCHES``; one such step profiled
   with the backward's parts apart ("K1 dgrad", the library's dgrad and
   wgrad, "K3 backward"); (c) for each cell ``TRAIN_STEPS`` bfloat16 steps
   through the fault-tolerant trainer (``cell_trainer``:
   ``runtime.train.make_trainer``'s parts) at the cell's batch (256 /
   64) or, where a fit of two probe steps' peak memory up to the update
   (``split_peaks``) and the trainer's entry state says it does not fit,
   the largest power of two that does (printed as reduced, with the fit's
   predicted peak beside the measured one): step ms, images/s, TFLOP/s
   (``step_flops_of``: ``FlopCounterMode``'s count, the convs from their
   shapes, K3's forwards, the recompute as it ran) fed to a
   ``ComputeRateEstimator`` by the trainer's ``compute_observer``, one
   step profiled by part, at cls_224 its K1 and K3 signatures held as in
   (a) in bfloat16 at that batch; (d) ViT-L/16 cut to ``FAULT_LAYERS``
   layers, bfloat16 at batch 256: ``FAULT_STEPS`` steps checkpointed every
   ``FAULT_EVERY`` with faults injected at ``FAULT_AT``, every final leaf
   ``torch.equal`` to an uninterrupted run's, failures and restores both
   exactly ``len(FAULT_AT)``.
16. trains the LM and diffusion families through ``configs.steps``' train
   cells (``phase_lm_diffusion_train``), TF32 off, seeded random weights:
   (a) K3's autograd Function held against the plain version's autograd in
   float32 at Qwen3-4B's [1, 32, 4096, 128] causal GQA (8 KV heads),
   DeepSeek-V3's (192, 128) at [1, 128, 512], the U-Net's D = 40 at T =
   1024 and its cross-attention at S = 77 for D = 40 / 80 / 160, DiT's D =
   72 at T = 256 (o, dq, dk, dv within 2e-5 x (1 + |g|) plus ``SUM_RTOL``
   x the sum of |terms|), each timed beside its plain backward, that
   backward's bound and SDPA's forward + backward; the U-Net's T = 16384
   timed only; K1's Function at every K1 signature of a U-Net train_256
   step; (b) float32 steps from ``warm_state`` held to the same steps
   through the plain versions (``held_step``: the loss within
   ``DEPTH_RTOL``, each first moment and update within
   ``TRAIN_LEAF_RTOL``; a control with one K3 call's output gradient scaled
   must break it): Qwen3-4B at full width cut to ``LM_CHECK_LAYERS`` layers
   at 1 x 4096 tokens, the U-Net and DiT at train_256 and batch 4; remat on
   against off equal (``same_step``); K3 / K1 launches (forward, recompute,
   K1 dgrad) counted against the recorded calls; (c) bfloat16 through the
   fault-tolerant trainer (``train_bf16``): Qwen3-4B at all 36 layers at
   4096 tokens with remat, the U-Net and DiT at train_256, each at the
   cell's batch of 256 or the largest power of two two probe steps' peak
   memory (up to the update: ``split_peaks``) fits, ``TRAIN16_STEPS``
   steps timed (ms, tokens or latents/s, TFLOP/s, peak memory) and one
   profiled by part; one train_1024 step of each at the batch that fits;
   (d) DeepSeek-V3's ``loss_fn`` with its MTP module at full width (1 dense
   trunk layer, no MoE trunk layer, 14.1 B parameters, bf16, no AdamW
   step: its moments do not fit) at 1 x 512 tokens, its metrics and every
   gradient held to the same pass with plain attention (``mtp_pass``),
   route aware.

17. drives the script twins (``examples/*_torch.py``, ``tools/*_torch.py``)
   through their functions in-process at full width (``phase_scripts``):
   (a) quickstart at VGG-16 224 x 224, width 1.0, batch 1 -- ``run_plan``
   through K1 lossless against the single-device forward; (b) serve_halp at
   VGG-16's full config -- latency curve at b = 1, 2, 4, 8, the admitted
   batch (>= 1), 48 requests all completed, p50 / p99, req/s, per-ES
   GFLOP/s (one window, under the call recorder), the first served batch's
   logits (recomputed through its plan) within 2e-5 x (1 + |y|) of the
   single-device forward and its class ids the single-device argmax; (c)
   replan_channel at full-width VGG-16, its link rates times its
   ``link_scale`` (28: a row crosses a link in the demo's time) -- section 3
   served through K1, section 4 lossless; (d)
   train_fault_tolerant on full-width ViT-L/16 (cls_224, bf16) through phase
   15's ``cell_trainer`` at ``SCRIPTS_TRAIN_BATCH``, ``SCRIPTS_TRAIN_STEPS``
   steps with faults at ``SCRIPTS_FAULTS_AT`` and a checkpoint every
   ``SCRIPTS_CKPT_EVERY`` -- the chaos run's final state bit-identical to the
   uninterrupted run's, K1's and K3's Functions held at its signatures;
   (e) precompute_plans_torch --smoke into a temporary store, check_torch
   --store --benchmarks exiting 0, one K2 launch at each geometry its kernel
   pass probed, and a restarted controller serving all 12 lattice points
   with 0 optimizer calls, each plan lossless through K1.  Every K1 call
   signature of (a)-(c) is held to the plain version; each part's K1 / K3
   launches are counted against its forwards and steps.  It prints one JSON
   line ``{"phase17": ...}`` before the kernels line.

18. the parallel modules and the dry run (``phase_parallel``): (a) GPipe
   (``parallel.pipeline_apply``) over a ``LocalComm`` of 2 stages on the
   card: full-width ViT-L/16 (224 x 224, seeded weights), 12 blocks a stage,
   8 microbatches of 4 images, the patch embedding (K1, once a microbatch)
   and the head outside the pipeline, float32 (TF32 off) and bfloat16 --
   each microbatch bit-identical to the same 24 blocks run unpipelined, the
   logits within 2e-5 x (1 + |y|) of ``vit.apply`` at batch 32 (bf16: 2e-2
   of the largest |logit| of the float32 forward of its rounded weights),
   216 K3 and 8 K1 launches; pipelined and unpipelined ms (median of 10,
   CUDA events) beside 1 / (1 - bubble_fraction(2, 8)) = 1.125; (b)
   ``launch.dryrun.run_cell`` on a 1-device mesh at ViT-L/16 cls_224 (bf16,
   batch 128), Qwen3-4B prefill_32k at 4 x 512 and UNet-SD1.5 gen_fast,
   each against the same bundle realised and run on the card: the argument
   bytes placed (512-byte blocks) equal, the K1 / K3 call signatures and
   counts equal to those the wrappers record in one step or forward,
   ViT's step operations equal to ``step_flops_of``; the peak of live bytes
   beside the card's peak memory as a ratio.  It prints one JSON line
   ``{"phase18": ...}`` before the kernels line.

19. the kernels' sharding rules (``phase_collectives``): on a (2, 4)
   ("data", "model") mesh emulated on the card, ``launch.dryrun.run_cell``
   (the collective pass, meta tensors on the host) logs every kernel call
   with its operands' placements, then the same bundle runs unsharded on
   the card with every K1 / K3 call (and ViT's backward calls) replayed on
   the 8 ranks by ``parallel.kernel_rules.replaying``: each rank's blocks
   cut by the logged placements, redistributed and halo-exchanged by real
   device copies over a LocalComm, the local launches (K1, K2 for the halo
   rule, K3), the outputs assembled by the rule's placements.  Cells:
   ViT-L/16 cls_224 (bf16, batch 128, forward and backward), Qwen3-4B
   prefill_32k at 4 x 512, UNet-SD1.5 gen_fast (one DDIM step) under base
   and spatial2d, ConvNeXt-B serve_b1 (H over data).  Gates: assembled
   outputs bit-identical where the launch configuration of rank 0's block
   equals the whole call's, else within 2e-2 of the largest |y|, each
   output of a call on its own (ViT's patch-embedding dW reported by
   name); rank 0's exchanged bytes by kind equal to the dry run's ``kernel_collectives``;
   8 local launches for each unsharded K1 / K3 forward, 8 K2 launches for
   each halo-ruled conv.  It prints one JSON line ``{"phase19": ...}``
   before the kernels line.

20. the LM cells at their own length (``phase_lm_long``): Qwen3-4B (36
   layers) and CodeQwen1.5-7B (32 layers, MHA) at full width in bfloat16,
   seeded weights: K3 at one layer's prefill call [1, 32, 32768, 128]
   causal held to its plain version (one head at a time) in float32
   and bfloat16 and timed beside SDPA and its bound, Qwen3-4B's also at
   the cell's 32 sequences (past 2^31 elements a tensor, the last sequence
   held); ``prefill_32k`` at the cell's 32 sequences or the largest power
   of two two probe prefills (the model cut to ``LONG_CHECK_LAYERS``
   layers) fit, timed, its logits' last ``LONG_TAIL`` positions at the cut
   held to the float32 forward of its bf16-rounded weights at phase 7's
   bf16 limit (1.25 x plain attention's own bf16 gap, or 2e-2 of the
   largest |logit|); ``decode_32k`` over a 32,768-slot cache of seeded
   values at the cell's 128 or the largest power of two whose cache and
   weights fit, its K3 call (T = 1 over 32,768 keys) held to its plain
   version on every sequence in float32 and bfloat16, ``LONG_DECODE_STEPS``
   steps at index 32,767 at all layers, ms a step beside the bytes bound,
   then the same steps at the cut held as the prefill on the first and the
   last sequence; K3's block shape at both printed.  Every phase prints its
   seconds, and the script its total, before the last two lines.

The last two lines of standard output are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``; the per-shape table is also written to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import types
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


def device_window(torch, fn, reps: int = 20, warmup: int = 3, tries: int = 3) -> tuple[float, dict]:
    """Device time of ``fn`` in us per call, and the kernels it launches as
    ``{name: [launches a call, us a call]}``, from ``torch.profiler``
    windows over ``reps`` back-to-back calls.  Each window is the active
    step of a schedule whose warmup step (``warmup`` calls, discarded) has
    the device trace running before it opens.  The first whole window (every
    kernel's count a multiple of ``reps``) gives the time.  A window may
    still lose launches (a kernel at 6-9 of 10, the same in every window of
    a call), so after ``tries`` windows that all lost some, each kernel's
    time a launch is the mean over the launches the windows kept, times its
    launches a call: the most any window counted over ``reps``, rounded, and
    at least 1, since every call of ``fn`` launches the same kernels.  (One
    count of all kernels over ``reps`` read a call of 2 or 3 kernels at 1/2
    or 2/3.)  nan if no window traced device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    seen = {}  # kernel: [most launches a window counted, launches kept, us kept]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts,
                                    schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for calls in (warmup, reps):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        rows = [a for a in prof.key_averages()  # the schedule's step row spans the window: not a kernel
                if a.device_type == torch.autograd.DeviceType.CUDA and not a.key.startswith("ProfilerStep")]
        total = sum(a.self_device_time_total for a in rows)
        if total > 0 and all(a.count % reps == 0 for a in rows) and seen.keys() <= {a.key for a in rows}:
            return total / reps, {a.key: [a.count / reps, a.self_device_time_total / reps] for a in rows}
        for a in rows:
            most, kept, us = seen.get(a.key, (0, 0, 0.0))
            seen[a.key] = [max(most, a.count), kept + a.count, us + a.self_device_time_total]
    kernels = {key: [max(1, round(most / reps)), us / kept * max(1, round(most / reps))]
               for key, (most, kept, us) in seen.items()}
    total = sum(us for _, us in kernels.values())
    return (total if total > 0 else float("nan")), kernels


def device_us(torch, fn, reps: int = 20, warmup: int = 3, tries: int = 3) -> float:
    """``device_window``'s time alone: us per call, or nan."""
    return device_window(torch, fn, reps=reps, warmup=warmup, tries=tries)[0]


def device_or_event_us(torch, fn, reps: int = 20) -> tuple[float, str]:
    """``device_us`` of ``fn``; where its windows measured nothing (nan),
    the CUDA-event mean stands in (host-bound where the wrapper outlasts the
    kernel): (us, "profiler" or "events")."""
    us = device_us(torch, fn, reps=reps)
    if math.isfinite(us):
        return us, "profiler"
    return time_ms(torch, fn, reps=reps) * 1e3, "events"


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


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list tree, in order (a tuple is a leaf:
    a bundle's (shape, dtype) specs)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def calibrated_bn(torch, mod, params, cfg, x):
    """A copy of EfficientNet's ``params`` whose batch norms' running
    statistics are those of ``x``'s forward: each batch norm's input's
    per-channel mean and variance, taken in float32 in turn."""
    from repro_torch.models import efficientnet
    from repro_torch.models.common import tree_map

    out = tree_map(lambda t: t.clone(), params)
    real = efficientnet.batchnorm_inference

    def calibrate(h, p, eps=1e-5):
        p["mean"].copy_(h.float().mean(dim=(0, 1, 2)))
        p["var"].copy_(h.float().var(dim=(0, 1, 2), unbiased=False))
        return real(h, p, eps)

    efficientnet.batchnorm_inference = calibrate
    try:
        mod.apply(out, cfg, x)
    finally:
        efficientnet.batchnorm_inference = real
    torch.cuda.synchronize()
    return out


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


def conv_how(config: dict) -> str:
    """A K1 / K2 ``launch_config`` in a word: the dense core's gather variant,
    or the depthwise branch's copies, tile (rows x columns x outputs a
    thread), slab, threads and shared memory."""
    dw = config.get("depthwise")
    if not dw:
        return config["gather"]
    return (f"depthwise {dw['copies']} tile {'x'.join(map(str, dw['tile']))} slab {dw['slab']} "
            f"{dw['threads']} threads {dw['smem']} B")


# The port's kernels in a profile, by a substring of the device kernel's name
# (the split-K reduction is one kernel for K1 and K2 alike), cuBLAS's
# matrix products (the LM's dense layers and the experts' batched products;
# nvjet is its bf16 family on Hopper), and the MoE routing's sorts, searches,
# scatters and gathers (the embedding's row gather falls there too).
KERNEL_FAMILIES = (("dwconv2d", "K1 depthwise"), ("conv2d_igemm<float, (anonymous namespace)::DenseRows", "K1"),
                   ("conv2d_igemm<float, (anonymous namespace)::HaloRows", "K2"),
                   ("splitk_reduce", "K1/K2 split-K reduction"), ("flash_fwd", "K3"),
                   ("conv2d_igemm", "K1/K2 (bf16)"), ("gemm", "GEMM (cuBLAS)"), ("gemv", "GEMM (cuBLAS)"),
                   ("splitKreduce", "GEMM (cuBLAS)"), ("nvjet", "GEMM (cuBLAS)"),
                   ("sort", "routing"), ("Sort", "routing"), ("search", "routing"), ("index", "routing"),
                   ("Index", "routing"), ("scatter", "routing"), ("gather", "routing"))


def kernel_family(name: str) -> str:
    return next((fam for key, fam in KERNEL_FAMILIES if key in name), "other")


def profiled(torch, fn) -> tuple:
    """One call of ``fn`` under the profiler: (the profile, its device-side
    rows -- kernels, copies -- longest first).  Operator rows are left out:
    they repeat their kernels' time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = sorted((a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA),
                       key=lambda a: -a.self_device_time_total)
    return prof, by_kernel


def profile_device(torch, fn) -> tuple[float, list]:
    """``profiled``'s device rows of one call of ``fn``, after its device busy ms."""
    _, by_kernel = profiled(torch, fn)
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
              f"S={config['splits']} {conv_how(config)}: max_err {err:.3g} "
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


def op_cost():
    """The port's cost accounting (``repro_torch.launch.op_cost``): the one
    formula of K3's pairs and of a step's operations, which the dry run
    counts too."""
    from repro_torch.launch import op_cost as module

    return module


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
        flops = 2.0 * b * h * op_cost().attention_pairs(t, s, causal) * (d + dv)
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
    """``fn()`` with the LM's attention through K3's plain version
    (``attention_plain``) on the same device, the KV heads repeated, then K3
    restored."""
    from repro_torch.kernels.attention import gqa_flash
    from repro_torch.models import attention as lm_attention

    def plain_gqa(q, k, v, *, causal):
        g = q.shape[2] // k.shape[2]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kr, vr = kt.repeat_interleave(g, dim=1), vt.repeat_interleave(g, dim=1)
        return attention_plain(qt, kr, vr, causal=causal).transpose(1, 2)

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
        return [{k: v.detach().cpu().numpy() for k, v in rec.items()} for rec in self.layers]


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
    return dict(prefill_flops=flops(LM_BATCH * LM_LEN, capacity, op_cost().attention_pairs(LM_LEN, LM_LEN, True)),
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
    leaves = tree_leaves(params)
    check([(tuple(x.shape), x.dtype) for x in leaves] == tree_leaves(prefill.state),
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
    leaves = tree_leaves(params)
    check([(tuple(x.shape), x.dtype) for x in leaves] == tree_leaves(prefill48.state),
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
    pairs = op_cost().attention_pairs(LM_LEN, LM_LEN, True)
    return dict(prefill_flops=flops(LM_BATCH * LM_LEN, LM_BATCH * LM_LEN, pairs, capacity),
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
    leaves = tree_leaves(params)
    check([(tuple(x.shape), x.dtype) for x in leaves] == tree_leaves(prefill.state),
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


def probe_k2(torch, calls: dict, gen) -> list[dict]:
    """One K2 launch at every geometry of ``calls`` (``plan_kernel_calls``:
    geometry -> operand shapes, None where the probe refused it) that the
    probe accepts, on seeded inputs, held to the probe's output shape and to
    the plain version within TOL; fatal otherwise.  Returns one row a launch."""
    from repro_torch.kernels.halo_conv import halo_conv2d_cuda, halo_conv2d_ref

    probed = []
    for (k, s, p, groups, cin, cout, hs, w), shapes in sorted(calls.items()):
        if shapes is None:  # not a K2 geometry (check_plan_kernels agreed with the predicate)
            continue
        kw = dict(stride=s, padding=p, groups=groups)
        want = shapes["out"]
        x, top, bot, wt = (None if shapes[n] is None else torch.randn(shapes[n], generator=gen, device="cuda")
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
    return probed


def phase_serving(torch, params=None, images=None, plain=None) -> tuple[dict, dict]:
    """Phase 10: the plan analysers and deadline-aware serving (paper §V.D)
    over full-width VGG-16 under ``plan_halp(overlap_rows=4)``, with phase
    4's weights and images (drawn here as ``serve`` draws them when run
    alone; ``plain`` is phase 4's plain-conv forward of the first MAX_BATCH
    images on the CPU, computed here when not given).  Returns the report
    and the launches of K1 and K2 on its path: the probe's K2 launches, the
    latency curve's and the burst's forwards."""

    from repro_torch.analysis import AnalysisError, check_plan, check_plan_kernels
    from repro_torch.analysis.kernel_check import plan_kernel_calls
    from repro_torch.core import (OffloadChannel, Segment, plan_even, plan_halp, rate_fluctuation,
                                  service_reliability)
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.kernels.halo_conv import halo_conv2d_cuda
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
    probed = probe_k2(torch, calls, torch.Generator(device="cuda").manual_seed(10))
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


# Phase 18 (``phase_parallel``): (a) GPipe (``parallel.pipeline_apply``)
# over a LocalComm of PIPE_STAGES stages on the card: full-width ViT-L/16,
# its 24 blocks cut into stages of 12, PIPE_MICRO microbatches of PIPE_MB
# images, float32 then bfloat16, timed (median of PIPE_REPS) beside the same
# blocks run microbatch by microbatch; (b) the dry run (``launch.dryrun``) on
# a 1-device mesh at DRY_CELLS, each against the same bundle realised and
# run on the card.
PIPE_STAGES, PIPE_MICRO, PIPE_MB, PIPE_REPS = 2, 8, 4, 10
DRY_CELLS = (("vit-l16", "cls_224", dict(batch=128)), ("qwen3-4b", "prefill_32k", dict(global_batch=4, seq_len=512)),
             ("unet-sd15", "gen_fast", {}))


def median_event_ms(torch, fns, reps: int) -> list[float]:
    """Each of ``fns``' median time over ``reps`` calls by CUDA events, the
    functions called in turns (one warm-up call each), so a drift of the
    card's clocks reaches them alike."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [sorted(ts)[reps // 2] for ts in times]


def dry_signatures(rec: dict, kind: str, keep) -> Counter:
    """A dry-run record's calls of ``kind`` as a Counter, each signature
    (JSON lists back to tuples) cut to ``keep(sig)``."""
    out = Counter()
    for sig, n in rec["kernels"].get(kind, []):
        out[keep(tuple(tuple(v) if isinstance(v, list) else v for v in sig))] += n
    return out


def phase_parallel(torch) -> tuple[dict, dict]:
    """Phase 18: the parallel modules and the dry run on the card.  (a)
    ``pipeline_apply`` at full width: ViT-L/16 (224 x 224, seeded weights)
    as PIPE_STAGES stages of 12 blocks over ``LocalComm`` on the card,
    PIPE_MICRO microbatches of PIPE_MB images, the patch embedding (K1, once
    a microbatch) and the head outside the pipeline, float32 (TF32 off) and
    bfloat16: each microbatch's output bit-identical to the same 24 blocks
    run unpipelined on it, the logits within 2e-5 x (1 + |y|) of
    ``vit.apply`` at the whole batch (bfloat16: 2e-2 of the largest |logit|
    of the float32 forward of its rounded weights), K3 launched (S + M - 1)
    x S x 12 times and K1 M times; both timed beside the unpipelined blocks
    (median of PIPE_REPS by CUDA events, in turns) with 1 / (1 -
    bubble_fraction).
    (b) ``dryrun.run_cell`` on a 1-device mesh at DRY_CELLS, then the same
    bundle realised on the card: the argument bytes the allocator places
    (each leaf a multiple of 512 bytes) equal to the record's, its K1 / K3
    signatures and counts equal to those the wrappers record on the card in
    one step or forward, ViT's step operations equal to phase 15's
    ``step_flops_of`` count; the peak of live bytes beside the card's peak
    memory over what was allocated before ``realize`` (what earlier phases
    left is not the step's), as a ratio (a record).  Returns the report and the launches of
    its counted runs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get as get_arch
    from repro_torch.configs.steps import build, realize
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import vit
    from repro_torch.models.common import layer, tree_leaves as state_leaves, tree_map
    from repro_torch.parallel import bubble_fraction, pipeline_apply
    from repro_torch.spatial import LocalComm

    phase_t0 = time.perf_counter()
    smi = nvidia_smi()
    print(f"phase 18 on {smi}: the parallel modules and the dry run")
    launches = {"conv2d": 0, "conv2d_backward": 0, "flash_attention": 0}
    report: dict = {"card": smi}

    def zero():
        conv2d_cuda.launches = conv2d_cuda.backward_launches = flash_attention.launches = 0

    def read() -> tuple[int, int, int]:
        got = conv2d_cuda.launches, conv2d_cuda.backward_launches, flash_attention.launches
        for key, n in zip(("conv2d", "conv2d_backward", "flash_attention"), got):
            launches[key] += n
        return got

    # (a) GPipe at full width
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(18)
    cfg = get_arch("vit-l16").cfg
    per_stage = cfg.n_layers // PIPE_STAGES
    comm = LocalComm(PIPE_STAGES, "cuda")
    batch = PIPE_MICRO * PIPE_MB
    params32 = vit.init(gen, cfg, torch.float32)
    images32 = torch.randn((batch, cfg.img_res, cfg.img_res, cfg.in_channels), generator=gen, device="cuda")
    bubble = 1.0 / (1.0 - bubble_fraction(PIPE_STAGES, PIPE_MICRO))
    want_k3 = (PIPE_STAGES + PIPE_MICRO - 1) * PIPE_STAGES * per_stage
    rep_a = report["pipeline"] = dict(stages=PIPE_STAGES, micro=PIPE_MICRO, micro_batch=PIPE_MB,
                                      blocks_per_stage=per_stage, bubble_ratio=bubble)

    def stage_fn(blocks, h):
        for j in range(per_stage):
            h = vit.vit_block_apply(layer(blocks, j), h, cfg.n_heads)
        return h

    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        params = params32 if dt == torch.float32 else tree_map(lambda t: t.to(dt), params32)
        images = images32.to(dt)
        stages = [tree_map(lambda t, i=i: t[i * per_stage:(i + 1) * per_stage], params["blocks"])
                  for i in range(PIPE_STAGES)]
        zero()
        micro = torch.stack([vit.embed(params, cfg, x) for x in images.split(PIPE_MB)])
        ys = pipeline_apply(stages, micro, stage_fn, comm)
        logits = vit.head(params, ys.reshape(batch, *ys.shape[2:]))
        torch.cuda.synchronize()
        got = read()
        print(f"  (a) {dname}: ViT-L/16 as {PIPE_STAGES} stages of {per_stage} blocks over LocalComm, "
              f"{PIPE_MICRO} microbatches of {PIPE_MB}: K1 {got[0]} launches (expected {PIPE_MICRO}), K3 "
              f"{got[2]} (expected {want_k3})")
        check(got == (PIPE_MICRO, 0, want_k3), f"the pipelined {dname} forward launched {got}")

        def unpipelined(h):
            for blocks in stages:
                h = stage_fn(blocks, h)
            return h

        zero()
        same = all(torch.equal(ys[i], unpipelined(micro[i])) for i in range(PIPE_MICRO))
        read()
        check(same, f"a {dname} microbatch through the pipeline differs from the same blocks run unpipelined")
        check(bool(torch.isfinite(logits.float()).all()) and logits.shape == (batch, cfg.num_classes),
              f"non-finite or misshapen {dname} logits")
        zero()
        if dt == torch.float32:
            ref = vit.apply(params, cfg, images)
            err = (logits - ref).abs()
            share = (err / (TOL[dname] * (1 + ref.abs()))).max().item()
            limit = f"{TOL[dname]} x (1 + |y|)"
        else:
            ref = vit.apply(tree_map(lambda t: t.float(), params), cfg, images.float())
            err = (logits.float() - ref).abs()
            share = err.max().item() / (TOL[dname] * ref.abs().max().item())
            limit = f"{TOL[dname]} of the largest |logit| of the float32 forward of its rounded weights"
        torch.cuda.synchronize()
        read()
        check(share <= 1.0, f"the pipelined {dname} logits miss the whole batch's forward: share {share:.3g}")
        zero()
        piped_ms, plain_ms = median_event_ms(torch, (lambda: pipeline_apply(stages, micro, stage_fn, comm),
                                                     lambda: [unpipelined(micro[i]) for i in range(PIPE_MICRO)]),
                                             PIPE_REPS)
        read()
        print(f"  (a) {dname} on {smi}: every microbatch bit-identical to its unpipelined blocks: {same}; logits "
              f"vs vit.apply at batch {batch}: max |diff| {err.max().item():.3g} (share {share:.3g} of {limit}); "
              f"pipelined {piped_ms:.3f} ms, unpipelined {plain_ms:.3f} ms (median of {PIPE_REPS} in turns, CUDA events): "
              f"ratio {piped_ms / plain_ms:.4f} beside 1 / (1 - bubble_fraction) = {bubble:.4f}")
        rep_a[dname] = dict(k1=got[0], k3=got[2], bit_identical=same, max_abs_err=err.max().item(), share=share,
                            pipelined_ms=piped_ms, unpipelined_ms=plain_ms, ratio=piped_ms / plain_ms)
        del params, images, stages, micro, ys, logits, ref, err
    del params32, images32
    torch.cuda.empty_cache()
    rep_a["s"] = time.perf_counter() - t0

    # (b) the dry run against the card
    one_device = Mesh(("data", "model"), (1, 1))
    for name, cell, meta in DRY_CELLS:
        t0 = time.perf_counter()
        arch = resized(get_arch(name), cell, **meta)
        rec = dryrun.run_cell(arch, cell, mesh=one_device, verbose=False)
        check(rec["status"] == "ok", f"the dry run of {name}/{cell}: {rec}")
        bundle = build(arch, cell)
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        state, inputs = realize(arch, bundle, gen)
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated() - before
        exact = sum(t.numel() * t.element_size() for t in state_leaves((state, inputs)))
        mem = rec["memory"]
        print(f"  (b) {name}/{cell} {meta}, {bundle.kind}: arguments placed on the card {placed} B (dry run "
              f"{mem['argument_allocated_bytes']} B at 512-byte blocks), exactly {exact} B (dry run "
              f"{mem['argument_size_in_bytes']} B); dry-run trace {rec['trace_s']:.2f} s")
        check(placed == mem["argument_allocated_bytes"] and exact == mem["argument_size_in_bytes"],
              f"{name}/{cell}: the dry run's argument bytes are not what realize placed on the card")
        torch.cuda.reset_peak_memory_stats()
        zero()
        counter = FlopCounterMode(display=False)
        if bundle.kind == "train":
            with recording_train_calls() as rc, counter:
                out = bundle.fn(state, **inputs)
                torch.cuda.synchronize()
            k1_key, k3_key = (lambda sig: sig), (lambda sig: sig[:4])
        elif bundle.kind == "prefill":
            with torch.no_grad(), recording_lm_calls() as rc:
                out = bundle.fn(state, **inputs)
                torch.cuda.synchronize()
            k1_key, k3_key = (lambda sig: sig), (lambda sig: sig)
        else:
            with torch.no_grad(), recording_calls() as rc:
                out = bundle.fn(state, **inputs)
                torch.cuda.synchronize()
            k1_key, k3_key = (lambda sig: sig[:7]), (lambda sig: sig[:3])
        got = read()
        peak = torch.cuda.max_memory_allocated() - before  # the step's own: its arguments and what it allocates
        dry_k1, dry_k3 = dry_signatures(rec, "K1", k1_key), dry_signatures(rec, "K3", k3_key)
        check(not rec["kernels"].get("K1 dgrad") and not rec["kernels"].get("K2"),
              f"{name}/{cell}: the dry run counted {sorted(rec['kernels'])}")
        print(f"  (b) {name}/{cell}: K1 signatures {len(dry_k1)} / {len(rc.convs)} ({sum(dry_k1.values())} / "
              f"{sum(rc.convs.values())} calls), K3 {len(dry_k3)} / {len(rc.attns)} ({sum(dry_k3.values())} / "
              f"{sum(rc.attns.values())}), dry run / card; launches K1 {got[0]}, K3 {got[2]}")
        check(dry_k1 == rc.convs and dry_k3 == rc.attns,
              f"{name}/{cell}: the dry run's kernel calls {dict(dry_k1)} {dict(dry_k3)} differ from the card's "
              f"{dict(rc.convs)} {dict(rc.attns)}")
        check(got[0] == sum(dry_k1.values()) and got[2] == sum(dry_k3.values()) and got[2] > 0,
              f"{name}/{cell}: the card launched {got}, the dry run counts {sum(dry_k1.values())} K1 and "
              f"{sum(dry_k3.values())} K3")
        check(all(bool(torch.isfinite(t.float()).all()) for t in state_leaves(out)), f"{name}/{cell}: non-finite")
        row = dict(cell=cell, kind=bundle.kind, meta=meta, argument_bytes=mem["argument_size_in_bytes"],
                   allocated_argument_bytes=placed, k1_calls=sum(dry_k1.values()), k3_calls=sum(dry_k3.values()),
                   dry_flops=rec["cost"]["flops"], dry_bytes_accessed=rec["cost"]["bytes_accessed"],
                   peak_live_bytes=rec["peak_live_bytes"], card_peak_bytes=peak,
                   peak_ratio=rec["peak_live_bytes"] / peak, trace_s=rec["trace_s"])
        if bundle.kind == "train":
            card_flops = op_cost().step_flops_of(counter, rc)
            row["card_step_flops"] = card_flops
            print(f"  (b) {name}/{cell}: the step's operations, dry run {rec['cost']['flops']:.6e} / phase 15's "
                  f"step_flops_of on the card {card_flops:.6e}")
            check(rec["cost"]["flops"] == card_flops, f"{name}/{cell}: the dry run's step operations differ from "
                                                      f"step_flops_of's")
        print(f"  (b) {name}/{cell} on {smi}: peak of live bytes {rec['peak_live_bytes'] / 1e9:.3f} GB (dry run, "
              f"unsharded) / the card's peak memory {peak / 1e9:.3f} GB = {row['peak_ratio']:.4f}; dry-run "
              f"operations {rec['cost']['flops']:.4e}, eager bytes {rec['cost']['bytes_accessed']:.4e}")
        row["s"] = time.perf_counter() - t0
        report[name] = row
        del state, inputs, out, rc, counter
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - phase_t0
    print(f"  phase 18: {phase_s:.1f} s")
    report["phase_s"] = phase_s
    report["launches"] = dict(launches)
    return report, launches


# Phase 19 (``phase_collectives``): the kernels' sharding rules
# (``parallel.kernel_rules``) held on the card.  Each cell's step runs once
# as DTensors on COLL_MESH (``launch.dryrun.run_cell``, meta tensors on the
# CPU: the rules' calls and collectives), then once unsharded on the card
# with every kernel call replayed on the mesh's 8 ranks held on the card
# (``kernel_rules.replaying``): each rank's blocks cut by the logged
# placements, redistributed and halo-exchanged by real device copies over a
# LocalComm, the local launches, the outputs assembled.  Cells: name, cell,
# variant, the cell's meta at the size taken, and whether its backward runs.
COLL_MESH = (("data", "model"), (2, 4))
COLL_CELLS = (("vit-l16", "cls_224", "base", dict(batch=128), True),
              ("qwen3-4b", "prefill_32k", "base", dict(global_batch=4, seq_len=512), False),
              ("unet-sd15", "gen_fast", "base", dict(steps=1), False),
              ("unet-sd15", "gen_fast", "spatial2d", dict(steps=1), False),
              ("convnext-b", "serve_b1", "base", {}, False))


def same_config(torch, call, operands, blocks) -> bool:
    """Whether the kernel takes the same launch configuration for rank 0's
    blocks as for the whole operands (K1 and K3 forwards on the card)."""
    from repro_torch.kernels.attention.ops import launch_config as k3_config
    from repro_torch.kernels.conv2d.ops import launch_config as k1_config

    if call.kernel == "K1" and call.route == "K1":
        stride, padding, groups, _ = call.statics
        x, w = operands[:2]
        xl, wl = blocks[:2]
        return k1_config(x, w, stride=stride, padding=padding, groups=groups) == \
            k1_config(xl, wl, stride=stride, padding=padding, groups=xl.shape[3] if groups > 1 else 1)
    if call.kernel == "K3":
        causal = call.statics[0]
        return k3_config(*operands, causal=causal)["block"] == k3_config(*blocks, causal=causal)["block"]
    return False


def phase_collectives(torch) -> tuple[dict, dict]:
    """Phase 19: the kernels' sharding rules on the card, at COLL_CELLS on a
    (2, 4) ("data", "model") mesh emulated on one H100 (COLL_MESH).  For
    every kernel call of one forward (ViT-L/16: one train step, so also its
    backward), the 8 ranks' outputs assembled by the rule's output
    placements (Partial ones summed over their group) must be bit-identical
    to the unsharded launch where the kernel takes the same launch
    configuration for rank 0's blocks as for the whole operands, and
    otherwise within 2e-2 of the largest |y| (bfloat16, every cell's type),
    each output of a call against its own largest |y|; ViT's patch-embedding
    dW (Partial over the data group) is gated so on its own and reported by
    name.
    Rank 0's result bytes of the exchanges the emulation performed, by
    kind, must equal the dry run's ``kernel_collectives``; each unsharded K1
    or K3 forward must become 8 local launches, a halo-ruled K1 call 8 K2
    launches.  Returns the report and the launches of its counted runs."""
    from repro_torch.configs import get as get_arch
    from repro_torch.configs.steps import build, realize
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.kernels.halo_conv import halo_conv2d_cuda
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.common import tree_leaves as state_leaves
    from repro_torch.parallel import kernel_rules, variants

    phase_t0 = time.perf_counter()
    smi = nvidia_smi()
    print(f"phase 19 on {smi}: the kernels' sharding rules on a {COLL_MESH[1]} mesh emulated on the card")
    mesh = Mesh(*COLL_MESH)
    sizes = mesh.sizes
    ranks = mesh.size
    launches = {"conv2d": 0, "conv2d_backward": 0, "halo_conv2d": 0, "flash_attention": 0}
    report: dict = {"card": smi, "mesh": dict(zip(*COLL_MESH))}
    gen = torch.Generator(device="cuda").manual_seed(19)

    def zero():
        conv2d_cuda.launches = conv2d_cuda.backward_launches = halo_conv2d_cuda.launches = 0
        flash_attention.launches = 0

    def read() -> dict:
        got = dict(conv2d=conv2d_cuda.launches, conv2d_backward=conv2d_cuda.backward_launches,
                   halo_conv2d=halo_conv2d_cuda.launches, flash_attention=flash_attention.launches)
        for key, n in got.items():
            launches[key] += n
        return got

    for name, cell, variant, meta, backward in COLL_CELLS:
        t0 = time.perf_counter()
        label = f"{name}/{cell}/{variant}"
        arch = resized(get_arch(name), cell, **meta)
        calls: list = []
        rec = dryrun.run_cell(arch, cell, mesh=mesh, variant=variant, calls=calls, verbose=False)
        check(rec["status"] == "ok", f"the dry run of {label}: {rec}")
        check(not torch.distributed.is_initialized(), f"the dry run of {label} left a process group open")
        dry = Counter()
        for per in rec["kernel_collectives"].values():
            for kind, v in per.items():
                if kind != "calls":
                    dry[kind] += v[1]
        previous = variants.get_variant().name
        variants.set_variant(variant)
        try:
            bundle = build(arch, cell)
            state, inputs = realize(arch, bundle, gen)
            rows = []

            def hold(r):
                """Each output of the call gated on its own: its error, its
                largest |y|, its share of the bf16 limit."""
                call = r["call"]
                errs, shares, equal = {}, {}, True
                for out, g, w in zip(kernel_rules.OUTPUTS[call.kernel], r["got"], r["want"]):
                    if w is None:
                        continue
                    check(g.shape == w.shape, f"{label} {call.signature()} {out}: assembled {tuple(g.shape)} != "
                                              f"{tuple(w.shape)}")
                    d = (g.float() - w.float()).abs().max().item()
                    scale = w.float().abs().max().item()
                    errs[out] = d
                    shares[out] = d / (TOL["bfloat16"] * scale) if scale else float(d > 0)
                    equal = equal and torch.equal(g, w)
                    check(shares[out] <= 1.0, f"{label} {call.signature()} {out}: assembled output misses the "
                                              f"unsharded launch: max |diff| {d:.3g}, share {shares[out]:.3g} of "
                                              f"2e-2 x its largest |y| {scale:.3g}")
                same = same_config(torch, call, r["operands"], r["blocks"]) if r.get("blocks") else False
                rows.append(dict(kernel=call.kernel, route=call.route, signature=call.signature(),
                                 max_abs_err=max(errs.values()), share=max(shares.values()), errs=errs, shares=shares,
                                 bit_identical=equal, same_config=same, moved=r["moved"]))
                check(equal or not same, f"{label} {call.signature()}: the same launch configuration but not "
                                         f"bit-identical (max |diff| {errs})")
                r["got"] = r["want"] = r["operands"] = r["blocks"] = None

            zero()
            with kernel_rules.replaying(calls, sizes, hold):
                if backward:
                    out = bundle.fn(state, **inputs)
                else:
                    with torch.no_grad():
                        out = bundle.fn(state, **inputs)
                torch.cuda.synchronize()
            got = read()
        finally:
            variants.set_variant(previous)
        check(all(bool(torch.isfinite(t.float()).all()) for t in state_leaves(out) if t.is_floating_point()),
              f"{label}: non-finite output")
        moved = Counter()
        for row in rows:
            for kind, v in row["moved"].items():
                moved[kind] += v[1]
        by_kernel = Counter(row["kernel"] for row in rows)
        k2_calls = sum(row["route"] == "K2" for row in rows if row["kernel"] == "K1")
        k1_calls = by_kernel["K1"] - k2_calls
        # the unsharded step's own forwards, and ranks local launches for each replayed one
        want = dict(conv2d=(ranks + 1) * k1_calls + k2_calls, halo_conv2d=ranks * k2_calls,
                    flash_attention=(ranks + 1) * by_kernel["K3"])
        gathered = sorted({row["signature"] for row in rows if row["route"] == "gathered"})
        identical = sum(row["bit_identical"] for row in rows)
        worst = max(rows, key=lambda row: row["share"])
        row = dict(cell=cell, variant=variant, meta=meta, calls=dict(by_kernel), k2_calls=k2_calls,
                   launches=got, expected_launches=want, moved=dict(moved), dry_kernel_collectives=dict(dry),
                   collectives=rec["collectives"], replicated_ops=rec["replicated_ops"], gathered=gathered,
                   bit_identical=identical, same_config=sum(row["same_config"] for row in rows),
                   max_share=worst["share"], worst=worst["signature"], collective_trace_s=rec["collective_trace_s"])
        dws = [r for r in rows if r["kernel"] == "K1 backward" and "dw" in r["shares"]]
        if backward:
            check(dws, f"{label}: no K1 backward with dW was replayed")
            # ViT's one conv is the patch embedding: its dW, Partial over the data group, summed
            row["patch_embed_dw"] = dict(max_abs_err=max(r["errs"]["dw"] for r in dws),
                                         share=max(r["shares"]["dw"] for r in dws))
            print(f"  {label} on {smi}: the patch embedding's dW summed over the data group against the unsharded "
                  f"dW: max |diff| {row['patch_embed_dw']['max_abs_err']:.3g}, share "
                  f"{row['patch_embed_dw']['share']:.3g} of 2e-2 x its largest |dW|")
        print(f"  {label} {meta} on {smi}: {dict(by_kernel)} calls replayed on {ranks} ranks, {k2_calls} through the "
              f"halo rule (K2); launches {got} (expected {want}); {identical} / {len(rows)} bit-identical "
              f"({row['same_config']} at the same launch configuration), largest share of the bf16 limit "
              f"{worst['share']:.3g} ({worst['signature']}); rank 0's exchanges {dict(moved)} B, dry run's "
              f"kernel_collectives {dict(dry)} B; the step's collectives {rec['collectives']}; halo rule gathered "
              f"{len(gathered)} conv signatures; dry run {rec['trace_s']:.2f} + {rec['collective_trace_s']:.2f} s")
        check(dict(moved) == dict(dry), f"{label}: the emulation moved {dict(moved)} B, the dry run counts {dict(dry)}")
        check(all(got[k] == v for k, v in want.items()), f"{label}: launches {got}, expected {want}")
        row["s"] = time.perf_counter() - t0
        report[label] = row
        del state, inputs, out, rows
        gc.collect()
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - phase_t0
    print(f"  phase 19 on {smi}: {phase_s:.1f} s")
    report["phase_s"] = phase_s
    report["launches"] = dict(launches)
    return report, launches


# Phase 20 (``phase_lm_long``): the LM cells at their own length, 32,768
# tokens, bfloat16 at full width (seeded random weights): Qwen3-4B (36
# layers, 32 query / 8 KV heads) and CodeQwen1.5-7B (32 layers, 32 / 32).
# (a) K3 held at one layer's prefill call [1, H, 32768, 128] causal against
# its plain version (``attention_plain``, one head at a time: the whole
# [T, T] logits are 137 GB a head set), float32 and bfloat16, timed beside SDPA; Qwen3-4B's
# also at the cell's batch of 32 (q 4.3e9 elements, past 2^31), its last
# sequence held.  (b) prefill_32k: two probe prefills of the model cut to
# LONG_CHECK_LAYERS layers (LONG_PROBES sequences; no gradient, so a
# sequence's transients do not grow with depth and the cut's weights are
# views of the whole model's) fit the batch: the cell's 32 or the largest
# power of two under TRAIN_MEM_SHARE of the card; the first probe's logits
# at the last LONG_TAIL positions held to the float32 forward of the cut's
# bf16-rounded weights at phase 7's bf16 limit (``bf16_hold``: the larger of
# BF16_RTOL x its largest |logit| and 1.25 x plain attention's own bf16
# gap); then one prefill at all layers at that batch, timed, its peak beside
# the fit's.  (c) decode_32k: a 32,768-slot cache of seeded values at the
# cell's batch of 128 or the largest power of two whose cache and weights
# fit, LONG_DECODE_STEPS steps at index 32,767 (K3 at T = 1 over 32,768
# keys) at all layers, timed beside the bytes bound (the cache and the
# weights read), each beside the same step with plain attention (a record:
# in bfloat16 the two part by ~5 % of the largest |logit| over 36 random
# layers, as plain attention itself parts from float32); then the same
# steps at the cut, over the cache's first layers, each held as the prefill
# on the first and the last sequence.  Before the timing, the step's K3
# call held to its plain version on every sequence, float32 and bfloat16.
LONG_ARCHS = ("qwen3-4b", "codeqwen1.5-7b")
LONG_LEN, LONG_PROBES, LONG_CHECK_LAYERS, LONG_TAIL, LONG_DECODE_STEPS = 32768, (1, 2), 4, 1024, 3
LONG_WIDE = {"qwen3-4b": 32}  # K3 held at this many sequences too (the cell's batch)


def hold_long_attention(torch, F, gen, b: int, h: int, hkv: int, t: int, d: int, hold_b: int | None = None,
                        dtypes=("float32", "bfloat16"), timed: bool = True) -> dict:
    """K3 at one LM layer's causal prefill call [b, h (hkv KV heads), t, d],
    the model's layout ([B, T, H*D] buffers seen through strides), through
    ``gqa_flash``, against ``attention_plain`` on the same values within TOL x
    (1 + |y|): every sequence, or only sequence ``hold_b``.  Timed
    (``timed``): K3's and SDPA's device us a call (on the repeated KV heads)
    beside the bound.  The launch count is left as it was."""
    from repro_torch.kernels.attention import flash_attention, gqa_flash
    from repro_torch.kernels.attention.ops import launch_config

    count = flash_attention.launches
    g = h // hkv
    out = {}
    for dname in dtypes:
        dt = getattr(torch, dname)
        q, k, v = (torch.randn((b, t, n * d), generator=gen, device=gen.device).to(dt).view(b, t, n, d)
                   for n in (h, hkv, hkv))

        def kernel():
            return gqa_flash(q, k, v, causal=True)

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        config = launch_config(qt, kt, vt, causal=True)
        got = kernel().transpose(1, 2)
        sl = slice(None) if hold_b is None else slice(hold_b, hold_b + 1)
        kr, vr = (x[sl].repeat_interleave(g, dim=1) for x in (kt, vt))
        want = attention_plain(qt[sl], kr, vr, causal=True)
        torch.cuda.synchronize()
        diff = (got[sl].float() - want.float()).abs()
        err = diff.max().item()
        ok = bool((diff <= TOL[dname] * (1 + want.float().abs())).all()) and bool(torch.isfinite(got[sl]).all())
        del diff, want
        row = dict(b=b, h=h, hkv=hkv, t=t, d=d, dtype=dname, held=f"sequence {hold_b}" if hold_b is not None else "all",
                   q_elements=q.numel(), max_abs_err=err, **config)
        if timed:
            kr, vr = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
            pairs = op_cost().attention_pairs(t, t, True)
            flops = 2.0 * b * h * pairs * 2 * d
            nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size()
            ops_ms, bytes_ms = bound_ms(flops, nbytes, dname)
            us, src = device_or_event_us(torch, kernel, reps=3)
            lib_us, lib_src = device_or_event_us(
                torch, lambda: F.scaled_dot_product_attention(qt, kr, vr, is_causal=True), reps=3)
            row.update(device_ms=us / 1e3, source=src, library_device_ms=lib_us / 1e3, library_source=lib_src,
                       library_backend=sdpa_backend(
                           torch, lambda: F.scaled_dot_product_attention(qt, kr, vr, is_causal=True)),
                       bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                       tflops=flops / us / 1e6)
            del kr, vr
        print(f"  K3 {dname:8s} [{b}, {h} ({hkv} KV), {t}, {d}] causal ({q.numel():.3e} elements a tensor; "
              f"{config['block']}, {config['blocks']} blocks), held at {row['held']}: max_err {err:.3g}"
              + (f"; device {row['device_ms']:.3f} ms a call ({row['tflops']:.1f} TFLOP/s; {row['source']}), SDPA "
                 f"{row['library_device_ms']:.3f} ms ({row['library_backend']}), bound {row['bound_ms']:.3f} ms "
                 f"({row['bound_by']})" if timed else ""))
        check(ok, f"K3 disagrees with its plain version at {row}")
        out[dname] = row
        del q, k, v, qt, kt, vt, got
        torch.cuda.empty_cache()
    flash_attention.launches = count
    return out


def cut_layers(params, n: int):
    """The LM's parameters with each layer stack cut to its first ``n``
    layers, as views."""
    from repro_torch.models.common import tree_map

    return {key: tree_map(lambda t: t[:n], val) if key.endswith("_layers") else val for key, val in params.items()}


def seeded_cache(cfg, batch: int, slots: int, gen):
    """A bfloat16 KV cache of ``slots`` slots for ``batch`` sequences on the
    generator's device, every value N(0, 1) from ``gen``."""
    import torch

    from repro_torch.models import transformer_lm as lm
    from repro_torch.models.common import tree_leaves

    cache = lm.init_cache(cfg, batch, slots, torch.bfloat16, device=gen.device)
    for leaf in tree_leaves(cache):
        leaf.normal_(generator=gen)
    return cache


def lm_tail(params, cfg, tokens, n: int):
    """The LM's logits at the last ``n`` positions alone: ``forward``'s trunk,
    then its final norm and head on those rows (a float32 reference whose
    whole logits would take 20 GB)."""
    from repro_torch.models import transformer_lm as lm
    from repro_torch.models.layers import dense, rmsnorm

    x, _ = lm.trunk(params, cfg, tokens)
    return dense(rmsnorm(x[:, -n:], params["final_norm"]), params["lm_head"])


def bf16_hold(label: str, got, plain, ref) -> dict:
    """Phase 7's bfloat16 hold: ``got`` (through K3) against ``ref``, the
    float32 forward of the same bf16-rounded weights with plain attention,
    within the larger of BF16_RTOL x its largest |logit| and 1.25 x the gap
    of ``plain`` (the same bfloat16 forward with plain attention) to it."""
    got, plain, ref = (x.float() for x in (got, plain, ref))
    scale = ref.abs().max().item()
    err, gap = (got - ref).abs().max().item(), (plain - ref).abs().max().item()
    limit = max(BF16_RTOL * scale, 1.25 * gap)
    row = dict(max_abs_err=err, plain_max_abs_err=gap, max_abs_logit=scale, limit=limit,
               vs_plain=(got - plain).abs().max().item())
    print(f"  {label}: vs the float32 forward of the bf16-rounded weights max |diff| {err:.4g} (the plain attention's "
          f"bf16 {gap:.4g}; limit {limit:.4g} = the larger of {BF16_RTOL} x max |logit| {scale:.4g} and 1.25 x the "
          f"plain gap); vs the plain attention's bf16 {row['vs_plain']:.4g}")
    check(err <= limit and bool(got.isfinite().all()), f"{label}: K3's bf16 logits drift from the float32 forward")
    return row


def phase_lm_long(torch) -> tuple[dict, dict]:
    """Phase 20: Qwen3-4B and CodeQwen1.5-7B at full width through
    ``configs.steps``' prefill_32k and decode_32k cells at 32,768 tokens,
    bfloat16: (a) K3 at one layer's call held to its plain version
    (``hold_long_attention``), timed beside SDPA; (b) the prefill at the
    batch two cut probes fit, timed, the logits of a LONG_CHECK_LAYERS-layer
    cut held to the float32 forward of its rounded weights (``bf16_hold``);
    (c) decode steps at index 32,767 over a seeded cache at the batch that
    fits, timed beside the bytes bound, and the same steps at the cut held
    so.  Returns the report and the launches of its counted runs."""
    import torch.nn.functional as F

    from repro_torch.configs import get as get_arch
    from repro_torch.configs.steps import build
    from repro_torch.kernels.attention import flash_attention, gqa_flash
    from repro_torch.kernels.attention.ops import launch_config
    from repro_torch.models import transformer_lm as lm
    from repro_torch.models.common import tree_leaves, tree_map

    phase_t0 = time.perf_counter()
    smi = nvidia_smi()
    print(f"phase 20 on {smi}: the LM cells at 32,768 tokens")
    launches = {"flash_attention": 0}
    report: dict = {"card": smi}
    gen = torch.Generator(device="cuda").manual_seed(20)
    room = TRAIN_MEM_SHARE * torch.cuda.get_device_properties(0).total_memory

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    for name in LONG_ARCHS:
        t0 = time.perf_counter()
        arch = get_arch(name)
        cfg = arch.cfg
        rep = report[name] = {"resident_gb": settle(torch, f"before {name}")}
        t_len = arch.cells["prefill_32k"].meta["seq_len"]
        check(t_len == arch.cells["decode_32k"].meta["seq_len"] == LONG_LEN,
              f"{name}'s LM cells are not {LONG_LEN} tokens")
        params = lm.init(gen, cfg, torch.bfloat16)
        torch.cuda.synchronize()
        weights = nbytes(params)
        n_params = sum(t.numel() for t in tree_leaves(params))
        print(f"{name}: {n_params / 1e9:.4f} B parameters ({weights / 1e9:.2f} GB bfloat16), {cfg.n_layers} layers, "
              f"{cfg.n_heads} query / {cfg.n_kv_heads} KV heads of {cfg.d_head}, vocabulary {cfg.vocab}")
        rep.update(n_params=n_params, layers=cfg.n_layers, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads)

        # (a) K3 at one layer's call
        rep["k3_prefill"] = hold_long_attention(torch, F, gen, 1, cfg.n_heads, cfg.n_kv_heads, t_len, cfg.d_head)
        if name in LONG_WIDE:
            wide = LONG_WIDE[name]
            rep["k3_prefill_wide"] = hold_long_attention(torch, F, gen, wide, cfg.n_heads, cfg.n_kv_heads, t_len,
                                                         cfg.d_head, hold_b=wide - 1, dtypes=("bfloat16",),
                                                         timed=False)["bfloat16"]

        # (b) prefill: the probes at LONG_CHECK_LAYERS layers, the hold, the fit
        cut_cfg = dataclasses.replace(cfg, n_layers=LONG_CHECK_LAYERS)
        cut_params = cut_layers(params, LONG_CHECK_LAYERS)
        ref_params = tree_map(lambda t: t.float(), cut_params)  # the holds' float32 reference
        cut_fn = build(resized(dataclasses.replace(arch, cfg=cut_cfg), "prefill_32k", global_batch=1),
                       "prefill_32k").fn
        peaks = {}
        for pb in LONG_PROBES:
            tokens = torch.randint(0, cfg.vocab, (pb, t_len), generator=gen, device=gen.device, dtype=torch.int32)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            flash_attention.launches = 0
            with torch.no_grad():
                logits = cut_fn(cut_params, tokens)
                torch.cuda.synchronize()
            peaks[pb] = torch.cuda.max_memory_allocated()
            n = flash_attention.launches
            launches["flash_attention"] += n
            check(n == LONG_CHECK_LAYERS and tuple(logits.shape) == (pb, t_len, cfg.vocab),
                  f"{name}'s cut prefill launched K3 {n} times, logits {tuple(logits.shape)}")
            if pb == LONG_PROBES[0]:  # the hold, before the next probe's peak
                tail = logits[:, -LONG_TAIL:].clone()
                del logits
                with torch.no_grad():
                    plain_tail = with_plain_attention(lambda: cut_fn(cut_params, tokens)[:, -LONG_TAIL:].clone())
                    ref_tail = with_plain_attention(lambda: lm_tail(ref_params, cut_cfg, tokens, LONG_TAIL))
                rep["prefill_hold"] = bf16_hold(
                    f"{name} cut to {LONG_CHECK_LAYERS} layers, {pb} x {t_len} tokens, the logits of the last "
                    f"{LONG_TAIL} positions", tail, plain_tail, ref_tail)
                del tail, plain_tail, ref_tail
            else:
                del logits
            del tokens
            torch.cuda.empty_cache()
        lo, hi = LONG_PROBES
        per = (peaks[hi] - peaks[lo]) / (hi - lo)
        fixed = peaks[lo] - per * lo
        cell_batch = arch.cells["prefill_32k"].meta["global_batch"]
        batch = cell_batch
        while batch > 1 and fixed + per * batch > room:
            batch //= 2
        print(f"  {name} prefill_32k: peak memory {', '.join(f'{peaks[p] / 1e9:.2f} GB at {p}' for p in LONG_PROBES)}"
              f" sequences (cut): {per / 1e9:.3f} GB a sequence -> batch {batch}"
              + (f" (reduced from the cell's {cell_batch}: {(fixed + per * cell_batch) / 1e9:.1f} GB predicted, over "
                 f"{TRAIN_MEM_SHARE} of the card)" if batch < cell_batch else " (the cell's)"))
        prefill = build(resized(arch, "prefill_32k", global_batch=batch), "prefill_32k")
        tokens = torch.randint(0, cfg.vocab, (batch, t_len), generator=gen, device=gen.device, dtype=torch.int32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            start.record()
            logits = prefill.fn(params, tokens)
            end.record()
            end.synchronize()
        prefill_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated()
        n = flash_attention.launches
        launches["flash_attention"] += n
        finite = all(bool(torch.isfinite(logits[i, r:r + 4096]).all())
                     for i in range(batch) for r in range(0, t_len, 4096))
        print(f"  {name} prefill_32k at {batch} x {t_len} tokens, all {cfg.n_layers} layers: {prefill_ms:.1f} ms, "
              f"{batch * t_len / prefill_ms * 1e3:.1f} tokens/s; K3 launches {n}; peak memory {peak / 1e9:.2f} GB (the "
              f"fit predicted {(fixed + per * batch) / 1e9:.2f}); logits {tuple(logits.shape)} finite: {finite}")
        check(n == cfg.n_layers and tuple(logits.shape) == (batch, t_len, cfg.vocab) and finite,
              f"{name}'s prefill: K3 {n} launches, logits {tuple(logits.shape)}, finite {finite}")
        rep["prefill"] = dict(batch=batch, cell_batch=cell_batch, reduced=batch < cell_batch, seq_len=t_len,
                              probe_peak_gb={k: v / 1e9 for k, v in peaks.items()}, per_sequence_gb=per / 1e9,
                              predicted_peak_gb=(fixed + per * batch) / 1e9, peak_gb=peak / 1e9, ms=prefill_ms,
                              tokens_per_s=batch * t_len / prefill_ms * 1e3, launches=n)
        del logits, tokens
        torch.cuda.empty_cache()

        # (c) decode: a seeded 32,768-slot cache, steps at index 32,767
        per_seq = nbytes(lm.init_cache(cfg, 1, t_len, torch.bfloat16, device="meta"))
        cell_batch = arch.cells["decode_32k"].meta["global_batch"]
        batch = cell_batch
        while batch > 1 and weights + per_seq * batch > room:
            batch //= 2
        decode = build(resized(arch, "decode_32k", global_batch=batch), "decode_32k")
        cache = seeded_cache(cfg, batch, t_len, gen)
        index = t_len - 1
        kv = cache["dense"]
        q1 = torch.randn((batch, 1, cfg.n_heads, cfg.d_head), generator=gen, device=gen.device).to(torch.bfloat16)
        k_view, v_view = kv["k"][0], kv["v"][0]
        config = launch_config(q1.transpose(1, 2), k_view.transpose(1, 2), v_view.transpose(1, 2), causal=False)
        g = cfg.n_heads // cfg.n_kv_heads
        # the call held to its plain version on every sequence, in float32
        # (the cache widened) and in bfloat16 (the cache's own views)
        decode_err = {}
        for dname in ("float32", "bfloat16"):
            qd, kd, vd = (x.to(getattr(torch, dname)) for x in (q1, k_view, v_view))
            got = gqa_flash(qd, kd, vd, causal=False).transpose(1, 2)
            ok, err = bool(torch.isfinite(got).all()), 0.0
            for i in range(batch):
                kr, vr = (x[i:i + 1].transpose(1, 2).repeat_interleave(g, dim=1) for x in (kd, vd))
                want = attention_plain(qd[i:i + 1].transpose(1, 2), kr, vr).float()
                diff = (got[i:i + 1].float() - want).abs()
                err = max(err, diff.max().item())
                ok = ok and bool((diff <= TOL[dname] * (1 + want.abs())).all())
            decode_err[dname] = err
            print(f"  {name} K3 {dname:8s} decode [{batch}, {cfg.n_heads} ({cfg.n_kv_heads} KV), 1, {cfg.d_head}] "
                  f"over {t_len} keys, held at every sequence: max_err {err:.3g}")
            check(ok, f"{name}: K3's {dname} decode call over {t_len} keys disagrees with its plain version "
                      f"(max_err {err:.3g})")
            del qd, kd, vd, got, kr, vr, want, diff
        torch.cuda.empty_cache()
        k3_us, k3_src = device_or_event_us(torch, lambda: gqa_flash(q1, k_view, v_view, causal=False), reps=5)
        kr, vr = (x.transpose(1, 2).repeat_interleave(g, dim=1) for x in (k_view, v_view))
        lib_us, lib_src = device_or_event_us(
            torch, lambda: F.scaled_dot_product_attention(q1.transpose(1, 2), kr, vr), reps=5)
        del kr, vr
        k3_bytes = (q1.numel() * 2 + k_view.numel() + v_view.numel()) * 2
        k3_flops = 2.0 * batch * cfg.n_heads * t_len * 2 * cfg.d_head
        k3_ops_ms, k3_bytes_ms = bound_ms(k3_flops, k3_bytes, "bfloat16")
        print(f"  {name} decode_32k: cache {per_seq / 1e9:.3f} GB a sequence -> batch {batch}"
              + (f" (reduced from the cell's {cell_batch}: cache and weights "
                 f"{(weights + per_seq * cell_batch) / 1e9:.0f} GB, over {TRAIN_MEM_SHARE} of the card)"
                 if batch < cell_batch else " (the cell's)")
              + f"; K3 at T = 1 over {t_len} keys [{batch}, {cfg.n_heads} ({cfg.n_kv_heads} KV), 1, {cfg.d_head}] "
                f"({config['block']}, {config['blocks']} blocks): device {k3_us / 1e3:.4f} ms a call ({k3_src}), SDPA "
                f"{lib_us / 1e3:.4f} ms, bound {max(k3_ops_ms, k3_bytes_ms):.4f} ms (bytes)")
        # the steps at all layers: timed, each beside the same step with plain attention
        flash_attention.launches = 0
        gaps, times = [], []
        for i in range(LONG_DECODE_STEPS):
            tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=gen.device, dtype=torch.int32)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.no_grad():
                start.record()
                step_logits, cache = decode.fn(params, cache, tok, index)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
                check(tuple(step_logits.shape) == (batch, cfg.vocab)
                      and bool(torch.isfinite(step_logits.float()).all()),
                      f"{name}'s decode step: logits {tuple(step_logits.shape)}")
                plain_logits, cache = with_plain_attention(lambda: decode.fn(params, cache, tok, index))
            gaps.append((step_logits.float() - plain_logits.float()).abs().max().item())
            del step_logits, plain_logits
        n = flash_attention.launches
        launches["flash_attention"] += n
        peak = torch.cuda.max_memory_allocated()
        step_ms = sorted(times)[len(times) // 2]
        read_bytes = nbytes(cache) + weights
        print(f"  {name} decode_32k at batch {batch}, index {index}: {LONG_DECODE_STEPS} steps, median "
              f"{step_ms:.3f} ms "
              f"(all {', '.join(f'{v:.2f}' for v in times)}), {batch / step_ms * 1e3:.1f} tokens/s; bytes bound "
              f"{read_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms ({read_bytes / 1e9:.2f} GB of cache and weights at 3.35 "
              f"TB/s); K3 launches {n}; vs the same step with plain attention, all {cfg.n_layers} layers in bf16: "
              f"max |diff| {', '.join(f'{e:.4g}' for e in gaps)} (a record; held below at {LONG_CHECK_LAYERS} layers)")
        check(n == cfg.n_layers * LONG_DECODE_STEPS, f"{name}'s decode steps launched K3 {n} times")
        # the hold: the same steps at the cut, over the cache's first layers
        # (views), against plain attention's and the float32 reference's on
        # the first and the last sequence (their cache in float32, a copy)
        cut_decode = build(resized(dataclasses.replace(arch, cfg=cut_cfg), "decode_32k", global_batch=batch),
                           "decode_32k").fn
        seqs = sorted({0, batch - 1})
        cut_cache = {"dense": {key: val[:LONG_CHECK_LAYERS] for key, val in kv.items()}}
        ref_cache = {"dense": {key: val[:LONG_CHECK_LAYERS, seqs].float() for key, val in kv.items()}}
        holds = []
        for i in range(LONG_DECODE_STEPS):
            tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=gen.device, dtype=torch.int32)
            with torch.no_grad():
                got, cut_cache = cut_decode(cut_params, cut_cache, tok, index)
                plain_logits, cut_cache = with_plain_attention(lambda: cut_decode(cut_params, cut_cache, tok, index))
                ref, ref_cache = with_plain_attention(lambda: cut_decode(ref_params, ref_cache, tok[seqs], index))
            holds.append(bf16_hold(f"{name} decode step {i} at index {index}, cut to {LONG_CHECK_LAYERS} layers, "
                                   f"sequences {seqs}", got[seqs], plain_logits[seqs], ref))
            del got, plain_logits, ref
        check(flash_attention.launches - n == LONG_CHECK_LAYERS * LONG_DECODE_STEPS,
              f"{name}'s cut decode steps launched K3 {flash_attention.launches - n} times")
        launches["flash_attention"] += flash_attention.launches - n
        rep["decode"] = dict(batch=batch, cell_batch=cell_batch, reduced=batch < cell_batch, cache_slots=t_len,
                             index=index, cache_gb_per_sequence=per_seq / 1e9, steps=LONG_DECODE_STEPS,
                             step_ms=step_ms, step_ms_all=times, tokens_per_s=batch / step_ms * 1e3,
                             bytes_bound_ms=read_bytes / PEAK_BYTES_PER_S * 1e3, read_gb=read_bytes / 1e9,
                             vs_plain_all_layers=gaps, holds=holds, launches=n, peak_gb=peak / 1e9,
                             k3=dict(device_ms=k3_us / 1e3, source=k3_src, library_device_ms=lib_us / 1e3,
                                     library_source=lib_src, bound_ms=max(k3_ops_ms, k3_bytes_ms),
                                     bound_by="operations" if k3_ops_ms >= k3_bytes_ms else "bytes",
                                     max_abs_err=decode_err, **config))
        del cache, params, cut_params, ref_params, cut_cache, ref_cache, q1, k_view, v_view, kv
        gc.collect()
        torch.cuda.empty_cache()
        rep["phase_s"] = time.perf_counter() - t0
        print(f"  {name}: {rep['phase_s']:.1f} s")
    phase_s = time.perf_counter() - phase_t0
    print(f"  phase 20: {phase_s:.1f} s")
    report["phase_s"] = phase_s
    report["launches"] = dict(launches)
    return report, launches


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
    ``shapes`` (``conv_shapes``: shape -> calls a forward, each run VALID
    with a bias), on seeded inputs; fatal where it disagrees.  With
    ``timed``, each shape is also timed as phase 3 times it (kernel, plain
    version, ``F.conv2d``) beside its bounds.  K1's launch count is left as
    it was: these launches compare, they are no path's.  Returns one row per
    shape."""
    import torch.nn.functional as F

    holds = [dict(hold_conv(torch, F, gen, ((n, h, w, cin), (k, k, cin, cout), st, 0, 1, True, "float32"), timed),
                  path=path, per_forward=per_forward)
             for (n, h, w, cin, cout, k, st), per_forward in sorted(shapes.items())]
    torch.cuda.synchronize()
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
    # K1 (convs) or the pool at the single-device shape (device_or_event_us)
    lgen = torch.Generator(device="cuda").manual_seed(11)
    layers = []
    for i, g in enumerate(net.layers):
        if g.kind == "conv":
            x = torch.randn((1, sizes[i] + 2 * g.p, sizes[i] + 2 * g.p, g.c_in), generator=lgen, device="cuda")
            p = params["features"][i]
            meas, src = device_or_event_us(
                torch, lambda x=x, p=p, g=g: conv2d_cuda(x, p["w"], p["b"], stride=g.s, padding=0))
        else:
            x = torch.randn((1, sizes[i], sizes[i], g.c_in), generator=lgen, device="cuda")
            meas, src = device_or_event_us(torch, lambda x=x, g=g: max_pool(x, k=g.k, s=g.s))
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


# Phase 13: the vision family served at full width.  K1 launches a forward
# (all, of which depthwise) and K3's, whatever the batch and resolution.
VISION_ARCHS = ("vit-l16", "swin-b", "convnext-b", "efficientnet-b7")
VISION_LAUNCHES = {"vit-l16": (1, 0, 24), "swin-b": (1, 0, 0), "convnext-b": (40, 36, 0),
                   "efficientnet-b7": (163, 55, 0)}


@contextlib.contextmanager
def model_kernels(conv, attn):
    """The vision and diffusion models' K1 and K3 calls
    (``models.layers.conv2d_cuda``; ``flash_attention`` as ``models.vit``,
    ``unet`` and ``dit`` call it) through ``conv`` and ``attn``, which take
    the wrappers' arguments; then the wrappers restored."""
    from repro_torch.models import dit, layers, unet, vit

    attn_mods = (vit, unet, dit)
    real = layers.conv2d_cuda, [m.flash_attention for m in attn_mods]
    layers.conv2d_cuda = conv
    for m in attn_mods:
        m.flash_attention = attn
    try:
        yield
    finally:
        layers.conv2d_cuda = real[0]
        for m, f in zip(attn_mods, real[1]):
            m.flash_attention = f


@contextlib.contextmanager
def recording_calls():
    """Records the arguments of every K1 and K3 call the vision and
    diffusion models make while entered, by call signature (``hold_conv``'s;
    K3's: q's shape, the key count, dtype); the wrappers run as they are, so
    their launch counts move as without it."""
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_cuda

    rec = types.SimpleNamespace(convs=Counter(), attns=Counter(), sdpa=None)

    def conv(x, w, b=None, *, stride=1, padding=1, groups=1):
        rec.convs[(tuple(x.shape), tuple(w.shape), stride, padding, groups, b is not None,
                   str(x.dtype).removeprefix("torch."))] += 1
        return conv2d_cuda(x, w, b, stride=stride, padding=padding, groups=groups)

    def attn(q, k, v, *, causal=True):
        rec.attns[(tuple(q.shape), k.shape[2], str(q.dtype).removeprefix("torch."))] += 1
        return flash_attention(q, k, v, causal=causal)

    with model_kernels(conv, attn):
        yield rec


def attention_plain(q, k, v, causal: bool = False):
    """K3's plain version on [B, H, T, D] operands: in one call, or past
    PLAIN_LOGITS_BYTES of float32 logits (gen_1024's U-Net: 4 x 8 x 16384^2
    x 4 B = 34 GB) one (batch, head) slice at a time (a 32,768-token head:
    4.3 GB of logits, about three times that while masked and softmaxed)."""
    from repro_torch.kernels.attention import attention_ref

    b, h, t, _ = q.shape
    if b * h * t * k.shape[2] * 4 <= PLAIN_LOGITS_BYTES:
        return attention_ref(q, k, v, causal=causal)
    out = q.new_empty((b, h, t, v.shape[3]))
    for i in range(b):
        for j in range(h):
            out[i, j] = attention_ref(q[i:i + 1, j:j + 1], k[i:i + 1, j:j + 1], v[i:i + 1, j:j + 1],
                                      causal=causal)[0, 0]
    return out


@contextlib.contextmanager
def held_on_path(torch, sum_rtol: float = 0.0):
    """While entered, every K1 and K3 call the vision and diffusion models
    make is also run through its plain version on the same inputs
    (``attention_plain``), and the kernel's output held against it at TOL
    (fatal beyond it): the kernels on the path's own activations.  With
    ``sum_rtol`` a K1 output may also miss by ``sum_rtol`` x sum |x| |w|
    (+ |b|) at its element -- the scale of a float32 sum's rounding, which
    TOL x (1 + |y|) does not follow where large inputs cancel (the U-Net's
    residual stream; ``SUM_RTOL``).  Yields the rows; the launch counts are
    restored on exit."""
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref

    rows = []
    counts = conv2d_cuda.launches, conv2d_cuda.depthwise_launches, flash_attention.launches

    def held(kind, got, want, what, slack=None):
        diff = (got.float() - want.float()).abs()
        dname = str(got.dtype).removeprefix("torch.")
        limit = TOL[dname] * (1 + want.float().abs())
        within_tol = bool((diff <= limit).all())
        if slack is not None:
            limit = limit + slack
        ok = bool((diff <= limit).all())
        rows.append(dict(kernel=kind, what=what, dtype=dname, max_abs_err=diff.max().item(),
                         max_abs_out=want.float().abs().max().item(), within_tol=within_tol, held=ok,
                         limit_share=(diff / limit).max().item()))
        check(ok, f"{kind} disagrees with its plain version on the path's activations: {rows[-1]}")
        return got

    def conv(x, w, b=None, *, stride=1, padding=1, groups=1):
        kw = dict(stride=stride, padding=padding, groups=groups)
        slack = None
        if sum_rtol:
            babs = None if b is None else b.abs()
            slack = sum_rtol * conv2d_ref(x.abs(), w.abs(), babs, **kw).float()
        return held("K1", conv2d_cuda(x, w, b, **kw), conv2d_ref(x, w, b, **kw),
                    f"{list(x.shape)} -> {w.shape[-1]} k{w.shape[0]} s{stride} p{padding} g{groups}", slack)

    def attn(q, k, v, *, causal=True):
        return held("K3", flash_attention(q, k, v, causal=causal), attention_plain(q, k, v, causal=causal),
                    f"{list(q.shape)} S={k.shape[2]}")

    try:
        with model_kernels(conv, attn):
            yield rows
    finally:
        torch.cuda.synchronize()
        conv2d_cuda.launches, conv2d_cuda.depthwise_launches, flash_attention.launches = counts


def hold_conv(torch, F, gen, sig: tuple, timed: bool, device_times: bool = False) -> dict:
    """K1 against its plain version at one call signature (input and weight
    shapes, stride, padding, groups, bias, dtype: ``recording_calls``), on
    seeded inputs; fatal beyond TOL.  With ``timed``, the CUDA-event means
    of the kernel, the plain version and ``F.conv2d`` (with ``groups=C`` for
    depthwise; never on the path) and the bound; with ``device_times`` also
    the kernel's and ``F.conv2d``'s device us per call from profiler
    windows.  The launch counts are left as they were."""
    from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref
    from repro_torch.kernels.conv2d.ops import launch_config

    counts = conv2d_cuda.launches, conv2d_cuda.depthwise_launches
    (n, h, w, cin), (k, _, w_cin, cout), st, pad, groups, has_bias, dname = sig
    dt = getattr(torch, dname)
    x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(dt)
    wt = (math.sqrt(2.0 / (k * k * w_cin)) * torch.randn((k, k, w_cin, cout), generator=gen, device="cuda")).to(dt)
    b = (0.1 * torch.randn((cout,), generator=gen, device="cuda")).to(dt) if has_bias else None
    kw = dict(stride=st, padding=pad, groups=groups)
    got, want = conv2d_cuda(x, wt, b, **kw), conv2d_ref(x, wt, b, **kw)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= TOL[dname] * (1 + want.float().abs())).all()) and bool(torch.isfinite(got.float()).all())
    row = dict(shape=[n, h, w, cin, cout], k=k, stride=st, pad=pad, groups=groups, bias=has_bias, dtype=dname,
               max_abs_err=diff.max().item(), within_tol=ok, **launch_config(x, wt, **kw))
    check(ok, f"K1 disagrees with its plain version at {row}")
    if timed:
        xn, wn = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)  # NCHW / OIHW views

        def lib():
            return F.conv2d(xn, wn, b, stride=st, padding=pad, groups=groups)

        flops = 2.0 * k * k * w_cin * cout * n * got.shape[1] * got.shape[2]
        nbytes = (x.numel() + wt.numel() + (b.numel() if has_bias else 0) + got.numel()) * x.element_size()
        ops_ms, bytes_ms = bound_ms(flops, nbytes, dname)
        row.update(ms=time_ms(torch, lambda: conv2d_cuda(x, wt, b, **kw)),
                   plain_ms=time_ms(torch, lambda: conv2d_ref(x, wt, b, **kw), reps=5),
                   library_ms=time_ms(torch, lib),
                   bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms,
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   ffma_bound_ms=max(bound_ms(flops, nbytes, dname, ffma=True)))
        if device_times:
            row["device_us"], row["device_source"] = device_or_event_us(
                torch, lambda: conv2d_cuda(x, wt, b, **kw), reps=10)
            row["library_device_us"], row["library_device_source"] = device_or_event_us(torch, lib, reps=10)
    torch.cuda.synchronize()
    conv2d_cuda.launches, conv2d_cuda.depthwise_launches = counts
    return row


def hold_vit_attention(torch, F, gen, b: int, h: int, t: int, d: int, dname: str, timed: bool) -> dict:
    """K3 against its plain version at ViT's layout: q, k and v the three
    slices of one [B, T, 3, H, D] projection seen as [B, H, T, D], not
    causal; fatal beyond TOL.  With ``timed``, the CUDA-event means of the
    kernel, the plain version and SDPA (never on the path), their device us
    per call from profiler windows, and the bound.  The count is left as it
    was."""
    from repro_torch.kernels.attention import attention_ref, flash_attention
    from repro_torch.kernels.attention.ops import launch_config

    count = flash_attention.launches
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").to(getattr(torch, dname))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    got, want = flash_attention(q, k, v, causal=False), attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= TOL[dname] * (1 + want.float().abs())).all()) and bool(torch.isfinite(got.float()).all())
    row = dict(b=b, h=h, t=t, s=t, d=d, dtype=dname, max_abs_err=diff.max().item(), within_tol=ok,
               **launch_config(q, k, v, causal=False))
    check(ok, f"K3 disagrees with its plain version at ViT's shape {row}")
    if timed:
        def lib():
            return F.scaled_dot_product_attention(q, k, v)

        flops = 2.0 * b * h * t * t * (d + d)
        nbytes = 4 * b * h * t * d * qkv.element_size()  # q, k, v in; o out
        ops_ms, bytes_ms = bound_ms(flops, nbytes, dname)
        kern = lambda: flash_attention(q, k, v, causal=False)  # noqa: E731
        row.update(ms=time_ms(torch, kern), plain_ms=time_ms(torch, lambda: attention_ref(q, k, v, causal=False)),
                   library_ms=time_ms(torch, lib), library_backend=sdpa_backend(torch, lib),
                   bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms,
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   ffma_bound_ms=max(bound_ms(flops, nbytes, dname, ffma=True)))
        row["device_us"], row["device_source"] = device_or_event_us(torch, kern)
        row["library_device_us"], row["library_device_source"] = device_or_event_us(torch, lib)
    torch.cuda.synchronize()
    flash_attention.launches = count
    return row


def phase_vision(torch) -> tuple[dict, dict, list, list]:
    """Phase 13: ViT-L/16, Swin-B, ConvNeXt-B and EfficientNet-B7 at full
    width, each (1) served through ``launch.serve.serve`` (N_REQUESTS at
    MAX_BATCH, its FULL config: EfficientNet at 600), (2) one forward at
    batch MAX_BATCH, float32 and bfloat16, counted against
    ``VISION_LAUNCHES`` and recorded (``recording_calls``), no SDPA operator
    in its profile, (3) ``configs.steps.build``'s ``serve_b1`` (bfloat16,
    224) held to the float32 forward of the same bf16-rounded weights and
    ``serve_b128`` run once counted and once timed, (4) every kernel call of
    the float32 forward held on its own activations (``held_on_path``) and
    image 0 held to the plain versions' float32 forward on the CPU --
    ConvNeXt also with every gamma 1 (``layer_scale = 1.0``), EfficientNet
    with batch-norm statistics from the batch (``calibrated_bn``) --, (5) K1
    and K3 held against their plain versions at every call signature those
    forwards made (the batch-4 float32 ones timed), (6) steady f32 / bf16
    forwards timed and profiled.  Returns the report, the launches of its
    counted runs, and its K1 and K3 rows."""
    import torch.nn.functional as F

    from repro_torch.configs import get as get_arch
    from repro_torch.configs.steps import build
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.launch.serve import serve
    from repro_torch.models.common import tree_map

    phase_t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(13)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    launches = {"conv2d": 0, "conv2d_depthwise": 0, "flash_attention": 0}
    conv_rows, attn_rows, report = [], [], {}

    def zero():
        conv2d_cuda.launches = conv2d_cuda.depthwise_launches = flash_attention.launches = 0

    def read() -> tuple[int, int, int]:
        got = (conv2d_cuda.launches, conv2d_cuda.depthwise_launches, flash_attention.launches)
        for key, n in zip(launches, got):
            launches[key] += n
        return got

    def counted(label, fn, want, profile=False):
        """One call of ``fn`` with the counts set to 0 before and read after,
        its kernel calls recorded; fatal unless the counts are ``want``."""
        zero()
        with recording_calls() as rec:
            if profile:
                with torch.profiler.profile(activities=acts) as prof:
                    y = fn()
                    torch.cuda.synchronize()
                rec.sdpa = sdpa_ops(prof)
            else:
                y = fn()
                torch.cuda.synchronize()
        got = read()
        print(f"  {label}: K1 launches {got[0]} (depthwise {got[1]}), K3 {got[2]}; expected {want}")
        check(got == want, f"{label} launched {got}, expected {want}")
        check(bool(torch.isfinite(y.float()).all()), f"{label}: non-finite logits")
        return y, rec

    for name in VISION_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        arch = get_arch(name)
        cfg, mod, want = arch.cfg, arch.module, VISION_LAUNCHES[name]

        # (1) served through the launcher
        zero()
        out = serve(name, n_requests=N_REQUESTS, max_batch=MAX_BATCH, device="cuda", seed=0)
        served = read()
        stats, reqs = out["stats"], out["requests"]
        n_batches = len({r.done for r in reqs})
        params, x4 = out["params"], out["images"][:MAX_BATCH]
        n_params = sum(t.numel() for t in tree_leaves(params))
        print(f"{name} ({cfg.img_res}x{cfg.img_res}, {n_params / 1e6:.1f} M parameters) served "
              f"{stats['completed']} requests in {n_batches} batches of {MAX_BATCH}: p50 "
              f"{stats['p50_latency_s'] * 1e3:.3f} ms p99 {stats['p99_latency_s'] * 1e3:.3f} ms "
              f"{out['requests_per_s']:.3f} req/s; launches {served}")
        check(stats["completed"] == N_REQUESTS and n_batches >= -(-N_REQUESTS // MAX_BATCH), "serving fell short")
        check(served == tuple(n_batches * c for c in want), f"serving launched {served}, {n_batches} x {want}")
        logits = out["logits"]
        check(tuple(logits.shape) == (N_REQUESTS, cfg.num_classes) and bool(torch.isfinite(logits).all()),
              f"bad served logits {tuple(logits.shape)}")

        # (2) one forward at batch MAX_BATCH, counted and recorded, f32 then bf16
        y32, rec32 = counted("float32 forward", lambda: mod.apply(params, cfg, x4), want, profile=True)
        print(f"  SDPA operators in its profile: {rec32.sdpa or 'none'}")
        check(not rec32.sdpa, f"{name}'s forward ran {rec32.sdpa}")
        lossless = (y32 - logits[:MAX_BATCH]).abs().max().item()
        check(torch.allclose(y32, logits[:MAX_BATCH], rtol=2e-5, atol=2e-5),
              f"the forward disagrees with the served logits ({lossless})")
        extra, y_hold = {}, y32
        if name == "efficientnet-b7":
            # With JAX's init statistics (mean 0, var 1) no batch norm
            # normalises, the activations grow to ~1e6 and two correct float32
            # forwards part: a record.  The holds below run on the same weights
            # with each batch norm's statistics taken from this batch, as a
            # trained model's running statistics normalise its activations.
            c0 = mod.apply(tree_map(lambda t: t.cpu(), params), cfg, x4[:1].cpu())
            with plain_kernels():
                p0 = mod.apply(params, cfg, x4[:1])
            extra["init_stats"] = dict(max_abs_logit=c0.abs().max().item(),
                                       kernels_vs_cpu=(y32[:1].cpu() - c0).abs().max().item(),
                                       plain_on_card_vs_cpu=(p0.cpu() - c0).abs().max().item())
            print(f"  at JAX's init statistics (record): max |logit| {extra['init_stats']['max_abs_logit']:.4g}; "
                  f"image 0 vs the CPU: kernels {extra['init_stats']['kernels_vs_cpu']:.4g}, the plain "
                  f"versions on the card {extra['init_stats']['plain_on_card_vs_cpu']:.4g}")
            del c0, p0
            params = calibrated_bn(torch, mod, params, cfg, x4)
            y_hold, _ = counted("float32 forward, batch-norm statistics of this batch",
                                lambda: mod.apply(params, cfg, x4), want)
        bparams = tree_map(lambda t: t.to(torch.bfloat16), params)
        xb = x4.to(torch.bfloat16)
        y16, rec16 = counted("bfloat16 forward", lambda: mod.apply(bparams, cfg, xb), want)

        # (3) the step builder's serve cells, bfloat16 (build's default), at 224
        b1, b128 = build(arch, "serve_b1"), build(arch, "serve_b128")
        check(b1.inputs["images"][1] == torch.bfloat16 and b128.inputs["images"][1] == torch.bfloat16,
              "build's serve cells are not bfloat16")
        check([(tuple(t.shape), t.dtype) for t in tree_leaves(bparams)] == tree_leaves(b1.state),
              "the weights do not match the bundle's shapes")
        img1 = torch.randn(b1.inputs["images"][0], generator=gen, device="cuda").to(torch.bfloat16)
        s1, rec1 = counted("serve_b1 (bfloat16, 224)", lambda: b1.fn(bparams, img1), want)
        rparams = tree_map(lambda t: t.float(), bparams)
        r1 = b1.fn(rparams, img1.float())
        with plain_kernels():
            p1 = b1.fn(bparams, img1)
        del rparams
        b_err = (s1.float() - r1).abs().max().item()
        b_plain = (p1.float() - r1).abs().max().item()
        b_vs_plain = (s1.float() - p1.float()).abs().max().item()
        b_scale = r1.abs().max().item()
        # BF16_RTOL, or as phase 7 1.25x the plain versions' own bfloat16 gap
        # where bfloat16 arithmetic itself misses it (EfficientNet-B7: 0.05
        # of its largest |logit| in the plain versions too)
        b_limit = max(BF16_RTOL * b_scale, 1.25 * b_plain)
        print(f"  serve_b1 vs the float32 forward of its bf16-rounded weights: max |diff| {b_err:.4g} (max "
              f"|logit| {b_scale:.4g}; the plain versions in bf16: {b_plain:.4g}; limit {b_limit:.4g} = the "
              f"larger of {BF16_RTOL} x max |logit| and 1.25 x the plain gap); kernels vs the plain versions, "
              f"both bf16: {b_vs_plain:.4g}")
        check(b_err <= b_limit, f"{name}'s bfloat16 forward drifts from the float32 one")
        img128 = torch.randn(b128.inputs["images"][0], generator=gen, device="cuda").to(torch.bfloat16)
        _, rec128 = counted("serve_b128 (bfloat16, 224)", lambda: b128.fn(bparams, img128), want)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(3):
            b128.fn(bparams, img128)
        torch.cuda.synchronize()
        b128_ms = (time.perf_counter() - t1) / 3 * 1e3
        print(f"  serve_b128 steady forward (host clock, 3 runs): {b128_ms:.3f} ms, "
              f"{128 / b128_ms * 1e3:.1f} images/s")

        # (4) every kernel call of the float32 forward against its plain
        # version on the same activations; then image 0 against the plain
        # versions' float32 forward on the CPU (the plain versions on the
        # card beside it: the gap a change of summation order alone makes)
        with held_on_path(torch) as path_rows:
            mod.apply(params, cfg, x4)
        worst = max(path_rows, key=lambda r: r["max_abs_err"] / (1 + r["max_abs_out"]))
        print(f"  on the path's own activations: {len(path_rows)} kernel calls each within TOL of its plain "
              f"version (largest share of the limit: {worst['kernel']} {worst['what']}, max_err "
              f"{worst['max_abs_err']:.3g} at max |out| {worst['max_abs_out']:.3g})")
        t1 = time.perf_counter()
        cparams = tree_map(lambda t: t.cpu(), params)
        c_logits = mod.apply(cparams, cfg, x4[:1].cpu())
        cpu_s = time.perf_counter() - t1
        with plain_kernels():
            pc_logits = mod.apply(params, cfg, x4[:1])
        c_err = (y_hold[:1].cpu() - c_logits).abs().max().item()
        c_plain = (pc_logits.cpu() - c_logits).abs().max().item()
        c_scale = c_logits.abs().max().item()
        c_limit = DEPTH_RTOL * c_scale
        print(f"  vs the plain versions on the CPU (image 0, {cpu_s:.1f} s with the host copy): max |diff| "
              f"{c_err:.4g} (max |logit| {c_scale:.4g}, limit {DEPTH_RTOL} x that; the plain versions on the "
              f"card: {c_plain:.4g})")
        check(c_err <= c_limit, f"{name} drifts from the plain versions on the CPU")
        if name == "convnext-b":  # every branch at full weight: a wrong depthwise conv would show
            def unit_gamma(tree):
                return {**tree, "stages": [{**st, "blocks": {**st["blocks"], "gamma": torch.ones_like(
                    st["blocks"]["gamma"])}} for st in tree["stages"]]}

            lparams = unit_gamma(params)
            yl, _ = counted("float32 forward at layer_scale 1.0", lambda: mod.apply(lparams, cfg, x4), want)
            cl = mod.apply(unit_gamma(cparams), cfg, x4[:1].cpu())
            l_err, l_scale = (yl[:1].cpu() - cl).abs().max().item(), cl.abs().max().item()
            gap = (yl - y32).abs().max().item()
            print(f"  layer_scale 1.0 vs the CPU: max |diff| {l_err:.4g} (max |logit| {l_scale:.4g}, limit "
                  f"{DEPTH_RTOL} x that); its logits move {gap:.4g} from layer_scale 1e-6's")
            check(l_err <= DEPTH_RTOL * l_scale, "ConvNeXt at layer_scale 1.0 drifts from the CPU")
            extra.update(layer_scale_1_cpu_max_abs=l_err, layer_scale_1_max_abs_logit=l_scale,
                         layer_scale_1_vs_1e6=gap)
            del lparams
        del cparams

        # (5) K1 and K3 at every call signature of those forwards; batch 4 timed
        held = 0
        for path, rec, timed in (("b4-float32", rec32, True), ("b4-bfloat16", rec16, False),
                                 ("serve_b1", rec1, False), ("serve_b128", rec128, False)):
            for sig, per_forward in sorted(rec.convs.items(), key=str):
                conv_rows.append(dict(hold_conv(torch, F, gen, sig, timed, device_times=True), arch=name,
                                      path=path, per_forward=per_forward))
                held += 1
            for (shape, _, dname), per_forward in rec.attns.items():
                bq, hq, tq, dq = shape
                attn_rows.append(dict(hold_vit_attention(torch, F, gen, bq, hq, tq, dq, dname, timed),
                                      arch=name, path=path, per_forward=per_forward))
        # every depthwise signature (bf16 and the serve cells' too) takes 16-byte channel vectors
        dw_rows = [r for r in conv_rows if r["arch"] == name and r["groups"] > 1]
        check(all(r["depthwise"]["copies"] == "16-byte" for r in dw_rows),
              f"{name}: a depthwise conv takes narrower copies: "
              f"{[(r['shape'], r['dtype'], r['depthwise']) for r in dw_rows if r['depthwise']['copies'] != '16-byte']}")
        for r in (r for r in conv_rows if r["arch"] == name and r["path"] == "b4-float32"):
            print(f"  conv {r['shape']} k{r['k']} s{r['stride']} p{r['pad']} g{r['groups']}"
                  f"{' bias' if r['bias'] else ''} x{r['per_forward']}/fwd S={r['splits']} {conv_how(r)}: "
                  f"max_err {r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms ({r['device_us']:.2f} us, "
                  f"{r['device_source']}) plain {r['plain_ms']:.4f} F.conv2d {r['library_ms']:.4f} "
                  f"({r['library_device_us']:.2f} us, {r['library_device_source']}) bound {r['bound_ms']:.4f} "
                  f"({r['bound_by']})")
        for r in (r for r in attn_rows if r["arch"] == name and "ms" in r):
            print(f"  attn B{r['b']} H{r['h']} T{r['t']} D{r['d']} x{r['per_forward']}/fwd [{r['block']}]: "
                  f"max_err {r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms ({r['device_us']:.2f} us, "
                  f"{r['device_source']}) plain {r['plain_ms']:.4f} SDPA {r['library_ms']:.4f} "
                  f"({r['library_device_us']:.2f} us, {r['library_device_source']}; {r['library_backend']}) bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']})")
        mine = [r for r in conv_rows + attn_rows if r["arch"] == name]
        print(f"  held {held} K1 signatures (max_err float32 "
              f"{max([r['max_abs_err'] for r in mine if r['dtype'] == 'float32'], default=0):.3g}, bfloat16 "
              f"{max([r['max_abs_err'] for r in mine if r['dtype'] == 'bfloat16'], default=0):.3g}) and "
              f"{len(mine) - held} K3")

        # (6) where the time goes
        f_ms, f_busy, f_top, f_fams = steady_and_profiled(torch, lambda: mod.apply(params, cfg, x4),
                                                          f"{name} float32")
        h_ms, h_busy, h_top, h_fams = steady_and_profiled(torch, lambda: mod.apply(bparams, cfg, xb),
                                                          f"{name} bfloat16")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        arch_s = time.perf_counter() - t0
        print(f"  {name}: {arch_s:.1f} s, peak device memory allocated {peak_gb:.2f} GB")
        report[name] = dict(
            img_res=cfg.img_res, n_params=n_params, launches_per_forward=want, served_launches=served,
            serve=dict(stats, requests_per_s=out["requests_per_s"], wall_s=out["wall_s"], batches=n_batches),
            served_vs_forward_max_abs=lossless, cpu_max_abs=c_err, cpu_max_abs_logit=c_scale, cpu_s=cpu_s,
            cpu_plain_on_card_max_abs=c_plain, cpu_limit=c_limit, path_holds=len(path_rows),
            path_worst=worst,
            bf16_b1_max_abs=b_err, bf16_b1_plain_max_abs=b_plain, bf16_b1_max_abs_logit=b_scale,
            bf16_b1_limit=b_limit, bf16_b1_vs_plain_bf16=b_vs_plain,
            sdpa_ops=rec32.sdpa, serve_b128_ms=b128_ms, serve_b128_images_per_s=128 / b128_ms * 1e3,
            float32=dict(steady_ms=f_ms, device_busy_ms=f_busy, top_device=f_top, device_ms_by_kernel=f_fams),
            bfloat16=dict(steady_ms=h_ms, device_busy_ms=h_busy, top_device=h_top, device_ms_by_kernel=h_fams),
            peak_device_gb=peak_gb, phase_s=arch_s, **extra)
        del out, params, bparams, logits, x4, xb, y32, y_hold, y16, s1, r1, p1, img1, img128
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - phase_t0
    print(f"  phase 13: {phase_s:.1f} s")
    report["phase_s"] = phase_s
    return report, launches, conv_rows, attn_rows


# Phase 14: diffusion generation at full width.  K1 and K3 launches a
# forward, whatever the batch and resolution: UNet-SD1.5 66 convs (conv_in,
# 21 down with 3 downsamples, 4 mid, 39 up with 3 upsamples, conv_out) and
# 16 transformer blocks of a self and a cross attention; DiT-XL/2 its patch
# embedding and 28 blocks.
DIFFUSION_ARCHS = ("unet-sd15", "dit-xl2")
DIFFUSION_LAUNCHES = {"unet-sd15": (66, 32), "dit-xl2": (1, 28)}
# gen_1024's 50 DDIM steps cut to GEN_1024_STEPS: every step runs the same
# shapes, so two show each K3 call at T = 16384 (U-Net) / 4096 (DiT)
GEN_1024_STEPS = 2
# image 0 of a float32 forward at this resolution is held to the plain
# versions' forward on the CPU (latent 32: the U-Net's level-0 attention at
# T = 1024 keeps the CPU forward to seconds)
DIFFUSION_CPU_RES = 256
# float32 logits past this many bytes: the plain attention runs one (batch,
# head) slice at a time (attention_plain)
PLAIN_LOGITS_BYTES = 4e9
# K1 on the U-Net's path: its residual stream grows to |x| ~ 80 at random
# weights, and where such inputs cancel (|y| << sum |x w|, K up to 23,040)
# two float32 sums in other orders part by more than TOL x (1 + |y|); each
# such output may also miss by SUM_RTOL x sum |x| |w| -- 16 units of float32
# roundoff of the sum's terms (held_on_path's sum_rtol)
SUM_RTOL = 2.0 ** -20


def hold_diffusion_attention(torch, F, gen, sig: tuple, timed: bool) -> dict:
    """K3 against its plain version at one U-Net call signature (q's shape
    [B, H, T, D], the S keys, dtype: ``recording_calls``' ``attns``): q
    from a [B, T, H*D] projection and k, v from [B, S, H*D] ones, each seen
    as [B, H, n, D] (``unet._mha``'s views), not causal; fatal beyond TOL.
    With ``timed``, the CUDA-event means of the kernel, the plain version and
    SDPA (never on the path), their device us per call from profiler
    windows, and the bound.  The count is left as it was."""
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.attention.ops import launch_config

    count = flash_attention.launches
    (b, h, t, d), s, dname = sig
    dt = getattr(torch, dname)
    q, k, v = (torch.randn((b, n, h * d), generator=gen, device="cuda").to(dt).view(b, n, h, d).transpose(1, 2)
               for n in (t, s, s))
    got, want = flash_attention(q, k, v, causal=False), attention_plain(q, k, v)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= TOL[dname] * (1 + want.float().abs())).all()) and bool(torch.isfinite(got.float()).all())
    row = dict(b=b, h=h, t=t, s=s, d=d, dtype=dname, max_abs_err=diff.max().item(), within_tol=ok,
               **launch_config(q, k, v, causal=False))
    check(ok, f"K3 disagrees with its plain version at the U-Net's shape {row}")
    del want, diff
    if timed:
        def lib():
            return F.scaled_dot_product_attention(q, k, v)

        flops = 2.0 * b * h * t * s * (d + d)
        nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) * q.element_size()
        ops_ms, bytes_ms = bound_ms(flops, nbytes, dname)
        kern = lambda: flash_attention(q, k, v, causal=False)  # noqa: E731
        row.update(ms=time_ms(torch, kern), plain_ms=time_ms(torch, lambda: attention_plain(q, k, v), reps=5),
                   library_ms=time_ms(torch, lib), library_backend=sdpa_backend(torch, lib),
                   bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms,
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   ffma_bound_ms=max(bound_ms(flops, nbytes, dname, ffma=True)))
        row["device_us"], row["device_source"] = device_or_event_us(torch, kern, reps=10)
        row["library_device_us"], row["library_device_source"] = device_or_event_us(torch, lib, reps=10)
    torch.cuda.synchronize()
    flash_attention.launches = count
    return row


def perturb_adaln(torch, params, gen) -> None:
    """DiT's adaLN-zero weights -- every block's ``ada`` and ``final_ada``,
    zero at init, so each block is the identity and a hold would check
    nothing of K3 -- drawn in place from ``gen``: w N(0, 1 / d), b 0.1 N(0, 1)."""
    for p in (params["blocks"]["ada"], params["final_ada"]):
        p["w"].copy_(torch.randn(p["w"].shape, generator=gen, device="cuda") / math.sqrt(p["w"].shape[-2]))
        p["b"].copy_(0.1 * torch.randn(p["b"].shape, generator=gen, device="cuda"))


def phase_diffusion(torch) -> tuple[dict, dict, list, list]:
    """Phase 14: UNet-SD1.5 and DiT-XL/2 at full width (seeded weights; DiT's
    adaLN-zero weights drawn, ``perturb_adaln``), each (1) one float32
    forward at batch MAX_BATCH at gen_fast's 512 (latent 64), counted
    against ``DIFFUSION_LAUNCHES`` and recorded, no SDPA operator in its
    profile, every K1 / K3 call held on its own activations
    (``held_on_path``), and the same in bfloat16, counted; (2) image 0 of a
    float32 forward at 256 (latent 32) held to the plain versions' forward on
    the CPU within DEPTH_RTOL (the plain versions on the card beside); (3)
    ``configs.steps.build``'s ``gen_fast`` whole (bfloat16, batch 16, 4 DDIM
    steps), counted, timed and held to the float32 sampler of the same
    bf16-rounded weights by phase 7's rule; (4) ``gen_1024`` (bfloat16,
    batch 4, 1024: latent 128) with its steps cut to GEN_1024_STEPS, counted,
    timed, and every kernel call held on its own activations, K3's one
    (batch, head) slice at a time; (5) K1 and K3 held against their plain
    versions at every call signature those runs made (the batch-4 float32
    ones timed beside F.conv2d / SDPA, never on the path, with device us and
    the bound); (6) steady f32 / bf16 forwards at batch 4 timed and profiled.
    Returns the report, the launches of its counted runs, and its K1 and K3
    rows."""

    import torch.nn.functional as F

    from repro_torch.configs import Cell
    from repro_torch.configs import get as get_arch
    from repro_torch.configs.steps import build
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.models.common import tree_map

    phase_t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(14)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    launches = {"conv2d": 0, "flash_attention": 0}
    conv_rows, attn_rows, report = [], [], {}

    def counted(label, fn, want, profile=False):
        """One call of ``fn`` with the counts set to 0 before and read after,
        its kernel calls recorded; fatal unless the counts are ``want``."""
        conv2d_cuda.launches = conv2d_cuda.depthwise_launches = flash_attention.launches = 0
        with recording_calls() as rec:
            if profile:
                with torch.profiler.profile(activities=acts) as prof:
                    y = fn()
                    torch.cuda.synchronize()
                rec.sdpa = sdpa_ops(prof)
            else:
                y = fn()
                torch.cuda.synchronize()
        got = (conv2d_cuda.launches, flash_attention.launches)
        launches["conv2d"] += got[0]
        launches["flash_attention"] += got[1]
        print(f"  {label}: K1 launches {got[0]}, K3 {got[1]}; expected {want}")
        check(got == want, f"{label} launched {got}, expected {want}")
        check(bool(torch.isfinite(y.float()).all()), f"{label}: non-finite output")
        return y, rec

    for name in DIFFUSION_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        arch = get_arch(name)
        mod, want = arch.module, DIFFUSION_LAUNCHES[name]
        is_dit = name == "dit-xl2"

        def cfg_at(res):
            return dataclasses.replace(arch.cfg, img_res=res)

        res_fast, res_big = (arch.cells[c].meta["img_res"] for c in ("gen_fast", "gen_1024"))
        # the weights at gen_1024's resolution (DiT's positions cover its 4096
        # tokens); a cell at a lower one takes its first n_tokens, as its bundle's state is shaped
        params = mod.init(gen, cfg_at(res_big))
        if is_dit:
            perturb_adaln(torch, params, gen)
            print(f"{name}: adaLN-zero weights (ada, final_ada: zero at init) drawn, w N(0, 1/d), b 0.1 N(0, 1)")
        n_params = sum(t.numel() for t in tree_leaves(params))

        def at(tree, res):
            return {**tree, "pos": tree["pos"][:, : cfg_at(res).n_tokens]} if is_dit else tree

        def inputs(b, res, dt):
            lr = res // 8
            lat = torch.randn((b, lr, lr, arch.cfg.latent_ch), generator=gen, device="cuda").to(dt)
            if is_dit:
                cond = torch.randint(0, arch.cfg.num_classes, (b,), generator=gen, device="cuda",
                                     dtype=torch.int32)
            else:
                cond = torch.randn((b, arch.cfg.ctx_len, arch.cfg.ctx_dim), generator=gen, device="cuda").to(dt)
            return lat, cond

        tsteps = torch.tensor([999, 666, 333, 1], dtype=torch.int32, device="cuda")
        c_fast = cfg_at(res_fast)
        p_fast = at(params, res_fast)
        x4, cond4 = inputs(MAX_BATCH, res_fast, torch.float32)
        print(f"{name} ({n_params / 1e6:.1f} M parameters, f32 on the card)")

        # (1) one forward at batch MAX_BATCH at gen_fast's resolution: float32 counted, profiled,
        # recorded and held on its own activations; then bfloat16, counted
        y32, rec32 = counted(f"float32 forward, batch 4, {res_fast}", lambda: mod.apply(p_fast, c_fast, x4, tsteps, cond4),
                             want, profile=True)
        print(f"  SDPA operators in its profile: {rec32.sdpa or 'none'}")
        check(not rec32.sdpa, f"{name}'s forward ran {rec32.sdpa}")
        with held_on_path(torch, SUM_RTOL) as path_rows:
            mod.apply(p_fast, c_fast, x4, tsteps, cond4)
        worst = max(path_rows, key=lambda r: r["limit_share"])
        beyond = sum(not r["within_tol"] for r in path_rows)
        print(f"  on the path's own activations: {len(path_rows)} kernel calls each within TOL (K1: plus "
              f"{SUM_RTOL:.3g} x sum |x w|) of its plain version (largest share of the limit "
              f"{worst['limit_share']:.3f}: {worst['kernel']} {worst['what']}, max_err {worst['max_abs_err']:.3g} "
              f"at max |out| {worst['max_abs_out']:.3g}; K1 calls past TOL x (1 + |y|) alone: {beyond})")
        bparams = tree_map(lambda t: t.to(torch.bfloat16), params)
        bp_fast = at(bparams, res_fast)
        xb4, condb4 = x4.to(torch.bfloat16), cond4 if is_dit else cond4.to(torch.bfloat16)
        _, rec16 = counted(f"bfloat16 forward, batch 4, {res_fast}", lambda: mod.apply(bp_fast, c_fast, xb4, tsteps, condb4),
                           want)

        # (2) image 0 of a float32 forward at DIFFUSION_CPU_RES against the plain versions on the CPU
        c_cpu = cfg_at(DIFFUSION_CPU_RES)
        x_cpu, cond_cpu = inputs(MAX_BATCH, DIFFUSION_CPU_RES, torch.float32)
        y_cpu = mod.apply(at(params, DIFFUSION_CPU_RES), c_cpu, x_cpu, tsteps, cond_cpu)
        t1 = time.perf_counter()
        cparams = tree_map(lambda t: t.cpu(), at(params, DIFFUSION_CPU_RES))
        c0 = mod.apply(cparams, c_cpu, x_cpu[:1].cpu(), tsteps[:1].cpu(), cond_cpu[:1].cpu())
        cpu_s = time.perf_counter() - t1
        del cparams
        with plain_kernels():
            p0 = mod.apply(at(params, DIFFUSION_CPU_RES), c_cpu, x_cpu[:1], tsteps[:1], cond_cpu[:1])
        c_err = (y_cpu[:1].cpu() - c0).abs().max().item()
        c_plain = (p0.cpu() - c0).abs().max().item()
        c_scale = c0.abs().max().item()
        print(f"  image 0 at {DIFFUSION_CPU_RES} vs the plain versions on the CPU ({cpu_s:.1f} s with the host copy): max |diff| "
              f"{c_err:.4g} (max |out| {c_scale:.4g}, limit {DEPTH_RTOL} x that; the plain versions on the card: "
              f"{c_plain:.4g})")
        check(c_err <= DEPTH_RTOL * c_scale, f"{name} drifts from the plain versions on the CPU")
        del y_cpu, p0, c0

        # (3) gen_fast whole: bfloat16, batch 16, 4 DDIM steps
        fast = build(arch, "gen_fast")
        n_fast = arch.cells["gen_fast"].meta["steps"]
        bfast = at(bparams, res_fast)
        check([(tuple(t.shape), t.dtype) for t in tree_leaves(bfast)] == tree_leaves(fast.state),
              "the weights do not match gen_fast's bundle")
        lat16, cond16 = inputs(fast.inputs["latents"][0][0], res_fast, torch.bfloat16)
        fast_b = lat16.shape[0]
        check((tuple(lat16.shape), lat16.dtype) == fast.inputs["latents"]
              and (tuple(cond16.shape), cond16.dtype) == fast.inputs["cond"], "gen_fast's inputs")
        s16, recf = counted(f"gen_fast (bfloat16, batch {lat16.shape[0]}, {n_fast} steps)",
                            lambda: fast.fn(bfast, lat16, cond16), tuple(n_fast * c for c in want))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(2):
            fast.fn(bfast, lat16, cond16)
        torch.cuda.synchronize()
        fast_s = (time.perf_counter() - t1) / 2
        rparams = tree_map(lambda t: t.float(), bfast)
        r16 = fast.fn(rparams, lat16.float(), cond16 if is_dit else cond16.float())
        del rparams
        with plain_kernels():
            pl16 = fast.fn(bfast, lat16, cond16)
        torch.cuda.empty_cache()
        g_err = (s16.float() - r16).abs().max().item()
        g_plain = (pl16.float() - r16).abs().max().item()
        g_scale = r16.abs().max().item()
        g_limit = max(BF16_RTOL * g_scale, 1.25 * g_plain)
        print(f"  gen_fast: {fast_s:.3f} s a call (host clock, 2 runs), {fast_b / fast_s:.2f} latents/s; "
              f"vs the float32 sampler of its bf16-rounded weights: max |diff| {g_err:.4g} (max |latent| "
              f"{g_scale:.4g}; the plain versions in bf16: {g_plain:.4g}; limit {g_limit:.4g} = the larger of "
              f"{BF16_RTOL} x max |latent| and 1.25 x the plain gap)")
        check(g_err <= g_limit, f"{name}'s bfloat16 gen_fast drifts from the float32 sampler")
        del s16, r16, pl16, lat16, cond16

        # (4) gen_1024 with its steps cut: bfloat16, batch 4, latent 128
        meta = arch.cells["gen_1024"].meta
        cut = dataclasses.replace(arch, cells={**arch.cells, "gen_1024": Cell(
            "gen_1024", "gen", {**meta, "steps": GEN_1024_STEPS})})
        big = build(cut, "gen_1024")
        print(f"  gen_1024: steps cut from {meta['steps']} to {GEN_1024_STEPS} (every step runs the same shapes)")
        bbig = at(bparams, res_big)
        check([(tuple(t.shape), t.dtype) for t in tree_leaves(bbig)] == tree_leaves(big.state),
              "the weights do not match gen_1024's bundle")
        lat4, condb = inputs(big.inputs["latents"][0][0], meta["img_res"], torch.bfloat16)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s1024, rec1024 = counted(f"gen_1024 (bfloat16, batch {lat4.shape[0]}, {GEN_1024_STEPS} steps)",
                                 lambda: big.fn(bbig, lat4, condb), tuple(GEN_1024_STEPS * c for c in want))
        big_s = time.perf_counter() - t1
        with held_on_path(torch, SUM_RTOL) as big_rows:
            h1024 = big.fn(bbig, lat4, condb)
        big_worst = max(big_rows, key=lambda r: r["limit_share"])
        print(f"  gen_1024: {big_s:.3f} s for {GEN_1024_STEPS} steps (host clock, the first call), "
              f"{lat4.shape[0] / big_s:.3f} latents/s at {GEN_1024_STEPS} steps; {len(big_rows)} kernel calls "
              f"held on their own activations (largest share of the limit {big_worst['limit_share']:.3f}: "
              f"{big_worst['kernel']} "
              f"{big_worst['what']}, max_err {big_worst['max_abs_err']:.3g} at max |out| "
              f"{big_worst['max_abs_out']:.3g}); the held run's latents equal the first's: "
              f"{bool(torch.equal(h1024, s1024))}")
        del s1024, h1024, lat4, condb

        # (5) K1 and K3 at every call signature of those runs; batch 4 float32 timed
        held = 0
        for path, rec, timed, n_steps in (("b4-float32", rec32, True, 1), ("b4-bfloat16", rec16, False, 1),
                                          ("gen_fast", recf, False, n_fast),
                                          ("gen_1024", rec1024, False, GEN_1024_STEPS)):
            for sig, calls in sorted(rec.convs.items(), key=str):
                conv_rows.append(dict(hold_conv(torch, F, gen, sig, timed, device_times=timed), arch=name,
                                      path=path, per_forward=calls // n_steps))
                held += 1
            for (shape, s, dname), calls in sorted(rec.attns.items(), key=str):
                bq, hq, tq, dq = shape
                row = (hold_vit_attention(torch, F, gen, bq, hq, tq, dq, dname, timed) if is_dit
                       else hold_diffusion_attention(torch, F, gen, (shape, s, dname), timed))
                attn_rows.append(dict(row, arch=name, path=path, per_forward=calls // n_steps))
        for r in (r for r in conv_rows if r["arch"] == name and r["path"] == "b4-float32"):
            print(f"  conv {r['shape']} k{r['k']} s{r['stride']} p{r['pad']}{' bias' if r['bias'] else ''} "
                  f"x{r['per_forward']}/fwd S={r['splits']} {r['gather']}: max_err {r['max_abs_err']:.3g} kernel "
                  f"{r['ms']:.4f} ms ({r['device_us']:.2f} us, {r['device_source']}) plain {r['plain_ms']:.4f} "
                  f"F.conv2d {r['library_ms']:.4f} ({r['library_device_us']:.2f} us, {r['library_device_source']}) "
                  f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
        for r in (r for r in attn_rows if r["arch"] == name and "ms" in r):
            print(f"  attn B{r['b']} H{r['h']} T{r['t']} S{r['s']} D{r['d']} x{r['per_forward']}/fwd [{r['block']}]: "
                  f"max_err {r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms ({r['device_us']:.2f} us, "
                  f"{r['device_source']}) plain {r['plain_ms']:.4f} SDPA {r['library_ms']:.4f} "
                  f"({r['library_device_us']:.2f} us, {r['library_device_source']}; {r['library_backend']}) bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']})")
        mine = [r for r in conv_rows + attn_rows if r["arch"] == name]
        print(f"  held {held} K1 signatures and {len(mine) - held} K3 (max_err float32 "
              f"{max([r['max_abs_err'] for r in mine if r['dtype'] == 'float32'], default=0):.3g}, bfloat16 "
              f"{max([r['max_abs_err'] for r in mine if r['dtype'] == 'bfloat16'], default=0):.3g})")

        # (6) where the time goes: steady forwards at batch 4 at gen_fast's resolution
        f_ms, f_busy, f_top, f_fams = steady_and_profiled(
            torch, lambda: mod.apply(p_fast, c_fast, x4, tsteps, cond4), f"{name} float32")
        h_ms, h_busy, h_top, h_fams = steady_and_profiled(
            torch, lambda: mod.apply(bp_fast, c_fast, xb4, tsteps, condb4), f"{name} bfloat16")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        arch_s = time.perf_counter() - t0
        print(f"  {name}: {arch_s:.1f} s, peak device memory allocated {peak_gb:.2f} GB")
        report[name] = dict(
            n_params=n_params, launches_per_forward=want, sdpa_ops=rec32.sdpa, path_holds=len(path_rows),
            path_worst=worst, cpu_max_abs=c_err, cpu_max_abs_out=c_scale, cpu_plain_on_card_max_abs=c_plain,
            cpu_s=cpu_s, gen_fast=dict(s_per_call=fast_s, latents_per_s=fast_b / fast_s, batch=fast_b, steps=n_fast,
                                       max_abs=g_err, plain_max_abs=g_plain, max_abs_latent=g_scale,
                                       limit=g_limit),
            gen_1024=dict(steps=GEN_1024_STEPS, steps_uncut=meta["steps"], s_first_call=big_s,
                          path_holds=len(big_rows), path_worst=big_worst),
            float32=dict(steady_ms=f_ms, device_busy_ms=f_busy, top_device=f_top, device_ms_by_kernel=f_fams),
            bfloat16=dict(steady_ms=h_ms, device_busy_ms=h_busy, top_device=h_top, device_ms_by_kernel=h_fams),
            peak_device_gb=peak_gb, phase_s=arch_s)
        del params, bparams, p_fast, bp_fast, bfast, bbig, x4, xb4, cond4, condb4, y32
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - phase_t0
    print(f"  phase 14: {phase_s:.1f} s")
    report["phase_s"] = phase_s
    return report, launches, conv_rows, attn_rows


# Phase 15: vision training through configs.steps' cls_224 and cls_384
# cells, each model rematerialised as JAX runs it (ViT-L/16: every block;
# Swin-B: the (regular, shifted) pairs of its depth-18 stage; ConvNeXt-B:
# the blocks of its depth-27 stage; EfficientNet-B7: none).  (a) and (b) at
# TRAIN_CHECK_BATCH images in float32 at cls_224, remat on against off; at
# cls_384 the K1 and K3 signatures of a float32 step at TRAIN_CHECK_BATCH
# held as in (a); (c) TRAIN_STEPS timed bfloat16 steps of each cell at its
# batch, or the largest power of two whose peak memory up to the AdamW
# update (``split_peaks``: AdamW's float32 temporaries, which once set the
# probes' whole-step peak and sent the fit past the card, are not in it),
# fitted from two probe steps at TRAIN_PROBE_BATCHES[cell] plus the
# trainer's entry state, stays under TRAIN_MEM_SHARE of the card, the fit's
# prediction printed beside the peak measured at that batch; at cls_224
# every K1 and K3 signature of one step at that batch held in bfloat16; (d)
# ViT-L/16 cut to FAULT_LAYERS layers, FAULT_STEPS steps checkpointed every
# FAULT_EVERY, faults injected at FAULT_AT.
TRAIN_ARCHS = ("vit-l16", "swin-b", "convnext-b", "efficientnet-b7")
TRAIN_CELLS = ("cls_224", "cls_384")
TRAIN_CHECK_BATCH, TRAIN_STEPS, TRAIN_MEM_SHARE = 4, 4, 0.8
TRAIN_PROBE_BATCHES = {"cls_224": (32, 64), "cls_384": (16, 32),
                       ("efficientnet-b7", "cls_384"): (8, 16)}  # 2.1 GB an image: 32 would not fit
# the K1 (of them depthwise) and K3 launches remat adds to a train step: the
# checkpointed blocks' second forward, in the backward
REMAT_LAUNCHES = {"vit-l16": (0, 0, 24), "swin-b": (0, 0, 0), "convnext-b": (27, 27, 0),
                  "efficientnet-b7": (0, 0, 0)}
# the predicted and the measured peak at the fitted batch may part by this share
FIT_RTOL = 0.1
FAULT_LAYERS, FAULT_STEPS, FAULT_EVERY, FAULT_AT = 4, 12, 4, (5, 9)
# (b)'s holds, leaf by leaf: each new first moment (the clipped gradient /
# 10) and each update against the plain versions' step, relative to that
# leaf's largest |moment| or |update| there, within TRAIN_LEAF_RTOL.  A leaf
# whose largest |moment| is under TRAIN_BLIND of the tree's is one the loss
# does not see (a shift ahead of a batch-statistics norm: rounding noise in
# both, no scale of its own) and is held at the tree's largest |moment|.
# The control, the same step with one K1 call's output gradient scaled by
# TRAIN_CONTROL, must break the first moments' limit (an update also holds
# the weight decay, the same in both, which may dilute the change).
TRAIN_LEAF_RTOL, TRAIN_BLIND, TRAIN_CONTROL = 1e-2, 1e-5, 1.05
# the backward's record_function ranges (kernels.conv2d.ops.conv2d_backward,
# kernels.attention.ops.FlashAttentionFunction)
BACKWARD_RANGES = ("K1 dgrad", "conv dgrad (library)", "conv wgrad (library)", "K3 backward")


def with_batch(arch, batch: int, cell: str = "cls_224"):
    """``arch`` with its ``cell`` at ``batch`` (images, latents or
    sequences)."""
    key = "global_batch" if "global_batch" in arch.cells[cell].meta else "batch"
    return resized(arch, cell, **{key: batch})


def resized(arch, cell: str, **meta):
    """``arch`` with these entries of its ``cell``'s meta replaced."""
    from repro_torch.configs.base import Cell

    c = arch.cells[cell]
    return dataclasses.replace(arch, cells={**arch.cells, cell: Cell(c.name, c.kind, {**c.meta, **meta})})


def cell_trainer(torch, arch, fault_cfg, cell: str = "cls_224", state=None, **kw):
    """(trainer, initial state) of ``arch``'s ``cell`` on the card, as
    ``runtime.train.make_trainer`` builds them for a registered arch (state
    from seed 0 unless ``state`` is given, the cell's stream: images,
    tokens or latents); ``kw`` goes to the trainer."""
    from repro_torch.configs.steps import build, realize
    from repro_torch.data.pipeline import device_batch
    from repro_torch.runtime import FaultTolerantTrainer
    from repro_torch.runtime.train import _stream_for

    bundle = build(arch, cell)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if state is None:
        state, _ = realize(arch, bundle, gen)
    stream = _stream_for(bundle)

    def step_fn(state, **batch):
        return bundle.fn(state, **device_batch(batch, gen.device))

    return FaultTolerantTrainer(step_fn, stream, fault_cfg, **kw), state


def named_leaves(tree, name: str = "") -> list:
    """(path, tensor) of every leaf of a tree, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in named_leaves(v, f"{name}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in named_leaves(v, f"{name}/{i}")]
    return [(name, tree)]


def leaf_shares(new, ref, old) -> dict:
    """Leaf by leaf, ``new``'s train state against ``ref``'s, both one step
    from ``old``: the largest |difference| of each first moment over that
    leaf's largest |moment| in ``ref`` (the tree's, for a leaf under
    TRAIN_BLIND of it), and of each update over its largest |update|.
    Returns the worst of each with its leaf, and the blind leaves."""
    from repro_torch.models.common import tree_leaves

    mus, ref_mus = named_leaves(new[1]["mu"]), named_leaves(ref[1]["mu"])
    tree_mu = max(t.abs().max().item() for _, t in ref_mus)
    out = dict(mu=(0.0, ""), update=(0.0, ""), blind=[])
    for (name, mu), (_, rmu), a, r, o in zip(mus, ref_mus, tree_leaves(new[0]), tree_leaves(ref[0]),
                                             tree_leaves(old[0])):
        scale = rmu.abs().max().item()
        if scale < TRAIN_BLIND * tree_mu:
            out["blind"].append(name)
            scale = tree_mu
        share = (mu - rmu).abs().max().item() / max(scale, 1e-30)
        u, ru = (a - o).float(), (r - o).float()
        u_share = (u - ru).abs().max().item() / max(ru.abs().max().item(), 1e-30)
        out["mu"] = max(out["mu"], (share, name))
        out["update"] = max(out["update"], (u_share, name))
    return out


def warm_state(torch, state, gen):
    """A train state past warmup, for holding one step against another: every
    bias and norm shift ``b`` 0.1 N(0, 1) and every norm ``scale`` 1 + 0.1
    N(0, 1) (the init's zeros and ones would leave those paths untested),
    the step and AdamW's count at 1000 (learning-rate scale 1, bias
    corrections ~1), every second moment 1e-4: so Adam's normalisation does
    not blow a gradient's rounding noise (a key bias the softmax ignores, a
    shift ahead of a batch-statistics norm) up to a whole step."""
    params, opt, n = state

    def perturb(tree, name=""):
        if isinstance(tree, dict):
            return {k: perturb(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [perturb(v, name) for v in tree]
        if name not in ("b", "scale"):  # (a stacked stack's are [layers, d])
            return tree
        noise = 0.1 * torch.randn(tree.shape, generator=gen, device=gen.device)
        return (noise + (1.0 if name == "scale" else 0.0)).to(tree.dtype)

    from repro_torch.models.common import tree_map

    nu = tree_map(lambda t: torch.full_like(t, 1e-4), opt["nu"])
    return perturb(params), dict(opt, nu=nu, count=torch.full_like(opt["count"], 1000)), torch.full_like(n, 1000)


@contextlib.contextmanager
def recording_train_calls():
    """Records every K1 and K3 call the vision models make while entered, by
    signature: K1 ``hold_conv``'s and whether its input requires grad (the
    images do not), K3 q's shape, the key count, dtype and causal; apart,
    the calls a checkpoint's recompute makes in the backward
    (``recomputed``, ``recomputed_attns``), and the forward's K1 calls in
    order (``order``)."""
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_cuda

    import torch

    rec = types.SimpleNamespace(convs=Counter(), attns=Counter(), recomputed=Counter(), recomputed_attns=Counter(),
                                order=[])

    def conv(x, w, b=None, *, stride=1, padding=1, groups=1):
        sig = (tuple(x.shape), tuple(w.shape), stride, padding, groups, b is not None,
               str(x.dtype).removeprefix("torch."), x.requires_grad)
        rec.convs[sig] += 1
        if in_backward(torch):
            rec.recomputed[sig] += 1
        else:
            rec.order.append(sig)
        return conv2d_cuda(x, w, b, stride=stride, padding=padding, groups=groups)

    def attn(q, k, v, *, causal=True):
        sig = (tuple(q.shape), k.shape[2], str(q.dtype).removeprefix("torch."), causal)
        rec.attns[sig] += 1
        if in_backward(torch):
            rec.recomputed_attns[sig] += 1
        return flash_attention(q, k, v, causal=causal)

    with model_kernels(conv, attn):
        yield rec


def in_backward(torch) -> bool:
    """Whether autograd is running a backward pass: a checkpointed block's
    recompute runs inside one."""
    return torch._C._current_graph_task_id() != -1


def k1_dgrads(rec) -> int:
    """K1 backward launches a step of these convs makes: one for each stride-1
    conv whose input needs a gradient (``conv2d_backward``), a recomputed
    conv's once (its backward runs on the recompute's graph)."""
    return sum(c - rec.recomputed[sig] for sig, c in rec.convs.items()
               if sig[-1] and sig[2] == 1 and sig[3] <= sig[1][0] - 1)


def hold_conv_grad(torch, gen, sig: tuple) -> dict:
    """K1 and its autograd Function on the generator's device, in the
    signature's dtype, against its plain version and autograd through it in
    float32 on the same values: the output and dx (where the input needs
    one), dW, db within TOL x (1 + |g|) plus ``SUM_RTOL`` x the same function
    of the operands' absolute values (large sums cancel); fatal beyond.  (In
    bfloat16 the plain version's own autograd rounds each tap's share of dx
    to bfloat16 and sums them so: its reading is kept as ``plain_share``.)
    The launch counts are left as they were."""
    from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref

    counts = conv2d_cuda.launches, conv2d_cuda.depthwise_launches, conv2d_cuda.backward_launches
    (n, h, w, cin), (k, _, w_cin, cout), st, pad, groups, has_bias, dname, x_grad = sig
    dt, dev = getattr(torch, dname), gen.device
    x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(dt)
    wt = (math.sqrt(2.0 / (k * k * w_cin)) * torch.randn((k, k, w_cin, cout), generator=gen, device=dev)).to(dt)
    b = (0.1 * torch.randn((cout,), generator=gen, device=dev)).to(dt) if has_bias else None
    kw = dict(stride=st, padding=pad, groups=groups)
    names = ["y"] + (["dx"] if x_grad else []) + ["dw"] + (["db"] if has_bias else [])
    dy = torch.randn((n, (h + 2 * pad - k) // st + 1, (w + 2 * pad - k) // st + 1, cout), generator=gen,
                     device=dev).to(dt)

    def outputs(fn, x, w, b, dy):
        leaves = [x.clone().requires_grad_(x_grad), w.clone().requires_grad_(),
                  None if b is None else b.clone().requires_grad_()]
        asked = [t for t, nm in zip(leaves, ("dx", "dw", "db")) if nm in names]
        y = fn(*leaves, **kw)
        return [t.float() for t in (y.detach(), *torch.autograd.grad(y, asked, dy))]

    up = [None if t is None else t.float() for t in (x, wt, b, dy)]
    got = outputs(conv2d_cuda, x, wt, b, dy)
    want = outputs(conv2d_ref, *up)
    sums = outputs(conv2d_ref, *(None if t is None else t.abs() for t in up))
    plain = want if dname == "float32" else outputs(conv2d_ref, x, wt, b, dy)
    torch.cuda.synchronize()
    row = dict(shape=[n, h, w, cin, cout], k=k, stride=st, pad=pad, groups=groups, bias=has_bias, dtype=dname,
               x_grad=x_grad, k1_dgrad=x_grad and st == 1 and pad <= k - 1)
    for nm, g, r, s, p in zip(names, got, want, sums, plain):
        limit = TOL[dname] * (1 + r.abs()) + SUM_RTOL * s
        diff = (g - r).abs()
        share = (diff / limit).max().item()
        row[nm] = dict(max_abs_err=diff.max().item(), max_abs=r.abs().max().item(), limit_share=share,
                       plain_share=((p - r).abs() / limit).max().item())
        check(share <= 1.0 and bool(torch.isfinite(g).all()), f"K1's {nm} disagrees with the plain version's "
                                                            f"at {row}")
    conv2d_cuda.launches, conv2d_cuda.depthwise_launches, conv2d_cuda.backward_launches = counts
    return row


def hold_attention_grad(torch, gen, b: int, h: int, t: int, d: int, dname: str = "float32") -> dict:
    """K3's autograd Function in ``dname`` against autograd through its plain
    version in float32 on the same values, at ViT's layout (q, k, v slices
    of one [B, T, 3, H, D] projection), not causal: dq, dk, dv within TOL x
    (1 + |g|); fatal beyond.  In float32 also the device us of K3's forward
    and of its backward (``attention_backward``) a call.  The count is left
    as it was."""
    from repro_torch.kernels.attention import attention_ref, flash_attention
    from repro_torch.kernels.attention.ops import attention_backward

    count = flash_attention.launches
    dt = getattr(torch, dname)
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device=gen.device).to(dt)
    do = torch.randn((b, h, t, d), generator=gen, device=gen.device).to(dt)

    def grads(fn, qkv, do):
        leaf = qkv.clone().requires_grad_()
        q, k, v = (leaf[:, :, i].transpose(1, 2) for i in range(3))
        return torch.autograd.grad(fn(q, k, v, causal=False), leaf, do)[0].float()

    got, want = grads(flash_attention, qkv, do), grads(attention_ref, qkv.float(), do.float())
    diff = (got - want).abs()
    share = (diff / (TOL[dname] * (1 + want.abs()))).max().item()
    row = dict(b=b, h=h, t=t, d=d, dtype=dname, max_abs_err=diff.max().item(), max_abs=want.abs().max().item(),
               limit_share=share)
    check(share <= 1.0, f"K3's gradients disagree with the plain version's autograd at {row}")
    if dname == "float32":
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = flash_attention(q, k, v, causal=False)
        row["forward_device_us"], row["forward_source"] = device_or_event_us(
            torch, lambda: flash_attention(q, k, v, causal=False), reps=10)
        row["backward_device_us"], row["backward_source"] = device_or_event_us(
            torch, lambda: attention_backward(q, k, v, o, do, False), reps=5)
    flash_attention.launches = count
    return row


def step_breakdown(torch, step) -> tuple[float, dict]:
    """One call of ``step`` under the profiler (``profiled``): (device busy
    ms, device ms by part).  The backward's ranges (``BACKWARD_RANGES``)
    take every kernel launched inside them; the kernels outside go to "K1
    forward" (K1's families), "K3" (its forward), "GEMM" or "other"."""
    prof, by_kernel = profiled(torch, step)
    parts = {name: 0.0 for name in ("K1 forward", *BACKWARD_RANGES, "K3", "GEMM", "other")}

    def kernels(ev):
        return list(ev.kernels) + [kn for ch in ev.cpu_children for kn in kernels(ch)]

    inside = Counter()
    for ev in prof.events():
        if ev.name in BACKWARD_RANGES and ev.device_type == torch.autograd.DeviceType.CPU:
            for kn in kernels(ev):
                parts[ev.name] += kn.duration / 1e3
                inside[kn.name] += kn.duration / 1e3
    for a in by_kernel:
        if a.key in BACKWARD_RANGES:
            continue  # the device-side spans of the ranges
        fam = kernel_family(a.key)
        part = "K1 forward" if fam.startswith("K1") else fam if fam in ("K3", "GEMM (cuBLAS)") else "other"
        parts["GEMM" if part == "GEMM (cuBLAS)" else part] += a.self_device_time_total / 1e3 - inside[a.key]
    return sum(parts.values()), parts


def phase_train(torch) -> tuple[dict, dict]:
    """Phase 15: training of ViT-L/16, Swin-B, ConvNeXt-B and EfficientNet-B7
    through ``configs.steps``' cls_224 and cls_384 cells (random weights
    from seeds) on the card, remat as JAX has it: (a) K1's and K3's
    autograd Functions held against autograd through their plain versions
    at every K1 and K3 signature of one batch-4 float32 step of each cell;
    (b) one full-width float32 step of each at cls_224 and batch 4 held
    against the same step through the plain versions (the loss; each leaf's
    first moment and update), a control step with one wrong gradient
    breaking that hold, the step with remat off bit-identical, its launches
    counted (the forward's and the recompute's); (c) TRAIN_STEPS bfloat16
    steps of each cell through the fault-tolerant trainer, timed, their
    FLOP/s fed to a ``ComputeRateEstimator`` by the trainer's
    ``compute_observer``, one step profiled by part, at cls_224 its K1 and
    K3 signatures held as in (a) in bfloat16; (d) a fault-injected run of
    ViT-L/16 (FAULT_LAYERS layers) equal bit for bit to an uninterrupted
    one.  Returns the report and the launches of its counted runs."""
    import tempfile

    from repro_torch.configs import get as get_arch
    from repro_torch.configs.steps import build, realize
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime import FaultConfig, InjectedFault

    phase_t0 = time.perf_counter()
    smi = nvidia_smi()
    print(f"phase 15 on {smi}: vision training at {', '.join(TRAIN_CELLS)}")
    gen = torch.Generator(device="cuda").manual_seed(15)
    dev = gen.device
    launches = {"conv2d": 0, "conv2d_backward": 0, "flash_attention": 0}
    report: dict = {"card": smi}

    def zero():
        conv2d_cuda.launches = conv2d_cuda.depthwise_launches = conv2d_cuda.backward_launches = 0
        flash_attention.launches = 0

    def read() -> tuple[int, int, int, int]:
        got = (conv2d_cuda.launches, conv2d_cuda.depthwise_launches, conv2d_cuda.backward_launches,
               flash_attention.launches)
        launches["conv2d"] += got[0]
        launches["conv2d_backward"] += got[2]
        launches["flash_attention"] += got[3]
        return got

    apply_scaled = scaled_grad(torch)

    for name in TRAIN_ARCHS:
        t0 = time.perf_counter()
        arch = get_arch(name)
        rep = report[name] = {}
        fwd, extra = VISION_LAUNCHES[name], REMAT_LAUNCHES[name]
        per_step = tuple(a + b for a, b in zip(fwd, extra))  # K1, K1 depthwise, K3 a train step

        # (b) one float32 step at batch 4 through the kernels, counted and recorded
        bundle = build(arch, "cls_224", dtype=torch.float32)
        state, _ = realize(arch, bundle, gen)
        state = warm_state(torch, state, gen)
        b, res = TRAIN_CHECK_BATCH, arch.cells["cls_224"].meta["img_res"]
        images = torch.randn((b, res, res, 3), generator=gen, device=dev)
        labels = torch.randint(0, arch.cfg.num_classes, (b,), generator=gen, device=dev).to(torch.int32)
        zero()
        with recording_train_calls() as rec:
            new, metrics = bundle.fn(state, images=images, labels=labels)
            torch.cuda.synchronize()
        got = read()
        want = step_launches(rec)
        print(f"{name} float32 step at batch {b} (cls_224, {res} x {res}): K1 launches {got[0]} (depthwise {got[1]}) "
              f"forward and recompute, {got[2]} backward; K3 {got[3]}; expected {want}; of them recomputed under "
              f"remat: K1 {sum(rec.recomputed.values())}, K3 {sum(rec.recomputed_attns.values())}")
        check(got == want and (got[0], got[1], got[3]) == per_step,
              f"{name}'s step launched {got}, expected {want} (phase 13's forward {fwd} plus remat's {extra})")
        check((sum(rec.recomputed.values()), sum(rec.recomputed_attns.values())) == (extra[0], extra[2]),
              f"{name}'s step recomputed K1 {sum(rec.recomputed.values())} and K3 "
              f"{sum(rec.recomputed_attns.values())} times, expected {extra[0]} and {extra[2]}")
        # (a K1 dgrad wherever a conv's input needs a gradient: not ViT's and
        # Swin's one conv, on the images)
        check(got[0] > 0 and (got[3] > 0 or name != "vit-l16") and (got[2] > 0 or fwd[0] == 1),
              f"{name}'s step left a kernel of its path unlaunched: {got}")
        zero()
        with plain_kernels():
            plain, pmetrics = bundle.fn(state, images=images, labels=labels)
            torch.cuda.synchronize()
        check(read() == (0, 0, 0, 0), "the plain step launched a kernel")
        # the control: the output gradient of one K1 call scaled, the middle
        # of the forward's calls that no checkpoint recomputes (a scaled
        # output inside a checkpoint is dropped with its graph)
        calls, pick = [0], control_pick(rec)

        def control_conv(*args, **kw):
            y = conv2d_cuda(*args, **kw)
            if in_backward(torch):
                return y
            calls[0] += 1
            return apply_scaled(y) if calls[0] - 1 == pick else y

        with model_kernels(control_conv, flash_attention):
            control, _ = bundle.fn(state, images=images, labels=labels)
            torch.cuda.synchronize()
        read()
        loss, ploss = metrics["loss"].item(), pmetrics["loss"].item()
        shares, ctl = leaf_shares(new, plain, state), leaf_shares(control, plain, state)
        moved = max((a - o).abs().max().item() for a, o in zip(tree_leaves(new[0]), tree_leaves(state[0])))
        print(f"  vs the plain versions' step: loss {loss:.7g} / {ploss:.7g}; leaf by leaf, largest |diff| of a "
              f"first moment {shares['mu'][0]:.3g} of its leaf's largest ({shares['mu'][1]}), of an update "
              f"{shares['update'][0]:.3g} ({shares['update'][1]}); limit {TRAIN_LEAF_RTOL}; "
              f"{len(shares['blind'])} blind leaves held at the tree's largest |moment| {shares['blind'][:4]}; "
              f"largest |update| {moved:.3g}")
        print(f"  the control (K1 call {pick} of the forward's {calls[0]}, output gradient x {TRAIN_CONTROL}): "
              f"first moment {ctl['mu'][0]:.3g} ({ctl['mu'][1]}), update {ctl['update'][0]:.3g} ({ctl['update'][1]})")
        check(abs(loss - ploss) <= DEPTH_RTOL * abs(ploss) and shares["mu"][0] <= TRAIN_LEAF_RTOL
              and shares["update"][0] <= TRAIN_LEAF_RTOL, f"{name}'s float32 step drifts from the plain versions' step")
        check(ctl["mu"][0] > TRAIN_LEAF_RTOL,
              f"{name}: the control step with one wrong gradient passes the hold: it tests nothing")
        check(moved > 0, f"{name}'s step left the parameters where they were: the holds test nothing")
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(new)), f"{name}: non-finite state")
        del plain, control, pmetrics
        if getattr(arch.cfg, "remat", False):
            # the same step with remat off: bit for bit, the forward's launches only
            off = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, remat=False))
            zero()
            unremat = build(off, "cls_224", dtype=torch.float32).fn(state, images=images, labels=labels)
            torch.cuda.synchronize()
            got_off = read()
            same = same_step(torch, f"{name} remat on against off", (new, metrics), unremat, state)
            print(f"  remat off: K1 {got_off[0]} (depthwise {got_off[1]}) forward, {got_off[2]} backward; K3 "
                  f"{got_off[3]} (phase 13's forward {fwd})")
            check(same["bit_identical"], f"{name}: the step with remat on is not bit-identical to remat off")
            check(got_off == (fwd[0], fwd[1], got[2], fwd[2]), f"{name}'s step with remat off launched {got_off}")
            rep["remat"] = dict(same, launches_off=dict(zip(("k1", "k1_depthwise", "k1_backward", "k3"), got_off)))
            del unremat
        zero()
        bwd_ms, bwd_parts = step_breakdown(torch, lambda: bundle.fn(state, images=images, labels=labels))
        read()
        print("  one profiled float32 step, device ms by part: "
              + "; ".join(f"{k} {v:.3f}" for k, v in bwd_parts.items()) + f" (busy {bwd_ms:.3f})")
        rep["float32_step"] = dict(batch=b, launches=dict(zip(("k1", "k1_depthwise", "k1_backward", "k3"), got)),
                                   recomputed=dict(k1=sum(rec.recomputed.values()),
                                                   k3=sum(rec.recomputed_attns.values())),
                                   loss=loss, plain_loss=ploss, mu_share=shares["mu"], update_share=shares["update"],
                                   blind_leaves=shares["blind"], limit=TRAIN_LEAF_RTOL,
                                   control=dict(scale=TRAIN_CONTROL, call=pick, mu_share=ctl["mu"],
                                                update_share=ctl["update"]),
                                   max_abs_update=moved, device_busy_ms=bwd_ms, device_ms_by_part=bwd_parts)
        del new, metrics, state, images, labels

        print(f"  {name} float32 steps: {time.perf_counter() - t0:.1f} s")

        # (a) the Functions' gradients at every K1 and K3 signature of that step
        t1 = time.perf_counter()
        rows, attn_rows = hold_train_signatures(torch, gen, rec, "float32")
        rep["k1_grad_rows"], rep["k3_grad_rows"] = rows, attn_rows
        if attn_rows:
            rep["k3_grad"] = attn_rows[0]
        print(f"  {name} float32 holds: {time.perf_counter() - t1:.1f} s")

        for cell in TRAIN_CELLS:
            t1 = time.perf_counter()
            if cell != "cls_224":
                rep[cell] = dict(float32_step=vision_f32_signatures(torch, gen, arch, cell, read, zero, per_step))
            rep.setdefault(cell, {}).update(vision_bf16(torch, gen, arch, cell, read, zero, want,
                                                        hold=cell == "cls_224"))
            rep[cell]["s"] = time.perf_counter() - t1
            print(f"  {name} {cell}: {rep[cell]['s']:.1f} s")
        rep["phase_s"] = time.perf_counter() - t0
        print(f"  {name}: {rep['phase_s']:.1f} s")

    # (d) fault tolerance: faults at FAULT_AT against an uninterrupted run
    t0 = time.perf_counter()
    vit = get_arch("vit-l16")
    cut = dataclasses.replace(vit, cfg=dataclasses.replace(vit.cfg, n_layers=FAULT_LAYERS))
    fired = set()

    def hook(i):
        if i in FAULT_AT and i not in fired:
            fired.add(i)
            raise InjectedFault(f"injected at step {i}")

    with tempfile.TemporaryDirectory() as d:
        runs = []
        for label, fault_hook in (("uninterrupted", None), ("faulted", hook)):
            trainer, state = cell_trainer(torch, cut, FaultConfig(ckpt_dir=f"{d}/{label}", ckpt_every=FAULT_EVERY),
                                           fault_hook=fault_hook)
            zero()
            state, stats = trainer.run(state, FAULT_STEPS, resume=False)
            got = read()
            runs.append((state, stats))
            print(f"  {label} run: {stats.steps} steps, {stats.failures} failures, {stats.restores} restores; "
                  f"K1 {got[0]} forward / {got[2]} backward, K3 {got[3]} (forward and recompute)")
        (ref, ref_stats), (faulted, stats) = runs
        batch = vit.cells["cls_224"].meta["batch"]
        equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(ref), tree_leaves(faulted)))
        print(f"ViT-L/16 at full width cut to {FAULT_LAYERS} of its {vit.cfg.n_layers} layers, bf16, batch "
              f"{batch}: {FAULT_STEPS} steps checkpointed every {FAULT_EVERY}, faults injected at {FAULT_AT}: "
              f"final state bit-identical to the uninterrupted run's: {equal}; losses equal: "
              f"{stats.losses == ref_stats.losses}")
        check(stats.failures == len(FAULT_AT) and stats.restores == len(FAULT_AT),
              f"the faulted run counted {stats.failures} failures and {stats.restores} restores, "
              f"expected {len(FAULT_AT)} each (a kernel failure must not pass as a recovered fault)")
        check(equal and stats.losses == ref_stats.losses and int(faulted[2]) == FAULT_STEPS,
              "the fault-injected run does not replay to the uninterrupted run's state")
        report["fault"] = dict(layers=FAULT_LAYERS, batch=batch, steps=FAULT_STEPS, ckpt_every=FAULT_EVERY,
                               faults_at=list(FAULT_AT), failures=stats.failures, restores=stats.restores,
                               bit_identical=equal, s=time.perf_counter() - t0)
        del runs, ref, faulted, state, trainer
    phase_s = time.perf_counter() - phase_t0
    print(f"  phase 15: {phase_s:.1f} s")
    report["phase_s"] = phase_s
    return report, launches


def step_launches(rec) -> tuple[int, int, int, int]:
    """The launches a recorded train step makes: K1 (forward and recompute),
    of them depthwise, K1's backward ones (``k1_dgrads``) and K3 (forward
    and recompute)."""
    return (sum(rec.convs.values()), sum(c for sig, c in rec.convs.items() if sig[4] > 1), k1_dgrads(rec),
            sum(rec.attns.values()))


def control_pick(rec) -> int:
    """The index, among a recorded step's forward K1 calls (in order), of
    the middle one whose signature no checkpoint recomputes, a dense one
    where there is one (ConvNeXt's depthwise outputs reach the loss through
    a layer scale of 1e-6: a change there hides under the hold's limit)."""
    free = [i for i, sig in enumerate(rec.order) if sig not in rec.recomputed]
    dense = [i for i in free if rec.order[i][4] == 1]
    check(bool(free), "every K1 call of the step is recomputed: the control has no call to scale")
    return (dense or free)[len(dense or free) // 2]


def hold_train_signatures(torch, gen, rec, dname: str) -> tuple[list, list]:
    """K1's and K3's Functions held (``hold_conv_grad``, ``hold_attention_grad``)
    at every signature a recorded step made, in ``dname``, and printed;
    returns (K1 rows, K3 rows), each with its calls a step."""
    rows = [dict(hold_conv_grad(torch, gen, sig), per_step=c) for sig, c in sorted(rec.convs.items(), key=str)]
    print_conv_holds(rows, dname)
    attn_rows = []
    for (shape, s, _, causal), c in sorted(rec.attns.items()):
        row = dict(hold_attention_grad(torch, gen, *shape, dname), per_step=c)
        attn_rows.append(row)
        times = (f"; K3 forward {row['forward_device_us']:.2f} us, its plain backward "
                 f"{row['backward_device_us']:.2f} us a call" if "forward_device_us" in row else "")
        print(f"  K3's Function held in {dname} at {list(shape)}: max_err {row['max_abs_err']:.3g} (share "
              f"{row['limit_share']:.3g}){times}, x{c} a step")
    return rows, attn_rows


def vision_f32_signatures(torch, gen, arch, cell: str, read, zero, per_step: tuple) -> dict:
    """One float32 step of ``cell`` at TRAIN_CHECK_BATCH through the kernels,
    its launches counted (``per_step``: K1, depthwise, K3), then K1's and
    K3's Functions held at each of its signatures (``hold_train_signatures``)."""
    from repro_torch.configs.steps import build, realize
    from repro_torch.models.common import tree_leaves

    bundle = build(arch, cell, dtype=torch.float32)
    state, _ = realize(arch, bundle, gen)
    b, res = TRAIN_CHECK_BATCH, arch.cells[cell].meta["img_res"]
    images = torch.randn((b, res, res, 3), generator=gen, device=gen.device)
    labels = torch.randint(0, arch.cfg.num_classes, (b,), generator=gen, device=gen.device).to(torch.int32)
    zero()
    with recording_train_calls() as rec:
        new, metrics = bundle.fn(state, images=images, labels=labels)
        torch.cuda.synchronize()
    got, want = read(), step_launches(rec)
    loss = metrics["loss"].item()
    print(f"{arch.name} float32 step at batch {b} ({cell}, {res} x {res}): K1 launches {got[0]} (depthwise "
          f"{got[1]}), {got[2]} backward; K3 {got[3]}; expected {want}; loss {loss:.6g}")
    check(got == want and (got[0], got[1], got[3]) == per_step, f"{arch.name} {cell}: the step launched {got}")
    check(math.isfinite(loss) and all(bool(torch.isfinite(t).all()) for t in tree_leaves(new)),
          f"{arch.name} {cell}: non-finite")
    del state, new, metrics, images, labels
    rows, attn_rows = hold_train_signatures(torch, gen, rec, "float32")
    return dict(batch=b, loss=loss, launches=dict(zip(("k1", "k1_depthwise", "k1_backward", "k3"), got)),
                k1_grad_rows=rows, k3_grad_rows=attn_rows)


def vision_bf16(torch, gen, arch, cell: str, read, zero, per_step: tuple, hold: bool) -> dict:
    """(c) for one cell: bfloat16 at full width, two probe steps (peak memory
    up to the update, operations), the batch fitted (``fit_batch``, the
    trainer's entry state beside), TRAIN_STEPS steps through the
    fault-tolerant trainer timed, the fit's predicted peak beside the one
    measured there, one more step profiled by part; with ``hold`` that
    step's K1 and K3 signatures held in bfloat16.  ``per_step``: a step's
    launches (``step_launches``)."""
    import tempfile

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.steps import build, realize
    from repro_torch.core import ComputeRateEstimator
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime import FaultConfig

    name, dev = arch.name, gen.device
    res = arch.cells[cell].meta["img_res"]
    bundle = build(arch, cell)
    state, _ = realize(arch, bundle, gen)
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    probes = TRAIN_PROBE_BATCHES.get((name, cell), TRAIN_PROBE_BATCHES[cell])
    peaks, flops = {}, {}
    for pb in probes:
        x = torch.randn((pb, res, res, 3), generator=gen, device=dev).to(torch.bfloat16)
        y = torch.randint(0, arch.cfg.num_classes, (pb,), generator=gen, device=dev).to(torch.int32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        with recording_train_calls() as prec, FlopCounterMode(display=False) as counter, split_peaks(torch) as split:
            bundle.fn(state, images=x, labels=y)
            torch.cuda.synchronize()
        read()
        peaks[pb] = split["grad"]
        flops[pb] = op_cost().step_flops_of(counter, prec)
        del x, y
    cell_batch = arch.cells[cell].meta["batch"]
    batch, per, fixed = fit_batch(torch, peaks, probes, cell_batch, extra=state_bytes)
    predicted = fixed + per * batch + state_bytes
    step_flops = flops[probes[0]] / probes[0] * batch
    del state
    at = ", ".join(f"{peaks[p] / 1e9:.2f} GB at batch {p}" for p in probes)
    print(f"  {name} {cell} bf16: peak memory up to the update {at}: {per / 1e9:.4f} GB an image, the trainer's "
          f"entry state {state_bytes / 1e9:.2f} GB -> batch {batch}"
          + (f" (reduced from the cell's {cell_batch}: {(fixed + per * cell_batch + state_bytes) / 1e9:.1f} GB "
             f"predicted, over {TRAIN_MEM_SHARE} of the card)" if batch < cell_batch else " (the cell's)"))
    est = ComputeRateEstimator({"h100": 1e14}, alpha=0.5)
    dts = []

    def observe(es, fl, dt):
        dts.append(dt)
        est.observe(es, fl, dt)

    with tempfile.TemporaryDirectory() as d:
        trainer, state = cell_trainer(torch, with_batch(arch, batch, cell), FaultConfig(ckpt_dir=d, ckpt_every=10 ** 9),
                                      cell=cell, compute_observer=observe, es_name="h100", step_flops=step_flops)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        with split_peaks(torch) as split, no_final_checkpoint():
            state, stats = trainer.run(state, TRAIN_STEPS, resume=False)
        got = read()
        measured, update_peak = split["grad"], split["update"]
        check(stats.steps == TRAIN_STEPS and stats.failures == 0, f"{name} {cell}'s bf16 run: {stats}")
        check(all(math.isfinite(v) for v in stats.losses), f"{name} {cell}: a non-finite bf16 loss {stats.losses}")
        check(got == tuple(TRAIN_STEPS * n for n in per_step),
              f"{name} {cell}'s bf16 steps launched {got}, {TRAIN_STEPS} x {per_step}")
        zero()
        with recording_train_calls() as brec:
            busy, parts = step_breakdown(torch, lambda: trainer.step_fn(state, **trainer.stream.batch_at(TRAIN_STEPS)))
        read()
        del state, trainer
    steady = sorted(dts[1:]) or dts
    step_ms = steady[len(steady) // 2] * 1e3
    tflops = step_flops / (step_ms / 1e3) / 1e12
    fit_share = measured / predicted - 1.0
    print(f"  {TRAIN_STEPS} bf16 steps at batch {batch} through the trainer: losses "
          f"{', '.join(f'{v:.4f}' for v in stats.losses)}; median of steps 2-{len(dts)} {step_ms:.3f} ms (all "
          f"{', '.join(f'{v * 1e3:.1f}' for v in dts)}), {batch / step_ms * 1e3:.1f} images/s, {step_flops / 1e12:.3f} "
          f"TFLOP a step (remat's second forward counted) -> {tflops:.1f} TFLOP/s (the estimator's EWMA "
          f"{est.rate('h100') / 1e12:.1f}); peak memory up to the update {measured / 1e9:.2f} GB (the fit predicted "
          f"{predicted / 1e9:.2f}: {fit_share:+.3f}), in the update {update_peak / 1e9:.2f} GB")
    if abs(fit_share) > FIT_RTOL:
        print(f"  the fit's prediction misses the measured peak by more than {FIT_RTOL}: move {cell}'s probes")
    print("  one profiled bf16 step, device ms by part: " + "; ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f" (busy {busy:.3f}, idle share {1 - busy / step_ms:.3f} of the median step)")
    out = dict(batch=batch, cell_batch=cell_batch, reduced=batch < cell_batch, probes=list(probes),
               probe_peak_gb={k: v / 1e9 for k, v in peaks.items()}, per_image_gb=per / 1e9,
               entry_state_gb=state_bytes / 1e9, predicted_peak_gb=predicted / 1e9, peak_gb=measured / 1e9,
               update_peak_gb=update_peak / 1e9, fit_share=fit_share, losses=stats.losses, step_ms=step_ms,
               step_ms_all=[v * 1e3 for v in dts], images_per_s=batch / step_ms * 1e3, step_tflop=step_flops / 1e12,
               tflops=tflops, estimator_tflops=est.rate("h100") / 1e12, device_busy_ms=busy,
               device_ms_by_part=parts, launches=dict(zip(("k1", "k1_depthwise", "k1_backward", "k3"), got)))
    torch.cuda.empty_cache()
    if hold:  # that step's K1 and K3 signatures, in bfloat16 at the timed batch
        bf_rows, bf_attn = hold_train_signatures(torch, gen, brec, "bfloat16")
        check(bool(bf_rows) and {r["dtype"] for r in bf_rows} == {"bfloat16"}
              and all(r["shape"][0] == batch for r in bf_rows),
              f"{name}: the timed step's K1 calls were not bf16 at batch {batch}")
        out.update(k1_grad_rows=bf_rows, k3_grad_rows=bf_attn)
        torch.cuda.empty_cache()
    return out


# Phase 16 (``phase_lm_diffusion_train``): LM and diffusion training.  (a)
# K3's Function held at LM_FN_SHAPES and DIFF_FN_SHAPES (label, B, H, Hkv,
# T, S, D, DV, causal) and timed beside its plain backward, that backward's
# bound and SDPA's forward + backward; at TIMED_ONLY_SHAPES (gen and
# train_1024's U-Net level 0, T = 16384: its plain autograd alone would hold
# ~30 GB) timed only.  (b) f32 steps: Qwen3-4B cut to LM_CHECK_LAYERS layers
# at 1 x LM_TRAIN_LEN tokens, the U-Net and DiT at train_256 and batch
# TRAIN_CHECK_BATCH.  (c) bf16 through the trainer: Qwen3-4B at all its
# layers (probes LM_PROBE_BATCHES), the diffusion pair at train_256 (probes
# DIFF_PROBE_BATCHES), TRAIN16_STEPS timed steps each; one train_1024 step of
# each (probes DIFF_1024_PROBES) at the batch they fit, at most
# TRAIN_1024_BATCH (for time: DiT-XL/2's 32 took 33 s).  (d) DeepSeek-V3's
# loss_fn with the MTP
# module at full width, MTP_TOKENS tokens, its gradient held group by group
# (MTP_GROUPS: each of the MTP block's expert matrices, then the rest) so
# that one group's plain gradient fits beside the kernels' whole one.
LM_FN_SHAPES = (("qwen3-4b causal GQA", 1, 32, 8, 4096, 4096, 128, 128, True),
                ("deepseek-v3 MLA", 1, 128, 128, 512, 512, 192, 128, True))
DIFF_FN_SHAPES = (("unet-sd15 self D=40", 4, 8, 8, 1024, 1024, 40, 40, False),
                  ("unet-sd15 cross D=40", 4, 8, 8, 1024, 77, 40, 40, False),
                  ("unet-sd15 cross D=80", 4, 8, 8, 256, 77, 80, 80, False),
                  ("unet-sd15 cross D=160", 4, 8, 8, 64, 77, 160, 160, False),
                  ("dit-xl2 D=72", 4, 16, 16, 256, 256, 72, 72, False))
TIMED_ONLY_SHAPES = (("unet-sd15 self D=40 T=16384", 1, 8, 8, 16384, 16384, 40, 40, False),)
LM_CHECK_LAYERS, LM_TRAIN_LEN, TRAIN16_STEPS = 4, 4096, 3  # the median of steps 2-3: the first is warm-up
LM_PROBE_BATCHES, DIFF_PROBE_BATCHES, DIFF_1024_PROBES, TRAIN_1024_BATCH = (1, 2), (16, 32), (1, 2), 8
MTP_TOKENS = 512
MTP_GROUPS = ("mtp/block/ffn/experts/w1", "mtp/block/ffn/experts/w3", "mtp/block/ffn/experts/w2", None)


@contextlib.contextmanager
def recording_lm_calls(attn_wrap=None):
    """Records every K3 call the LM makes while entered (``gqa_flash`` as
    ``models.attention`` calls it), by q's [B, H, T, D] shape, the key
    count, dtype, causal and the value width; ``attn_wrap(out, call)`` may
    replace each output (the control).  The wrapper runs as it is."""
    from repro_torch.kernels.attention import gqa_flash
    from repro_torch.models import attention as lm_attention

    rec = types.SimpleNamespace(convs=Counter(), attns=Counter(), recomputed=Counter(), calls=0)  # no K1 calls

    def attn(q, k, v, *, causal):
        b, t, h, d = q.shape
        rec.attns[((b, h, t, d), k.shape[1], str(q.dtype).removeprefix("torch."), causal, v.shape[3])] += 1
        out = gqa_flash(q, k, v, causal=causal)
        rec.calls += 1
        return attn_wrap(out, rec.calls - 1) if attn_wrap else out

    lm_attention.gqa_flash = attn
    try:
        yield rec
    finally:
        lm_attention.gqa_flash = gqa_flash


def scaled_grad(torch):
    """The identity, whose backward scales the gradient by TRAIN_CONTROL."""
    class ScaledGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y):
            return y.view_as(y)

        @staticmethod
        def backward(ctx, g):
            return g * TRAIN_CONTROL

    return ScaledGrad.apply


def attention_backward_bound(b, h, hkv, t, s, d, dv, causal) -> dict:
    """The least time of K3's backward at a shape: operations of its five
    products over the (query, key) pairs the softmax weighs (the scores
    recomputed, dV, dP, dQ, dK: 2 x pairs x (3 D + 2 DV)) and float32 bytes
    (q, k, v, o, dO read once, dq, dk, dv written once), at the 3xTF32 peak
    and, beside it, at the CUDA cores' FMA rate (the plain backward runs
    with TF32 off)."""
    flops = 2.0 * b * h * op_cost().attention_pairs(t, s, causal) * (3 * d + 2 * dv)
    nbytes = 4.0 * (2 * b * h * t * d + 2 * b * hkv * s * d + 2 * b * hkv * s * dv + 2 * b * h * t * dv)
    ops_ms, bytes_ms = bound_ms(flops, nbytes, "float32")
    return dict(flops=flops, bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ffma_bound_ms=max(flops / FFMA_FLOPS * 1e3, bytes_ms))


def attention_abs_sums(torch, q, k, v, do, *, causal: bool = True) -> tuple:
    """The scale of float32 rounding in attention and its gradients: for o,
    dq, dk and dv (the operands as ``attention_ref``'s, [B,H,T,D], ``do``
    the output's cotangent, [B,H,T,DV]) the sum of the absolute values of
    the terms each element adds up, from the plain version's probabilities
    P: ``P |v|``; ``A |k| / sqrt(D)``, ``A^T |q| / sqrt(D)`` and
    ``P^T |do|``, where ``A = P * (|do| |v|^T + rowsum(|do| * |o|))`` bounds
    the terms of the score gradient ``P * (do v^T - rowsum(do * o))``.  A
    difference of float32 sums where large terms cancel is of this scale
    times 2^-20 or so, which 2e-5 x (1 + |g|) does not follow; float32."""
    t, d = q.shape[2], q.shape[3]
    s = k.shape[2]
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    logits = torch.einsum("bhtd,bhsd->bhts", qf, kf) / math.sqrt(d)
    if causal:
        mask = torch.arange(t, device=q.device)[:, None] >= torch.arange(s, device=q.device)[None, :]
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    del logits
    o_abs = torch.einsum("bhts,bhsd->bhtd", p, vf.abs())
    o = torch.einsum("bhts,bhsd->bhtd", p, vf)
    a = p * (torch.einsum("bhtd,bhsd->bhts", dof.abs(), vf.abs()) + (dof * o).abs().sum(-1, keepdim=True))
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bhts,bhsd->bhtd", a, kf.abs()) * scale
    dk = torch.einsum("bhts,bhtd->bhsd", a, qf.abs()) * scale
    dv = torch.einsum("bhts,bhtd->bhsd", p, dof.abs())
    return o_abs, dq, dk, dv


def hold_attention_fn(torch, F, gen, shape: tuple, hold: bool = True) -> dict:
    """K3's autograd Function at one shape (label, B, H, Hkv, T, S, D, DV,
    causal), float32 in the model layout ([B, T, H, D]; ``gqa_flash``):
    with ``hold``, o, dq, dk and dv against autograd through the plain
    version on the same values within 2e-5 x (1 + |g|) plus ``SUM_RTOL`` x
    the sum of |terms| (``attention_abs_sums``), fatal beyond.  Then device
    us of K3's forward, of its plain backward (``attention_backward``) a
    call, the backward's bound, and of SDPA's forward + backward on the
    repeated KV heads (the library's yardstick).  The count is left as it
    was."""
    from repro_torch.kernels.attention import attention_ref, flash_attention, gqa_flash
    from repro_torch.kernels.attention.ops import attention_backward

    label, b, h, hkv, t, s, d, dv, causal = shape
    count, g = flash_attention.launches, h // hkv
    q, k, v, do = (torch.randn(sh, generator=gen, device=gen.device)
                   for sh in ((b, t, h, d), (b, s, hkv, d), (b, s, hkv, dv), (b, t, h, dv)))
    row = dict(label=label, b=b, h=h, hkv=hkv, t=t, s=s, d=d, dv=dv, causal=causal)

    def plain(q, k, v):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return attention_ref(qt, kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1),
                             causal=causal).transpose(1, 2)

    def outputs(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        return [out.detach(), *torch.autograd.grad(out, leaves, do)]

    if hold:
        got = outputs(lambda q, k, v: gqa_flash(q, k, v, causal=causal))
        want = outputs(plain)
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        sums = [x.transpose(1, 2) for x in attention_abs_sums(torch, qt, kt.repeat_interleave(g, 1),
                                                              vt.repeat_interleave(g, 1), dot, causal=causal)]
        sums[2:] = [x.reshape(b, s, hkv, g, -1).sum(3) for x in sums[2:]]  # a KV head's query heads
        for name, gt, wt, sm in zip(("o", "dq", "dk", "dv"), got, want, sums):
            diff = (gt - wt).abs()
            tol = TOL["float32"] * (1 + wt.abs())
            share = (diff / (tol + SUM_RTOL * sm)).max().item()
            row[name] = dict(max_abs_err=diff.max().item(), max_abs=wt.abs().max().item(), limit_share=share,
                             within_tol=bool((diff <= tol).all()))
            check(share <= 1.0 and bool(torch.isfinite(gt).all()),
                  f"K3's Function disagrees with the plain version's autograd at {label}: {name} {row[name]}")
        del got, want, sums
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    o = gqa_flash(q, k, v, causal=causal).transpose(1, 2)
    row["forward_device_us"], row["forward_source"] = device_or_event_us(
        torch, lambda: gqa_flash(q, k, v, causal=causal), reps=5)
    row["backward_device_us"], row["backward_source"] = device_or_event_us(
        torch, lambda: attention_backward(qt, kt, vt, o, dot, causal), reps=3)
    row["backward"] = attention_backward_bound(b, h, hkv, t, s, d, dv, causal)
    qs, ks, vs = (x.contiguous().requires_grad_() for x in (qt, kt.repeat_interleave(g, 1),
                                                             vt.repeat_interleave(g, 1)))
    dos = dot.contiguous()

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        torch.autograd.grad(out, (qs, ks, vs), dos)

    row["sdpa_fwd_bwd_device_us"], row["sdpa_source"] = device_or_event_us(torch, sdpa_fwd_bwd, reps=3)
    row["sdpa_backend"] = sdpa_backend(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal))
    flash_attention.launches = count
    held = (f"held: max_err o {row['o']['max_abs_err']:.3g} dq {row['dq']['max_abs_err']:.3g} dk "
            f"{row['dk']['max_abs_err']:.3g} dv {row['dv']['max_abs_err']:.3g}, largest share of the limit "
            f"{max(row[n]['limit_share'] for n in ('o', 'dq', 'dk', 'dv')):.3g} (within 2e-5 x (1 + |g|) alone: "
            f"{all(row[n]['within_tol'] for n in ('o', 'dq', 'dk', 'dv'))}); " if hold else "timed only; ")
    bw = row["backward"]
    print(f"  K3's Function at {label} [{b}, {h} ({hkv} KV), {t}, {d}/{dv}] S={s}{' causal' if causal else ''}: "
          f"{held}K3 forward {row['forward_device_us']:.1f} us, plain backward {row['backward_device_us']:.1f} us "
          f"(bound {bw['bound_ms'] * 1e3:.1f} us by {bw['bound_by']}, {bw['ffma_bound_ms'] * 1e3:.1f} at the FMA "
          f"rate), SDPA forward + backward {row['sdpa_fwd_bwd_device_us']:.1f} us ({row['sdpa_backend']})")
    return row


def settle(torch, label: str) -> float:
    """Collect what a finished part left (autograd graphs and checkpoint
    frames can hold device tensors in reference cycles until Python's
    collector runs), return the cache, and print the device memory still
    allocated, in GB."""
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    print(f"  {label}: {resident:.2f} GB of device memory still allocated")
    return resident


@contextlib.contextmanager
def no_final_checkpoint():
    """The fault-tolerant trainer's checkpoints skipped while entered."""
    from repro_torch.runtime import fault

    real = fault.save_checkpoint
    fault.save_checkpoint = lambda *args, **kw: None
    try:
        yield
    finally:
        fault.save_checkpoint = real


def random_batch(torch, arch, bundle, batch: int, gen) -> dict:
    """A batch of the bundle's inputs at ``batch`` on the generator's device,
    as the streams make them: tokens below the vocabulary, timesteps below
    1000, class ids below the class count, float32 N(0, 1) (the step casts
    them)."""
    out = {}
    for name, (shape, dt) in bundle.inputs.items():
        shape = (batch,) + tuple(shape[1:])
        if dt.is_floating_point:
            out[name] = torch.randn(shape, generator=gen, device=gen.device)
            continue
        high = {"tokens": getattr(arch.cfg, "vocab", 0), "labels": getattr(arch.cfg, "vocab", 0), "t": 1000,
                "cond": getattr(arch.cfg, "num_classes", 0)}[name]
        out[name] = torch.randint(0, high, shape, generator=gen, device=gen.device).to(dt)
    return out


def held_step(torch, label: str, run, plain, state, rtol: float = TRAIN_LEAF_RTOL) -> dict:
    """One f32 train step through the kernels (``run``: (new state,
    metrics)) held to the same step through the plain versions (``plain``):
    the loss within DEPTH_RTOL, leaf by leaf each first moment and update
    within ``rtol`` (``leaf_shares``).  Returns the shares."""
    from repro_torch.models.common import tree_leaves

    new, metrics = run
    ref, pmetrics = plain
    key = "total" if "total" in metrics else "loss"
    loss, ploss = metrics[key].item(), pmetrics[key].item()
    shares = leaf_shares(new, ref, state)
    moved = max((a - o).abs().max().item() for a, o in zip(tree_leaves(new[0]), tree_leaves(state[0])))
    print(f"  {label} vs the plain versions' step: loss {loss:.7g} / {ploss:.7g}; leaf by leaf, largest |diff| of a "
          f"first moment {shares['mu'][0]:.3g} of its leaf's largest ({shares['mu'][1]}), of an update "
          f"{shares['update'][0]:.3g} ({shares['update'][1]}); limit {rtol}; {len(shares['blind'])} blind leaves; "
          f"largest |update| {moved:.3g}")
    check(abs(loss - ploss) <= DEPTH_RTOL * abs(ploss) and shares["mu"][0] <= rtol and shares["update"][0] <= rtol,
          f"{label}: the float32 step drifts from the plain versions' step")
    check(moved > 0 and all(bool(torch.isfinite(t).all()) for t in tree_leaves(new)),
          f"{label}: the step left the parameters where they were, or made them non-finite")
    return dict(loss=loss, plain_loss=ploss, mu_share=shares["mu"], update_share=shares["update"],
                blind_leaves=shares["blind"], max_abs_update=moved)


def held_control(label: str, control, plain, state, rtol: float = TRAIN_LEAF_RTOL) -> tuple:
    """The control: the step with one kernel call's output gradient scaled
    by TRAIN_CONTROL must break ``held_step``'s first-moment hold against
    the plain versions' step.  Returns its largest share and leaf."""
    ctl = leaf_shares(control[0], plain[0], state)
    print(f"  {label}: the control (one K3 call's output gradient x {TRAIN_CONTROL}): first moment "
          f"{ctl['mu'][0]:.3g} ({ctl['mu'][1]}), update {ctl['update'][0]:.3g}")
    check(ctl["mu"][0] > rtol, f"{label}: the control step with one wrong gradient passes the hold: it tests nothing")
    return ctl["mu"]


def same_step(torch, label: str, a, b, state) -> dict:
    """Two f32 steps that must agree (remat on and off): the losses equal,
    every first moment and update within TRAIN_LEAF_RTOL of its leaf's
    (``leaf_shares``); whether every leaf is bit-identical is printed."""
    from repro_torch.models.common import tree_leaves

    key = "total" if "total" in a[1] else "loss"
    shares = leaf_shares(a[0], b[0], state)
    bits = all(torch.equal(x, y) for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])))
    print(f"  {label}: loss {a[1][key].item():.9g} / {b[1][key].item():.9g}; first moments {shares['mu'][0]:.3g}, "
          f"updates {shares['update'][0]:.3g} of their leaves' largest; every leaf bit-identical: {bits}")
    check(torch.equal(a[1][key], b[1][key]) and shares["mu"][0] <= TRAIN_LEAF_RTOL
          and shares["update"][0] <= TRAIN_LEAF_RTOL, f"{label}: the two steps differ")
    return dict(mu_share=shares["mu"], update_share=shares["update"], bit_identical=bits)


@contextlib.contextmanager
def split_peaks(torch):
    """While entered, a train step's peak device memory is read in two
    parts: up to its AdamW update (the parameters, the state, the
    activations and the gradients: ``"grad"``), and in the update (the old
    and the new state side by side, the same at any batch: ``"update"``);
    ``configs.steps.adamw_update`` is wrapped to read them."""
    from repro_torch.configs import steps

    real, peaks = steps.adamw_update, {}

    def update(*args, **kw):
        torch.cuda.synchronize()
        peaks["grad"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        peaks["update"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()  # a next step's "grad" starts here
        return out

    steps.adamw_update = update
    try:
        yield peaks
    finally:
        steps.adamw_update = real


def fit_batch(torch, peaks: dict, probes: tuple, cell_batch: int, extra: float = 0.0) -> tuple[int, float, float]:
    """The largest power-of-two cut of ``cell_batch`` whose peak memory up to
    the update (``split_peaks``' "grad"), by a line through the probes',
    plus ``extra`` bytes held beside the step (a trainer's entry state),
    stays within TRAIN_MEM_SHARE of the card (at least the larger probe):
    (batch, bytes an item, fixed bytes).  The update's own peak does not
    grow with the batch, and the probes ran it."""
    lo, hi = probes
    per = (peaks[hi] - peaks[lo]) / (hi - lo)
    fixed = peaks[lo] - per * lo
    room = TRAIN_MEM_SHARE * torch.cuda.get_device_properties(0).total_memory
    batch = cell_batch
    while batch > hi and fixed + per * batch + extra > room:
        batch //= 2
    return batch, per, fixed


def train_bf16(torch, gen, arch, cell: str, probes: tuple, recorder, unit: str, items_per: int) -> tuple[dict, dict]:
    """(c) for one arch: bfloat16 at full width through ``configs.steps``'
    ``cell``: two probe steps (peak memory, operations), the batch fitted
    (``fit_batch``), TRAIN16_STEPS steps through the fault-tolerant trainer
    (``cell_trainer``) timed, one more profiled by part.  ``recorder()``
    records the kernel calls; ``items_per`` counts ``unit`` in one batch
    item (tokens of a sequence, one latent).  Returns (report, the counted
    launches' recordings)."""
    import tempfile

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.steps import build, realize
    from repro_torch.core import ComputeRateEstimator
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime import FaultConfig

    bundle = build(arch, cell)
    state, _ = realize(arch, bundle, gen)
    n_params = sum(t.numel() for t in tree_leaves(state[0]))
    peaks, update_peaks, flops, recs = {}, {}, {}, []
    for pb in probes:
        batch = random_batch(torch, arch, bundle, pb, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with recorder() as rec, FlopCounterMode(display=False) as counter, split_peaks(torch) as split:
            metrics = bundle.fn(state, **batch)[1]  # the new state dropped at once: a second would not fit
            torch.cuda.synchronize()
        recs.append(rec)
        peaks[pb], update_peaks[pb] = split["grad"], split["update"]
        flops[pb] = op_cost().step_flops_of(counter, rec)
        check(all(math.isfinite(v.item()) for v in metrics.values()), f"{arch.name}: a non-finite probe loss")
        del batch, metrics
    cell_batch = max(arch.cells[cell].meta.get(k, 0) for k in ("batch", "global_batch"))
    batch, per, fixed = fit_batch(torch, peaks, probes, cell_batch)
    step_flops = flops[probes[0]] / probes[0] * batch
    print(f"  {arch.name} {cell} bf16 ({n_params / 1e9:.3f} B parameters): peak memory up to the update "
          + ", ".join(f"{peaks[p] / 1e9:.2f} GB at batch {p}" for p in probes)
          + f" (in the update {max(update_peaks.values()) / 1e9:.2f} GB): {per / 1e9:.3f} GB an item -> batch {batch}"
          + (f" (reduced from the cell's {cell_batch}: {(fixed + per * cell_batch) / 1e9:.1f} GB predicted, over "
             f"{TRAIN_MEM_SHARE} of the card)" if batch < cell_batch else " (the cell's)"))
    est = ComputeRateEstimator({"h100": 1e14}, alpha=0.5)
    dts = []

    def observe(es, fl, dt):
        dts.append(dt)
        est.observe(es, fl, dt)

    # the trainer's run keeps its entry state for a rollback beside the
    # step's old and new states: where that third state does not fit, the
    # trainer's step runs in a loop of its own (2 states at the update)
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    through_run = max(update_peaks.values()) + state_bytes <= 0.95 * torch.cuda.get_device_properties(0).total_memory
    with tempfile.TemporaryDirectory() as d:
        trainer, state = cell_trainer(torch, with_batch(arch, batch, cell), FaultConfig(ckpt_dir=d, ckpt_every=10 ** 9),
                                      cell=cell, state=state, compute_observer=observe, es_name="h100",
                                      step_flops=step_flops)
        torch.cuda.reset_peak_memory_stats()
        with recorder() as rec:
            if through_run:
                # the run's closing checkpoint is not written (phase 15 (d)
                # holds checkpoint and restart bit for bit)
                with no_final_checkpoint():
                    state, stats = trainer.run(state, TRAIN16_STEPS, resume=False)
                losses = stats.losses
                check(stats.steps == TRAIN16_STEPS and stats.failures == 0, f"{arch.name}'s bf16 run: {stats}")
            else:
                print(f"  the trainer's run would hold a third state of {state_bytes / 1e9:.1f} GB beside the "
                      f"update's peak {max(update_peaks.values()) / 1e9:.1f} GB: its step runs in a loop")
                losses = []
                for i in range(TRAIN16_STEPS):
                    host = trainer.stream.batch_at(i)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    state, metrics = trainer.step_fn(state, **host)
                    torch.cuda.synchronize()
                    observe("h100", step_flops, time.perf_counter() - t1)
                    losses.append(metrics.get("total", metrics.get("loss")).item())
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        recs.append(rec)
        check(len(losses) == TRAIN16_STEPS and all(math.isfinite(v) for v in losses),
              f"{arch.name}: a non-finite bf16 loss {losses}")
        with recorder() as rec:
            busy, parts = step_breakdown(
                torch, lambda: trainer.step_fn(state, **trainer.stream.batch_at(TRAIN16_STEPS)))
        recs.append(rec)
    steady = sorted(dts[1:]) or dts
    step_ms = steady[len(steady) // 2] * 1e3
    tflops = step_flops / (step_ms / 1e3) / 1e12
    rate = batch * items_per / step_ms * 1e3
    print(f"  {TRAIN16_STEPS} bf16 steps at batch {batch} through the trainer's "
          f"{'run' if through_run else 'step'}: losses {', '.join(f'{v:.4f}' for v in losses)}; "
          f"median of steps 2-{len(dts)} {step_ms:.1f} ms (all "
          f"{', '.join(f'{v * 1e3:.1f}' for v in dts)}), {rate:.1f} {unit}/s, {step_flops / 1e12:.2f} TFLOP a step "
          f"-> {tflops:.1f} TFLOP/s (the estimator's EWMA {est.rate('h100') / 1e12:.1f}); peak memory {peak_gb:.2f} GB")
    print("  one profiled bf16 step, device ms by part: " + "; ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f" (busy {busy:.1f}, idle share {1 - busy / step_ms:.3f} of the median step); the TFLOP counted: "
          f"matrix products as they ran (remat's second forward, K3's plain backward over every pair), the convs "
          f"from their shapes, K3's forwards at the pairs they weigh")
    del state, trainer
    settle(torch, f"after {arch.name}'s bf16 steps")
    return dict(params_b=n_params / 1e9, batch=batch, cell_batch=cell_batch, reduced=batch < cell_batch,
                probe_peak_gb={k: v / 1e9 for k, v in peaks.items()},
                update_peak_gb=max(update_peaks.values()) / 1e9, through_run=through_run, losses=losses,
                step_ms=step_ms,
                step_ms_all=[v * 1e3 for v in dts], per_s=rate, unit=unit, step_tflop=step_flops / 1e12,
                tflops=tflops, estimator_tflops=est.rate("h100") / 1e12, peak_gb=peak_gb, device_busy_ms=busy,
                device_ms_by_part=parts), recs


def one_step_at_fit(torch, gen, arch, cell: str, probes: tuple, recorder, most: int) -> tuple[dict, list]:
    """One bfloat16 step of ``cell`` at the batch two probe steps' peak
    memory fits (``fit_batch``), at most ``most``: ms a step (host clock to
    a synchronize) and peak memory.  Returns (report, the recordings)."""
    from repro_torch.configs.steps import build, realize

    bundle = build(arch, cell)
    state, _ = realize(arch, bundle, gen)
    peaks, recs = {}, []

    def step(b):
        batch = random_batch(torch, arch, bundle, b, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recorder() as rec, split_peaks(torch) as split:
            metrics = bundle.fn(state, **batch)[1]
            torch.cuda.synchronize()
        recs.append(rec)
        check(math.isfinite(metrics["loss"].item()), f"{arch.name} {cell}: a non-finite loss")
        return (time.perf_counter() - t0) * 1e3, split, metrics["loss"].item()

    for pb in probes:
        peaks[pb] = step(pb)[1]["grad"]
    cell_batch = arch.cells[cell].meta["batch"]
    fit, per, _ = fit_batch(torch, peaks, probes, cell_batch)
    batch = min(fit, most)
    ms, split, loss = step(batch)
    peak = max(split.values())
    print(f"  {arch.name} {cell} bf16: one step at batch {batch} (the cell's {cell_batch}"
          f"{'' if batch == fit else f', the fit {fit}, reduced for time'}; {per / 1e9:.2f} GB an "
          f"item by the probes at {probes}): {ms:.1f} ms, loss {loss:.4f}, peak memory {peak / 1e9:.2f} GB "
          f"({split['grad'] / 1e9:.2f} up to the update)")
    del state
    settle(torch, f"after {arch.name}'s {cell} step")
    return dict(batch=batch, cell_batch=cell_batch, fit_batch=fit, reduced=batch < cell_batch, ms=ms,
                peak_gb=peak / 1e9, loss=loss, probe_peak_gb={k: v / 1e9 for k, v in peaks.items()}), recs


def phase_lm_diffusion_train(torch) -> tuple[dict, dict]:
    """Phase 16: LM and diffusion training through ``configs.steps``' train
    cells on the card, TF32 off, seeded random weights: (a) K3's autograd
    Function held against the plain version's autograd at the LM and
    diffusion train shapes (``hold_attention_fn``), and K1's at every K1
    signature of a U-Net train_256 step (``hold_conv_grad``); (b) float32
    steps from a warm state held to the same steps through the plain
    versions (``held_step``), a control that must break the hold, remat on
    against off (``same_step``), the launches counted: Qwen3-4B at full
    width cut to LM_CHECK_LAYERS layers at 1 x LM_TRAIN_LEN tokens, the
    U-Net and DiT at train_256 and batch TRAIN_CHECK_BATCH; (c) bfloat16
    through the trainer (``train_bf16``): Qwen3-4B at all 36 layers at
    train_4k's 4096 tokens, remat on; the U-Net and DiT at train_256; one
    train_1024 step of each (``one_step_at_fit``); (d) DeepSeek-V3's
    ``loss_fn`` with its MTP module at full width (1 dense layer, no MoE
    trunk layer) at MTP_TOKENS tokens: metrics and gradients held to the
    same pass with plain attention, route aware, with no AdamW step (its
    moments would not fit).  Returns the report and the launches."""
    import torch.nn.functional as F

    from repro_torch.configs import get as get_arch
    from repro_torch.configs.steps import build, realize
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.models import transformer_lm as lm
    from repro_torch.models.common import tree_leaves

    phase_t0 = time.perf_counter()
    settle(torch, "phase 16 starts")
    gen = torch.Generator(device="cuda").manual_seed(16)
    dev = gen.device
    launches = {"conv2d": 0, "conv2d_backward": 0, "flash_attention": 0}
    report: dict = {}
    apply_scaled = scaled_grad(torch)

    def zero():
        conv2d_cuda.launches = conv2d_cuda.depthwise_launches = conv2d_cuda.backward_launches = 0
        flash_attention.launches = 0

    def read() -> tuple[int, int, int]:
        """The launches since the last read (or ``zero``), added to the phase's."""
        got = conv2d_cuda.launches, conv2d_cuda.backward_launches, flash_attention.launches
        for key, n in zip(("conv2d", "conv2d_backward", "flash_attention"), got):
            launches[key] += n
        zero()
        return got

    # (a) K3's Function at the train shapes
    t0 = time.perf_counter()
    report["k3_fn"] = [hold_attention_fn(torch, F, gen, sh) for sh in LM_FN_SHAPES + DIFF_FN_SHAPES]
    report["k3_fn"] += [hold_attention_fn(torch, F, gen, sh, hold=False) for sh in TIMED_ONLY_SHAPES]
    settle(torch, "after (a)")
    print(f"  (a) K3's Function: {time.perf_counter() - t0:.1f} s")

    # (b) Qwen3-4B at full width, LM_CHECK_LAYERS layers, float32 at 1 x LM_TRAIN_LEN
    t0 = time.perf_counter()
    qwen = get_arch("qwen3-4b")
    cut = dataclasses.replace(qwen, cfg=dataclasses.replace(qwen.cfg, n_layers=LM_CHECK_LAYERS))
    bundle = build(cut, "train_4k", dtype=torch.float32)
    state, _ = realize(cut, bundle, gen)
    state = warm_state(torch, state, gen)
    batch = random_batch(torch, cut, bundle, 1, gen)  # 1 x train_4k's seq_len
    zero()
    plain = with_plain_attention(lambda: bundle.fn(state, **batch))
    torch.cuda.synchronize()
    check(read() == (0, 0, 0), "the plain LM step launched a kernel")
    with recording_lm_calls() as rec:
        run = bundle.fn(state, **batch)
        torch.cuda.synchronize()
    got = read()
    check(got[2] == sum(rec.attns.values()) == 2 * LM_CHECK_LAYERS,
          f"Qwen3-4B's remat step launched K3 {got[2]} times, recorded {sum(rec.attns.values())}, expected "
          f"{2 * LM_CHECK_LAYERS} (forward and recompute)")
    print(f"qwen3-4b float32 step at full width, {LM_CHECK_LAYERS} of {qwen.cfg.n_layers} layers, 1 x {LM_TRAIN_LEN} "
          f"tokens: K3 launches {got[2]} with remat (forward and recompute); metrics "
          + ", ".join(f"{k} {v.item():.6g}" for k, v in run[1].items()))
    off = build(dataclasses.replace(cut, cfg=dataclasses.replace(cut.cfg, remat=False)), "train_4k",
                dtype=torch.float32)
    run_off = off.fn(state, **batch)
    torch.cuda.synchronize()
    check(read()[2] == LM_CHECK_LAYERS, "Qwen3-4B's step without remat launched K3 other than once a layer")
    remat = same_step(torch, "qwen3-4b remat on against off", run, run_off, state)
    del run_off
    lm_rep = held_step(torch, "qwen3-4b", run, plain, state)
    del run
    with recording_lm_calls(lambda y, i: apply_scaled(y) if i == LM_CHECK_LAYERS // 2 else y):
        control = off.fn(state, **batch)
        torch.cuda.synchronize()
    read()
    lm_rep.update(remat=remat, control_mu_share=held_control("qwen3-4b", control, plain, state))
    del control, plain
    bwd_ms, bwd_parts = step_breakdown(torch, lambda: bundle.fn(state, **batch))
    read()
    print("  one profiled float32 step, device ms by part: " + "; ".join(f"{k} {v:.2f}" for k, v in bwd_parts.items())
          + f" (busy {bwd_ms:.2f})")
    report["qwen3-4b"] = dict(float32_step=dict(lm_rep, layers=LM_CHECK_LAYERS, tokens=LM_TRAIN_LEN, k3_launches=got[2],
                                                device_busy_ms=bwd_ms, device_ms_by_part=bwd_parts))
    del state, bundle, off
    settle(torch, "after qwen3-4b's float32 steps")
    print(f"  qwen3-4b float32: {time.perf_counter() - t0:.1f} s")

    # (b) the U-Net and DiT, float32 at train_256 and batch TRAIN_CHECK_BATCH
    for name in DIFFUSION_ARCHS:
        t0 = time.perf_counter()
        arch = get_arch(name)
        bundle = build(arch, "train_256", dtype=torch.float32)
        state, _ = realize(arch, bundle, gen)
        state = warm_state(torch, state, gen)
        batch = random_batch(torch, arch, bundle, TRAIN_CHECK_BATCH, gen)
        zero()
        with recording_train_calls() as rec:
            run = bundle.fn(state, **batch)
            torch.cuda.synchronize()
        got = read()
        remat = 2 if getattr(arch.cfg, "remat", False) else 1
        want = (sum(rec.convs.values()), k1_dgrads(rec), sum(rec.attns.values()))
        conv_fwd, attn_fwd = DIFFUSION_LAUNCHES[name]
        print(f"{name} float32 step at batch {TRAIN_CHECK_BATCH} (train_256: latent "
              f"{arch.cells['train_256'].meta['img_res'] // 8}): K1 launches {got[0]} forward, {got[1]} backward; "
              f"K3 {got[2]}; recorded {want}; remat x{remat}")
        check(got == want and got[0] == conv_fwd and got[2] == remat * attn_fwd,
              f"{name}'s step launched {got}, recorded {want}, expected K1 {conv_fwd} and K3 {remat} x {attn_fwd}")
        check(got[0] > 0 and got[2] > 0 and (got[1] > 0 or name == "dit-xl2"),
              f"{name}'s step left a kernel of its path unlaunched: {got}")
        with plain_kernels():
            plain = bundle.fn(state, **batch)
            torch.cuda.synchronize()
        check(read() == (0, 0, 0), "the plain diffusion step launched a kernel")
        rep = report[name] = {}
        if remat > 1:
            off = build(dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, remat=False)), "train_256",
                        dtype=torch.float32)
            run_off = off.fn(state, **batch)
            torch.cuda.synchronize()
            check(read()[2] == attn_fwd, f"{name}'s step without remat launched K3 other than once a block")
            remat_rep = same_step(torch, f"{name} remat on against off", run, run_off, state)
            del run_off, off
        rep["float32_step"] = held_step(torch, name, run, plain, state)
        del run
        if remat > 1:
            rep["float32_step"]["remat"] = remat_rep
        calls, pick = [0], attn_fwd // 2

        def control_attn(*args, **kw):
            calls[0] += 1
            y = flash_attention(*args, **kw)
            return apply_scaled(y) if calls[0] - 1 == pick else y

        with model_kernels(conv2d_cuda, control_attn):
            control = bundle.fn(state, **batch)
            torch.cuda.synchronize()
        read()
        rep["float32_step"]["control_mu_share"] = held_control(name, control, plain, state)
        del control, plain
        zero()
        bwd_ms, bwd_parts = step_breakdown(torch, lambda: bundle.fn(state, **batch))
        read()
        print("  one profiled float32 step, device ms by part: "
              + "; ".join(f"{k} {v:.2f}" for k, v in bwd_parts.items()) + f" (busy {bwd_ms:.2f})")
        rep["float32_step"].update(batch=TRAIN_CHECK_BATCH, launches=dict(zip(("k1", "k1_backward", "k3"), got)),
                                   device_busy_ms=bwd_ms, device_ms_by_part=bwd_parts)
        del state, bundle
        if name == "unet-sd15":  # (a) K1's Function at every K1 signature of the step
            rows = [dict(hold_conv_grad(torch, gen, sig), per_step=c) for sig, c in sorted(rec.convs.items(), key=str)]
            rep["k1_grad_rows"] = rows
            print_conv_holds(rows, "float32")
        settle(torch, f"after {name}'s float32 steps")
        print(f"  {name} float32: {time.perf_counter() - t0:.1f} s")

    # (c) bfloat16 through the trainer
    t0 = time.perf_counter()
    rep_c, recs = train_bf16(torch, gen, qwen, "train_4k", LM_PROBE_BATCHES, recording_lm_calls, "tokens",
                             qwen.cells["train_4k"].meta["seq_len"])
    report["qwen3-4b"]["bfloat16"] = rep_c
    lm_calls = [sum(r.attns.values()) for r in recs]
    n = read()
    check(n[2] == sum(lm_calls) and all(c == 2 * qwen.cfg.n_layers * k for k, c in
                                        zip((1, 1, TRAIN16_STEPS, 1), lm_calls)),
          f"Qwen3-4B's bf16 steps launched K3 {n[2]} times, recorded {lm_calls}")
    print(f"  qwen3-4b bf16: K3 launches {n[2]} ({2 * qwen.cfg.n_layers} a step: forward and recompute); "
          f"{time.perf_counter() - t0:.1f} s")
    for name in DIFFUSION_ARCHS:
        t0 = time.perf_counter()
        arch = get_arch(name)
        rep_c, recs = train_bf16(torch, gen, arch, "train_256", DIFF_PROBE_BATCHES, recording_train_calls, "latents", 1)
        n = read()
        k3 = sum(sum(r.attns.values()) for r in recs)
        k1 = sum(sum(r.convs.values()) for r in recs)
        check(n[2] == k3 and n[0] == k1 and n[1] == sum(k1_dgrads(r) for r in recs),
              f"{name}'s bf16 steps launched {n}, recorded K1 {k1}, K3 {k3}")
        report[name]["bfloat16"] = rep_c
        rep_1024, recs = one_step_at_fit(torch, gen, arch, "train_1024", DIFF_1024_PROBES, recording_train_calls,
                                         TRAIN_1024_BATCH)
        n = read()
        check(n[2] == sum(sum(r.attns.values()) for r in recs) and n[0] == sum(sum(r.convs.values()) for r in recs),
              f"{name}'s train_1024 steps launched {n}")
        k3_t = sorted({sig[0][2] for r in recs for sig in r.attns})
        print(f"    K3 at T = {k3_t} in train_1024")
        report[name]["train_1024"] = dict(rep_1024, k3_t=k3_t)
        print(f"  {name} bf16: {time.perf_counter() - t0:.1f} s")

    # (d) DeepSeek-V3's loss_fn with MTP at full width
    t0 = time.perf_counter()
    report["deepseek-v3-mtp"] = mtp_pass(torch, gen, get_arch("deepseek-v3-671b"), read, zero)
    print(f"  deepseek-v3 MTP: {time.perf_counter() - t0:.1f} s")
    phase_s = time.perf_counter() - phase_t0
    print(f"  phase 16: {phase_s:.1f} s")
    report["phase_s"] = phase_s
    return report, launches


def chunked_quantiles(torch, g, ref, expert_axis=None) -> dict:
    """The median and p99 of |g - ref| over a leaf, bounded from above by
    the largest of each over chunks along its first axis (an expert, where
    ``expert_axis`` names the leaf's expert axis; rows of <= 2^26 elements
    otherwise): if no chunk has more than 1 % of its elements above x, the
    leaf has not either.  A sort of a whole expert leaf (3.8e9 elements)
    would not fit the card.  Also the largest |diff| and ``ref``'s largest
    |value|."""
    ref = torch.zeros_like(g) if ref is None else ref
    if g.dim() >= 2 and g.shape[0] == 1:  # a stack of one layer (the trunk's dense layer, the MTP module)
        g, ref = g[0], ref[0]
    if expert_axis is not None:
        g, ref = g.movedim(expert_axis, 0), ref.movedim(expert_axis, 0)
    step = 1 if expert_axis is not None else max(1, (1 << 26) // max(1, g[0].numel()))
    out = dict(median=0.0, p99=0.0, max=0.0, max_abs_grad=0.0)
    for i in range(0, g.shape[0], step):
        a, r = (x[i:i + step].reshape(-1) for x in (g, ref))
        d = (a.float() - r.float()).abs()
        med, p99 = abs_quantiles(torch, d)
        out = dict(median=max(out["median"], med), p99=max(out["p99"], p99), max=max(out["max"], d.max().item()),
                   max_abs_grad=max(out["max_abs_grad"], r.float().abs().max().item()))
    return out


@contextlib.contextmanager
def pinned_routes(ids: list):
    """While entered, each MoE layer (in call order, ``ids`` repeating) takes
    the experts ``ids`` gives it, their gates from its own router
    probabilities renormalised as ``moe.router_topk`` does: two passes then
    route alike, and what differs between them is not a flipped near-tie."""
    from repro_torch.models import moe

    real, calls = moe.router_topk, [0]

    def router_topk(p, cfg, x):
        _, _, probs = real(p, cfg, x)
        chosen = ids[calls[0] % len(ids)]
        calls[0] += 1
        gates = probs.gather(1, chosen)
        return (gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)).to(x.dtype), chosen, probs

    moe.router_topk = router_topk
    try:
        yield
    finally:
        moe.router_topk = real


def mtp_pass(torch, gen, ds, read, zero) -> dict:
    """(d): DeepSeek-V3 at full width with 1 dense trunk layer, no MoE trunk
    layer and the MTP module (an MoE block of 256 experts), bfloat16, one
    ``loss_fn`` and its gradient at 1 x MTP_TOKENS tokens through the
    kernels.  Held: every gradient finite, the MTP block's expert and
    attention leaves non-zero; against the same pass with plain attention
    (route aware): a forward with its own routes, every metric within
    BF16_RTOL and the tokens whose kept experts differ counted; then, with
    the kernels' pass's experts (``pinned_routes``), once per MTP_GROUPS
    group of leaves (one group's gradient beside the kernels' whole one fits
    the card), leaf by leaf the median and p99 of |diff| within BF16_RTOL x
    the leaf's largest |gradient| (``chunked_quantiles``)."""
    from repro_torch.models import transformer_lm as lm

    cfg = dataclasses.replace(ds.cfg, n_layers=1, first_k_dense=1)
    params = lm.init(gen, cfg, torch.bfloat16)
    named = named_leaves(params)
    n_params = sum(t.numel() for _, t in named)
    tokens = torch.randint(0, cfg.vocab, (1, MTP_TOKENS + 1), generator=gen, device=gen.device).to(torch.int32)
    x, y = tokens[:, :-1], tokens[:, 1:]

    def loss_and_grads(leaves):
        for _, t in named:
            t.requires_grad_(any(t is u for u in leaves))
        loss, metrics = lm.loss_fn(params, cfg, x, y)
        return {k: v.item() for k, v in metrics.items()}, torch.autograd.grad(loss, leaves, allow_unused=True)

    torch.cuda.reset_peak_memory_stats()
    zero()
    with RouteRecorder() as rec:
        metrics, grads = loss_and_grads([t for _, t in named])
        torch.cuda.synchronize()
    got = read()
    ids, routes = [layer["ids"] for layer in rec.layers], rec.host()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grads = {name: torch.zeros_like(t) if g is None else g for (name, t), g in zip(named, grads)}
    print(f"deepseek-v3-671b loss_fn with MTP at full width: 1 dense trunk layer, no MoE trunk layer, the MTP module "
          f"(an MoE block of {cfg.moe.n_experts} experts): {n_params / 1e9:.2f} B parameters, bf16, 1 x {MTP_TOKENS} "
          f"tokens: " + ", ".join(f"{k} {v:.5g}" for k, v in metrics.items())
          + f" (load_balance is the trunk's: it has no MoE layer, and the MTP block's is not counted, as JAX's); "
          f"K3 launches {got[2]}; peak memory {peak_gb:.2f} GB. No AdamW step: its moments "
          f"({2 * 2 * n_params / 1e9:.0f} GB in bf16) do not fit beside the parameters and gradients")
    check(got[2] == 3, f"the MTP pass launched K3 {got[2]} times: expected the trunk layer's forward and recompute "
                       f"and the MTP block's once")
    check(all(math.isfinite(v) for v in metrics.values()) and set(metrics) == {"ce", "load_balance", "mtp", "total"},
          f"bad MTP metrics {metrics}")
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()), "a non-finite MTP-pass gradient")
    block = [n for n in grads if n.startswith("/mtp/block/ffn/experts") or n.startswith("/mtp/block/attn")]
    check(bool(block) and all(grads[n].abs().max().item() > 0 for n in block),
          f"an MTP block leaf got a zero gradient: {[n for n in block if grads[n].abs().max().item() == 0]}")
    # plain attention with its own routes: the metrics, and the tokens whose kept experts differ
    zero()
    with RouteRecorder() as prec, torch.no_grad():
        plain_metrics = {k: v.item() for k, v in with_plain_attention(lambda: lm.loss_fn(params, cfg, x, y))[1].items()}
    check(read() == (0, 0, 0), "the plain MTP pass launched a kernel")
    flipped = int(np.any([(np.sort(np.where(r["keep"], r["ids"], -1), 1)
                           != np.sort(np.where(p["keep"], p["ids"], -1), 1)).any(1)
                          for r, p in zip(routes, prec.host())], axis=0).sum())
    for k in metrics:
        check(abs(metrics[k] - plain_metrics[k]) <= BF16_RTOL * max(abs(plain_metrics[k]), 1.0),
              f"MTP metric {k}: K3 {metrics[k]} against plain attention {plain_metrics[k]}")
    # its gradients on the kernels' routes, a group of leaves at a time
    rows = []
    for group in MTP_GROUPS:
        names = [n for n, _ in named if (n == "/" + group if group else
                                          all(n != "/" + g for g in MTP_GROUPS if g))]
        with pinned_routes(ids):
            _, pgrads = with_plain_attention(lambda: loss_and_grads([dict(named)[n] for n in names]))
        torch.cuda.synchronize()
        check(read() == (0, 0, 0), "the plain MTP pass launched a kernel")
        for name, pg in zip(names, pgrads):
            axis = 0 if "/experts/" in name else None  # [256, ...] past the stack: held expert by expert
            rows.append(dict(leaf=name, **chunked_quantiles(torch, grads[name], pg, axis)))
        del pgrads
    worst = max(rows, key=lambda r: max(r["median"], r["p99"]) / max(r["max_abs_grad"], 1e-30))
    share = max(worst["median"], worst["p99"]) / max(worst["max_abs_grad"], 1e-30)
    print(f"  vs plain attention: metrics " + ", ".join(f"{k} {plain_metrics[k]:.5g}" for k in metrics)
          + f" (its own routes: tokens whose kept experts differ {flipped} of {MTP_TOKENS}); gradients with the "
          f"kernels' routes ({len(MTP_GROUPS)} passes, one a group of leaves), leaf by leaf, largest median / p99 "
          f"|diff| over the leaf's largest |gradient| {share:.3g} at {worst['leaf']} (median {worst['median']:.3g}, "
          f"p99 {worst['p99']:.3g}, largest |g| {worst['max_abs_grad']:.3g}; limit {BF16_RTOL})")
    check(share <= BF16_RTOL, f"the MTP pass's gradients drift from plain attention's at {worst}")
    del params, grads, named, rec, prec, ids
    settle(torch, "after the MTP pass")
    return dict(params_b=n_params / 1e9, tokens=MTP_TOKENS, metrics=metrics, plain_metrics=plain_metrics,
                k3_launches=got[2], peak_gb=peak_gb, flipped_tokens=flipped, worst_leaf=worst, worst_share=share,
                leaves_held=len(rows), adamw="not run: the moments do not fit")


def print_conv_holds(rows: list, label: str) -> None:
    """One line for a set of ``hold_conv_grad`` rows: how many, how many with
    a K1 dgrad, and the largest share of the limit, where."""
    def worst_share(r):
        return max(r[g]["limit_share"] for g in ("y", "dx", "dw", "db") if g in r)

    worst = max(rows, key=worst_share)
    plain = max(r[g]["plain_share"] for r in rows for g in ("y", "dx", "dw", "db") if g in r)
    print(f"  K1 and its Function held in {label} at {len(rows)} signatures ({sum(r['k1_dgrad'] for r in rows)} "
          f"with a K1 dgrad): largest share of the limit {worst_share(worst):.3g} at {worst['shape']} "
          f"k{worst['k']} s{worst['stride']} g{worst['groups']} (the plain version's own autograd: {plain:.3g})")


def plain_kernels():
    """The vision and diffusion models' convs and attention through K1's and
    K3's plain versions on the same device (``attention_plain``), then the
    kernels restored."""
    from repro_torch.kernels.conv2d import conv2d_ref

    return model_kernels(conv2d_ref, attention_plain)


# Phase 17 (``phase_scripts``): the script twins, called in-process at full
# width.  (d) runs
# train_fault_tolerant_torch on full-width ViT-L/16 (bf16, cls_224, remat)
# at SCRIPTS_TRAIN_BATCH images (for time: phase 15 trains the cell's 256),
# cut to SCRIPTS_TRAIN_STEPS steps with faults at SCRIPTS_FAULTS_AT and a
# checkpoint every SCRIPTS_CKPT_EVERY steps.  (e) walks
# precompute_plans_torch's --smoke lattices (3 x 3 halo, 3 scheme points).
SCRIPTS_TRAIN_BATCH, SCRIPTS_TRAIN_STEPS, SCRIPTS_FAULTS_AT, SCRIPTS_CKPT_EVERY = 128, 12, (5, 10), 4
SMOKE_LINK_SHIFTS, SMOKE_COMPUTE_SHIFTS = [-1, 0, 1], [-2, -1, 0]


def plan_k1_calls(plan, batch: int) -> int:
    """K1 launches of one ``run_plan`` forward of a HALP or mixed-scheme plan."""
    from repro_torch.core import SchemePlan

    return sum((scheme_calls(plan, batch)[0] if isinstance(plan, SchemePlan) else conv_shapes(plan, batch)).values())


def phase_scripts(torch) -> tuple[dict, dict, list, list]:
    """Phase 17: the script twins (``examples/*_torch.py``, ``tools/*_torch.py``)
    driven through their ``run`` / ``main`` functions at full width on the
    card, TF32 off: (a) quickstart at VGG-16 (224, width 1.0, batch 1),
    section 3 lossless; (b) serve_halp at VGG-16's full config (the curve,
    the admitted batch, 48 requests), the first served batch's logits
    recomputed through its plan and held to the single-device forward, and
    its served class ids to the single-device argmax; (c) replan_channel at
    full-width VGG-16 (its links x ``link_scale``), section 3 served,
    section 4 lossless; (d) train_fault_tolerant on
    ViT-L/16 through phase 15's ``cell_trainer``, the chaos run's final state
    bit-identical to the uninterrupted run's, K1's and K3's Functions held at
    its signatures in bfloat16; (e) precompute_plans_torch --smoke into a
    temporary store, check_torch --store --benchmarks exiting 0, one K2
    launch at each geometry its kernel pass probed, and a restarted
    controller serving every lattice point with 0 optimizer calls, each plan
    lossless through ``run_plan``.  Every K1 call the serving parts made is
    held to its plain version at its signature afterwards.  Returns the
    report, the launches of the twins' runs (holds excluded), and the K1 and
    K2 hold rows."""
    import tempfile

    import torch.nn.functional as F

    sys.path[:0] = [str(ROOT / "examples"), str(ROOT / "tools")]
    import check_torch
    import precompute_plans_torch
    import quickstart_torch
    import replan_channel_torch
    import serve_halp_torch
    import train_fault_tolerant_torch

    from repro_torch.analysis.kernel_check import plan_kernel_calls
    from repro_torch.configs import get as get_arch
    from repro_torch.core import PlanStore, ReplanController, plan_halp, plan_halp_topology, vgg16_geom
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.kernels.halo_conv import halo_conv2d_cuda
    from repro_torch.models import vgg
    from repro_torch.models.common import tree_leaves
    from repro_torch.spatial import run_plan

    phase_t0 = time.perf_counter()
    smi = nvidia_smi()
    print(f"phase 17 on {smi}: the script twins at full width")
    launches = {"conv2d": 0, "conv2d_backward": 0, "halo_conv2d": 0, "flash_attention": 0}
    report: dict = {"card": smi}

    def zero():
        conv2d_cuda.launches = conv2d_cuda.backward_launches = halo_conv2d_cuda.launches = 0
        flash_attention.launches = 0

    def read() -> tuple[int, int, int]:
        got = conv2d_cuda.launches, conv2d_cuda.backward_launches, flash_attention.launches
        launches["conv2d"] += got[0]
        launches["conv2d_backward"] += got[1]
        launches["flash_attention"] += got[2]
        return got

    def lossless(y, single, what: str) -> float:
        check(bool(torch.isfinite(y).all()) and y.shape == single.shape, f"{what}: non-finite or misshapen output")
        share = ((y - single).abs() / (TOL["float32"] * (1 + single.abs()))).max().item()
        check(share <= 1, f"{what} is not lossless against the single-device forward ({share:.3f} of the limit)")
        return share

    with recording_calls() as rec:
        # (a) quickstart at full-width VGG-16
        t0 = time.perf_counter()
        zero()
        qs = quickstart_torch.run("cuda", vgg.FULL)
        got = read()
        plan = plan_halp(vgg.FULL.geom(), overlap_rows=4)
        want = sum(g.kind == "conv" for g in plan.net.layers) + plan_k1_calls(plan, 1)
        check(got[0] == want, f"quickstart launched K1 {got[0]} times, its two forwards make {want} calls")
        report["quickstart"] = dict(lossless=qs["lossless"], k1_launches=got[0], s=time.perf_counter() - t0)
        print(f"  (a) quickstart at VGG-16 224 x 224 width 1.0, batch 1: run_plan vs vgg.features max |diff| "
              f"{qs['lossless']['max_abs_err']:.3g} (largest |y| {qs['lossless']['ref_max_abs']:.3g}); K1 launches "
              f"{got[0]}; {report['quickstart']['s']:.1f} s")

        # (b) serve_halp at VGG-16's full config
        t0 = time.perf_counter()
        cfg = get_arch("vgg16").cfg
        zero()
        sv = serve_halp_torch.run(48, 2000.0, "cuda", cfg)
        got = read()
        batch = sv["max_batch"]
        check(batch >= 1, f"serve_halp's admission shed at full width: curve {sv['curve_s']}")
        stats = sv["stats"]
        check(stats["completed"] == 48, f"serve_halp completed {stats['completed']} of 48 requests")
        per_fwd = plan_k1_calls(sv["plan"], 1)
        calls = len(serve_halp_torch.CURVE_BATCHES) * (serve_halp_torch.CURVE_CALLS + 1) + math.ceil(48 / batch)
        check(got[0] == per_fwd * calls, f"serve_halp launched K1 {got[0]} times, {calls} forwards make "
              f"{per_fwd * calls}")
        # the engine serves class ids: recompute the first batch's logits
        # through the same plan (K1, not counted) and hold them and the served
        # ids to the single-device forward
        first = sv["images"][:batch]
        single = vgg.apply(sv["params"], cfg, first)
        share = lossless(vgg.head(sv["params"], run_plan(sv["plan"], sv["params"]["features"], vgg.apply_layer,
                                                        first)), single, "serve_halp's first served batch")
        picked = single.gather(1, sv["classes"][:batch, None])[:, 0]
        slack = 2 * TOL["float32"] * (1 + single.abs().max(dim=-1).values)
        check(bool((picked >= single.max(dim=-1).values - slack).all()),
              f"serve_halp served classes {sv['classes'][:batch].tolist()}, the single-device argmax is "
              f"{single.argmax(dim=-1).tolist()}")
        report["serve_halp"] = dict(curve_ms={b: t * 1e3 for b, t in sv["curve_s"].items()}, max_batch=batch,
                                    requests_per_s=sv["requests_per_s"], wall_s=sv["wall_s"], **stats,
                                    es_gflops={es: r / 1e9 for es, r in sv["es_rates"].items()},
                                    first_batch_share=share, k1_launches=got[0], s=time.perf_counter() - t0)
        print(f"  (b) serve_halp at VGG-16's full config: latency curve (ms) "
              f"{ {b: round(t * 1e3, 3) for b, t in sv['curve_s'].items()} }, admitted max_batch {batch}; "
              f"48 requests in {sv['wall_s']:.3f} s ({sv['requests_per_s']:.1f} req/s), p50 "
              f"{stats['p50_latency_s'] * 1e3:.1f} ms, p99 {stats['p99_latency_s'] * 1e3:.1f} ms, deadlines met "
              f"{stats['deadline_met_frac']:.3f}; per-ES GFLOP/s "
              f"{ {es: round(r / 1e9, 1) for es, r in sv['es_rates'].items()} } (one window of 48 requests, "
              f"under the call recorder); first batch's logits within {share:.3f} of the limit, its class ids "
              f"the single-device argmax; K1 launches {got[0]}")
        del sv, single

        # (c) replan_channel at full-width VGG-16
        t0 = time.perf_counter()
        zero()
        rc = replan_channel_torch.run("cuda", vgg.FULL)
        scale = replan_channel_torch.link_scale(vgg.FULL.geom())
        got = read()
        served = rc["serving"]
        check(served["batch0"] >= 1, "replan_channel's admission shed at full width")
        check(served["stats"]["completed"] == replan_channel_torch.N_SERVED,
              f"replan_channel served {served['stats']['completed']} requests")
        want = (plan_k1_calls(served["plan"], 1) * math.ceil(replan_channel_torch.N_SERVED / served["batch0"])
                + sum(g.kind == "conv" for g in vgg.FULL.geom().layers) + plan_k1_calls(rc["lossless"]["plan"], 1))
        check(got[0] == want, f"replan_channel launched K1 {got[0]} times, its forwards make {want} calls")
        st = rc["replay"]["stats"]
        report["replan_channel"] = dict(
            link_scale=scale, static_mean_ms=rc["replay"]["static_mean"] * 1e3,
            adaptive_mean_ms=rc["replay"]["adaptive_mean"] * 1e3, stats=st, batch0=served["batch0"],
            batch1=served["batch1"], calibration=served["calibration"], served=served["stats"],
            serve_wall_s=served["wall_s"], lossless_max_abs_err=rc["lossless"]["max_abs_err"],
            rows=rc["lossless"]["rows"], k1_launches=got[0], s=time.perf_counter() - t0)
        print(f"  (c) replan_channel at full-width VGG-16, links x{scale:g}: mean makespan static "
              f"{rc['replay']['static_mean'] * 1e3:.3f} ms, adaptive {rc['replay']['adaptive_mean'] * 1e3:.3f} ms "
              f"({st['replans']} switches, {st['optimizer_calls']} optimizer calls); "
              f"admitted batch {served['batch0']} -> {served['batch1']} after the collapse, calibration "
              f"{served['calibration']:.3f}, {served['stats']['completed']} served in {served['wall_s']:.3f} s; "
              f"adaptive plan {rc['lossless']['rows']} lossless, max |diff| {rc['lossless']['max_abs_err']:.3g}; "
              f"K1 launches {got[0]}")
        del rc

    # every K1 call signature of (a)-(c), held to the plain version (untimed)
    hgen = torch.Generator(device="cuda").manual_seed(17)
    k1_holds = [dict(hold_conv(torch, F, hgen, sig, timed=False), calls=c, path="scripts")
                for sig, c in sorted(rec.convs.items(), key=str)]
    print(f"  K1 held at the {len(k1_holds)} call signatures of (a)-(c): largest |err| "
          f"{max(r['max_abs_err'] for r in k1_holds):.3g}")
    report["k1_signatures"] = len(k1_holds)

    # (d) train_fault_tolerant on full-width ViT-L/16 through phase 15's trainer
    t0 = time.perf_counter()
    vit = with_batch(get_arch("vit-l16"), SCRIPTS_TRAIN_BATCH)

    def factory(arch, cell, fault_cfg, fault_hook=None):
        return cell_trainer(torch, vit, fault_cfg, cell, fault_hook=fault_hook)

    zero()
    with recording_train_calls() as trec:
        tr = train_fault_tolerant_torch.run(SCRIPTS_TRAIN_STEPS, "vit-l16", "cuda", SCRIPTS_FAULTS_AT,
                                            SCRIPTS_CKPT_EVERY, trainer_factory=factory)
    got = read()
    ref, chaos = tr["reference"], tr["chaos"]
    equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(tr["reference_state"]), tree_leaves(tr["chaos_state"])))
    replays = sum(f - f // SCRIPTS_CKPT_EVERY * SCRIPTS_CKPT_EVERY for f in SCRIPTS_FAULTS_AT)
    steps_run = 2 * SCRIPTS_TRAIN_STEPS + replays
    check(tr["ok"] and equal and chaos.losses == ref.losses,
          "the chaos run's final state is not bit-identical to the uninterrupted run's")
    check(chaos.failures == chaos.restores == len(SCRIPTS_FAULTS_AT) and tr["injected"] == list(SCRIPTS_FAULTS_AT),
          f"the chaos run counted {chaos.failures} failures, {chaos.restores} restores, injected {tr['injected']}")
    check(all(math.isfinite(v) for v in ref.losses), f"a non-finite loss {ref.losses}")
    per_step = [a + b for a, b in zip(VISION_LAUNCHES["vit-l16"], REMAT_LAUNCHES["vit-l16"])]  # forward, recompute
    check(got[0] == steps_run * per_step[0] and got[2] == steps_run * per_step[2],
          f"the twin's {steps_run} steps launched K1 {got[0]} / K3 {got[2]} times, {per_step} a step")
    grad_rows = [hold_conv_grad(torch, hgen, sig) for sig in sorted(trec.convs, key=str)]
    attn_rows = [hold_attention_grad(torch, hgen, *shape, dname) for shape, s, dname, causal in sorted(trec.attns)]
    check(grad_rows and attn_rows and all(r["dtype"] == "bfloat16" and r["shape"][0] == SCRIPTS_TRAIN_BATCH
                                          for r in grad_rows),
          f"the twin's steps were not bf16 at batch {SCRIPTS_TRAIN_BATCH}: {sorted(trec.convs, key=str)}")
    print_conv_holds(grad_rows, f"bfloat16 at batch {SCRIPTS_TRAIN_BATCH}")
    for row in attn_rows:
        print(f"  K3's Function held in bfloat16 at [{row['b']}, {row['h']}, {row['t']}, {row['d']}]: max_err "
              f"{row['max_abs_err']:.3g} (share {row['limit_share']:.3g})")
    report["train_fault_tolerant"] = dict(
        arch="vit-l16", cell="cls_224", dtype="bfloat16", batch=SCRIPTS_TRAIN_BATCH, steps=SCRIPTS_TRAIN_STEPS,
        faults_at=list(SCRIPTS_FAULTS_AT), ckpt_every=SCRIPTS_CKPT_EVERY, failures=chaos.failures,
        restores=chaos.restores, steps_run=steps_run, bit_identical=equal, losses=ref.losses,
        ema_step_ms=ref.ema_step_s * 1e3, k1_launches=got[0], k3_launches=got[2],
        reduced=dict(batch=f"{SCRIPTS_TRAIN_BATCH} of the cell's 256 (for time; phase 15 trains at the cell's)",
                     steps=f"{SCRIPTS_TRAIN_STEPS} of the script's 120",
                     faults=f"{list(SCRIPTS_FAULTS_AT)} for the script's [37, 83]",
                     ckpt_every=f"{SCRIPTS_CKPT_EVERY} for the script's 20"),
        s=time.perf_counter() - t0)
    print(f"  (d) train_fault_tolerant on ViT-L/16 at full width, cls_224, bf16 (reduced: "
          f"{report['train_fault_tolerant']['reduced']}): losses {ref.losses[0]:.4f} -> {ref.losses[-1]:.4f}, ema "
          f"step {ref.ema_step_s * 1e3:.1f} ms; chaos run {chaos.failures} failures, {chaos.restores} restores, "
          f"final state bit-identical: {equal}; {steps_run} steps run, K1 {got[0]}, K3 {got[2]} launches; "
          f"{report['train_fault_tolerant']['s']:.1f} s")
    del tr
    torch.cuda.empty_cache()

    # (e) precompute_plans_torch --smoke, check_torch --store --benchmarks,
    # then a restarted controller serving every lattice point through K1
    t0 = time.perf_counter()
    k2_rows = []
    with tempfile.TemporaryDirectory() as d:
        store_path = os.path.join(d, "plans.sqlite")
        pre = precompute_plans_torch.main(["--store", store_path, "--smoke"])
        check(pre["base"]["lattice_points"] == len(SMOKE_LINK_SHIFTS) * len(SMOKE_COMPUTE_SHIFTS)
              and pre["scheme"]["store_entries"] == pre["base"]["lattice_points"] + pre["scheme"]["lattice_points"],
              f"precompute_plans_torch --smoke filled {pre}")
        zero()
        rc_check = check_torch.main(["--store", store_path, "--benchmarks"])
        check(rc_check == 0, f"check_torch --store --benchmarks exited {rc_check}")
        check(halo_conv2d_cuda.launches == 0 and conv2d_cuda.launches == 0, "the static checker launched a kernel")
        # one K2 launch at each geometry check_torch's kernel pass probed
        topo = precompute_plans_torch.demo_topology()
        calls = {}
        for net in (precompute_plans_torch.demo_net(), vgg16_geom()):
            calls.update(plan_kernel_calls(plan_halp_topology(net, topo)))
        zero()
        k2_rows = probe_k2(torch, calls, hgen)
        launches["halo_conv2d"] += halo_conv2d_cuda.launches
        check(k2_rows and halo_conv2d_cuda.launches == len(k2_rows), f"K2 probe launches {halo_conv2d_cuda.launches}")
        cfg = vgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10)
        check(cfg.geom() == precompute_plans_torch.demo_net(), "the store's net is not the thin VGG-16")
        params = vgg.init(torch.Generator(device="cuda").manual_seed(17), cfg)
        x = torch.randn((MAX_BATCH, cfg.img_res, cfg.img_res, cfg.in_channels), generator=hgen, device="cuda")
        single = vgg.features(params, cfg, x)
        served, shares, optimizer_calls = 0, [], 0
        with PlanStore(store_path) as store:
            for config, links, computes in (
                    (precompute_plans_torch.demo_config(), SMOKE_LINK_SHIFTS, SMOKE_COMPUTE_SHIFTS),
                    (precompute_plans_torch.demo_scheme_config(), SMOKE_LINK_SHIFTS, [0])):
                ctl = ReplanController(cfg.geom(), topo, config, store=store)
                keys = precompute_plans_torch.lattice_keys(ctl, links, computes)
                for key in keys:
                    plan = ctl.prime(key).plan
                    zero()
                    y = run_plan(plan, params["features"], vgg.apply_layer, x)
                    got = read()
                    check(got[0] == plan_k1_calls(plan, MAX_BATCH), f"a stored plan launched K1 {got[0]} times")
                    shares.append(lossless(y, single, f"the stored plan at {key}"))
                    served += 1
                optimizer_calls += ctl.optimizer_calls
                check(ctl.optimizer_calls == 0 and ctl.cache.store_hits == len(keys),
                      f"the restarted controller optimised {ctl.optimizer_calls} times, {ctl.cache.store_hits} "
                      f"store hits for {len(keys)} points")
        check(served == pre["scheme"]["store_entries"], f"served {served} of {pre['scheme']['store_entries']} points")
    report["precompute_check"] = dict(
        lattice_points=served, store_entries=pre["scheme"]["store_entries"], check_exit=rc_check,
        k2_probe_launches=len(k2_rows), k2_max_abs_err=max(r["max_abs_err"] for r in k2_rows),
        served_optimizer_calls=optimizer_calls, largest_lossless_share=max(shares), s=time.perf_counter() - t0)
    print(f"  (e) precompute_plans_torch --smoke: {served} lattice points; check_torch --store --benchmarks exit "
          f"{rc_check}; K2 launched once at each of {len(k2_rows)} probed geometries (max |err| "
          f"{report['precompute_check']['k2_max_abs_err']:.3g}); a restarted controller served all {served} with "
          f"{optimizer_calls} optimizer calls, each plan lossless through K1 (largest share {max(shares):.3g})")
    phase_s = time.perf_counter() - phase_t0
    print(f"  phase 17: {phase_s:.1f} s")
    report["phase_s"] = phase_s
    report["launches"] = dict(launches)
    return report, launches, k1_holds, k2_rows


def main() -> int:
    # phase 16 holds several full-width train states at once: segments that
    # grow keep the allocator's cache from splintering the card's 80 GB
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    started = time.perf_counter()
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
        if name.startswith("attention"):
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # K3's two libraries: attention.cu's 5 width pairs, attention_diffusion.cu's 4
    k3_regs = k3_ptxas(_build.build_logs().get("attention", "") + _build.build_logs().get("attention_diffusion", ""))
    check(len(k3_regs) == 108, f"ptxas reported {len(k3_regs)} K3 instantiations, expected 108")
    for r in k3_regs:
        print(f"  attention: flash_fwd {r['dtype']:8s} ({r['dqk']}, {r['dv']}) {r['copies']:7s} {r['block']}: "
              f"{r['registers']} registers, {r['spill_store_bytes']} / {r['spill_load_bytes']} bytes spill "
              f"stores / loads")

    # -- 3. the kernel against its plain version, on the card -----------------
    clock = time.perf_counter()

    def lap(label: str) -> None:
        """Prints the seconds since the last lap, as the later phases do."""
        nonlocal clock
        now = time.perf_counter()
        print(f"  {label}: {now - clock:.1f} s")
        clock = now

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
                  f"S={config['splits']} {conv_how(config)}: "
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

    lap("phase 3")

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

    lap("phase 3b")

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

    lap("phase 3c")

    # -- 4. the main path: full-width VGG-16 served through the HALP plan -----
    conv2d_cuda.launches = 0
    out = serve("vgg16", n_requests=N_REQUESTS, max_batch=MAX_BATCH, device="cuda", seed=0)
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

    lap("phase 4")

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

    lap("phase 5")

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

    lap("phase 6a")

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

    lap("phase 6b")

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
    leaves = tree_leaves(lparams)
    check([(tuple(t.shape), t.dtype) for t in leaves] == tree_leaves(prefill.state),
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

    # -- 13. the vision family served at full width ----------------------------
    vision_report, vision_launches, vision_conv_rows, vision_attn_rows = phase_vision(torch)

    # -- 14. diffusion generation at full width -------------------------------
    diff_report, diff_launches, diff_conv_rows, diff_attn_rows = phase_diffusion(torch)

    # -- 15. vision training through configs.steps' cls_224 cells -------------
    train_report, train_launches = phase_train(torch)

    # -- 16. LM and diffusion training through configs.steps' train cells -----
    lmd_report, lmd_launches = phase_lm_diffusion_train(torch)

    # -- 17. the script twins at full width ------------------------------------
    scripts_report, scripts_launches, scripts_k1_holds, scripts_k2_rows = phase_scripts(torch)

    # -- 18. the parallel modules and the dry run -----------------------------
    parallel_report, parallel_launches = phase_parallel(torch)

    # -- 19. the kernels' sharding rules on a mesh emulated on the card ---------
    coll_report, coll_launches = phase_collectives(torch)

    # -- 20. the LM cells at their own length, 32,768 tokens ------------------
    long_report, long_launches = phase_lm_long(torch)

    # -- result --------------------------------------------------------------
    # each kernel's numbers summed over one forward of every main path that
    # launches it: run_plan (phase 4) and the two spatial layouts (phase 5);
    # launches also count phase 10's path
    main_rows = [r for r in rows if r["per_forward"] and r["dtype"] == "float32"]
    fix_rows = [r for r in main_rows if r["path"] == "weighted-fixup"]
    main_rows += engines_holds
    vision_main = [r for r in vision_conv_rows if r["path"] == "b4-float32"]
    main_rows += vision_main
    diff_main = [r for r in diff_conv_rows if r["path"] == "b4-float32"]
    main_rows += diff_main
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
    attn_main += [r for r in vision_attn_rows if r["path"] == "b4-float32"]
    attn_main += [r for r in diff_attn_rows if r["path"] == "b4-float32"]
    kernels = [
        entry("conv2d", "src/repro_torch/kernels/conv2d/conv2d.cu",
              "src/repro/kernels/conv2d/conv2d.py:39", main_rows,
              launches + sum(v["launches"]["conv2d"] for v in spatial.values())
              + got_vit["conv2d"] + np_launches + serving_launches["conv2d"] + engines_launches["conv2d"]
              + replan_launches["conv2d"] + vision_launches["conv2d"] + diff_launches["conv2d"]
              + train_launches["conv2d"] + train_launches["conv2d_backward"] + lmd_launches["conv2d"]
              + lmd_launches["conv2d_backward"] + scripts_launches["conv2d"] + scripts_launches["conv2d_backward"]
              + parallel_launches["conv2d"] + parallel_launches["conv2d_backward"] + coll_launches["conv2d"]
              + coll_launches["conv2d_backward"]),
        entry("halo_conv2d", "src/repro_torch/kernels/halo_conv/halo_conv.cu",
              "src/repro/kernels/halo_conv/halo_conv.py:30", halo_main,
              sum(v["launches"]["halo_conv2d"] for v in spatial.values()) + serving_launches["halo_conv2d"]
              + scripts_launches["halo_conv2d"] + coll_launches["halo_conv2d"]),
        entry("flash_attention", "src/repro_torch/kernels/attention/attention.cu",
              "src/repro/kernels/attention/attention.py:20", attn_main,
              got_vit["flash_attention"] + lm_launches + decode_launches + moe_launches
              + sum(mla_launches.values()) + vision_launches["flash_attention"]
              + diff_launches["flash_attention"] + train_launches["flash_attention"]
              + lmd_launches["flash_attention"] + scripts_launches["flash_attention"]
              + parallel_launches["flash_attention"] + coll_launches["flash_attention"]
              + long_launches["flash_attention"]),
    ]
    # phase 15's backward: K1's launches in it, and per float32 step at batch
    # 4 the device ms of its parts; K3's plain backward at ViT's shape
    kernels[0]["backward"] = dict(launches=train_launches["conv2d_backward"] + lmd_launches["conv2d_backward"], **{
        name: {part: rep[name]["float32_step"]["device_ms_by_part"][part] for part in BACKWARD_RANGES[:3]}
        for rep, names in ((train_report, TRAIN_ARCHS), (lmd_report, ("unet-sd15",))) for name in names})
    k3_grad = train_report["vit-l16"]["k3_grad"]
    kernels[2]["backward"] = dict(per_step=k3_grad["per_step"], device_us=k3_grad["backward_device_us"],
                                  forward_device_us=k3_grad["forward_device_us"],
                                  vit_step_ms=train_report["vit-l16"]["float32_step"]["device_ms_by_part"]["K3 backward"])
    # phase 16: K3's plain backward a call at the LM's T = 4096 (causal GQA)
    # and the U-Net's T = 16384, with its bound and SDPA's forward + backward
    for row in lmd_report["k3_fn"]:
        if row["t"] in (4096, 16384):
            kernels[2]["backward"][row["label"]] = dict(
                device_us=row["backward_device_us"], bound_us=row["backward"]["bound_ms"] * 1e3,
                bound_by=row["backward"]["bound_by"], ffma_bound_us=row["backward"]["ffma_bound_ms"] * 1e3,
                forward_device_us=row["forward_device_us"], sdpa_fwd_bwd_device_us=row["sdpa_fwd_bwd_device_us"])
    kernels[2]["max_abs_err"] = max([kernels[2]["max_abs_err"]] + [r["o"]["max_abs_err"] for r in lmd_report["k3_fn"]
                                                                  if "o" in r])
    # phase 20: K3 at 32,768 tokens -- a layer's causal prefill call (one
    # sequence) and a decode step's call over the 32,768-slot cache -- beside
    # SDPA and the bound, device ms a call; the float32 holds of both in the
    # error
    kernels[2]["long"] = {name: dict(
        prefill={dname: {key: long_report[name]["k3_prefill"][dname][key] for key in (
            "b", "h", "hkv", "t", "block", "device_ms", "library_device_ms", "library_backend", "bound_ms", "bound_by",
            "max_abs_err")} for dname in ("float32", "bfloat16")},
        decode={"batch": long_report[name]["decode"]["batch"], **long_report[name]["decode"]["k3"]})
        for name in LONG_ARCHS}
    kernels[2]["max_abs_err"] = max([kernels[2]["max_abs_err"]]
                                    + [long_report[name]["k3_prefill"]["float32"]["max_abs_err"] for name in LONG_ARCHS]
                                    + [long_report[name]["decode"]["k3"]["max_abs_err"]["float32"]
                                       for name in LONG_ARCHS])
    # K1's depthwise branch on its own: ConvNeXt-B's and EfficientNet-B7's
    # float32 forwards at batch 4 (every vision hold, bf16 too, in its error)
    dw_main = [r for r in vision_main if r["groups"] > 1]
    kernels[0]["depthwise"] = dict(
        launches=vision_launches["conv2d_depthwise"],
        max_abs_err=max(r["max_abs_err"] for r in vision_conv_rows if r["groups"] > 1 and r["dtype"] == "float32"),
        bf16_max_abs_err=max(r["max_abs_err"] for r in vision_conv_rows
                             if r["groups"] > 1 and r["dtype"] == "bfloat16"),
        **{key: per_fwd(dw_main, key) for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        device_ms=per_fwd(dw_main, "device_us") / 1e3, library_device_ms=per_fwd(dw_main, "library_device_us") / 1e3,
        bound_by="operations" if per_fwd(dw_main, "ops_ms") >= per_fwd(dw_main, "bytes_ms") else "bytes")
    vision_per_forward = {}
    for name in VISION_ARCHS:
        rs = [r for r in vision_main if r["arch"] == name]
        vision_per_forward[name] = {
            part: {key: per_fwd([r for r in rs if (r["groups"] > 1) == (part == "K1 depthwise")], key)
                   for key in ("ms", "device_us", "plain_ms", "library_ms", "library_device_us", "bound_ms")}
            for part in ("K1 dense", "K1 depthwise")}
        vrs = [r for r in attn_main if r.get("arch") == name]
        if vrs:
            vision_per_forward[name]["K3"] = {key: per_fwd(vrs, key) for key in (
                "ms", "device_us", "plain_ms", "library_ms", "library_device_us", "bound_ms")}
        print(f"per float32 forward of {name} at batch {MAX_BATCH} (device_us: us): "
              f"{json.dumps(vision_per_forward[name])}")
    diffusion_per_forward = {}
    for name in DIFFUSION_ARCHS:
        keys = ("ms", "device_us", "plain_ms", "library_ms", "library_device_us", "bound_ms")
        diffusion_per_forward[name] = {
            "K1": {key: per_fwd([r for r in diff_main if r["arch"] == name], key) for key in keys},
            "K3": {key: per_fwd([r for r in attn_main if r.get("arch") == name], key) for key in keys}}
        print(f"per float32 forward of {name} at batch {MAX_BATCH}, 512 (device_us: us): "
              f"{json.dumps(diffusion_per_forward[name])}")
    # K1 and K3 at every diffusion call signature (bf16 and the samplers' too) add to the errors
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], max(r["max_abs_err"] for r in diff_conv_rows
                                                                    if r["dtype"] == "float32"))
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], max(r["max_abs_err"] for r in diff_attn_rows
                                                                    if r["dtype"] == "float32"))
    # phase 12's and 17's holds are untimed: they add to K1's and K2's
    # errors, not to their times
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], max(r["max_abs_err"] for r in replan_holds),
                                    max(r["max_abs_err"] for r in scripts_k1_holds))
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], max(r["max_abs_err"] for r in scripts_k2_rows))
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
        "engines": engines_report, "replan": replan_report, "vision": vision_report,
        "vision_conv_cases": vision_conv_rows, "vision_attention_cases": vision_attn_rows,
        "vision_per_forward": vision_per_forward, "diffusion": diff_report,
        "diffusion_conv_cases": diff_conv_rows, "diffusion_attention_cases": diff_attn_rows,
        "diffusion_per_forward": diffusion_per_forward, "train": train_report, "lm_diffusion_train": lmd_report,
        "scripts": scripts_report, "scripts_k1_holds": scripts_k1_holds, "scripts_k2_probe": scripts_k2_rows,
        "parallel": parallel_report, "collectives": coll_report, "lm_long": long_report,
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
                "phase 12's untimed holds at every shape its plans give K1.  Phase 13 adds to conv2d's "
                "sums one float32 forward at batch 4 of ViT-L/16 (1 call), Swin-B (1), ConvNeXt-B (40: 36 "
                "depthwise) and EfficientNet-B7 at 600 (163: 55 depthwise), and to flash_attention's one "
                "of ViT-L/16 (24 calls, T = 197); its launches count the 4 served batches of each, its "
                "counted float32 and bfloat16 forwards at batch 4, serve_b1, serve_b128 and ConvNeXt at "
                "layer_scale 1.0; conv2d's depthwise entry sums the depthwise calls alone.  Phase 14 adds "
                "to both kernels' sums one float32 forward at batch 4 and 512 (latent 64) of UNet-SD1.5 "
                "(66 K1 calls, 32 K3 at D = 40 / 80 / 160) and DiT-XL/2 (1 K1, 28 K3 at D = 72); its "
                "launches count each model's counted float32 and bfloat16 forwards at batch 4, gen_fast "
                "(bf16, batch 16, 4 steps) and gen_1024 (bf16, batch 4, 2 of its 50 steps); max_abs_err "
                "covers its float32 holds at every signature (bf16 errors are in chip_smoke.json).  Phase 15 "
                "adds to the launches those of its training steps (ViT-L/16, Swin-B, ConvNeXt-B and EfficientNet-B7: "
                "at cls_224 float32 steps at batch 4 (remat on and off), at cls_384 one, at each cell two probe "
                "steps and 4 timed and one profiled bf16 steps; "
                "and every step of the fault-injected pair, replays included), K1's forward and backward (its input gradients at "
                "stride 1) launches alike; conv2d's backward entry counts the backward ones and gives the "
                "backward's device ms by part in one profiled float32 step at batch 4 of each model, "
                "flash_attention's the device us of K3's plain backward at ViT's shape.  Phase 16 adds to the "
                "launches those of its LM and diffusion training (K3's Function holds are not counted; a "
                "checkpointed layer's kernels launch twice a step, forward and recompute): Qwen3-4B's float32 "
                "steps at 4 layers (remat on, off, the control) and its profiled step, the U-Net's and DiT's "
                "float32 steps at batch 4, their bfloat16 probe, timed and profiled steps (Qwen3-4B at 36 layers, "
                "the diffusion pair at train_256), the train_1024 probe and fitted steps, and DeepSeek-V3's MTP "
                "pass; conv2d's backward entry adds the U-Net's parts, flash_attention's backward entry the plain "
                "backward a call at T = 4096 causal and T = 16384 beside its bound and SDPA's forward + backward; "
                "flash_attention's max_abs_err covers the o of phase 16's Function holds.  Phase 17 adds to "
                "the launches those of the script twins' runs: quickstart's two forwards, serve_halp's latency "
                "curve and served batches, replan_channel's served batches and lossless forwards, the "
                "fault-tolerant pair's steps (replays included), one K2 launch per geometry check_torch's "
                "kernel pass probed, and one forward of every stored plan; conv2d's and halo_conv2d's "
                "max_abs_err cover its untimed holds.  Phase 18 adds to the launches those of its pipelined "
                "ViT-L/16 forwards (float32 and bfloat16: 8 K1, 216 K3 each), of the unpipelined blocks and "
                "whole-batch forwards it holds them to, of its timed runs, and of the three bundles it runs on "
                "the card beside the dry run.  Phase 19 adds the launches of its "
                "unsharded runs (ViT-L/16's train step, Qwen3-4B's prefill, the U-Net's forward under base and "
                "spatial2d, ConvNeXt-B's serve_b1 forward) and of their replays on the 8 emulated ranks: 8 K1, K2 "
                "or K3 launches for each unsharded call.  Since remat in the vision models, a train step of "
                "ViT-L/16 launches K3 48 times (24 recomputed) and one of ConvNeXt-B K1 67 times (27 depthwise "
                "recomputed); phase 15 trains all four vision models at cls_224 and cls_384 (counted: their float32 "
                "steps at batch 4, remat on and off, the probes, the timed and profiled bfloat16 steps).  Phase 20 "
                "adds to flash_attention's launches those of its LM prefills (the 4-layer probes and holds, the "
                "full-depth prefill) and decode steps at 32,768 tokens; flash_attention's long entry gives K3's "
                "device ms a call there (one sequence's causal prefill call; a decode step's call over the "
                "32,768-slot cache) beside SDPA's and the bound, and its max_abs_err covers the float32 holds.",
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    check(all(math.isfinite(v) for e in kernels for v in tree_leaves(e) if isinstance(v, float)),
          f"a non-finite number in the kernels line: {kernels}")
    print(json.dumps({"phase17": {k: scripts_report[k] for k in (
        "card", "quickstart", "serve_halp", "replan_channel", "train_fault_tolerant", "precompute_check", "launches",
        "phase_s")}}))
    print(json.dumps({"phase18": parallel_report}))
    print(json.dumps({"phase19": coll_report}))
    print(json.dumps({"phase20": {name: {key: long_report[name][key] for key in ("prefill", "decode")}
                                  for name in LONG_ARCHS}}))
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
