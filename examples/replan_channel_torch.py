"""Online channel-adaptive re-partitioning in one script, on the port.

The PyTorch port's twin of ``examples/replan_channel.py`` (same sections and
printed lines, over ``repro_torch``; no ``jax``, no ``repro``), plus
``--device``:

1. replay a Gauss-Markov time-variant channel through the DES: one offline
   nominal-rate plan (the paper's deployment) vs the cached adaptive
   re-planner (``repro_torch.core.replan``),
2. plan-cache amortisation: steady-state plan requests are O(1) lookups,
3. serving integration: the batcher feeds measured latencies back and
   ``plan_aware_batch_size`` re-admits against the *current* plan,
4. losslessness: the adaptive plan's distributed forward (K1 through
   ``run_plan`` on the card) equals the single-device forward.

    PYTHONPATH=src python examples/replan_channel_torch.py
    PYTHONPATH=src python examples/replan_channel_torch.py --device cpu

Sections 1-2 are host arithmetic over the configuration's geometry.  Every
link rate of the script (nominal, trace and collapse) is for the thin
model; :func:`run` at another configuration scales them by
:func:`link_scale`, the ratio of its feature bytes a row to the thin
model's, so that a row crosses a link in the time it takes in the demo
(x28 for full-width VGG-16, which ``chip_smoke.py`` runs: on the demo's
Mbps links every plan of it misses the 4/30 s deadline).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AGX_XAVIER,
    CollabTopology,
    GaussMarkovTrace,
    Link,
    OffloadChannel,
    ReplanConfig,
    ReplanController,
    StaticPlanner,
    optimize_static,
    replay_rate_trace,
)
from repro_torch.core.reliability import IMAGE_BYTES  # noqa: E402
from repro_torch.models import vgg  # noqa: E402
from repro_torch.runtime.serve import BatchingEngine, ServeConfig, plan_aware_batch_size  # noqa: E402
from repro_torch.spatial import run_plan  # noqa: E402

# A thin VGG-16 (64x64, 1/8 width) so the whole demo runs in seconds on CPU;
# Mbps-grade edge links make the schedule communication-dominated, which is
# exactly where adapting the partition to the measured channel pays off.
DEMO = vgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10)
NOMINAL = 120e6
N_EPOCHS, N_TASKS = 36, 4
N_SERVED = 12
RTOL = ATOL = 2e-5  # the JAX script's losslessness check


def link_scale(net) -> float:
    """``net``'s feature bytes a row over the thin model's: 1 for ``DEMO``,
    28 for full-width VGG-16 (3.5x the width, 8x the channels)."""
    def row_bytes(g) -> float:
        return sum(g.feature_bytes(i, rows=1) for i in range(len(g.layers)))

    return row_bytes(net) / row_bytes(DEMO.geom())


def topology(scale: float = 1.0) -> CollabTopology:
    return CollabTopology(
        host="e0",
        secondaries=("a", "b"),
        platforms={"e0": AGX_XAVIER, "a": AGX_XAVIER, "b": AGX_XAVIER},
        default_link=Link(NOMINAL * scale),
    )


def replan_config() -> ReplanConfig:
    return ReplanConfig(n_tasks=N_TASKS)


def b_share(plan) -> float:
    rows = plan.parts[0].out
    return rows["b"].rows / sum(seg.rows for seg in rows.values())


def channel_replay(net) -> dict:
    """Sections 1-2: the static and the adaptive plan replayed over one
    Gauss-Markov trace of secondary b's link, every rate times
    ``link_scale(net)``.  Returns every fourth epoch's row (epoch, b's rate,
    both makespans, b's share of the adaptive plan), both mean makespans,
    the controller's ``stats()`` and the controller."""
    scale = link_scale(net)
    topo, cfg = topology(scale), replan_config()
    nominal = NOMINAL * scale
    trace_b = GaussMarkovTrace(
        lo=30e6 * scale, hi=nominal, mean=50e6 * scale, corr=0.9, sigma_frac=0.1, start=nominal, seed=5,
    ).rates(N_EPOCHS)
    link_rates = {("e0", "b"): trace_b, ("b", "e0"): trace_b}

    static_plan = optimize_static(net, topo, cfg).plan
    static_run = replay_rate_trace(net, topo, StaticPlanner(static_plan), link_rates, n_tasks=N_TASKS)
    controller = ReplanController(net, topo, cfg)
    adaptive_run = replay_rate_trace(net, topo, controller, link_rates, n_tasks=N_TASKS)

    rows = [dict(epoch=a["epoch"], rate_b=s["rates"][("e0", "b")], static=s["makespan"],
                 adaptive=a["makespan"], b_share=b_share(a["plan"]))
            for s, a in zip(static_run, adaptive_run) if not a["epoch"] % 4]

    def mean(run):
        return sum(r["makespan"] for r in run) / len(run)

    return dict(rows=rows, static_mean=mean(static_run), adaptive_mean=mean(adaptive_run),
                stats=controller.stats(), controller=controller)


def serve_adaptive(controller: ReplanController, params, cfg: vgg.VGGConfig, device: torch.device) -> dict:
    """Section 3: serve ``N_SERVED`` requests on the controller's current
    plan at the admitted batch, feeding measured batch latencies back; then
    feed it a link collapse to 30 Mbps (times ``link_scale``) and re-admit.
    Request ``i``'s image comes from a generator seeded with ``i``.
    Returns both admitted batches, the engine's stats, the wall time, the
    calibration, the plan served and the served class ids (submission
    order); ``batch0`` 0 alone when admission sheds."""
    plan_now = controller.plan

    def model(batch: torch.Tensor) -> torch.Tensor:
        feats = run_plan(plan_now, params["features"], vgg.apply_layer, batch)
        return vgg.head(params, feats).argmax(dim=-1)

    channel = OffloadChannel(rate_bps=100e6, sigma_s=1e-3)
    batch0 = plan_aware_batch_size(controller, 4.0 / 30.0, channel, target=0.999, max_batch=8)
    if batch0 == 0:  # admission says shed: no batch meets the deadline target
        return dict(batch0=0)
    engine = BatchingEngine(model, ServeConfig(max_batch=batch0), observer=controller.observe_batch_latency)
    shape = (cfg.img_res, cfg.img_res, cfg.in_channels)
    for i in range(N_SERVED):
        # generous deadline for the served requests: the first batch pays any
        # one-off set-up, which is not the offload/inference path §V.D models
        gen = torch.Generator(device=device).manual_seed(i)
        engine.submit(torch.randn(shape, generator=gen, device=device), deadline_s=10.0)
    t0 = time.monotonic()
    serve_stats = engine.run_until_drained()
    wall = time.monotonic() - t0
    calibration = controller.stats()["calibration"]
    # the channel collapses: feed the controller the measured (slow) transfers and
    # re-admit -- the batch size follows the new plan's predicted makespan.
    collapsed = 30e6 * link_scale(cfg.geom())
    for _ in range(replan_config().hysteresis + 2):
        controller.observe_transfer("e0", "b", IMAGE_BYTES, 8.0 * IMAGE_BYTES / collapsed)
        controller.observe_transfer("b", "e0", IMAGE_BYTES, 8.0 * IMAGE_BYTES / collapsed)
        controller.step()
    batch1 = plan_aware_batch_size(controller, 4.0 / 30.0, channel, target=0.999, max_batch=8)
    classes = torch.stack([r.result for r in sorted(engine.completed, key=lambda r: r.rid)])
    return dict(batch0=batch0, batch1=batch1, stats=serve_stats, wall_s=wall, calibration=calibration,
                plan=plan_now, classes=classes)


def adaptive_lossless(controller: ReplanController, params, cfg: vgg.VGGConfig, device: torch.device) -> dict:
    """Section 4: the controller's current plan through ``run_plan`` against
    the single-device ``vgg.features`` on an image from a generator seeded
    with 99; raises if they part by more than ``ATOL + RTOL * |ref|``."""
    gen = torch.Generator(device=device).manual_seed(99)
    x = torch.randn((1, cfg.img_res, cfg.img_res, cfg.in_channels), generator=gen, device=device)
    plan = controller.plan
    ref = vgg.features(params, cfg, x)
    out = run_plan(plan, params["features"], vgg.apply_layer, x)
    err = (out - ref).abs()
    if tuple(out.shape) != tuple(ref.shape) or not bool((err <= ATOL + RTOL * ref.abs()).all()):
        raise AssertionError(f"adaptive plan parts from the single-device forward: max |diff| "
                             f"{err.max().item():.3g}")
    rows = {es: seg.rows for es, seg in plan.parts[0].out.items()}
    return dict(plan=plan, rows=rows, max_abs_err=err.max().item(), ref_max_abs=ref.abs().max().item())


def run(device: str | torch.device = "cuda", cfg: vgg.VGGConfig = DEMO) -> dict:
    """The four sections at ``cfg`` (the thin VGG-16 by default) with every
    link rate times ``link_scale(cfg.geom())``, sections 3 and 4 on
    ``device`` with parameters from a generator seeded with 0.  Section 4 is
    skipped (``lossless`` None) when section 3's admission sheds, as the JAX
    script stops there."""
    dev = resolve_device(device)
    replay = channel_replay(cfg.geom())
    controller = replay.pop("controller")
    params = vgg.init(torch.Generator(device=dev).manual_seed(0), cfg)
    served = serve_adaptive(controller, params, cfg, dev)
    lossless = adaptive_lossless(controller, params, cfg, dev) if served["batch0"] else None
    return dict(device=str(dev), replay=replay, serving=served, lossless=lossless, controller=controller,
                params=params)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run(args.device)

    replay = out["replay"]
    print("== channel replay: secondary b drifts 120 -> ~50 Mbps ==")
    print(f"{'epoch':>5s} {'b rate':>8s} {'static':>9s} {'adaptive':>9s} {'b share':>8s}")
    for r in replay["rows"]:
        print(
            f"{r['epoch']:5d} {r['rate_b']/1e6:6.0f}Mb "
            f"{r['static']*1e3:7.2f}ms {r['adaptive']*1e3:7.2f}ms "
            f"{r['b_share']*100:7.1f}%"
        )
    print(
        f"mean makespan: static {replay['static_mean']*1e3:.2f} ms, "
        f"adaptive {replay['adaptive_mean']*1e3:.2f} ms"
    )
    stats = replay["stats"]
    print(
        f"\n== plan cache == {stats['epochs']} epochs -> {stats['replans']} plan "
        f"switches, {stats['optimizer_calls']} optimizer calls, "
        f"hit rate {stats['cache_hit_rate']:.2f}"
    )
    served = out["serving"]
    if served["batch0"] == 0:
        raise SystemExit("admission returned 0 (shed): deadline infeasible on this plan")
    serve_stats = served["stats"]
    print(
        f"\n== serving == admitted batch {served['batch0']}; served {serve_stats['completed']} "
        f"requests in {served['wall_s']:.2f}s, deadline met "
        f"{serve_stats['deadline_met_frac']*100:.0f}%, calibration "
        f"{served['calibration']:.2f}"
    )
    batch1 = served["batch1"]
    print(
        f"after measured collapse to 30 Mbps: admitted batch {served['batch0']} -> {batch1}"
        + (" (0 = shed: nothing meets the deadline now)" if batch1 == 0 else "")
    )
    print("\n== losslessness: adaptive plan forward == single-device forward  OK ==")
    print("\nreplan_channel complete.")
    return out


if __name__ == "__main__":
    main()
