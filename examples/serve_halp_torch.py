"""End-to-end serving driver (the paper's workload type) on the port:
batched image requests served through the HALP-partitioned VGG-16 with
deadline tracking -- the host-ES/secondary-ES collaboration as a real request
loop, each conv through K1 on the card.

The PyTorch port's twin of ``examples/serve_halp.py``: the same flags and
printed lines over ``repro_torch`` (no ``jax``, no ``repro``), plus
``--device``.  PyTorch runs eagerly: a warm-up call takes the place of the
JAX script's compile, and each timed call ends in ``torch.cuda.synchronize``
on the card.  The engine serves each request's class id (the argmax of its
logits), and each request's image is drawn inside the timed window.

    PYTHONPATH=src python examples/serve_halp_torch.py --requests 48
    PYTHONPATH=src python examples/serve_halp_torch.py --requests 8 --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import OffloadChannel, plan_halp  # noqa: E402
from repro_torch.core.replan import ComputeRateEstimator  # noqa: E402
from repro_torch.kernels._build import build_all  # noqa: E402
from repro_torch.models import vgg  # noqa: E402
from repro_torch.runtime.serve import BatchingEngine, ServeConfig, choose_batch_size  # noqa: E402
from repro_torch.spatial import run_plan  # noqa: E402

CURVE_BATCHES = (1, 2, 4, 8)
CURVE_CALLS = 3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(
    n_requests: int = 48,
    deadline_ms: float = 2000.0,
    device: str | torch.device = "cuda",
    cfg: vgg.VGGConfig | None = None,
) -> dict:
    """Serve ``n_requests`` random images of ``cfg`` (VGG-16's
    ``smoke_cfg`` by default) through ``plan_halp(overlap_rows=4)`` + the
    head, at the batch size the reliability policy admits over the measured
    latency curve.

    Returns the curve (seconds per call at each width), the admitted
    ``max_batch``, the engine's ``stats``, the wall time and request rate,
    the per-ES compute rates ``run_plan`` attributed (FLOP/s), and for
    checking the ``plan``, ``params``, ``images`` and served ``classes`` (in
    submission order).  Parameters come from a generator seeded with 0 and
    the images from one seeded with 1, as the JAX script's keys.  When
    admission sheds (batch 0) nothing is served: the result holds the curve
    and ``max_batch`` 0 only."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        build_all()  # set-up: compile the kernels before anything is timed
    cfg = cfg or get("vgg16").smoke_cfg
    params = vgg.init(torch.Generator(device=dev).manual_seed(0), cfg)
    plan = plan_halp(cfg.geom(), overlap_rows=4)

    # zero-config per-ES timing attribution: run_plan itself reports one
    # (es, flops, elapsed) sample per ES per inference straight into the
    # engine's observe_es_time -> ComputeRateEstimator; nothing is measured
    # by hand here.
    est = ComputeRateEstimator({es: 1e9 for es in plan.es_names})
    engine: list[BatchingEngine] = []  # bound below; warm-up calls before that are not attributed

    def model(batch: torch.Tensor) -> torch.Tensor:
        feats = run_plan(plan, params["features"], vgg.apply_layer, batch,
                         time_observer=engine[0].observe_es_time if engine else None)
        return vgg.head(params, feats).argmax(dim=-1)

    # pick the batch size with the paper's reliability policy: measure the
    # latency curve, then admit the largest batch meeting the deadline target.
    res = cfg.img_res
    lat = {}
    for b in CURVE_BATCHES:
        xb = torch.zeros((b, res, res, cfg.in_channels), device=dev)
        model(xb)  # warm-up
        _sync(dev)
        t0 = time.monotonic()
        for _ in range(CURVE_CALLS):
            model(xb)
        _sync(dev)
        lat[b] = (time.monotonic() - t0) / CURVE_CALLS
    ch = OffloadChannel(rate_bps=100e6, sigma_s=1e-3)
    batch = choose_batch_size(
        lambda b: lat[min(lat, key=lambda k: abs(k - b))],
        deadline_ms / 1e3,
        ch,
        target=0.999,
        max_batch=8,
    )
    if batch == 0:  # admission says shed: no batch meets the deadline target
        return dict(device=str(dev), curve_s=lat, max_batch=0)

    eng = BatchingEngine(model, ServeConfig(max_batch=batch), es_observer=est.observe)
    engine.append(eng)
    gen = torch.Generator(device=dev).manual_seed(1)
    images = []
    t0 = time.monotonic()
    for _ in range(n_requests):
        images.append(torch.randn((res, res, cfg.in_channels), generator=gen, device=dev))
        eng.submit(images[-1], deadline_s=deadline_ms / 1e3)
    stats = eng.run_until_drained()
    wall = time.monotonic() - t0
    requests = sorted(eng.completed, key=lambda r: r.rid)
    return dict(
        device=str(dev), curve_s=lat, max_batch=batch, stats=stats, wall_s=wall,
        requests_per_s=stats["completed"] / wall, es_rates={es: est.rate(es) for es in plan.es_names},
        plan=plan, params=params, cfg=cfg, images=torch.stack(images),
        classes=torch.stack([r.result for r in requests]),
    )


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--deadline-ms", type=float, default=2000.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    out = run(args.requests, args.deadline_ms, args.device)
    print("latency curve:", {b: f"{t*1e3:.1f}ms" for b, t in out["curve_s"].items()})
    print(f"reliability-chosen max_batch = {out['max_batch']}")
    if out["max_batch"] == 0:
        raise SystemExit("admission returned 0 (shed): deadline infeasible")
    stats, wall = out["stats"], out["wall_s"]
    print(
        f"served {stats['completed']} requests in {wall:.2f}s "
        f"({stats['completed']/wall:.1f} req/s), deadline met: "
        f"{stats['deadline_met_frac']*100:.1f}%, p99 {stats['p99_latency_s']*1e3:.0f}ms"
    )
    print(
        "measured per-ES compute (auto-attributed):",
        {es: f"{r/1e9:.2f} GFLOP/s" for es, r in out["es_rates"].items()},
    )
    return out


if __name__ == "__main__":
    main()
