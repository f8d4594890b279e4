"""Serving launcher: VGG-16 through the HALP plan and the deadline-aware
batching engine, on the card (twin of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch vgg16 --requests 32
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The full-width configuration is served by default; ``--smoke`` serves the
reduced one the JAX launcher uses.  PyTorch runs eagerly, so there is no jit:
the first batch pays any one-off CUDA set-up, the kernels' build excepted.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device
from ..core.partition import plan_halp
from ..kernels._build import build_all
from ..models import vgg
from ..runtime.serve import BatchingEngine, ServeConfig
from ..spatial import run_plan


def serve(
    cfg: vgg.VGGConfig = vgg.FULL,
    n_requests: int = 32,
    max_batch: int = 8,
    deadline_ms: float = 500.0,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> dict:
    """Serve ``n_requests`` random images through ``plan_halp(overlap_rows=4)``.

    Parameters and images are drawn from ``seed`` on ``device``.  Returns the
    engine's ``stats``, the wall time from the first submission until the
    engine has drained (``start_s`` is the clock at the first submission) and
    the request rate over it, and --
    for checking -- the completed ``requests`` and their ``logits``
    ([n_requests, classes]), both in submission order, the ``images``, the
    ``params`` and the ``plan``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        build_all()  # set-up, not serving: compile the kernels before the clock starts
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = vgg.init(gen, cfg)
    plan = plan_halp(cfg.geom(), overlap_rows=4)

    def model(batch: torch.Tensor) -> torch.Tensor:
        feats = run_plan(plan, params["features"], vgg.apply_layer, batch)
        return vgg.head(params, feats)

    res = cfg.img_res
    images = torch.randn((n_requests, res, res, cfg.in_channels), generator=gen, device=dev)
    eng = BatchingEngine(model, ServeConfig(max_batch=max_batch))
    t0 = time.monotonic()
    for i in range(n_requests):
        eng.submit(images[i], deadline_s=deadline_ms / 1e3)
    stats = eng.run_until_drained()
    wall = time.monotonic() - t0
    requests = sorted(eng.completed, key=lambda r: r.rid)
    return {
        "stats": stats,
        "start_s": t0,
        "wall_s": wall,
        "requests_per_s": stats["completed"] / wall,
        "requests": requests,
        "logits": torch.stack([r.result for r in requests]),
        "images": images,
        "params": params,
        "plan": plan,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="vgg16", choices=["vgg16"])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--deadline-ms", type=float, default=500.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true", help="serve the reduced CPU-test configuration")
    args = ap.parse_args()

    cfg = vgg.SMOKE if args.smoke else vgg.FULL
    out = serve(cfg, args.requests, args.max_batch, args.deadline_ms, args.device)
    stats = out["stats"]
    print(f"serving vgg16 ({cfg.img_res}x{cfg.img_res}, width {cfg.width_mult}) through the "
          f"HALP plan ({len(out['plan'].parts)} layers, 3 collaborating segments) on {args.device}")
    print(f"requests={stats['completed']} deadline_met={stats['deadline_met_frac']:.3f} "
          f"p50={stats['p50_latency_s']*1e3:.1f}ms p99={stats['p99_latency_s']*1e3:.1f}ms "
          f"throughput={out['requests_per_s']:.1f} req/s")


if __name__ == "__main__":
    main()
