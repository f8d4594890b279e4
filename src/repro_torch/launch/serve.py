"""Serving launcher: VGG-16 through the HALP plan, or any other vision arch
through its model's ``apply``, behind the deadline-aware batching engine, on
the card (twin of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch vgg16 --requests 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch vit-l16 --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch swin-b --smoke --device cpu

The full-width configuration is served by default; ``--smoke`` serves the
reduced one (``arch.smoke_cfg``, what the JAX launcher serves).  PyTorch runs
eagerly, so there is no jit: the first batch pays any one-off CUDA set-up,
the kernels' build excepted.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device
from ..configs import get, list_archs
from ..core.partition import plan_halp
from ..kernels._build import build_all
from ..models import vgg
from ..runtime.serve import BatchingEngine, ServeConfig
from ..spatial import run_plan


def serve_archs() -> list[str]:
    """The archs the launcher serves: every registered vision and convnet arch."""
    return [name for name in list_archs() if get(name).family in ("vision", "convnet")]


def serve(
    arch: str = "vgg16",
    n_requests: int = 32,
    max_batch: int = 8,
    deadline_ms: float = 500.0,
    device: str | torch.device = "cuda",
    seed: int = 0,
    smoke: bool = False,
) -> dict:
    """Serve ``n_requests`` random images of ``arch`` (its full config, or
    with ``smoke`` its reduced one): ``vgg16`` through
    ``plan_halp(overlap_rows=4)`` + the head, any other arch through
    ``arch.module.apply``.

    Parameters and images are drawn from ``seed`` on ``device``.  Returns the
    engine's ``stats``, the wall time from the first submission until the
    engine has drained (``start_s`` is the clock at the first submission) and
    the request rate over it, and -- for checking -- the completed
    ``requests`` and their ``logits`` ([n_requests, classes]), both in
    submission order, the ``images``, the ``params``, the served ``cfg`` and
    the ``plan`` (None for an arch served through ``apply``)."""
    spec = get(arch)
    if spec.family not in ("vision", "convnet"):
        raise ValueError(f"{arch!r} is a {spec.family} arch; the launcher serves {serve_archs()}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        build_all()  # set-up, not serving: compile the kernels before the clock starts
    cfg = spec.smoke_cfg if smoke else spec.cfg
    gen = torch.Generator(device=dev).manual_seed(seed)
    plan = None
    if arch == "vgg16":
        params = vgg.init(gen, cfg)
        plan = plan_halp(cfg.geom(), overlap_rows=4)

        def model(batch: torch.Tensor) -> torch.Tensor:
            feats = run_plan(plan, params["features"], vgg.apply_layer, batch)
            return vgg.head(params, feats)
    else:
        params = spec.module.init(gen, cfg)

        def model(batch: torch.Tensor) -> torch.Tensor:
            return spec.module.apply(params, cfg, batch)

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
        "cfg": cfg,
        "plan": plan,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="vgg16", choices=serve_archs())
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--deadline-ms", type=float, default=500.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true", help="serve the reduced CPU-test configuration")
    args = ap.parse_args()

    out = serve(args.arch, args.requests, args.max_batch, args.deadline_ms, args.device, smoke=args.smoke)
    cfg, stats = out["cfg"], out["stats"]
    if out["plan"] is not None:
        how = f"width {cfg.width_mult}) through the HALP plan ({len(out['plan'].parts)} layers, " \
              "3 collaborating segments)"
    else:
        how = f"{cfg.name}) through {get(args.arch).module.__name__}.apply"
    print(f"serving {args.arch} ({cfg.img_res}x{cfg.img_res}, {how} on {args.device}")
    print(f"requests={stats['completed']} deadline_met={stats['deadline_met_frac']:.3f} "
          f"p50={stats['p50_latency_s']*1e3:.1f}ms p99={stats['p99_latency_s']*1e3:.1f}ms "
          f"throughput={out['requests_per_s']:.1f} req/s")


if __name__ == "__main__":
    main()
