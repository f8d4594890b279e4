"""Quickstart: the paper's full pipeline on VGG-16 in one script, on the port.

The PyTorch port's twin of ``examples/quickstart.py`` (same sections and
printed lines, over ``repro_torch``; no ``jax``, no ``repro``):

1. receptive-field arithmetic (paper eqs. 1-4),
2. HALP partition plan (eqs. 5-9) + inter-ES message sizes (eqs. 10-14),
3. losslessness: the partitioned forward (K1 through ``run_plan`` on the
   card) equals the single-device forward,
4. latency: HALP vs MoDNN vs standalone on the paper's platforms (eqs. 15-23),
5. service reliability under a time-variant channel (Table III model).

    PYTHONPATH=src python examples/quickstart_torch.py               # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain versions

Sections 1, 2, 4 and 5 are host arithmetic.  Section 3 runs the thin VGG-16
(64 x 64, 1/8 width) unless :func:`run` is given another configuration.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AGX_XAVIER,
    GTX_1080TI,
    Link,
    OffloadChannel,
    plan_halp,
    rf_chain,
    service_reliability,
    simulate_halp,
    simulate_modnn,
    standalone_time,
    vgg16_geom,
)
from repro_torch.models import vgg  # noqa: E402
from repro_torch.spatial import run_plan  # noqa: E402

DEMO = vgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10)
RTOL = ATOL = 2e-5  # the JAX script's losslessness check


def receptive_fields(net) -> list[dict]:
    """Section 1: the chain's state after the first four layers and the last."""
    states = rf_chain(net.in_rows, net.layers)
    picked = list(zip(net.layers, states))[:4] + [(net.layers[-1], states[-1])]
    return [dict(name=g.name, out=st.out, jump=st.jump, rf=st.rf) for g, st in picked]


def halp_partition(net) -> dict:
    """Section 2: each ES's output rows of conv1_1 and one message size."""
    plan = plan_halp(net, overlap_rows=4)
    p0 = plan.parts[0]
    rows = [dict(es=es, lo=p0.out[es].lo, hi=p0.out[es].hi, rows=p0.out[es].rows) for es in plan.es_names]
    return dict(rows=rows, message_bytes=plan.message_bytes(3, "e0", "e1"))


def losslessness(cfg: vgg.VGGConfig, device: torch.device) -> dict:
    """Section 3: ``run_plan`` under ``plan_halp(overlap_rows=4)`` against the
    single-device ``vgg.features`` on one image; raises if they part by more
    than ``ATOL + RTOL * |ref|``.  Parameters from a generator seeded with
    0, the image from one seeded with 1, as the JAX script's keys."""
    params = vgg.init(torch.Generator(device=device).manual_seed(0), cfg)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((1, cfg.img_res, cfg.img_res, cfg.in_channels), generator=gen, device=device)
    ref = vgg.features(params, cfg, x)
    dist = run_plan(plan_halp(cfg.geom(), overlap_rows=4), params["features"], vgg.apply_layer, x)
    err = (dist - ref).abs()
    ok = tuple(dist.shape) == tuple(ref.shape) and bool((err <= ATOL + RTOL * ref.abs()).all())
    if not ok:
        raise AssertionError(f"distributed forward parts from the single-device one: max |diff| "
                             f"{err.max().item():.3g}")
    return dict(shape=list(dist.shape), max_abs_err=err.max().item(), ref_max_abs=ref.abs().max().item())


def latency(net) -> list[dict]:
    """Section 4: standalone, HALP (4 tasks) and MoDNN times in seconds."""
    rows = []
    for plat in (GTX_1080TI, AGX_XAVIER):
        t_pre = standalone_time(net, plat)
        for rate in (40e9, 100e9):
            rows.append(dict(platform=plat.name, rate=rate, standalone=t_pre,
                             halp=simulate_halp(net, plat, Link(rate), n_tasks=4)["total"],
                             modnn=simulate_modnn(net, plat, Link(rate), 9)["total"]))
    return rows


def reliability() -> list[tuple[str, float]]:
    """Section 5: service reliability at a 30 FPS deadline on Xavier."""
    ch = OffloadChannel(rate_bps=40e6, sigma_s=5e-3)
    return [(name, service_reliability(ch, t_inf, 4.0 / 30.0))
            for name, t_inf in (("standalone", 32.43e-3), ("HALP", 17.77e-3))]


def run(device: str | torch.device = "cuda", cfg: vgg.VGGConfig = DEMO) -> dict:
    """The five sections; section 3 at ``cfg`` on ``device``."""
    dev = resolve_device(device)
    net = vgg16_geom()
    return dict(device=str(dev), receptive_fields=receptive_fields(net), partition=halp_partition(net),
                lossless=losslessness(cfg, dev), latency=latency(net), reliability=reliability())


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run(args.device)

    print("== receptive-field chain (VGG-16) ==")
    for r in out["receptive_fields"]:
        print(f"  {r['name']:10s} out={r['out']:4d} jump={r['jump']:3d} rf={r['rf']:4d}")
    print("\n== HALP partition, layer conv1_1 ==")
    for r in out["partition"]["rows"]:
        print(f"  {r['es']}: output rows {r['lo']}..{r['hi']} ({r['rows']} rows)")
    print(f"  host->e1 message after conv2_1: {out['partition']['message_bytes']:,.0f} bytes")
    print("\n== losslessness: distributed == single-device forward  OK ==")
    print("\n== inference time (ms), 4 tasks per batch ==")
    for r in out["latency"]:
        halp = r["halp"]
        print(
            f"  {r['platform']:18s} @{r['rate']/1e9:3.0f}G: standalone {r['standalone']*1e3:6.2f}  "
            f"HALP {halp*1e3:6.2f} ({4/halp:5.0f} fps)  MoDNN {r['modnn']*1e3:6.2f}"
        )
    print("\n== service reliability, 30 FPS deadline, Xavier ==")
    for name, r in out["reliability"]:
        print(f"  {name:10s}: {r:.6f}")
    print("\nquickstart complete.")
    return out


if __name__ == "__main__":
    main()
