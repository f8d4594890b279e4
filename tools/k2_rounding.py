#!/usr/bin/env python3
"""Where the halo-conv kernel (K2) and its plain version part, element by
element, against a float64 reference, on the card.

    python3 tools/k2_rounding.py [--out chiprun_out/k2_rounding.json]

At the geometries of ``tests/test_torch_cuda.py``'s probe test (batch 2), with
that test's draw (``np.random.default_rng(sum(geometry))``, standard normal
shard, halos and weights, in that order) taken twice -- as drawn
("unscaled", every term of a dot product ~ N(0, 1)) and with the weights
scaled by sqrt(2 / fan-in) ("fan-in", |y| ~ 1) -- it launches K2, runs the
float32 plain version (``halo_conv2d_ref``, TF32 off) and a float64 conv of
the same operands, and prints per geometry and draw:

* the element where K2 comes closest to (or past) the repo's float32 limit
  ``2e-5 x (1 + |ref|)``: its share of the limit, |K2 - ref|, ref, the float64
  value, K2's and the plain version's own errors against it, and the
  dot product's condition sum(|x| |w|);
* over all elements: how many exceed the limit, and the largest error of K2 and
  of the plain version against float64, in units of float32's unit roundoff
  u = 2^-24 times the condition sum.

Needs the card and ``nvcc``; no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

# (k, s, p, groups, c_in, c_out, hs, w), as in tests/test_torch_cuda.py
GEOMETRIES = [(3, 1, 1, 1, 64, 64, 37, 224), (3, 2, 1, 1, 32, 64, 10, 31), (1, 1, 0, 1, 16, 8, 3, 9),
              (5, 1, 2, 24, 24, 24, 7, 20), (3, 1, 1, 1, 3, 64, 1, 224)]
TOL = 2e-5
U = 2.0 ** -24


def conv64(torch, ops, s, p, groups, absolute=False):
    """The float64 conv of the shard with its halos (the width zero-padded by
    ``p``), NHWC out; with ``absolute`` of |operands|: the condition sum."""
    import torch.nn.functional as F

    f = (lambda t: t.double().abs()) if absolute else (lambda t: t.double())
    ext = torch.cat([f(ops[n]) for n in ("top", "x", "bottom") if ops[n] is not None], dim=1)
    ext = F.pad(ext, (0, 0, p, p)).permute(0, 3, 1, 2)
    return F.conv2d(ext, f(ops["weights"]).permute(3, 2, 0, 1), stride=s, groups=groups).permute(0, 2, 3, 1)


def main() -> int:
    import torch

    from repro_torch.analysis.kernel_check import geometry_shapes
    from repro_torch.kernels.halo_conv import halo_conv2d_cuda, halo_conv2d_ref
    from repro_torch.kernels.halo_conv.ops import launch_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/k2_rounding.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for geom in GEOMETRIES:
        k, s, p, groups, cin, cout, hs, w = geom
        shapes = geometry_shapes(k, s, p, groups=groups, c_in=cin, c_out=cout, hs=hs, w=w, batch=2)
        rng = np.random.default_rng(sum(geom))
        drawn = {n: None if v is None else torch.from_numpy(rng.standard_normal(v, dtype=np.float32)).cuda()
                 for n, v in shapes.items() if n != "out"}
        for draw in ("unscaled", "fan-in"):
            ops = dict(drawn)
            if draw == "fan-in":
                ops["weights"] = drawn["weights"] * (2.0 / (k * k * shapes["weights"][2])) ** 0.5
            kw = dict(stride=s, padding=p, groups=groups)
            y = halo_conv2d_cuda(ops["x"], ops["top"], ops["bottom"], ops["weights"], **kw)
            ref = halo_conv2d_ref(ops["x"], ops["top"], ops["bottom"], ops["weights"], None, **kw)
            r64 = conv64(torch, ops, s, p, groups)
            cond = conv64(torch, ops, s, p, groups, absolute=True)
            share = (y - ref).abs() / (TOL * (1 + ref.abs()))
            i = int(share.argmax())
            at = lambda t: t.reshape(-1)[i].item()  # noqa: E731
            k_err = (y.double() - r64).abs()
            p_err = (ref.double() - r64).abs()
            row = dict(
                geometry=list(geom), draw=draw, **launch_config(ops["x"], ops["top"], ops["bottom"],
                                                                ops["weights"], **kw),
                n=y.numel(), n_over_limit=int((share > 1).sum()), worst_share=at(share),
                worst_index=[int(j) for j in np.unravel_index(i, tuple(y.shape))],
                worst_abs_err=at((y - ref).abs()),
                worst_ref=at(ref), worst_ref64=at(r64), worst_kernel_err64=at(k_err),
                worst_plain_err64=at(p_err), worst_cond=at(cond), max_abs_ref=ref.abs().max().item(),
                kernel_err64_max_u=(k_err / (U * cond)).max().item(),
                plain_err64_max_u=(p_err / (U * cond)).max().item(),
                kernel_vs64_share=(k_err / (TOL * (1 + r64.abs()))).max().item(),
            )
            rows.append(row)
            print(f"K2 {geom} {draw:8s} S={row['splits']}: {row['n_over_limit']} of {row['n']} over "
                  f"2e-5 x (1 + |ref|); worst {row['worst_share']:.3f} of it at {row['worst_index']}: "
                  f"|K2 - ref| {row['worst_abs_err']:.3g}, ref {row['worst_ref']:.6g}, float64 "
                  f"{row['worst_ref64']:.6g}, |K2 - f64| {row['worst_kernel_err64']:.3g}, |ref - f64| "
                  f"{row['worst_plain_err64']:.3g}, sum |x||w| {row['worst_cond']:.4g}; max |y|"
                  f" {row['max_abs_ref']:.4g}; largest error vs f64 in u x sum|x||w|: K2 "
                  f"{row['kernel_err64_max_u']:.3f}, plain {row['plain_err64_max_u']:.3f}; K2 vs f64 "
                  f"{row['kernel_vs64_share']:.3f} of the limit")
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
