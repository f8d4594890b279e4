#!/usr/bin/env python3
"""Time and hold the two routes of a dense conv's weight gradient that
``kernels/conv2d/ops.py: conv2d_backward`` can take, on the card, at every
dense K1 call signature of the train steps that run K1.

    python3 tools/wgrad_routes.py [--batch 4] [--out chiprun_out/wgrad_routes.json]

The signatures are recorded (``chip_smoke.recording_train_calls``) from one
float32 train step at batch 1, at full width, of UNet-SD1.5 and DiT-XL/2
(train_256) and ViT-L/16 and EfficientNet-B7 (cls_224); each is then run at
``--batch``.  Per signature:

- float32: device us (``chip_smoke.device_window``) of cuDNN's weight
  gradient (``aten.convolution_backward`` under ``library_flags``: TF32 off,
  deterministic) and of ``_wgrad_taps`` (one cuBLAS product a tap, the
  route float32 takes), and each one's error against the same gradient in
  float64 as a share of 2^-20 x the sum of |terms| (the float32 rounding
  scale the card tests hold it to);
- bfloat16: the route bfloat16 takes (cuDNN on float32 copies, TF32 on),
  its error against float64 on the same bfloat16 values as a share of
  2^-8 x |g| + 2^-20 x the sum of |terms| (one bfloat16 rounding of the
  sum, plus the float32 scale), beside the same share of ``_wgrad_taps``'s
  float32 result rounded to bfloat16.

Prints a line per signature and per model the sums over a step (each
signature times its calls a step), and writes a JSON artifact.  Exits
non-zero if a float32 route's share exceeds 1 where ``_wgrad_taps`` is
taken, or if a time stays unmeasured.  Needs the card and ``nvcc``; imports
no JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from chip_smoke import device_window, recording_train_calls, with_batch  # noqa: E402

MODELS = (("unet-sd15", "train_256"), ("dit-xl2", "train_256"), ("vit-l16", "cls_224"),
          ("efficientnet-b7", "cls_224"))
SUM_RTOL = 2.0 ** -20
BF16_RTOL = 2.0 ** -8


def signatures(torch, name: str, cell: str) -> Counter:
    """(x shape, w shape, stride, padding) -> calls a step, of the dense K1
    calls of one float32 step of ``name`` at batch 1."""
    from repro_torch.configs import get
    from repro_torch.configs.steps import build, realize

    arch = with_batch(get(name), 1, cell)
    bundle = build(arch, cell, dtype=torch.float32)
    state, inputs = realize(arch, bundle, torch.Generator(device="cuda").manual_seed(0))
    with recording_train_calls() as rec:
        bundle.fn(state, **inputs)
        torch.cuda.synchronize()
    del state
    sigs = Counter()
    for (xs, ws, st, pad, groups, *_), c in rec.convs.items():
        if groups == 1:
            sigs[(xs[1:], ws, st, pad)] += c
    return sigs


def cudnn_wgrad(torch, dy, x, w, stride: int, padding: int, allow_tf32: bool):
    """cuDNN's weight gradient as ``conv2d_backward``'s library call makes
    it: NHWC operands on NCHW views, deterministic, [k, k, Cin, Cout]."""
    from repro_torch.kernels.conv2d.ops import library_flags

    with library_flags(allow_tf32=allow_tf32):
        out = torch.ops.aten.convolution_backward(
            dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None, [stride] * 2,
            [padding] * 2, [1, 1], False, [0, 0], 1, [False, True, False])[1]
    return out.permute(2, 3, 1, 0)


def hold(torch, batch: int, sig: tuple, gen) -> dict:
    from repro_torch.kernels.conv2d.ops import _wgrad_taps, conv2d_backward

    (h, w, cin), (k, _, _, cout), st, pad = sig
    ho, wo = (h + 2 * pad - k) // st + 1, (w + 2 * pad - k) // st + 1
    x = torch.randn((batch, h, w, cin), generator=gen, device="cuda")
    wt = math.sqrt(2.0 / (k * k * cin)) * torch.randn((k, k, cin, cout), generator=gen, device="cuda")
    dy = torch.randn((batch, ho, wo, cout), generator=gen, device="cuda")
    row = dict(x=[batch, h, w, cin], k=k, cout=cout, stride=st, pad=pad)

    def exact(x, dy):
        return cudnn_wgrad(torch, dy.double(), x.double(), wt.double(), st, pad, False)

    want, sums = exact(x, dy), exact(x.abs(), dy.abs())
    routes = {"cudnn": lambda: cudnn_wgrad(torch, dy, x, wt, st, pad, False),
              "taps": lambda: _wgrad_taps(dy, x, k, st, pad)}
    for name, fn in routes.items():
        err = (fn().double() - want).abs()
        row[f"f32_{name}_share"] = (err / (SUM_RTOL * sums)).max().item()
        row[f"f32_{name}_us"] = device_window(torch, fn, reps=10)[0]
    xb, dyb = x.bfloat16(), dy.bfloat16()
    want, sums = exact(xb, dyb), exact(xb.abs(), dyb.abs())
    limit = BF16_RTOL * want.abs() + SUM_RTOL * sums
    got = conv2d_backward(dyb, xb, wt.bfloat16(), st, pad, 1, (False, True, False))[1]
    row["bf16_route_share"] = ((got.double() - want).abs() / limit).max().item()
    taps = _wgrad_taps(dyb.float(), xb.float(), k, st, pad).bfloat16()
    row["bf16_taps_share"] = ((taps.double() - want).abs() / limit).max().item()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default="chiprun_out/wgrad_routes.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("wgrad_routes: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    report, ok = {}, True
    for name, cell in MODELS:
        sigs = signatures(torch, name, cell)
        torch.cuda.empty_cache()
        rows = []
        for sig, calls in sorted(sigs.items()):
            row = dict(hold(torch, args.batch, sig, gen), calls=calls)
            rows.append(row)
            ok &= row["f32_taps_share"] <= 1.0 and all(math.isfinite(row[f"f32_{r}_us"]) for r in ("cudnn", "taps"))
            print(f"{name:16s} x{row['x']} k{row['k']} s{row['stride']} p{row['pad']} -> {row['cout']} x{calls}/step: "
                  f"f32 cuDNN {row['f32_cudnn_us']:.1f} us (share {row['f32_cudnn_share']:.3g}), taps "
                  f"{row['f32_taps_us']:.1f} us (share {row['f32_taps_share']:.3g}); bf16 route share "
                  f"{row['bf16_route_share']:.3g} (taps rounded: {row['bf16_taps_share']:.3g})")
        step = {r: sum(row[f"f32_{r}_us"] * row["calls"] for row in rows) / 1e3 for r in ("cudnn", "taps")}
        worst = {key: max(row[key] for row in rows) for key in
                 ("f32_cudnn_share", "f32_taps_share", "bf16_route_share", "bf16_taps_share")}
        report[name] = dict(cell=cell, batch=args.batch, signatures=rows, f32_step_ms=step, largest=worst)
        print(f"{name}: {len(rows)} dense signatures, {sum(sigs.values())} calls a step at batch {args.batch}: "
              f"f32 weight gradients {step['cudnn']:.3f} ms (cuDNN) / {step['taps']:.3f} ms (taps) a step; "
              f"largest shares: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print("wgrad_routes: " + ("ok" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
