#!/usr/bin/env python3
"""Launch the port's direct-conv kernel (K1) thousands of times at two
shapes on the card and count the runs whose bits differ from the first run
or whose values leave the plain version's tolerance.

    python3 tools/k1_stress.py [--launches 4000] [--out chiprun_out/k1_stress.json]
    python3 tools/k1_stress.py --sanitizer racecheck   # one launch of each under compute-sanitizer

The two cases:

- ``splitk``: the forward of a float32 conv x[4, 6, 30, 256] -> 512, k3,
  stride 1, padding 0, with bias, which the core splits over K (8 splits
  on the H100: the split-K pass and ``splitk_reduce``), once on a
  contiguous input and once on a row-slice view of a taller one, in turns;
- ``pointwise-dgrad``: ``Conv2dFunction``'s backward of a float32 1x1 conv
  [64, 28, 28, 80] -> 480 with bias, whose input gradient is a K1 launch
  (``conv2d_backward``'s "K1 dgrad"); dx, dW and db are compared.

Between launches a live allocation of a varying size (a ring of 8) moves
where the caching allocator places the next buffers, and the input is a
fresh copy every other launch.  The reference is the plain version on the
card in float32 with TF32 off: a run is out of tolerance where
|got - want| > 2e-5 x (1 + |want|) + 2^-20 x the sum of |terms|.  Each
allocator setting runs in a process of its own (``PYTORCH_CUDA_ALLOC_CONF``
unset, and ``expandable_segments:True``).  Prints one line per case and
setting, writes a JSON artifact, and exits non-zero if any run differed in
its bits or left the tolerance.  ``--sanitizer TOOL`` instead runs one
launch of each case under ``compute-sanitizer --tool TOOL`` and reports its
exit code and last lines.  Needs the card and ``nvcc``; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = ("", "expandable_segments:True")
RING = 8
SUM_RTOL = 2.0 ** -20
TOL = 2e-5


def _bits(t):
    import torch

    return t.contiguous().view(torch.int32)


def _case_splitk(torch, gen, launches: int) -> dict:
    from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref
    from repro_torch.kernels.conv2d.ops import launch_config

    n, h, w, cin, cout, k = 4, 6, 30, 256, 512, 3
    tall = torch.randn((n, h + 4, w, cin), generator=gen, device="cuda")
    inputs = (tall[:, 2:2 + h].contiguous(), tall[:, 2:2 + h])  # contiguous, and a row-slice view
    wt = math.sqrt(2.0 / (k * k * cin)) * torch.randn((k, k, cin, cout), generator=gen, device="cuda")
    b = 0.1 * torch.randn((cout,), generator=gen, device="cuda")
    kw = dict(stride=1, padding=0)
    configs = [launch_config(x, wt, **kw) for x in inputs]
    want = conv2d_ref(inputs[0], wt, b, **kw).float()
    limit = TOL * (1 + want.abs()) + SUM_RTOL * conv2d_ref(inputs[0].abs(), wt.abs(), b.abs(), **kw).float()
    first = [[_bits(conv2d_cuda(x, wt, b, **kw))] for x in inputs]

    def run(i: int):
        x = inputs[i % 2]
        x = x.clone() if (i // 2) % 2 else x
        return [conv2d_cuda(x, wt, b, **kw)], i % 2

    return _loop(torch, gen, launches, run, first, [want], [limit],
                 dict(shape=[n, h, w, cin, cout], k=k, stride=1, pad=0, bias=True, dtype="float32",
                      configs=configs))


def _case_pointwise_dgrad(torch, gen, launches: int) -> dict:
    from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref
    from repro_torch.kernels.conv2d.ops import launch_config

    n, h, cin, cout = 64, 28, 80, 480
    x = torch.randn((n, h, h, cin), generator=gen, device="cuda")
    wt = 0.1 * torch.randn((1, 1, cin, cout), generator=gen, device="cuda")
    b = torch.randn((cout,), generator=gen, device="cuda")
    dy = torch.randn((n, h, h, cout), generator=gen, device="cuda")
    kw = dict(stride=1, padding=0)

    def grads(fn, x, wt, b, dy):
        leaves = [t.clone().requires_grad_() for t in (x, wt, b)]
        return [g.detach() for g in torch.autograd.grad(fn(*leaves, **kw), leaves, dy)]

    want = grads(conv2d_ref, x, wt, b, dy)
    sums = grads(conv2d_ref, x.abs(), wt.abs(), b.abs(), dy.abs())
    limits = [TOL * (1 + g.abs()) + SUM_RTOL * s for g, s in zip(want, sums)]
    flipped = wt.flip(0, 1).transpose(2, 3).contiguous()
    configs = [launch_config(dy, flipped, stride=1, padding=0)]
    first = [[_bits(g) for g in grads(conv2d_cuda, x, wt, b, dy)]]

    def run(i: int):
        xi = x.clone() if (i // 2) % 2 else x
        return grads(conv2d_cuda, xi, wt, b, dy), 0

    return _loop(torch, gen, launches, run, first, want, limits,
                 dict(shape=[n, h, h, cin, cout], k=1, stride=1, pad=0, bias=True, dtype="float32",
                      configs=configs, compared=["dx", "dw", "db"]))


def _loop(torch, gen, launches: int, run, first: list, want: list, limits: list, row: dict) -> dict:
    """``launches`` runs of ``run(i) -> (outputs, variant)``: the outputs'
    bits against ``first[variant]``'s, and their values against ``want``
    within ``limits``."""
    from repro_torch.kernels.conv2d import conv2d_cuda

    ring, differ, outside, worst = [], 0, 0, 0.0
    before = conv2d_cuda.launches, conv2d_cuda.backward_launches
    for i in range(launches):
        size = int(torch.randint(1, 1 << 22, (1,), generator=gen, device="cuda").item())
        ring.append(torch.empty(size, dtype=torch.uint8, device="cuda"))
        if len(ring) > RING:
            ring.pop(0)
        outs, variant = run(i)
        differ += any(not torch.equal(_bits(o), r) for o, r in zip(outs, first[variant]))
        shares = [((o.float() - w).abs() / lim).max().item() for o, w, lim in zip(outs, want, limits)]
        outside += max(shares) > 1.0
        worst = max(worst, *shares)
    torch.cuda.synchronize()
    return dict(row, launches=launches, k1_launches=conv2d_cuda.launches - before[0],
                k1_backward_launches=conv2d_cuda.backward_launches - before[1],
                runs_with_other_bits=differ, runs_outside_tolerance=outside, largest_share_of_limit=worst)


CASES = {"splitk": _case_splitk, "pointwise-dgrad": _case_pointwise_dgrad}


def child(launches: int) -> int:
    sys.path[:0] = [str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("k1_stress: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {name: fn(torch, gen, launches) for name, fn in CASES.items()}
    print(json.dumps(dict(alloc_conf=os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""), cases=rows)))
    return 0


def run_child(launches: int, alloc_conf: str, prefix: list[str] | None = None, timeout: int = 900) -> dict:
    env = dict(os.environ)
    env.pop("PYTORCH_CUDA_ALLOC_CONF", None)
    if alloc_conf:
        env["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    cmd = [*(prefix or []), sys.executable, str(Path(__file__).resolve()), "--child", "--launches", str(launches)]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    got = json.loads(lines[-1]) if lines else {}
    return dict(got, rc=proc.returncode, stderr_tail=proc.stderr[-2000:], stdout_tail=proc.stdout[-2000:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=4000)
    ap.add_argument("--out", default="chiprun_out/k1_stress.json")
    ap.add_argument("--sanitizer", choices=["racecheck", "memcheck", "synccheck", "initcheck"])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.launches)
    if args.sanitizer:
        tool = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
        try:
            res = run_child(1, "", [tool, "--tool", args.sanitizer, "--error-exitcode", "9"], timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            res = dict(rc=None, error=repr(e))
        print(f"compute-sanitizer --tool {args.sanitizer}: rc {res.get('rc')}")
        print((res.get("stdout_tail", "") + res.get("stderr_tail", "") + res.get("error", ""))[-1500:])
        out = Path(args.out).with_name(f"k1_sanitizer_{args.sanitizer}.json")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
        return 0 if res.get("rc") == 0 else 1
    results, ok = [], True
    for conf in SETTINGS:
        res = run_child(args.launches, conf)
        results.append(res)
        if res["rc"] != 0 or "cases" not in res:
            ok = False
            print(f"PYTORCH_CUDA_ALLOC_CONF={conf!r}: rc {res['rc']}\n{res['stderr_tail']}")
            continue
        for name, r in res["cases"].items():
            ok &= r["runs_with_other_bits"] == 0 and r["runs_outside_tolerance"] == 0
            print(f"{name:16s} PYTORCH_CUDA_ALLOC_CONF={conf or '(unset)'}: {r['launches']} runs, "
                  f"K1 launches {r['k1_launches']} forward / {r['k1_backward_launches']} backward, "
                  f"splits {[c['splits'] for c in r['configs']]} {[c['gather'] for c in r['configs']]}: "
                  f"{r['runs_with_other_bits']} with other bits, {r['runs_outside_tolerance']} out of tolerance, "
                  f"largest share of the limit {r['largest_share_of_limit']:.4g}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print("k1_stress: " + ("every run equal in its bits and within tolerance" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
