#!/usr/bin/env python3
"""Hold the port's direct-conv kernel (K1) against another source of its
shared core, on the card: equal bits and device time in turns.

    python3 tools/k1_variants.py --source PARENT_CONV_IGEMM_CUH [--out chiprun_out/k1_variants.json]

``src/repro_torch/kernels/conv2d/conv2d.cu`` is compiled by ``nvcc`` for
``sm_90a`` with the port's flags twice, in parallel, into
``build/k1_variants/``: once against this checkout's
``kernels/conv_igemm.cuh`` ("change") and once against ``--source`` (a
parent commit's core, "parent"; exports that core lacks are left out of its
build).  Both are called through the wrapper's own launch code
(``conv2d/ops.py: launch``) at every depthwise call signature of
ConvNeXt-B (224) and EfficientNet-B7 (600) at batch 4 (``DW_SHAPES``) and
at one dense VGG-16 and one dense ViT-L/16 shape (``DENSE_SHAPES``, a guard
on the dense core), in float32 and bfloat16 (bfloat16 inputs scaled by
powers of two from 2^-8 to 2^8, so that the f32 sums round).  The two
outputs must be equal bit for bit.  Device us per call come from
``chip_smoke.device_window`` (the helper ``chip_smoke.py`` times its
phases with) over back-to-back launches, in turns: parent, change, change,
parent.  Beside them: ``F.conv2d(groups=C)``'s device us (cuDNN; float32
with TF32 off) and the kernels it launches a call, never called by the
port, and the bytes bound (input, weights, bias and output once at 3.35
TB/s).  Prints one line per signature and per-model sums per forward, and
writes a JSON artifact.  Exits non-zero if any output differs or any time
stays unmeasured (nan after ``TRIES`` windows).  Needs the card and
``nvcc``; imports no JAX.

Where the checkout has no git history, write the parent's core first from
a clone that has it (``chipwork/`` is gitignored):
``git show <parent>:src/repro_torch/kernels/conv_igemm.cuh > chipwork/parent_conv_igemm.cuh``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from chip_smoke import device_window  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv2d import ops  # noqa: E402

KERNELS = ROOT / "src" / "repro_torch" / "kernels"
OUT_DIR = ROOT / "build" / "k1_variants"
PEAK_BYTES_PER_S = 3.35e12
BATCH = 4
TRIES = 5  # profiler windows a time may take (device_window)

# (model, H = W, C, k, stride, bias, calls per forward): every depthwise
# call signature of a forward at batch 4, padding (k - 1) / 2
DW_SHAPES = [
    ("convnext-b", 56, 128, 7, 1, True, 3), ("convnext-b", 28, 256, 7, 1, True, 3),
    ("convnext-b", 14, 512, 7, 1, True, 27), ("convnext-b", 7, 1024, 7, 1, True, 3),
    ("efficientnet-b7", 300, 64, 3, 1, False, 1), ("efficientnet-b7", 300, 32, 3, 1, False, 3),
    ("efficientnet-b7", 300, 192, 3, 2, False, 1), ("efficientnet-b7", 150, 288, 3, 1, False, 6),
    ("efficientnet-b7", 150, 288, 5, 2, False, 1), ("efficientnet-b7", 75, 480, 5, 1, False, 6),
    ("efficientnet-b7", 75, 480, 3, 2, False, 1), ("efficientnet-b7", 38, 960, 3, 1, False, 9),
    ("efficientnet-b7", 38, 960, 5, 1, False, 1), ("efficientnet-b7", 38, 1344, 5, 1, False, 9),
    ("efficientnet-b7", 38, 1344, 5, 2, False, 1), ("efficientnet-b7", 19, 2304, 5, 1, False, 12),
    ("efficientnet-b7", 19, 2304, 3, 1, False, 1), ("efficientnet-b7", 19, 3840, 3, 1, False, 3),
]
# (name, H = W, Cin, Cout, k, stride, pad): VGG-16's conv2_2 and a ViT-L/16 1x1
DENSE_SHAPES = [("vgg16-conv2_2", 112, 128, 128, 3, 1, 1), ("vit-l16-mlp1", 14, 1024, 4096, 1, 1, 0)]


def build(core_text: str, tag: str) -> tuple[ctypes.CDLL, str]:
    """conv2d.cu compiled against the shared core ``core_text``, into
    OUT_DIR/tag; the parent's build leaves out the depthwise launch shape's
    export (an older core has none; only the launch is timed)."""
    d = OUT_DIR / tag
    (d / "conv2d").mkdir(parents=True, exist_ok=True)
    src = (KERNELS / "conv2d" / "conv2d.cu").read_text()
    if tag != "change":
        src = re.sub(r'extern "C" \w+ conv2d_dw_config\(.*?\n}\n', "", src, flags=re.S)
    (d / "conv2d" / "conv2d.cu").write_text(src)
    (d / "conv_igemm.cuh").write_text(core_text)
    shutil.copy(KERNELS / "sm90_ops.cuh", d / "sm90_ops.cuh")
    lib = d / "libconv2d.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / "conv2d" / "conv2d.cu")],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"k1_variants: nvcc failed on {tag}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The launch's C interface (``conv2d_fwd``, the split count, the error
    string), which cores older than the depthwise launch shape export alike."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.conv2d_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i64, i64, i64, i, i, i, i, i, i, i, i, p]
    lib.conv2d_fwd.restype = ctypes.c_int
    ops.bind_splits(lib)
    return lib


def span(times: list[float]) -> tuple[float, float]:
    """The faster and the slower of a signature's turns; nan, which compares
    false, if a turn is unmeasured."""
    return (min(times), max(times)) if all(map(math.isfinite, times)) else (math.nan, math.nan)


def inputs(torch, gen, n, h, cin, cout, k, groups, has_bias, dt):
    x = torch.randn((n, h, h, cin), generator=gen, device="cuda")
    if dt == torch.bfloat16:
        x = x * torch.exp2(torch.randint(-8, 9, x.shape, generator=gen, device="cuda").float())
    w_cin = 1 if groups > 1 else cin
    wt = (2.0 / (k * k * w_cin)) ** 0.5 * torch.randn((k, k, w_cin, cout), generator=gen, device="cuda")
    b = 0.1 * torch.randn((cout,), generator=gen, device="cuda") if has_bias else None
    return x.to(dt), wt.to(dt), None if b is None else b.to(dt)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", required=True, help="another conv_igemm.cuh (a parent's): equal bits required")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "k1_variants.json"))
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("k1_variants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    texts = {"parent": Path(args.source).read_text(), "change": (KERNELS / "conv_igemm.cuh").read_text()}
    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda kv: build(kv[1], kv[0]), texts.items())))
    for name, (_, log) in built.items():
        entry = ""
        for line in log.splitlines():  # ptxas: each depthwise entry's registers, spills, shared memory
            if "Compiling entry" in line:
                entry = line
            elif "dwconv2d" in entry and ("Used" in line or "spill" in line):
                print(f"  {name}: {line.strip()[:120]}")
    libs = {name: (ops.bind if name == "change" else bind)(lib) for name, (lib, _) in built.items()}
    turns = ("parent", "change", "change", "parent")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows, same_all, unmeasured = [], True, []
    cases = [(m, h, c, c, k, s, (k - 1) // 2, c, bias, calls) for m, h, c, k, s, bias, calls in DW_SHAPES]
    cases += [(name, h, cin, cout, k, s, p, 1, True, 0) for name, h, cin, cout, k, s, p in DENSE_SHAPES]
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).removeprefix("torch.")
        for model, h, cin, cout, k, s, pad, groups, has_bias, calls in cases:
            x, wt, b = inputs(torch, gen, BATCH, h, cin, cout, k, groups, has_bias, dt)
            ho = (h + 2 * pad - k) // s + 1
            y = {key: torch.empty((BATCH, ho, ho, cout), dtype=dt, device="cuda") for key in libs}

            def run(key):
                ops.launch(libs[key], x, wt, b, y[key], s, pad, groups, stream)

            for key in libs:
                run(key)
            torch.cuda.synchronize()
            iv = torch.int16 if dt == torch.bfloat16 else torch.int32
            same = torch.equal(y["parent"].view(iv), y["change"].view(iv))
            same_all &= same
            us = {key: [] for key in libs}
            for key in turns:
                us[key].append(device_window(torch, lambda: run(key), tries=TRIES)[0])
            xn, wn = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)  # NCHW / OIHW views of the same memory
            lib_us, lib_kernels = device_window(
                torch, lambda: F.conv2d(xn, wn, b, stride=s, padding=pad, groups=groups), tries=TRIES)
            sig = f"{dname} {model} {h}x{h}x{cin}->{cout} k{k} s{s}"
            unmeasured += [f"{sig} {key}" for key, ts in [*us.items(), ("F.conv2d", [lib_us])]
                           if not all(map(math.isfinite, ts))]
            nbytes = (x.numel() + wt.numel() + (b.numel() if b is not None else 0) + y["change"].numel()) \
                * x.element_size()
            config = ops.configure(libs["change"], x, wt, stride=s, padding=pad, groups=groups)
            rows.append(dict(model=model, dtype=dname, shape=[BATCH, h, h, cin, cout], k=k, stride=s, pad=pad,
                             groups=groups, bias=has_bias, per_forward=calls, bit_identical=same,
                             device_us=us, library_us=lib_us, library_kernels=lib_kernels,
                             bound_us=nbytes / PEAK_BYTES_PER_S * 1e6, config=config))
            dw = config["depthwise"]
            how = f"{dw['copies']} {'x'.join(map(str, dw['tile']))} cb{dw['slab']}" if dw else config["gather"]
            times = ", ".join(f"{key} {' / '.join(f'{t:.2f}' for t in us[key])}" for key in turns[:2])
            print(f"{sig}{' bias' if has_bias else ''} x{calls}/fwd [{how}]: bit-identical {same}; "
                  f"device us/call {times}, F.conv2d {lib_us:.2f} ({sum(n for n, _ in lib_kernels.values()):g} "
                  f"kernels a call), bound {rows[-1]['bound_us']:.2f}")
    sums = {}
    for dname in ("float32", "bfloat16"):
        for model in ("convnext-b", "efficientnet-b7"):
            rs = [r for r in rows if r["model"] == model and r["dtype"] == dname]

            def ms(get):  # device ms a forward
                return sum(get(r) * r["per_forward"] for r in rs) / 1e3

            v = dict(calls=sum(r["per_forward"] for r in rs), library_ms=ms(lambda r: r["library_us"]),
                     bound_ms=ms(lambda r: r["bound_us"]))
            for key in libs:  # of the two turns, the faster and the slower
                v[f"{key}_ms"] = [ms(lambda r: span(r["device_us"][key])[0]),
                                  ms(lambda r: span(r["device_us"][key])[1])]
            v["slower_than_parent"] = [f"{r['shape']} k{r['k']} s{r['stride']}" for r in rs
                                       if span(r["device_us"]["change"])[0] > span(r["device_us"]["parent"])[0]]
            sums[f"{model}/{dname}"] = v
            times = ", ".join(f"{key} {v[key + '_ms'][0]:.4f}-{v[key + '_ms'][1]:.4f}" for key in turns[:2])
            print(f"per {dname} forward of {model} at batch {BATCH}, {v['calls']} depthwise calls, device ms: "
                  f"{times}; F.conv2d {v['library_ms']:.4f}; bytes bound {v['bound_ms']:.4f} "
                  f"({v['bound_ms'] / v['change_ms'][0]:.1%} of the change's); slower than the parent: "
                  f"{v['slower_than_parent'] or 'none'} (of the measured)")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(nvidia_smi=smi, parent=args.source, rows=rows, per_forward=sums,
                                   unmeasured=unmeasured), indent=1))
    print(f"all outputs bit-identical to the parent's: {same_all}")
    print(f"unmeasured after {TRIES} windows: {unmeasured or 'none'}")
    return 0 if same_all and not unmeasured else 1


if __name__ == "__main__":
    sys.exit(main())
