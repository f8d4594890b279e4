#!/usr/bin/env python3
"""Time the block shapes and source variants of the port's flash-attention
kernel (K3) on the card, side by side in one process.

    python3 tools/k3_variants.py [--variants NAME ...] [--source FILE] [--probe]
                                 [--out chiprun_out/k3_variants.json]

A variant is a block shape -- the one the launcher picks ("auto"), or one
forced through ``flash_attention_fwd_shape``: 16 query rows x 4 key groups,
32 x 4, or 64 x 1 (the 64-row block with no key split) -- of
``src/repro_torch/kernels/attention/attention.cu`` as it is or with an edit
(``EDITS``).  ``--source`` builds another kernel instead (its ``auto`` or
``as-is`` variants only: e.g. the parent commit's ``attention.cu``).  Each
distinct source is compiled by ``nvcc`` for ``sm_90a`` with the port's
flags, all in parallel, into ``build/k3_variants/``, and called through the
wrapper's C interface.  At the ViT-L/16 path's attention shapes (batch 4, 8 /
5 / 3 heads of 16 over the 14x14 grid, D = 64, the model layout's strides,
non-causal) and a causal T = S = 256 -- with ``--probe`` also shapes that
take one block's time apart -- in float32 and bfloat16, each variant is held
against the plain version (2e-5 / 2e-2 x (1 + |y|)) and timed: device us per
call from a ``torch.profiler`` window over back-to-back launches (the event
time of a launch this short is the host's).  Prints one line per variant
and shape, the shape "auto" picked, and each variant's sum over one ViT
forward (24 calls of each head shard).  Needs the card, ``nvcc``, no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention.ops import BLOCK_SHAPES  # noqa: E402

SHAPE_NAMES = tuple(f"{r}x{g}" for r, g in BLOCK_SHAPES)  # flash_attention_fwd_shape's index
ATTENTION_DIR = ROOT / "src" / "repro_torch" / "kernels" / "attention"
OUT_DIR = ROOT / "build" / "k3_variants"

# Edits of the source, by name: (pattern, replacement).
EDITS = {
    # TF32 hi by truncation (one logic op) and lo passed unrounded (the tensor
    # cores read its top 19 bits), in place of two cvt.rna.tf32 per split
    "trunc-split": [(r"hi = sm90::cvt_tf32\(x\);\n  lo = sm90::cvt_tf32\(x - __uint_as_float\(hi\)\);",
                     "hi = __float_as_uint(x) & 0xffffe000u;\n  lo = __float_as_uint(x - __uint_as_float(hi));")],
    # key steps of 32 keys in place of 16: four independent 8-key tiles a step
    "kb32": [(r"constexpr int KB = \d+;", "constexpr int KB = 32;")],
    # ask for three resident 128-thread blocks per SM: at most 168 registers
    "lb3": [(r"__launch_bounds__\(32 \* WQ \* WK\)", "__launch_bounds__(32 * WQ * WK, WQ * WK == 4 ? 3 : 1)")],
}
# name -> (block shape index or None for the launcher's pick, edits)
VARIANTS = {
    "auto": (None, ()),
    "16x4": (0, ()),
    "32x4": (1, ()),
    "64x1": (2, ()),
    "auto-trunc": (None, ("trunc-split",)),
    "auto-kb32": (None, ("kb32",)),
    "auto-lb3": (None, ("lb3",)),
    "as-is": (None, ()),  # --source unchanged, through flash_attention_fwd
}
# (B, H, T, S, causal, calls per ViT forward)
SHAPES = [(4, 8, 196, 196, False, 24), (4, 5, 196, 196, False, 24), (4, 3, 196, 196, False, 24),
          (4, 16, 256, 256, True, 0)]
# with --probe: where one block's time goes -- no keys (Q, merge, store), one
# key step per warp, and a lone 16-row tile of one head
PROBES = [(4, 3, 196, 0, False, 0), (4, 3, 196, 64, False, 0), (1, 1, 16, 196, False, 0),
          (1, 1, 16, 0, False, 0), (1, 1, 16, 16, False, 0)]
D = 64
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def edited_source(source: Path, edits) -> str:
    src = source.read_text()
    for edit in edits:
        for pattern, repl in EDITS[edit]:
            src, n = re.subn(pattern, repl, src)
            if n == 0:
                raise SystemExit(f"k3_variants: edit {edit} matches nothing in {source}")
    return src


def build(source: Path, edits) -> tuple[tuple, ctypes.CDLL, str]:
    d = OUT_DIR / "-".join((source.stem,) + tuple(edits))
    d.mkdir(parents=True, exist_ok=True)
    cu = d / "attention.cu"
    cu.write_text(edited_source(source, edits))
    lib = d / "libattention.so"
    # the source includes "../sm90_ops.cuh": found through the attention directory
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(ATTENTION_DIR), "-o", str(lib), str(cu)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"k3_variants: nvcc failed on {cu}:\n{proc.stderr}")
    return tuple(edits), ctypes.CDLL(str(lib)), proc.stdout + proc.stderr


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    args = [p, p, p, p, i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, i, p]
    lib.flash_attention_fwd.argtypes = args
    if hasattr(lib, "flash_attention_fwd_shape"):
        lib.flash_attention_fwd_shape.argtypes = args + [i]
        lib.flash_attention_shape.argtypes = [p, p, p, i, i, i, i, i, i, i,
                                              ctypes.POINTER(ctypes.c_longlong), i, i]
    lib.kernel_error_string.argtypes = [i]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def call(torch, lib, q, k, v, causal: bool, shape=None):
    """The wrapper's launch (``ops.py: _launch``) through a variant's library."""
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*[st for x in (q, k, v, o) for st in x.stride()[:3]])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 0 if q.dtype == torch.float32 else 1,
            b, h, k.shape[1], t, k.shape[2], d, strides, 1.0 / math.sqrt(d), int(causal),
            q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream)
    err = lib.flash_attention_fwd(*args) if shape is None else lib.flash_attention_fwd_shape(*args, shape)
    if err != 0:
        raise RuntimeError(f"launch failed: {lib.kernel_error_string(err).decode()}")
    return o


def picked(torch, lib, q, k, v, causal: bool) -> str:
    """The block shape the launcher picks for this call ("-" for a kernel without the choice)."""
    if not hasattr(lib, "flash_attention_shape"):
        return "-"
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 12)(*[st for x in (q, k, v, q) for st in x.stride()[:3]])
    c = lib.flash_attention_shape(q.data_ptr(), k.data_ptr(), v.data_ptr(), 0 if q.dtype == torch.float32 else 1,
                                  b, h, k.shape[1], t, k.shape[2], d, strides, int(causal), q.device.index or 0)
    return SHAPE_NAMES[c] if 0 <= c < len(SHAPE_NAMES) else f"error {c}"


def device_us(torch, fn, reps: int = 20) -> float:
    """Device us per call in a profiler window over ``reps`` calls of ``fn``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA]
    total, count = sum(a.self_device_time_total for a in rows), sum(a.count for a in rows)
    # a window may drop events: the mean kernel's time x the kernels a call launches
    return total / count * max(1, round(count / reps)) if total > 0 else float("nan")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=["auto", "16x4", "32x4", "64x1"], choices=sorted(VARIANTS))
    ap.add_argument("--source", help="another attention.cu to build (variants auto / as-is)")
    ap.add_argument("--probe", action="store_true", help="also time the latency probes (PROBES)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "k3_variants.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k3_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.attention import attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    source = Path(args.source).resolve() if args.source else ATTENTION_DIR / "attention.cu"
    edit_sets = sorted({VARIANTS[n][1] for n in args.variants})
    with ThreadPoolExecutor(max_workers=len(edit_sets)) as pool:
        built = list(pool.map(lambda e: build(source, e), edit_sets))
    libs = {}
    for edits, lib, log in built:
        libs[edits] = bind(lib)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {'-'.join(edits) or source.name}: {line.strip()[:160]}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).removeprefix("torch.")
        for b, h, t, s, causal, per_fwd in SHAPES + (PROBES if args.probe else []):
            # [B, T, H*D] buffers seen as [B, H, T, D]: the ViT's layout
            q, k, v = (torch.randn((b, n, h * D), generator=gen, device="cuda").to(dt)
                       .view(b, n, h, D).transpose(1, 2) for n in (t, s, s))
            want = attention_ref(q, k, v, causal=causal).float()
            for name in args.variants:
                shape, edits = VARIANTS[name]
                lib = libs[edits]
                got = call(torch, lib, q, k, v, causal, shape).float()
                ok = bool(((got - want).abs() <= TOL[dname] * (1 + want.abs())).all())
                us = device_us(torch, lambda: call(torch, lib, q, k, v, causal, shape))
                pick = SHAPE_NAMES[shape] if shape is not None else picked(torch, lib, q, k, v, causal)
                rows.append(dict(variant=name, block=pick, dtype=dname, b=b, h=h, t=t, s=s, causal=causal,
                                 per_forward=per_fwd, device_us=us, within_tol=ok,
                                 max_abs_err=(got - want).abs().max().item()))
                print(f"{name:10s} {dname:8s} B{b} H{h} T{t} S{s}{' causal' if causal else ''} [{pick}]: "
                      f"device {us:.2f} us/call, max_err {rows[-1]['max_abs_err']:.3g}"
                      f"{'' if ok else '  OUT OF TOLERANCE'}")
    for dname in TOL:
        for name in args.variants:
            ms = sum(r["device_us"] * r["per_forward"] for r in rows
                     if r["variant"] == name and r["dtype"] == dname) / 1e3
            print(f"per ViT forward, {dname}, {name}: {ms:.4f} device ms")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(nvidia_smi=smi, source=str(source), rows=rows), indent=1))
    return 0 if all(r["within_tol"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
