"""Compile one of the port's CUDA sources for the CPU, through the emulation
in ``tests/cuda_emu/cuda_shim.h``, and load it with ``ctypes``.

The source's local headers (``#include "....cuh"``) and the sources it
includes (``attention_diffusion.cu`` includes ``attention.cu``) are inlined, the CUDA
headers dropped, and every launch ``kernel<...><<<grid, block, smem,
stream>>>(args)`` rewritten to ``_emu_launch(grid, block, smem, stream,
kernel<...>, args)``; ``g++`` then builds a shared library with the same C
interface the wrapper calls on the card.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
SHIM = Path(__file__).resolve().parent / "cuda_emu" / "cuda_shim.h"
LAUNCH = re.compile(r"(\w+<[\w, ]+>)<<<(.*?)>>>\(")


def _inline(path: Path, seen: set) -> str:
    out = []
    for line in path.read_text().splitlines():
        m = re.match(r'#include "(.+\.cuh?)"', line)
        if m:
            hdr = (path.parent / m.group(1)).resolve()
            if hdr not in seen:
                seen.add(hdr)
                out.append(_inline(hdr, seen))
        elif re.match(r"#include <cuda_(bf16|runtime)\.h>", line) or line.strip() == "#pragma once":
            continue
        else:
            out.append(line)
    return "\n".join(out)


def emulated_source(path: Path) -> tuple[str, int]:
    """The C++20 text of a CUDA source for the shim, and its number of launches."""
    return LAUNCH.subn(r"_emu_launch(\2, \1, ", _inline(path, set()))


def build_emulated(path: Path, out_dir: Path, launches: int) -> ctypes.CDLL:
    """Compile ``path`` with g++ against the shim into ``out_dir``; skips the
    calling test when there is no g++.  ``launches`` is the number of kernel
    launches the source must hold."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    src, n = emulated_source(path)
    assert n == launches, f"expected {launches} kernel launches in {path.name}, found {n}"
    cpp = out_dir / f"{path.stem}_emu.cpp"
    lib = out_dir / f"lib{path.stem}_emu.so"
    cpp.write_text(src)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-include", str(SHIM),
         "-o", str(lib), str(cpp), "-lpthread"],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))
