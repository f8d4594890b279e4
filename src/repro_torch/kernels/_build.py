"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Every ``*.cu`` file under ``repro_torch/kernels`` exposes a plain C interface
and is compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``).  All sources compile in parallel, one ``nvcc`` process each.
A library's file name carries a hash of its source, of every shared header
(``*.cuh`` under ``repro_torch/kernels``) and of the flags, so an edited
source or header is rebuilt and an unchanged one is reused.  No file includes PyTorch's
headers: such a file takes minutes to compile, a plain C interface seconds.

Nothing is compiled when this module is imported: the CPU tests import every
module of the port on a machine that has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
# kernels -> repro_torch -> src -> root of the checkout
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_build_logs: dict[str, str] = {}


def sources() -> dict[str, Path]:
    """The CUDA sources of the port, by library name (the file's stem)."""
    return {p.stem: p for p in sorted(KERNELS_DIR.rglob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built where a CUDA toolkit is")


def headers() -> list[Path]:
    """The shared headers a source may include, in a fixed order."""
    return sorted(KERNELS_DIR.rglob("*.cuh"))


def _lib_path(name: str, src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in headers():
        h.update(str(hdr.relative_to(KERNELS_DIR)).encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(nvcc: str, name: str, src: Path) -> tuple[Path, str]:
    out = _lib_path(name, src)
    if out.is_file():
        return out, ""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent reader never sees half a file
    return out, proc.stdout + proc.stderr


def build_all() -> float:
    """Compile every CUDA source that has no up-to-date library yet, all in
    parallel, and load each; returns the seconds it took.  Idempotent."""
    t0 = time.perf_counter()
    with _lock:
        todo = {n: s for n, s in sources().items() if n not in _libs}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            with ThreadPoolExecutor(max_workers=len(todo)) as pool:
                futs = {n: pool.submit(_compile, nvcc, n, s) for n, s in todo.items()}
                built = {n: f.result() for n, f in futs.items()}
            for n, (path, log) in built.items():
                _libs[n] = ctypes.CDLL(str(path))
                _build_logs[n] = log
    return time.perf_counter() - t0


def build_logs() -> dict[str, str]:
    """What ``nvcc``/``ptxas`` printed for each library built in this process
    (registers, shared memory and spills per kernel); empty when reused."""
    return dict(_build_logs)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from ``<name>.cu``, building first if needed."""
    if name not in _libs:
        build_all()
    return _libs[name]
