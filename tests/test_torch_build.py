"""The kernel build cache (``repro_torch.kernels._build``) on the CPU, with a
stand-in for ``nvcc``: a script that writes the output file, prints a
``ptxas``-style line and counts its calls.  What ``nvcc``/``ptxas`` printed
is kept beside the library, so a library reused from the build directory
reports the same registers and spills as when it was compiled."""
import os
import stat
import sys
from pathlib import Path

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = """#!{python}
import sys
from pathlib import Path
args = sys.argv[1:]
Path(args[args.index("-o") + 1]).write_bytes(b"not a library")
with open({calls!r}, "a") as f:
    f.write("x")
print("ptxas info    : Used 40 registers, 0 bytes spill stores, 0 bytes spill loads", file=sys.stderr)
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    src = tmp_path / "k.cu"
    src.write_text("// a source\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.BUILD_DIR.mkdir()
    return str(nvcc), src, (lambda: len(calls.read_text()) if calls.exists() else 0)


def test_reused_library_keeps_its_build_log(fake):
    nvcc, src, n_calls = fake
    out, log = _build._compile(nvcc, "k", src)
    assert n_calls() == 1 and out.is_file() and "Used 40 registers" in log
    again, log_again = _build._compile(nvcc, "k", src)
    assert n_calls() == 1, "an up-to-date library is reused, not rebuilt"
    assert again == out and log_again == log
    assert sorted(p.suffix for p in _build.BUILD_DIR.iterdir()) == [".log", ".so"]  # no temporaries left


def test_library_without_its_log_is_rebuilt(fake):
    nvcc, src, n_calls = fake
    out, log = _build._compile(nvcc, "k", src)
    os.remove(out.with_suffix(".log"))
    again, log_again = _build._compile(nvcc, "k", src)
    assert n_calls() == 2 and again == out and log_again == log
    src.write_text("// an edited source\n")
    edited, _ = _build._compile(nvcc, "k", src)
    assert n_calls() == 3 and edited != out and Path(edited).is_file()
