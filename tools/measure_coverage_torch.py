"""Measure line coverage of src/repro_torch without coverage.py installed.

The port's twin of ``tools/measure_coverage.py``: the same arguments, the
same ``sys.settrace`` tracer and executable-line recovery (a copy of that
tool's, as the port keeps its own copy of what it needs), restricted to
``src/repro_torch`` files, and the same JSON, plus ``unreached``: for every
file, the executable lines no test of the run reached, as ranges.  On the CPU those are, besides untested code,
the card's routes (kernel launches, CUDA-only branches), which only
``chip_smoke.py`` drives.

Usage::

    python tools/measure_coverage_torch.py [pytest args...]

Runs the full tier-1 suite by default; pass a subset of test files to get a
cheaper lower bound (a subset can only under-count coverage).
"""
from __future__ import annotations

import dis
import json
import pathlib
import sys
import threading

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
PREFIX = str(PACKAGE) + "/"

executed: dict[str, set[int]] = {}


def _tracer(frame, event, arg):
    filename = frame.f_code.co_filename
    if not filename.startswith(PREFIX):
        return None
    lines = executed.setdefault(filename, set())
    lines.add(frame.f_lineno)

    def local(frame, event, arg):
        if event == "line":
            lines.add(frame.f_lineno)
        return local

    return local


def _code_lines(code) -> set[int]:
    lines = {line for _, line in dis.findlinestarts(code) if line is not None}
    for const in code.co_consts:
        if hasattr(const, "co_code"):
            lines |= _code_lines(const)
    return lines


def _ranges(lines) -> str:
    """Sorted line numbers as ``a-b`` runs, comma-separated."""
    out, start, prev = [], None, None
    for n in sorted(lines):
        if start is None:
            start = prev = n
        elif n == prev + 1:
            prev = n
        else:
            out.append(f"{start}-{prev}" if prev > start else str(start))
            start = prev = n
    if start is not None:
        out.append(f"{start}-{prev}" if prev > start else str(start))
    return ",".join(out)


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import pytest

    sys.settrace(_tracer)
    threading.settrace(_tracer)
    rc = pytest.main(["-q", "-p", "no:cacheprovider", *argv])
    sys.settrace(None)
    threading.settrace(None)

    total = covered = 0
    per_file, unreached = {}, {}
    for path in sorted(PACKAGE.rglob("*.py")):
        lines = _code_lines(compile(path.read_text(), str(path), "exec"))
        hit = lines & executed.get(str(path), set())
        name = str(path.relative_to(ROOT))
        per_file[name] = (len(hit), len(lines))
        missed = lines - hit - {0}  # line 0: a module's own start, which no trace reports
        if missed:
            unreached[name] = _ranges(missed)
        total += len(lines)
        covered += len(hit)
    print(json.dumps(dict(
        pytest_exit=int(rc),
        covered=covered,
        total=total,
        pct=round(100.0 * covered / total, 2),
        worst=sorted(per_file.items(), key=lambda kv: kv[1][0] / max(1, kv[1][1]))[:10],
        unreached=unreached,
    ), indent=2))
    return int(rc)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
