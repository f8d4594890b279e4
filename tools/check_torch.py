"""Static verification CLI: run every ``repro_torch.analysis`` analyzer, exit 1 on findings.

The PyTorch port's twin of ``tools/check.py``: the same flags, sections,
findings and summary lines, over ``repro_torch`` (no ``jax``, no
``repro``).  It always runs the config-keying lint (on the port's
``core/replan.py`` and ``core/planstore.py``), and optionally

* ``--store PATH`` -- verify every current-schema row of a persistent
  :class:`~repro_torch.core.planstore.PlanStore` artifact: payloads must
  deserialize (through the store's own unpickler, which resolves only the
  port's classes: a row the JAX package wrote is a finding, and nothing of
  it is imported) and every plan they carry must pass
  :func:`~repro_torch.analysis.check_plan` (the same verifier
  ``PlanStore.get`` applies online);
* ``--benchmarks`` -- rebuild the benchmark/demo configurations (the demo
  cluster of ``tools/precompute_plans_torch.py``, full VGG-16, ViT-L/16) and
  push each through all four analyzers: plan invariants, DAG
  acyclicity/transfer/orphan checks, template-vs-scalar duration audits, and
  the kernel geometry of the halo-conv kernel K2, probed by its wrapper's own
  argument check on ``meta`` tensors (no launch).  K2 takes no tile height,
  so an accepted geometry of two or more output rows counts one check fewer
  than the JAX tool's ``jax.eval_shape`` pass
  (``repro_torch/analysis/kernel_check.py``).

No findings -> exit 0 and a one-line summary per section.  Any finding ->
printed as ``[check] where: detail`` and exit 1.

Usage::

    python tools/check_torch.py                       # keying lint only
    python tools/check_torch.py --store plans_warm.sqlite --benchmarks
"""
from __future__ import annotations

import argparse
import io
import sqlite3
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch.analysis import (  # noqa: E402
    Report,
    check_dag,
    check_keying,
    check_plan,
    check_plan_kernels,
    check_template,
)
from repro_torch.core.nets import vgg16_geom, vit_l16_geom  # noqa: E402
from repro_torch.core.partition import (  # noqa: E402
    plan_halp_topology,
    plan_layout,
    plan_scheme,
    scheme_layout,
)
from repro_torch.core.planstore import PLAN_SCHEMA_VERSION, _PortUnpickler  # noqa: E402


def _plans_of(payload) -> list:
    """Every plan object a stored payload carries (OptimizeResult ``.plan``,
    TaskPlacement ``.plans``, PlacementResult ``.placement.plans``)."""
    plans = getattr(payload, "plans", None)
    if plans is None:
        plans = getattr(getattr(payload, "placement", None), "plans", None)
    if plans is not None:
        return list(plans)
    plan = getattr(payload, "plan", None)
    return [] if plan is None else [plan]


def check_store(path: str) -> Report:
    """Verify every current-schema row of a PlanStore sqlite file."""
    rep = Report()
    if not Path(path).exists():
        rep.add("store.payload", path, "store file does not exist")
        return rep
    conn = sqlite3.connect(path)
    try:
        rows = conn.execute(
            "SELECT key_text, payload FROM plans WHERE schema_version = ?",
            (PLAN_SCHEMA_VERSION,),
        ).fetchall()
    finally:
        conn.close()
    for key_text, payload in rows:
        where = key_text if len(key_text) <= 64 else key_text[:61] + "..."
        rep.tick()
        try:
            obj = _PortUnpickler(io.BytesIO(payload)).load()
        except Exception as exc:
            rep.add("store.payload", where, f"payload failed to deserialize: {exc!r}")
            continue
        for plan in _plans_of(obj):
            sub = check_plan(plan)
            rep.tick(sub.checks)
            for f in sub.findings:
                rep.add(f.check, f"{where} :: {f.where}", f.detail)
    return rep


def check_benchmarks() -> Report:
    """Rebuild the benchmark/demo configurations and verify plans, DAGs,
    templates, and kernel geometries statically."""
    from precompute_plans_torch import demo_net, demo_topology
    from repro_torch.core.events import (
        DagTemplate,
        _layout_quantities,
        _scheme_quantities,
        _scheme_template,
        build_halp_dag,
        build_scheme_dag,
    )
    from repro_torch.core.simulator import Sim

    rep = Report()
    demo, topo = demo_net(), demo_topology()
    secs = topo.secondaries
    cases = [
        ("demo/halo", demo, topo),
        ("vgg16/halo", vgg16_geom(), topo),
    ]

    # --- plan invariants + fused-kernel geometry (halo plans)
    for label, net, top in cases:
        plan = plan_halp_topology(net, top)
        for sub in (check_plan(plan), check_plan_kernels(plan)):
            rep.tick(sub.checks)
            for f in sub.findings:
                rep.add(f.check, f"{label} :: {f.where}", f.detail)

    # --- mixed-scheme plans (conv net + the attention net)
    for label, net in (("vgg16/scheme", vgg16_geom()), ("vit_l16/scheme", vit_l16_geom())):
        plan = plan_scheme(net, topo)
        for sub in (check_plan(plan), check_plan_kernels(plan)):
            rep.tick(sub.checks)
            for f in sub.findings:
                rep.add(f.check, f"{label} :: {f.where}", f.detail)

    # --- built DAGs: halo (per-task clones) and mixed-scheme
    sim = Sim()
    build_halp_dag(sim, [plan_halp_topology(demo, topo)], topo)
    sub = check_dag(sim)
    rep.tick(sub.checks)
    for f in sub.findings:
        rep.add(f.check, f"demo/halo-dag :: {f.where}", f.detail)

    slay = scheme_layout(vit_l16_geom(), secs, host=topo.host)
    sim = Sim()
    build_scheme_dag(sim, slay, 2, topo)
    sub = check_dag(sim)
    rep.tick(sub.checks)
    for f in sub.findings:
        rep.add(f.check, f"vit_l16/scheme-dag :: {f.where}", f.detail)

    # --- template factorisation audits (build-time assert -> finding)
    lay = plan_layout(demo, secs, host=topo.host)
    try:
        tmpl = DagTemplate.from_layouts([lay], topo, physical=False)
    except AssertionError as exc:
        rep.add("dag.template", "demo/halo-template", f"build-time self-check failed: {exc}")
    else:
        sub = check_template(tmpl, _layout_quantities([lay]), topo)
        rep.tick(sub.checks)
        for f in sub.findings:
            rep.add(f.check, f"demo/halo-template :: {f.where}", f.detail)
    try:
        stmpl = _scheme_template(slay, 1, topo)
    except AssertionError as exc:
        rep.add("dag.template", "vit_l16/scheme-template", f"build-time self-check failed: {exc}")
    else:
        sub = check_template(stmpl, _scheme_quantities(slay, 1), topo)
        rep.tick(sub.checks)
        for f in sub.findings:
            rep.add(f.check, f"vit_l16/scheme-template :: {f.where}", f.detail)
    return rep


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", help="PlanStore sqlite file to verify row-by-row")
    ap.add_argument(
        "--benchmarks",
        action="store_true",
        help="verify the benchmark/demo plan, DAG, template, kernel configs",
    )
    args = ap.parse_args(argv)

    sections: list[tuple[str, Report]] = []
    t0 = time.perf_counter()
    sections.append(("keying", check_keying()))
    if args.store:
        sections.append((f"store {args.store}", check_store(args.store)))
    if args.benchmarks:
        sections.append(("benchmarks", check_benchmarks()))

    failures = 0
    for label, rep in sections:
        status = "ok" if rep.ok else f"{len(rep.findings)} finding(s)"
        print(f"{label}: {status} ({rep.checks} checks)")
        for f in rep.findings:
            failures += 1
            print(f"  {f}")
    print(f"total: {failures} finding(s) in {time.perf_counter() - t0:.2f}s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
