"""Static verification of built job/message DAGs (the port's copy of
``repro/analysis/dag_check.py``).

Works on any ``repro_torch.core.simulator.Sim`` (list of ``Job``\\ s with explicit
dependencies plus implicit per-resource FIFO order) -- the objects laid by
``events.build_halp_dag`` / ``events.build_scheme_dag`` and embedded in
``events.DagTemplate``.  Checks:

* **Event-order consistency** (``dag.event-order``): every explicit
  dependency points backwards in submission order.  ``Sim.run`` rejects a
  forward dependency at run time; here it is caught without running.
* **Deadlock freedom** (``dag.deadlock``): the precedence digraph -- explicit
  dependency edges *plus* the per-resource FIFO edges ``Sim._merged_deps``
  folds in -- must be acyclic.  A cycle means the list schedule (and the
  vectorized ``Sim.run_batch`` longest-path sweep) could never complete: a
  static race/deadlock detector.
* **Transfer endpoints** (``dag.transfer``): a job on ``link:src->dst`` may
  only depend on work at ``src`` (compute on ``src`` or a transfer arriving
  at ``src``), and may only be consumed by work at ``dst`` (compute on
  ``dst`` or a transfer departing ``dst``) -- data cannot teleport.
* **Orphan transfers** (``dag.orphan``): a positive-duration transfer with no
  consumer means rows are shipped and never used.  One documented exception
  is exempt: the seed convention prices each secondary's *last-layer*
  boundary send both as a ``msg[...]`` job and in the ``final[...]`` merge
  (see ``events.sec_step``), so an unconsumed ``msg[t]...`` job is allowed
  iff a later ``final[t]...`` job exists on the same link for the same task.

:func:`check_template` additionally audits a ``DagTemplate``'s duration
factorisation against the scalar builder node-for-node: for the quantity
vector of the candidate the template was built from, ``nums * q / rate`` must
reproduce every job's scalar-priced duration bit-for-bit.
"""
from __future__ import annotations

import re

from .findings import Report

__all__ = ["check_dag", "check_template"]

_TASK_RE = re.compile(r"^[a-z]+\[(\d+)\]")


def _task_of(name: str) -> str | None:
    m = _TASK_RE.match(name)
    return m.group(1) if m else None


def _link_endpoints(resource: str) -> tuple[str, str] | None:
    if not resource.startswith("link:") or "->" not in resource:
        return None
    src, dst = resource[5:].split("->", 1)
    return src, dst


def check_dag(sim) -> Report:
    """Statically verify a built DAG; returns a Report (never raises)."""
    rep = Report()
    jobs = list(sim.jobs)
    n = len(jobs)
    if not jobs:
        rep.add("dag.empty", "sim", "no jobs")
        return rep

    # --- explicit deps must point backwards (Sim.run's contract)
    edges: list[list[int]] = [[] for _ in range(n)]  # dep -> successors
    consumers: list[list[int]] = [[] for _ in range(n)]  # explicit only
    for job in jobs:
        for d in job.deps:
            rep.tick()
            if not 0 <= d < n:
                rep.add(
                    "dag.event-order",
                    f"job {job.jid} ({job.name})",
                    f"depends on nonexistent job {d}",
                )
                continue
            if d >= job.jid:
                rep.add(
                    "dag.event-order",
                    f"job {job.jid} ({job.name}) on {job.resource}",
                    f"depends on later job {d} ({jobs[d].name}): resource FIFO "
                    f"edges are inconsistent with event order",
                )
            edges[d].append(job.jid)
            consumers[d].append(job.jid)

    # --- FIFO edges: previous job on the same resource precedes the next
    last_on: dict[str, int] = {}
    for job in jobs:
        prev = last_on.get(job.resource)
        if prev is not None:
            edges[prev].append(job.jid)
        last_on[job.resource] = job.jid

    # --- cycle detection over deps + FIFO edges (Kahn; leftovers = cycles)
    rep.tick()
    indeg = [0] * n
    for succs in edges:
        for j in succs:
            if 0 <= j < n:
                indeg[j] += 1
    queue = [j for j in range(n) if indeg[j] == 0]
    seen = 0
    while queue:
        u = queue.pop()
        seen += 1
        for v in edges[u]:
            if 0 <= v < n:
                indeg[v] -= 1
                if indeg[v] == 0:
                    queue.append(v)
    if seen < n:
        stuck = [j for j in range(n) if indeg[j] > 0]
        cycle = _find_cycle(edges, stuck)
        names = " -> ".join(
            f"{jobs[j].name}@{jobs[j].resource}" for j in cycle[:6]
        )
        rep.add(
            "dag.deadlock",
            f"{len(stuck)} job(s) unreachable",
            f"dependency + resource-FIFO edges form a cycle ({names}"
            f"{' -> ...' if len(cycle) > 6 else ''}): Sim.run_batch's "
            f"longest-path sweep would never converge",
        )

    # --- transfer producer/consumer endpoint locality + orphans
    finals_on: dict[tuple[str, str | None], int] = {}
    for job in jobs:
        if job.name.startswith("final[") and _link_endpoints(job.resource):
            finals_on[(job.resource, _task_of(job.name))] = job.jid

    for job in jobs:
        ends = _link_endpoints(job.resource)
        if ends is None:
            continue
        src, dst = ends
        for d in job.deps:
            if not 0 <= d < n:
                continue
            rep.tick()
            dep = jobs[d]
            dep_ends = _link_endpoints(dep.resource)
            ok = (dep.resource == src) if dep_ends is None else (dep_ends[1] == src)
            if not ok:
                rep.add(
                    "dag.transfer",
                    f"job {job.jid} ({job.name}) on {job.resource}",
                    f"producer {dep.name} runs on {dep.resource}, not at the "
                    f"link's source {src!r}: the transferred rows would not "
                    f"exist at departure",
                )
        rep.tick()
        bad_consumers = []
        for c in consumers[job.jid]:
            con = jobs[c]
            con_ends = _link_endpoints(con.resource)
            ok = (con.resource == dst) if con_ends is None else (con_ends[0] == dst)
            if not ok:
                bad_consumers.append(con)
        for con in bad_consumers:
            rep.add(
                "dag.transfer",
                f"job {job.jid} ({job.name}) on {job.resource}",
                f"consumer {con.name} runs on {con.resource}, not at the "
                f"link's destination {dst!r}: the rows arrive where nothing "
                f"reads them",
            )
        if job.duration > 0 and not consumers[job.jid]:
            exempt = False
            if job.name.startswith("msg["):
                fin = finals_on.get((job.resource, _task_of(job.name)))
                exempt = fin is not None and fin > job.jid
            if not exempt:
                rep.add(
                    "dag.orphan",
                    f"job {job.jid} ({job.name}) on {job.resource}",
                    f"positive-duration transfer ({job.duration:.3g}s) with no "
                    f"consumer: rows shipped to {dst!r} are never used",
                )
    return rep


def _find_cycle(edges: list[list[int]], stuck: list[int]) -> list[int]:
    """One concrete cycle among the nodes Kahn could not clear."""
    stuck_set = set(stuck)
    start = stuck[0]
    path: list[int] = []
    pos: dict[int, int] = {}
    u = start
    while u not in pos:
        pos[u] = len(path)
        path.append(u)
        u = next((v for v in edges[u] if v in stuck_set), None)
        if u is None:  # pragma: no cover - stuck nodes always have a stuck succ
            return path
    return path[pos[u] :]


def check_template(template, quantities, topology) -> Report:
    """Audit a ``DagTemplate``'s factorisation against its scalar builder.

    ``quantities`` must be the quantity vector of the candidate the template's
    ``sim`` was laid for (``events._layout_quantities`` /
    ``events._scheme_quantities``); every job's ``nums[j] * q[j] / rate[j]``
    must equal the duration the scalar builder priced, bit-for-bit."""
    import numpy as np

    rep = Report()
    jobs = template.sim.jobs
    q = np.asarray(quantities, dtype=np.float64).reshape(-1)
    rep.tick()
    if len(q) != len(jobs):
        rep.add(
            "dag.template",
            "quantity walk",
            f"{len(q)} quantities for {len(jobs)} builder jobs: the layout "
            f"walk and the DAG builder fell out of step",
        )
        return rep
    ref = template.durations(q, topology)[0]
    for j, job in enumerate(jobs):
        rep.tick()
        if ref[j] != job.duration:
            rep.add(
                "dag.template",
                f"job {j} ({job.name}) on {job.resource}",
                f"template factorisation prices {ref[j]!r} but the scalar "
                f"builder priced {job.duration!r}: nums/den lanes diverge from "
                f"the event builder",
            )
    return rep
