"""Discrete-event simulator for collaborative-ES schedules (ground truth;
the port's copy of ``repro/core/simulator.py``, plain Python and numpy).

The paper's closed-form recursions (eqs. 16-20, 22-23) approximate a job/message
DAG executed by FIFO compute resources (the ESs) and full-duplex point-to-point
links.  This module simulates that DAG exactly:

* every compute chunk and every message is a :class:`Job` bound to a resource,
* a resource serves its jobs in submission order (list scheduling -- the paper's
  schedule is static), a job starts when its resource is free *and* all
  dependencies have finished,
* the makespan of the sink job is the inference time.

The HALP DAG itself is laid out by ``repro_torch.core.events.build_halp_dag`` -- the
same plan-walk the closed form prices -- so the two engines cross-validate on
identical structure (``tests/test_torch_engines.py``).  Arbitrary
:class:`~repro_torch.core.topology.CollabTopology` instances are supported: N
secondaries, per-ES platforms, per-link rates.  The same engine doubles as a
straggler / fault-injection harness: per-resource slowdown factors model node
degradation at scale.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from .events import build_halp_dag, init_bytes, resolve_halp_setup
from .nets import ConvNetGeom
from .partition import HALPPlan, plan_even
from .reliability import IMAGE_BYTES
from .topology import CollabTopology, Link, Platform

__all__ = [
    "Sim",
    "Job",
    "BatchRun",
    "simulate_halp",
    "simulate_modnn",
    "enhanced_modnn_delay",
    "GaussMarkovTrace",
    "replay_trace",
    "replay_rate_trace",
    "serve_latency_table",
]


@dataclass
class Job:
    jid: int
    name: str
    resource: str
    duration: float
    deps: tuple[int, ...]
    start: float = 0.0
    finish: float = 0.0


@dataclass
class BatchRun:
    """Result of :meth:`Sim.run_batch`: one DES sweep over B duration vectors.

    ``makespan[b]`` is candidate ``b``'s makespan; ``finish[j, b]`` the finish
    time of job ``j`` under candidate ``b`` (``finish_of`` mirrors
    :meth:`Sim.finish_of` for per-task head lookups)."""

    makespan: np.ndarray  # [B]
    finish: np.ndarray  # [J, B]

    def finish_of(self, jid: int) -> np.ndarray:
        return self.finish[jid]


class Sim:
    """Static list-scheduling simulator over FIFO resources."""

    def __init__(self) -> None:
        self.jobs: list[Job] = []
        self.slowdown: dict[str, float] = {}
        self._batch_deps: list[list[int]] | None = None

    def add(self, name: str, resource: str, duration: float, deps=()) -> int:
        jid = len(self.jobs)
        deps = tuple(d for d in deps if d is not None)
        self.jobs.append(Job(jid, name, resource, max(0.0, duration), deps))
        self._batch_deps = None
        return jid

    def run(self) -> float:
        """Resolve start/finish for all jobs; returns the makespan."""
        free: dict[str, float] = {}
        # Jobs on a resource are served in submission order (FIFO). Because a
        # later job on the same resource cannot start before an earlier one, a
        # single forward pass in submission order is exact as long as deps only
        # point backwards -- which the builders guarantee.
        for job in self.jobs:
            for d in job.deps:
                if d >= job.jid:
                    raise ValueError(f"forward dependency {d} -> {job.jid}")
            ready = max((self.jobs[d].finish for d in job.deps), default=0.0)
            start = max(ready, free.get(job.resource, 0.0))
            dur = job.duration * self.slowdown.get(job.resource, 1.0)
            job.start = start
            job.finish = start + dur
            free[job.resource] = job.finish
        return max((j.finish for j in self.jobs), default=0.0)

    def finish_of(self, jid: int) -> float:
        return self.jobs[jid].finish

    def _merged_deps(self) -> list[list[int]]:
        """Per-job dependency lists with the FIFO resource edge folded in.

        A job's start is ``max(dep finishes, previous job on its resource)``;
        adding the resource predecessor as an explicit edge turns the forward
        pass into a pure longest-path sweep, which is what lets ``run_batch``
        drop the per-candidate ``free`` bookkeeping.  Cached until the next
        :meth:`add`."""
        if self._batch_deps is None:
            merged: list[list[int]] = []
            last_on: dict[str, int] = {}
            for job in self.jobs:
                deps = list(job.deps)
                prev = last_on.get(job.resource)
                if prev is not None:
                    deps.append(prev)
                merged.append(deps)
                last_on[job.resource] = job.jid
            self._batch_deps = merged
        return self._batch_deps

    def run_batch(self, durations: np.ndarray | None = None) -> BatchRun:
        """Vectorized DES: score B duration vectors in one forward sweep.

        ``durations`` is a ``[B, J]`` (or ``[J]``) array of per-job durations
        -- typically produced by a :class:`~repro_torch.core.events.DagTemplate` for
        B candidate plans sharing this Sim's job/message structure; ``None``
        scores the jobs' own durations (B = 1).  Per-resource ``slowdown``
        factors apply exactly as in :meth:`run`.

        Bit-consistent with the scalar :meth:`run`: the same float operations
        run in the same dependency order, only batched across candidates
        (``tests/test_torch_engines.py`` pins float *equality*, not closeness).
        Unlike :meth:`run` this does not mutate job start/finish state."""
        n_jobs = len(self.jobs)
        if durations is None:
            durations = np.array([[job.duration for job in self.jobs]])
        else:
            durations = np.asarray(durations, dtype=np.float64)
            if durations.ndim == 1:
                durations = durations[None, :]
            if durations.shape[1] != n_jobs:
                raise ValueError(
                    f"durations have {durations.shape[1]} jobs, sim has {n_jobs}"
                )
        if self.slowdown:
            factors = np.array(
                [self.slowdown.get(job.resource, 1.0) for job in self.jobs]
            )
            durations = durations * factors
        n_batch = durations.shape[0]
        merged = self._merged_deps()
        if n_batch * n_jobs <= 4096:
            # Small batches: plain-float forward passes beat per-job numpy
            # dispatch overhead.  max/+ on Python floats and on float64 arrays
            # are the same IEEE-754 operations, so this path is bit-identical
            # to the vectorized one below.
            finish = np.empty((n_jobs, n_batch))
            for b in range(n_batch):
                dur_b = durations[b].tolist()
                fin: list[float] = [0.0] * n_jobs
                for j, deps in enumerate(merged):
                    ready = 0.0
                    for d in deps:
                        fd = fin[d]
                        if fd > ready:
                            ready = fd
                    fin[j] = ready + dur_b[j]
                finish[:, b] = fin
            makespan = finish.max(axis=0) if n_jobs else np.zeros(n_batch)
            return BatchRun(makespan=makespan, finish=finish)
        dur = np.ascontiguousarray(durations.T)  # [J, B]
        finish = np.empty((n_jobs, n_batch))
        maximum = np.maximum
        add = np.add
        for j, deps in enumerate(merged):
            row = finish[j]
            if not deps:
                row[:] = dur[j]
            elif len(deps) == 1:
                add(finish[deps[0]], dur[j], out=row)
            else:
                maximum(finish[deps[0]], finish[deps[1]], out=row)
                for d in deps[2:]:
                    maximum(row, finish[d], out=row)
                row += dur[j]
        makespan = finish.max(axis=0) if n_jobs else np.zeros(n_batch)
        return BatchRun(makespan=makespan, finish=finish)


def _chunk_time(net: ConvNetGeom, platform: Platform, i: int, rows: int) -> float:
    width = net.sizes()[i + 1]
    return platform.compute_time(net.layers[i].flops_per_out_row(width) * rows)


def simulate_halp(
    net: ConvNetGeom,
    platform: Platform | None = None,
    link: Link | None = None,
    overlap_rows: int | None = None,
    n_tasks: int = 1,
    host_platform: Platform | None = None,
    slowdown: dict[str, float] | None = None,
    topology: CollabTopology | None = None,
    ratios: Sequence[float] | None = None,
    plan: HALPPlan | None = None,
) -> dict:
    """Simulate HALP for ``n_tasks`` tasks on N*n_tasks secondaries + one host.

    Two calling conventions:

    * paper-style: ``simulate_halp(net, platform, link, ...)`` -- the symmetric
      two-secondary triple with one shared platform/link (``host_platform``
      optionally differing), exactly the paper's setting;
    * topology-style: ``simulate_halp(net, topology=topo, ...)`` -- arbitrary
      N-way heterogeneous clusters with per-ES platforms and per-link rates;
      ``ratios`` overrides the capacity-weighted segment split and ``plan``
      overrides the plan entirely.

    Resources: the host ES name (host compute), ``{slot}^{t}`` (secondary
    compute), ``link:a->b`` (directed point-to-point links; Ethernet full
    duplex).  The host serves the per-task zones in task order within each
    layer (paper §IV.B).  ``slowdown`` maps resource name -> multiplicative
    factor (straggler injection).
    """
    topology, plan = resolve_halp_setup(
        net, platform, link, overlap_rows, topology, ratios, plan, host_platform
    )
    plans = [plan for _ in range(n_tasks)]
    sim = Sim()
    if slowdown:
        sim.slowdown.update(slowdown)
    heads = build_halp_dag(sim, plans, topology)
    makespan = sim.run()
    finishes = [sim.finish_of(h) for h in heads]
    return dict(
        total=makespan,
        per_task_finish=finishes,
        avg_delay=sum(finishes) / len(finishes),
        sim=sim,
        plan=plan,
    )


def simulate_modnn(
    net: ConvNetGeom,
    platform: Platform,
    link: Link,
    n_workers: int,
    slowdown: dict[str, float] | None = None,
) -> dict:
    """Conventional layer-wise parallelization (MoDNN): synchronous halo
    exchange through the host after every CL; host NIC serialises transfers."""
    plan = plan_even(net, n_workers)
    names = plan.es_names
    host = names[0]
    sim = Sim()
    if slowdown:
        sim.slowdown.update(slowdown)
    n_layers = len(net.layers)
    last: dict[str, int | None] = {}
    gate: dict[str, int | None] = {}  # message that worker w waits on before layer i

    for w in names[1:]:
        gate[w] = sim.add(
            f"int.{w}", f"link:{host}->{w}", link.comm_time(init_bytes(plan, w))
        )
    gate[host] = None

    for i in range(n_layers):
        chunks = {}
        for w in names:
            rows = plan.parts[i].out[w].rows
            chunks[w] = sim.add(
                f"cmp.{w}.g{i}", w, _chunk_time(net, platform, i, rows), [last.get(w), gate.get(w)]
            )
        # synchronous exchange: gathers serialise on host RX, scatters on host TX,
        # and every worker waits for its scatter before the next layer.
        gathers = []
        for w in names:
            for v in names:
                if v == w:
                    continue
                nbytes = plan.message_bytes(i, w, v)
                if nbytes:
                    gathers.append(
                        sim.add(
                            f"gather.{w}->{v}.g{i}",
                            f"{host}:rx",
                            link.comm_time(nbytes),
                            [chunks[w]],
                        )
                    )
        barrier = sim.add(f"merge.g{i}", host, 0.0, [chunks[host]] + gathers)
        for w in names:
            need = sum(
                plan.message_bytes(i, v, w) for v in names if v != w
            )
            if w == host or need == 0.0:
                gate[w] = barrier
            else:
                gate[w] = sim.add(
                    f"scatter.->{w}.g{i}", f"{host}:tx", link.comm_time(need), [barrier]
                )
        last = dict(chunks)

    final = []
    for w in names[1:]:
        nbytes = net.feature_bytes(n_layers - 1, plan.parts[-1].out[w].rows)
        final.append(
            sim.add(f"final.{w}", f"{host}:rx", link.comm_time(nbytes), [last[w]])
        )
    head = sim.add("head", host, platform.compute_time(net.head_flops), final + [last[host]])
    total = sim.run()
    return dict(total=total, sim=sim)


@dataclass(frozen=True)
class GaussMarkovTrace:
    """Bounded Gauss-Markov (AR(1), mean-reverting) rate process.

    The standard mobility/channel fading model the paper's §V.D time-variant
    channel implies: each step reverts ``1 - corr`` of the way to ``mean`` and
    adds Gaussian innovation, clipped to [lo, hi].  ``corr=0`` is i.i.d.
    sampling; ``corr=1`` removes the mean reversion (a clipped random walk --
    combine with ``sigma_frac=0`` to freeze the channel).  Deterministic given
    ``seed`` -- every policy in a comparison replays the identical trace.

    The process is agnostic to what the rate measures: link traces are in
    bits/s, and the same class models per-ES *compute* drift (effective
    FLOP/s of a thermally-throttled or co-loaded straggler ES -- the DistrEdge
    / arXiv 2211.13778 testbed observation) for :func:`replay_trace`'s
    ``compute_rates``."""

    lo: float
    hi: float
    corr: float = 0.9
    sigma_frac: float = 0.15  # innovation std as a fraction of (hi - lo)
    mean: float | None = None  # reversion level; default: the band midpoint
    start: float | None = None  # initial rate; default: the reversion level
    seed: int = 0

    def __post_init__(self) -> None:
        if not self.lo < self.hi:
            raise ValueError(f"need lo < hi, got [{self.lo}, {self.hi}]")
        if not 0.0 <= self.corr <= 1.0:
            raise ValueError(f"corr must be in [0, 1], got {self.corr}")

    def rates(self, n: int) -> list[float]:
        """The first ``n`` rates of the process."""
        rng = random.Random(self.seed)
        mean = (self.lo + self.hi) / 2.0 if self.mean is None else self.mean
        sigma = self.sigma_frac * (self.hi - self.lo)
        x = mean if self.start is None else self.start
        out = []
        for _ in range(n):
            out.append(x)
            x = mean + self.corr * (x - mean) + rng.gauss(0.0, sigma)
            x = min(self.hi, max(self.lo, x))
        return out


def _compute_slowdown(
    topology: CollabTopology, true_flops: Mapping[str, float], n_tasks: int
) -> dict[str, float]:
    """Per-resource slowdown factors realising true per-ES compute rates.

    The DES prices compute jobs from the topology's *nominal* ``eff_flops``;
    an ES whose true effective rate is ``r`` therefore runs every one of its
    jobs ``nominal / r`` times slower.  Host jobs run on the host ES name;
    secondary jobs run on the per-task clone resources ``{es}^{t}`` laid by
    :func:`~repro_torch.core.events.build_halp_dag`, so the factor is applied to
    all ``n_tasks`` clones of a straggling secondary."""
    slow: dict[str, float] = {}
    for es, rate in true_flops.items():
        if es not in topology.platforms:
            raise ValueError(f"compute trace names {es!r}, not an ES of the topology")
        if rate <= 0:
            raise ValueError(f"compute rate for {es!r} must be positive, got {rate}")
        factor = topology.platform_of(es).eff_flops / rate
        if es == topology.host:
            slow[es] = factor
        else:
            for t in range(n_tasks):
                slow[f"{es}^{t}"] = factor
    return slow


def replay_trace(
    net: ConvNetGeom,
    topology: CollabTopology,
    planner,
    link_rates: Mapping[tuple[str, str], Sequence[float]] | None = None,
    compute_rates: Mapping[str, Sequence[float]] | None = None,
    n_epochs: int | None = None,
    n_tasks: int = 4,
    probe_bytes: float = float(IMAGE_BYTES),  # one image per link probe
    probe_flops: float = 1e9,  # one timed chunk per compute probe
) -> list[dict]:
    """Replay time-variant conditions through the DES, one plan per epoch.

    ``link_rates`` maps directed ES pairs to per-epoch true link rates and
    ``compute_rates`` maps ES names to per-epoch true effective FLOP/s (e.g.
    :meth:`GaussMarkovTrace.rates` for either); anything not listed stays at
    ``topology``'s nominal.  Per epoch the driver (a) asks ``planner`` for a
    plan -- the planner only ever sees *past* observations, so adaptive
    policies react with a one-epoch lag, exactly like a real serving loop --
    (b) simulates the makespan under the epoch's **true** rates: true link
    rates rebuild the topology's links, true compute rates map onto the DES
    through per-resource :attr:`Sim.slowdown` factors
    (``nominal_eff / true_eff`` on the ES's compute resources -- the same
    injection path the straggler/fault harness uses), and plans are
    geometry-only, so a stale plan is merely slow, never wrong -- and (c)
    feeds one observed ``probe_bytes`` transfer per traced link and one timed
    ``probe_flops`` execution per traced ES back to the planner.

    ``planner`` implements the replan protocol (``plan_for_epoch()`` +
    ``observe_transfer(src, dst, nbytes, elapsed_s)`` + -- when compute is
    traced -- ``observe_compute(es, flops, elapsed_s)``):
    :class:`~repro_torch.core.replan.StaticPlanner` for the paper's offline
    baseline, :class:`~repro_torch.core.replan.ReplanController` for the
    adaptive policies (link-only via ``ReplanConfig(adapt_compute=False)``,
    joint by default).  Returns one record per epoch with the true rates (``rates``
    for links, ``compute_rates`` per ES), the simulated makespan, the plan
    served, and -- for planners exposing ``stats()`` -- a snapshot of the
    planner's counters *after* serving the epoch (so cache hit rates over
    any window can be recovered from the records)."""
    link_rates = dict(link_rates or {})
    compute_rates = dict(compute_rates or {})
    if not link_rates and not compute_rates:
        raise ValueError(
            "need at least one trace: link_rates (directed pair -> rates) "
            "and/or compute_rates (ES -> effective FLOP/s)"
        )
    all_traces = list(link_rates.values()) + list(compute_rates.values())
    max_epochs = min(len(trace) for trace in all_traces)
    if n_epochs is None:
        n_epochs = max_epochs
    elif n_epochs > max_epochs:
        raise ValueError(
            f"n_epochs={n_epochs} exceeds the shortest trace ({max_epochs} "
            f"entries); extend the traces or drop n_epochs"
        )
    results = []
    for epoch in range(n_epochs):
        plan = planner.plan_for_epoch()
        rates = {pair: trace[epoch] for pair, trace in link_rates.items()}
        flops_now = {es: trace[epoch] for es, trace in compute_rates.items()}
        true_topology = topology.with_links({p: Link(r) for p, r in rates.items()})
        sim = simulate_halp(
            net,
            topology=true_topology,
            n_tasks=n_tasks,
            plan=plan,
            slowdown=_compute_slowdown(topology, flops_now, n_tasks) or None,
        )
        for (src, dst), rate in rates.items():
            planner.observe_transfer(src, dst, probe_bytes, 8.0 * probe_bytes / rate)
        for es, rate in flops_now.items():
            planner.observe_compute(es, probe_flops, probe_flops / rate)
        record = dict(
            epoch=epoch, rates=rates, compute_rates=flops_now,
            makespan=sim["total"], plan=plan,
        )
        if hasattr(planner, "stats"):
            record["planner_stats"] = planner.stats()
        results.append(record)
    return results


def replay_rate_trace(
    net: ConvNetGeom,
    topology: CollabTopology,
    planner,
    link_rates: Mapping[tuple[str, str], Sequence[float]],
    n_epochs: int | None = None,
    n_tasks: int = 4,
    probe_bytes: float = float(IMAGE_BYTES),
) -> list[dict]:
    """Link-only replay (superseded by :func:`replay_trace`, kept as the
    established entry point): equivalent to ``replay_trace`` with no compute
    traces, so compute stays at the nominals throughout."""
    if not link_rates:
        raise ValueError("link_rates must map at least one directed pair to a trace")
    return replay_trace(
        net, topology, planner,
        link_rates=link_rates, n_epochs=n_epochs, n_tasks=n_tasks,
        probe_bytes=probe_bytes,
    )


def enhanced_modnn_delay(
    net: ConvNetGeom, platform: Platform, link: Link, n_es: int = 9, n_tasks: int = 4
) -> dict:
    """Paper §V.C 'Enhanced MoDNN': first (n_tasks - 1) tasks run in parallel on
    disjoint groups of n_es // (n_tasks - 1) ESs, the last on all n_es.

    Returns T^E1, T^E2, the average per-task delay T^E1 + T^E2/n_tasks and
    throughput n_tasks / (T^E1 + T^E2)."""
    group = n_es // (n_tasks - 1)
    t_e1 = simulate_modnn(net, platform, link, group)["total"]
    t_e2 = simulate_modnn(net, platform, link, n_es)["total"]
    return dict(
        T_E1=t_e1,
        T_E2=t_e2,
        avg_delay=t_e1 + t_e2 / n_tasks,
        throughput=n_tasks / (t_e1 + t_e2),
    )


def serve_latency_table(
    net: ConvNetGeom,
    platform: Platform | None = None,
    link: Link | None = None,
    overlap_rows: int | None = None,
    topology: CollabTopology | None = None,
    ratios: Sequence[float] | None = None,
    plan: HALPPlan | None = None,
    host_platform: Platform | None = None,
    max_batch: int = 8,
    scenarios: Sequence[Mapping[str, float]] | None = None,
) -> np.ndarray:
    """DES-priced service-time model for the serving loop: ``table[s, b-1]``
    is the makespan of a ``b``-task batch under scenario ``s``.

    This is the request-stream replay's pricing step: for each batch width
    ``b`` the full HALP DAG for ``b`` concurrent tasks is laid once
    (:func:`~repro_torch.core.events.build_halp_dag`) and every scenario's duration
    vector sweeps through :meth:`Sim.run_batch` in one vectorized pass, so a
    whole (scenario x batch-size) grid prices in milliseconds.  The serving
    loop (``repro_torch.runtime.serve.serve_trace``) then replays millions of
    requests against the table without touching the DES again -- the
    batched-DES division of labour that makes a simulated million-request day
    cost seconds.

    ``scenarios`` is a sequence of per-resource slowdown mappings (one table
    row each; ``None`` means the single nominal scenario).  Keys are either
    raw DES resource names (``"link:e0->a"``, ``"a^0"``) or bare ES names,
    which expand exactly like the straggler harness: the host applies to its
    own compute resource, a secondary to all ``b`` per-task clones
    ``{es}^{t}``.  Calling conventions for the cluster match
    :func:`simulate_halp` (paper-style ``(platform, link)`` or
    ``topology=``)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    topology, plan = resolve_halp_setup(
        net, platform, link, overlap_rows, topology, ratios, plan, host_platform
    )
    scen = list(scenarios) if scenarios is not None else [{}]
    if not scen:
        raise ValueError("scenarios must be non-empty when given")
    table = np.empty((len(scen), max_batch))
    for b in range(1, max_batch + 1):
        sim = Sim()
        build_halp_dag(sim, [plan] * b, topology)
        base = np.array([job.duration for job in sim.jobs])
        resources = [job.resource for job in sim.jobs]
        durations = np.empty((len(scen), len(sim.jobs)))
        for s, mapping in enumerate(scen):
            slow: dict[str, float] = {}
            for key, factor in mapping.items():
                if factor <= 0:
                    raise ValueError(f"slowdown for {key!r} must be positive, got {factor}")
                if key in topology.platforms and key != topology.host:
                    for t in range(b):
                        slow[f"{key}^{t}"] = factor
                elif key.startswith("link:") and "->" in key and "^" not in key:
                    # bare directed pair: expand the secondary end to its
                    # per-task clone resources, like the compute case above
                    src, dst = key[len("link:") :].split("->", 1)
                    for t in range(b):
                        src_r = src if src == topology.host else f"{src}^{t}"
                        dst_r = dst if dst == topology.host else f"{dst}^{t}"
                        slow[f"link:{src_r}->{dst_r}"] = factor
                else:
                    slow[key] = factor
            durations[s] = base * np.array([slow.get(r, 1.0) for r in resources])
        table[:, b - 1] = sim.run_batch(durations).makespan
    return table
