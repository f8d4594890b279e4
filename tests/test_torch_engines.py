"""The port's latency engines against the JAX package's, on the CPU.

``repro_torch.core.events`` / ``simulator`` / ``schedule`` and
``repro_torch.analysis.dag_check`` are plain Python and numpy copies of the
JAX modules, so every comparison here is **exact**: ``==`` on floats,
``np.array_equal`` on arrays, and the same types leaf for leaf in the
layout walks and signatures the DES caches key on (a numpy int against an
int would make templates miss or collide silently).  Each case builds the
same inputs in both packages (``M`` is the package's ``core``), runs the JAX
function and its port, and compares.

The port's own twins of ``tests/test_conformance.py``'s invariants close the
file: the vectorised DES equals the scalar one bit for bit, the closed form
is an upper bound on the DES within the pinned slack and never looser than
eq. 22, and the degenerate single-ES cell is exact.
"""
import dataclasses

import numpy as np
import pytest

import repro.analysis as janalysis
import repro.core as J
import repro_torch.analysis as tanalysis
import repro_torch.core as T
from repro.models import vgg as jvgg
from repro_torch.models import vgg
from test_torch_partition import NETS, assert_same_plan

RATES = (40e9, 60e9, 80e9, 100e9)  # benchmarks/paper_tables.py: RATES
SKEW_SCALES = (1.0, 0.5, 0.8, 0.3, 0.65)
SCHEME_RATIOS = (0.5, 0.3, 0.2)
VIT_SMALL = dict(in_rows=64, n_blocks=2, d=64, heads=4, d_ff=128)
LOWER_TOL = 1e-9
# tests/test_conformance.py: UPPER_SLACK, the closed form's pinned looseness
UPPER_SLACK = {
    (2, "sym", 1): 1.05, (2, "sym", 4): 1.11,
    (2, "skew", 1): 1.06, (2, "skew", 4): 1.26,
    (2, "sym-agx", 1): 1.04, (2, "sym-agx", 4): 1.05,
    (3, "sym", 1): 1.09, (3, "sym", 4): 1.11,
    (3, "skew", 1): 1.15, (3, "skew", 4): 1.49,
    (3, "sym-agx", 1): 1.05, (3, "sym-agx", 4): 1.05,
    (5, "sym", 1): 1.11, (5, "sym", 4): 1.08,
    (5, "skew", 1): 1.14, (5, "skew", 4): 1.22,
    (5, "sym-agx", 1): 1.05, (5, "sym-agx", 4): 1.05,
}
GRID = sorted(UPPER_SLACK)


def sym_topology(M, n, platform="GTX_1080TI"):
    return M.CollabTopology.symmetric(getattr(M, platform), M.Link(40e9), n_secondaries=n)


def skew_topology(M, n):
    """tests/test_conformance.py: skew_topology -- platforms x1.0 .. x0.3 with
    alternating 40/10 Gbps links."""
    secs = tuple(f"e{j}" for j in range(1, n + 1))
    platforms = {"e0": M.GTX_1080TI}
    links = {}
    for j, (s, scale) in enumerate(zip(secs, SKEW_SCALES)):
        platforms[s] = M.GTX_1080TI.scaled(scale, f"es x{scale:g}")
        rate = 10e9 if j % 2 else 40e9
        links[("e0", s)] = M.Link(rate)
        links[(s, "e0")] = M.Link(rate)
    return M.CollabTopology(host="e0", secondaries=secs, platforms=platforms,
                            links=links, default_link=M.Link(40e9))


def topology(M, kind, n):
    if kind == "skew":
        return skew_topology(M, n)
    return sym_topology(M, n, "AGX_XAVIER" if kind == "sym-agx" else "GTX_1080TI")


def smoke_net(M):
    return vgg.SMOKE.geom() if M is T else jvgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10).geom()


def same(a, b, path="") -> None:
    """Equal leaf for leaf, with the same leaf types (tuples, lists, dicts and
    dataclasses -- each package has its own classes, held by name -- recursed;
    numpy arrays by ``array_equal`` and dtype)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert type(a) is type(b) and a.dtype == b.dtype, path
        assert np.array_equal(a, b, equal_nan=True), path
        return
    assert type(a) is type(b), f"{path}: {type(a).__name__} != {type(b).__name__}"
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{k}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def jobs(sim):
    return [(j.jid, j.name, j.resource, j.duration, j.deps, j.start, j.finish) for j in sim.jobs]


def _report(rep):
    return [(f.check, f.where, f.detail) for f in rep.findings], rep.checks


# ---------------------------------------------------------------------------
# geometry bytes, layout walks, signatures and per-stage comm bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", sorted(NETS))
def test_total_flops_and_feature_bytes_match(net):
    g, jg = NETS[net]
    assert T.nets.DTYPE_BYTES == J.nets.DTYPE_BYTES
    same(g.total_flops(), jg.total_flops())
    for i in range(len(g.layers)):
        same(g.feature_bytes(i), jg.feature_bytes(i))
        same(g.feature_bytes(i, rows=3), jg.feature_bytes(i, rows=3))


LAYOUTS = [
    (("e1", "e2"), None, 2), (("e1", "e2"), None, 4), (("e1", "e2"), None, 6),
    (("e1", "e2"), (0.7, 0.3), 4),
    (("e1", "e2", "e3"), (0.5, 0.3, 0.2), 4),
    (("a", "b", "c", "d"), (0.4, 0.1, 0.1, 0.4), 2),
    (("e1", "e2", "e3"), (0.9, 0.05, 0.05), 8),
    (tuple(f"e{j}" for j in range(1, 6)), None, 4),  # idle slots
    (tuple(f"e{j}" for j in range(1, 7)), None, 4),  # auto-reduces at depth
    (tuple(f"e{j}" for j in range(1, 9)), None, 4),
]


@pytest.mark.parametrize("secs,ratios,overlap", LAYOUTS)
@pytest.mark.parametrize("net", ["vgg16_224", "smoke"])
def test_layout_walk_and_signature_match(net, secs, ratios, overlap):
    g, jg = NETS[net]
    kw = dict(host="e0", overlap_rows=overlap, ratios=ratios)
    lay, jlay = T.partition.plan_layout(g, secs, **kw), J.partition.plan_layout(jg, secs, **kw)
    same(lay.walk(), jlay.walk())
    same(lay.signature, jlay.signature)
    same(T.events._layout_quantities([lay, lay]), J.events._layout_quantities([jlay, jlay]))


def _assignments(M, net):
    spans = M.stage_spans(net)
    options = [M.stage_scheme_options(net, sp, M.SCHEMES) for sp in spans]
    halo = tuple(M.SCHEME_HALO if M.SCHEME_HALO in o else o[0] for o in options)
    np_ = tuple(M.SCHEME_NP if M.SCHEME_NP in o else o[0] for o in options)
    mixed = tuple((M.SCHEME_NP if si % 2 else o[0]) if M.SCHEME_NP in o else o[0]
                  for si, o in enumerate(options))
    mixed_even = tuple((o[0] if si % 2 else M.SCHEME_NP) if M.SCHEME_NP in o else o[0]
                       for si, o in enumerate(options))
    return {"halo": halo, "non_penetrative": np_, "mixed": mixed, "mixed_even": mixed_even}


def _scheme_net(M, name):
    return M.vgg16_geom() if name == "vgg16" else M.vit_l16_geom(**VIT_SMALL)


@pytest.mark.parametrize("kind", ["halo", "non_penetrative", "mixed", "mixed_even"])
@pytest.mark.parametrize("name", ["vgg16", "vit"])
def test_scheme_layout_signature_and_comm_bytes_match(name, kind):
    net, jnet = _scheme_net(T, name), _scheme_net(J, name)
    a, ja = _assignments(T, net)[kind], _assignments(J, jnet)[kind]
    assert a == ja
    kw = dict(overlap_rows=4, ratios=SCHEME_RATIOS)
    slay = T.scheme_layout(net, ("e1", "e2", "e3"), assignment=a, **kw)
    jslay = J.partition.scheme_layout(jnet, ("e1", "e2", "e3"), assignment=ja, **kw)
    same(slay.signature, jslay.signature)
    same(T.events._scheme_quantities(slay, 2), J.events._scheme_quantities(jslay, 2))
    topo, jtopo = skew_topology(T, 3), skew_topology(J, 3)
    plan = T.plan_scheme(net, topo, assignment=a, **kw)
    jplan = J.plan_scheme(jnet, jtopo, assignment=ja, **kw)
    same(T.comm_bytes_per_stage(plan), J.comm_bytes_per_stage(jplan))


HALO_PLANS = {
    "halp_w2": lambda M, g: M.partition.plan_halp(g, overlap_rows=2),
    "halp_w6": lambda M, g: M.partition.plan_halp(g, overlap_rows=6),
    "halp_n3": lambda M, g: M.plan_halp_n(g, secondaries=("e1", "e2", "e3"), ratios=(0.5, 0.3, 0.2)),
    "halp_n6": lambda M, g: M.plan_halp_n(g, secondaries=tuple(f"e{j}" for j in range(1, 7))),
    "even3": lambda M, g: M.plan_even(g, 3),
    "even5_weighted": lambda M, g: M.plan_even(g, 5, ratios=(1.0, 0.55, 0.35, 0.8, 0.3)),
}


@pytest.mark.parametrize("which", sorted(HALO_PLANS))
@pytest.mark.parametrize("net", ["vgg16_224", "smoke"])
def test_halo_comm_bytes_per_stage_match(net, which):
    g, jg = NETS[net]
    plan, jplan = HALO_PLANS[which](T, g), HALO_PLANS[which](J, jg)
    assert_same_plan(plan, jplan)
    same(T.comm_bytes_per_stage(plan), J.comm_bytes_per_stage(jplan))
    same(T.partition._halo_plan_comm_bytes(plan), J.partition._halo_plan_comm_bytes(jplan))


# ---------------------------------------------------------------------------
# DAG builders, the simulator and the closed form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_sec,kind,n_tasks", GRID)
def test_halp_dag_jobs_match(n_sec, kind, n_tasks):
    topo, jtopo = topology(T, kind, n_sec), topology(J, kind, n_sec)
    plan = T.plan_halp_topology(T.vgg16_geom(), topo)
    jplan = J.plan_halp_topology(J.vgg16_geom(), jtopo)
    sim, jsim = T.Sim(), J.Sim()
    heads = T.events.build_halp_dag(sim, [plan] * n_tasks, topo)
    jheads = J.events.build_halp_dag(jsim, [jplan] * n_tasks, jtopo)
    same(heads, jheads)
    same(jobs(sim), jobs(jsim))
    same(sim.run(), jsim.run())
    same(jobs(sim), jobs(jsim))


def test_multitask_dag_and_evaluator_match():
    """Two tasks sharing a skewed 5-ES pool (tests/test_conformance.py's
    placement cell): the physical-resource DAG and its batched evaluator."""
    groups = (("e1", "e4"), ("e2", "e3", "e5"))
    out = []
    for M in (T, J):
        pool = skew_topology(M, 5).with_links({})
        plans = [M.plan_halp_topology(M.vgg16_geom(), pool.sub_topology(g), overlap_rows=4) for g in groups]
        sim = M.Sim()
        heads = M.events.build_multitask_dag(sim, plans, pool)
        total = sim.run()
        res = M.events.MultitaskBatchEvaluator(M.vgg16_geom(), pool).evaluate([groups, (("e1",), ("e9",))])
        out.append((heads, jobs(sim), total, res))
        fins = [sim.finish_of(h) for h in heads]
        assert res[0] == dict(total=total, avg_delay=sum(fins) / len(fins), per_task_finish=tuple(fins))
        assert res[1] is None  # e9 is not in the pool
    same(out[0], out[1])


@pytest.mark.parametrize("bad", ["empty", "net", "host", "pool"])
def test_multitask_dag_rejects_like_jax(bad):
    errs = []
    for M in (T, J):
        pool = skew_topology(M, 3)
        plan = M.plan_halp_topology(M.vgg16_geom(), pool.sub_topology(("e1", "e2")))
        plans = {"empty": [],
                 "net": [plan, M.plan_halp_topology(M.vgg16_geom(160), pool.sub_topology(("e1", "e2")))],
                 "host": [plan, dataclasses.replace(plan, host="e1")],
                 "pool": [M.plan_halp_n(M.vgg16_geom(), secondaries=("e1", "x"))]}[bad]
        with pytest.raises(ValueError) as exc:
            M.events.build_multitask_dag(M.Sim(), plans, pool)
        errs.append(str(exc.value))
    assert errs[0] == errs[1]


SIM_CASES = [
    dict(platform="GTX_1080TI", rate=r, n_tasks=n) for r in RATES for n in (1, 4)
] + [
    dict(platform="AGX_XAVIER", rate=40e9, n_tasks=4, overlap_rows=2),
    dict(platform="GTX_1080TI", rate=60e9, n_tasks=2, host_platform="AGX_XAVIER"),
    dict(platform="GTX_1080TI", rate=40e9, n_tasks=4, slowdown={"e1^0": 2.0, "link:e0->e2^3": 1.5}),
]


@pytest.mark.parametrize("case", SIM_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_simulate_halp_paper_style_matches(case):
    out = []
    for M in (T, J):
        kw = {k: v for k, v in case.items() if k not in ("platform", "rate", "host_platform")}
        if "host_platform" in case:
            kw["host_platform"] = getattr(M, case["host_platform"])
        r = M.simulate_halp(M.vgg16_geom(), getattr(M, case["platform"]), M.Link(case["rate"]), **kw)
        out.append((r["total"], r["per_task_finish"], r["avg_delay"], jobs(r["sim"]), r["plan"]))
    same(out[0][:4], out[1][:4])
    assert_same_plan(out[0][4], out[1][4])


@pytest.mark.parametrize("n_sec,kind,n_tasks", GRID)
def test_simulate_halp_topology_style_matches(n_sec, kind, n_tasks):
    ratios = tuple(j + 1.0 for j in range(n_sec))
    ratios = tuple(r / sum(ratios) for r in ratios)
    out = []
    for M in (T, J):
        topo = topology(M, kind, n_sec)
        for kw in (dict(), dict(ratios=ratios, overlap_rows=2)):
            r = M.simulate_halp(M.vgg16_geom(), topology=topo, n_tasks=n_tasks, **kw)
            out.append((r["total"], r["per_task_finish"], r["avg_delay"], jobs(r["sim"])))
    same(out[:2], out[2:])


@pytest.mark.parametrize("kwargs", [
    dict(), dict(platform=True), dict(platform=True, link=True, topology=True),
    dict(topology=True, plan=True, ratios=(0.5, 0.5)),
])
def test_simulate_halp_rejects_like_jax(kwargs):
    errs = []
    for M in (T, J):
        kw = dict(kwargs)
        if kw.pop("platform", False):
            kw["platform"] = M.GTX_1080TI
        if kw.pop("link", False):
            kw["link"] = M.Link(40e9)
        if kw.pop("topology", False):
            kw["topology"] = sym_topology(M, 2)
        if kw.pop("plan", False):
            kw["plan"] = M.plan_halp(M.vgg16_geom())
        with pytest.raises(TypeError) as exc:
            M.simulate_halp(M.vgg16_geom(), **kw)
        errs.append(str(exc.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("n_workers", [2, 3, 9])
@pytest.mark.parametrize("platform", ["GTX_1080TI", "AGX_XAVIER"])
def test_simulate_modnn_and_modnn_time_match(platform, n_workers):
    out = []
    for M in (T, J):
        p, link = getattr(M, platform), M.Link(60e9)
        r = M.simulate_modnn(M.vgg16_geom(), p, link, n_workers)
        slow = M.simulate_modnn(M.vgg16_geom(), p, link, n_workers, slowdown={"w1": 1.7, "w0:rx": 1.2})
        out.append((r["total"], jobs(r["sim"]), slow["total"], M.modnn_time(M.vgg16_geom(), p, link, n_workers)))
    same(out[0], out[1])


@pytest.mark.parametrize("rate", RATES)
def test_enhanced_modnn_delay_matches(rate):
    same(T.enhanced_modnn_delay(T.vgg16_geom(), T.GTX_1080TI, T.Link(rate)),
         J.enhanced_modnn_delay(J.vgg16_geom(), J.GTX_1080TI, J.Link(rate)))


@pytest.mark.parametrize("n_tasks", [1, 2])
@pytest.mark.parametrize("kind", ["sym", "skew"])
@pytest.mark.parametrize("scheme_kind", ["halo", "non_penetrative", "mixed"])
@pytest.mark.parametrize("name", ["vgg16", "vit"])
def test_simulate_scheme_matches(name, scheme_kind, kind, n_tasks):
    out = []
    for M in (T, J):
        net = _scheme_net(M, name)
        a = _assignments(M, net)[scheme_kind]
        r = M.simulate_scheme(net, topology(M, kind, 3), ratios=SCHEME_RATIOS, overlap_rows=4,
                              assignment=a, n_tasks=n_tasks)
        sim = M.Sim()
        heads = M.build_scheme_dag(sim, r["layout"], n_tasks, topology(M, kind, 3))
        out.append((r["total"], r["heads"], jobs(r["sim"]), r["layout"].signature, tuple(heads)))
    same(out[0], out[1])


SCENARIOS = [
    {},
    {"e1": 2.0},  # a bare secondary: every per-task clone
    {"e0": 1.5, "link:e0->e2": 3.0},  # the host, a bare directed link
    {"link:e1^0->e0": 4.0, "e2^1": 1.25},  # raw DES resource names
]


@pytest.mark.parametrize("style", ["paper", "topology", "plan"])
def test_serve_latency_table_matches(style):
    out = []
    for M in (T, J):
        if style == "paper":
            kw = dict(platform=M.GTX_1080TI, link=M.Link(100e9))
        elif style == "topology":
            kw = dict(topology=skew_topology(M, 2), overlap_rows=2)
        else:
            topo = skew_topology(M, 3)
            kw = dict(topology=topo, plan=M.plan_halp_topology(M.vgg16_geom(), topo, ratios=SCHEME_RATIOS))
        out.append(M.serve_latency_table(M.vgg16_geom(), max_batch=8, scenarios=SCENARIOS, **kw))
        out.append(M.serve_latency_table(M.vgg16_geom(), max_batch=3, **kw))
    same(out[:2], out[2:])
    assert out[0].shape == (len(SCENARIOS), 8) and bool((np.diff(out[0], axis=1) > 0).all())


@pytest.mark.parametrize("kwargs,err", [(dict(max_batch=0), "max_batch"), (dict(scenarios=[]), "non-empty"),
                                        (dict(scenarios=[{"e1": 0.0}]), "positive")])
def test_serve_latency_table_rejects_like_jax(kwargs, err):
    msgs = []
    for M in (T, J):
        with pytest.raises(ValueError, match=err) as exc:
            M.serve_latency_table(M.vgg16_geom(), M.GTX_1080TI, M.Link(40e9), **kwargs)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


GM_CASES = [
    dict(lo=30e6, hi=120e6, corr=0.9, sigma_frac=0.2, seed=4),
    dict(lo=40e9, hi=100e9, seed=7),
    dict(lo=1.0, hi=2.0, corr=1.0, sigma_frac=0.0, start=1.5),
    dict(lo=1e12, hi=5e12, corr=0.0, mean=2e12, seed=11),
]


@pytest.mark.parametrize("kw", GM_CASES)
def test_gauss_markov_trace_matches(kw):
    same(T.GaussMarkovTrace(**kw).rates(300), J.GaussMarkovTrace(**kw).rates(300))


@pytest.mark.parametrize("kw", [dict(lo=2.0, hi=1.0), dict(lo=0.0, hi=1.0, corr=1.5)])
def test_gauss_markov_trace_rejects_like_jax(kw):
    msgs = []
    for M in (T, J):
        with pytest.raises(ValueError) as exc:
            M.GaussMarkovTrace(**kw)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


class StaticPlanner:
    """One plan for every epoch; records what the replay reports back."""

    def __init__(self, plan):
        self.plan = plan
        self.seen = []

    def plan_for_epoch(self):
        return self.plan

    def observe_transfer(self, src, dst, nbytes, elapsed_s):
        self.seen.append(("link", src, dst, nbytes, elapsed_s))

    def observe_compute(self, es, flops, elapsed_s):
        self.seen.append(("es", es, flops, elapsed_s))


def _replay(M, fn, **kw):
    topo = skew_topology(M, 2)
    planner = StaticPlanner(M.plan_halp_topology(M.vgg16_geom(), topo))
    recs = fn(M.vgg16_geom(), topo, planner, **kw)
    return [(r["epoch"], r["rates"], r["compute_rates"], r["makespan"]) for r in recs], planner.seen


def test_replay_trace_matches():
    out = []
    for M in (T, J):
        link = M.GaussMarkovTrace(lo=5e9, hi=40e9, seed=3).rates(12)
        flops = M.GaussMarkovTrace(lo=2e12, hi=8e12, seed=5).rates(12)
        out.append(_replay(M, M.replay_trace, link_rates={("e0", "e2"): link, ("e2", "e0"): link},
                           compute_rates={"e1": flops, "e0": flops[::-1]}, n_tasks=3))
        out.append(_replay(M, M.replay_trace, compute_rates={"e2": flops}, n_epochs=5))
    same(out[:2], out[2:])
    assert len(out[0][0]) == 12 and len(out[1][0]) == 5


def test_replay_rate_trace_matches():
    out = []
    for M in (T, J):
        link = M.GaussMarkovTrace(lo=10e9, hi=100e9, corr=0.8, seed=9).rates(10)
        out.append(_replay(M, M.replay_rate_trace, link_rates={("e0", "e1"): link}, n_epochs=8))
    same(out[0], out[1])


@pytest.mark.parametrize("fn,kw", [
    ("replay_trace", dict()),
    ("replay_trace", dict(compute_rates={"zz": [1e12]})),
    ("replay_trace", dict(compute_rates={"e1": [0.0]})),
    ("replay_trace", dict(link_rates={("e0", "e1"): [1e9] * 3}, n_epochs=4)),
    ("replay_rate_trace", dict(link_rates={})),
])
def test_replay_rejects_like_jax(fn, kw):
    msgs = []
    for M in (T, J):
        with pytest.raises(ValueError) as exc:
            _replay(M, getattr(M, fn), **kw)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_calibrated_platforms_match():
    for name in ("GTX_1080TI", "AGX_XAVIER"):
        assert dataclasses.astuple(getattr(T, name)) == dataclasses.astuple(getattr(J, name))
        same(T.standalone_time(T.vgg16_geom(), getattr(T, name)),
             J.standalone_time(J.vgg16_geom(), getattr(J, name)))
    same(T.schedule._calibrated("card", 1e12, 5e-3), J.schedule._calibrated("card", 1e12, 5e-3))
    same(T.speedup_ratio(0.002, 0.0047), J.speedup_ratio(0.002, 0.0047))
    # the port states no TPU rate
    assert not hasattr(T.schedule, "TPU_V5E") and "TPU_V5E" not in T.__all__


@pytest.mark.parametrize("bound", ["list", "eq22"])
@pytest.mark.parametrize("n_sec,kind,n_tasks", GRID)
def test_halp_closed_form_matches(n_sec, kind, n_tasks, bound):
    r = T.halp_closed_form(T.vgg16_geom(), topology=topology(T, kind, n_sec), n_tasks=n_tasks,
                           multitask_bound=bound)
    jr = J.halp_closed_form(J.vgg16_geom(), topology=topology(J, kind, n_sec), n_tasks=n_tasks,
                            multitask_bound=bound)
    same(r["total"], jr["total"])
    same(r["per_layer"], jr["per_layer"])
    assert_same_plan(r["plan"], jr["plan"])


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("platform", ["GTX_1080TI", "AGX_XAVIER"])
def test_halp_closed_form_paper_style_matches(platform, rate):
    for n_tasks in (1, 4):
        same(T.halp_closed_form(T.vgg16_geom(), getattr(T, platform), T.Link(rate), n_tasks=n_tasks)["total"],
             J.halp_closed_form(J.vgg16_geom(), getattr(J, platform), J.Link(rate), n_tasks=n_tasks)["total"])
    same(T.events.init_bytes(T.plan_halp(T.vgg16_geom()), "e1"),
         J.schedule._init_bytes(J.plan_halp(J.vgg16_geom()), "e1"))


def test_closed_form_rejects_unknown_bound_like_jax():
    msgs = []
    for M in (T, J):
        with pytest.raises(ValueError, match="multitask_bound") as exc:
            M.halp_closed_form(M.vgg16_geom(), M.GTX_1080TI, M.Link(40e9), multitask_bound="magic")
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# DAG templates and the DAG analyser (tests/test_analysis.py's corruptions)
# ---------------------------------------------------------------------------


def demo_topology(M):
    """tools/precompute_plans.py: demo_topology, in either package."""
    return M.CollabTopology(host="e0", secondaries=("a", "b"),
                            platforms={"e0": M.AGX_XAVIER, "a": M.AGX_XAVIER, "b": M.AGX_XAVIER},
                            default_link=M.Link(120e6))


def _demo_dag(M):
    sim = M.Sim()
    topo = demo_topology(M)
    M.events.build_halp_dag(sim, [M.plan_halp_topology(smoke_net(M), topo)], topo)
    return sim


def fifo_cycle(sim):
    by_res, pair = {}, None
    for job in sim.jobs:
        if job.resource in by_res:
            pair = (by_res[job.resource], job.jid)
            break
        by_res[job.resource] = job.jid
    a, b = pair
    sim.jobs[a].deps = sim.jobs[a].deps + (b,)


def orphan_transfer(sim):
    last_cmp = max(j.jid for j in sim.jobs if not j.resource.startswith("link:"))
    sim.add("stray[0]", f"link:{sim.jobs[last_cmp].resource}->nowhere", 0.5, deps=[last_cmp])


def endpoint_mismatch(sim):
    msg = next(j for j in sim.jobs if j.resource.startswith("link:") and j.deps)
    msg.resource = f"link:elsewhere->{msg.resource[5:].split('->', 1)[1]}"


def missing_dep(sim):
    sim.jobs[-1].deps = sim.jobs[-1].deps + (len(sim.jobs) + 3,)


DAG_CORRUPTIONS = {
    "clean": (None, None),
    "fifo_cycle": (fifo_cycle, "dag.deadlock"),
    "orphan_transfer": (orphan_transfer, "dag.orphan"),
    "endpoint_mismatch": (endpoint_mismatch, "dag.transfer"),
    "missing_dep": (missing_dep, "dag.event-order"),
}


@pytest.mark.parametrize("name", sorted(DAG_CORRUPTIONS))
def test_check_dag_reports_equal_jax(name):
    mutate, check = DAG_CORRUPTIONS[name]
    sim, jsim = _demo_dag(T), _demo_dag(J)
    if mutate is not None:
        mutate(sim)
        mutate(jsim)
    rep, jrep = tanalysis.check_dag(sim), janalysis.check_dag(jsim)
    assert _report(rep) == _report(jrep)
    if check is None:
        assert rep.ok and rep.checks > 0
        # the seed convention's double-priced last-layer sends are exempt
        assert any(j.name.startswith("msg[") and j.duration > 0
                   and not any(j.jid in o.deps for o in sim.jobs) for j in sim.jobs)
    else:
        assert any(f.check == check for f in rep.findings), str(rep)


def test_check_dag_empty_equal_jax():
    assert _report(tanalysis.check_dag(T.Sim())) == _report(janalysis.check_dag(J.Sim()))


@pytest.mark.parametrize("build", ["halp", "scheme", "vit"])
def test_check_dag_clean_on_built_dags(build):
    reps = []
    for M, A in ((T, tanalysis), (J, janalysis)):
        sim, topo = M.Sim(), skew_topology(M, 3)
        if build == "halp":
            M.events.build_halp_dag(sim, [M.plan_halp_topology(M.vgg16_geom(), topo)] * 3, topo)
        else:
            net = _scheme_net(M, "vgg16" if build == "scheme" else "vit")
            slay = M.partition.scheme_layout(net, topo.secondaries, ratios=SCHEME_RATIOS,
                                             assignment=_assignments(M, net)["mixed"])
            M.build_scheme_dag(sim, slay, 2, topo)
        reps.append(A.check_dag(sim))
    assert reps[0].ok, str(reps[0])
    assert _report(reps[0]) == _report(reps[1])


def _template(M, physical=False, n_tasks=1):
    net, topo = smoke_net(M), demo_topology(M)
    lay = M.partition.plan_layout(net, topo.secondaries, host=topo.host)
    tmpl = M.events.DagTemplate.from_layouts([lay] * n_tasks, topo, physical=physical)
    return tmpl, M.events._layout_quantities([lay] * n_tasks), topo


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "duration"])
@pytest.mark.parametrize("physical", [False, True], ids=["clone", "physical"])
def test_check_template_reports_equal_jax(physical, corrupt):
    (tmpl, q, topo), (jtmpl, jq, jtopo) = _template(T, physical, 2), _template(J, physical, 2)
    same((tmpl.heads, tmpl.nums, tmpl.den_ids, tmpl.den_kinds),
         (jtmpl.heads, jtmpl.nums, jtmpl.den_ids, jtmpl.den_kinds))
    same(jobs(tmpl.sim), jobs(jtmpl.sim))
    if corrupt:
        for t in (tmpl, jtmpl):
            t.nums[next(j for j, job in enumerate(t.sim.jobs) if job.duration > 0)] *= 2.0
    rep = tanalysis.check_template(tmpl, q, topo)
    assert _report(rep) == _report(janalysis.check_template(jtmpl, jq, jtopo))
    assert rep.ok != corrupt
    short = tanalysis.check_template(tmpl, q[:-1], topo)  # a walk out of step
    assert _report(short) == _report(janalysis.check_template(jtmpl, jq[:-1], jtopo))
    assert not short.ok


def test_template_cache_keys_match():
    """The batched evaluators key the process-wide template cache on
    signatures: the port's keys are the JAX keys, leaf types included."""
    out = []
    for M in (T, J):
        M.events._TEMPLATES.clear()
        topo = skew_topology(M, 3)
        ev = M.events.HalpBatchEvaluator(M.vgg16_geom(), topo, n_tasks=2)
        ev.evaluate([((0.5, 0.3, 0.2), 4), ((0.2, 0.3, 0.5), 2), ((0.34, 0.33, 0.33), 8)])
        keys = [k[:2] + k[3:] for k in M.events._TEMPLATES]  # the net is each package's own
        out.append((keys, M.events._TEMPLATE_CAPACITY, M.events._LAYOUT_CAPACITY))
    same(out[0], out[1])


# ---------------------------------------------------------------------------
# the port's own twins of tests/test_conformance.py's invariants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_sec,kind,n_tasks", GRID)
def test_closed_form_upper_bounds_des_within_pinned_slack(n_sec, kind, n_tasks):
    topo = topology(T, kind, n_sec)
    cf = T.halp_closed_form(T.vgg16_geom(), topology=topo, n_tasks=n_tasks)["total"]
    ev = T.simulate_halp(T.vgg16_geom(), topology=topo, n_tasks=n_tasks)["total"]
    assert cf >= ev * (1.0 - LOWER_TOL), (cf, ev)
    assert cf <= ev * UPPER_SLACK[(n_sec, kind, n_tasks)], cf / ev
    legacy = T.halp_closed_form(T.vgg16_geom(), topology=topo, n_tasks=n_tasks, multitask_bound="eq22")["total"]
    assert cf <= legacy + 1e-15
    if n_tasks == 1:
        assert cf == legacy


@pytest.mark.parametrize("n_sec,kind,n_tasks", GRID)
def test_run_batch_matches_scalar_sim(n_sec, kind, n_tasks):
    """Both ``run_batch`` paths (plain floats at B = 1, numpy at B = 40)
    reproduce the scalar ``Sim.run``, also under per-resource slowdowns."""
    res = T.simulate_halp(T.vgg16_geom(), topology=topology(T, kind, n_sec), n_tasks=n_tasks)
    sim = res["sim"]
    assert float(sim.run_batch().makespan[0]) == res["total"]
    durations = np.array([[job.duration for job in sim.jobs]])
    wide = sim.run_batch(np.repeat(durations, 40, axis=0))
    assert all(float(m) == res["total"] for m in wide.makespan)
    for k, name in enumerate(sorted({job.resource for job in sim.jobs})[::3]):
        sim.slowdown[name] = 1.0 + (k % 4) / 3.0
    scalar = sim.run()
    assert float(sim.run_batch().makespan[0]) == scalar
    assert all(float(m) == scalar for m in sim.run_batch(np.repeat(durations, 40, axis=0)).makespan)


def test_run_batch_rejects_a_wrong_width():
    sim = T.simulate_halp(T.vgg16_geom(), T.GTX_1080TI, T.Link(40e9))["sim"]
    with pytest.raises(ValueError, match="durations have"):
        sim.run_batch(np.zeros((2, len(sim.jobs) + 1)))
    fwd = T.Sim()
    fwd.add("a", "r", 1.0, [1])
    fwd.add("b", "r", 1.0)
    with pytest.raises(ValueError, match="forward dependency"):
        fwd.run()


@pytest.mark.parametrize("kind", ["sym", "skew"])
@pytest.mark.parametrize("scheme_kind", ["halo", "non_penetrative", "mixed"])
def test_scheme_batched_matches_scalar(scheme_kind, kind):
    topo = topology(T, kind, 3)
    a = _assignments(T, T.vgg16_geom())[scheme_kind]
    total = T.simulate_scheme(T.vgg16_geom(), topo, ratios=SCHEME_RATIOS, overlap_rows=4, assignment=a)["total"]
    assert T.SchemeBatchEvaluator(T.vgg16_geom(), topo).evaluate([(SCHEME_RATIOS, 4, a)]) == [total]
    if scheme_kind == "halo":
        assert total == T.evaluate_plan(T.vgg16_geom(), topo, SCHEME_RATIOS, 4, n_tasks=1)


@pytest.mark.parametrize("n_tasks", [1, 4])
def test_degenerate_single_es_exact(n_tasks):
    """N = 1: no collaboration.  A single-resource DES chain reproduces t_pre
    x n_tasks; both engines share the FLOP model (tests/test_conformance.py
    holds it to rel 1e-12)."""
    net = T.vgg16_geom()
    t_pre = T.standalone_time(net, T.GTX_1080TI)
    sim, prev, sizes = T.Sim(), None, net.sizes()
    for _ in range(n_tasks):
        for i, g in enumerate(net.layers):
            prev = sim.add(f"g{i}", "e0",
                           T.GTX_1080TI.compute_time(g.flops_per_out_row(sizes[i + 1]) * sizes[i + 1]), [prev])
        prev = sim.add("head", "e0", T.GTX_1080TI.compute_time(net.head_flops), [prev])
    assert sim.run() == pytest.approx(t_pre * n_tasks, rel=1e-12)
