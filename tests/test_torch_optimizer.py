"""The port's plan search (``repro_torch.core.optimizer``) against the JAX
package's, on the CPU, by exact equality.

``optimize_plan`` memoises by ``(ratios, overlap)`` after renormalisation,
so its trajectory, its evaluation count and its plan depend on float-exact
copies of the renormalisation and on bit-equal DES scores: every case
compares the result field by field -- ratios, overlap, makespan, evaluation
count, the whole history, the scheme assignment and the plan, Segment for
Segment.  The port's own twin of ``tests/test_conformance.py:425`` (the
batched and the scalar engine return the same plan, and under a budget
spend the same evaluations) closes the file.
"""
import dataclasses
import math

import pytest

import repro.core as J
import repro_torch.core as T
from repro.models import vgg as jvgg
from repro_torch.analysis import AnalysisError
from repro_torch.models import vgg
from test_torch_engines import VIT_SMALL, demo_topology, same, skew_topology
from test_torch_partition import assert_same_plan


def table4_topology(M, slow_factor=0.35, slow_gbps=10.0, fast_gbps=40.0):
    """benchmarks/hetero_sweep.py: _two_secondary_topology -- a fast and a
    slow secondary of the GTX 1080TI platform."""
    slow = M.GTX_1080TI.scaled(slow_factor, f"slow x{slow_factor:g}")
    return M.CollabTopology(
        host="e0", secondaries=("fast", "slow"),
        platforms={"e0": M.GTX_1080TI, "fast": M.GTX_1080TI, "slow": slow},
        links={("e0", "fast"): M.Link(fast_gbps * 1e9), ("fast", "e0"): M.Link(fast_gbps * 1e9),
               ("e0", "slow"): M.Link(slow_gbps * 1e9), ("slow", "e0"): M.Link(slow_gbps * 1e9)},
    )


def assert_same_result(r, jr):
    same((r.ratios, r.overlap_rows, r.makespan, r.evaluations, r.schemes),
         (jr.ratios, jr.overlap_rows, jr.makespan, jr.evaluations, jr.schemes))
    same(r.history, jr.history)
    assert type(r.plan).__name__ == type(jr.plan).__name__
    if isinstance(r.plan, T.HALPPlan):
        assert_same_plan(r.plan, jr.plan)
        return
    assert (r.plan.assignment, r.plan.spans, r.plan.ratios) == (jr.plan.assignment, jr.plan.spans, jr.plan.ratios)
    assert [dataclasses.astuple(s) for s in r.plan.segments] == [dataclasses.astuple(s) for s in jr.plan.segments]
    for hp, jhp in zip(r.plan.halo_plans, jr.plan.halo_plans):
        assert (hp is None) == (jhp is None)
        if hp is not None:
            assert_same_plan(hp, jhp)


def _cf_objective(M, net, topo):
    """A custom objective: the closed form in place of the DES."""
    def fn(ratios, w):
        try:
            return M.halp_closed_form(net, topology=topo, ratios=ratios, overlap_rows=w)["total"]
        except (AssertionError, ValueError):
            return float("inf")
    return fn


SEARCHES = {
    "table4_1task": lambda M: (M.vgg16_geom(), table4_topology(M), dict()),
    "table4_4task_verify": lambda M: (M.vgg16_geom(), table4_topology(M), dict(n_tasks=4, verify=True)),
    "slow_x0.25_5G": lambda M: (M.vgg16_geom(), table4_topology(M, 0.25, 5.0), dict(overlap_choices=(2, 4))),
    "skew3_budget": lambda M: (M.vgg16_geom(), skew_topology(M, 3), dict(eval_budget=20, n_tasks=2)),
    "skew3_tol": lambda M: (M.vgg16_geom(), skew_topology(M, 3), dict(tol=1e-5, init_ratios=(0.2, 0.3, 0.5))),
    "skew4_strict": lambda M: (M.vgg16_geom(160), skew_topology(M, 4), dict(auto_reduce=False, max_rounds=3)),
    "schemes_vgg64": lambda M: (M.vgg16_geom(in_rows=64), skew_topology(M, 2),
                                dict(overlap_choices=(4,), max_rounds=2, schemes=M.SCHEMES)),
    "schemes_budget8": lambda M: (M.vgg16_geom(in_rows=64), skew_topology(M, 2),
                                  dict(overlap_choices=(4,), max_rounds=2, schemes=M.SCHEMES, eval_budget=8)),
    "schemes_verify_3sec": lambda M: (M.vgg16_geom(in_rows=64), skew_topology(M, 3),
                                      dict(overlap_choices=(2, 4), max_rounds=2, schemes=M.SCHEMES,
                                           verify=True, n_tasks=2)),
    "vit_attention": lambda M: (M.vit_l16_geom(**VIT_SMALL), skew_topology(M, 3), dict(max_rounds=2)),
    "demo_verify": lambda M: ((vgg.SMOKE.geom() if M is T else
                               jvgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10).geom()),
                              demo_topology(M), dict(max_rounds=1, verify=True)),
}


@pytest.mark.parametrize("engine", ["batched", "scalar"])
@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_optimize_plan_matches(name, engine):
    (net, topo, kw), (jnet, jtopo, jkw) = SEARCHES[name](T), SEARCHES[name](J)
    r = T.optimize_plan(net, topo, engine=engine, **kw)
    jr = J.optimize_plan(jnet, jtopo, engine=engine, **jkw)
    assert_same_result(r, jr)
    assert math.isfinite(r.makespan) and r.evaluations == len(r.history)


@pytest.mark.parametrize("engine", ["batched", "scalar"])
def test_optimize_plan_custom_objective_matches(engine):
    out = []
    for M in (T, J):
        net, topo = M.vgg16_geom(), table4_topology(M)
        out.append(M.optimize_plan(net, topo, engine=engine, objective=_cf_objective(M, net, topo), max_rounds=4))
    assert_same_result(*out)


@pytest.mark.parametrize("name", ["table4_1task", "skew3_budget", "schemes_vgg64", "schemes_budget8", "vit_attention"])
def test_optimize_plan_engines_agree(name):
    """The port's own twin of tests/test_conformance.py:425: both engines
    return the identical plan and, under a budget, spend the same number of
    evaluations, fewer than an unbudgeted run prices (the budget binds)."""
    net, topo, kw = SEARCHES[name](T)
    rb = T.optimize_plan(net, topo, engine="batched", **kw)
    rs = T.optimize_plan(net, topo, engine="scalar", **kw)
    assert (rb.makespan, rb.ratios, rb.overlap_rows, rb.schemes) == (rs.makespan, rs.ratios, rs.overlap_rows, rs.schemes)
    assert rb.plan == rs.plan
    if "eval_budget" in kw:
        assert rb.evaluations == rs.evaluations == kw["eval_budget"]
        full = T.optimize_plan(net, topo, **{k: v for k, v in kw.items() if k != "eval_budget"})
        assert full.evaluations > kw["eval_budget"]


def test_optimum_beats_the_equal_split():
    """Table IV's cell: the searched plan is no slower than the equal split
    and the capacity split it starts from."""
    net, topo = T.vgg16_geom(), table4_topology(T)
    res = T.optimize_plan(net, topo, n_tasks=4)
    equal = T.evaluate_plan(net, topo, T.equal_ratios(topo), 4, n_tasks=4)
    capacity = T.evaluate_plan(net, topo, topo.capacity_ratios(), 4, n_tasks=4)
    assert res.makespan < equal and res.makespan <= capacity
    assert res.makespan == T.simulate_halp(net, topology=topo, n_tasks=4, plan=res.plan)["total"]


CANDIDATES = [((0.5, 0.5), 4), ((0.7, 0.3), 2), ((0.3, 0.7), 8), ((0.98, 0.02), 6), ((1.0, 0.0), 4)]


@pytest.mark.parametrize("auto_reduce", [True, False])
@pytest.mark.parametrize("n_tasks", [1, 3])
def test_evaluate_plan_and_batch_evaluator_match(n_tasks, auto_reduce):
    out = []
    for M in (T, J):
        net, topo = M.vgg16_geom(), table4_topology(M)
        scalar = [M.evaluate_plan(net, topo, r, w, n_tasks=n_tasks, auto_reduce=auto_reduce) for r, w in CANDIDATES]
        batched = M.events.HalpBatchEvaluator(net, topo, n_tasks=n_tasks, auto_reduce=auto_reduce).evaluate(CANDIDATES)
        assert batched == scalar
        out.append((scalar, M.equal_ratios(topo), M.equal_ratios(skew_topology(M, 5))))
    same(out[0], out[1])


def test_evaluate_scheme_assignment_matches():
    out = []
    for M in (T, J):
        net, topo = M.vgg16_geom(in_rows=64), skew_topology(M, 3)
        spans = M.stage_spans(net)
        cands = [((0.5, 0.3, 0.2), 4, (M.SCHEME_HALO,) * len(spans)),
                 ((0.2, 0.3, 0.5), 2, (M.SCHEME_NP,) * len(spans)),
                 ((0.4, 0.4, 0.2), 4, (M.SCHEME_HALO, M.SCHEME_NP) * (len(spans) // 2) + (M.SCHEME_HALO,)),
                 ((0.5, 0.3, 0.2), 4, (M.SCHEME_HS,) * len(spans))]  # head_sequence has no conv stage
        scalar = [M.evaluate_scheme_assignment(net, topo, r, w, a, n_tasks=2) for r, w, a in cands]
        assert M.SchemeBatchEvaluator(net, topo, n_tasks=2).evaluate(cands) == scalar
        out.append(scalar)
    same(out[0], out[1])
    assert math.isinf(out[0][3]) and all(math.isfinite(v) for v in out[0][:3])


@pytest.mark.parametrize("case", ["engine", "budget", "objective_schemes", "infeasible", "infeasible_schemes"])
def test_optimize_plan_rejects_like_jax(case):
    msgs = []
    for M in (T, J):
        net, topo = M.vgg16_geom(), table4_topology(M)
        kw = {"engine": dict(engine="fast"), "budget": dict(eval_budget=0),
              "objective_schemes": dict(objective=lambda r, w: 1.0, schemes=M.SCHEMES)}.get(case)
        if case.startswith("infeasible"):
            topo = M.CollabTopology.symmetric(M.GTX_1080TI, M.Link(40e9), n_secondaries=16)
            kw = dict(auto_reduce=False, max_rounds=1)
            if case == "infeasible_schemes":
                net, kw = M.vgg16_geom(in_rows=32), dict(kw, schemes=(M.SCHEME_HALO, M.SCHEME_HS))
        with pytest.raises(ValueError) as exc:
            M.optimize_plan(net, topo, **kw)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_verify_gate_raises_like_jax():
    """``_verify_plan`` (``optimize_plan(verify=True)``'s gate) on a plan
    with a row gap: the port raises AnalysisError with JAX's findings."""
    import repro.analysis as janalysis

    errs = []
    for M, Err in ((T, AnalysisError), (J, janalysis.AnalysisError)):
        plan = M.plan_halp_topology(M.vgg16_geom(), table4_topology(M))
        slot = next(s for s in plan.es_names if plan.parts[0].out[s])
        seg, part = plan.parts[0].out[slot], plan.parts[0]
        bad = dataclasses.replace(plan, parts=(dataclasses.replace(
            part, out=dict(part.out, **{slot: M.partition.Segment(seg.lo + 1, seg.hi)})),) + plan.parts[1:])
        with pytest.raises(Err) as exc:
            M.optimizer._verify_plan(bad, "optimize_plan")
        errs.append(str(exc.value))
    assert errs[0] == errs[1] and "plan.coverage" in errs[0]
