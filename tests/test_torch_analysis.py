"""The port's static analysers against the JAX package's (``repro.analysis``),
on the CPU.

The same plans -- the demo HALP plan, ``plan_scheme`` on the demo VGG and a
small ViT, ``plan_even`` -- are built in both packages and held equal Segment
for Segment first; then every seeded corruption of ``tests/test_analysis.py``
is applied to both, and the reports must be equal: the same findings (check,
site and diagnostic) and the same number of checks.  The kernel probe is held
to the JAX ``eval_shape`` probe on the findings' check and site; its
diagnostics name the port's wrapper, and it counts one check fewer for every
geometry with two or more output rows (``kernel.tiles``, see
``repro_torch.analysis.kernel_check``).  ``run_plan(verify=True)`` must
refuse a corrupt plan before any conv runs.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))  # tools/ is a plain directory, not a package

import repro.analysis as janalysis  # noqa: E402
from _torch_parity import jax_vgg_params  # noqa: E402
from repro.core import nets as jnets  # noqa: E402
from repro.core import partition as jpart  # noqa: E402
from repro.models import vgg as jvgg  # noqa: E402
from repro.spatial import run_plan as jax_run_plan  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import kernel_check  # noqa: E402
from repro_torch.core import nets, partition  # noqa: E402
from repro_torch.core import AGX_XAVIER  # noqa: E402
from repro_torch.core.topology import CollabTopology, Link  # noqa: E402
from repro_torch.kernels.halo_conv import ops as halo_ops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import vgg  # noqa: E402
from repro_torch.models.common import params_from_jax  # noqa: E402
from repro_torch.spatial import run_plan  # noqa: E402
from test_analysis import GOOD_STORE_SRC, _replan_src  # noqa: E402
from test_torch_partition import assert_same_plan  # noqa: E402
from tools.precompute_plans import NOMINAL_BPS, demo_net, demo_topology  # noqa: E402

VIT_SMALL = dict(in_rows=64, n_blocks=2, d=64, heads=4, d_ff=128)


def port_topology() -> CollabTopology:
    """``tools/precompute_plans.py: demo_topology``'s twin: three ESs on the
    port's ``AGX_XAVIER``."""
    return CollabTopology(host="e0", secondaries=("a", "b"),
                          platforms={"e0": AGX_XAVIER, "a": AGX_XAVIER, "b": AGX_XAVIER},
                          default_link=Link(NOMINAL_BPS))


def test_port_topology_is_the_demo_topology():
    topo, jtopo = port_topology(), demo_topology()
    assert (topo.host, topo.secondaries, topo.default_link.rate_bps) == (
        jtopo.host, jtopo.secondaries, jtopo.default_link.rate_bps)
    assert {es: dataclasses.astuple(p) for es, p in topo.platforms.items()} == {
        es: dataclasses.astuple(p) for es, p in jtopo.platforms.items()}
    assert topo.capacity_ratios() == jtopo.capacity_ratios()


@pytest.fixture(scope="module")
def plans():
    """name -> (port plan, JAX plan), held equal before any comparison."""
    net, jnet = vgg.SMOKE.geom(), demo_net()
    topo, jtopo = port_topology(), demo_topology()
    vit, jvit = nets.vit_l16_geom(**VIT_SMALL), jnets.vit_l16_geom(**VIT_SMALL)
    out = {
        "halp": (partition.plan_halp_topology(net, topo), jpart.plan_halp_topology(jnet, jtopo)),
        "scheme": (partition.plan_scheme(net, topo), jpart.plan_scheme(jnet, jtopo)),
        "vit": (partition.plan_scheme(vit, topo), jpart.plan_scheme(jvit, jtopo)),
        "even": (partition.plan_even(net, 3), jpart.plan_even(jnet, 3)),
    }
    for name in ("halp", "even"):
        assert_same_plan(*out[name])
    for name in ("scheme", "vit"):
        sp, jsp = out[name]
        assert (sp.assignment, sp.spans, sp.ratios) == (jsp.assignment, jsp.spans, jsp.ratios)
        assert [dataclasses.astuple(s) for s in sp.segments] == [dataclasses.astuple(s) for s in jsp.segments]
        for hp, jhp in zip(sp.halo_plans, jsp.halo_plans):
            assert (hp is None) == (jhp is None)
            if hp is not None:
                assert_same_plan(hp, jhp)
    return out


def _report(rep):
    return [(f.check, f.where, f.detail) for f in rep.findings], rep.checks


# ---------------------------------------------------------------------------
# the mutations of tests/test_analysis.py, each applied to either package's
# plan with that package's Segment (``P`` is the partition module)
# ---------------------------------------------------------------------------


def mutate_part(plan, layer, slot, out=None, inp=None):
    part = plan.parts[layer]
    new_out, new_inp = dict(part.out), dict(part.inp)
    if out is not None:
        new_out[slot] = out
    if inp is not None:
        new_inp[slot] = inp
    bad = dataclasses.replace(part, out=new_out, inp=new_inp)
    return dataclasses.replace(plan, parts=plan.parts[:layer] + (bad,) + plan.parts[layer + 1:])


def _owners(plan, layer=0):
    return [s for s in plan.es_names if plan.parts[layer].out[s]]


def row_gap(P, plan):
    slot = _owners(plan)[0]
    seg = plan.parts[0].out[slot]
    return mutate_part(plan, 0, slot, out=P.Segment(seg.lo + 1, seg.hi))


def row_overlap(P, plan):
    slot = _owners(plan)[1]
    seg = plan.parts[0].out[slot]
    return mutate_part(plan, 0, slot, out=P.Segment(seg.lo - 1, seg.hi))


def tail_gap(P, plan):
    slot = _owners(plan)[-1]
    seg = plan.parts[0].out[slot]
    return mutate_part(plan, 0, slot, out=P.Segment(seg.lo, seg.hi - 1))


def short_halo(P, plan):
    slot = _owners(plan)[0]
    inp = plan.parts[0].inp[slot]
    return mutate_part(plan, 0, slot, inp=P.Segment(inp.lo + 1, inp.hi))


def surplus_input(P, plan):
    layer, slot = next((i, s) for i in range(len(plan.parts)) for s in plan.es_names
                       if plan.parts[i].out.get(s) and plan.parts[i].inp[s].lo > 1)
    inp = plan.parts[layer].inp[slot]
    return mutate_part(plan, layer, slot, inp=P.Segment(inp.lo - 1, inp.hi))


def idle_slot_with_input(P, plan):
    return mutate_part(plan, 0, _owners(plan)[0], out=P.EMPTY)


def auto_reduce_reactivation(P, plan):
    sec = plan.secondary_slots[-1]
    conv_layers = [i for i, g in enumerate(plan.net.layers) if g.kind != "pool" and plan.parts[i].out[sec]]
    assert any(i > conv_layers[0] for i in conv_layers)
    return mutate_part(plan, conv_layers[0], sec, out=P.EMPTY, inp=P.EMPTY)


def attention_row_split(P, plan):
    net = plan.net
    attn_g = dataclasses.replace(net.layers[1], kind="attn", heads=1)
    return dataclasses.replace(plan, net=dataclasses.replace(
        net, layers=net.layers[:1] + (attn_g,) + net.layers[2:]))


def illegal_scheme(P, plan):
    stage = next(idx for idx, (a, b) in enumerate(plan.spans)
                 if any(g.kind == "attn" for g in plan.net.layers[a:b + 1]))
    assignment = list(plan.assignment)
    assignment[stage] = "non_penetrative"
    return dataclasses.replace(plan, assignment=tuple(assignment))


def spans_mismatch(P, plan):
    return dataclasses.replace(plan, spans=plan.spans[:-1])


def head_divisibility(P, plan):
    net = plan.net
    layers = tuple(dataclasses.replace(g, heads=3) if g.kind == "attn" else g for g in net.layers)
    return dataclasses.replace(plan, net=dataclasses.replace(net, layers=layers))


def secondary_exchange(P, plan):
    sizes = plan.net.sizes()
    slot = plan.es_names[0]
    layer = next(i for i in range(1, len(plan.parts))
                 if plan.net.layers[i - 1].kind != "attn" and plan.net.layers[i].kind != "attn"
                 and plan.parts[i].out.get(slot))
    return mutate_part(plan, layer, slot, inp=P.Segment(1, sizes[layer]))


# (mutation, plan it corrupts, the check it must raise)
MUTATIONS = [
    (row_gap, "halp", "plan.coverage"),
    (row_overlap, "halp", "plan.coverage"),
    (tail_gap, "halp", "plan.coverage"),
    (short_halo, "halp", "plan.rf"),
    (surplus_input, "halp", "plan.rf"),
    (idle_slot_with_input, "halp", "plan.rf"),
    (auto_reduce_reactivation, "halp", "plan.reduce"),
    (attention_row_split, "halp", "plan.scheme"),
    (illegal_scheme, "vit", "plan.scheme"),
    (spans_mismatch, "scheme", "plan.scheme"),
    (head_divisibility, "vit", "plan.heads"),
    (secondary_exchange, "halp", "plan.halo"),
]


@pytest.mark.parametrize("name", ["halp", "scheme", "vit", "even"])
def test_check_plan_clean_on_valid_plans(plans, name):
    plan, jplan = plans[name]
    rep, jrep = analysis.check_plan(plan), janalysis.check_plan(jplan)
    assert rep.ok and jrep.ok, (str(rep), str(jrep))
    assert rep.checks == jrep.checks > 0


def test_check_plan_clean_on_a_layout():
    net, topo = vgg.SMOKE.geom(), port_topology()
    lay = partition.plan_layout(net, topo.secondaries, host=topo.host)
    jtopo = demo_topology()
    jlay = jpart.plan_layout(demo_net(), jtopo.secondaries, host=jtopo.host)
    rep, jrep = analysis.check_plan(lay), janalysis.check_plan(jlay)
    assert rep.ok and jrep.ok and rep.checks == jrep.checks


@pytest.mark.parametrize("mutation,which,check", MUTATIONS, ids=[m[0].__name__ for m in MUTATIONS])
def test_mutation_findings_equal_jax(plans, mutation, which, check):
    plan, jplan = plans[which]
    rep = analysis.check_plan(mutation(partition, plan))
    jrep = janalysis.check_plan(mutation(jpart, jplan))
    assert not rep.ok
    assert any(f.check == check for f in rep.findings), str(rep)
    assert _report(rep) == _report(jrep)


def test_check_plan_reports_a_non_plan():
    rep, jrep = analysis.check_plan(object()), janalysis.check_plan(object())
    assert _report(rep) == _report(jrep)
    assert rep.findings[0].check == "plan.type"


def test_report_raises_analysis_error(plans):
    bad = row_gap(partition, plans["halp"][0])
    with pytest.raises(analysis.AnalysisError, match="plan.coverage") as exc:
        analysis.check_plan(bad).raise_if_failed("ctx")
    assert isinstance(exc.value, ValueError) and not exc.value.report.ok
    assert str(exc.value).startswith("ctx: ")


# ---------------------------------------------------------------------------
# the kernel probe
# ---------------------------------------------------------------------------

GEOMETRIES = [  # (k, s, p, kwargs, supported override)
    (5, 1, 0, dict(w=3), True),  # divergence: w + 2p < k, the probe refuses
    (3, 1, 1, dict(w=16), False),  # forfeit: the probe accepts
    (5, 1, 0, dict(w=3, hs=4), None),  # narrow widths: the predicate agrees
    (4, 2, 0, dict(w=3, hs=4), None),
    (3, 1, 1, dict(w=16), None),
    (3, 2, 1, dict(w=15, hs=6), None),
    (3, 1, 2, dict(w=16), None),  # p > k - s: unsupported by both
    (3, 1, 1, dict(groups=8, c_in=8, c_out=8), None),  # depthwise
    (3, 1, 1, dict(groups=8, c_in=8, c_out=16), None),  # grouped, not depthwise
    (1, 1, 0, dict(hs=1), None),
]


@pytest.mark.parametrize("k,s,p,kw,supported", GEOMETRIES)
def test_kernel_geometry_findings_equal_jax(k, s, p, kw, supported):
    rep = analysis.check_kernel_geometry(k, s, p, supported=supported, **kw)
    jrep = janalysis.check_kernel_geometry(k, s, p, supported=supported, **kw)
    sites = [(f.check, f.where) for f in rep.findings]
    assert sites == [(f.check, f.where) for f in jrep.findings]
    for f, jf in zip(rep.findings, jrep.findings):
        # the same direction of divergence, named for the port's wrapper
        assert ("forfeited" in f.detail) == ("forfeited" in jf.detail)
        assert ("refuses" in f.detail) == ("fails to trace" in jf.detail)
    # JAX probes a ragged tile height on every accepted geometry of >= 2
    # output rows (kernel.tiles); K2 has no tile height to force
    accepted = rep.checks == 2
    assert jrep.checks - rep.checks == int(accepted and kw.get("hs", 8) // s >= 2)


def test_kernel_geometry_cases_of_tests_analysis():
    rep = analysis.check_kernel_geometry(5, 1, 0, w=3, supported=True)
    assert [f.check for f in rep.findings] == ["kernel.support"]
    assert "refuses" in rep.findings[0].detail and "non-positive output width" in rep.findings[0].detail
    rep = analysis.check_kernel_geometry(3, 1, 1, w=16, supported=False)
    assert [f.check for f in rep.findings] == ["kernel.support"] and "forfeited" in rep.findings[0].detail
    for k, s, p, w in ((5, 1, 0, 3), (4, 2, 0, 3)):
        assert analysis.check_kernel_geometry(k, s, p, w=w, hs=4).ok


@pytest.mark.parametrize("name", ["halp", "even", "scheme"])
def test_check_plan_kernels_clean_and_counts_as_jax(plans, name):
    plan, jplan = plans[name]
    rep, jrep = analysis.check_plan_kernels(plan), janalysis.check_plan_kernels(jplan)
    assert rep.ok and jrep.ok, (str(rep), str(jrep))
    subs = plan.halo_plans if name == "scheme" else (plan,)
    geoms = [g for sub in subs if sub is not None for g in kernel_check._plan_geometries(sub)]
    assert geoms and rep.checks == 2 * len(geoms)
    # one kernel.tiles tick fewer than JAX for every geometry of >= 2 output rows
    assert jrep.checks - rep.checks == sum(hs // s >= 2 for _, s, _, _, _, _, hs, _ in geoms)
    # plan_kernel_calls lists the probed geometries with their K2 operand shapes
    # and the probe's output shape, the expected one on a clean plan
    for sub in filter(None, subs):
        calls = kernel_check.plan_kernel_calls(sub, batch=2)
        assert set(calls) == kernel_check._plan_geometries(sub)
        for (k, s, p, groups, cin, cout, hs, w), shapes in calls.items():
            assert shapes == kernel_check.geometry_shapes(k, s, p, groups=groups, c_in=cin, c_out=cout,
                                                          hs=hs, w=w, batch=2)


def test_probe_matches_the_wrapper_on_the_cpu():
    """The probe's shape is the shape the wrapper returns (run here through
    the plain version), and it refuses what the wrapper refuses."""
    rng = np.random.default_rng(0)
    for k, s, p, groups, cin, cout, hs, w in [(3, 1, 1, 1, 4, 8, 6, 7), (3, 2, 1, 1, 3, 5, 4, 9),
                                              (5, 1, 2, 6, 6, 6, 5, 8), (1, 1, 0, 1, 2, 3, 1, 4)]:
        shapes = kernel_check.geometry_shapes(k, s, p, groups=groups, c_in=cin, c_out=cout, hs=hs, w=w, batch=2)
        cpu = {n: None if v is None else torch.from_numpy(rng.standard_normal(v, dtype=np.float32))
               for n, v in shapes.items() if n != "out"}
        meta = {n: None if v is None else v.to("meta") for n, v in cpu.items()}
        got = halo_ops.probe(meta["x"], meta["top"], meta["bottom"], meta["weights"],
                             stride=s, padding=p, groups=groups)
        y = halo_ops.halo_conv2d_cuda(cpu["x"], cpu["top"], cpu["bottom"], cpu["weights"],
                                      stride=s, padding=p, groups=groups)
        assert got == tuple(y.shape) == shapes["out"]
    x = torch.empty((1, 4, 3, 8), device="meta")
    with pytest.raises(ValueError, match="non-positive output width"):
        halo_ops.probe(x, None, torch.empty((1, 4, 3, 8), device="meta"),
                       torch.empty((5, 5, 8, 8), device="meta"), stride=1, padding=0)
    with pytest.raises(ValueError, match="takes meta tensors"):  # the probe takes shapes only
        halo_ops.probe(torch.zeros((1, 4, 4, 2)), None, None, torch.zeros((1, 1, 2, 2)), padding=0)
    # the wrappers' meta route (the dry run's): the probe's shape, no launch counted
    before = halo_ops.halo_conv2d_cuda.launches, tlayers.conv2d_cuda.launches
    y = halo_ops.halo_conv2d_cuda(torch.empty((1, 4, 4, 2), device="meta"), None, None,
                                  torch.empty((1, 1, 2, 2), device="meta"), padding=0)
    assert y.device.type == "meta" and tuple(y.shape) == halo_ops.probe(
        torch.empty((1, 4, 4, 2), device="meta"), None, None, torch.empty((1, 1, 2, 2), device="meta"), padding=0)
    y = tlayers.conv2d_cuda(torch.empty((1, 4, 4, 2), device="meta"), torch.empty((1, 1, 2, 2), device="meta"),
                            padding=0)
    assert y.device.type == "meta" and tuple(y.shape) == (1, 4, 4, 2)
    assert (halo_ops.halo_conv2d_cuda.launches, tlayers.conv2d_cuda.launches) == before
    with pytest.raises(ValueError, match="non-positive output width"):  # and it refuses what the probe refuses
        halo_ops.halo_conv2d_cuda(x, None, torch.empty((1, 4, 3, 8), device="meta"),
                                  torch.empty((5, 5, 8, 8), device="meta"), stride=1, padding=0)


# ---------------------------------------------------------------------------
# run_plan(verify=True)
# ---------------------------------------------------------------------------


@pytest.fixture
def conv_spy(monkeypatch):
    """Counts the convs ``apply_layer`` runs (K1's wrapper, patched where the
    layers module calls it)."""
    calls = []
    real = tlayers.conv2d_cuda

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tlayers, "conv2d_cuda", spy)
    return calls


def test_run_plan_verify_refuses_a_corrupt_plan_before_any_conv(plans, conv_spy):
    plan, jplan = plans["halp"]
    jparams = jax_vgg_params()
    params = params_from_jax(jparams)
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3), dtype=np.float32)
    bad, jbad = row_gap(partition, plan), row_gap(jpart, jplan)
    with pytest.raises(analysis.AnalysisError, match="plan.coverage") as exc:
        run_plan(bad, params["features"], vgg.apply_layer, torch.from_numpy(x), verify=True)
    assert conv_spy == []
    assert exc.value.report.findings and "layer 0" in exc.value.report.findings[0].where
    with pytest.raises(janalysis.AnalysisError) as jexc:
        jax_run_plan(jbad, jparams["features"], jvgg.apply_layer, x, verify=True)
    assert _report(exc.value.report) == _report(jexc.value.report)
    # a scheme plan is gated the same way
    sbad = spans_mismatch(partition, plans["scheme"][0])
    with pytest.raises(analysis.AnalysisError, match="stage spans"):
        run_plan(sbad, params["features"], vgg.apply_layer, torch.from_numpy(x), verify=True)
    assert conv_spy == []


def test_run_plan_verify_passes_a_valid_plan(plans, conv_spy):
    params = params_from_jax(jax_vgg_params())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 64, 64, 3), dtype=np.float32))
    plan = plans["halp"][0]
    got = run_plan(plan, params["features"], vgg.apply_layer, x, verify=True)
    want = run_plan(plan, params["features"], vgg.apply_layer, x)
    assert torch.equal(got, want) and len(conv_spy) > 0


# ---------------------------------------------------------------------------
# keying lint: the port's own sources, and tests/test_analysis.py's synthetic
# corruptions (l.413-489) through both packages' lints
# ---------------------------------------------------------------------------

BAD_STORE_SRC = """
class PlanStore:
    def get(self, key):
        return pickle.loads(row[2])
"""


KEYING_CASES = {
    "unkeyed": (_replan_src(["alpha", "new_knob"], ["alpha"], {}), GOOD_STORE_SRC, "keying.unkeyed"),
    "stale_exclusion": (_replan_src(["alpha"], ["alpha"], {"gone": "this field was removed long ago"}),
                        GOOD_STORE_SRC, "keying.stale-exclusion"),
    "no_justification": (_replan_src(["alpha", "beta"], ["alpha"], {"beta": "perf"}), GOOD_STORE_SRC,
                         "keying.no-justification"),
    "contradiction": (_replan_src(["alpha"], ["alpha"], {"alpha": "excluded for a very well argued reason"}),
                      GOOD_STORE_SRC, "keying.contradiction"),
    "store_veto": (_replan_src(["alpha"], ["alpha"], {}), BAD_STORE_SRC, "keying.store-veto"),
    "unknown_field": (_replan_src(["alpha"], ["alpha", "ghost"], {}), GOOD_STORE_SRC, "keying.unknown-field"),
    "no_exclusion_list": ("class ReplanConfig:\n    a: int = 0\n\nclass ReplanController:\n"
                          "    def __init__(self, config):\n        self._fingerprint = (config.a,)\n",
                          GOOD_STORE_SRC, "keying.exclusion-list"),
    "unparseable": ("def (:", GOOD_STORE_SRC, "keying.parse"),
    "no_get": (_replan_src(["alpha"], ["alpha"], {}), "class PlanStore:\n    pass\n", "keying.parse"),
}


@pytest.mark.parametrize("name", sorted(KEYING_CASES))
def test_keying_corruption_findings_equal_jax(name):
    replan_src, store_src, check = KEYING_CASES[name]
    rep = analysis.check_keying(replan_src, store_src)
    assert _report(rep) == _report(janalysis.check_keying(replan_src, store_src))
    assert check in [f.check for f in rep.findings]


def test_check_keying_clean_on_the_ports_sources():
    """``check_keying()`` lints the port's own ``core/replan.py`` and
    ``core/planstore.py`` (never the JAX package's) and finds them clean,
    with JAX's check count on its own sources."""
    from repro_torch.core import planstore, replan

    rep = analysis.check_keying()
    assert rep.ok, str(rep)
    own = analysis.check_keying(Path(replan.__file__).read_text(), Path(planstore.__file__).read_text())
    assert _report(rep) == _report(own)
    assert rep.checks == janalysis.check_keying().checks


@pytest.mark.parametrize("cut", ["            config.tol,\n", "            config.bucket_frac,\n"])
def test_keying_catches_an_unkeyed_knob_in_either_packages_source(cut):
    """A knob dropped from the real fingerprint tuple: both lints, each on
    its own package's source, report the same finding."""
    from repro.core import planstore as jplanstore
    from repro.core import replan as jreplan
    from repro_torch.core import planstore, replan

    reps = []
    for lint, rmod, smod in ((analysis.check_keying, replan, planstore),
                             (janalysis.check_keying, jreplan, jplanstore)):
        src = Path(rmod.__file__).read_text()
        assert src.count(cut) == 1
        reps.append(_report(lint(src.replace(cut, ""), Path(smod.__file__).read_text())))
    assert reps[0] == reps[1]
    assert [f[0] for f in reps[0][0]] == ["keying.unkeyed"]
