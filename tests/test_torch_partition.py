"""The port's copy of the HALP planner against the JAX package's planner:
the same plans, Segment for Segment and message for message, exactly."""
import pytest

from repro.core import nets as jnets
from repro.core import partition as jpart
from repro.core import rf as jrf
from repro.models import vgg as jvgg
from repro_torch.core import nets, partition, rf
from repro_torch.models import vgg


def _iv(seg):
    return (seg.lo, seg.hi)


def assert_same_plan(plan, jplan):
    assert plan.es_names == jplan.es_names
    assert plan.host == jplan.host
    assert plan.slot_owner == jplan.slot_owner
    assert len(plan.parts) == len(jplan.parts)
    for part, jp in zip(plan.parts, jplan.parts):
        assert part.index == jp.index
        assert {s: _iv(v) for s, v in part.out.items()} == {s: _iv(v) for s, v in jp.out.items()}
        assert {s: _iv(v) for s, v in part.inp.items()} == {s: _iv(v) for s, v in jp.inp.items()}
    for i in range(len(plan.parts)):
        assert plan.active_secondaries(i) == jplan.active_secondaries(i)
        for src in plan.es_names:
            for dst in plan.es_names:
                assert _iv(plan.message(i, src, dst)) == _iv(jplan.message(i, src, dst)), (i, src, dst)


NETS = {
    "vgg16_224": (nets.vgg16_geom(), jnets.vgg16_geom()),
    "vgg16_160": (nets.vgg16_geom(160), jnets.vgg16_geom(160)),
    "smoke": (vgg.SMOKE.geom(), jvgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10).geom()),
}


@pytest.mark.parametrize("net", sorted(NETS))
def test_geometry_matches(net):
    g, jg = NETS[net]
    assert g.sizes() == jg.sizes()
    assert g.head_flops == jg.head_flops
    for i, (a, b) in enumerate(zip(g.layers, jg.layers)):
        assert (a.name, a.kind, a.k, a.s, a.p, a.c_in, a.c_out) == (
            b.name, b.kind, b.k, b.s, b.p, b.c_in, b.c_out)
        assert g.layer_flops(i) == jg.layer_flops(i)
        assert g.layer_flops(i, rows=3) == jg.layer_flops(i, rows=3)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("overlap", [2, 4, 6])
def test_plan_halp_matches(net, overlap):
    g, jg = NETS[net]
    assert_same_plan(partition.plan_halp(g, overlap_rows=overlap),
                     jpart.plan_halp(jg, overlap_rows=overlap))


@pytest.mark.parametrize(
    "secs,ratios",
    [
        (("e1", "e2"), (0.7, 0.3)),
        (("e1", "e2", "e3"), (0.5, 0.3, 0.2)),
        (("a", "b", "c", "d"), (0.4, 0.1, 0.1, 0.4)),
        (("e1", "e2", "e3"), (0.9, 0.05, 0.05)),
    ],
)
@pytest.mark.parametrize("net", ["vgg16_224", "smoke"])
def test_plan_halp_n_skewed_matches(net, secs, ratios):
    g, jg = NETS[net]
    assert_same_plan(partition.plan_halp_n(g, secondaries=secs, ratios=ratios),
                     jpart.plan_halp_n(jg, secondaries=secs, ratios=ratios))


@pytest.mark.parametrize("n", [5, 6, 8])
def test_auto_reduced_plans_match(n):
    """N=5/8 degrade by idle slots, N=6 auto-reduces to one active secondary
    at the 14-row depth (tests/test_partition.py pins those plans)."""
    g, jg = NETS["vgg16_224"]
    secs = tuple(f"e{j}" for j in range(1, n + 1))
    plan = partition.plan_halp_n(g, secondaries=secs)
    assert_same_plan(plan, jpart.plan_halp_n(jg, secondaries=secs))
    if n == 6:
        assert [len(plan.active_secondaries(i)) for i in range(len(plan.parts))] == [6] * 16 + [1, 1]


def test_strict_mode_raises_like_jax():
    g, jg = NETS["vgg16_224"]
    secs = tuple(f"e{j}" for j in range(1, 7))
    with pytest.raises(jpart.PlanInfeasible) as jexc:
        jpart.plan_halp_n(jg, secondaries=secs, auto_reduce=False)
    with pytest.raises(partition.PlanInfeasible) as exc:
        partition.plan_halp_n(g, secondaries=secs, auto_reduce=False)
    assert str(exc.value) == str(jexc.value)
    assert (exc.value.layer, exc.value.reduce_at) == (jexc.value.layer, jexc.value.reduce_at)


@pytest.mark.parametrize(
    "kwargs,err",
    [({"secondaries": ("e1",)}, ValueError), ({"secondaries": ("e0", "e1")}, ValueError),
     ({"secondaries": ("e1", "e2"), "ratios": (1.0,)}, ValueError),
     ({"secondaries": ("e1", "e2"), "ratios": (1.0, -0.5)}, ValueError)],
)
def test_plan_halp_n_rejects_like_jax(kwargs, err):
    g, jg = NETS["smoke"]
    with pytest.raises(err):
        jpart.plan_halp_n(jg, **kwargs)
    with pytest.raises(err):
        partition.plan_halp_n(g, **kwargs)


def test_rf_helpers_match():
    for k, s, p in ((3, 1, 1), (2, 2, 0), (7, 2, 3), (1, 1, 0)):
        for in_rows in (7, 14, 56, 224):
            assert rf.out_size(in_rows, k, s, p) == jrf.out_size(in_rows, k, s, p)
            o = rf.out_size(in_rows, k, s, p)
            for lo, hi in ((1, 1), (1, o), (max(1, o // 3), max(1, o // 2)), (o, o)):
                assert rf.input_range_exact(lo, hi, k, s, p, in_rows) == jrf.input_range_exact(
                    lo, hi, k, s, p, in_rows)
    with pytest.raises(ValueError):
        rf.out_size(1, 3, 1, 0)
    with pytest.raises(ValueError):
        rf.input_range_exact(2, 1, 3, 1, 1, 10)


PLAN_EVEN_RATIOS = {2: (0.7, 0.3), 3: (3.0, 2.0, 1.0), 4: (1.0, 0.55, 0.35, 0.8),
                    5: (1, 2, 3, 2, 1), 6: (0.0, 1, 1, 1, 1, 2), 7: (5, 1, 1, 1, 1, 1, 1),
                    8: (4, 3, 2, 1, 1, 2, 3, 4)}


@pytest.mark.parametrize("weighted", [False, True], ids=["equal", "ratios"])
@pytest.mark.parametrize("n", range(2, 9))
@pytest.mark.parametrize("net", ["vgg16_224", "smoke"])
def test_plan_even_matches(net, n, weighted):
    """plan_even (and split_rows under it) Segment for Segment, for the equal
    split and a capacity weighting (including a zero ratio, which leaves a
    worker empty on small layers)."""
    g, jg = NETS[net]
    ratios = PLAN_EVEN_RATIOS[n] if weighted else None
    assert_same_plan(partition.plan_even(g, n, ratios=ratios), jpart.plan_even(jg, n, ratios=ratios))


@pytest.mark.parametrize("total", [0, 1, 7, 14, 224])
@pytest.mark.parametrize("ratios", [(1.0,), (0.5, 0.5), (0.7, 0.2, 0.1), (0.05, 0.9, 0.05)])
def test_split_rows_matches(total, ratios):
    assert [_iv(s) for s in partition.split_rows(total, ratios)] == [
        _iv(s) for s in jpart.split_rows(total, ratios)]


@pytest.mark.parametrize("n,ratios", [(3, (1.0, 2.0)), (2, (1.0, -0.5)), (2, (0.0, 0.0))])
def test_plan_even_rejects_like_jax(n, ratios):
    g, jg = NETS["smoke"]
    with pytest.raises(ValueError) as jexc:
        jpart.plan_even(jg, n, ratios=ratios)
    with pytest.raises(ValueError) as exc:
        partition.plan_even(g, n, ratios=ratios)
    assert str(exc.value) == str(jexc.value)
