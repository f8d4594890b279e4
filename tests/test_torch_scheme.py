"""The port's copy of the per-stage scheme planner against the JAX package's:
the same stage spans, assignments, segments, ratios, hub fractions and halo
sub-plans, exactly, for VGG-16 and ViT-L/16 (full and small), several ratio
sets, and baseline, non-penetrative, mixed and host_solo assignments."""
import pytest

from repro.core import nets as jnets
from repro.core import partition as jpart
from repro.core import rf as jrf
from repro.core import topology as jtopo
from repro.models import vgg as jvgg
from repro.models import vit_spatial as jvit
from repro_torch.core import nets, partition, rf, topology
from repro_torch.models import vgg, vit_spatial
from test_torch_partition import assert_same_plan

NETS = {
    "vgg16": (nets.vgg16_geom(), jnets.vgg16_geom()),
    "vgg_smoke": (vgg.SMOKE.geom(), jvgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10).geom()),
    "vit_l16": (nets.vit_l16_geom(), jnets.vit_l16_geom()),
    "vit_smoke": (vit_spatial.SMOKE.geom(), jvit.ViTSpatialConfig(
        name="vit_l16_smoke", img_res=64, patch=8, n_blocks=2, d=64, heads=4, d_ff=128,
        num_classes=10).geom()),
}
RATIOS = [(0.5, 0.3, 0.2), (1 / 3, 1 / 3, 1 / 3), (0.7, 0.2, 0.1), (2.0, 1.0)]


def _assignment(P, net, kind):
    """One scheme per stage, from the module ``P`` (the port's or JAX's)."""
    spans = P.stage_spans(net)
    opts = [P.stage_scheme_options(net, sp, P.SCHEMES) for sp in spans]
    if kind == "baseline":
        return None
    if kind == "host_solo":
        return (P.SCHEME_HOST,) * len(spans)
    if kind == "non_penetrative":
        return tuple(P.SCHEME_NP if P.SCHEME_NP in o else o[0] for o in opts)
    assert kind == "mixed"  # alternate NP / halo, host_solo every third stage
    out = []
    for si, o in enumerate(opts):
        want = P.SCHEME_HOST if si % 3 == 2 else (P.SCHEME_NP if si % 2 else P.SCHEME_HALO)
        out.append(want if want in o or want == P.SCHEME_HOST else o[0])
    return tuple(out)


def assert_same_scheme_plan(sp, jsp):
    assert sp.net.sizes() == jsp.net.sizes()
    assert (sp.host, sp.secondaries, sp.ratios, sp.overlap_rows) == (
        jsp.host, jsp.secondaries, jsp.ratios, jsp.overlap_rows)
    assert sp.assignment == jsp.assignment
    assert sp.spans == jsp.spans
    assert [(s.scheme, s.start, s.stop, s.stages) for s in sp.segments] == [
        (s.scheme, s.start, s.stop, s.stages) for s in jsp.segments]
    assert len(sp.halo_plans) == len(jsp.halo_plans)
    for hp, jhp in zip(sp.halo_plans, jsp.halo_plans):
        assert (hp is None) == (jhp is None)
        if hp is not None:
            assert hp.net.name == jhp.net.name and hp.net.sizes() == jhp.net.sizes()
            assert_same_plan(hp, jhp)


@pytest.mark.parametrize("kind", ["baseline", "non_penetrative", "mixed", "host_solo"])
@pytest.mark.parametrize("ratios", RATIOS, ids=lambda r: "-".join(f"{x:.2f}" for x in r))
@pytest.mark.parametrize("net", sorted(NETS))
def test_scheme_layouts_and_plans_match(net, ratios, kind):
    g, jg = NETS[net]
    secs = tuple(f"e{j}" for j in range(1, len(ratios) + 1))
    assignment = _assignment(partition, g, kind)
    assert assignment == _assignment(jpart, jg, kind)
    lay = partition.scheme_layout(g, secs, ratios=ratios, assignment=assignment)
    jlay = jpart.scheme_layout(jg, secs, ratios=ratios, assignment=assignment)
    assert lay.hub_fracs == jlay.hub_fracs
    assert [h is None for h in lay.halo_layouts] == [h is None for h in jlay.halo_layouts]
    for h, jh in zip(lay.halo_layouts, jlay.halo_layouts):
        if h is not None:
            assert (h.slots, h.owners, h.bounds, h.inp) == (jh.slots, jh.owners, jh.bounds, jh.inp)
    assert_same_scheme_plan(partition.plan_from_scheme_layout(lay), jpart.plan_from_scheme_layout(jlay))


def _topologies(ratios):
    caps = dict(zip(("e0", "e1", "e2", "e3"), (1.0, *ratios)))
    secs = tuple(caps)[1:len(ratios) + 1]
    mk = lambda mod: mod.CollabTopology(  # noqa: E731
        host="e0", secondaries=secs,
        platforms={es: mod.Platform(es, c * 1e12, c * 1e12) for es, c in caps.items() if es == "e0" or es in secs},
        default_link=mod.Link(1e9))
    return mk(topology), mk(jtopo)


@pytest.mark.parametrize("net", ["vit_l16", "vgg16"])
def test_plan_scheme_from_capacities_matches(net):
    """Capacities 5:3:2 give the ratios (0.5, 0.3, 0.2): ViT-L/16 takes
    halo_segment for the patch conv and head_sequence for all 24 blocks."""
    g, jg = NETS[net]
    topo, jt = _topologies((5.0, 3.0, 2.0))
    assert topo.capacity_ratios() == jt.capacity_ratios() == (0.5, 0.3, 0.2)
    sp = partition.plan_scheme(g, topo)
    assert_same_scheme_plan(sp, jpart.plan_scheme(jg, jt))
    if net == "vit_l16":
        assert sp.assignment == (partition.SCHEME_HALO,) + (partition.SCHEME_HS,) * 24
        assert [(s.scheme, s.start, s.stop) for s in sp.segments] == [
            (partition.SCHEME_HALO, 0, 0), (partition.SCHEME_HS, 1, 96)]
        assert partition._split_counts(16, sp.ratios) == [8, 5, 3]
        assert partition._split_counts(14, sp.ratios) == [7, 4, 3]


def test_topology_copy_matches():
    topo, jt = _topologies((5.0, 3.0, 2.0))
    assert topo.es_names == jt.es_names and topo.collab_pairs() == jt.collab_pairs()
    sub, jsub = topo.sub_topology(("e3", "e1")), jt.sub_topology(("e3", "e1"))
    assert sub.secondaries == jsub.secondaries and sub.capacity_ratios() == jsub.capacity_ratios()
    assert topo.link_between("e1", "e0").comm_time(1e6) == jt.link_between("e1", "e0").comm_time(1e6)
    sym, jsym = (m.CollabTopology.symmetric(m.Platform("p", 2e12, 1e12), m.Link(5e8), n_secondaries=3)
                 for m in (topology, jtopo))
    assert sym.es_names == jsym.es_names and sym.capacity_ratios() == jsym.capacity_ratios()
    with pytest.raises(ValueError):
        topology.CollabTopology(host="e0", secondaries=("e0",), platforms={"e0": None})


@pytest.mark.parametrize("net", sorted(NETS))
def test_stage_options_and_baseline_match(net):
    g, jg = NETS[net]
    assert partition.stage_spans(g) == jpart.stage_spans(jg)
    for schemes in (partition.SCHEMES, (partition.SCHEME_NP,), (partition.SCHEME_HS,)):
        assert partition.baseline_assignment(g, schemes) == jpart.baseline_assignment(jg, schemes)
        for span in partition.stage_spans(g):
            assert partition.stage_scheme_options(g, span, schemes) == jpart.stage_scheme_options(
                jg, span, schemes)


def test_vit_geometry_matches():
    for (g, jg) in (NETS["vit_l16"], NETS["vit_smoke"]):
        assert g.sizes() == jg.sizes() and g.head_flops == jg.head_flops and g.name == jg.name
        for i, (a, b) in enumerate(zip(g.layers, jg.layers)):
            assert (a.name, a.kind, a.k, a.s, a.p, a.c_in, a.c_out, a.heads) == (
                b.name, b.kind, b.k, b.s, b.p, b.c_in, b.c_out, b.heads)
            assert g.layer_flops(i) == jg.layer_flops(i)
            assert g.layer_flops(i, rows=3) == jg.layer_flops(i, rows=3)
    assert rf.attn("a", 64, 4) == rf.LayerGeom(**vars(jrf.attn("a", 64, 4)))
    with pytest.raises(ValueError):
        rf.attn("a", 65, 4)


@pytest.mark.parametrize(
    "net,kwargs",
    [("vit_smoke", {"assignment": ("non_penetrative",) * 3}),   # NP cannot split attention
     ("vgg_smoke", {"assignment": ("head_sequence",) * 5}),     # HS needs pointwise layers
     ("vgg_smoke", {"assignment": ("halo_segment",)}),          # one scheme per stage
     ("vgg_smoke", {"ratios": (1.0, -1.0)})],
)
def test_scheme_layout_rejects_like_jax(net, kwargs):
    g, jg = NETS[net]
    with pytest.raises(ValueError) as jexc:
        jpart.scheme_layout(jg, ("e1", "e2"), **kwargs)
    with pytest.raises(ValueError) as exc:
        partition.scheme_layout(g, ("e1", "e2"), **kwargs)
    assert type(exc.value) is type(jexc.value)
    for secs in (("e1",), ("e0", "e1")):
        with pytest.raises(ValueError):
            partition.scheme_layout(g, secs)
