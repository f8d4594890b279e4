"""The port's HALP plan executor against the JAX package's, on the CPU.

The same seeded parameters and images go through JAX ``run_plan`` /
``vgg.features`` and the port's ``run_plan`` (plain conv on the CPU).  The
port's plan is built by its own copy of the planner, the JAX one by the JAX
planner.  float32 tolerance 2e-5: only the summation order of the conv
differs, and the smoke stack stays inside it (tests/test_torch_vgg.py).
Within the port, ``run_plan`` equals the single-device ``features`` exactly:
every output row is computed from the same input rows by the same code.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JCFG, jax_vgg_params
from repro.core import partition as jpart
from repro.models import vgg as jvgg
from repro.spatial import run_plan as jax_run_plan
from repro_torch.core import partition
from repro_torch.models import vgg
from repro_torch.models.common import params_from_jax
from repro_torch.spatial import run_plan

F32 = dict(rtol=2e-5, atol=2e-5)

PLANS = {
    "halp": lambda part, net: part.plan_halp(net, overlap_rows=4),
    "halp_skewed": lambda part, net: part.plan_halp(net, overlap_rows=4, ratios=(0.7, 0.3)),
    "n3_skewed": lambda part, net: part.plan_halp_n(
        net, secondaries=("e1", "e2", "e3"), ratios=(0.5, 0.3, 0.2), overlap_rows=4),
    "n4_thin_zone": lambda part, net: part.plan_halp_n(
        net, secondaries=("a", "b", "c", "d"), ratios=(0.4, 0.1, 0.1, 0.4), overlap_rows=2),
}


@pytest.fixture(scope="module")
def setup():
    jp = jax_vgg_params()
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3), dtype=np.float32)
    jfeats = np.asarray(jvgg.features(jp, JCFG, jnp.asarray(x)))
    return jp, params_from_jax(jp), x, jfeats


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_run_plan_matches_jax(setup, plan):
    """Against JAX ``vgg.features`` for every plan, and against JAX
    ``run_plan`` (slow in eager JAX) for the paper's plan and a skewed N-way one."""
    jp, p, x, jfeats = setup
    make = PLANS[plan]
    out = run_plan(make(partition, vgg.SMOKE.geom()), p["features"], vgg.apply_layer,
                   torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), jfeats, **F32)
    if plan in ("halp", "n3_skewed"):
        jout = jax_run_plan(make(jpart, JCFG.geom()), jp["features"], jvgg.apply_layer,
                            jnp.asarray(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
    own = vgg.features(p, vgg.SMOKE, torch.from_numpy(x))
    torch.testing.assert_close(out, own, rtol=0, atol=0)


def test_run_plan_with_head_matches_jax_apply(setup):
    jp, p, x, _ = setup
    feats = run_plan(partition.plan_halp(vgg.SMOKE.geom()), p["features"], vgg.apply_layer,
                     torch.from_numpy(x))
    np.testing.assert_allclose(vgg.head(p, feats).numpy(),
                               np.asarray(jvgg.apply(jp, JCFG, jnp.asarray(x))), **F32)


def test_run_plan_time_observer_matches_jax(setup):
    """One (es, flops, seconds) sample per slot, with the JAX executor's FLOP
    attribution."""
    jp, p, x, _ = setup
    seen, jseen = [], []
    run_plan(partition.plan_halp(vgg.SMOKE.geom()), p["features"], vgg.apply_layer,
             torch.from_numpy(x), time_observer=lambda es, fl, dt: seen.append((es, fl, dt)))
    jax_run_plan(jpart.plan_halp(JCFG.geom()), jp["features"], jvgg.apply_layer, jnp.asarray(x),
                 time_observer=lambda es, fl, dt: jseen.append((es, fl, dt)))
    assert [(es, fl) for es, fl, _ in seen] == [(es, fl) for es, fl, _ in jseen]
    assert all(dt > 0 for _, _, dt in seen)


def test_run_plan_reads_only_the_plans_rows(setup):
    """Reconstruction is strict: a plan whose messages are cut short fails
    loudly instead of producing a wrong feature map."""
    _, p, x, _ = setup
    plan = partition.plan_halp(vgg.SMOKE.geom())
    part = plan.parts[1]
    narrowed = dict(part.inp)
    seg = narrowed["e2"]
    narrowed["e2"] = partition.Segment(seg.lo + 1, seg.hi)  # e2 'needs' one row fewer
    broken = plan.parts[:1] + (partition.LayerPartition(1, part.out, narrowed),) + plan.parts[2:]
    plan = partition.HALPPlan(plan.net, broken, plan.es_names, plan.host, plan.slot_owner)
    with pytest.raises(AssertionError, match="insufficient rows"):
        run_plan(plan, p["features"], vgg.apply_layer, torch.from_numpy(x))
