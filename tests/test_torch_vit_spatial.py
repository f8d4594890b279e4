"""The port's spatial ViT and its mixed-scheme plan executor against the JAX
package's, on the CPU.

The same seeded parameters (non-zero biases) and images go through JAX
``vit_spatial.apply`` / ``run_plan`` and the port's (plain conv and plain
attention on the CPU); the port's plans come from its own copy of the
planner, the JAX ones from the JAX planner.  float32 tolerance 2e-5: only
the summation order differs (the attention's softmax and the 1x1 convs).
Within the port, ``run_plan`` on a ``SchemePlan`` equals the single-device
forward exactly: each shard is computed from the same inputs by the same code.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JCFG, JVIT_CFG, jax_vgg_params, jax_vit_params
from repro.core import partition as jpart
from repro.models import layers as jlayers
from repro.models import vgg as jvgg
from repro.models import vit_spatial as jvit
from repro.spatial import run_plan as jax_run_plan
from repro_torch.core import partition
from repro_torch.models import layers, vgg, vit_spatial
from repro_torch.models.common import params_from_jax
from repro_torch.spatial import run_plan

F32 = dict(rtol=2e-5, atol=2e-5)
CFG = vit_spatial.SMOKE
SECS = ("e1", "e2", "e3")
# (0.7, 0.2, 0.1) gives the third secondary no head of the 4
RATIOS = [(0.5, 0.3, 0.2), (1 / 3, 1 / 3, 1 / 3), (0.7, 0.2, 0.1)]


@pytest.fixture(scope="module")
def vit():
    jp = jax_vit_params()
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3), dtype=np.float32)
    return jp, params_from_jax(jp), x, np.asarray(jvit.features(jp, JVIT_CFG, jnp.asarray(x)))


def test_configs_match_jax():
    from repro.configs import vit_l16 as jconfigs

    full, ref = vit_spatial.FULL, jvit.ViTSpatialConfig()
    assert vars(full) == vars(ref)
    s = jconfigs.SMOKE
    assert (CFG.img_res, CFG.patch, CFG.n_blocks, CFG.d, CFG.heads, CFG.d_ff, CFG.num_classes) == (
        s.img_res, s.patch, s.n_layers, s.d_model, s.n_heads, s.d_ff, s.num_classes)
    assert vars(CFG) == vars(JVIT_CFG)


def test_init_shapes_match_jax():
    shapes = jax.eval_shape(lambda k: jvit.init(k, JVIT_CFG), jax.random.PRNGKey(0))
    p = vit_spatial.init(torch.Generator().manual_seed(0), CFG)
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), p)
    assert got == jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)


def test_global_avg_pool_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 6), dtype=np.float32)
    np.testing.assert_allclose(layers.global_avg_pool(torch.from_numpy(x)).numpy(),
                               np.asarray(jlayers.global_avg_pool(jnp.asarray(x))), **F32)


def test_apply_matches_jax(vit):
    jp, p, x, jfeats = vit
    feats = vit_spatial.features(p, CFG, torch.from_numpy(x))
    np.testing.assert_allclose(feats.numpy(), jfeats, **F32)
    np.testing.assert_allclose(vit_spatial.apply(p, CFG, torch.from_numpy(x)).numpy(),
                               np.asarray(jvit.apply(jp, JVIT_CFG, jnp.asarray(x))), **F32)


@pytest.mark.parametrize("ratios", RATIOS, ids=["5-3-2", "equal", "7-2-1"])
def test_run_vit_scheme_plan_matches_jax(vit, ratios):
    """The baseline plan: halo_segment for the patch conv, head_sequence for
    both blocks (heads and token rows split by ``ratios``)."""
    jp, p, x, jfeats = vit
    plan = partition.scheme_layout(CFG.geom(), SECS, ratios=ratios)
    assert plan.assignment == (partition.SCHEME_HALO, partition.SCHEME_HS, partition.SCHEME_HS)
    plan = partition.plan_from_scheme_layout(plan)
    jplan = jpart.plan_from_scheme_layout(jpart.scheme_layout(JVIT_CFG.geom(), SECS, ratios=ratios))
    out = run_plan(plan, p["features"], vit_spatial.apply_layer, torch.from_numpy(x))
    jout = jax_run_plan(jplan, jp["features"], jvit.apply_layer, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
    np.testing.assert_allclose(out.numpy(), jfeats, **F32)
    own = vit_spatial.features(p, CFG, torch.from_numpy(x))
    torch.testing.assert_close(out, own, rtol=0, atol=0)
    if ratios == (0.7, 0.2, 0.1):
        assert partition._split_counts(CFG.heads, plan.ratios)[-1] == 0


VGG_KINDS = {
    "non_penetrative": lambda P, net: tuple(P.SCHEME_NP for _ in P.stage_spans(net)),
    "mixed": lambda P, net: tuple((P.SCHEME_NP, P.SCHEME_HALO, P.SCHEME_HOST)[i % 3]
                                  for i in range(len(P.stage_spans(net)))),
}


@pytest.fixture(scope="module")
def vgg_setup():
    jp = jax_vgg_params()
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3), dtype=np.float32)
    return jp, params_from_jax(jp), x, np.asarray(jvgg.features(jp, JCFG, jnp.asarray(x)))


@pytest.mark.parametrize("kind", sorted(VGG_KINDS))
def test_run_vgg_scheme_plan_matches_jax(vgg_setup, kind):
    """VGG SMOKE under filter splits (every dense conv gets a non-contiguous
    slice of the HWIO weights) and under a halo / NP / host_solo mix."""
    jp, p, x, jfeats = vgg_setup
    net, jnet = vgg.SMOKE.geom(), JCFG.geom()
    make = VGG_KINDS[kind]
    plan = partition.plan_from_scheme_layout(partition.scheme_layout(
        net, SECS, ratios=(0.5, 0.3, 0.2), assignment=make(partition, net)))
    jplan = jpart.plan_from_scheme_layout(jpart.scheme_layout(
        jnet, SECS, ratios=(0.5, 0.3, 0.2), assignment=make(jpart, jnet)))
    out = run_plan(plan, p["features"], vgg.apply_layer, torch.from_numpy(x))
    jout = jax_run_plan(jplan, jp["features"], jvgg.apply_layer, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
    np.testing.assert_allclose(out.numpy(), jfeats, **F32)


@pytest.mark.parametrize("model", ["vit", "vgg_mixed"])
def test_scheme_time_observer_matches_jax(vit, vgg_setup, model):
    """One (es, flops, seconds) sample per physical ES, with the JAX
    executor's names and FLOP attribution across halo and hub segments."""
    if model == "vit":
        jp, p, x, _ = vit
        net, jnet, fn, jfn = CFG.geom(), JVIT_CFG.geom(), vit_spatial.apply_layer, jvit.apply_layer
        assign = jassign = None
    else:
        jp, p, x, _ = vgg_setup
        net, jnet, fn, jfn = vgg.SMOKE.geom(), JCFG.geom(), vgg.apply_layer, jvgg.apply_layer
        assign, jassign = VGG_KINDS["mixed"](partition, net), VGG_KINDS["mixed"](jpart, jnet)
    seen, jseen = [], []
    run_plan(partition.plan_from_scheme_layout(partition.scheme_layout(
                 net, SECS, ratios=(0.5, 0.3, 0.2), assignment=assign)),
             p["features"], fn, torch.from_numpy(x),
             time_observer=lambda es, fl, dt: seen.append((es, fl, dt)))
    jax_run_plan(jpart.plan_from_scheme_layout(jpart.scheme_layout(
                     jnet, SECS, ratios=(0.5, 0.3, 0.2), assignment=jassign)),
                 jp["features"], jfn, jnp.asarray(x),
                 time_observer=lambda es, fl, dt: jseen.append((es, fl, dt)))
    assert [(es, fl) for es, fl, _ in seen] == [(es, fl) for es, fl, _ in jseen]
    assert {es for es, _, _ in seen} == {"e0", *SECS}
    assert all(dt > 0 for _, _, dt in seen)
