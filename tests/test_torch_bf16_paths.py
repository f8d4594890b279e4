"""The port's bfloat16 forwards through its plan executors and its spatial
engine, against the JAX package's bfloat16 forward, on the CPU.

The same seeded parameters and images, cast to bfloat16, go through the port
-- the smoke ViT under ``plan_scheme`` / ``run_plan`` (head_sequence: the
attention split by heads, the 1x1 convs by token rows), the smoke VGG under
``plan_halp`` / ``run_plan`` and through the spatial engine in an equal
two-shard layout (fused engine) -- and through JAX's single-device bfloat16
``apply``, which every plan and layout is lossless to.  As
``tests/test_torch_vgg.py: test_apply_bfloat16_matches_jax``, each is held
to the JAX float32 forward: the port's bfloat16 error stays within 2e-2 of
the largest |logit| (bf16 ``_tol``) and no larger than JAX's own bfloat16
error.  The two bfloat16 forwards round at other places (JAX rounds the
attention's scores and probabilities to bfloat16, the port's plain
attention only its output), so they are not compared elementwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JCFG, JVIT_CFG, jax_vgg_params, jax_vit_params
from repro.models import vgg as jvgg
from repro.models import vit_spatial as jvit
from repro_torch.core import CollabTopology, Platform, partition
from repro_torch.launch.mesh import make_spatial_comm
from repro_torch.models import vgg, vit_spatial
from repro_torch.models.common import params_from_jax
from repro_torch.spatial import features_spatial, run_plan, spatial_alignment

# three secondaries of capacities 5:3:2 under a host, as chip_smoke.py's phase 6
TOPO = CollabTopology(host="e0", secondaries=("e1", "e2", "e3"),
                      platforms={es: Platform(es, c * 1e12, c * 1e12)
                                 for es, c in (("e0", 1.0), ("e1", 5.0), ("e2", 3.0), ("e3", 2.0))})


def _bf16(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), tree)


def _vit_port(p, x):
    plan = partition.plan_scheme(vit_spatial.SMOKE.geom(), TOPO)
    assert plan.assignment == (partition.SCHEME_HALO, partition.SCHEME_HS, partition.SCHEME_HS)
    return vit_spatial.head(p, run_plan(plan, p["features"], vit_spatial.apply_layer, x))


def _vgg_halp_port(p, x):
    plan = partition.plan_halp(vgg.SMOKE.geom(), overlap_rows=4)
    return vgg.head(p, run_plan(plan, p["features"], vgg.apply_layer, x))


def _vgg_spatial_port(p, x):
    net = vgg.SMOKE.geom()
    n = x.shape[1] // spatial_alignment(net)  # 2 shards of 32 rows
    ys = features_spatial(p["features"], net, list(x.chunk(n, dim=1)),
                          comm=make_spatial_comm(n, device="cpu"), engine="fused")
    return vgg.head(p, torch.cat(ys, dim=1))


PATHS = {
    "vit-plan_scheme": (jax_vit_params, jvit, JVIT_CFG, _vit_port),
    "vgg-plan_halp": (jax_vgg_params, jvgg, JCFG, _vgg_halp_port),
    "vgg-spatial-equal": (jax_vgg_params, jvgg, JCFG, _vgg_spatial_port),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_bfloat16_path_matches_jax(path):
    make_params, jmodel, jcfg, port = PATHS[path]
    jp = make_params()
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3), dtype=np.float32)
    want = np.asarray(jmodel.apply(jp, jcfg, jnp.asarray(x)))
    jax_bf16 = np.asarray(jmodel.apply(_bf16(jp), jcfg, jnp.asarray(x).astype(jnp.bfloat16))
                          .astype(jnp.float32))
    got = port(params_from_jax(_bf16(jp)), torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    # the float32 forward through the same path agrees with JAX's (the parity
    # the float32 tests hold), so the bfloat16 error below is the rounding's
    f32 = port(params_from_jax(jp), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(f32, want, rtol=2e-5, atol=2e-5)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), (err, np.abs(want).max())
    assert err <= np.abs(jax_bf16 - want).max(), (err, np.abs(jax_bf16 - want).max())
