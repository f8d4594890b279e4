"""The port's VGG-16 against the JAX package's, on the CPU.

Parameters and inputs come from numpy with a seed, in the JAX parameter
tree's structure; the port takes them through ``params_from_jax``.  Tolerances: 2e-5
for float32 -- measured at the smoke size, the whole 13-conv stack stays
inside it, since both sides sum float32 products and only the order differs
-- and 2e-2 for bfloat16 (rounding at other places), the values of
``tests/test_kernels.py: _tol``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JCFG, jax_vgg_params
from repro.models import layers as jlayers
from repro.models import vgg as jvgg
from repro_torch.models import layers, vgg
from repro_torch.models.common import conv_params, dense_params, params_from_jax

CFG = vgg.SMOKE
F32 = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def jparams():
    return jax_vgg_params()


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).standard_normal((2, 64, 64, 3), dtype=np.float32)


def test_configs_match_jax():
    from repro.configs import vgg16 as jconfigs

    for port, ref in ((vgg.FULL, jconfigs.FULL), (vgg.SMOKE, jconfigs.SMOKE)):
        assert (port.img_res, port.in_channels, port.num_classes, port.width_mult,
                port.blocks, port.fc_dims) == (ref.img_res, ref.in_channels, ref.num_classes,
                                               ref.width_mult, ref.blocks, ref.fc_dims)
        assert port.widths() == ref.widths()


def test_params_from_jax(jparams):
    p = params_from_jax(jparams)
    jleaves = jax.tree_util.tree_leaves(jparams)
    leaves = [t for layer in p["features"] + p["head"] for _, t in sorted(layer.items())]
    assert len(leaves) == len(jleaves)
    for t, a in zip(leaves, jleaves):
        assert t.dtype == torch.float32 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    assert p["features"][2] == {}  # pool layers keep their empty slot


def test_params_from_jax_bfloat16_and_cast():
    tree = {"w": jnp.asarray([[1.5, -2.25], [3.0e-3, 7.0]], jnp.bfloat16), "b": [jnp.ones(2)]}
    p = params_from_jax(tree)
    assert p["w"].dtype == torch.bfloat16 and isinstance(p["b"], list)
    np.testing.assert_array_equal(p["w"].float().numpy(), np.asarray(tree["w"], np.float32))
    assert params_from_jax(tree, dtype=torch.float32)["w"].dtype == torch.float32


def test_init_shapes_match_jax():
    p = vgg.init(torch.Generator().manual_seed(0), CFG)
    jinit = jax.eval_shape(lambda k: jvgg.init(k, JCFG), jax.random.PRNGKey(0))
    jshapes = [a.shape for a in jax.tree_util.tree_leaves(jinit)]
    shapes = [tuple(t.shape) for layer in p["features"] + p["head"] for _, t in sorted(layer.items())]
    assert shapes == jshapes


def test_initializers_scale():
    gen = torch.Generator().manual_seed(1)
    w = conv_params(gen, 3, 64, 128)["w"]
    assert tuple(w.shape) == (3, 3, 64, 128)
    assert abs(w.std().item() - (2.0 / (9 * 64)) ** 0.5) < 0.01  # He normal
    d = dense_params(gen, 512, 256)
    assert abs(d["w"].std().item() - (1.0 / 512) ** 0.5) < 0.01  # LeCun normal
    assert not d["b"].any()


@pytest.mark.parametrize("layer", range(18))
def test_apply_layer_matches_jax(jparams, layer):
    """Each feature layer, VALID, on an input padded as features() pads it."""
    geom = CFG.geom()
    g = geom.layers[layer]
    rows = geom.sizes()[layer] + (2 * g.p if g.kind != "pool" else 0)
    x = np.random.default_rng(layer).standard_normal((2, rows, rows, g.c_in), dtype=np.float32)
    p = params_from_jax(jparams["features"][layer])
    want = jvgg.apply_layer(jparams["features"][layer], JCFG.geom().layers[layer], jnp.asarray(x))
    got = vgg.apply_layer(p, g, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_max_pool_matches_reduce_window():
    x = np.random.default_rng(3).standard_normal((2, 9, 7, 5), dtype=np.float32)
    for k, s in ((2, 2), (3, 2), (3, 1)):
        want = np.asarray(jlayers.max_pool(jnp.asarray(x), k=k, s=s))
        np.testing.assert_array_equal(layers.max_pool(torch.from_numpy(x), k=k, s=s).numpy(), want)


def test_conv2d_layer_padding_modes():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 6, 6, 2), dtype=np.float32))
    p = {"w": torch.ones(3, 3, 2, 4), "b": torch.zeros(4)}
    torch.testing.assert_close(layers.conv2d(x, p, padding="SAME"), layers.conv2d(x, p, padding=1))
    assert layers.conv2d(x, p, padding="VALID").shape == (1, 4, 4, 4)
    with pytest.raises(ValueError):
        layers.conv2d(x, p, stride=2, padding="SAME")


def test_features_and_apply_match_jax(jparams, images):
    p = params_from_jax(jparams)
    x = torch.from_numpy(images)
    np.testing.assert_allclose(vgg.features(p, CFG, x).numpy(),
                               np.asarray(jvgg.features(jparams, JCFG, jnp.asarray(images))), **F32)
    logits = vgg.apply(p, CFG, x)
    assert tuple(logits.shape) == (2, 10)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jvgg.apply(jparams, JCFG, jnp.asarray(images))), **F32)


def test_apply_bfloat16_matches_jax(jparams, images):
    """bfloat16 through the whole stack.  JAX and the port both round each
    conv's float32 sum to bfloat16 and then add the bias in bfloat16
    (``conv_igemm.cuh: finish``), so the two forwards round at the same
    places: the logits agree elementwise within 2e-2 * (1 + |y|) (measured:
    one bf16 step, 0.0156, on logits up to 8.2).  Also held against the
    float32 forward: the port's bfloat16 error stays within 2e-2 of the
    largest |logit| and no larger than JAX's own bfloat16 error."""
    want = np.asarray(jvgg.apply(jparams, JCFG, jnp.asarray(images)))
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jparams)
    jax_bf16 = np.asarray(jvgg.apply(jp, JCFG, jnp.asarray(images).astype(jnp.bfloat16))
                          .astype(jnp.float32))
    got = vgg.apply(params_from_jax(jp), CFG, torch.from_numpy(images).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - jax_bf16) <= 2e-2 * (1 + np.abs(jax_bf16)))
    err = np.abs(got - want).max()
    assert err <= 2e-2 * np.abs(want).max()
    assert err <= np.abs(jax_bf16 - want).max()
