"""Shared inputs of the port's parity tests (tests/test_torch_*.py)."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.models import vgg as jvgg
from repro.models import vit_spatial as jvit

# the JAX package's reduced VGG-16 (repro/configs/vgg16.py SMOKE)
JCFG = jvgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10)
# the JAX spatial ViT at the widths of repro/configs/vit_l16.py SMOKE
JVIT_CFG = jvit.ViTSpatialConfig(name="vit_l16_smoke", img_res=64, patch=8, n_blocks=2, d=64,
                                 heads=4, d_ff=128, num_classes=10)


def _seeded_tree(shapes, seed):
    """A tree of the given abstract shapes filled with seeded numpy values:
    fan-in-scaled weights and non-zero biases, so bias paths are covered."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        scale = 0.1 if len(s.shape) == 1 else (2.0 / np.prod(s.shape[:-1])) ** 0.5
        return jnp.asarray(scale * rng.standard_normal(s.shape, dtype=np.float32))

    return jax.tree_util.tree_map(leaf, shapes)


def jax_vgg_params(cfg=JCFG, seed=0):
    """A JAX VGG parameter tree (the shapes of ``jvgg.init``) of seeded numpy
    values: He-scaled weights and non-zero biases, so bias paths are covered."""
    return _seeded_tree(jax.eval_shape(lambda k: jvgg.init(k, cfg), jax.random.PRNGKey(0)), seed)


def jax_vit_params(cfg=JVIT_CFG, seed=0):
    """A JAX spatial-ViT parameter tree (the shapes of ``jvit.init``) of
    seeded numpy values, as :func:`jax_vgg_params`."""
    return _seeded_tree(jax.eval_shape(lambda k: jvit.init(k, cfg), jax.random.PRNGKey(0)), seed)
