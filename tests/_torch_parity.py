"""Shared inputs of the port's parity tests (tests/test_torch_*.py)."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.models import vgg as jvgg

# the JAX package's reduced VGG-16 (repro/configs/vgg16.py SMOKE)
JCFG = jvgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10)


def jax_vgg_params(cfg=JCFG, seed=0):
    """A JAX VGG parameter tree (the shapes of ``jvgg.init``) of seeded numpy
    values: He-scaled weights and non-zero biases, so bias paths are covered."""
    shapes = jax.eval_shape(lambda k: jvgg.init(k, cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(s):
        scale = 0.1 if len(s.shape) == 1 else (2.0 / np.prod(s.shape[:-1])) ** 0.5
        return jnp.asarray(scale * rng.standard_normal(s.shape, dtype=np.float32))

    return jax.tree_util.tree_map(leaf, shapes)
