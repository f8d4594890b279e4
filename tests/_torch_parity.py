"""Shared inputs of the port's parity tests (tests/test_torch_*.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import vgg as jvgg
from repro.models import vit_spatial as jvit
from repro_torch.models import attention, moe
from repro_torch.models import transformer_lm as lm

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


def perturb_norms(tree, seed):
    """A JAX parameter tree with each norm scale times (1 + 0.1 N(0, 1)) and
    each router bias 0.1 N(0, 1), from numpy, so those paths are covered."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        if "scale" in jax.tree_util.keystr(path):
            return a * jnp.asarray(1 + 0.1 * rng.standard_normal(a.shape, dtype=np.float32))
        if "router_b" in jax.tree_util.keystr(path):
            return jnp.asarray(0.1 * rng.standard_normal(a.shape, dtype=np.float32))
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def port_lm_config(jcfg) -> lm.LMConfig:
    """The port's LMConfig with a JAX LMConfig's fields (its MoEConfig and
    MLAConfig as the port's)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if jcfg.moe is not None:
        fields["moe"] = moe.MoEConfig(**dataclasses.asdict(jcfg.moe))
    if jcfg.mla is not None:
        fields["mla"] = attention.MLAConfig(**dataclasses.asdict(jcfg.mla))
    return lm.LMConfig(**fields)


def perturb_vision(tree, seed):
    """JAX's tree with each one-dimensional leaf replaced by seeded numpy
    values of its role: biases and means 0.1 N(0, 1), scales 1 + 0.1 N(0, 1),
    variances 1 + 0.2 |N(0, 1)|; ConvNeXt's gamma keeps its layer scale."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        shape = a.shape
        if name in ("b", "mean"):
            return jnp.asarray(0.1 * rng.standard_normal(shape, dtype=np.float32), a.dtype)
        if name == "scale":
            return jnp.asarray(1 + 0.1 * rng.standard_normal(shape, dtype=np.float32), a.dtype)
        if name == "var":
            return jnp.asarray(1 + 0.2 * np.abs(rng.standard_normal(shape, dtype=np.float32)), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def warm_jax_state(params, opt_cfg):
    """A JAX train state past warmup from ``params``: step and AdamW count
    1000 (bias corrections ~1, learning-rate scale 1), every second moment
    1e-4, so a step moves each parameter by about lr x 10 x its clipped
    gradient and the updates are held, not only the parameters."""
    from repro.optim import adamw as jadamw

    opt = jadamw.adamw_init(params, opt_cfg)
    nu = jax.tree_util.tree_map(lambda t: jnp.full_like(t, 1e-4), opt["nu"])
    return params, dict(opt, nu=nu, count=jnp.int32(1000)), jnp.int32(1000)


def diffusion_param_values(init, cfg, seed=0):
    """The tree of JAX's ``init(key, cfg)`` (shapes from ``jax.eval_shape``)
    filled with seeded numpy values of each leaf's role -- weights N(0, 1 /
    fan-in), a stacked layer's leading axis not counted, biases 0.1 N(0, 1),
    scales 1 + 0.1 N(0, 1), other leaves 0.02 N(0, 1) (DiT's adaLN-zero
    weights non-zero, so no block is the identity) --, rounded to bfloat16
    values so float32 and bfloat16 cases start from the same numbers."""
    import math

    rng = np.random.default_rng(seed)

    def leaf(path, a):
        keys = [str(getattr(k, "key", "")) for k in path]
        z = rng.standard_normal(a.shape, dtype=np.float32)
        if keys[-1] == "w":
            z = z / np.float32(math.sqrt(math.prod(a.shape[1:-1] if "blocks" in keys else a.shape[:-1])))
        elif keys[-1] == "b":
            z = np.float32(0.1) * z
        elif keys[-1] == "scale":
            z = 1 + np.float32(0.1) * z
        else:
            z = np.float32(0.02) * z
        return np.asarray(jnp.asarray(z).astype(jnp.bfloat16).astype(jnp.float32))

    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)
