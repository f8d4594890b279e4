"""Diffusion training in the port (``configs.steps._diffusion_train`` over
``models.unet`` and ``models.dit``, DiT's blocks under remat) against the JAX
package, on the CPU at the SMOKE configs (the bundles, DiT's remat, a JAX
trainer's state continued and the launcher:
``tests/test_torch_diffusion_train_runtime.py``).

The parameters fill the tree of JAX's init with seeded numpy values of each
leaf's role (as ``tests/test_torch_diffusion.py``: DiT's adaLN-zero weights
non-zero, so no block is the identity), rounded to values bfloat16 holds;
the batch (latents, timesteps, conditioning, noise) is seeded numpy.  Each
step starts from a state past warmup (step and AdamW count 1000, every
second moment 1e-4: a step moves each parameter by about lr x 10 x its
clipped gradient).  On the CPU the convs run K1's autograd ``Function`` and
the attention K3's (at the SMOKE U-Net's D = 8, which K3 has no pair for,
the plain version).

float32, against JAX's jitted step: the loss within ``DEPTH_RTOL`` = 1e-4,
each first moment (0.1 x the clipped gradient) and each update within 1e-4
of the tree's largest (a leaf the loss is blind to has no scale of its own),
the second moments within 1e-4.  bfloat16, against JAX's float32 step: the
loss within 2e-2, and leaf by leaf each first moment's distance (2-norm)
within 2e-2 of that leaf's norm, or within ``BF16_JAX_FACTOR`` x JAX's own
bfloat16 step's distance there (as ``tests/test_torch_train_loss.py``
holds the vision models).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import steps as jsteps
from _torch_parity import diffusion_param_values, warm_jax_state
from repro_torch.configs import get
from repro_torch.configs.steps import build
from repro_torch.models.common import train_state_from_jax, tree_leaves, tree_map

DIFFUSION = ("unet-sd15", "dit-xl2")
DEPTH_RTOL, BF16_RTOL, BF16_JAX_FACTOR, TOL = 1e-4, 2e-2, 3, 2e-5

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the smoke shapes' small operators run ~20x
    slower on all of a shared host's cores than on two."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)



def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.cache
def _param_values(name: str):
    ja = jget(name)
    return diffusion_param_values(ja.module.init, ja.smoke_cfg)


@functools.cache
def _batch(name: str, cell: str = "train_256", seed: int = 1) -> dict:
    """The smoke bundle's inputs as seeded float32 / int32 numpy arrays, in
    the bundle's order; bfloat16 values."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, (shape, dt) in build(get(name), cell, smoke=True).inputs.items():
        if dt == torch.int32:  # timesteps, or DiT's class ids
            high = 1000 if key == "t" else jget(name).smoke_cfg.num_classes
            out[key] = rng.integers(0, high, shape).astype(np.int32)
        else:
            z = rng.standard_normal(shape, dtype=np.float32)
            out[key] = np.asarray(jnp.asarray(z).astype(jnp.bfloat16).astype(jnp.float32))
    return out


@functools.cache
def _jax_step(name: str, dtype: str):
    """JAX's jitted smoke train_256 step in ``dtype`` from the warm state:
    (loss, new state as float32 numpy trees)."""
    ja = jget(name)
    jdt = jnp.dtype(dtype)
    jb = jsteps.build(ja, "train_256", smoke=True, dtype=jdt)
    params = jax.tree_util.tree_map(lambda v: jnp.asarray(v).astype(jdt), _param_values(name))
    js = warm_jax_state(params, jsteps._opt_cfg_for(ja))
    batch = [jnp.asarray(v) if v.dtype == np.int32 else jnp.asarray(v).astype(jdt) for v in _batch(name).values()]
    new, metrics = jax.jit(jb.fn)(js, *batch)
    return float(metrics["loss"]), jax.tree_util.tree_map(_np, new)


def port_step(name: str, dtype: torch.dtype, cfg=None):
    """The port's smoke train_256 step in ``dtype`` (at ``cfg`` when given)
    from the same warm state, fed the stream's float32 arrays (the step
    casts them): (metrics, state before, state after)."""
    a = get(name)
    a = dataclasses.replace(a, smoke_cfg=cfg) if cfg is not None else a
    b = build(a, "train_256", smoke=True, dtype=dtype)
    js = warm_jax_state(jax.tree_util.tree_map(jnp.asarray, _param_values(name)), jsteps._opt_cfg_for(jget(name)))
    params, opt, n = train_state_from_jax(js)
    state = (tree_map(lambda t: t.to(dtype), params), dict(opt, **{k: tree_map(lambda t: t.to(dtype), opt[k])
                                                                    for k in ("mu", "nu")}), n)
    new, metrics = b.fn(state, **{k: torch.from_numpy(v) for k, v in _batch(name).items()})
    return metrics, state, new


def by_path(port_tree, jax_tree) -> tuple[list, list]:
    """The leaves of a port tree and of JAX's (sorted keys) paired by path."""
    got, want = [], []
    tree_map(lambda g, w: (got.append(_np(g)), want.append(_np(w) if isinstance(w, torch.Tensor) else w)),
             port_tree, jax_tree)
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DIFFUSION)
def test_diffusion_train_step_matches_jax(name, dtype):
    tdt = getattr(torch, dtype)
    metrics, state, new = port_step(name, tdt)
    want_loss, jnew = _jax_step(name, "float32")
    assert list(metrics) == ["loss"] and metrics["loss"].dtype == torch.float32
    assert not metrics["loss"].requires_grad and int(new[2]) == 1001 and int(new[1]["count"]) == 1001
    assert all(t.dtype == tdt for t in tree_leaves(new[0]) + tree_leaves(new[1]["mu"]))
    mu, jmu = by_path(new[1]["mu"], jnew[1]["mu"])
    if dtype == "float32":
        assert abs(metrics["loss"].item() - want_loss) <= DEPTH_RTOL * abs(want_loss)
        top = max(np.abs(w).max() for w in jmu)
        assert max(np.abs(g - w).max() for g, w in zip(mu, jmu)) <= DEPTH_RTOL * top
        got_p, want_p = by_path(new[0], jnew[0])
        old = [_np(t) for t in tree_leaves(state[0])]
        top = max(np.abs(w - o).max() for w, o in zip(want_p, old))
        assert top > 1e-5  # the step moved the parameters
        for g, w, o in zip(got_p, want_p, old):
            assert np.abs(g - w).max() <= DEPTH_RTOL * top + TOL * np.abs(o).max()
        nu, jnu = by_path(new[1]["nu"], jnew[1]["nu"])
        for g, w in zip(nu, jnu):
            np.testing.assert_allclose(g, w, rtol=DEPTH_RTOL, atol=0)
        return
    assert abs(metrics["loss"].item() - want_loss) <= BF16_RTOL * abs(want_loss)
    gap = np.array([np.linalg.norm(g - w) for g, w in zip(mu, jmu)])
    scale = np.array([np.linalg.norm(w) for w in jmu])
    if (gap <= BF16_RTOL * scale).all():
        return
    jax_mu = by_path(new[1]["mu"], _jax_step(name, "bfloat16")[1][1]["mu"])[1]
    limit = np.maximum(BF16_RTOL * scale, BF16_JAX_FACTOR * np.array([np.linalg.norm(j - w)
                                                                      for j, w in zip(jax_mu, jmu)]))
    worst = int(np.argmax(gap - limit))
    assert (gap <= limit).all(), (worst, gap[worst], limit[worst], scale[worst])
