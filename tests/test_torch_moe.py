"""The port's MoE layer (``repro_torch.models.moe``) against the JAX package's
``repro/models/moe.py``, on the CPU.

The same parameters (JAX's ``moe_init``, the router redrawn by seeded numpy
at std 1/sqrt(D) so that routing is decided by the input, not by near-ties
of a near-zero router, converted by ``params_from_jax``) and the same seeded
numpy tokens go through the JAX function and its twin.  Routing is held
exactly: the top-k ids (ties to the lower index, as ``lax.top_k``) and
``_dispatch``'s positions and keep mask are equal integers.  Values as
``tests/test_kernels.py: _tol``: 2e-5 x (1 + |y|) in float32; bfloat16 no
worse than JAX's own bfloat16 error against the float32 forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe
from repro_torch.models.common import params_from_jax

TOL = 2e-5
# JAX's init and float32 forward compiled once per config (op by op is
# slower here); the bfloat16 forward runs op by op, as the JAX package's own
# tests run it: under jit XLA fuses bfloat16 steps in float32 and rounds
# elsewhere
_jinit = jax.jit(jmoe.moe_init, static_argnums=(1,))
_japply = jax.jit(jmoe.moe_apply, static_argnums=(1,))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * (1 + np.abs(want))), np.abs(got - want).max()


def _cfg(**kw):
    base = dict(d_model=32, n_experts=8, top_k=2, d_ff=48)
    return jmoe.MoEConfig(**dict(base, **kw))


def _port(jcfg) -> moe.MoEConfig:
    return moe.MoEConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0):
    """JAX's init; the router redrawn at std 1/sqrt(D) and, where there is
    one, the router bias at 0.1 N(0, 1), from numpy."""
    rng = np.random.default_rng(seed)
    p = _jinit(jax.random.PRNGKey(seed), jcfg)
    d, e = jcfg.d_model, jcfg.n_experts
    p["router"]["w"] = jnp.asarray(rng.standard_normal((d, e), dtype=np.float32) / np.sqrt(d))
    if jcfg.router_bias:
        p["router_b"] = jnp.asarray(0.1 * rng.standard_normal(e, dtype=np.float32))
    return p


def _x(t, d, seed=1):
    return np.random.default_rng(seed).standard_normal((t, d), dtype=np.float32)


# -- router_topk --------------------------------------------------------------


def _router_case(name):
    """(JAX config, JAX params, x) of a router case."""
    jcfg = _cfg(top_k=3, router_bias=name.startswith("bias"))
    p = _params(jcfg)
    x = _x(40, jcfg.d_model)
    if name == "all-tie":  # a zero router: every probability 1/E
        p["router"]["w"] = jnp.zeros_like(p["router"]["w"])
    elif name == "bias-tie":  # a zero router and a bias with a three-way tie at the top
        p["router"]["w"] = jnp.zeros_like(p["router"]["w"])
        p["router_b"] = jnp.asarray([0.1, 0.3, 0.3, 0.2, 0.3, 0.0, 0.1, 0.2], jnp.float32)
    elif name == "column-tie":  # experts 2, 5 and 6 share a column: per-token ties
        w = np.array(p["router"]["w"])
        w[:, 5] = w[:, 6] = w[:, 2]
        p["router"]["w"] = jnp.asarray(w)
    return jcfg, p, x


@pytest.mark.parametrize("name", ["random", "bias", "all-tie", "bias-tie", "column-tie"])
def test_router_topk_matches_jax(name):
    jcfg, p, x = _router_case(name)
    wg, wi, wp = jmoe.router_topk(p, jcfg, jnp.asarray(x))
    gg, gi, gp = moe.router_topk(params_from_jax(p), _port(jcfg), torch.from_numpy(x))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gg, wg)
    _close(gp, wp)
    if name == "all-tie":
        assert (gi.numpy() == np.arange(3)).all()
    if name == "bias-tie":
        assert (gi.numpy() == [1, 2, 4]).all()
    if name == "column-tie":  # the tie is hit, and broken to the lower index
        rows = np.isin(gi.numpy(), [2, 5, 6]).sum(1) >= 2
        assert rows.any()
        for r in gi.numpy()[rows]:
            tied = [e for e in r if e in (2, 5, 6)]
            assert tied == sorted(tied)


def test_router_topk_bfloat16_matches_jax():
    """bfloat16: the router product in bf16, then float32; the ids and gates
    equal JAX's."""
    jcfg, p, x = _router_case("bias")
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
    wg, wi, wp = jmoe.router_topk(jp, jcfg, jnp.asarray(x).astype(jnp.bfloat16))
    gg, gi, gp = moe.router_topk(params_from_jax(jp), _port(jcfg), torch.from_numpy(x).to(torch.bfloat16))
    assert gg.dtype == torch.bfloat16 and gp.dtype == torch.float32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gg.float(), wg.astype(jnp.float32), 0)
    _close(gp, wp)


# -- _dispatch -------------------------------------------------------------------


def _skewed_ids(t, e, k, seed):
    """[T, k] distinct experts per token, expert 0 and 1 far likelier."""
    rng = np.random.default_rng(seed)
    w = np.ones(e)
    w[:2] = 8.0
    return np.stack([rng.choice(e, size=k, replace=False, p=w / w.sum()) for _ in range(t)]).astype(np.int32)


@pytest.mark.parametrize("t,e,k,capacity", [(16, 8, 2, 4), (64, 8, 2, 16), (50, 16, 4, 3), (30, 8, 3, 100),
                                            (7, 4, 2, 1)])
def test_dispatch_integers_match_jax(t, e, k, capacity):
    ids = _skewed_ids(t, e, k, seed=t + e)
    want = jmoe._dispatch(jnp.asarray(ids), e, capacity)
    got = moe._dispatch(torch.from_numpy(ids).long(), e, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = got[2].numpy()
    if capacity < t * k // e:
        assert not keep.all()  # skewed loads overflow: some pairs are dropped
    if capacity >= t:
        assert keep.all()


# -- moe_apply ---------------------------------------------------------------------


MOE_CASES = [  # (name, T, config overrides)
    ("dropless", 24, {}),
    ("dropless-shared-bias", 40, dict(n_shared=1, router_bias=True)),
    ("capacity", 320, dict(capacity_factor=1.0)),  # T > dropless_below: pairs past capacity drop
    ("capacity-shared-bias", 320, dict(capacity_factor=1.0, n_shared=1, router_bias=True)),
    ("capacity-top3", 300, dict(top_k=3, capacity_factor=0.75, dropless_below=64)),
]


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: c[0])
def test_moe_apply_matches_jax(case):
    name, t, kw = case
    jcfg = _cfg(**kw)
    p = _params(jcfg, seed=t)
    x = _x(t, jcfg.d_model, seed=t + 1)
    want, waux = _japply(p, jcfg, jnp.asarray(x))
    got, aux = moe.moe_apply(params_from_jax(p), _port(jcfg), torch.from_numpy(x))
    _close(got, want)
    for key in ("load_balance_loss", "dropped_frac"):
        _close(aux[key], waux[key])
    dropped = float(aux["dropped_frac"])
    assert (dropped > 0) == name.startswith("capacity"), dropped


@pytest.mark.parametrize("case", MOE_CASES[:1] + MOE_CASES[3:4], ids=lambda c: c[0])
def test_moe_apply_bfloat16_matches_jax(case):
    """bfloat16 parameters and tokens: the port's error against JAX's float32
    forward is no worse than JAX's own bfloat16 forward's."""
    name, t, kw = case
    jcfg = _cfg(**kw)
    p = _params(jcfg, seed=t)
    x = _x(t, jcfg.d_model, seed=t + 1)
    want = np.asarray(_japply(p, jcfg, jnp.asarray(x))[0])
    jbf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
    xbf = jnp.asarray(x).astype(jnp.bfloat16)
    jy, jaux = jmoe.moe_apply(jbf, jcfg, xbf)
    got, aux = moe.moe_apply(params_from_jax(jbf), _port(jcfg), torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    jax_err = np.abs(np.asarray(jy.astype(jnp.float32)) - want).max()
    assert err <= jax_err, (err, jax_err)
    _close(aux["dropped_frac"], jaux["dropped_frac"])


def test_moe_decode_sized_batch_is_dropless():
    """A token count at or below ``dropless_below`` raises the capacity to T:
    no pair drops even when every token picks the same experts."""
    jcfg = _cfg(capacity_factor=0.25)
    p = _params(jcfg)
    p["router"]["w"] = jnp.zeros_like(p["router"]["w"])  # all tie: every token picks experts 0, 1
    x = _x(6, jcfg.d_model)
    want, waux = _japply(p, jcfg, jnp.asarray(x))
    got, aux = moe.moe_apply(params_from_jax(p), _port(jcfg), torch.from_numpy(x))
    _close(got, want)
    _close(aux["dropped_frac"], waux["dropped_frac"])
    assert float(aux["dropped_frac"]) == 0.0


def test_moe_init_layout_matches_jax():
    """The same keys, shapes and types, with and without the shared experts
    and the router bias."""
    for kw in ({}, dict(n_shared=2, router_bias=True)):
        jcfg = _cfg(**kw)
        jshapes = jax.eval_shape(lambda k: jmoe.moe_init(k, jcfg), jax.random.PRNGKey(0))
        got = moe.moe_init(torch.Generator().manual_seed(0), _port(jcfg))
        assert jax.tree_util.tree_structure(jshapes) == jax.tree_util.tree_structure(got)
        for a, g in zip(jax.tree_util.tree_leaves(jshapes), jax.tree_util.tree_leaves(got)):
            assert tuple(g.shape) == a.shape and g.dtype == torch.float32
        bf = moe.moe_init(torch.Generator().manual_seed(0), _port(jcfg), dtype=torch.bfloat16, device="meta")
        assert all(g.dtype == torch.bfloat16 and g.device.type == "meta" for g in jax.tree_util.tree_leaves(bf))
