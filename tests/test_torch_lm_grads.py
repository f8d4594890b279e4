"""The LM's attention and MoE modules under autograd in the port
(``repro_torch.models.attention.gqa_apply`` / ``mla_apply`` through K3's
autograd ``Function``, ``models.moe.moe_apply``) against ``jax.vjp`` of the
JAX package's, on the CPU, float32.

Each case takes the gradient of every argument -- the activations and every
parameter leaf -- for a seeded numpy cotangent, and holds it within
2e-5 x (1 + the largest |g|) plus 1e-4 of the largest |g| (summation order
over the sequence and the experts).  JAX's side runs jitted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.models import attention as jattn
from repro.models import moe as jmoe
from _torch_parity import perturb_norms
from repro_torch.models import attention, moe
from repro_torch.models.common import params_from_jax

DEPTH_RTOL, TOL = 1e-4, 2e-5

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


def _vjp_pair(jfn, tfn, jargs: list, seed: int):
    """(port, JAX) gradients of <f(args), cotangent> with respect to every
    argument: ``jfn`` and ``tfn`` take the same float32 numpy arguments (as
    arrays / tensors) and return one array."""
    jargs = [jnp.asarray(a) for a in jargs]
    shape = jax.eval_shape(jfn, *jargs).shape
    ct = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    want = jax.jit(lambda ct, *a: jax.vjp(jfn, *a)[1](ct))(jnp.asarray(ct), *jargs)
    targs = [torch.from_numpy(np.array(a)).requires_grad_() for a in jargs]
    got = torch.autograd.grad(tfn(*targs), targs, torch.from_numpy(ct), allow_unused=True)
    return [np.zeros(a.shape, np.float32) if g is None else _np(g) for g, a in zip(got, jargs)], \
        [_np(w) for w in want]


def _held_vjp(got, want):
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= TOL * (1 + np.abs(w).max()) + DEPTH_RTOL * np.abs(w).max(), \
            np.abs(g - w).max()


GRAD_GQA = [  # (B, T, d_model, H, Hkv, d_head, qk_norm)
    (2, 12, 64, 4, 2, 16, True),
    (1, 9, 64, 4, 1, 32, True),
    (1, 8, 128, 2, 2, 128, False),
]


@pytest.mark.parametrize("case", GRAD_GQA, ids=lambda c: f"h{c[3]}kv{c[4]}d{c[5]}")
def test_gqa_apply_vjp_matches_jax(case):
    """``gqa_apply`` through K3's Function (the KV-group sums of dk / dv),
    RoPE and qk-norm: the gradients of x and of every weight."""
    b, t, d_model, h, hkv, dh, qk_norm = case
    jcfg = jattn.GQAConfig(d_model=d_model, n_heads=h, n_kv_heads=hkv, d_head=dh, qk_norm=qk_norm)
    cfg = attention.GQAConfig(**dataclasses.asdict(jcfg))
    jp = perturb_norms(jattn.gqa_init(jax.random.PRNGKey(3), jcfg), 3)
    flat, treedef = jax.tree_util.tree_flatten(jp)
    x = np.random.default_rng(4).standard_normal((b, t, d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))

    def jfn(x, *ws):
        return jattn.gqa_apply(jax.tree_util.tree_unflatten(treedef, ws), jcfg, x, jnp.asarray(pos),
                               jattn.causal_mask(t))[0]

    def tfn(x, *ws):
        return attention.gqa_apply(jax.tree_util.tree_unflatten(treedef, list(ws)), cfg, x,
                                   torch.from_numpy(pos.copy()))[0]

    got, want = _vjp_pair(jfn, tfn, [x, *[np.asarray(a) for a in flat]], seed=5)
    _held_vjp(got, want)


MLA_GRAD = jattn.MLAConfig(d_model=64, n_heads=2, q_lora_rank=32, kv_lora_rank=24, qk_nope_head_dim=128,
                           qk_rope_head_dim=64, v_head_dim=128)


@pytest.mark.parametrize("cfg", [MLA_GRAD, jget("deepseek-v3-671b").smoke_cfg.mla], ids=["192-128", "smoke"])
def test_mla_apply_vjp_matches_jax(cfg):
    """``mla_apply``: at DeepSeek-V3's head widths (192, 128) through K3's
    Function, its RoPE key broadcast over the heads summed back in dk; at
    the smoke widths (24, 16) through JAX's plain branch."""
    pcfg = attention.MLAConfig(**dataclasses.asdict(cfg))
    jp = perturb_norms(jattn.mla_init(jax.random.PRNGKey(6), cfg), 6)
    flat, treedef = jax.tree_util.tree_flatten(jp)
    b, t = 2, 10
    x = np.random.default_rng(7).standard_normal((b, t, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))

    def jfn(x, *ws):
        return jattn.mla_apply(jax.tree_util.tree_unflatten(treedef, ws), cfg, x, jnp.asarray(pos),
                               jattn.causal_mask(t))[0]

    def tfn(x, *ws):
        return attention.mla_apply(jax.tree_util.tree_unflatten(treedef, list(ws)), pcfg, x,
                                   torch.from_numpy(pos.copy()))[0]

    got, want = _vjp_pair(jfn, tfn, [x, *[np.asarray(a) for a in flat]], seed=8)
    _held_vjp(got, want)


MOE_GRAD = [  # (name, config, tokens): drops above capacity, a shared expert, the router bias
    ("drops", jmoe.MoEConfig(d_model=32, n_experts=8, top_k=2, d_ff=24, n_shared=1, router_bias=True,
                             capacity_factor=1.0, dropless_below=4), 40),
    ("dropless", jmoe.MoEConfig(d_model=32, n_experts=4, top_k=2, d_ff=24, capacity_factor=1.0), 12),
]


@pytest.mark.parametrize("case", MOE_GRAD, ids=lambda c: c[0])
def test_moe_apply_vjp_matches_jax(case):
    """``moe_apply``'s y and load-balance loss under autograd: the gradients
    of x and of every leaf (router, router bias, experts, shared) against
    ``jax.vjp`` of JAX's, with pairs past capacity dropped (their gradient
    zero) and the load-balance term's gradient through the mean router
    probabilities only; the routes equal JAX's."""
    _, jcfg, n = case
    cfg = moe.MoEConfig(**dataclasses.asdict(jcfg))
    jp = perturb_norms(jmoe.moe_init(jax.random.PRNGKey(9), jcfg), 9)
    flat, treedef = jax.tree_util.tree_flatten(jp)
    x = np.random.default_rng(10).standard_normal((n, jcfg.d_model), dtype=np.float32)
    lb_ct = 3.0  # the load-balance term's cotangent beside y's

    def jfn(x, *ws):
        y, aux = jmoe.moe_apply(jax.tree_util.tree_unflatten(treedef, ws), jcfg, x)
        return jnp.concatenate([y.reshape(-1), lb_ct * aux["load_balance_loss"][None]])

    def tfn(x, *ws):
        y, aux = moe.moe_apply(jax.tree_util.tree_unflatten(treedef, list(ws)), cfg, x)
        return torch.cat([y.reshape(-1), lb_ct * aux["load_balance_loss"][None]])

    capacity = max(1, int(cfg.capacity_factor * n * cfg.top_k / cfg.n_experts))
    capacity = max(capacity, n) if n <= cfg.dropless_below else capacity
    _, _, keep = moe._dispatch(moe.router_topk(params_from_jax(jp), cfg, torch.from_numpy(x))[1],
                               cfg.n_experts, capacity)
    assert bool(keep.all()) == (case[0] == "dropless")
    got, want = _vjp_pair(jfn, tfn, [x, *[np.asarray(a) for a in flat]], seed=11)
    _held_vjp(got, want)
