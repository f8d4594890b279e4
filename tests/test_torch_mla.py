"""The port's MLA (``repro_torch.models.attention``: ``mla_init``,
``mla_apply``, the plain ``_mla_attend`` / ``_mla_chunked_causal``) and
DeepSeek-V3's layer stacks against the JAX package, on the CPU.

The same parameters (JAX's init, the norm scales perturbed by seeded numpy
noise) and the same seeded numpy activations go through the JAX function and
its twin.  Two widths: the DeepSeek-V3 smoke config's (no-RoPE 16, RoPE 8,
value 16: a query/key width of 24, which K3 does not compile, so
``mla_apply`` takes JAX's plain branches for it, on the CPU only) and a
narrow config with DeepSeek-V3's head widths (no-RoPE 128, RoPE 64, value
128: K3's (192, 128) pair, whose plain version runs on the CPU -- the
function JAX's two einsums compute).  Tolerance
as ``tests/test_kernels.py: _tol``: 2e-5 x (1 + |y|) in float32 (the logits
are one dot product over the 192 dims here, two added there: summation
order).  deepseek-smoke's forward, decode, bfloat16 forward, init / cache
trees and bundles run as cases of ``tests/test_torch_lm.py``'s tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import attention as jattn
from repro.models import transformer_lm as jlm
from repro.models.moe import MoEConfig as JMoEConfig
from _torch_parity import perturb_norms, port_lm_config
from repro_torch.kernels.attention import attention_ref
from repro_torch.models import attention, moe
from repro_torch.models import transformer_lm as lm
from repro_torch.models.common import params_from_jax, stack_layers

TOL = 2e-5
# (name, JAX MLAConfig): the smoke widths, and DeepSeek-V3's head widths at a narrow d_model
MLA_CFGS = {
    "smoke-24-16": jattn.MLAConfig(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    "wide-192-128": jattn.MLAConfig(d_model=256, n_heads=4, q_lora_rank=64, kv_lora_rank=32),
}
# a dense MLA layer then an MoE layer at DeepSeek-V3's head widths, with its
# shared expert, router bias and MTP head
MLA2 = jlm.LMConfig(name="mla-moe-2l", n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_head=128,
                    d_ff=256, vocab=512, rope_theta=1e4, attn="mla", mla=MLA_CFGS["wide-192-128"],
                    moe=JMoEConfig(d_model=256, n_experts=8, top_k=2, d_ff=64, n_shared=1, router_bias=True,
                                   capacity_factor=2.0),
                    first_k_dense=1, mtp_depth=1)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * (1 + np.abs(want))), np.abs(got - want).max()


def _mla(name, seed=0):
    jcfg = MLA_CFGS[name]
    jp = perturb_norms(jattn.mla_init(jax.random.PRNGKey(seed), jcfg), seed)
    return jcfg, attention.MLAConfig(**dataclasses.asdict(jcfg)), jp, params_from_jax(jp)


@pytest.mark.parametrize("t", [8, 33, 4096], ids=["T8", "T33", "T4096-chunked"])
@pytest.mark.parametrize("name", MLA_CFGS)
def test_mla_apply_matches_jax(name, t):
    """Prefill: causal MLA over T tokens; T = 4096 is JAX's
    ``_mla_chunked_causal`` branch.  No cache in, none out."""
    jcfg, cfg, jp, p = _mla(name)
    b = 1 if t >= 4096 else 2
    x = np.random.default_rng(t).standard_normal((b, t, jcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    want, jcache = jattn.mla_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), jattn.causal_mask(t))
    got, cache = attention.mla_apply(p, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert cache is None and jcache is None
    _close(got, want)


def _split_heads(rng, b, t, s, h, nope, rope, dv):
    shapes = ((b, t, h, nope), (b, t, h, rope), (b, s, h, nope), (b, s, rope), (b, s, h, dv))
    return [rng.standard_normal(sh, dtype=np.float32) for sh in shapes]


@pytest.mark.parametrize("t", [33, 2048])
def test_plain_mla_attend_matches_jax(t):
    """The plain versions kept for reference: ``_mla_attend`` under the
    causal mask against JAX's plain branch (``_mla_chunked_causal`` with one
    block of all T queries runs exactly its einsums, mask and softmax), and
    ``_mla_chunked_causal`` (chunk 512 at T = 2048) against JAX's; under the
    decode mask against K3's plain version over the visible prefix."""
    rng = np.random.default_rng(t)
    arrays = _split_heads(rng, 1, t, t, 2, 128, 64, 128)
    j, g = [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]
    scale = 192 ** -0.5
    got = attention._mla_attend(*g, attention.causal_mask(t), scale)
    _close(got, jattn._mla_chunked_causal(*j, scale, chunk=t))
    if t % 512 == 0:
        chunked = attention._mla_chunked_causal(*g, scale, chunk=512)
        _close(chunked, jattn._mla_chunked_causal(*j, scale, chunk=512))
        _close(chunked, got)
    idx = t // 2
    qn, qr, kn, kr, v = g
    dec = attention._mla_attend(qn[:, :1], qr[:, :1], kn, kr, v, attention.decode_mask(t, idx), scale)
    q = torch.cat([qn[:, :1], qr[:, :1]], -1).transpose(1, 2)
    k = torch.cat([kn, kr[:, :, None].expand(-1, -1, 2, -1)], -1)[:, :idx + 1].transpose(1, 2)
    want = attention_ref(q, k, v[:, :idx + 1].transpose(1, 2), causal=False).transpose(1, 2)
    _close(dec, want)


@pytest.mark.parametrize("name", MLA_CFGS)
def test_mla_apply_with_cache_matches_jax(name):
    """8 decode steps against a 12-slot latent cache: each step's output and
    the cache after it against JAX's (which expands and masks every slot;
    the port expands the prefix only), and each step's output against the
    prefill's at its position."""
    jcfg, cfg, jp, p = _mla(name, seed=1)
    b, steps, s_max = 2, 8, 12
    x = np.random.default_rng(2).standard_normal((b, steps, jcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(steps, dtype=np.int32), (b, steps)).copy()
    full, _ = attention.mla_apply(p, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    width = jcfg.kv_lora_rank + jcfg.qk_rope_head_dim
    jcache, cache = jnp.zeros((b, s_max, width)), torch.zeros((b, s_max, width))
    for i in range(steps):
        xi, pi = x[:, i:i + 1], pos[:, i:i + 1]
        want, jcache = jattn.mla_apply(jp, jcfg, jnp.asarray(xi), jnp.asarray(pi), jattn.decode_mask(s_max, i),
                                       jcache, i)
        got, out_cache = attention.mla_apply(p, cfg, torch.from_numpy(xi), torch.from_numpy(pi), cache, i)
        assert out_cache is cache  # written in place
        _close(got, want)
        _close(cache, jcache)
        _close(got[:, 0], full[:, i])
    assert not cache[:, steps:].any()


def test_mla_apply_decode_takes_one_token():
    _, cfg, _, p = _mla("smoke-24-16")
    x = torch.zeros((1, 2, cfg.d_model))
    with pytest.raises(NotImplementedError, match="one token"):
        attention.mla_apply(p, cfg, x, torch.zeros((1, 2), dtype=torch.int32), torch.zeros((1, 4, 24)), 0)


def test_mla_lm_forward_and_decode_match_jax():
    """Two layers at DeepSeek-V3's head widths (a dense stack and an MoE
    stack, shared expert, router bias, the MTP head built and ignored): the
    forward's logits and load-balance loss, then 8 decode steps' logits and
    the latent caches, against JAX's; and decode against the forward."""
    cfg = port_lm_config(MLA2)
    jp = perturb_norms(jlm.init(jax.random.PRNGKey(3), MLA2), 3)
    p = params_from_jax(jp)
    assert sorted(p) == ["dense_layers", "embed", "final_norm", "lm_head", "moe_layers", "mtp"]
    toks = np.random.default_rng(4).integers(0, MLA2.vocab, (2, 8), dtype=np.int32)
    want, want_lb = jlm.forward(jp, MLA2, jnp.asarray(toks))
    got, lb = lm.forward(p, cfg, torch.from_numpy(toks))
    _close(got, want)
    _close(lb, want_lb)
    jcache, cache = jlm.init_cache(MLA2, 2, 12), lm.init_cache(cfg, 2, 12, device="cpu")
    for i in range(8):
        jstep, jcache = jlm.decode_step(jp, MLA2, jcache, jnp.asarray(toks[:, i:i + 1]), i)
        step, cache = lm.decode_step(p, cfg, cache, torch.from_numpy(toks[:, i:i + 1]), i)
        _close(step, jstep)
        _close(step, got[:, i])
    for stack in ("dense", "moe"):
        _close(cache[stack], jcache[stack])


class _Allocations(TorchDispatchMode):
    """Every fresh tensor an op makes (not a view, not on the meta device):
    its shape and its storage."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.device.type != "meta" and not t._is_view():
                self.made.append((tuple(t.shape), t.untyped_storage().data_ptr()))
        return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_stack_layers_draws_no_second_copy_of_a_layer(dtype):
    """Drawing a stack of 3 MoE blocks allocates each stacked leaf once; the
    rest is one layer's small leaves and one expert's float32 matrix at a
    time -- never a layer's [E, D, F] expert leaf (a second copy of the
    layer), in float32 or bfloat16.  ``moe_init`` alone allocates its
    expert leaves once too."""
    mcfg = moe.MoEConfig(d_model=32, n_experts=16, top_k=2, d_ff=128)
    cfg = lm.LMConfig(name="moe-draw", n_layers=3, d_model=32, n_heads=4, n_kv_heads=4, d_head=8, d_ff=64,
                      vocab=64, moe=mcfg)
    expert, layer = 32 * 128, 16 * 32 * 128
    with _Allocations() as allocs:
        stacked = stack_layers(lambda g, dev, out: lm._block_init(g, cfg, True, dtype, dev, out),
                               torch.Generator().manual_seed(0), 3, "cpu")
    leaves = [stacked["ffn"]["experts"][k] for k in ("w1", "w3", "w2")]
    assert all(x.dtype == dtype and x.shape[0] == 3 and x.shape[1] == 16 and bool(x.any()) for x in leaves)
    stack_ptrs = {x.untyped_storage().data_ptr() for x in jax.tree_util.tree_leaves(stacked)}
    temps = [shape for shape, ptr in allocs.made if ptr not in stack_ptrs]
    assert [shape for shape, ptr in allocs.made if ptr in stack_ptrs]  # the stack, allocated under the mode
    assert max(int(np.prod(s)) for s in temps) <= expert < layer, sorted(temps, key=np.prod)[-3:]
    with _Allocations() as allocs:
        p = moe.moe_init(torch.Generator().manual_seed(1), mcfg, dtype=dtype)
    sizes = sorted((int(np.prod(s)) for s, _ in allocs.made), reverse=True)
    assert sizes[:3] == [layer] * 3 and sizes[3] <= expert
    assert all(p["experts"][k].dtype == dtype for k in ("w1", "w3", "w2"))

