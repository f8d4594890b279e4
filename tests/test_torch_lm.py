"""The port's LM, dense and MoE, GQA and MLA (``repro_torch.models.attention``,
``models.moe``, ``models.transformer_lm``, ``configs``) against the JAX
package, on the CPU (MLA's own module tests: ``tests/test_torch_mla.py``).

The same parameters (JAX's init, the norm scales perturbed by seeded numpy
noise so the scale paths are covered, converted by ``params_from_jax``) and the
same seeded numpy tokens and activations go through the JAX function and its
twin.  On the CPU the port's attention runs the flash kernel's plain version,
the function JAX's ``_sdpa`` / ``_sdpa_chunked_causal`` compute.  Tolerances
as ``tests/test_kernels.py: _tol``: 2e-5 x (1 + |y|) in float32 (summation
order); the bfloat16 forward is held as ``tests/test_torch_bf16_paths.py``
holds its paths: within 2e-2 of the largest |logit| of JAX's float32 forward
and no worse than JAX's own bfloat16 error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import list_archs as jlist_archs
from repro.configs import steps as jsteps
from repro.configs.base import lm_cells as jlm_cells
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer_lm as jlm
from repro.models.moe import MoEConfig as JMoEConfig
from _torch_parity import perturb_norms, port_lm_config
from repro_torch.configs import get, list_archs, lm_cells
from repro_torch.configs.steps import build
from repro_torch.models import attention, layers, moe
from repro_torch.models import transformer_lm as lm
from repro_torch.models.common import params_from_jax, trunc_normal

TOL = 2e-5
ARCHS = ("qwen3-4b", "codeqwen1.5-7b", "moonshot-v1-16b-a3b", "deepseek-v3-671b")
# two GQA layers with qk-norm at Qwen3's head width, d_head 128
D128 = jlm.LMConfig(name="gqa-d128", n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_head=128,
                    d_ff=256, vocab=512, qk_norm=True)
# a dense GQA layer, then an MoE layer (first_k_dense = 1: both stacks run),
# with a shared expert and the router bias; above 16 tokens (the forward's
# 2 x 24) pairs past an expert's capacity drop, up to 16 (decode) none do
MOE2 = jlm.LMConfig(name="gqa-moe-2l", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                    d_ff=128, vocab=512, qk_norm=True, first_k_dense=1,
                    moe=JMoEConfig(d_model=64, n_experts=8, top_k=2, d_ff=48, n_shared=1, router_bias=True,
                                   capacity_factor=1.0, dropless_below=16))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * (1 + np.abs(want))), np.abs(got - want).max()


def _jax_params(jcfg, seed=0):
    """JAX's init, each norm scale times (1 + 0.1 N(0, 1)) and each router
    bias 0.1 N(0, 1), from numpy."""
    return perturb_norms(jlm.init(jax.random.PRNGKey(seed), jcfg), seed)


def _tokens(cfg, b, t, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t), dtype=np.int32)


def _jcfg(name):
    return {D128.name: D128, MOE2.name: MOE2}.get(name) or jget(name).smoke_cfg


# -- layers ---------------------------------------------------------------


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 3, 128), dtype=np.float32)
    pos = np.sort(rng.integers(0, 4096, (2, 16)), axis=1).astype(np.int32)
    pos[0, -1] = 4095
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = attention.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax_to_position_32767(theta, d):
    """Every position of a 32,768-token prefill (the LM cells' length):
    within ``TOL`` of JAX with no slack for the angle.  The frequencies
    agree to one float32 step (at theta 1e6, d 128 one of the 64, index
    37, is one step apart: its angle at 32,767 moves by ~1e-6 rad, and the
    largest error stays under a fifth of the limit)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 32768, 2, d), dtype=np.float32)
    pos = np.arange(32768, dtype=np.int32)[None]
    want_f, got_f = np.asarray(jattn.rope_freqs(d, theta)), attention.rope_freqs(d, theta).numpy()
    assert np.abs(want_f.view(np.int32) - got_f.view(np.int32)).max() <= 1
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = attention.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_silu_match_jax(dtype):
    """bfloat16: the same roundings in the same order, so equal bits."""
    rng = np.random.default_rng(4)
    x = 3 * rng.standard_normal((8, 256), dtype=np.float32)
    scale = rng.standard_normal(256, dtype=np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jlayers.rmsnorm(jnp.asarray(x).astype(jdt), {"scale": jnp.asarray(scale).astype(jdt)})
    got = layers.rmsnorm(torch.from_numpy(x).to(tdt), {"scale": torch.from_numpy(scale).to(tdt)})
    want_s = jax.nn.silu(jnp.asarray(x).astype(jdt))
    got_s = layers.silu(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got_s.dtype == tdt
    tol = 0 if dtype == "bfloat16" else TOL
    _close(got.float(), want.astype(jnp.float32), tol)
    _close(got_s.float(), want_s.astype(jnp.float32), tol)


def test_trunc_normal_is_truncated_at_two_std():
    x = trunc_normal(torch.Generator().manual_seed(0), (200_000,), std=0.5)
    assert x.abs().max() <= 1.0
    # the standard deviation of N(0, 1) truncated to +-2 is 0.8796
    assert abs(x.std().item() / 0.5 - 0.8796) < 0.01 and abs(x.mean().item()) < 0.01


# -- attention --------------------------------------------------------------


GQA_CASES = [  # (name, B, T, d_model, H, Hkv, d_head, qk_norm)
    ("T8", 2, 8, 64, 4, 2, 16, True),
    ("T33-ragged", 2, 33, 64, 4, 1, 32, True),
    ("T33-mha", 1, 33, 64, 4, 4, 16, False),
    ("T4096-chunked", 1, 4096, 32, 2, 1, 16, True),  # JAX's _sdpa_chunked_causal branch
]


@pytest.mark.parametrize("case", GQA_CASES, ids=lambda c: c[0])
def test_gqa_apply_matches_jax(case):
    _, b, t, d_model, h, hkv, dh, qk_norm = case
    cfg = jattn.GQAConfig(d_model=d_model, n_heads=h, n_kv_heads=hkv, d_head=dh, qk_norm=qk_norm)
    jp = jattn.gqa_init(jax.random.PRNGKey(5), cfg)
    x = np.random.default_rng(6).standard_normal((b, t, d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    want, (wk, wv) = jattn.gqa_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos), jattn.causal_mask(t))
    got, (gk, gv) = attention.gqa_apply(params_from_jax(jp), attention.GQAConfig(**dataclasses.asdict(cfg)),
                                        torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("t", [33, 2048])
def test_plain_sdpa_matches_jax(t):
    """The plain versions kept for reference: _sdpa under the causal and the
    decode masks, and _sdpa_chunked_causal (chunk 512 at T = 2048)."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, t, 4, 16), dtype=np.float32)
    k, v = (rng.standard_normal((1, t, 2, 16), dtype=np.float32) for _ in range(2))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    scale = 16 ** -0.5
    _close(attention._sdpa(tq, tk, tv, attention.causal_mask(t), scale),
           jattn._sdpa(jq, jk, jv, jattn.causal_mask(t), scale))
    _close(attention._sdpa(tq[:, :1], tk, tv, attention.decode_mask(t, t // 2), scale),
           jattn._sdpa(jq[:, :1], jk, jv, jattn.decode_mask(t, t // 2), scale))
    if t % 512 == 0:
        _close(attention._sdpa_chunked_causal(tq, tk, tv, scale, chunk=512),
               jattn._sdpa_chunked_causal(jq, jk, jv, scale, chunk=512))
        _close(attention._sdpa_chunked_causal(tq, tk, tv, scale, chunk=512),
               attention._sdpa(tq, tk, tv, attention.causal_mask(t), scale))


# -- the LM -------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS + (D128.name, MOE2.name))
def test_forward_matches_jax(name):
    """Logits and the load-balance loss: zero for dense layers, the MoE
    layers' sum otherwise."""
    jcfg = _jcfg(name)
    jp = _jax_params(jcfg)
    toks = _tokens(jcfg, 2, 24)
    want, want_lb = jlm.forward(jp, jcfg, jnp.asarray(toks))
    got, lb = lm.forward(params_from_jax(jp), port_lm_config(jcfg), torch.from_numpy(toks))
    _close(got, want)
    if jcfg.moe is None:
        assert float(lb) == float(want_lb) == 0.0
    else:
        _close(lb, want_lb)
        assert float(lb) > 0


@pytest.mark.parametrize("name", ARCHS + (MOE2.name,))
def test_init_and_cache_layouts_match_jax(name):
    """The port's init and init_cache give JAX's trees: the same keys, shapes
    and types, the layers stacked on a leading axis."""
    jcfg = _jcfg(name)
    cfg = port_lm_config(jcfg)
    jshapes = jax.eval_shape(lambda k: jlm.init(k, jcfg), jax.random.PRNGKey(0))
    got = lm.init(torch.Generator().manual_seed(0), cfg)
    assert jax.tree_util.tree_structure(jshapes) == jax.tree_util.tree_structure(got)
    for a, g in zip(jax.tree_util.tree_leaves(jshapes), jax.tree_util.tree_leaves(got)):
        assert tuple(g.shape) == a.shape and g.dtype == torch.float32
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jc = jlm.init_cache(jcfg, 3, 16, dtype=jdt)
        c = lm.init_cache(cfg, 3, 16, dtype=tdt, device="cpu")
        assert jax.tree_util.tree_structure(jc) == jax.tree_util.tree_structure(c)
        for a, g in zip(jax.tree_util.tree_leaves(jc), jax.tree_util.tree_leaves(c)):
            assert tuple(g.shape) == a.shape and g.dtype == tdt and not g.any()


@pytest.mark.parametrize("name", ARCHS + (D128.name, MOE2.name))
def test_decode_step_matches_jax(name):
    """8 decode steps: each step's logits and, after the last, the whole
    cache against JAX's; then the port's decode against the port's forward
    (the equivalence tests/test_archs.py holds for JAX)."""
    jcfg = _jcfg(name)
    cfg = port_lm_config(jcfg)
    jp = _jax_params(jcfg, seed=2)
    p = params_from_jax(jp)
    toks = _tokens(jcfg, 2, 8, seed=3)
    jcache, cache = jlm.init_cache(jcfg, 2, 12), lm.init_cache(cfg, 2, 12, device="cpu")
    full, _ = lm.forward(p, cfg, torch.from_numpy(toks))
    for i in range(8):
        want, jcache = jlm.decode_step(jp, jcfg, jcache, jnp.asarray(toks[:, i:i + 1]), i)
        got, cache = lm.decode_step(p, cfg, cache, torch.from_numpy(toks[:, i:i + 1]), i)
        _close(got, want)
        _close(got, full[:, i])
    assert sorted(cache) == sorted(jcache)
    for stack in cache:
        if cfg.attn == "mla":  # the latent [L, B, S, kv_lora + rope]
            _close(cache[stack], jcache[stack])
            continue
        for key in ("k", "v"):
            _close(cache[stack][key], jcache[stack][key])


@pytest.mark.parametrize("name", ("qwen3-4b", D128.name))
def test_bfloat16_forward_matches_jax(name):
    jcfg = _jcfg(name)
    jp = _jax_params(jcfg)
    toks = _tokens(jcfg, 2, 24)
    want = np.asarray(jlm.forward(jp, jcfg, jnp.asarray(toks))[0])
    jbf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    jax_bf16 = np.asarray(jlm.forward(jbf, jcfg, jnp.asarray(toks))[0].astype(jnp.float32))
    got, _ = lm.forward(params_from_jax(jbf), port_lm_config(jcfg), torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), (err, np.abs(want).max())
    assert err <= np.abs(jax_bf16 - want).max(), (err, np.abs(jax_bf16 - want).max())


def _recording_routes(monkeypatch):
    """Record each MoE layer's kept routes (the port's ``_dispatch``
    wrapped): a list of ids [B*T, k], dropped pairs as -1."""
    routes = []
    dispatch = moe._dispatch

    def recording_dispatch(ids, e, capacity):
        out = dispatch(ids, e, capacity)
        routes.append(torch.where(out[2], ids, -1).numpy())
        return out

    monkeypatch.setattr(moe, "_dispatch", recording_dispatch)
    return routes


def _held(ref_routes, routes, b, t):
    """[B, T] positions whose logits no routing difference reaches: a layer's
    kept experts (as sets) differ at a position, which taints its own output
    and, through the next layers' causal attention, every later position."""
    out = np.zeros((b, t), bool)  # the layer's output differs
    for ref, got in zip(ref_routes, routes):
        differs = (np.sort(ref, 1) != np.sort(got, 1)).any(1).reshape(b, t)
        out = np.maximum.accumulate(out, axis=1) | differs
    return ~out


@pytest.mark.parametrize("name", ("moonshot-v1-16b-a3b", MOE2.name, "deepseek-v3-671b"))
def test_moe_bfloat16_forward_matches_jax(name, monkeypatch):
    """A bfloat16 MoE forward routes as the float32 one except at near-ties,
    which bfloat16's rounding may flip either way (JAX's own bfloat16 forward
    flips others): one flip changes a token's FFN output by a share of it,
    and attention carries that to later tokens.  So the logits are held at
    the positions whose routes (every layer, the causal past) match the
    float32 forward's -- at least three quarters of them -- against JAX's
    float32 forward: the mean |diff| no worse than 1.25x JAX's bfloat16
    forward's at the same positions, the largest within 2e-2 of the largest
    |logit| or 1.25x JAX's largest.  The factor: the port rounds in other
    places than JAX's compiled scan (the attention keeps float32 scores), so
    the two errors are alike, not equal (measured over three seeds: either
    one the larger by up to 6 %)."""
    jcfg = _jcfg(name)
    jp = _jax_params(jcfg)
    b, t = 2, 24
    toks = _tokens(jcfg, b, t)
    want = np.asarray(jlm.forward(jp, jcfg, jnp.asarray(toks))[0])
    jbf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    jax_err = np.abs(np.asarray(jlm.forward(jbf, jcfg, jnp.asarray(toks))[0].astype(jnp.float32)) - want)
    routes = _recording_routes(monkeypatch)
    got32, _ = lm.forward(params_from_jax(jp), port_lm_config(jcfg), torch.from_numpy(toks))
    ref_routes, routes[:] = routes[:], []
    got, _ = lm.forward(params_from_jax(jbf), port_lm_config(jcfg), torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16 and len(routes) == len(ref_routes) == port_lm_config(jcfg).n_moe_layers
    _close(got32, want)
    held = _held(ref_routes, routes, b, t)
    assert held.mean() >= 0.75, held
    err, jax_err = np.abs(got.float().numpy() - want)[held], jax_err[held]
    assert err.mean() <= 1.25 * jax_err.mean(), (err.mean(), jax_err.mean())
    assert err.max() <= max(2e-2 * np.abs(want).max(), 1.25 * jax_err.max()), (err.max(), jax_err.max())


# -- configs and steps ----------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_jax(name):
    ja, a = jget(name), get(name)
    for attr in ("name", "family", "notes"):
        assert getattr(a, attr) == getattr(ja, attr)
    for which in ("cfg", "smoke_cfg"):
        assert dataclasses.asdict(getattr(a, which)) == dataclasses.asdict(getattr(ja, which))
        assert dataclasses.asdict(getattr(a, which).gqa) == dataclasses.asdict(getattr(ja, which).gqa)
    assert {k: dataclasses.asdict(c) for k, c in a.cells.items()} == \
        {k: dataclasses.asdict(c) for k, c in ja.cells.items()}
    for full in (True, False):
        assert {k: dataclasses.asdict(c) for k, c in lm_cells(full_attention=full).items()} == \
            {k: dataclasses.asdict(c) for k, c in jlm_cells(full_attention=full).items()}
    assert a.module is lm


def test_registry_holds_the_ported_archs_only():
    """The LMs and, since the diffusion pair was ported, every JAX arch; a
    diffusion train bundle builds, as JAX's (its step:
    ``tests/test_torch_diffusion_train.py``)."""
    assert set(ARCHS) <= set(list_archs())
    assert list_archs() == jlist_archs()
    b = build(get("unet-sd15"), "train_256", smoke=True)
    assert b.kind == jsteps.build(jget("unet-sd15"), "train_256", smoke=True).kind == "train"


def _check_bundles(name, cell, smoke):
    """The bundle's kind, its inputs' shapes and types and its parameters'
    shapes against JAX's; the smoke step runs and agrees with JAX's."""
    ja, a = jget(name), get(name)
    jb, b = jsteps.build(ja, cell, smoke=smoke), build(a, cell, smoke=smoke)
    assert b.kind == jb.kind
    jdt = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.int32): torch.int32}

    def same(spec, s):
        assert spec == (tuple(s.shape), jdt[jnp.dtype(s.dtype)])

    jax.tree_util.tree_map(same, b.inputs, jb.inputs, is_leaf=lambda x: isinstance(x, tuple))
    jax.tree_util.tree_map(same, b.state, jb.state, is_leaf=lambda x: isinstance(x, tuple))
    if not smoke:
        return
    jp = _jax_params(ja.smoke_cfg)
    p = params_from_jax(jp)
    (bsz, t), _ = b.inputs["tokens"]
    toks = _tokens(ja.smoke_cfg, bsz, t if cell == "prefill_32k" else 1)
    if cell == "prefill_32k":
        _close(b.fn(p, torch.from_numpy(toks)), jb.fn(jp, jnp.asarray(toks)))
    else:
        # the cache's length from the spec of its first stack: {k, v} (GQA)
        # or the latent (MLA)
        spec, jspec = next(iter(b.inputs["cache"].values())), next(iter(jb.inputs["cache"].values()))
        s_max = (spec["k"] if isinstance(spec, dict) else spec)[0][2]
        cache = lm.init_cache(a.smoke_cfg, bsz, s_max, device="cpu")
        jcache = jlm.init_cache(ja.smoke_cfg, bsz, (jspec["k"] if isinstance(jspec, dict) else jspec).shape[2])
        got, _ = b.fn(p, cache, torch.from_numpy(toks), 0)
        want, _ = jb.fn(jp, jcache, jnp.asarray(toks), 0)
        _close(got, want)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("cell", ["prefill_32k", "decode_32k"])
def test_build_bundles_match_jax(cell, smoke):
    _check_bundles("qwen3-4b", cell, smoke)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("cell", ["prefill_32k", "decode_32k"])
def test_moe_build_bundles_match_jax(cell, smoke):
    """moonshot-v1-16b-a3b's bundles: its 48 MoE layers' stacked experts
    ([48, 64, 2048, 1408]) as shapes on the meta device, and its "moe" cache."""
    _check_bundles("moonshot-v1-16b-a3b", cell, smoke)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("cell", ["prefill_32k", "decode_32k"])
def test_mla_build_bundles_match_jax(cell, smoke):
    """deepseek-v3-671b's bundles: its 3 dense and 58 MoE layers' MLA and
    expert weights and the MTP head as shapes on the meta device, and its
    latent cache spec ([L, 128, 32768, 576] per stack, a tensor, not
    {k, v})."""
    _check_bundles("deepseek-v3-671b", cell, smoke)


@pytest.mark.parametrize("cell", ["prefill_32k", "decode_32k"])
def test_codeqwen_full_bundles_match_jax(cell):
    """CodeQwen1.5-7B (MHA: 32 KV heads) at its full config: the bundle's
    parameters and inputs on the ``meta`` device against JAX's, and
    ``init_cache`` at the cell's size and at the batches a card holds
    against JAX's under ``eval_shape``."""
    _check_bundles("codeqwen1.5-7b", cell, smoke=False)
    ja, a = jget("codeqwen1.5-7b"), get("codeqwen1.5-7b")
    cfg, jcfg = a.cfg, ja.cfg
    assert (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_head) == (32, 32, 32, 128)
    meta = a.cells[cell].meta
    assert meta["seq_len"] == 32768 == ja.cells[cell].meta["seq_len"]
    for batch in (meta["global_batch"], 1, 2):
        for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            got = lm.init_cache(cfg, batch, meta["seq_len"], dt, device="meta")
            want = jax.eval_shape(lambda: jlm.init_cache(jcfg, batch, meta["seq_len"], jdt))
            assert sorted(got) == sorted(want) == ["dense"]
            for k in ("k", "v"):
                assert tuple(got["dense"][k].shape) == want["dense"][k].shape == (32, batch, 32768, 32, 128)
                assert got["dense"][k].dtype == dt and want["dense"][k].dtype == jdt


@pytest.mark.parametrize("jname", ["moonshot-v1-16b-a3b", "deepseek-v3-671b"])
def test_moe_mla_and_mtp_raise(jname):
    """MoE layers on GQA (moonshot) and on MLA with the MTP head (DeepSeek-V3)
    run -- init, init_cache and a forward -- where the MLA and MTP configs
    raised before they were ported; the MTP head is built (``mtp``) and
    ignored by the forward, as JAX's."""
    cfg = port_lm_config(jget(jname).smoke_cfg)
    stacks = {"moonshot-v1-16b-a3b": ["moe"], "deepseek-v3-671b": ["dense", "moe"]}[jname]
    extra = ["mtp"] if cfg.mtp_depth else []
    assert sorted(lm.init(torch.Generator(), cfg, device="meta")) == sorted(
        ["embed", "final_norm", "lm_head"] + [f"{s}_layers" for s in stacks] + extra)
    assert sorted(lm.init_cache(cfg, 1, 4, device="cpu")) == stacks
    params = lm.init(torch.Generator().manual_seed(0), cfg)
    logits, lb = lm.forward(params, cfg, torch.zeros((1, 4), dtype=torch.int32))
    assert tuple(logits.shape) == (1, 4, cfg.vocab) and float(lb) > 0


def test_train_step_raises():
    """The train_4k cell builds a train bundle of JAX's inputs (its step:
    ``tests/test_torch_lm_train.py``); the skipped long_500k cell still
    raises."""
    b = build(get("qwen3-4b"), "train_4k", smoke=True)
    assert b.kind == "train" and b.inputs == {"tokens": ((2, 64), torch.int32), "labels": ((2, 64), torch.int32)}
    with pytest.raises(ValueError, match="skipped"):
        build(get("qwen3-4b"), "long_500k")
