"""The port's diffusion family (``repro_torch.models.unet``, ``dit``, the
layers they need, ``parallel.variants``, their configs and the ``gen`` step
builder -- a DDIM sampler over the backbone) against the JAX package, on the
CPU.

The same parameters and the same seeded numpy inputs go through the JAX
function and its twin.  The parameters fill the tree of JAX's init (its
shapes from ``jax.eval_shape``) with seeded numpy values of each leaf's
role -- weights N(0, 1 / fan-in), biases 0.1 N(0, 1), norm scales
1 + 0.1 N(0, 1), embeddings 0.02 N(0, 1) -- so every bias and scale is
exercised and DiT's adaLN-zero weights (``ada`` / ``final_ada``, zero at
JAX's init) make no block the identity; the port takes them through
``params_from_jax``.  (Running JAX's init itself takes ~12 s a U-Net
config on the CPU; its tree is held against the port's in
``test_init_layout_matches_jax``.)  On the CPU the port's convs run K1's plain version
and its attention K3's (at the SMOKE U-Net's D = 8, which K3 has no pair
for, ``unet._mha`` calls the plain version directly).  Tolerances: per
function ``tests/test_kernels.py: _tol`` (2e-5 x (1 + |y|) in float32,
2e-2 x (1 + |y|) in bfloat16); whole forwards and sampled latents within
1e-4 of the largest |value| in float32 and, bfloat16 against JAX's
bfloat16, within 2e-2 of it (a sampler's first step divides by
sqrt(alpha(999)) ~ 1.6e-3, so latents are held relative to their largest
|value|).  Tables, ints, configs and bundles are held with ``==``.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import list_archs as jlist_archs
from repro.configs import steps as jsteps
from repro.configs.base import diffusion_cells as jdiffusion_cells
from repro.models import dit as jdit
from repro.models import layers as jlayers
from repro.models import unet as junet
from repro.parallel import variants as jvariants
from repro_torch.configs import diffusion_cells, get, list_archs
from repro_torch.configs import steps
from repro_torch.configs.steps import build
from repro_torch.models import dit, layers, unet
from repro_torch.models.common import params_from_jax
from repro_torch.parallel import variants

DIFFUSION = ("unet-sd15", "dit-xl2")
DEPTH_RTOL, BF16_RTOL = 1e-4, 2e-2
JMOD = {unet: junet, dit: jdit}
# one full-width, shallow case per model, in the JAX package's configs: the
# U-Net's first two levels at SD-1.5's widths (heads of D = 40 and 80; 77
# context tokens of 768) and one DiT-XL/2 block (D = 72, 16 tokens)
WIDE = {
    "unet-sd15": junet.UNetConfig(name="unet-wide", img_res=64, ch=320, ch_mult=(1, 2), n_res_blocks=1,
                                  attn_down=(1, 2), ctx_dim=768, ctx_len=77, n_heads=8, groups=32),
    "dit-xl2": jdit.DiTConfig(name="dit-wide", img_res=64, d_model=1152, n_heads=16, n_layers=1),
}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype="float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **_tol(dtype))


def _held(got, want, rtol):
    """|got - want| within ``rtol`` of the largest |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert np.isfinite(got).all() and err <= rtol * scale, (err, scale)


@functools.cache
def _values(init, *args, seed=0):
    """The tree of JAX's ``init(key, *args)`` (shapes from ``jax.eval_shape``;
    no value of JAX's drawn) filled with seeded float32 numpy values of each
    leaf's role: weights (``w``) N(0, 1 / fan-in) -- a stacked layer's
    leading axis not counted --, biases 0.1 N(0, 1), scales
    1 + 0.1 N(0, 1), other leaves (position and label embeddings)
    0.02 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        keys = [str(getattr(k, "key", "")) for k in path]
        z = rng.standard_normal(a.shape, dtype=np.float32)
        if keys[-1] == "w":
            return z / np.float32(math.sqrt(math.prod(a.shape[1:-1] if "blocks" in keys else a.shape[:-1])))
        if keys[-1] == "b":
            return np.float32(0.1) * z
        if keys[-1] == "scale":
            return 1 + np.float32(0.1) * z
        return np.float32(0.02) * z

    shapes = jax.eval_shape(lambda k: init(k, *args), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _params(init, *args, seed=0, dtype="float32"):
    """:func:`_values` as JAX arrays of ``dtype`` (rounded by numpy: no XLA
    computation per leaf)."""
    return jax.tree_util.tree_map(lambda v: jnp.asarray(v.astype(jnp.dtype(dtype))), _values(init, *args, seed=seed))


def _port_cfg(module, jcfg):
    cls = {unet: unet.UNetConfig, dit: dit.DiTConfig}[module]
    return cls(**dataclasses.asdict(jcfg))


def _inputs(name, jcfg, b=2, seed=1):
    """Latents [b, r/8, r/8, 4], timesteps [b] and the conditioning: int32
    labels (DiT) or a text context [b, ctx_len, ctx_dim] (U-Net)."""
    rng = np.random.default_rng(seed)
    lr = jcfg.img_res // 8
    lat = rng.standard_normal((b, lr, lr, jcfg.latent_ch), dtype=np.float32)
    t = np.array([999, 417][:b], np.int32)
    if name == "dit-xl2":
        cond = rng.integers(0, jcfg.num_classes, b).astype(np.int32)
    else:
        cond = rng.standard_normal((b, jcfg.ctx_len, jcfg.ctx_dim), dtype=np.float32)
    return lat, t, cond


def _tensor(a, dtype):
    t = torch.from_numpy(a)
    return t if a.dtype == np.int32 else t.to(getattr(torch, dtype))


def _jarray(a, dtype):
    return jnp.asarray(a) if a.dtype == np.int32 else jnp.asarray(a).astype(jnp.dtype(dtype))


# -- layers ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups", [((2, 5, 3, 64), 32), ((2, 4, 4, 12), 8), ((1, 6, 2, 320), 32)],
                         ids=["64-of-32", "12-of-8", "320-of-32"])
def test_groupnorm_matches_jax(shape, groups, dtype):
    """JAX's ``groupnorm``; at 12 channels ``groups=8`` does not divide them
    and is lowered to 6."""
    rng = np.random.default_rng(shape[-1])
    x = 2 * rng.standard_normal(shape, dtype=np.float32) + 0.3
    c = shape[-1]
    p = {"scale": 1 + 0.1 * rng.standard_normal(c, dtype=np.float32), "b": 0.1 * rng.standard_normal(c, dtype=np.float32)}
    tp = {k: _tensor(v, dtype) for k, v in p.items()}
    jp = {k: _jarray(v, dtype) for k, v in p.items()}
    got = layers.groupnorm(_tensor(x, dtype), tp, groups)
    assert got.dtype == getattr(torch, dtype)
    _close(got, jlayers.groupnorm(_jarray(x, dtype), jp, groups), dtype)
    _close(layers.groupnorm(_tensor(x, dtype), {"scale": tp["scale"]}, groups),
           jlayers.groupnorm(_jarray(x, dtype), {"scale": jp["scale"]}, groups), dtype)


@pytest.mark.parametrize("dim", [320, 256])
def test_timestep_embedding_matches_jax(dim):
    """Within ``_tol`` plus the float32 rounding of the angle t f: XLA's
    ``exp`` and PyTorch's part by one float32 step at some frequencies (not
    correctly rounded either of them), and at t = 999 one step of f moves
    cos / sin(t f) by up to |t f| 2^-24 ~ 6e-5 -- past 2e-5 for the lowest
    frequencies, with no error in either port (ROADMAP.md §3).  The
    frequencies themselves are held to one float32 step."""
    t = np.array([0, 1, 500, 999], np.int32)
    got = dit.timestep_embedding(torch.from_numpy(t), dim)
    want = np.asarray(jdit.timestep_embedding(jnp.asarray(t), dim))
    assert got.dtype == torch.float32 and got.shape == (4, dim)
    half = dim // 2
    freqs = np.asarray(jnp.exp(-math.log(10_000.0) * jnp.arange(half, dtype=jnp.float32) / half))
    port_freqs = dit.timestep_embedding(torch.ones(1, dtype=torch.int32), dim)  # cos(f), sin(f) at t = 1
    np.testing.assert_allclose(port_freqs.numpy()[0], want[1], rtol=2e-5, atol=2e-5)
    angle_step = np.abs(t.astype(np.float32)[:, None] * freqs[None]) * 2.0 ** -23  # one step of f and of t f
    slack = np.concatenate([angle_step, angle_step], axis=-1)
    assert (np.abs(got.numpy() - want) <= 2e-5 * (1 + np.abs(want)) + slack).all()
    assert unet.timestep_embedding is dit.timestep_embedding  # the U-Net's, as JAX's unet.py imports it


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nearest_upsample_equals_jax(dtype):
    x = np.random.default_rng(3).standard_normal((2, 3, 5, 7), dtype=np.float32)
    got = unet._upsample2(_tensor(x, dtype))
    want = jax.image.resize(_jarray(x, dtype), (2, 6, 10, 7), "nearest")
    assert got.dtype == getattr(torch, dtype) and got.is_contiguous()
    assert np.array_equal(_np(got), _np(want))


# -- the U-Net's blocks and DiT's block -------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,c_out", [(16, 32), (32, 32)], ids=["skip-conv", "identity-skip"])
def test_res_block_matches_jax(c_in, c_out, dtype):
    jp = _params(junet._res_init, c_in, c_out, 64, jnp.float32, seed=c_in, dtype=dtype)
    assert ("skip" in jp) == (c_in != c_out)
    rng = np.random.default_rng(c_in)
    x, temb = rng.standard_normal((2, 6, 5, c_in), dtype=np.float32), rng.standard_normal((2, 64), dtype=np.float32)
    got = unet._res_apply(params_from_jax(jp), _tensor(x, dtype), _tensor(temb, dtype), 8)
    assert got.dtype == getattr(torch, dtype)
    _close(got, jax.jit(junet._res_apply, static_argnums=3)(jp, _jarray(x, dtype), _jarray(temb, dtype), 8), dtype)


def _jax_mha_in_float32(q, k, v, heads, f32=True):
    """K3's (and its plain version's) math in JAX: float32 logits, softmax
    and PV from the operands, one rounding to q's type."""
    b, n, c = q.shape
    qh, kh, vh = (x.reshape(x.shape[0], x.shape[1], heads, c // heads).astype(jnp.float32) for x in (q, k, v))
    logits = jnp.einsum("bnhd,bmhd->bhnm", qh, kh) / math.sqrt(c / heads)
    out = jnp.einsum("bhnm,bmhd->bnhd", jax.nn.softmax(logits, -1), vh)
    return out.reshape(b, n, c).astype(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f32", [True, False], ids=["attn_f32", "attn_bf16"])
@pytest.mark.parametrize("c,heads,hw,ctx", [(32, 4, 4, (7, 32)), (1280, 8, 4, (77, 768))],
                         ids=["smoke-d8", "sd15-d160"])
def test_attention_block_matches_jax(c, heads, hw, ctx, f32, dtype, monkeypatch):
    """The U-Net's transformer block (self, cross, GEGLU) at the SMOKE
    config's D = 8 (the plain version, directly) and at SD-1.5's deepest
    level (c = 1280, 8 heads: D = 160 through K3's wrapper) on a 4x4 map,
    with JAX's ``attn_f32`` True and False.  JAX's einsums round the
    bfloat16 logits (a step of 2^-5 at |logit| ~ 8) and, with ``attn_f32``
    off, the softmax; K3 keeps both in float32.  So in bfloat16 the block is
    held to JAX's block with its ``_mha`` taking K3's float32 math -- element
    by element at the SMOKE width; at c = 1280 (products of K = 1280 and
    5120 rounded to bfloat16 in a chain of a dozen steps, where one step's
    rounding tie broken the other way moves an output near 0 by ~0.03) within
    ``BF16_RTOL`` of the largest |y|, as a whole forward -- and to JAX's own
    within ``BF16_RTOL`` of the largest |y|."""
    jp = _params(junet._attn_init, c, ctx[1], jnp.float32, seed=c, dtype=dtype)
    rng = np.random.default_rng(c + 1)
    x = rng.standard_normal((2, hw, hw, c), dtype=np.float32)
    cx = rng.standard_normal((2, *ctx), dtype=np.float32)
    got = unet._attn_apply(params_from_jax(jp), _tensor(x, dtype), _tensor(cx, dtype), heads, 8, f32)
    assert got.dtype == getattr(torch, dtype)

    def jax_block():
        # float32 jitted; bfloat16 op by op, each op rounded as the port's
        # layers round (XLA's fusions may skip a rounding); traced anew each
        # call, so after the patch below with JAX's _mha swapped
        fn = jax.jit(junet._attn_apply, static_argnums=(3, 4, 5)) if dtype == "float32" else junet._attn_apply
        return fn(jp, _jarray(x, dtype), _jarray(cx, dtype), heads, 8, f32)

    if dtype == "float32":
        _close(got, jax_block(), dtype)
        return
    _held(got, jax_block(), BF16_RTOL)
    monkeypatch.setattr(junet, "_mha", _jax_mha_in_float32)
    if c == 32:
        _close(got, jax_block(), dtype)
    else:
        _held(got, jax_block(), BF16_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dit_block_matches_jax(dtype):
    """One DiT block with adaLN weights drawn (at JAX's init, zero: the block
    is the identity): 4 heads of D = 16 over 36 tokens."""
    d = 64
    jp = _params(jdit._block_init, d, 4, jnp.float32, seed=5, dtype=dtype)
    assert float(jnp.abs(jp["ada"]["w"].astype(jnp.float32)).max()) > 0
    rng = np.random.default_rng(6)
    x, c = rng.standard_normal((2, 36, d), dtype=np.float32), rng.standard_normal((2, d), dtype=np.float32)
    got = dit._block_apply(params_from_jax(jp), _tensor(x, dtype), _tensor(c, dtype), 4)
    assert got.dtype == getattr(torch, dtype)
    _close(got, jax.jit(jdit._block_apply, static_argnums=3)(jp, _jarray(x, dtype), _jarray(c, dtype), 4), dtype)


# -- whole models ------------------------------------------------------------


def _forward_pair(name, which, dtype, seed=0):
    module = get(name).module
    jcfg = WIDE[name] if which == "wide" else jget(name).smoke_cfg
    jmod = JMOD[module]
    jp = _params(jmod.init, jcfg, seed=seed, dtype=dtype)
    lat, t, cond = _inputs(name, jcfg)
    want = jax.jit(lambda p, *a: jmod.apply(p, jcfg, *a))(jp, *(_jarray(a, dtype) for a in (lat, t, cond)))
    got = module.apply(params_from_jax(jp), _port_cfg(module, jcfg), *(_tensor(a, dtype) for a in (lat, t, cond)))
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["smoke", "wide"])
@pytest.mark.parametrize("name", DIFFUSION)
def test_forward_matches_jax(name, which, dtype):
    got, want = _forward_pair(name, which, dtype)
    assert got.dtype == getattr(torch, dtype)
    _held(got, want, DEPTH_RTOL if dtype == "float32" else BF16_RTOL)


@pytest.mark.parametrize("which", ["smoke", "wide"])
@pytest.mark.parametrize("name", DIFFUSION)
def test_attention_widths_of_each_case(name, which, monkeypatch):
    """The wide cases reach K3's wrapper at the diffusion pairs (U-Net: 40 and
    80, DiT: 72); the SMOKE U-Net's level 0 (D = 8) takes the plain version
    directly and its level 1 (64 channels: D = 16) K3's wrapper."""
    seen = []
    real = unet.flash_attention

    def spy(q, k, v, *, causal=True):
        seen.append((q.shape[-1], k.shape[2]))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(unet, "flash_attention", spy)
    monkeypatch.setattr(dit, "flash_attention", spy)
    module = get(name).module
    jcfg = WIDE[name] if which == "wide" else jget(name).smoke_cfg
    cfg = _port_cfg(module, jcfg)
    lat, t, cond = _inputs(name, jcfg)
    module.apply(module.init(torch.Generator().manual_seed(0), cfg), cfg,
                 *(_tensor(a, "float32") for a in (lat, t, cond)))
    want = {("unet-sd15", "smoke"): {(16, 16), (16, 7)}, ("unet-sd15", "wide"): {(40, 64), (40, 77), (80, 16), (80, 77)},
            ("dit-xl2", "smoke"): {(16, 16)}, ("dit-xl2", "wide"): {(72, 16)}}[(name, which)]
    assert set(seen) == want


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("name", DIFFUSION)
def test_init_layout_matches_jax(name, smoke):
    """The port's init gives JAX's tree: the same keys, list lengths, shapes
    and types (FULL on the meta device)."""
    module = get(name).module
    jcfg = jget(name).smoke_cfg if smoke else jget(name).cfg
    cfg = _port_cfg(module, jcfg)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jshapes = jax.eval_shape(lambda k: JMOD[module].init(k, jcfg, dtype=jdt), jax.random.PRNGKey(0))
        got = module.init(torch.Generator().manual_seed(0), cfg, tdt, device=None if smoke else "meta")
        assert jax.tree_util.tree_structure(jshapes) == jax.tree_util.tree_structure(got)
        for a, g in zip(jax.tree_util.tree_leaves(jshapes), jax.tree_util.tree_leaves(got)):
            assert tuple(g.shape) == a.shape and g.dtype == tdt


# -- configs, registry, steps ------------------------------------------------------


@pytest.mark.parametrize("name", DIFFUSION)
def test_configs_match_jax(name):
    ja, a = jget(name), get(name)
    for attr in ("name", "family", "notes"):
        assert getattr(a, attr) == getattr(ja, attr)
    for which in ("cfg", "smoke_cfg"):
        assert dataclasses.asdict(getattr(a, which)) == dataclasses.asdict(getattr(ja, which))
    assert {k: dataclasses.asdict(c) for k, c in a.cells.items()} == \
        {k: dataclasses.asdict(c) for k, c in ja.cells.items()}
    assert a.module.__name__.rsplit(".", 1)[-1] == ja.module.__name__.rsplit(".", 1)[-1]


def test_diffusion_cells_registry_and_variants_match_jax():
    assert {k: dataclasses.asdict(c) for k, c in diffusion_cells().items()} == \
        {k: dataclasses.asdict(c) for k, c in jdiffusion_cells().items()}
    assert list_archs() == jlist_archs()
    assert {k: dataclasses.asdict(v) for k, v in variants.VARIANTS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jvariants.VARIANTS.items()}


_JDT = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
        jnp.dtype(jnp.int32): torch.int32}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("cell", ["gen_fast", "gen_1024"])
@pytest.mark.parametrize("name", DIFFUSION)
def test_build_bundles_match_jax(name, cell, smoke):
    """Kind, input and parameter shapes and types against JAX's bundle."""
    ja, a = jget(name), get(name)
    jb, b = jsteps.build(ja, cell, smoke=smoke), build(a, cell, smoke=smoke)
    assert b.kind == jb.kind == "gen"

    def same(spec, s):
        assert spec == (tuple(s.shape), _JDT[jnp.dtype(s.dtype)])

    assert sorted(b.inputs) == sorted(jb.inputs) == ["cond", "latents"]
    jax.tree_util.tree_map(same, b.inputs, jb.inputs, is_leaf=lambda x: isinstance(x, tuple))
    jax.tree_util.tree_map(same, b.state, jb.state, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("n_steps", [2, 4, 50])
def test_ddim_timesteps_equal_jax(n_steps):
    want = np.asarray(jnp.linspace(999, 1, n_steps).astype(jnp.int32)).tolist()
    assert steps.ddim_timesteps(1000, n_steps) == want


def _sample_pair(name, dtype, seed=2):
    """JAX's smoke ``gen_fast`` sampler (2 steps, jitted as JAX's own test
    runs it) and the port's, on the same perturbed weights and inputs."""
    ja, a = jget(name), get(name)
    jb, b = jsteps.build(ja, "gen_fast", smoke=True, dtype=jnp.dtype(dtype)), \
        build(a, "gen_fast", smoke=True, dtype=getattr(torch, dtype))
    jp = _params(ja.module.init, ja.smoke_cfg, seed=seed, dtype=dtype)
    lat, _, cond = _inputs(name, ja.smoke_cfg, b=b.inputs["latents"][0][0], seed=seed)
    want = jax.jit(jb.fn)(jp, _jarray(lat, dtype), _jarray(cond, dtype))
    got = b.fn(params_from_jax(jp), _tensor(lat, dtype), _tensor(cond, dtype))
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DIFFUSION)
def test_smoke_sampler_matches_jax(name, dtype):
    """Two DDIM steps (t = 999, then 1): in bfloat16 each update runs in
    float32 and only its result is rounded, as JAX's does."""
    got, want = _sample_pair(name, dtype)
    assert got.dtype == getattr(torch, dtype)
    _held(got, want, DEPTH_RTOL if dtype == "float32" else BF16_RTOL)


def test_bf16_sampler_updates_in_float32(monkeypatch):
    """The bfloat16 sampler's update is computed in float32: with the
    backbone replaced by a fixed eps, its two steps equal the float32
    formula rounded once a step, which the same update in bfloat16 misses."""
    b = build(get("dit-xl2"), "gen_fast", smoke=True, dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    lat, eps = (torch.from_numpy(rng.standard_normal(b.inputs["latents"][0], dtype=np.float32)).to(torch.bfloat16)
                for _ in range(2))
    monkeypatch.setattr(steps, "_diffusion_apply", lambda *args: eps)
    got = b.fn(None, lat, torch.zeros(b.inputs["cond"][0], dtype=torch.int32))
    want, in_bf16 = lat, lat
    for t, tn in ((999, 1), (1, 0)):
        s1a, sa, san, s1an = (torch.sqrt(v) for v in (1 - steps._alpha(t, 1000), steps._alpha(t, 1000),
                                                       steps._alpha(tn, 1000), 1 - steps._alpha(tn, 1000)))
        x0 = (want.float() - s1a * eps.float()) / sa
        want = (san * x0 + s1an * eps.float()).to(torch.bfloat16)
        x0 = (in_bf16 - s1a.to(torch.bfloat16) * eps) / sa.to(torch.bfloat16)
        in_bf16 = san.to(torch.bfloat16) * x0 + s1an.to(torch.bfloat16) * eps
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert not torch.equal(got, in_bf16)


@pytest.mark.parametrize("name", DIFFUSION)
def test_spatial2d_variant_serves_the_unet_with_attn_f32_off(name, monkeypatch):
    """``set_variant("spatial2d")`` makes the U-Net's gen bundle run with
    ``attn_f32=False``, as JAX's; the bfloat16 sampler under it is held to
    JAX's (a bf16 softmax there, K3's float32 one here) at bf16's
    tolerance.  DiT has no such field and is unchanged."""
    flags = []
    real = unet._attn_apply
    monkeypatch.setattr(unet, "_attn_apply", lambda *a: flags.append(a[5]) or real(*a))
    try:
        variants.set_variant("spatial2d")
        jvariants.set_variant("spatial2d")
        got, want = _sample_pair(name, "bfloat16")
    finally:
        variants.set_variant("base")
        jvariants.set_variant("base")
    assert set(flags) == ({False} if name == "unet-sd15" else set())
    _held(got, want, BF16_RTOL)
    assert variants.get_variant().name == "base"


@pytest.mark.parametrize("cell", ["train_256", "train_1024"])
@pytest.mark.parametrize("name", DIFFUSION)
def test_diffusion_train_cells_raise(name, cell):
    """The train cells, which raised before diffusion training was ported,
    build JAX's train bundle: inputs (latents, t, cond, noise) of JAX's
    shapes and types (the step: ``tests/test_torch_diffusion_train.py``)."""
    b, jb = build(get(name), cell, smoke=True), jsteps.build(jget(name), cell, smoke=True)
    assert b.kind == jb.kind == "train" and list(b.inputs) == list(jb.inputs) == ["latents", "t", "cond", "noise"]
    jdt = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.int32): torch.int32}
    assert b.inputs == {k: (tuple(s.shape), jdt[jnp.dtype(s.dtype)]) for k, s in jb.inputs.items()}
