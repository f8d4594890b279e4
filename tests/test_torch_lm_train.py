"""LM training in the port (``repro_torch.models.transformer_lm.loss_fn``,
``configs.steps._lm_train``, the layer stacks under remat) against the JAX
package, on the CPU (the step against JAX's and a JAX trainer's state
continued: ``tests/test_torch_lm_train_step.py``; the attention and MoE
modules' gradients against ``jax.vjp``: ``tests/test_torch_lm_grads.py``).

Parameters are JAX's init with the norm scales and router biases perturbed
(``perturb_norms``), rounded to values bfloat16 holds, so the float32 and
the bfloat16 cases start from the same numbers; tokens are seeded numpy.  On
the CPU the attention runs K3's autograd ``Function`` (the plain forward,
``attention_backward``).

float32: every metric (``ce``, ``load_balance``, ``mtp``, ``total``) within
``DEPTH_RTOL`` = 1e-4 of JAX's, every gradient within 1e-4 of the tree's
largest |g|.  bfloat16: the metrics within 2e-2, and leaf by leaf the
gradient's distance from JAX's float32 one (2-norm) within 2e-2 of that
leaf's norm, or within ``BF16_JAX_FACTOR`` x JAX's own bfloat16 gradient's
distance there (as ``tests/test_torch_train_loss.py`` holds the vision
models).  A bfloat16 MoE forward may flip a near-tie route either way
(``tests/test_torch_lm.py``), and a
flipped route moves a token's whole FFN output: the bfloat16 MoE gradients
are taken where the routes match, with every MoE layer's experts pinned to
the float32 forward's (the gates from the bfloat16 router at those
experts), after the natural bfloat16 forward is held to route as the
float32 one at three quarters of the positions or more.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import steps as jsteps
from repro.models import transformer_lm as jlm
from _torch_parity import perturb_norms, port_lm_config
from repro_torch.configs import get
from repro_torch.configs.steps import build
from repro_torch.models import moe
from repro_torch.models import transformer_lm as lm
from repro_torch.models.common import params_from_jax, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
DEPTH_RTOL, BF16_RTOL, BF16_JAX_FACTOR = 1e-4, 2e-2, 3
LMS = ("qwen3-4b", "moonshot-v1-16b-a3b", "deepseek-v3-671b")
B, T = 2, 16

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
def _inputs(name: str, seed: int = 0):
    """(JAX parameters, tokens, labels), every parameter a bfloat16 value."""
    jcfg = jget(name).smoke_cfg
    jp = perturb_norms(jlm.init(jax.random.PRNGKey(seed), jcfg), seed)
    jp = jax.tree_util.tree_map(lambda t: t.astype(jnp.bfloat16).astype(jnp.float32), jp)
    toks = np.random.default_rng(seed + 1).integers(0, jcfg.vocab, (B, T + 1), dtype=np.int32)
    return jp, toks[:, :-1], toks[:, 1:]


@functools.cache
def _jax_value_and_grad(name: str, dtype: str) -> tuple[dict, list]:
    """JAX's jitted (metrics, gradient leaves as float32 numpy) in ``dtype``."""
    jcfg = jget(name).smoke_cfg
    jp, x, y = _inputs(name)
    fn = jax.jit(jax.value_and_grad(lambda p, x, y: jlm.loss_fn(p, jcfg, x, y), has_aux=True))
    (_, metrics), grads = fn(jax.tree_util.tree_map(lambda t: t.astype(jnp.dtype(dtype)), jp), jnp.asarray(x),
                             jnp.asarray(y))
    return {k: float(v) for k, v in metrics.items()}, [_np(g) for g in jax.tree_util.tree_leaves(grads)]


def _port_value_and_grad(name: str, dtype, cfg=None) -> tuple[dict, list]:
    """The port's (metrics, gradient leaves as float32 numpy, zeros where
    unused), checking each gradient's type and shape."""
    jp, x, y = _inputs(name)
    cfg = cfg or port_lm_config(jget(name).smoke_cfg)
    leaves = tree_leaves(params := params_from_jax(jp, dtype=dtype))
    for t in leaves:
        t.requires_grad_()
    loss, metrics = lm.loss_fn(params, cfg, torch.from_numpy(x), torch.from_numpy(y))
    assert loss is metrics["total"] and loss.dtype == torch.float32
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(g is None or (g.dtype == dtype and g.shape == t.shape) for g, t in zip(grads, leaves))
    return ({k: v.item() for k, v in metrics.items()},
            [np.zeros(t.shape, np.float32) if g is None else _np(g) for g, t in zip(grads, leaves)])


def _norms(a: list, b: list | None = None) -> np.ndarray:
    return np.array([np.linalg.norm(x if b is None else x - y) for x, y in zip(a, b or a)])


def _recording_routes(monkeypatch):
    """Each MoE layer's routes, in call order, as the router gives them:
    ids [T, k] (``moe.router_topk`` wrapped)."""
    routes = []
    real = moe.router_topk

    def recording(p, cfg, x):
        out = real(p, cfg, x)
        routes.append(out[1])
        return out

    monkeypatch.setattr(moe, "router_topk", recording)
    return routes


def _pinned_routes(monkeypatch, ids: list):
    """``moe.router_topk`` with each call's experts taken from ``ids`` (in
    call order) and their gates from this call's router probabilities,
    renormalised as the router does."""
    real, it = moe.router_topk, iter(ids)

    def pinned(p, cfg, x):
        _, _, probs = real(p, cfg, x)
        chosen = next(it)
        gates = probs.gather(1, chosen)
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        return gates.to(x.dtype), chosen, probs

    monkeypatch.setattr(moe, "router_topk", pinned)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LMS)
def test_loss_fn_value_and_grad_match_jax(name, dtype, monkeypatch):
    want_m, want = _jax_value_and_grad(name, "float32")
    cfg = port_lm_config(jget(name).smoke_cfg)
    assert set(want_m) == {"ce", "load_balance", "total"} | ({"mtp"} if cfg.mtp_depth else set())
    if dtype == "float32":
        got_m, got = _port_value_and_grad(name, torch.float32)
        assert got_m.keys() == want_m.keys()
        for k in want_m:
            assert abs(got_m[k] - want_m[k]) <= DEPTH_RTOL * max(abs(want_m[k]), 1e-6), (k, got_m[k], want_m[k])
        gmax = max(np.abs(g).max() for g in want)
        err = max(np.abs(g - w).max() for g, w in zip(got, want))
        assert err <= DEPTH_RTOL * gmax, (err, gmax)
        return
    if cfg.moe is not None:
        # the natural bfloat16 forward routes as the float32 one at >= 3/4 of the positions ...
        routes = _recording_routes(monkeypatch)
        jp, x, y = _inputs(name)
        with torch.no_grad():
            for dt in (torch.float32, torch.bfloat16):
                lm.loss_fn(params_from_jax(jp, dtype=dt), cfg, torch.from_numpy(x), torch.from_numpy(y))
        half = len(routes) // 2
        f32_ids, bf_ids = routes[:half], routes[half:]
        same = np.mean([np.array_equal(np.sort(a.numpy(), 1)[i], np.sort(b.numpy(), 1)[i])
                        for a, b in zip(f32_ids, bf_ids) for i in range(a.shape[0])])
        assert half == cfg.n_moe_layers + bool(cfg.mtp_depth) and same >= 0.75, same
        # ... and its gradients are held with the float32 forward's routes
        # (the stacks not under remat: a recompute would take a second route)
        monkeypatch.undo()
        _pinned_routes(monkeypatch, f32_ids)
        cfg = dataclasses.replace(cfg, remat=False)
    got_m, got = _port_value_and_grad(name, torch.bfloat16, cfg)
    for k in want_m:
        assert abs(got_m[k] - want_m[k]) <= BF16_RTOL * max(abs(want_m[k]), 1.0), (k, got_m[k], want_m[k])
    gap, scale = _norms(got, want), _norms(want)
    if (gap <= BF16_RTOL * scale).all():
        return
    limit = np.maximum(BF16_RTOL * scale, BF16_JAX_FACTOR * _norms(_jax_value_and_grad(name, "bfloat16")[1], want))
    worst = int(np.argmax(gap - limit))
    assert (gap <= limit).all(), (worst, gap[worst], limit[worst], scale[worst])


@pytest.mark.parametrize("name", LMS)
def test_remat_equals_no_remat(name, monkeypatch):
    """The stacks under activation checkpointing give the same loss and
    gradients, bit for bit, and run each trunk block twice (the forward,
    then its recompute in the backward); without grad, once."""
    cfg = port_lm_config(jget(name).smoke_cfg)
    assert cfg.remat
    calls = []
    real = lm._block_apply
    monkeypatch.setattr(lm, "_block_apply", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = {}
    for remat in (True, False):
        calls.clear()
        out[remat] = _port_value_and_grad(name, torch.float32, dataclasses.replace(cfg, remat=remat))
        trunk = cfg.n_layers * (2 if remat else 1)
        assert len(calls) == trunk + bool(cfg.mtp_depth), (remat, len(calls))
    assert out[True][0] == out[False][0]
    assert all(np.array_equal(a, b) for a, b in zip(out[True][1], out[False][1]))
    calls.clear()
    jp, x, y = _inputs(name)
    with torch.no_grad():
        lm.loss_fn(params_from_jax(jp), cfg, torch.from_numpy(x), torch.from_numpy(y))
    assert len(calls) == cfg.n_layers + bool(cfg.mtp_depth)


_JDT = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
        jnp.dtype(jnp.int32): torch.int32}


@pytest.mark.parametrize("name", LMS + ("codeqwen1.5-7b",))
def test_full_train_bundles_match_jax(name):
    """The FULL train_4k bundle (the parameters and the AdamW state built on
    the ``meta`` device) against JAX's ``abstract_state``, shape and type
    leaf by leaf -- DeepSeek-V3's moments in bfloat16 -- and its inputs'."""
    ja, a = jget(name), get(name)
    jb, b = jsteps.build(ja, "train_4k"), build(a, "train_4k")
    assert b.kind == jb.kind == "train"

    def same(spec, s):
        assert spec == (tuple(s.shape), _JDT[jnp.dtype(s.dtype)])

    jax.tree_util.tree_map(same, b.inputs, jb.inputs, is_leaf=lambda x: isinstance(x, tuple))
    assert list(b.inputs) == list(jb.inputs) == ["tokens", "labels"]
    params, opt, n = b.state
    jparams, jopt, jn = jb.state
    jax.tree_util.tree_map(same, params, jparams, is_leaf=lambda x: isinstance(x, tuple))
    for key in ("mu", "nu"):
        jax.tree_util.tree_map(same, opt[key], jopt[key], is_leaf=lambda x: isinstance(x, tuple))
    same(opt["count"], jopt["count"])
    same(n, jn)
    moments = {spec[1] for spec in jax.tree_util.tree_leaves(opt["mu"], is_leaf=lambda x: isinstance(x, tuple))}
    assert moments == ({torch.bfloat16})


def test_launcher_trains_an_lm_in_a_port_only_process(tmp_path):
    """``python -m repro_torch.launch.train --arch qwen3-4b --device cpu`` in
    a fresh interpreter: it trains train_4k's smoke cell, checkpoints, and
    loads no ``jax``, ``repro`` or ``msgpack``."""
    code = f"""
import json, sys
from repro_torch.launch.train import main
main(["--arch", "qwen3-4b", "--steps", "2", "--device", "cpu", "--no-resume", "--ckpt-every", "2",
      "--ckpt-dir", {str(tmp_path)!r}])
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"))))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "arch=qwen3-4b cell=train_4k steps=2 failures=0" and lines[1].startswith("loss[0]=")
    assert json.loads(lines[-1]) == []
    assert sorted(os.listdir(tmp_path)) == ["step_000000002"]
