"""The port's LM train step (``configs.steps._lm_train``) against JAX's jitted
step, and a JAX trainer's LM state continued in the port
(``models.common.train_state_from_jax``), on the CPU at the SMOKE configs.

Both start from a JAX state past warmup (step and AdamW count 1000, every
second moment 1e-4: a step moves each parameter by about lr x 10 x its
clipped gradient, so the updates are held, not only the parameters).  The
metrics and each leaf of the new parameters within ``DEPTH_RTOL`` = 1e-4 of
JAX's (an update: of the leaf's largest |update|, plus 2e-5 of its largest
|value| for the float32 rounding of ``p - lr x step``); the moments within
1e-4 in float32 and 2e-2 in bfloat16 (DeepSeek-V3's moments are bfloat16,
and one bfloat16 step of a moment is 2^-8 of it), as
``tests/test_torch_train_runtime.py`` holds AdamW.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import steps as jsteps
from repro.models import transformer_lm as jlm
from repro.runtime.fault import FaultConfig as JFaultConfig
from repro.runtime.train import make_trainer as jmake_trainer
from _torch_parity import perturb_norms, warm_jax_state
from repro_torch.configs import get
from repro_torch.configs.steps import build
from repro_torch.models.common import params_from_jax, train_state_from_jax, tree_leaves, tree_map
from repro_torch.runtime import FaultConfig
from repro_torch.runtime.train import make_trainer, train_smoke

DEPTH_RTOL, TOL = 1e-4, 2e-5
LMS = ("qwen3-4b", "moonshot-v1-16b-a3b", "deepseek-v3-671b")

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


def _held_params(got_tree, want_tree, before_tree) -> list:
    """Leaf by leaf (found by key: JAX's updated trees sort their dict
    keys): the update within 1e-4 of the largest |update|, plus float32
    rounding of the value; returns each leaf's largest |update|."""
    moved = []

    def held(got, want, before):
        assert got.dtype == before.dtype
        b32 = before.float()
        step, jstep = got.float() - b32, want.float() - b32
        assert (step - jstep).abs().max().item() <= DEPTH_RTOL * jstep.abs().max().item() \
            + TOL * b32.abs().max().item()
        moved.append(jstep.abs().max().item())

    tree_map(held, got_tree, params_from_jax(want_tree), before_tree)
    return moved


def _held_moments(got_opt, want_opt) -> None:
    for key in ("mu", "nu"):
        def close(g, w):
            rtol = 1e-4 if g.dtype == torch.float32 else 2e-2
            np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=rtol * np.abs(_np(w)).max())

        tree_map(close, got_opt[key], params_from_jax(want_opt[key]))


@pytest.mark.parametrize("name", LMS)
def test_lm_train_step_matches_jax(name):
    """The smoke train_4k bundle's step (float32) against ``jax.jit`` of
    JAX's bundle's, from the same warm state (JAX's init with perturbed
    norms and router biases): every metric, the new parameters, ``mu`` and
    ``nu`` leaf by leaf; the port's metrics detached 0-dim tensors."""
    ja, a = jget(name), get(name)
    jb, b = jsteps.build(ja, "train_4k", smoke=True), build(a, "train_4k", smoke=True)
    assert b.kind == jb.kind == "train"
    js = warm_jax_state(perturb_norms(jlm.init(jax.random.PRNGKey(0), ja.smoke_cfg), 0), jsteps._opt_cfg_for(ja))
    state = train_state_from_jax(js)
    before = [t.clone() for t in tree_leaves(state)]
    (bs, t), _ = b.inputs["tokens"]
    toks = np.random.default_rng(5).integers(0, ja.smoke_cfg.vocab, (bs, t + 1), dtype=np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    new, metrics = b.fn(state, torch.from_numpy(x), torch.from_numpy(y))
    jnew, jmetrics = jax.jit(jb.fn)(js, jnp.asarray(x), jnp.asarray(y))
    assert all(torch.equal(u, v) for u, v in zip(before, tree_leaves(state)))  # the input state is intact
    assert metrics.keys() == jmetrics.keys()
    assert all(v.dim() == 0 and not v.requires_grad for v in metrics.values())
    for k in jmetrics:
        want = float(jmetrics[k])
        assert abs(metrics[k].item() - want) <= DEPTH_RTOL * max(abs(want), 1e-6), (k, metrics[k], want)
    assert int(new[2]) == 1001 and int(new[1]["count"]) == 1001
    moved = _held_params(new[0], jnew[0], state[0])
    _held_moments(new[1], jnew[1])
    assert len(moved) == len(tree_leaves(state[0])) and max(moved) > 1e-5


@pytest.mark.parametrize("name", ["qwen3-4b", "deepseek-v3-671b"])
def test_jax_lm_trainer_state_continues_in_the_port(name):
    """A JAX ``make_trainer`` LM state (Qwen3's dense stack; DeepSeek-V3's
    dense and MoE stacks and its ``mtp`` subtree, bfloat16 moments), warmed,
    carried into the port by ``train_state_from_jax`` and run 2 steps in
    both trainers on the same token stream: equal losses within 1e-4, the
    parameters and moments leaf by leaf as the step test holds them."""
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        jt, js = jmake_trainer(name, "train_4k", fault_cfg=JFaultConfig(ckpt_dir=d1, ckpt_every=100))
        js = warm_jax_state(js[0], jsteps._opt_cfg_for(jget(name)))
        state = train_state_from_jax(js, "cpu")
        assert sorted(state[0]) == sorted(js[0]) and ("mtp" in state[0]) == (name == "deepseek-v3-671b")
        first = tree_map(torch.clone, state[0])
        t, _ = make_trainer(name, "train_4k", device="cpu", state=state,
                            fault_cfg=FaultConfig(ckpt_dir=d2, ckpt_every=100))
        ts, tstats = t.run(state, 2, resume=False)
        js, jstats = jt.run(js, 2, resume=False)
    assert len(tstats.losses) == len(jstats.losses) == 2
    np.testing.assert_allclose(tstats.losses, jstats.losses, rtol=DEPTH_RTOL)
    assert int(ts[2]) == int(js[2]) == 1002
    moved = _held_params(ts[0], js[0], first)
    _held_moments(ts[1], js[1])
    assert max(moved) > 1e-5


def test_adamw_update_in_slices_is_bit_identical(monkeypatch):
    """AdamW updates a leaf larger than ``CHUNK`` elements a slice of its
    leading axis at a time (a stacked LM leaf's float32 temporaries would
    not fit beside Qwen3-4B's train state on one card): the same bits as
    the whole leaf at once, for stacked, 2-d, 1-d and bfloat16 leaves."""
    from repro_torch.optim import AdamWConfig, adamw, adamw_init, adamw_update

    g = torch.Generator().manual_seed(0)
    shapes = {"stack": (6, 5, 7), "embed": (33, 4), "norm": (40,), "half": (9, 8)}
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    params["half"] = params["half"].bfloat16()
    grads = {k: torch.randn(p.shape, generator=g).to(p.dtype) for k, p in params.items()}
    state = adamw_init(params, AdamWConfig(moment_dtype=None))
    state = dict(state, nu={k: torch.full_like(v, 1e-4) for k, v in state["nu"].items()})
    whole = adamw_update(grads, state, params, AdamWConfig(), 0.5)
    monkeypatch.setattr(adamw, "CHUNK", 8)
    sliced = adamw_update(grads, state, params, AdamWConfig(), 0.5)
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(tree_leaves(whole), tree_leaves(sliced)))


@pytest.mark.parametrize("name", LMS + ("codeqwen1.5-7b",))
def test_train_smoke_every_lm_on_the_cpu(name):
    """``runtime.train``'s default LM cell (train_4k) through ``make_trainer``'s
    token stream and the fault-tolerant trainer: 2 steps, finite losses (the
    LM's ``total``)."""
    out = train_smoke(name, n_steps=2, device="cpu")
    assert out["steps"] == 2 and len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
