"""Diffusion training's bundles and runtime in the port (``configs.steps``'
train_256 / train_1024 bundles, DiT's blocks under remat, ``runtime.train``,
``launch.train``, ``models.common.train_state_from_jax``) against the JAX
package, on the CPU at the SMOKE configs (the step against JAX's:
``tests/test_torch_diffusion_train.py``)."""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import steps as jsteps
from repro.runtime.fault import FaultConfig as JFaultConfig
from repro.runtime.train import make_trainer as jmake_trainer
from _torch_parity import diffusion_param_values, warm_jax_state
from test_torch_diffusion_train import by_path, port_step
from repro_torch.configs import get
from repro_torch.configs.steps import build
from repro_torch.models import dit
from repro_torch.models.common import params_from_jax, train_state_from_jax, tree_leaves
from repro_torch.runtime import FaultConfig
from repro_torch.runtime.train import make_trainer, train_smoke

ROOT = Path(__file__).resolve().parents[1]
DIFFUSION = ("unet-sd15", "dit-xl2")
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


def test_dit_remat_equals_no_remat(monkeypatch):
    """DiT's blocks under activation checkpointing (JAX's ``remat=True``)
    give the same loss and step, bit for bit, running each block twice a
    step (forward and recompute) and once where nothing records (the
    sampler); the U-Net, which JAX does not remat, has no such field."""
    assert not hasattr(get("unet-sd15").smoke_cfg, "remat") and get("dit-xl2").smoke_cfg.remat
    calls = []
    real = dit._block_apply
    monkeypatch.setattr(dit, "_block_apply", lambda *a: calls.append(1) or real(*a))
    a = get("dit-xl2")
    out = {}
    for remat in (True, False):
        calls.clear()
        out[remat] = port_step("dit-xl2", torch.float32, dataclasses.replace(a.smoke_cfg, remat=remat))
        assert len(calls) == a.smoke_cfg.n_layers * (2 if remat else 1)
    assert torch.equal(out[True][0]["loss"], out[False][0]["loss"])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(out[True][2]), tree_leaves(out[False][2])))
    calls.clear()
    b = build(a, "gen_fast", smoke=True)
    params = params_from_jax(diffusion_param_values(jget("dit-xl2").module.init, a.smoke_cfg))
    b.fn(params, torch.zeros(b.inputs["latents"][0]), torch.zeros(b.inputs["cond"][0], dtype=torch.int32))
    assert len(calls) == a.smoke_cfg.n_layers * min(2, a.cells["gen_fast"].meta["steps"])  # the smoke steps


_JDT = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
        jnp.dtype(jnp.int32): torch.int32}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("cell", ["train_256", "train_1024"])
@pytest.mark.parametrize("name", DIFFUSION)
def test_train_bundles_match_jax(name, cell, smoke):
    """The train bundles (FULL: the parameters and AdamW state built on the
    ``meta`` device) against JAX's: kind, input names in JAX's order
    (latents, t, cond, noise) with their shapes and types, and every leaf of
    the state (parameters, moments, count, step)."""
    ja, a = jget(name), get(name)
    jb, b = jsteps.build(ja, cell, smoke=smoke), build(a, cell, smoke=smoke)
    assert b.kind == jb.kind == "train"

    def same(spec, s):
        assert spec == (tuple(s.shape), _JDT[jnp.dtype(s.dtype)])

    assert list(b.inputs) == list(jb.inputs) == ["latents", "t", "cond", "noise"]
    jax.tree_util.tree_map(same, b.inputs, jb.inputs, is_leaf=lambda x: isinstance(x, tuple))
    params, opt, n = b.state
    jparams, jopt, jn = jb.state
    jax.tree_util.tree_map(same, params, jparams, is_leaf=lambda x: isinstance(x, tuple))
    for key in ("mu", "nu"):
        jax.tree_util.tree_map(same, opt[key], jopt[key], is_leaf=lambda x: isinstance(x, tuple))
    same(opt["count"], jopt["count"])
    same(n, jn)


def test_jax_diffusion_trainer_state_continues_in_the_port():
    """A JAX ``make_trainer`` DiT state (train_256, warmed) carried into the
    port by ``train_state_from_jax`` and run 2 steps in both trainers on the
    same diffusion stream: equal losses within 1e-4 and every parameter
    within 1e-4 of the tree's largest |update|."""
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        jt, js = jmake_trainer("dit-xl2", "train_256", fault_cfg=JFaultConfig(ckpt_dir=d1, ckpt_every=100))
        js = warm_jax_state(js[0], jsteps._opt_cfg_for(jget("dit-xl2")))
        state = train_state_from_jax(js, "cpu")
        first = [t.clone() for t in tree_leaves(state[0])]
        t, _ = make_trainer("dit-xl2", "train_256", device="cpu", state=state,
                            fault_cfg=FaultConfig(ckpt_dir=d2, ckpt_every=100))
        ts, tstats = t.run(state, 2, resume=False)
        js, jstats = jt.run(js, 2, resume=False)
    np.testing.assert_allclose(tstats.losses, jstats.losses, rtol=DEPTH_RTOL)
    assert int(ts[2]) == int(js[2]) == 1002
    got, want = by_path(ts[0], params_from_jax(js[0]))
    top = max(np.abs(w - _np(o)).max() for w, o in zip(want, first))
    assert top > 1e-5
    assert max(np.abs(g - w).max() for g, w in zip(got, want)) <= DEPTH_RTOL * top + TOL


@pytest.mark.parametrize("name", DIFFUSION)
def test_train_smoke_on_the_cpu(name):
    """``runtime.train``'s default diffusion cell (train_256) through
    ``make_trainer``'s stream and the fault-tolerant trainer."""
    out = train_smoke(name, n_steps=2, device="cpu")
    assert out["steps"] == 2 and len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


def test_launcher_trains_the_unet_in_a_port_only_process(tmp_path):
    """``python -m repro_torch.launch.train --arch unet-sd15 --device cpu`` in
    a fresh interpreter: it trains, checkpoints, and loads no ``jax`` or
    ``repro``."""
    code = f"""
import json, sys
from repro_torch.launch.train import main
main(["--arch", "unet-sd15", "--steps", "2", "--device", "cpu", "--no-resume", "--ckpt-every", "2",
      "--ckpt-dir", {str(tmp_path)!r}])
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"))))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "arch=unet-sd15 cell=train_256 steps=2 failures=0" and lines[1].startswith("loss[0]=")
    assert json.loads(lines[-1]) == [] and sorted(os.listdir(tmp_path)) == ["step_000000002"]
