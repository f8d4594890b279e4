"""Activation checkpointing (remat) in the port's ViT, Swin and ConvNeXt
against the JAX package's ``jax.checkpoint``, on the CPU.

* Which blocks: JAX checkpoints every ViT block
  (``repro/models/vit.py: apply``), each block of a ConvNeXt stage of depth
  >= 6 and each (regular, shifted) pair of a Swin stage of even depth >= 6
  (the stages it scans).  The port's checkpoint calls, counted on ``meta``
  tensors at the full configs, equal the ``checkpoint`` equations of JAX's
  jaxpr times their scans' lengths (ViT-L/16 24, Swin-B 9, ConvNeXt-B 27),
  at 224 and 384 pixels.
* The numbers: the loss and every gradient leaf of ``loss_fn`` with
  ``remat=True`` against ``jax.value_and_grad`` of JAX's, float32, within
  2e-5 x (1 + |g|), at ViT SMOKE (every block rematted), ConvNeXt SMOKE
  (depths 2-2-6-2: stage 3) and a narrow Swin with a depth-6 stage (Swin's
  SMOKE, depths (2, 2), rematerialises nothing).
* The port with remat on against off: the loss and gradients bit for bit;
  the K1 / K3 wrapper calls a step the forward's plus the recompute's; under
  ``torch.no_grad()`` the forward's calls only and the same logits.
* ``chip_smoke.py``'s record of a bfloat16 SMOKE train step on ``meta``
  tensors (``recording_train_calls``): the recomputed calls apart, and
  ``op_cost.step_flops_of`` (a recomputed conv's forward twice, its
  gradients once) equal to the dry run's count of the same step.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro_torch.configs import get
from repro_torch.configs.steps import _adapt_vision_cfg, _zeros, build
from repro_torch.launch import op_cost
from repro_torch.models import convnext, layers, swin, vit
from repro_torch.models.common import params_from_jax, tree_leaves

from _torch_parity import _seeded_tree, perturb_vision

torch.set_num_threads(2)
TOL = 2e-5


def _smoke_cfg(name: str):
    """The JAX config the case runs: the SMOKE config, but for Swin a
    depth-6 second stage (the stage JAX scans by pairs under remat)."""
    jcfg = jget(name.removesuffix("-deep")).smoke_cfg
    if name == "swin-b-deep":
        jcfg = dataclasses.replace(jcfg, depths=(2, 6))
    return jcfg


CASES = ("vit-l16", "convnext-b", "swin-b-deep")
# the port's wrapper calls of one SMOKE step (forward, recompute): K1, K3, and
# the blocks the model's block function runs
CALLS = {"vit-l16": dict(k1=(1, 0), k3=(2, 2), blocks=(2, 2)),
         "convnext-b": dict(k1=(16, 6), k3=(0, 0), blocks=(12, 6)),
         "swin-b-deep": dict(k1=(1, 0), k3=(0, 0), blocks=(8, 6))}
BLOCK_FN = {"vit-l16": (vit, "vit_block_apply"), "convnext-b": (convnext, "_block_apply"),
            "swin-b-deep": (swin, "_swin_block")}


def _port(name: str):
    return get(name.removesuffix("-deep"))


@functools.cache
def _inputs(name: str, seed: int = 0):
    """(JAX parameters, images, labels): seeded values in the tree of JAX's
    init, norms and biases perturbed (``perturb_vision``)."""
    jcfg = _smoke_cfg(name)
    jmod = jget(name.removesuffix("-deep")).module
    shapes = jax.eval_shape(lambda k: jmod.init(k, jcfg), jax.random.PRNGKey(0))
    jp = perturb_vision(_seeded_tree(shapes, seed), seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, jcfg.img_res, jcfg.img_res, jcfg.in_channels), dtype=np.float32)
    y = rng.integers(0, jcfg.num_classes, 2).astype(np.int32)
    return jp, x, y


def _port_cfg(name: str, **kw):
    jcfg = _smoke_cfg(name)
    return type(_port(name).smoke_cfg)(**{**dataclasses.asdict(jcfg), **kw})


def _value_and_grad(name: str, remat: bool = True):
    """The port's float32 (loss, gradient leaves) with ``remat``."""
    jp, x, y = _inputs(name)
    leaves = tree_leaves(params := params_from_jax(jp))
    for t in leaves:
        t.requires_grad_()
    loss, _ = _port(name).module.loss_fn(params, _port_cfg(name, remat=remat), torch.from_numpy(x),
                                         torch.from_numpy(y))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]


@pytest.mark.parametrize("name", CASES)
def test_loss_and_gradients_under_remat_match_jax(name):
    jcfg = _smoke_cfg(name)
    assert jcfg.remat
    jmod = jget(name.removesuffix("-deep")).module
    jp, x, y = _inputs(name)
    fn = jax.jit(jax.value_and_grad(lambda p, x, y: jmod.loss_fn(p, jcfg, x, y), has_aux=True))
    (want_loss, _), want = fn(jp, jnp.asarray(x), jnp.asarray(y))
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(want)]
    loss, got = _value_and_grad(name)
    assert len(got) == len(want)
    assert abs(loss.item() - float(want_loss)) <= TOL * (1 + abs(float(want_loss)))
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        assert g.shape == w.shape, i
        share = (np.abs(g - w) / (TOL * (1 + np.abs(w)))).max()
        assert share <= 1.0, (i, share)


def _counting(monkeypatch, name: str) -> dict:
    """Counts the port's K1 and K3 wrapper calls (as the models make them)
    and its block function's calls."""
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_cuda

    n = dict(k1=0, k3=0, blocks=0)

    def counted(key, fn):
        def call(*args, **kw):
            n[key] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(layers, "conv2d_cuda", counted("k1", conv2d_cuda))
    monkeypatch.setattr(vit, "flash_attention", counted("k3", flash_attention))
    mod, fn_name = BLOCK_FN[name]
    monkeypatch.setattr(mod, fn_name, counted("blocks", getattr(mod, fn_name)))
    return n


@pytest.mark.parametrize("name", CASES)
def test_remat_equals_no_remat_bit_for_bit(name, monkeypatch):
    n = _counting(monkeypatch, name)
    out = {}
    for remat in (True, False):
        n.update(k1=0, k3=0, blocks=0)
        out[remat] = _value_and_grad(name, remat)
        want = {k: v[0] + (v[1] if remat else 0) for k, v in CALLS[name].items()}
        assert n == want, (remat, n, want)
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))


@pytest.mark.parametrize("name", CASES)
def test_no_grad_forward_runs_as_before(name, monkeypatch):
    """Serving records no gradient: with remat set, the same calls (the
    forward's alone) and the same logits, bit for bit, as with it unset;
    no checkpoint is taken."""
    n = _counting(monkeypatch, name)
    taken = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", lambda *a, **kw: taken.append(1) or real(*a, **kw))
    jp, x, _ = _inputs(name)
    params = params_from_jax(jp)
    logits = {}
    for remat in (True, False):
        n.update(k1=0, k3=0, blocks=0)
        with torch.no_grad():
            logits[remat] = _port(name).module.apply(params, _port_cfg(name, remat=remat), torch.from_numpy(x))
        assert n == {k: v[0] for k, v in CALLS[name].items()}, (remat, n)
    assert torch.equal(logits[True], logits[False]) and not taken


def _jax_checkpointed_blocks(name: str, img_res: int) -> int:
    """The blocks JAX's full-config forward runs under ``jax.checkpoint``:
    the checkpoint equations in each scan's body times its length."""
    ja = jget(name)
    cfg = dataclasses.replace(ja.cfg, img_res=img_res)
    if hasattr(cfg, "window") and img_res == 384:
        cfg = dataclasses.replace(cfg, window=12)
    shapes = jax.eval_shape(lambda k: ja.module.init(k, cfg), jax.random.PRNGKey(0))
    x = jax.ShapeDtypeStruct((1, img_res, img_res, 3), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda p, x: ja.module.apply(p, cfg, x))(shapes, x).jaxpr
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "scan":
            body = eqn.params["jaxpr"].jaxpr
            total += eqn.params["length"] * sum(e.primitive.name in ("checkpoint", "remat2") for e in body.eqns)
    return total


@pytest.mark.parametrize("img_res", [224, 384])
@pytest.mark.parametrize("name,blocks", [("vit-l16", 24), ("swin-b", 9), ("convnext-b", 27)])
def test_full_configs_checkpoint_the_blocks_jax_does(name, blocks, img_res, monkeypatch):
    """The full configs' forward with the parameters requiring grad, on
    ``meta`` tensors (the kernels' shape-only route): one checkpoint for
    each block (Swin: pair) JAX checkpoints, none with remat unset."""
    assert _jax_checkpointed_blocks(name, img_res) == blocks
    a = get(name)
    taken = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", lambda *a, **kw: taken.append(1) or real(*a, **kw))
    cfg = _adapt_vision_cfg(a, a.cfg, img_res)
    params = a.module.init(torch.Generator(), cfg, device="meta")
    for t in tree_leaves(params):
        t.requires_grad_()
    x = torch.empty((1, img_res, img_res, 3), device="meta")
    for remat, want in ((True, blocks), (False, 0)):
        taken.clear()
        logits = a.module.apply(params, dataclasses.replace(cfg, remat=remat), x)
        assert logits.shape == (1, cfg.num_classes) and logits.requires_grad
        assert len(taken) == want, (remat, len(taken))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,recomputed", [("vit-l16", (0, 2)), ("convnext-b", (6, 0)), ("swin-b", (0, 0)),
                                             ("efficientnet-b7", (0, 0))])
def test_step_flops_of_counts_the_recompute_as_the_dry_run(name, recomputed):
    from torch.utils.flop_counter import FlopCounterMode

    cs = _chip_smoke()
    a = get(name)
    b = build(a, "cls_224", smoke=True, dtype=torch.bfloat16)
    state = _zeros(b.state, "meta")
    inputs = {k: _zeros(v, "meta") for k, v in b.inputs.items()}
    with op_cost.counting(state, inputs) as cost:
        b.fn(state, **inputs)
    with cs.recording_train_calls() as rec, FlopCounterMode(display=False) as counter:
        b.fn(state, **inputs)
    assert (sum(rec.recomputed.values()), sum(rec.recomputed_attns.values())) == recomputed
    assert len(rec.order) == sum(rec.convs.values()) - recomputed[0]
    assert cs.k1_dgrads(rec) == sum(cost.calls.get("K1 dgrad", {}).values())
    assert op_cost.step_flops_of(counter, rec) == cost.flops
