"""The port's training runtime (``repro_torch.optim``, ``data``,
``runtime.checkpoint``, ``runtime.fault``, ``runtime.train``,
``launch.train``) against the JAX package's, on the CPU.

AdamW, the schedules and the compressors are held to JAX's on the same
numpy inputs (float32 at 2e-5 x (1 + |x|), bfloat16 moments at 2e-2, as
``tests/test_kernels.py: _tol``); the data streams bit for bit; the
checkpoint by a round trip; the fault-tolerant trainer by twins of
``tests/test_runtime.py``'s trainer tests (ViT SMOKE in place of the LM);
a JAX trainer's state carried into the port and run 3 steps in both,
within ``DEPTH_RTOL`` = 1e-4 of each leaf's largest |value|.
"""
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

from repro.data import pipeline as jpipeline
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedules as jsched
from repro.runtime.fault import FaultConfig as JFaultConfig
from repro.runtime.train import make_trainer as jmake_trainer
from repro_torch.configs import get
from repro_torch.configs.steps import build, realize
from repro_torch.core import ComputeRateEstimator
from repro_torch.data import DiffusionStream, ImageStream, TokenStream, device_batch
from repro_torch.models.common import params_from_jax, train_state_from_jax, tree_leaves, tree_map
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, compress_bf16, compress_topk, constant,
                               decompress_bf16, global_norm, topk_sparsify, warmup_cosine)
from repro_torch.runtime import (FaultConfig, FaultTolerantTrainer, InjectedFault, latest_step,
                                 restore_checkpoint, save_checkpoint)
from repro_torch.runtime.train import make_trainer, train_smoke

ROOT = Path(__file__).resolve().parents[1]
DEPTH_RTOL = 1e-4


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-5)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype=torch.float32):
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


# -- optimizer ------------------------------------------------------------------


def _tree(rng, dtype=np.float32):
    """A small parameter tree, its dict keys in sorted order (JAX's leaf
    order, so the global norm adds the leaves in the same order)."""
    return {"b": rng.standard_normal(16).astype(dtype), "nested": {"s": rng.standard_normal(5).astype(dtype)},
            "w": rng.standard_normal((8, 16)).astype(dtype)}


@pytest.mark.parametrize("moments", [None, "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0, 50.0])
def test_adamw_update_matches_jax(moments, clip):
    rng = np.random.default_rng(3)
    params = _tree(rng)
    jcfg = jadamw.AdamWConfig(grad_clip=clip, moment_dtype=jnp.bfloat16 if moments else None)
    cfg = AdamWConfig(grad_clip=clip, moment_dtype=torch.bfloat16 if moments else None)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), tree_map(torch.from_numpy, params)
    js, ts = jadamw.adamw_init(jp, jcfg), adamw_init(tp, cfg)
    assert all(t.dtype == (torch.bfloat16 if moments else torch.float32) for t in tree_leaves(ts["mu"]))
    mdt = torch.bfloat16 if moments else torch.float32
    for n in (999, 1000, 1001, 5000):  # warmup's end, then cosine decay
        grads = tree_map(lambda a: 3 * a, _tree(rng))
        jp, js = jadamw.adamw_update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp, jcfg,
                                     jsched.warmup_cosine(n))
        tp, ts = adamw_update(tree_map(torch.from_numpy, grads), ts, tp, cfg, warmup_cosine(torch.tensor(n)))
        assert int(ts["count"]) == int(js["count"]) and ts["count"].dtype == torch.int32
        for got, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            _close(got, want)
        for key in ("mu", "nu"):
            for got, want in zip(tree_leaves(ts[key]), jax.tree_util.tree_leaves(js[key])):
                assert got.dtype == mdt
                _close(got, want, mdt)


def test_adamw_is_functional_and_keeps_types():
    """New tensors out, the inputs untouched (the trainer's rewind keeps a
    reference to its entry state); bfloat16 parameters stay bfloat16."""
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    cfg = AdamWConfig(lr=0.1, moment_dtype=torch.bfloat16)  # a step bfloat16 does not round away at 1
    s = adamw_init(p, cfg)
    before = [t.clone() for t in tree_leaves((p, s))]
    p2, s2 = adamw_update({"w": torch.ones(4, 4, dtype=torch.bfloat16)}, s, p, cfg)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves((p, s))))
    assert p2["w"].dtype == torch.bfloat16 and s2["mu"]["w"].dtype == torch.bfloat16
    assert p2["w"].data_ptr() != p["w"].data_ptr() and bool(torch.isfinite(p2["w"].float()).all())
    assert not torch.equal(p2["w"], p["w"])


def test_adamw_reduces_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params, cfg)
    for _ in range(300):
        params, state = adamw_update({"w": 2 * params["w"]}, state, params, cfg)
    assert params["w"].abs().max().item() < 1e-2


def test_global_norm_and_schedules_match_jax():
    rng = np.random.default_rng(4)
    tree = _tree(rng)
    _close(global_norm(tree_map(torch.from_numpy, tree)), jadamw.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    bf = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), tree)
    jbf = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    _close(global_norm(bf), jadamw.global_norm(jbf))
    for step in (0, 1, 500, 999, 1000, 1001, 50_000, 99_999, 100_000, 250_000):
        for kw in ({}, dict(warmup=10, total=200, floor=0.0)):
            got = warmup_cosine(step, **kw)
            assert got.dtype == torch.float32
            _close(got, jsched.warmup_cosine(step, **kw))
            _close(warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw), jsched.warmup_cosine(step, **kw))
        assert constant(step).item() == float(jsched.constant(step)) == 1.0


def test_grad_compress_matches_jax():
    rng = np.random.default_rng(5)
    g = {"a": rng.standard_normal((64, 128)).astype(np.float32), "small": rng.standard_normal(100).astype(np.float32)}
    tg, jg = tree_map(torch.from_numpy, g), jax.tree_util.tree_map(jnp.asarray, g)
    c, jc = compress_bf16(tg), jgc.compress_bf16(jg)
    assert c["a"].dtype == torch.bfloat16
    for got, want in zip(tree_leaves(c), jax.tree_util.tree_leaves(jc)):
        assert np.array_equal(_np(got), _np(want))
    d = decompress_bf16(c)
    assert d["a"].dtype == torch.float32 and np.array_equal(d["a"].numpy(), _np(jgc.decompress_bf16(jc)["a"]))
    for frac in (0.05, 0.1, 0.5):
        got, want = topk_sparsify(tg["a"], frac=frac), jgc.topk_sparsify(jg["a"], frac=frac)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert abs((got != 0).float().mean().item() - frac) < 1e-3
    assert topk_sparsify(tg["small"]) is tg["small"]  # under min_size: dense
    ties = torch.tensor([3.0] * 10 + [1.0] * 4086)  # a tie at the threshold is kept (>=)
    assert np.array_equal(topk_sparsify(ties, frac=0.001).numpy(), np.asarray(jgc.topk_sparsify(jnp.asarray(ties.numpy()), frac=0.001)))
    for got, want in zip(tree_leaves(compress_topk(tg)), jax.tree_util.tree_leaves(jgc.compress_topk(jg))):
        assert np.array_equal(got.numpy(), np.asarray(want))


# -- data ------------------------------------------------------------------------


STREAMS = [
    (TokenStream, jpipeline.TokenStream, dict(vocab=100, batch=2, seq_len=8, seed=1)),
    (ImageStream, jpipeline.ImageStream, dict(img_res=8, batch=3, num_classes=7, seed=2)),
    (DiffusionStream, jpipeline.DiffusionStream, dict(latent_res=4, batch=2, seed=3)),
    (DiffusionStream, jpipeline.DiffusionStream, dict(latent_res=4, batch=2, ctx=(7, 12), seed=4)),
]


@pytest.mark.parametrize("ours,theirs,kw", STREAMS, ids=["tokens", "images", "diffusion-classes", "diffusion-ctx"])
def test_streams_bit_equal_jax(ours, theirs, kw):
    s, js = ours(**kw), theirs(**kw)
    for step in range(4):
        got, want = s.batch_at(step), js.batch_at(step)
        assert list(got) == list(want)
        for key in got:
            w = np.asarray(want[key])
            assert got[key].numpy().dtype == w.dtype and np.array_equal(got[key].numpy(), w), key
    assert not np.array_equal(next(iter(s.batch_at(0).values())), next(iter(s.batch_at(1).values())))
    moved = device_batch(s.batch_at(0), "cpu")
    assert all(torch.equal(moved[k], v) for k, v in s.batch_at(0).items())


# -- checkpoints -------------------------------------------------------------------


def test_checkpoint_round_trip():
    tree = ({"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.randn(4).to(torch.bfloat16),
                                                          "d": torch.tensor(7, dtype=torch.int32)}},
            [torch.randn(3, 2)], torch.tensor(5, dtype=torch.int32))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 3, tree, extra={"arch": "x"})
        save_checkpoint(d, 7, tree)
        assert latest_step(d) == 7
        assert sorted(os.listdir(d)) == ["step_000000003", "step_000000007"]  # no temporary directory left
        assert sorted(os.listdir(Path(d, "step_000000003"))) == ["arrays.npz", "meta.json"]
        meta = json.loads(Path(d, "step_000000003", "meta.json").read_text())
        assert [m["dtype"] for m in meta["manifest"]] == ["float32", "bfloat16", "int32", "float32", "int32"]
        assert [m["key"] for m in meta["manifest"]] == ["0/a", "0/b/c", "0/b/d", "1/0", "2"]
        with np.load(Path(d, "step_000000003", "arrays.npz")) as npz:
            assert npz["a1"].dtype == np.uint16  # bfloat16 as its bits
        like = tree_map(torch.zeros_like, tree)
        restored, step, extra = restore_checkpoint(d, like, step=3)
        assert step == 3 and extra == {"arch": "x"}
        for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert isinstance(restored, tuple) and isinstance(restored[1], list)
        # a restore lands in the types of ``like``
        as_f32 = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32), tree)
        back, _, _ = restore_checkpoint(d, as_f32)
        assert all(t.dtype == torch.float32 for t in tree_leaves(back))
        assert torch.equal(back[0]["b"]["c"], tree[0]["b"]["c"].float())
        with pytest.raises(ValueError, match="leaves"):
            restore_checkpoint(d, {"only": torch.zeros(1)})
    with tempfile.TemporaryDirectory() as d:
        assert latest_step(d) is None and latest_step(Path(d, "absent")) is None
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(d, tree)


# -- the fault-tolerant trainer ------------------------------------------------------


class _CountStream:
    """Deterministic toy stream: batch i carries the scalar i."""

    def batch_at(self, i):
        return {"x": torch.tensor(float(i))}


def _toy_trainer(ckpt_dir, max_failures=3, fault_hook=None, **kw):
    def step(state, x):
        return {"w": state["w"] + x}, {"loss": x}

    cfg = FaultConfig(ckpt_dir=ckpt_dir, ckpt_every=2, max_failures=max_failures)
    return FaultTolerantTrainer(step, _CountStream(), cfg, fault_hook=fault_hook, **kw)


def _fault_once_at(steps):
    fired = set()

    def hook(i):
        if i in steps and i not in fired:
            fired.add(i)
            raise InjectedFault(f"chaos at step {i}")

    return hook


def _zero():
    return {"w": torch.zeros(())}


def test_trainer_stats_dedupe_replayed_steps():
    with tempfile.TemporaryDirectory() as d:
        state, stats = _toy_trainer(d, fault_hook=_fault_once_at({3})).run(_zero(), 6, resume=False)
        assert stats.failures == 1 and stats.restores == 1
        assert stats.steps == 6 and stats.losses == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
        assert float(state["w"]) == sum(range(6))


def test_trainer_retry_budget_is_consecutive_not_total():
    with tempfile.TemporaryDirectory() as d:
        state, stats = _toy_trainer(d, max_failures=1, fault_hook=_fault_once_at({1, 3, 5})).run(
            _zero(), 8, resume=False)
        assert stats.failures == 3 and stats.steps == 8 and float(state["w"]) == sum(range(8))


def test_trainer_consecutive_failures_still_bounded():
    def always_boom(i):
        if i == 3:
            raise InjectedFault("hard fault at step 3")

    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="consecutive"):
            _toy_trainer(d, max_failures=2, fault_hook=always_boom).run(_zero(), 6, resume=False)


def test_trainer_recovery_before_first_checkpoint_rewinds_state():
    class _OneBasedStream:
        def batch_at(self, i):
            return {"x": torch.tensor(float(i + 1))}

    def step(state, x):
        return {"w": state["w"] + x}, {"loss": x}

    with tempfile.TemporaryDirectory() as d:
        cfg = FaultConfig(ckpt_dir=d, ckpt_every=10, max_failures=3)
        t = FaultTolerantTrainer(step, _OneBasedStream(), cfg, fault_hook=_fault_once_at({1}))
        state, stats = t.run(_zero(), 4, resume=False)
        assert stats.failures == 1 and float(state["w"]) == 10.0
        assert stats.steps == 4 and stats.losses == [1.0, 2.0, 3.0, 4.0]


def test_trainer_recovery_ignores_stale_checkpoints_from_prior_runs():
    with tempfile.TemporaryDirectory() as d:
        _toy_trainer(d).run(_zero(), 8, resume=False)  # leaves step_8 etc.
        state, stats = _toy_trainer(d, fault_hook=_fault_once_at({1})).run(_zero(), 4, resume=False)
        assert stats.failures == 1 and stats.steps == 4 and float(state["w"]) == sum(range(4))


def test_trainer_stats_count_fresh_reruns():
    seen = []
    with tempfile.TemporaryDirectory() as d:
        t = _toy_trainer(d, compute_observer=lambda es, fl, dt: seen.append(es), step_flops=1e9)
        t.run(_zero(), 4, resume=False)
        assert t.stats.steps == 4 and len(seen) == 4
        t.run(_zero(), 4, resume=False)
        assert t.stats.steps == 8 and len(seen) == 8


def test_trainer_compute_observer_feeds_planner_once_per_step():
    seen = []
    with tempfile.TemporaryDirectory() as d:
        _toy_trainer(d, fault_hook=_fault_once_at({3}), compute_observer=lambda es, fl, dt: seen.append((es, fl, dt)),
                     es_name="b", step_flops=2e9).run(_zero(), 6, resume=False)
    assert len(seen) == 6 and all(es == "b" and fl == 2e9 and dt > 0 for es, fl, dt in seen)
    est = ComputeRateEstimator({"b": 1e12}, alpha=1.0)
    for es, fl, dt in seen:
        est.observe(es, fl, dt)
    assert est.rate("b") == pytest.approx(seen[-1][1] / seen[-1][2])


def test_trainer_resumes_from_the_newest_checkpoint():
    with tempfile.TemporaryDirectory() as d:
        _toy_trainer(d).run(_zero(), 4, resume=False)
        t = _toy_trainer(d)
        state, stats = t.run(_zero(), 6)  # resumes at step 4 from step_4's state
        assert stats.restores == 1 and stats.steps == 2 and float(state["w"]) == sum(range(6))


def test_fault_tolerant_trainer_recovers_vit_smoke():
    """Faults at step 3, twice; the run restores and replays to the state of
    an uninterrupted one, bit for bit (the CPU's arithmetic repeats)."""
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        t_ref, s_ref = make_trainer("vit-l16", "cls_224", device="cpu", fault_cfg=FaultConfig(ckpt_dir=d1, ckpt_every=2))
        s_ref, stats_ref = t_ref.run(s_ref, 6, resume=False)
        boom = {"n": 0}

        def hook(i):
            if i == 3 and boom["n"] < 2:
                boom["n"] += 1
                raise InjectedFault(f"chaos at step {i}")

        t2, s2 = make_trainer("vit-l16", "cls_224", device="cpu", fault_cfg=FaultConfig(ckpt_dir=d2, ckpt_every=2),
                              fault_hook=hook)
        s2, stats = t2.run(s2, 6, resume=False)
        assert stats.failures == 2 and stats.restores >= 2
        assert stats.losses == stats_ref.losses and stats.steps == 6
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s_ref), tree_leaves(s2)))
        assert int(s2[2]) == 6


def test_train_step_leaves_its_input_state_intact():
    arch = get("vit-l16")
    bundle = build(arch, "cls_224", smoke=True)
    assert bundle.kind == "train"
    state, inputs = realize(arch, bundle, torch.Generator().manual_seed(1))
    before = [t.clone() for t in tree_leaves(state)]
    new, metrics = bundle.fn(state, **inputs)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state)))
    assert int(new[2]) == 1 and int(state[2]) == 0 and bool(torch.isfinite(metrics["loss"]))
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(tree_leaves(new[0]), tree_leaves(state[0])))


def _warm(state):
    """A JAX trainer state past warmup: step and AdamW count 1000 (bias
    corrections ~1) and every second moment at 1e-4, so Adam's normalisation
    does not blow a gradient's rounding noise (a key bias the loss does not
    see) up to a whole step."""
    params, opt, _ = state
    nu = jax.tree_util.tree_map(lambda t: jnp.full_like(t, 1e-4), opt["nu"])
    return params, dict(opt, nu=nu, count=jnp.int32(1000)), jnp.int32(1000)


def test_jax_trainer_state_continues_in_the_port():
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        jt, js = jmake_trainer("vit-l16", "cls_224", fault_cfg=JFaultConfig(ckpt_dir=d1, ckpt_every=100))
        js = _warm(js)
        state = train_state_from_jax(js, "cpu")
        assert isinstance(state, tuple) and state[2].dtype == torch.int32 and int(state[1]["count"]) == 1000
        t, _ = make_trainer("vit-l16", "cls_224", device="cpu", state=state,
                            fault_cfg=FaultConfig(ckpt_dir=d2, ckpt_every=100))
        js, jstats = jt.run(js, 3, resume=False)
        ts, tstats = t.run(state, 3, resume=False)
    assert len(tstats.losses) == len(jstats.losses) == 3
    np.testing.assert_allclose(tstats.losses, jstats.losses, rtol=DEPTH_RTOL)
    assert int(ts[2]) == int(js[2]) == 1003 and int(ts[1]["count"]) == int(js[1]["count"]) == 1003
    first = params_from_jax(_warm(jmake_trainer("vit-l16", "cls_224")[1])[0])
    moved = []

    def held(got, want, before):  # leaves found by key: JAX's updated trees sort their dict keys
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= DEPTH_RTOL * scale
        moved.append((want - before).abs().max().item() / max(scale, 1e-30))

    tree_map(held, ts[0], params_from_jax(js[0]), first)
    assert len(moved) == len(tree_leaves(ts[0])) and max(moved) > 1e-3  # the holds are not of an unmoved state


def test_train_smoke_on_the_cpu():
    out = train_smoke("vit-l16", n_steps=3, device="cpu")
    assert out["steps"] == 3 and len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))


def test_launcher_trains_in_a_port_only_process(tmp_path):
    """``python -m repro_torch.launch.train --device cpu``'s main in a fresh
    interpreter: it trains, checkpoints, and loads no ``jax``, ``repro`` or
    ``msgpack``."""
    code = f"""
import json, sys
from repro_torch.launch.train import main
main(["--arch", "vit-l16", "--steps", "3", "--device", "cpu", "--no-resume", "--ckpt-every", "2",
      "--ckpt-dir", {str(tmp_path)!r}])
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"))))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "arch=vit-l16 cell=cls_224 steps=3 failures=0" and lines[1].startswith("loss[0]=")
    assert json.loads(lines[-1]) == []
    assert sorted(os.listdir(tmp_path)) == ["step_000000002", "step_000000003"]
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "vit-l16", "--steps", "1",
                           "--device", "cpu", "--ckpt-dir", str(tmp_path / "m")], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0 and "steps=1 failures=0" in proc.stdout, proc.stderr
