"""The PyTorch/CUDA port stands alone: ``src/repro_torch`` and ``chip_smoke.py``
import neither ``jax`` nor any module of the JAX package ``repro``, nor
``msgpack`` (the JAX package's checkpoint manifest; the card's machine has
none)."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the script twins, beside the JAX package's scripts
TWINS = [ROOT / "examples" / f"{name}_torch.py" for name in ("quickstart", "serve_halp", "replan_channel",
                                                             "train_fault_tolerant")]
TWINS += [ROOT / "tools" / f"{name}_torch.py" for name in ("check", "precompute_plans", "measure_coverage")]
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + TWINS


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "msgpack")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    """Import every module of the port and the script twins in a fresh
    interpreter, then look at ``sys.modules``: no ``jax`` and no
    ``repro``/``repro.*`` may be there."""
    code = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path[:0] = ["examples", "tools"]
twins = [p.split("/")[-1][:-3] for p in sys.argv[1:]]
for name in twins:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"))
print(json.dumps({"imported": names + twins, "bad": bad}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code, *map(str, TWINS)], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.launch.serve" in out["imported"]
    for name in ("quickstart_torch", "serve_halp_torch", "replan_channel_torch", "train_fault_tolerant_torch",
                 "check_torch", "precompute_plans_torch"):
        assert name in out["imported"]
    assert "repro_torch.kernels.conv2d.ops" in out["imported"]
    assert "repro_torch.kernels.attention.ops" in out["imported"]
    assert "repro_torch.models.vit_spatial" in out["imported"]
    assert "repro_torch.core.topology" in out["imported"]
    assert "repro_torch.models.transformer_lm" in out["imported"]
    assert "repro_torch.models.attention" in out["imported"]
    assert "repro_torch.configs.steps" in out["imported"]
    assert "repro_torch.configs.deepseek_v3_671b" in out["imported"]
    assert "repro_torch.analysis.plan_check" in out["imported"]
    assert "repro_torch.analysis.kernel_check" in out["imported"]
    assert "repro_torch.core.reliability" in out["imported"]
    assert "repro_torch.runtime.traffic" in out["imported"]
    for name in ("core.events", "core.simulator", "core.schedule", "core.optimizer", "analysis.dag_check",
                 "core.replan", "core.planstore", "core.placement", "analysis.keying_lint",
                 "models.vit", "models.swin", "models.convnext", "models.efficientnet", "configs.vit_l16",
                 "configs.swin_b", "configs.convnext_b", "configs.efficientnet_b7", "configs.vgg16",
                 "models.unet", "models.dit", "configs.unet_sd15", "configs.dit_xl2", "parallel.variants",
                 "optim.adamw", "optim.schedules", "optim.grad_compress", "data.pipeline", "runtime.checkpoint",
                 "runtime.fault", "runtime.train", "launch.train"):
        assert f"repro_torch.{name}" in out["imported"]
    assert out["bad"] == []


READ_JAX_STORE = """
import json, sys
from repro_torch.core import AGX_XAVIER, CollabTopology, Link, PlanStore, ReplanConfig, ReplanController
from repro_torch.models import vgg

topo = CollabTopology(host="e0", secondaries=("a", "b"),
                      platforms={"e0": AGX_XAVIER, "a": AGX_XAVIER, "b": AGX_XAVIER}, default_link=Link(120e6))
cfg = ReplanConfig(use_simulator=False, alpha=1.0, hysteresis=1, bucket_frac=0.5)
with PlanStore(sys.argv[1]) as store:
    ctl = ReplanController(vgg.SMOKE.geom(), topo, cfg, store=store)
    got = store.get((ctl._fingerprint, ctl._active))
    out = dict(got=repr(got), stats={k: v for k, v in store.stats().items() if k != "path"}, keys=store.keys())
out["bad"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps(out))
"""


def test_a_jax_written_plan_store_row_loads_nothing_of_jax(tmp_path):
    """A store file the JAX package's ``PlanStore`` wrote, at the key the
    port's controller asks for: the port's ``get`` returns None (a stale
    miss), the row stays in the file, and no ``repro`` or ``jax`` module was
    imported to find that out."""
    import repro.core as J
    from repro.models import vgg as jvgg

    path = tmp_path / "plans.sqlite"
    with J.PlanStore(path) as store:
        topo = J.CollabTopology(host="e0", secondaries=("a", "b"),
                                platforms={"e0": J.AGX_XAVIER, "a": J.AGX_XAVIER, "b": J.AGX_XAVIER},
                                default_link=J.Link(120e6))
        net = jvgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10).geom()
        cfg = J.ReplanConfig(use_simulator=False, alpha=1.0, hysteresis=1, bucket_frac=0.5)
        ctl = J.ReplanController(net, topo, cfg, store=store)
        ctl.current()
        keys = store.keys()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", READ_JAX_STORE, str(path)], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["got"] == "None" and out["bad"] == []
    assert out["stats"] == dict(entries=1, hits=0, misses=1, stale=1, writes=0, invalid=0)
    assert out["keys"] == keys and len(keys) == 1
    with J.PlanStore(path) as store:
        assert store.keys() == keys and store.get((ctl._fingerprint, ctl._active)) is not None


SERVE_VISION = """
import json, sys
from repro_torch.launch.serve import serve, serve_archs
done = {}
for name in serve_archs():
    out = serve(name, n_requests=2, max_batch=2, device="cpu", smoke=True)
    done[name] = list(out["logits"].shape)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"))
print(json.dumps({"served": done, "bad": bad}))
"""


def test_serving_every_vision_arch_loads_nothing_of_jax():
    """The launcher's ``serve`` on every arch it takes (the smoke configs, on
    the CPU) in a port-only process: no ``jax`` and no ``repro`` module."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SERVE_VISION], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(out["served"]) == ["convnext-b", "efficientnet-b7", "swin-b", "vgg16", "vit-l16"]
    assert out["served"]["vit-l16"] == [2, 10] and out["bad"] == []


SAMPLE_DIFFUSION = """
import json, sys
import torch
from repro_torch.configs import get
from repro_torch.configs.steps import build
from repro_torch.models.common import tree_map

done = {}
for name in ("unet-sd15", "dit-xl2"):
    arch = get(name)
    for cell in ("gen_fast", "gen_1024"):
        b = build(arch, cell, smoke=True)
        gen = torch.Generator().manual_seed(0)
        params = arch.module.init(gen, arch.smoke_cfg)
        lat = torch.randn(b.inputs["latents"][0], generator=gen)
        shape, dt = b.inputs["cond"]
        cond = torch.zeros(shape, dtype=dt) if dt == torch.int32 else torch.randn(shape, generator=gen)
        out = b.fn(params, lat, cond)
        done[f"{name}/{cell}"] = [list(out.shape), bool(torch.isfinite(out).all())]
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"))
print(json.dumps({"sampled": done, "bad": bad}))
"""


def test_sampling_every_diffusion_arch_loads_nothing_of_jax():
    """Both gen bundles of both diffusion archs (``configs.steps.build`` at
    the smoke configs, on the CPU) sampled in a port-only process: no
    ``jax`` and no ``repro`` module."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SAMPLE_DIFFUSION], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["sampled"] == {f"{a}/{c}": [[2, 8, 8, 4], True] for a in ("unet-sd15", "dit-xl2")
                              for c in ("gen_fast", "gen_1024")}
    assert out["bad"] == []


TRAIN_LM_AND_DIFFUSION = """
import json, sys
import torch
from repro_torch.configs import get
from repro_torch.configs.steps import build, realize

done = {}
for name, cell in (("deepseek-v3-671b", "train_4k"), ("unet-sd15", "train_256")):
    arch = get(name)
    b = build(arch, cell, smoke=True)
    state, inputs = realize(arch, b, torch.Generator().manual_seed(0))
    new, metrics = b.fn(state, **inputs)
    done[name] = [sorted(metrics), int(new[2]), all(bool(torch.isfinite(v)) for v in metrics.values())]
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"))
print(json.dumps({"trained": done, "bad": bad}))
"""


def test_lm_and_diffusion_train_steps_load_nothing_of_jax():
    """One smoke train step of an LM (DeepSeek-V3: MLA, MoE and the MTP
    loss) and of a diffusion model (the U-Net) through ``configs.steps`` in
    a port-only process: no ``jax`` and no ``repro`` module."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", TRAIN_LM_AND_DIFFUSION], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["trained"] == {"deepseek-v3-671b": [["ce", "load_balance", "mtp", "total"], 1, True],
                              "unet-sd15": [["loss"], 1, True]}
    assert out["bad"] == []
