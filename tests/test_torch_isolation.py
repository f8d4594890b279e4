"""The PyTorch/CUDA port stands alone: ``src/repro_torch`` and ``chip_smoke.py``
import neither ``jax`` nor any module of the JAX package ``repro``."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


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
    """Import every module of the port in a fresh interpreter, then look at
    ``sys.modules``: no ``jax`` and no ``repro``/``repro.*`` may be there."""
    code = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"imported": names, "bad": bad}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.launch.serve" in out["imported"]
    assert "repro_torch.kernels.conv2d.ops" in out["imported"]
    assert "repro_torch.kernels.attention.ops" in out["imported"]
    assert "repro_torch.models.vit_spatial" in out["imported"]
    assert "repro_torch.core.topology" in out["imported"]
    assert "repro_torch.models.transformer_lm" in out["imported"]
    assert "repro_torch.models.attention" in out["imported"]
    assert "repro_torch.configs.steps" in out["imported"]
    assert "repro_torch.configs.deepseek_v3_671b" in out["imported"]
    assert out["bad"] == []
