"""Checkpointing (twin of ``repro/runtime/checkpoint.py``): a tensor tree
<-> ``.npz`` plus a JSON manifest.

Layout per checkpoint: ``<dir>/step_<N:09d>/arrays.npz`` (entry ``a<i>`` for
the i-th leaf in tree order; bfloat16 stored as its uint16 bits) and
``meta.json`` (step, each leaf's path key and type, and ``extra``) where
JAX's writes ``meta.msgpack``; so a checkpoint the JAX package wrote is not
read here.  A checkpoint is written into a temporary directory beside it and
published with ``os.replace``, so ``latest_step`` only ever sees complete
ones.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models.common import tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

META = "meta.json"


def _paths_and_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths_and_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths_and_leaves(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def save_checkpoint(ckpt_dir: str | Path, step: int, tree: Any, extra: dict | None = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:09d}"
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        arrays, manifest = {}, []
        for i, (key, leaf) in enumerate(_paths_and_leaves(tree)):
            arrays[f"a{i}"], dtype = _to_numpy(leaf)
            manifest.append({"key": key, "dtype": dtype})
        np.savez(tmp / "arrays.npz", **arrays)
        meta = {"step": step, "manifest": manifest, "extra": extra or {}}
        (tmp / META).write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
             if d.name.startswith("step_") and (d / META).exists()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str | Path, like: Any, step: int | None = None):
    """Restore into the structure of ``like``, each leaf found by its path
    and put on the device and in the type of ``like``'s.  Returns (tree,
    step, extra)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:09d}"
    meta = json.loads((d / META).read_text())
    flat_like = _paths_and_leaves(like)
    index = {entry["key"]: (i, entry["dtype"]) for i, entry in enumerate(meta["manifest"])}
    if len(index) != len(flat_like) or any(key not in index for key, _ in flat_like):
        raise ValueError(f"checkpoint has {len(index)} leaves, expected {len(flat_like)} "
                         f"of the paths of the tree to restore into")
    leaves = []
    with np.load(d / "arrays.npz") as data:
        for key, ref in flat_like:
            i, dtype = index[key]
            arr = data[f"a{i}"]
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if dtype == "bfloat16" else torch.from_numpy(arr)
            leaves.append(t.to(device=ref.device, dtype=ref.dtype))
    return tree_unflatten(like, leaves), meta["step"], meta["extra"]
