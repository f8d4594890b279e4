"""Arch registry (twin of ``repro/configs/base.py``): each architecture the
port runs is a selectable config with its full config, a reduced smoke config
and one :class:`Cell` per assigned input shape.  :mod:`.steps` builds the step
function and the input shapes for an (arch, cell).  Every architecture of
the JAX package is registered; the kinds of step not ported yet raise in
:mod:`.steps` (``ROADMAP.md`` queues them).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

__all__ = ["Cell", "Arch", "REGISTRY", "register", "get", "list_archs", "lm_cells", "vision_cells",
           "diffusion_cells"]


@dataclass(frozen=True)
class Cell:
    """One assigned (architecture x input shape) cell."""

    name: str
    kind: str  # "train" | "prefill" | "decode" | "gen" | "serve"
    meta: dict = field(default_factory=dict)  # batch, seq_len, img_res, steps...
    skip: str | None = None  # reason if the cell is inapplicable (recorded)


@dataclass(frozen=True)
class Arch:
    name: str
    family: str  # "lm" | "vision" | "diffusion" | "convnet"
    cfg: Any
    smoke_cfg: Any
    cells: dict[str, Cell]
    module: Any  # the model module (init/forward/...)
    notes: str = ""


REGISTRY: dict[str, Arch] = {}


def register(arch: Arch) -> Arch:
    REGISTRY[arch.name] = arch
    return arch


def get(name: str) -> Arch:
    if name not in REGISTRY:
        from . import _load_all

        _load_all()
    if name not in REGISTRY:
        raise KeyError(f"{name!r} is not ported to repro_torch (registered: {sorted(REGISTRY)}; "
                       f"the queue is in ROADMAP.md)")
    return REGISTRY[name]


def list_archs() -> list[str]:
    from . import _load_all

    _load_all()
    return sorted(REGISTRY)


# The assigned LM shape set (shared by the LM archs).
def lm_cells(*, full_attention: bool) -> dict[str, Cell]:
    return {
        "train_4k": Cell("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
        "prefill_32k": Cell("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
        "decode_32k": Cell("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
        "long_500k": Cell(
            "long_500k",
            "decode",
            {"seq_len": 524288, "global_batch": 1},
            skip=(
                "full-attention architecture; long_500k requires sub-quadratic "
                "attention per the assignment (skip recorded in DESIGN.md)"
                if full_attention
                else None
            ),
        ),
    }


# The assigned vision shape set (shared by the vision archs).
def vision_cells() -> dict[str, Cell]:
    return {
        "cls_224": Cell("cls_224", "train", {"img_res": 224, "batch": 256}),
        "cls_384": Cell("cls_384", "train", {"img_res": 384, "batch": 64}),
        "serve_b1": Cell("serve_b1", "serve", {"img_res": 224, "batch": 1}),
        "serve_b128": Cell("serve_b128", "serve", {"img_res": 224, "batch": 128}),
    }


# The assigned diffusion shape set (shared by the diffusion archs).
def diffusion_cells() -> dict[str, Cell]:
    return {
        "train_256": Cell("train_256", "train", {"img_res": 256, "batch": 256, "steps": 1000}),
        "gen_1024": Cell("gen_1024", "gen", {"img_res": 1024, "batch": 4, "steps": 50}),
        "gen_fast": Cell("gen_fast", "gen", {"img_res": 512, "batch": 16, "steps": 4}),
        "train_1024": Cell("train_1024", "train", {"img_res": 1024, "batch": 32, "steps": 1000}),
    }
