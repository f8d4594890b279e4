"""Step builders (twin of the serving half of ``repro/configs/steps.py``):
(arch, cell) -> step function + the shapes and types of its inputs.

JAX's builder returns abstract pytrees (``jax.eval_shape``) for its dry-run;
the port has no dry-run, so its bundle holds ``(shape, dtype)`` pairs, taken
from an init on the ``meta`` device.  The LM ``prefill`` and ``decode`` kinds
and the vision ``serve`` kind are ported; training and the diffusion family
raise (``ROADMAP.md`` queues them).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..models import transformer_lm as lm
from ..models.common import tree_map
from .base import Arch, Cell

__all__ = ["StepBundle", "build", "abstract_params"]


@dataclass
class StepBundle:
    """One (arch, cell): the step, and the shapes its arguments take."""

    fn: Callable  # fn(params, *inputs)
    state: Any  # the parameters as a tree of (shape, dtype)
    inputs: dict[str, Any]  # name -> (shape, dtype), or a tree of them (a KV or latent cache)
    kind: str


def _spec(t: torch.Tensor) -> tuple[tuple[int, ...], torch.dtype]:
    return tuple(t.shape), t.dtype


def abstract_params(arch: Arch, cfg, dtype) -> Any:
    return tree_map(_spec, arch.module.init(torch.Generator(), cfg, dtype, device="meta"))


def _lm_prefill(arch: Arch, cfg, cell: Cell, dtype) -> StepBundle:
    def step(params, tokens):
        logits, _ = lm.forward(params, cfg, tokens)
        return logits

    b, s = cell.meta["global_batch"], cell.meta["seq_len"]
    return StepBundle(fn=step, state=abstract_params(arch, cfg, dtype),
                      inputs={"tokens": ((b, s), torch.int32)}, kind="prefill")


def _lm_decode(arch: Arch, cfg, cell: Cell, dtype) -> StepBundle:
    b, s = cell.meta["global_batch"], cell.meta["seq_len"]

    def step(params, cache, tokens, index):
        return lm.decode_step(params, cfg, cache, tokens, index)

    cache = tree_map(_spec, lm.init_cache(cfg, b, s, dtype, device="meta"))
    return StepBundle(fn=step, state=abstract_params(arch, cfg, dtype),
                      inputs={"cache": cache, "tokens": ((b, 1), torch.int32), "index": ((), torch.int32)},
                      kind="decode")


def _adapt_vision_cfg(arch: Arch, cfg, img_res: int):
    cfg = dataclasses.replace(cfg, img_res=img_res)
    if arch.family == "vision" and hasattr(cfg, "window") and img_res == 384:
        # Swin finetunes at 384 with window 12 (arXiv:2103.14030 §4.1)
        cfg = dataclasses.replace(cfg, window=12)
    return cfg


def _vision_serve(arch: Arch, cfg, cell: Cell, dtype) -> StepBundle:
    cfg = _adapt_vision_cfg(arch, cfg, cell.meta["img_res"])

    def step(params, images):
        return arch.module.apply(params, cfg, images)

    b, r = cell.meta["batch"], cell.meta["img_res"]
    return StepBundle(fn=step, state=abstract_params(arch, cfg, dtype),
                      inputs={"images": ((b, r, r, 3), dtype)}, kind="serve")


_BUILDERS = {
    ("lm", "prefill"): _lm_prefill,
    ("lm", "decode"): _lm_decode,
    ("vision", "serve"): _vision_serve,
}


def build(arch: Arch, cell_name: str, *, smoke: bool = False, dtype=None) -> StepBundle:
    cell = arch.cells[cell_name]
    if cell.skip:
        raise ValueError(f"{arch.name}/{cell_name} is skipped: {cell.skip}")
    if (arch.family, cell.kind) not in _BUILDERS:
        raise NotImplementedError(f"{arch.name}/{cell_name}: the {arch.family} {cell.kind} step is not "
                                  f"ported to repro_torch yet (queued in ROADMAP.md)")
    cfg = arch.smoke_cfg if smoke else arch.cfg
    if smoke:
        cell = _shrink(cell)
    if dtype is None:
        dtype = torch.float32 if smoke else torch.bfloat16
    return _BUILDERS[(arch.family, cell.kind)](arch, cfg, cell, dtype)


def _shrink(cell: Cell) -> Cell:
    m = dict(cell.meta)
    if "seq_len" in m:
        m["seq_len"] = 128 if cell.kind == "decode" else 64
    for k, v in (("global_batch", 2), ("batch", 2), ("steps", 2)):
        if k in m:
            m[k] = min(m[k], v)
    if "img_res" in m:
        m["img_res"] = 64
    return Cell(cell.name, cell.kind, m, None)
