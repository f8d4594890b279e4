"""Named config variants (twin of ``repro/parallel/variants.py``).

A variant is a set of small, orthogonal overrides consulted by the step
builders; one is active per process, selected with :func:`set_variant` or
the ``REPRO_VARIANT`` environment variable.  The port keeps the JAX
package's table field for field.  The sharding rules
(:mod:`.sharding`) read ``lm_fsdp_small``, ``embed_vocab_shard``,
``replicate_lm_head``, ``gather_experts`` and ``diffusion_spatial2d``; the
dry run (``launch.dryrun``) installs the ``lm_residual`` hint under
``seq_shard_activations`` / ``constrain_residual``; the step builders read
``diffusion_spatial2d`` (``configs.steps._diffusion_gen``: the U-Net serves
with ``attn_f32=False``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = ["Variant", "get_variant", "set_variant", "VARIANTS"]


@dataclass(frozen=True)
class Variant:
    name: str
    # sharding knobs
    lm_fsdp_small: bool = False  # FSDP also for the small/dense LMs
    constrain_residual: bool = False  # pin [B,S,D] residual: batch over dp
    seq_shard_activations: bool = False  # constrain [B,S,D] acts: S over model
    embed_vocab_shard: bool = False  # embed: shard vocab (not d_model)
    replicate_lm_head: bool = False
    gather_experts: bool = False  # EP off: replicate experts (ablation)
    # step knobs
    no_remat: bool = False
    q_chunk: int | None = None  # chunked-attention block override
    diffusion_spatial2d: bool = False  # 2-D spatial shard for gen; no conv TP
    notes: str = ""


VARIANTS: dict[str, Variant] = {
    "base": Variant("base"),
    "seq_shard": Variant(
        "seq_shard",
        seq_shard_activations=True,
        notes="sequence-parallel activation constraints between TP blocks",
    ),
    "vocab_shard": Variant(
        "vocab_shard",
        embed_vocab_shard=True,
        notes="embedding sharded over vocab instead of d_model",
    ),
    "fsdp_all": Variant(
        "fsdp_all", lm_fsdp_small=True, notes="ZeRO-3 for every LM arch"
    ),
    "no_remat": Variant("no_remat", no_remat=True, notes="disable activation ckpt"),
    "ep_off": Variant("ep_off", gather_experts=True, notes="ablate expert parallelism"),
    # code-level improvements land in `opt` so the baseline records survive
    "opt": Variant(
        "opt",
        constrain_residual=True,
        notes="sort-based MoE dispatch + carry-derived attention masks + bf16 "
        "cotangents (f32 cast inside the loss) + rematted attention chunks + "
        "residual-stream sharding constraint (batch x dp)",
    ),
    "spatial2d": Variant(
        "spatial2d",
        diffusion_spatial2d=True,
        notes="diffusion gen: 2-D spatial sharding (H x data, W x model), "
        "replicated conv params -- the paper's partitioning instead of TP",
    ),
}

_ACTIVE = VARIANTS["base"]


def set_variant(name: str) -> Variant:
    global _ACTIVE
    _ACTIVE = VARIANTS[name]
    return _ACTIVE


def get_variant() -> Variant:
    env = os.environ.get("REPRO_VARIANT")
    if env and env != _ACTIVE.name and env in VARIANTS:
        set_variant(env)
    return _ACTIVE
