"""PyTorch/CUDA port of the HALP reproduction, for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its names
and layout (``core``, ``models``, ``kernels``, ``spatial``, ``runtime``,
``launch``) and keeps its public layouts: NHWC activations, HWIO conv weights
and nested-dict params.  It imports ``torch`` and never ``jax`` or any module
of ``repro``: what it needs of the planner is copied into ``repro_torch.core``.

Entry points run on the card unless the caller passes ``device="cpu"``; on a
CPU tensor every kernel wrapper takes its plain PyTorch version, on a CUDA
tensor it launches the hand-written kernel or raises.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: ``"cuda"`` (the default) or ``"cpu"``.

    Raises when CUDA is asked for and absent, so a run without a card never
    carries on quietly on the CPU; the CPU is used only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
