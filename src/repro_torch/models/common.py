"""Parameter-tree conventions and initializers (twin of ``repro/models/common.py``).

Models are plain functions over nested-dict parameter trees of tensors, in the
JAX package's layouts: conv kernels HWIO ``[k, k, Cin, Cout]`` plus bias
``[Cout]``, dense ``[d_in, d_out]`` plus bias ``[d_out]``.  So a JAX parameter
tree converts by ``np.asarray`` alone (:func:`params_from_jax`).  Random
parameters come from an explicit ``torch.Generator``; they are not the numbers
``jax.random`` gives for the same seed.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

Params = Any  # nested dict/list tree of tensors


def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    """``std * N(0, 1)`` in float32 on the generator's device."""
    return std * torch.randn(shape, generator=gen, device=gen.device)


def dense_params(gen: torch.Generator, d_in: int, d_out: int) -> Params:
    """LeCun-normal float32 ``[d_in, d_out]`` weights and zero bias."""
    return {"w": _normal(gen, (d_in, d_out), math.sqrt(1.0 / max(1, d_in))),
            "b": torch.zeros((d_out,), device=gen.device)}


def conv_params(gen: torch.Generator, k: int, c_in: int, c_out: int) -> Params:
    """He-normal float32 HWIO conv kernel and zero bias."""
    return {"w": _normal(gen, (k, k, c_in, c_out), math.sqrt(2.0 / max(1, k * k * c_in))),
            "b": torch.zeros((c_out,), device=gen.device)}


def params_from_jax(tree, device: str | torch.device = "cpu",
                    dtype: torch.dtype | None = None) -> Params:
    """The JAX package's nested dict/list tree of arrays as tensors on ``device``.

    Layouts are shared, so each leaf is ``np.asarray`` + ``torch.from_numpy``;
    bfloat16 leaves (numpy has no such type) go through float32, which holds
    every bfloat16 value exactly.  The leaves are copied (JAX's buffers are
    read-only).  ``dtype`` casts every leaf when given."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def tree_map(fn, tree) -> Params:
    """Apply ``fn`` to every tensor leaf of a dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
