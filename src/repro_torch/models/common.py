"""Parameter-tree conventions and initializers (twin of ``repro/models/common.py``).

Models are plain functions over nested-dict parameter trees of tensors, in the
JAX package's layouts: conv kernels HWIO ``[k, k, Cin, Cout]`` plus bias
``[Cout]``, dense ``[d_in, d_out]`` plus bias ``[d_out]``, norms ``scale``
(plus ``b``), and a stack of identical layers as one tree whose leaves lead
with the layer axis (:func:`stack_layers`).  So a JAX parameter tree converts
by ``np.asarray`` alone (:func:`params_from_jax`).  Random parameters come
from an explicit ``torch.Generator``, on its device unless ``device`` is given
(``"meta"`` gives shapes only); they are not the numbers ``jax.random`` gives
for the same seed.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

Params = Any  # nested dict/list tree of tensors


def _normal(gen: torch.Generator, shape, std: float, device=None) -> torch.Tensor:
    """``std * N(0, 1)`` in float32, on the generator's device or ``device``."""
    return std * torch.randn(shape, generator=gen, device=device or gen.device)


def trunc_normal(gen: torch.Generator, shape, std: float = 0.02, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """``std * N(0, 1)`` truncated to +-2 (``jax.random.truncated_normal(key,
    -2, 2)``), drawn in float32 by the inverse CDF of a uniform draw, then
    cast to ``dtype``."""
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(shape, generator=gen, device=device or gen.device) * (hi - lo) + lo
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp_(-2.0, 2.0)
    return (std * z).to(dtype)


def dense_params(gen: torch.Generator, d_in: int, d_out: int, bias: bool = True,
                 std: float | None = None, dtype=torch.float32, device=None) -> Params:
    """``[d_in, d_out]`` weights -- LeCun-normal, or truncated normal of ``std``
    when given -- and a zero bias unless ``bias=False``."""
    device = device or gen.device
    if std is None:
        w = _normal(gen, (d_in, d_out), math.sqrt(1.0 / max(1, d_in)), device).to(dtype)
    else:
        w = trunc_normal(gen, (d_in, d_out), std, dtype, device)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def conv_params(gen: torch.Generator, k: int, c_in: int, c_out: int, bias: bool = True, groups: int = 1,
                dtype=torch.float32, device=None) -> Params:
    """He-normal HWIO conv kernel ``[k, k, c_in / groups, c_out]`` of fan-in
    ``k * k * c_in / groups`` (``groups == c_in == c_out``: depthwise, ``[k, k,
    1, C]``) and, unless ``bias=False``, a zero bias."""
    device = device or gen.device
    fan_in = k * k * (c_in // groups)
    p = {"w": _normal(gen, (k, k, c_in // groups, c_out), math.sqrt(2.0 / max(1, fan_in)), device).to(dtype)}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=dtype, device=device)
    return p


def norm_params(dim: int, bias: bool = True, dtype=torch.float32, device="cpu") -> Params:
    """A norm's unit ``scale`` and, unless ``bias=False``, zero ``b``."""
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def stack_layers(init_one, gen: torch.Generator, n: int, device=None) -> Params:
    """``n`` layers from ``init_one(gen, device, out)`` as one tree whose
    leaves lead with the layer axis, ``[n, ...]`` -- the layout JAX's
    ``stack_layers`` (a ``vmap`` of the init) gives, so a JAX LM tree converts
    by :func:`params_from_jax`.

    Each stacked leaf is allocated once, from the shapes of a draw on the
    ``meta`` device; then each layer is drawn in turn into its slot:
    ``init_one`` gets the slot's views as ``out`` and either draws into them
    in place (an MoE layer's experts, one expert at a time:
    :func:`~repro_torch.models.moe.moe_init`) or returns fresh leaves, which
    are copied in.  So the draw holds the stack plus one layer's other leaves
    and one expert's matrix, never a second copy of a layer."""
    device = torch.device(device or gen.device)
    shapes = init_one(torch.Generator(), "meta", None)
    stacked = tree_map(lambda a: torch.empty((n,) + tuple(a.shape), dtype=a.dtype, device=device), shapes)
    if device.type == "meta":
        return stacked
    for i in range(n):
        slot = tree_map(lambda a: a[i], stacked)
        _copy_into(slot, init_one(gen, device, slot))
    return stacked


def checkpointed(remat: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) where
    ``remat`` is set and autograd records the call (grad enabled, a tensor
    of ``args`` requiring grad): its activations are dropped after the
    forward and recomputed in the backward, JAX's ``jax.checkpoint`` over a
    scanned layer.  So a kernel in ``fn`` launches twice a train step, and a
    call that records nothing (serving) runs as it is."""
    if remat and torch.is_grad_enabled() and any(t.requires_grad for t in tree_leaves(args)
                                                 if isinstance(t, torch.Tensor)):
        from torch.utils.checkpoint import checkpoint

        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def layer(stack: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree (:func:`stack_layers`), as views."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}


def _copy_into(slot: Params, layer: Params) -> None:
    """Copy a layer's leaves into its slot, except those drawn there in place."""
    if isinstance(slot, dict):
        for k in slot:
            _copy_into(slot[k], layer[k])
    elif layer.data_ptr() != slot.data_ptr():
        slot.copy_(layer)


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


def train_state_from_jax(state, device: str | torch.device = "cpu"):
    """A JAX trainer's state ``(params, opt, step)`` -- AdamW's ``mu``,
    ``nu`` and ``count`` included -- as the port's, on ``device``, so that a
    JAX run continues in the port (:func:`params_from_jax`, leaf types kept)."""
    params, opt, step = state
    return params_from_jax(params, device), params_from_jax(opt, device), params_from_jax(step, device)


def tree_map(fn, tree, *rest) -> Params:
    """Apply ``fn`` to every tensor leaf of a dict/list/tuple tree, with the
    leaves at the same place in the trees of ``rest`` as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a dict/list/tuple tree in the order :func:`tree_map`
    visits them."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves) -> Params:
    """``leaves`` (in :func:`tree_leaves` order) in the structure of ``like``."""
    leaves, n = list(leaves), len(tree_leaves(like))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a tree of {n}")
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
