"""Parameter / input sharding rules and the spatial engine's input layout
(twin of ``repro/parallel/sharding.py``).

Rules are (path-regex, spec) pairs matched against ``a/b/c`` tree paths;
specs are axis-name tuples where the special token ``"fsdp"`` resolves to the
mesh's data axes (ZeRO-3 parameter sharding, enabled for the large LM
configs) and silently drops to replication when a dimension is not
divisible.  Stacked layer trees (leading layer axis) are handled by
left-padding specs with None when the leaf rank exceeds the spec rank.

A leaf's sharding is a :class:`Sharding`: a :class:`~..launch.mesh.Mesh`
value and a spec in JAX's form, one entry per dimension, each None, an axis
name or a tuple of names.  Trees are the port's nested dicts of
``(shape, dtype)`` (``configs.steps.StepBundle``); the port's dicts keep
their insertion order where JAX's are sorted, so compare two trees by leaf
path (:func:`named_shardings`), never by position.

Input sharding is per (family, cell kind) with two deliberate SP cases, the
paper's technique deployed through the mesh:

* vision ``serve_b1``       -- image *height* sharded (spatial partitioning),
* diffusion ``gen_1024``    -- latent height sharded across ``data``.

The spatial engine's own layout is :func:`weighted_spatial_inputs`: the
JAX package places one global array with a ``NamedSharding`` over the height
axis (``spatial_shardings``); here the list of local shards, each on the
comm's device, is that placement, so ``spatial_shardings`` has no
counterpart of its own.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

import torch

from ..configs.base import Arch, Cell
from ..launch.mesh import Mesh, dp_axes, fsdp_axes
from ..spatial.comm import Comm
from ..spatial.halo import plan_shard_heights, to_padded_shards

__all__ = [
    "Sharding",
    "param_shardings",
    "input_shardings",
    "state_shardings",
    "shard_rules",
    "named_shardings",
    "shard_bytes",
    "sharded_bytes",
    "weighted_spatial_inputs",
]

M = "model"


@dataclass(frozen=True)
class Sharding:
    """``spec`` over ``mesh``: entry ``i`` names the mesh axes (None, a name
    or a tuple of names) that split dimension ``i``; missing trailing
    entries replicate (JAX's ``NamedSharding(mesh, PartitionSpec(*spec))``)."""

    mesh: Mesh
    spec: tuple = ()

    def shard_shape(self, shape) -> tuple[int, ...]:
        """One device's block of an array of ``shape``; raises where a split
        dimension does not divide, as ``NamedSharding.shard_shape``."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the rank of {shape}")
        out = []
        for i, dim in enumerate(shape):
            n = _axis_size(self.mesh, self.spec[i]) if i < len(self.spec) else 1
            if dim % n:
                raise ValueError(f"sharding {self.spec} splits axis {i} of {shape} {n} ways: "
                                 f"{dim} does not divide")
            out.append(dim // n)
        return tuple(out)


def _lm_rules(big: bool):
    from .variants import get_variant

    v = get_variant()
    big = big or v.lm_fsdp_small
    fs = "fsdp" if big else None
    embed = (M, fs) if v.embed_vocab_shard else (fs, M)
    head = (None, None) if v.replicate_lm_head else (fs, M)
    if v.gather_experts:
        return [
            (r"embed$", embed),
            (r"lm_head/w$", head),
            (r"(wq|wk|wv|wqkv)/w$", (fs, M)),
            (r"wo/w$", (M, fs)),
            (r"(wdq|wuq|wdkv|wukv|wkr)/w$", (fs, M)),
            (r"ffn/(w1|w3)/w$", (fs, M)),
            (r"ffn/w2/w$", (M, fs)),
            (r"experts/", (None, None, None)),
            (r"router/w$", (None, None)),
        ]
    return [
        (r"embed$", embed),
        (r"lm_head/w$", head),
        (r"(wq|wk|wv|wqkv)/w$", (fs, M)),
        (r"wo/w$", (M, fs)),
        (r"(wdq|wuq|wdkv|wukv|wkr)/w$", (fs, M)),
        (r"ffn/(w1|w3)/w$", (fs, M)),
        (r"ffn/w2/w$", (M, fs)),
        (r"shared/(w1|w3)/w$", (fs, M)),
        (r"shared/w2/w$", (M, fs)),
        (r"experts/(w1|w3)$", (M, "fsdp" if big else None, None)),
        (r"experts/w2$", (M, None, "fsdp" if big else None)),
        (r"mtp/proj/w$", (fs, M)),
        (r"router/w$", (None, None)),
    ]


def _vision_rules():
    return [
        (r"(patch_embed|stem)/w$", (None, None, None, M)),
        (r"(wqkv|fc1|pw1)/w$", (None, M)),
        (r"(wo|fc2|pw2)/w$", (M, None)),
        (r"head/w$", (None, M)),
        (r"merge/w$", (None, M)),
        (r"(expand|project|head_conv|dw|down)/w$", (None, None, None, M)),
        (r"(se_reduce|se_expand|fc)/w$", (None, M)),
    ]


def _diffusion_rules():
    return [
        (r"(fc1|ff1|wqkv|sq|sk|sv|cq|ck|cv|t_mlp1|t1|proj_in)/w$", (None, M)),
        (r"(fc2|ff2|wo|so|co|t_mlp2|t2|proj_out)/w$", (M, None)),
        (r"ada/w$", (None, M)),
        (r"final_ada/w$", (None, M)),
        (r"(c1|c2|conv_in|conv_out|downsample|upsample|skip)/w$", (None, None, None, M)),
        (r"temb/w$", (None, M)),
        (r"(patch_embed)/w$", (None, None, None, M)),
        (r"final/w$", (None, M)),
        (r"label_embed$", (None, M)),
    ]


def shard_rules(arch: Arch):
    from .variants import get_variant

    if arch.family == "lm":
        big = arch.name.startswith(("deepseek", "moonshot"))
        return _lm_rules(big)
    if arch.family == "vision":
        return _vision_rules()
    if arch.family == "diffusion":
        if get_variant().diffusion_spatial2d:
            return []  # replicate params; parallelism is purely spatial
        return _diffusion_rules()
    return []


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.dtype)


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, (shape, dtype))`` at every leaf of a dict/list/tuple tree
    of ``(shape, dtype)`` pairs, in the tree's structure; ``path`` holds the
    dict keys and sequence indices down to the leaf."""
    if _is_spec(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _axis_size(mesh: Mesh, token) -> int:
    if token is None:
        return 1
    if isinstance(token, tuple):
        n = 1
        for a in token:
            n *= mesh.shape[a]
        return n
    return mesh.shape[token]


def _resolve(spec_tokens, mesh: Mesh, shape) -> tuple:
    """Map rule tokens onto the mesh, dropping non-divisible entries, and
    left-pad with None for stacked (layer) leading axes."""
    fs = fsdp_axes(mesh)
    tokens = []
    for t in spec_tokens:
        if t == "fsdp":
            t = fs if len(fs) > 1 else fs[0]
        tokens.append(t)
    if len(tokens) < len(shape):
        tokens = [None] * (len(shape) - len(tokens)) + tokens
    tokens = tokens[: len(shape)]
    out = []
    for dim, t in zip(shape, tokens):
        if t is not None and dim % _axis_size(mesh, t) == 0:
            out.append(t)
        else:
            out.append(None)
    return tuple(out)


def param_shardings(abstract_params, arch: Arch, mesh: Mesh):
    """A :class:`Sharding` for each leaf of a parameter tree of (shape, dtype)."""
    rules = [(re.compile(rx), spec) for rx, spec in shard_rules(arch)]

    def assign(path, leaf):
        ps = _path_str(path)
        for rx, spec in rules:
            if rx.search(ps):
                return Sharding(mesh, _resolve(spec, mesh, leaf[0]))
        return Sharding(mesh, ())

    return _map_with_path(assign, abstract_params)


def state_shardings(abstract_state, arch: Arch, mesh: Mesh):
    """(params, opt, step): moments follow the parameter sharding."""
    params_abs, opt_abs, _ = abstract_state
    p_sh = param_shardings(params_abs, arch, mesh)
    opt_sh = {"mu": p_sh, "nu": p_sh, "count": Sharding(mesh, ())}
    return (p_sh, opt_sh, Sharding(mesh, ()))


def _dp(mesh: Mesh) -> Any:
    d = dp_axes(mesh)
    return d if len(d) > 1 else d[0]


def input_shardings(bundle_inputs, arch: Arch, cell: Cell, mesh: Mesh):
    """Per-input :class:`Sharding`s for one (arch, cell) bundle (a tree of
    them for a cache)."""
    from .variants import get_variant

    dp = _dp(mesh)
    multi = "pod" in mesh.axis_names
    out = {}
    for name, spec in bundle_inputs.items():
        shape = spec[0] if _is_spec(spec) else None
        if name == "images" and "sp" in mesh.axis_names:
            # dedicated spatial mesh: height over "sp"
            sh = Sharding(mesh, (None, "sp", None, None))
        elif name in ("tokens", "labels") and arch.family == "lm":
            b = shape[0]
            tok = dp if b % _axis_size(mesh, dp) == 0 else "data"
            sh = Sharding(mesh, (tok, *([None] * (len(shape) - 1))))
        elif name == "cache":
            sh = _map_with_path(lambda _, s: Sharding(mesh, _cache_spec(s[0], mesh)), spec)
        elif name == "index":
            sh = Sharding(mesh, ())
        elif name in ("images",):
            b, r = shape[0], shape[1]
            if b == 1:  # serve_b1: the paper's SP -- shard the height axis
                ax = dp if r % _axis_size(mesh, dp) == 0 else "data"
                sh = Sharding(mesh, (None, ax, None, None))
            elif b % _axis_size(mesh, dp) == 0:
                sh = Sharding(mesh, (dp, None, None, None))
            else:
                sh = Sharding(mesh, ("data", None, None, None))
        elif name in ("latents", "noise"):
            b, r = shape[0], shape[1]
            if get_variant().diffusion_spatial2d and cell.kind == "gen":
                # the paper's technique in 2-D: H over data, W over model
                sh = Sharding(mesh, (None, "data", "model", None))
            elif b % _axis_size(mesh, dp) == 0:
                sh = Sharding(mesh, (dp, None, None, None))
            elif multi and b % mesh.shape["pod"] == 0 and r % mesh.shape["data"] == 0:
                sh = Sharding(mesh, ("pod", "data", None, None))
            elif b % mesh.shape["data"] == 0:
                sh = Sharding(mesh, ("data", None, None, None))
            else:  # small-batch gen: spatial sharding of the latent height
                sh = Sharding(mesh, (None, "data", None, None))
        elif name in ("t", "cond", "ctx"):
            b = shape[0]
            ax = dp if b % _axis_size(mesh, dp) == 0 else ("data" if b % mesh.shape["data"] == 0 else None)
            sh = Sharding(mesh, (ax, *([None] * (len(shape) - 1))))
        else:
            b = shape[0] if shape else None
            ax = dp if b and b % _axis_size(mesh, dp) == 0 else None
            sh = Sharding(mesh, (ax, *([None] * max(0, len(shape) - 1))) if shape else ())
        out[name] = sh
    return out


def _cache_spec(shape, mesh: Mesh) -> tuple:
    """KV caches: [L, B, S, H, dh] -> batch over data, SEQUENCE over model
    (distributed-softmax decode attention: per-shard logits stay local).
    MLA latent caches: [L, B, S, R] -> same layout."""
    dp = _dp(mesh)
    b = shape[1]
    bt = dp if b % _axis_size(mesh, dp) == 0 else (
        "data" if b % mesh.shape["data"] == 0 else None
    )
    s_ax = M if shape[2] % mesh.shape[M] == 0 else None
    if len(shape) == 5:
        return (None, bt, s_ax, None, None)
    if len(shape) == 4:
        return (None, bt, s_ax, None)
    return ()


def named_shardings(shardings, specs) -> dict:
    """``path -> (Sharding, (shape, dtype))`` over a tree of shardings and
    the same tree of specs, paths built as ``_path_str``."""
    out = {}

    def walk(sh, sp, path):
        if isinstance(sh, Sharding):
            out[_path_str(path)] = sh, sp
            return
        for k, v in (sh.items() if isinstance(sh, dict) else enumerate(sh)):
            walk(v, sp[k], path + (k,))

    walk(shardings, specs, ())
    return out


def shard_bytes(shardings, specs) -> list[int]:
    """One device's bytes of each leaf of a tree of ``(shape, dtype)`` laid
    out by ``shardings`` (the same tree of :class:`Sharding`): the shard
    shape's elements times the item size."""
    out = []
    for sh, (shape, dtype) in named_shardings(shardings, specs).values():
        n = dtype.itemsize
        for d in sh.shard_shape(shape):
            n *= d
        out.append(n)
    return out


def sharded_bytes(shardings, specs) -> int:
    """One device's bytes of the whole tree (:func:`shard_bytes` summed)."""
    return sum(shard_bytes(shardings, specs))


def weighted_spatial_inputs(
    x: torch.Tensor, plan_or_heights, comm: Comm, *, align: int = 1
) -> tuple[list[torch.Tensor], tuple[int, ...]]:
    """Lay a global image batch out for the capacity-weighted spatial engine.

    ``plan_or_heights`` is an N-way ``plan_even(ratios=...)`` plan (its
    first-layer row shares become the shard heights, re-quantised to
    ``align``: pass ``spatial_alignment(net)``) or explicit heights.  Returns
    ``(shards, heights)``: the padded blocks this process holds (``comm``'s
    indices), on ``comm.device``, which ``conv2d_spatial(heights=...)`` and
    ``max_pool_spatial(heights=...)`` take.  Equal heights give the plain
    equal split, which the unweighted ops take as well."""
    if hasattr(plan_or_heights, "parts"):
        heights = plan_shard_heights(plan_or_heights, align)
    else:
        heights = tuple(int(h) for h in plan_or_heights)
    if len(heights) != comm.n:
        raise ValueError(f"{len(heights)} shard heights for {comm.n} shards")
    blocks = to_padded_shards(x, heights)
    return [blocks[j].to(comm.device) for j in comm.indices], heights
