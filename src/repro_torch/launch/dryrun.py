"""Production-mesh dry run (twin of ``repro/launch/dryrun.py``): every
(architecture x input shape) laid out on the production meshes by the
sharding rules, its step run once on ``meta`` tensors, and its per-device
memory and its costs recorded.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --cell train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all             # single pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod # two pods

JAX lowers and compiles each cell for 256 / 512 forced host devices and
reads XLA's analyses.  Here the step runs eagerly on ``meta`` tensors built
from the bundle's (shape, dtype) trees, through the kernels' shape route
(their argument checks, then an empty output: a shape a kernel refuses fails
the cell), under :func:`~.op_cost.counting`.  The record keeps JAX's keys
where the port computes the same quantity:

* ``memory.argument_size_in_bytes`` / ``output_size_in_bytes``: one
  device's bytes of the arguments (state and inputs) and outputs, exact
  from the shardings (the outputs' follow :func:`_out_shardings`);
  ``argument_allocated_bytes`` the same with each leaf rounded up to the
  caching allocator's 512-byte blocks;
* ``cost.flops`` / ``bytes_accessed``: :mod:`.op_cost`'s eager count of the
  unsharded step;
* ``peak_live_bytes``: the peak of live tensor bytes over the unsharded
  step (not XLA's per-device ``temp_size_in_bytes``);
* ``kernels``: K1 / K1 dgrad / K2 / K3 call signatures with their counts;
  ``trace_s``: the seconds the meta run took.

A second pass counts the collectives (:func:`collective_pass`): the state
and inputs become ``meta`` DTensors laid out by the same shardings on the
mesh (``parallel.placements``, a fake process group of ``mesh.size`` ranks,
rank 0's view), the step runs once as DTensors under
:func:`~.collectives.counting` with the kernels' sharding rules in place
(``parallel.kernel_rules``), ``hints.constrain`` redistributes to its rule,
the gradients go to their parameters' sharding before the optimizer (JAX's
gradient all-reduce or reduce-scatter) and the outputs to
:func:`_out_shardings` (``jit``'s ``out_shardings``):

* ``collectives``: JAX's five kinds' result bytes on one device, ``total``
  and ``counts``, per step with every layer counted (JAX's
  ``hlo_cost.per_collective``); ``collective_trace_s`` the pass's seconds;
* ``replicated_ops``: operators DTensor has no strategy for, views it
  cannot take of an uneven or strided split, and those that index the whole
  tensor (the MoE dispatch), run replicated after a counted all-gather,
  with their calls;
* ``kernel_collectives``: the collectives the kernels' rules issued, by
  kernel call signature (calls, and kind -> [calls, bytes]);
  ``halo_gathered``: the halo-ruled convs that all-gathered H instead, and
  why;
* ``estimated_costs``: how many of DTensor's strategy costs were estimated
  for strided shards instead of searched (:func:`_strided_costs`): where it
  is not 0, the strategies picked, and so the bytes, rest on the estimate.

A one-device mesh moves nothing: its ``collectives`` are all 0, with no
pass run.

DTensor's partitioner is not GSPMD: where the two choose differently the
bytes differ (ROADMAP.md §3).  Records go to ``build/dryrun_torch/``
(ignored by git).  A decode cell runs at the last
position of its cache (``decode_index``), where its
attention reads every cached key, as JAX's masked decode does at any
position.  The tool launches nothing and takes no ``--device``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from ..configs import get, list_archs
from ..configs.base import Arch
from ..configs.steps import _is_spec, _zeros, build
from ..parallel import hints, kernel_rules, placements
from ..parallel.sharding import (Sharding, input_shardings, param_shardings, shard_bytes, sharded_bytes,
                                 state_shardings)
from ..parallel.variants import get_variant, set_variant
from . import collectives
from .mesh import Mesh, dp_axes, make_production_mesh
from .op_cost import counting

__all__ = ["run_cell", "record_cell", "collective_pass", "save", "main", "RESULTS_DIR"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"
ALLOC_BLOCK = 512  # the caching allocator's block granularity, bytes


def _spec_of(tree):
    """(shape, dtype) at every tensor leaf of an output tree."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, dict):
        return {k: _spec_of(v) for k, v in tree.items()}
    return type(tree)(_spec_of(v) for v in tree)


def _map_specs(fn, tree):
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return type(tree)(_map_specs(fn, v) for v in tree)


def _out_shardings(kind: str, out_specs, mesh: Mesh, state_sh, in_sh):
    """The outputs' shardings, as JAX's dry run pins them: a train step's
    state as its input state, metrics replicated; prefill logits vocabulary
    over ``model``; decode logits likewise and the cache as it came in; a
    sampler's latents as its input; served logits replicated."""
    def rep(_):
        return Sharding(mesh, ())

    if kind == "train":
        return state_sh, _map_specs(rep, out_specs[1])
    if kind == "prefill":
        return Sharding(mesh, (None, None, "model"))
    if kind == "decode":
        return Sharding(mesh, (None, "model")), in_sh["cache"]
    if kind == "gen":
        return in_sh["latents"]
    return Sharding(mesh, ())


def _allocated(shardings, specs) -> int:
    """:func:`sharded_bytes` with each leaf rounded up to ``ALLOC_BLOCK``."""
    return sum(max(ALLOC_BLOCK, -(-n // ALLOC_BLOCK) * ALLOC_BLOCK) for n in shard_bytes(shardings, specs))


def _install_hints(mesh: Mesh) -> None:
    """The activation rules of the active variant, as JAX's ``run_cell``
    installs them (``lm_residual``: sequence over ``model`` under
    ``seq_shard``, batch over the data axes under ``opt``)."""
    v = get_variant()
    dp = dp_axes(mesh)
    dpx = dp if len(dp) > 1 else dp[0]
    if v.seq_shard_activations:
        hints.set_rules({"lm_residual": Sharding(mesh, (dpx, "model", None))})
    elif v.constrain_residual:
        hints.set_rules({"lm_residual": Sharding(mesh, (dpx, None, None))})
    else:
        hints.clear_rules()


def _distributed(tree, shardings, dmesh):
    """A tree of ``(shape, dtype)`` specs as ``meta`` DTensors laid out by
    the same tree of shardings."""
    if isinstance(shardings, Sharding):
        return placements.distribute(torch.zeros(tree[0], dtype=tree[1], device="meta"), shardings, dmesh)
    if isinstance(tree, dict):
        return {k: _distributed(v, shardings[k], dmesh) for k, v in tree.items()}
    return type(tree)(_distributed(v, s, dmesh) for v, s in zip(tree, shardings))


def _placed(tree, shardings):
    """Each DTensor leaf of ``tree`` redistributed to its sharding (a plain
    leaf as it is)."""
    from torch.distributed.tensor import DTensor

    if isinstance(shardings, Sharding):
        if not isinstance(tree, DTensor):
            return tree
        return tree.redistribute(tree.device_mesh, placements.placements(shardings))
    if isinstance(tree, dict):
        return {k: _placed(v, shardings[k]) for k, v in tree.items()}
    return type(tree)(_placed(v, s) for v, s in zip(tree, shardings))


@contextlib.contextmanager
def _gradients_to_state(dmesh):
    """The train steps' optimizer (``configs.steps.adamw_update``) takes each
    gradient redistributed to its parameter's placements first, one
    reduction a leaf, and updates each leaf whole (its slices are the card's
    memory device and give the same bits; slicing a sharded leading axis
    would make DTensor gather it)."""
    from torch.distributed.tensor import DTensor

    from ..configs import steps
    from ..models.common import tree_map
    from ..optim import adamw

    real, chunk = steps.adamw_update, adamw.CHUNK

    def update(grads, opt, params, *args, **kw):
        grads = tree_map(lambda g, p: g.redistribute(dmesh, p.placements)
                         if isinstance(g, DTensor) and isinstance(p, DTensor) else g, grads, params)
        return real(grads, opt, params, *args, **kw)

    steps.adamw_update, adamw.CHUNK = update, float("inf")
    try:
        yield
    finally:
        steps.adamw_update, adamw.CHUNK = real, chunk


@contextlib.contextmanager
def _mask_broadcast():
    """DTensor's masked partial (a gather or an embedding over a sharded
    dim) zeroes its masked entries at the reduction with a mask of the
    gather's output shape; a squeeze between the two (``softmax_xent``'s
    gold logits) leaves the mask a dim too many and the reduction fails.
    While entered the mask is reshaped to the reduced tensor where the
    elements agree, or broadcast along its trailing dims (the embedding's
    case), and applied by ``masked_fill_``."""
    from torch.distributed.tensor._ops._mask_buffer import MaskBuffer

    real = MaskBuffer.apply_mask

    def apply_mask(self, tensor):
        if self.refcount == 0 or self.data is None:
            raise RuntimeError("MaskBuffer has not been materialized")
        mask = self.data
        if mask.ndim > tensor.ndim and mask.numel() == tensor.numel():
            mask = mask.reshape(tensor.shape)
        mask = mask.reshape(tuple(mask.shape) + (1,) * (tensor.ndim - mask.ndim))
        tensor.masked_fill_(mask, 0.0)

    MaskBuffer.apply_mask = apply_mask
    try:
        yield
    finally:
        MaskBuffer.apply_mask = real


@contextlib.contextmanager
def _strided_costs(coll: collectives.Collectives):
    """DTensor ranks an operator's candidate strategies by the cost of
    redistributing its operands to each.  Where a spec carries a strided
    shard (a view of a dim split over several mesh dims), that cost runs a
    graph search, 0.1-0.4 s a candidate on a three-axis mesh, dozens a call.
    While entered such a cost is estimated instead, and counted in
    ``coll.estimated_costs``: one collective of the device's bytes for each
    mesh dim whose placement changes, and no way into a ``Partial`` from a
    shard or another ``Partial``, as DTensor's own cost bans it.  The
    redistribution that runs is still DTensor's own."""
    from torch.distributed.tensor import _utils
    from torch.distributed.tensor._ops import utils as op_utils
    from torch.distributed.tensor.placement_types import _StridedShard

    real = op_utils.redistribute_cost

    def cost(current, target):
        strided = any(isinstance(p, _StridedShard) for p in (*current.placements, *target.placements))
        if not strided or current.mesh != target.mesh:
            return real(current, target)
        coll.estimated_costs += 1
        pairs = list(zip(current.placements, target.placements))
        if any(b.is_partial() and a != b and not a.is_replicate() for a, b in pairs):
            return float("inf")
        steps = sum(a != b for a, b in pairs)
        nbytes = current.tensor_meta.dtype.itemsize * current.tensor_meta.shape.numel() / current.num_shards
        return steps * nbytes / 2**30

    op_utils.redistribute_cost = _utils.redistribute_cost = cost
    try:
        yield
    finally:
        op_utils.redistribute_cost = _utils.redistribute_cost = real


def collective_pass(bundle, mesh: Mesh, state_sh, in_sh, out_sh, decode_index: int | None = None,
                    calls: list | None = None) -> collectives.Collectives:
    """The step of ``bundle`` once as ``meta`` DTensors on ``mesh`` (the
    module's docstring), its collectives counted; each kernel call is
    appended to ``calls`` (``kernel_rules.Call``).  The fake process group
    is closed on return."""
    from torch.distributed.tensor.experimental import implicit_replication

    with placements.device_mesh(mesh) as dmesh, collectives.counting() as coll:
        state = _distributed(bundle.state, state_sh, dmesh)
        inputs = {k: _distributed(v, in_sh[k], dmesh) for k, v in bundle.inputs.items()}
        if decode_index is not None:
            inputs["index"] = decode_index
        with kernel_rules.ruled(dmesh, coll, calls), implicit_replication(), _gradients_to_state(dmesh), \
                _mask_broadcast(), _strided_costs(coll):
            out = bundle.fn(state, **inputs)
            _placed(out, out_sh)
    return coll


def run_cell(arch: str | Arch, cell_name: str, multi_pod: bool = False, verbose: bool = True,
             variant: str = "base", mesh: Mesh | None = None, calls: list | None = None) -> dict:
    """One cell's record (see the module's docstring).  ``arch`` is a
    registered name or an :class:`Arch` (a cell resized, say); ``mesh``
    replaces the production mesh (a 1-device one holds what one card holds,
    and moves nothing: its collectives are none, with no pass run);
    ``calls`` gets the collective pass's kernel calls.  The variant and the
    hints are set for the run and restored after it."""
    arch = get(arch) if isinstance(arch, str) else arch
    cell = arch.cells[cell_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod" + "x".join(map(str, mesh.sizes))
    rec = {"arch": arch.name, "cell": cell_name, "mesh": mesh_name, "family": arch.family, "variant": variant}
    if cell.skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell.skip
        return rec

    previous = get_variant().name
    set_variant(variant)
    try:
        t0 = time.perf_counter()
        _install_hints(mesh)
        bundle = build(arch, cell_name)
        in_sh = input_shardings(bundle.inputs, arch, cell, mesh)
        state_sh = state_shardings(bundle.state, arch, mesh) if bundle.kind == "train" else \
            param_shardings(bundle.state, arch, mesh)
        state = _zeros(bundle.state, "meta")
        inputs = {k: _zeros(v, "meta") for k, v in bundle.inputs.items()}
        if bundle.kind == "decode":  # the port's decode step takes the position as an int
            inputs["index"] = rec["decode_index"] = cell.meta["seq_len"] - 1
        with counting(state, inputs) as cost:
            out = bundle.fn(state, **inputs)
        rec["trace_s"] = time.perf_counter() - t0
        out_sh = _out_shardings(bundle.kind, _spec_of(out), mesh, state_sh, in_sh)
        t0 = time.perf_counter()
        coll = collectives.Collectives() if mesh.size == 1 else \
            collective_pass(bundle, mesh, state_sh, in_sh, out_sh, rec.get("decode_index"), calls)
        rec["collective_trace_s"] = time.perf_counter() - t0
    finally:
        hints.clear_rules()
        set_variant(previous)

    specs = bundle.state, bundle.inputs
    rec["memory"] = {
        "argument_size_in_bytes": sharded_bytes((state_sh, in_sh), specs),
        "output_size_in_bytes": sharded_bytes(out_sh, _spec_of(out)),
        "argument_allocated_bytes": _allocated((state_sh, in_sh), specs),
    }
    rec["cost"] = {"flops": cost.flops, "bytes_accessed": cost.bytes_accessed,
                   "library_flops": cost.library_flops, "kernel_flops": cost.kernel_flops}
    rec["peak_live_bytes"] = cost.peak_live_bytes
    rec["kernels"] = {kind: [[list(sig), n] for sig, n in sorted(calls.items(), key=str)]
                      for kind, calls in sorted(cost.calls.items())}
    rec["collectives"] = coll.record()
    rec["replicated_ops"] = dict(sorted(coll.replicated_ops.items()))
    rec["kernel_collectives"] = dict(sorted(coll.kernel_collectives.items()))
    rec["halo_gathered"] = dict(sorted(coll.gathered.items()))
    rec["estimated_costs"] = coll.estimated_costs
    rec["status"] = "ok"
    if verbose:
        print(f"--- {arch.name} / {cell_name} / {mesh_name} ({variant}) ---")
        print(f"trace {rec['trace_s']:.1f}s")
        print("memory:", rec["memory"])
        print("cost:", rec["cost"], "peak_live_bytes:", rec["peak_live_bytes"])
        print("kernel calls:", {k: sum(n for _, n in v) for k, v in rec["kernels"].items()})
        print(f"collectives ({rec['collective_trace_s']:.1f}s): bytes/device",
              {k: v for k, v in rec["collectives"].items() if k != "counts"}, "replicated ops:", rec["replicated_ops"])
    return rec


def record_cell(arch: str | Arch, cell_name: str, multi_pod: bool = False, verbose: bool = True,
                variant: str = "base", mesh: Mesh | None = None) -> dict:
    """:func:`run_cell`, or an ``error`` record where the cell raises (a
    shape a kernel refuses, say), as ``main`` saves it."""
    try:
        return run_cell(arch, cell_name, multi_pod, verbose, variant, mesh)
    except Exception as e:
        name = arch if isinstance(arch, str) else arch.name
        mesh_name = "pod" + "x".join(map(str, (mesh or make_production_mesh(multi_pod=multi_pod)).sizes))
        if verbose:
            print(f"ERROR {name}/{cell_name}: {e}")
        return {"arch": name, "cell": cell_name, "mesh": mesh_name, "variant": variant, "status": "error",
                "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-3000:]}


def _record_name(arch: str, cell: str, mesh_name: str, variant: str) -> str:
    suffix = "" if variant == "base" else f"__{variant}"
    return f"{arch}__{cell}__{mesh_name}{suffix}.json"


def save(rec: dict, out_dir: Path = RESULTS_DIR) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / _record_name(rec["arch"], rec["cell"], rec["mesh"], rec.get("variant", "base"))
    path.write_text(json.dumps(rec, indent=2))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-cached", action="store_true")
    ap.add_argument("--variant", default="base")
    args = ap.parse_args(argv)
    if not args.all and args.arch is None:
        ap.error("give --arch (and optionally --cell) or --all")

    assigned = [a for a in list_archs() if a != "vgg16"]
    if args.all:
        targets = [(a, c) for a in assigned for c in get(a).cells]
    else:
        cells = [args.cell] if args.cell else list(get(args.arch).cells)
        targets = [(args.arch, c) for c in cells]

    failures = []
    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    for a, c in targets:
        cache = RESULTS_DIR / _record_name(a, c, mesh_name, args.variant)
        if args.skip_cached and cache.exists():
            st = json.loads(cache.read_text()).get("status")
            if st in ("ok", "skipped"):
                print(f"cached: {a}/{c}/{mesh_name} ({st})")
                continue
        rec = record_cell(a, c, args.multi_pod, variant=args.variant)
        if rec["status"] == "error":
            failures.append((a, c))
        save(rec)
    if failures:
        print("FAILURES:", failures)
        return 1
    print("dry-run complete: all cells ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
