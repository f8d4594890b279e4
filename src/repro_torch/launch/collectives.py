"""What a step's collectives move, counted per device (the twin of the
collective half of ``repro/launch/hlo_cost.py`` and of
``repro/launch/dryrun.py: collective_bytes``).

JAX reads GSPMD's collectives from the compiled HLO.  The port runs the step
as DTensors (``parallel.placements``) and counts, while it runs:

* every functional collective that DTensor issues to redistribute a tensor
  (``torch.ops._c10d_functional.*``), named as XLA names them:
  ``all_gather_into_tensor`` -> ``all-gather``, ``all_reduce`` ->
  ``all-reduce``, ``reduce_scatter_tensor`` -> ``reduce-scatter``,
  ``all_to_all_single`` -> ``all-to-all`` (the ``_coalesced`` forms alike);
  DTensor's own ``shard_dim_alltoall`` (``_dtensor.*``) is an all-to-all;
* the collective-permutes that the kernels' sharding rules issue themselves
  (the halo exchange, ``parallel.kernel_rules``), through :meth:`Collectives.note`.

An operator that DTensor has no sharding strategy for (nor a decomposition
into operators it has) runs replicated, as GSPMD replicates what it cannot
partition: its DTensor operands are all-gathered (counted), it runs on the
whole tensors, and its outputs are replicated.  So do the operators whose
indices address the whole tensor (the MoE dispatch's sort, searches, index
copies and scatters), and a view (``aten.view``, ``aten._unsafe_view``)
that DTensor cannot take of a dim split unevenly or over several mesh dims.
Any other error of DTensor's is raised.  Such operators are listed by name
with their calls (``replicated_ops``).

Bytes follow JAX's convention: the *result* shape's bytes on one device,
summed over calls (``dryrun._shape_bytes``).  The step runs eagerly, so a
layer loop's trips are each counted, as ``analyze_hlo`` multiplies a while
body by its trip count.  A collective issued inside a kernel rule is also
filed under that kernel's call signature (``kernel_collectives``).
"""
from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["KINDS", "Collectives", "counting", "shape_bytes"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def shape_bytes(shape, dtype: torch.dtype) -> int:
    n = dtype.itemsize
    for d in shape:
        n *= int(d)
    return n


@dataclass
class Collectives:
    """A step's collectives: ``per_collective`` (result bytes a device, by
    kind), ``counts`` (calls, by kind), ``kernel_collectives`` (kernel
    call signature -> ``calls`` and kind -> [calls, bytes]: those issued
    inside a kernel rule), ``gathered`` (signature -> why a halo-ruled conv
    all-gathered H instead), ``replicated_ops`` (operators DTensor has no
    strategy for, run replicated after a counted all-gather: name ->
    calls) and ``estimated_costs`` (the strategy costs the dry run estimated
    for strided shards instead of DTensor's search, ``dryrun._strided_costs``)."""

    per_collective: dict = field(default_factory=lambda: dict.fromkeys(KINDS, 0))
    counts: dict = field(default_factory=lambda: dict.fromkeys(KINDS, 0))
    kernel_collectives: dict = field(default_factory=dict)
    gathered: dict = field(default_factory=dict)
    replicated_ops: Counter = field(default_factory=Counter)
    estimated_costs: int = 0
    scope: list = field(default_factory=list)  # the kernel signatures being ruled, innermost last

    def note(self, kind: str, nbytes: int, calls: int = 1) -> None:
        """Count ``calls`` collectives of ``kind`` whose results hold ``nbytes``
        on one device in all."""
        self.per_collective[kind] += nbytes
        self.counts[kind] += calls
        if self.scope:
            c = self.kernel_collectives[self.scope[-1]].setdefault(kind, [0, 0])
            c[0] += calls
            c[1] += nbytes

    @contextlib.contextmanager
    def kernel(self, sig: str, gathered: str = ""):
        """Count a call of kernel signature ``sig`` and file what is counted
        while entered under it too; ``gathered`` says why a halo-ruled conv
        all-gathered H."""
        self.kernel_collectives.setdefault(sig, {"calls": 0})["calls"] += 1
        if gathered:
            self.gathered[sig] = gathered
        self.scope.append(sig)
        try:
            yield
        finally:
            self.scope.pop()

    def record(self) -> dict:
        """JAX's keys: the five kinds' bytes, ``total`` and ``counts``."""
        out = {k: self.per_collective[k] for k in KINDS}
        out["total"] = sum(out.values())
        out["counts"] = dict(self.counts)
        return out


def _has_strategy(func) -> bool:
    """Whether DTensor can propagate a sharding through ``func``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._decompositions import DecompShardingStrategy

    dispatcher = DTensor._op_dispatcher
    prop = dispatcher.sharding_propagator
    return (func in prop.op_strategy_funcs or func in prop.op_single_dim_strategy_funcs or func in prop.op_to_rules
            or func in dispatcher._custom_op_handlers or DecompShardingStrategy.has_decomp(func))


def _group_size(func, args, kwargs) -> int:
    """The size of the group a functional collective runs over."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    named = {a.name: v for a, v in zip(func._schema.arguments, args)}
    named.update(kwargs)
    group = named["group_name"]
    return (group if hasattr(group, "size") else _resolve_process_group(group)).size()


def _indexing() -> set:
    """Operators whose indices address the whole tensor (the MoE dispatch's
    sort, searches and index copies): DTensor has strategies for some of
    them, but applied to blocks of a sharded index they are not the
    operator's meaning, so they run replicated."""
    aten = torch.ops.aten
    return {aten.sort.default, aten.sort.stable, aten.argsort.default, aten.argsort.stable, aten.topk.default,
            aten.searchsorted.Tensor, aten.index.Tensor, aten.index_copy.default, aten.index_copy_.default,
            aten.index_add.default, aten.index_add_.default, aten.index_put.default, aten.index_put_.default}


def _views() -> set:
    """The views DTensor may be unable to take of a dim split unevenly or
    over several mesh dims (its message for that differs by torch
    version)."""
    return {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default}


class _Mode(TorchDispatchMode):
    """Counts the functional collectives dispatched on plain tensors.  A call
    on DTensors goes to DTensor with this mode still entered, so the
    collectives its redistributions issue come back here; one that DTensor
    has no strategy for, a view it cannot take of an uneven or strided
    split, or one that indexes the whole tensor runs replicated (the
    module's docstring)."""

    def __init__(self, coll: Collectives):
        super().__init__()
        self.coll = coll
        self.known: dict = {}
        self.indexing = _indexing()
        self.views = _views()
        self.handing = None  # the call being handed to DTensor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self.handing is func:
                self.handing = None
                return NotImplemented
            known = self.known.get(func)
            if known is None:
                known = self.known[func] = _has_strategy(func) and func not in self.indexing
            if not known:
                return self._replicated(func, args, kwargs)
            with self:
                self.handing = func
                try:
                    return func(*args, **kwargs)
                except RuntimeError:
                    # the step ran unsharded before this pass, so a view that
                    # fails here fails for its operand's split
                    if func not in self.views:
                        raise
                finally:
                    self.handing = None
            return self._replicated(func, args, kwargs)
        out = func(*args, **kwargs)
        if func.namespace in ("_c10d_functional", "_dtensor"):
            kind = "all-to-all" if func._opname == "shard_dim_alltoall" else _FUNCTIONAL.get(func._opname)
            if kind is not None and _group_size(func, args, kwargs) > 1:  # a group of one moves nothing
                outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
                self.coll.note(kind, sum(shape_bytes(t.shape, t.dtype) for t in outs), calls=1)
        return out

    def _replicated(self, func, args, kwargs):
        """``func`` on the whole tensors: its DTensor operands all-gathered
        (counted), its outputs replicated; an in-place operator returns its
        own operand as it was placed."""
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map

        mesh = next(a.device_mesh for a in tree_leaves((args, kwargs)) if isinstance(a, DTensor))
        whole = [Replicate()] * mesh.ndim

        def gather(a):
            return a.redistribute(mesh, whole).to_local() if isinstance(a, DTensor) else a

        with self:
            local_args, local_kwargs = tree_map(gather, (args, kwargs))
        out = func(*local_args, **local_kwargs)
        self.coll.replicated_ops[str(func)] += 1
        if func._schema.name.endswith("_") or func._schema.is_mutable:
            return args[0]
        return tree_map(lambda t: DTensor.from_local(t, mesh, whole, run_check=False)
                        if isinstance(t, torch.Tensor) else t, out)


@contextlib.contextmanager
def counting():
    """Count the collectives dispatched while entered; yields a
    :class:`Collectives`."""
    coll = Collectives()
    with _Mode(coll):
        yield coll
