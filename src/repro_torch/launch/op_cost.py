"""What a step runs, counted in eager order (twin of
``repro/launch/hlo_cost.py``).

JAX reads its costs from the compiled HLO; the port has no HLO, so this
module counts the operators a step dispatches while it runs (on ``meta``
tensors in the dry run, or on real ones):

* ``flops`` -- ``torch.utils.flop_counter.FlopCounterMode`` for the library
  operators (matrix products, convolutions), except the library's conv
  backward, whose input and weight gradients are counted here from the
  shapes *with* the groups (the counter's weight-gradient formula ignores
  them, counting a depthwise conv's C times over); K1, K2 and K3 from their
  call shapes, once each, with their plain internals not counted: a conv 2
  x the output pixels x k^2 x the filter's input channels x Cout, K3 2 x
  the (query, key) pairs the softmax weighs (under the causal mask, the
  half it computes) x (D + DV).  K3's plain backward runs as library
  operators and counts as such: its five products over every pair.
* ``bytes_accessed`` -- the operand and result bytes of every operator that
  is not a view (a kernel call is one operator: its operands and output):
  the eager, unfused traffic the card really moves.  No fusion is modelled.
* ``peak_live_bytes`` -- the peak of the bytes of the storages alive while
  the step runs (its arguments included), a storage counted from the
  operator that made it until the last tensor on it is gone.

The collective half of ``HLOCost`` is :mod:`.collectives`, which the dry
run's collective pass fills (``dryrun.collective_pass``).
:func:`step_flops_of` is the same count from a ``FlopCounterMode`` and a
record of the kernels' calls, which ``chip_smoke.py`` takes on the card.
"""
from __future__ import annotations

import contextlib
import types
import weakref
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCost", "counting", "attention_pairs", "conv_flops", "attn_flops", "step_flops_of"]

aten = torch.ops.aten
# operators that move no bytes: storage without a write, or metadata
_NO_TRAFFIC = {
    aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten._unsafe_view.default, aten.set_.source_Storage_storage_offset,
}


def attention_pairs(t: int, s: int, causal: bool) -> int:
    """(query, key) pairs the softmax weighs: T*S, or under the top-left
    causal mask sum_t min(S, t + 1)."""
    if not causal:
        return t * s
    if t <= s:
        return t * (t + 1) // 2
    return s * (s + 1) // 2 + (t - s) * s


def conv_call_flops(x_shape, w_shape, stride: int, padding: int) -> float:
    """Operations of one conv: 2 x output pixels x k^2 x the filter's input
    channels (1 for depthwise) x Cout."""
    n, h, w, _ = x_shape
    k, _, w_cin, cout = w_shape
    ho, wo = (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1
    return 2.0 * k * k * w_cin * cout * n * ho * wo


def conv_flops(rec, dgrad: bool = False) -> float:
    """Operations of the recorded K1 calls -- a conv's forward, and as many
    again for its weight gradient -- or, with ``dgrad``, of the input
    gradients of those whose input needs one (K1's or the library's: the
    same products).  ``rec.convs`` counts ``chip_smoke.recording_train_calls``'
    signatures: (x shape, w shape, stride, padding, groups, bias, dtype, x
    requires grad)."""
    total = 0.0
    for (x, w, st, pad, *_, x_grad), c in rec.convs.items():
        if dgrad and not x_grad:
            continue
        total += c * conv_call_flops(x, w, st, pad)
    return total


def attn_flops(rec) -> float:
    """Operations of the recorded K3 forwards: 2 x the (query, key) pairs the
    softmax weighs (:func:`attention_pairs`: under the causal mask, the half
    computed) x (D + DV); a record without DV has DV = D."""
    return sum(c * 2.0 * b * h * attention_pairs(t, s, causal) * (d + (dv[0] if dv else d))
               for ((b, h, t, d), s, _, causal, *dv), c in rec.attns.items())


def step_flops_of(counter, rec) -> float:
    """One train step's operations: ``FlopCounterMode``'s count without its
    conv backward (its weight-gradient formula ignores groups: a depthwise
    conv's is counted C times over), plus the recorded convs' forward,
    weight and input gradients and K3's forwards (neither kernel is an
    operator it sees).  What ran counts: under remat the second forward of
    each checkpointed layer (its products, its K3 and K1 calls, recorded
    again: a recomputed conv's gradients once, ``rec.recomputed`` counting
    the second calls), and the plain K3 backward's five products over every
    (query, key) pair, masked or not; K3's forwards at the pairs they weigh
    (the causal half).  The LM's cross-entropy and AdamW are elementwise,
    not counted."""
    library_conv = sum(v for op, v in counter.get_flop_counts()["Global"].items()
                       if "convolution_backward" in str(op))
    once = types.SimpleNamespace(convs=rec.convs - rec.recomputed)
    return counter.get_total_flops() - library_conv + conv_flops(rec) + conv_flops(once) \
        + conv_flops(once, dgrad=True) + attn_flops(rec)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


@dataclass
class OpCost:
    """A step's count: the fields of ``HLOCost`` that are not collectives
    (``flops``, ``bytes_accessed``), split into the library's and the
    kernels' shares, the peak of live bytes, and the kernels' calls by
    signature (K1 / K1 dgrad: x shape, w shape, stride, padding, groups,
    bias, dtype, x requires grad; K2: the shard's, halos' and weights'
    shapes, stride, padding, groups, bias, dtype; K3: q's [B, H, T, D],
    S, dtype, causal, DV)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    library_flops: float = 0.0
    kernel_flops: float = 0.0
    peak_live_bytes: int = 0
    calls: dict = field(default_factory=dict)  # "K1" / "K1 dgrad" / "K2" / "K3" -> Counter of signatures


def _layout(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype


class _Counter(TorchDispatchMode):
    """Counts every operator as it runs: its operations by the flop
    counter's formulas (a CompositeImplicit operator decomposed first, as
    ``FlopCounterMode`` does; the library conv backward's from the shapes
    with the groups), its operand and result bytes (views and allocations
    without a write excepted), and the live storages."""

    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost
        self.flops = 0.0
        self.live: dict[int, int] = {}
        self.current = 0
        self.implicit: dict = {}
        self.replays: dict = {}

    def track(self, tensors) -> None:
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.current += n
            self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self.current)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not isinstance(func, torch._ops.OpOverload):
            return func(*args, **kwargs)
        implicit = self.implicit.get(func)
        if implicit is None:
            implicit = self.implicit[func] = (
                func.overloadpacket not in flop_registry and func is not torch.ops.prim.device.default
                and torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), "CompositeImplicitAutograd"))
        if implicit:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func is aten.convolution_backward.default:
            dy, _, w = args[:3]
            mask = args[10]
            n_, cout, ho, wo = dy.shape
            each = 2.0 * n_ * ho * wo * cout * w.shape[1] * w.shape[2] * w.shape[3]
            self.flops += each * (int(mask[0]) + int(mask[1]))
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view or func in _NO_TRAFFIC:
            return out
        outs = tree_leaves(out)
        self.cost.bytes_accessed += sum(_nbytes(t) for t in tree_leaves((args, kwargs))) + sum(map(_nbytes, outs))
        self.track(outs)
        return out


def _kernel_hooks(cost: OpCost, traffic: _Counter):
    """Stand-ins for the kernels' dispatch routes (``conv2d.ops._conv``,
    ``conv2d_backward``, ``attention.ops._attend``, ``halo_conv.ops._halo``)
    that record each call's signature, operations and bytes and run the
    real route with no mode active (its plain internals on the CPU are not
    the kernel's work), and for K3's plain backward
    (``attention.ops.attention_backward``), which replays its count on a
    ``meta`` call whose operands' layouts it has seen.  Returns [(module,
    name, stand-in)]."""
    from ..kernels.attention import ops as attn_ops
    from ..kernels.conv2d import ops as conv_ops
    from ..kernels.halo_conv import ops as halo_ops

    real_conv, real_bwd, real_attend, real_halo = conv_ops._conv, conv_ops.conv2d_backward, attn_ops._attend, \
        halo_ops._halo
    real_attn_bwd = attn_ops.attention_backward
    state = types.SimpleNamespace(dgrad=False)

    def note(kind: str, sig: tuple, flops: float, operands, y) -> None:
        cost.calls.setdefault(kind, Counter())[sig] += 1
        cost.kernel_flops += flops
        cost.bytes_accessed += sum(_nbytes(t) for t in operands) + _nbytes(y)
        traffic.track([y])

    def conv(x, weights, bias, stride, padding, groups):
        with _disable_current_modes():
            y, launched = real_conv(x, weights, bias, stride, padding, groups)
        sig = (tuple(x.shape), tuple(weights.shape), stride, padding, groups, bias is not None, _dtype(x),
               x.requires_grad)
        note("K1 dgrad" if state.dgrad else "K1", sig, conv_call_flops(x.shape, weights.shape, stride, padding),
             (x, weights, bias), y)
        return y, launched

    def attention_backward(q, k, v, o, do, causal):
        # a pure function of its operands' layouts: on meta, a call seen
        # before replays its count instead of running its chunk loop again
        operands = (q, k, v, o, do)
        if any(t.device.type != "meta" for t in operands):
            return real_attn_bwd(q, k, v, o, do, causal)
        key = tuple(map(_layout, operands)), causal
        seen = traffic.replays.get(key)
        if seen is None:
            flops, nbytes, current = traffic.flops, cost.bytes_accessed, traffic.current
            cost.peak_live_bytes, outer_peak = current, cost.peak_live_bytes
            grads = real_attn_bwd(q, k, v, o, do, causal)
            excess = cost.peak_live_bytes - current
            cost.peak_live_bytes = max(outer_peak, cost.peak_live_bytes)
            traffic.replays[key] = (traffic.flops - flops, cost.bytes_accessed - nbytes, excess,
                                    [_layout(g) for g in grads])
            return grads
        flops, nbytes, excess, layouts = seen
        traffic.flops += flops
        cost.bytes_accessed += nbytes
        cost.peak_live_bytes = max(cost.peak_live_bytes, traffic.current + excess)
        grads = tuple(torch.empty_strided(sh, st, dtype=dt, device="meta") for sh, st, dt in layouts)
        traffic.track(grads)
        return grads

    def conv_backward(*args, **kw):
        state.dgrad = True
        try:
            return real_bwd(*args, **kw)
        finally:
            state.dgrad = False

    def attend(q, k, v, causal):
        with _disable_current_modes():
            o = real_attend(q, k, v, causal)
        b, h, t, d = q.shape
        s, dv = k.shape[2], v.shape[3]
        note("K3", (tuple(q.shape), s, _dtype(q), causal, dv), 2.0 * b * h * attention_pairs(t, s, causal) * (d + dv),
             (q, k, v), o)
        return o

    def halo(x, top, bot, weights, bias, stride, padding, groups, lo, hi, ho, wo):
        with _disable_current_modes():
            y, launched = real_halo(x, top, bot, weights, bias, stride, padding, groups, lo, hi, ho, wo)
        sig = (tuple(x.shape), lo, hi, tuple(weights.shape), stride, padding, groups, bias is not None, _dtype(x))
        flops = 2.0 * weights.shape[0] ** 2 * weights.shape[2] * weights.shape[3] * x.shape[0] * ho * wo
        note("K2", sig, flops, (x, top, bot, weights, bias), y)
        return y, launched

    return [(conv_ops, "_conv", conv), (conv_ops, "conv2d_backward", conv_backward), (attn_ops, "_attend", attend),
            (attn_ops, "attention_backward", attention_backward), (halo_ops, "_halo", halo)]


@contextlib.contextmanager
def counting(*args):
    """Count what runs while entered; ``args`` (trees of tensors: the step's
    state and inputs) are live from the start.  Yields an :class:`OpCost`,
    filled in on exit."""
    cost = OpCost()
    counter = _Counter(cost)
    counter.track(tree_leaves(args))
    hooks = _kernel_hooks(cost, counter)
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in hooks]
    for mod, name, fn in hooks:
        setattr(mod, name, fn)
    try:
        with counter:
            yield cost
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    cost.library_flops = counter.flops
    cost.flops = cost.library_flops + cost.kernel_flops
