"""One sharding rule for each hand-written kernel (K1, K2 as the halo
exchange, K3), for steps that run as DTensors (``launch.dryrun``'s
collective pass) and for their emulation on one card (:func:`emulate`).

A rule reads the placements its operands come with and answers, mesh dim by
mesh dim, the placements it takes them in (an operand is redistributed to
those first: that redistribution is a counted collective), what the output's
placements are, and which local launch computes a rank's block.  The rules:

* K1 dense.  x: N sharded; H (and W) sharded only through the halo rule
  below; C replicated unless w is sharded on I.  w: O (Cout) sharded or
  replicated; I (Cin) replicated.  y: N as x, C as w's O.  Where w is
  sharded on I, x takes C sharded the same way and y is ``Partial(sum)``
  (the bias added on the group's first rank only): the reduction happens
  where a consumer asks for Replicate or Shard, and DTensor counts it there.
* K1 depthwise (``groups == C``): x's C and w's O sharded alike; y: C as x.
* K1 with x sharded on H: the HALP halo exchange.  Each rank receives the
  ``lo`` bottom rows of the shard above and the ``hi`` top rows of the shard
  below (``spatial.halo.halo_sizes``; zeros at the edges, the conv's
  padding): a collective-permute each way.  K2 then computes the rank's
  rows from the shard and its halos.  With W sharded too, the W halos are
  exchanged first and the H halos are taken of the widened shard, so the
  corners come along (two collective-permutes a side), and K2 runs with no
  W padding of its own.  A kernel no taller than its stride at padding 0
  needs no halo (K1 on the shard).  Where a shard holds fewer rows than its
  halo, the shards are uneven or the geometry has no exact halo, the rule
  all-gathers H (and W) instead, computes the whole output on every rank,
  and lists the conv (``gathered``).
* K3 forward: q, k, v sharded on B and on the heads, T, S and D
  replicated (a sequence-sharded input is all-gathered first, as GSPMD
  must); KV heads sharded with the query heads that read them, or, where a
  shard of query heads reads part of one KV head's group, replicated and
  sliced locally.  o: as q.
* K1 and K3 backward: the forward's rule.  dx, dq, dk, dv take their
  operands' placements; the gradient of an operand replicated over a mesh
  dim on which the forward was sharded (the weight over a sharded batch, a
  KV head read by sharded query heads, x under a Cout-sharded w) is
  ``Partial(sum)``, never Replicate: the reduction is issued where the
  optimizer redistributes it to the state's sharding.  The backward of a
  halo-ruled conv all-gathers x and dy on H and takes the rank's rows (dx)
  and the rank's share of dW.

Collectives are filed under the kernel call's signature
(``launch.collectives``); each call is logged with its operands' placements
(:class:`Call`), which :func:`emulate` replays on real tensors.
"""
from __future__ import annotations

import contextlib
import itertools
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard

from ..spatial.comm import LocalComm
from ..spatial.halo import halo_sizes

__all__ = ["ConvRule", "AttnRule", "Call", "OUTPUTS", "plan_conv", "conv_backward_rule", "plan_attention", "ruled",
           "emulate", "replaying", "local_of", "assemble"]

R = Replicate()
P = Partial("sum")
# each kernel call's outputs, in order, by name
OUTPUTS = {"K1": ("y",), "K1 backward": ("dx", "dw", "db"), "K3": ("o",), "K3 backward": ("dq", "dk", "dv")}


def _is(p: Placement, dim: int) -> bool:
    return isinstance(p, Shard) and p.dim == dim


def _dims(pl, dim: int) -> list[int]:
    return [j for j, p in enumerate(pl) if _is(p, dim)]


def _ways(sizes, dims) -> int:
    n = 1
    for j in dims:
        n *= sizes[j]
    return n


def _even(pl, shape, sizes) -> list:
    """``pl`` with every Shard whose dim the mesh dims sharding it do not
    divide turned to Replicate (a rule takes even shards only), as is every
    placement on a mesh dim of one device (it holds the whole tensor)."""
    out = [R if n == 1 else p for p, n in zip(pl, sizes)]
    for d in range(len(shape)):
        dims = _dims(out, d)
        if dims and shape[d] % _ways(sizes, dims):
            for j in dims:
                out[j] = R
    return out


def _no_partial(pl) -> list:
    return [R if p.is_partial() else p for p in pl]


def _name(pl) -> str:
    return "(" + ",".join("R" if isinstance(p, Replicate) else "P" if p.is_partial() else f"S{p.dim}"
                          for p in pl) + ")"


# ---------------------------------------------------------------------------
# K1 / K2
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvRule:
    """K1's rule for one call: the placements x, w, the bias and y take,
    the route (``"K1"`` on the local blocks, ``"K2"`` after the halo
    exchange, ``"gathered"``: H / W all-gathered first), the mesh dims that
    shard H and W, the halos (rows above / below, columns left / right), the
    mesh dims on which y is Partial, and why H / W were gathered."""

    x: tuple
    w: tuple
    b: tuple
    y: tuple
    route: str
    h_dims: tuple = ()
    w_dims: tuple = ()
    lo: int = 0
    hi: int = 0
    wlo: int = 0
    whi: int = 0
    partial: tuple = ()
    gathered: str = ""


def _spatial(k: int, s: int, p: int, n: int, rows: int) -> tuple[int, int] | str:
    """The halo (lo, hi) an even ``n``-way split of ``rows`` takes, or why
    it takes none."""
    if rows % n:
        return f"{rows} rows do not split {n} ways"
    hs = rows // n
    if hs % s:
        return f"a shard's {hs} rows are not a multiple of the stride {s}"
    if k <= s:
        return (0, 0) if p == 0 else f"k={k} <= s={s} with padding {p}"
    if k - p - s < 0 or p >= k:
        return f"k={k} s={s} p={p} has no exact halo"
    lo, hi = halo_sizes(k, s, p)
    if lo > hs or hi > hs:
        return f"a shard's {hs} rows are fewer than its halo ({lo}, {hi})"
    return lo, hi


def plan_conv(xp, wp, x_shape, w_shape, stride: int, padding: int, groups: int, sizes) -> ConvRule:
    """K1's rule (the module's docstring) for x [N, H, W, C] and w [k, k,
    I, O] placed ``xp`` / ``wp`` on a mesh of ``sizes``."""
    n_mesh = len(sizes)
    depthwise = groups > 1
    X = _even(_no_partial(xp), x_shape, sizes)
    W = _even(_no_partial(wp), w_shape, sizes)
    Y: list = [R] * n_mesh
    h_dims, w_dims = [], []
    for j in range(n_mesh):
        x, w = X[j], W[j]
        if _is(x, 0):
            W[j], Y[j] = R, Shard(0)
            continue
        if _is(x, 1) or _is(x, 2):
            (h_dims if _is(x, 1) else w_dims).append(j)
            W[j] = R
            continue
        if _is(x, 3):
            if depthwise:
                W[j] = Y[j] = Shard(3)
                continue
            if _is(w, 2):
                Y[j] = P
                continue
            X[j] = R
        if depthwise:
            if _is(w, 3):
                X[j] = Y[j] = Shard(3)
            else:
                W[j] = R
        elif _is(w, 3):
            Y[j] = Shard(3)
        elif _is(w, 2):
            X[j], Y[j] = Shard(3), P
        else:
            W[j] = R
    k = w_shape[0]
    route, gathered, lo, hi, wlo, whi = "K1", "", 0, 0, 0, 0
    if w_dims and not h_dims:
        gathered = "W sharded without H"
    elif h_dims:
        got = _spatial(k, stride, padding, _ways(sizes, h_dims), x_shape[1])
        if isinstance(got, str):
            gathered = f"H: {got}"
        else:
            lo, hi = got
            if w_dims:
                got = _spatial(k, stride, padding, _ways(sizes, w_dims), x_shape[2])
                if isinstance(got, str):
                    gathered = f"W: {got}"
                else:
                    wlo, whi = got
            if not gathered:
                route = "K2" if lo + hi + wlo + whi else "K1"
                for j in h_dims:
                    Y[j] = Shard(1)
                for j in w_dims:
                    Y[j] = Shard(2)
    if gathered:
        route = "gathered"
        for j in h_dims + w_dims:
            X[j] = R
    b = tuple(Shard(0) if _is(y, 3) else R for y in Y)
    return ConvRule(tuple(X), tuple(W), b, tuple(Y), route, tuple(h_dims), tuple(w_dims), lo, hi, wlo, whi,
                    tuple(j for j, y in enumerate(Y) if y.is_partial()), gathered)


def conv_backward_rule(rule: ConvRule) -> dict:
    """The backward's placements from the forward's rule: dy as y (Partial
    dims replicated; a halo-ruled conv's H / W gathered), x as in the
    forward (gathered likewise), and the gradients' placements."""
    spatial = rule.route == "K2"
    x = list(rule.x)
    dy = [R if p.is_partial() else p for p in rule.y]
    dx, dw, db = [], [], []
    for j, (xj, wj, yj) in enumerate(zip(rule.x, rule.w, rule.y)):
        if spatial and j in rule.h_dims + rule.w_dims:
            x[j] = dy[j] = R
            dx.append(xj)
            dw.append(P)
            db.append(P)
            continue
        if yj.is_partial():  # x on C, w on I
            dx.append(Shard(3))
            dw.append(Shard(2))
            db.append(R)
        elif _is(yj, 3) and not _is(xj, 3):  # x replicated, w on O
            dx.append(P)
            dw.append(Shard(3))
            db.append(Shard(0))
        elif _is(yj, 3):  # depthwise on C
            dx.append(Shard(3))
            dw.append(Shard(3))
            db.append(Shard(0))
        elif isinstance(xj, Shard):  # N (or H / W through K1): w replicated over a sharded x
            dx.append(xj)
            dw.append(P)
            db.append(P)
        else:
            dx.append(R)
            dw.append(R)
            db.append(R)
    return dict(x=tuple(x), dy=tuple(dy), dx=tuple(dx), dw=tuple(dw), db=tuple(db))


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttnRule:
    """K3's rule for one call: the placements q (and o), k and v take, the
    mesh dims that shard the query heads, and whether the KV heads are
    replicated over them and sliced locally by group."""

    q: tuple
    kv: tuple
    head_dims: tuple = ()
    kv_sliced: bool = False


def plan_attention(qp, kp, q_shape, k_shape, sizes) -> AttnRule:
    """K3's rule (the module's docstring) for q [B, H, T, D] and k, v [B,
    Hkv, S, D(V)] placed ``qp`` / ``kp`` (v goes as k)."""
    n_mesh = len(sizes)
    Q = _even(_no_partial(qp), q_shape, sizes)
    K = _even(_no_partial(kp), k_shape, sizes)
    for j in range(n_mesh):
        if isinstance(Q[j], Shard) and Q[j].dim in (2, 3):
            Q[j] = R  # T or D: all-gathered
        if isinstance(K[j], Shard) and K[j].dim in (2, 3):
            K[j] = R  # S or D
    for j in range(n_mesh):
        if _is(Q[j], 0) or (isinstance(Q[j], Replicate) and _is(K[j], 0)):
            Q[j] = K[j] = Shard(0)
        elif isinstance(Q[j], Replicate) and _is(K[j], 1):
            Q[j] = Shard(1)
        elif not _is(Q[j], 1):
            K[j] = R
    h, hkv = q_shape[1], k_shape[1]
    head_dims = _dims(Q, 1)
    n = _ways(sizes, head_dims)
    sliced = False
    kv = Shard(1)
    if head_dims and hkv % n:
        kv = R
        if (h // hkv) % (h // n):  # a shard's query heads straddle two KV heads' groups
            for j in head_dims:
                Q[j] = R
        else:
            sliced = True
    for j in head_dims:
        K[j] = kv
    return AttnRule(tuple(Q), tuple(K), tuple(_dims(Q, 1)), sliced)


def _kv_slice(rule: AttnRule, sizes, coord, h: int, hkv: int) -> slice:
    """The KV heads a rank's query heads read where they are sliced."""
    n = _ways(sizes, rule.head_dims)
    r = 0
    for j in rule.head_dims:
        r = r * sizes[j] + coord[j]
    first = r * (h // n) // (h // hkv)
    return slice(first, first + 1)


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------


def _line(coord, dims, sizes):
    """(index along ``dims``, the coords of the line in order): a rank's
    place among the ranks that differ from it only on ``dims``."""
    others = [range(sizes[j]) if j in dims else [coord[j]] for j in range(len(sizes))]
    line = [c for c in itertools.product(*others)]
    return line.index(tuple(coord)), line


class _MetaExchange:
    """Rank 0's view in the dry run: a halo is a fresh tensor of its shape,
    and each permute is counted."""

    def __init__(self, coll):
        self.coll = coll

    def __call__(self, blocks: dict, axis: int, lo: int, hi: int, dims, sizes) -> dict:
        out = {}
        for c, x in blocks.items():
            halos = []
            for rows in (lo, hi):
                if not rows:
                    halos.append(None)
                    continue
                shape = list(x.shape)
                shape[axis] = rows
                halos.append(x.new_empty(shape))
                if self.coll is not None:
                    self.coll.note("collective-permute", _nbytes(shape, x.dtype))
            out[c] = tuple(halos)
        return out


class _LocalExchange:
    """Every rank's block on one device: each line of ranks along ``dims``
    shifts its donations over a ``LocalComm`` (zeros at the edges), and
    each received halo is copied on the device.  ``moved`` counts rank
    0's received bytes by kind."""

    def __init__(self, moved: dict):
        self.moved = moved

    def __call__(self, blocks: dict, axis: int, lo: int, hi: int, dims, sizes) -> dict:
        out = {c: [None, None] for c in blocks}
        done = set()
        for c in blocks:
            _, line = _line(c, dims, sizes)
            if line[0] in done:
                continue
            done.add(line[0])
            comm = LocalComm(len(line), blocks[c].device)
            xs = [blocks[q] for q in line]
            if lo:
                got = comm.shift([x.narrow(axis, x.shape[axis] - lo, lo) for x in xs], 1)
                for q, t in zip(line, got):
                    out[q][0] = t.clone()
            if hi:
                got = comm.shift([x.narrow(axis, 0, hi) for x in xs], -1)
                for q, t in zip(line, got):
                    out[q][1] = t.clone()
        origin = tuple([0] * len(sizes))
        for t in out[origin]:
            if t is not None:
                _add(self.moved, "collective-permute", _nbytes(t.shape, t.dtype))
        return {c: tuple(v) for c, v in out.items()}


def _nbytes(shape, dtype) -> int:
    n = dtype.itemsize
    for d in shape:
        n *= int(d)
    return n


def _add(moved: dict, kind: str, nbytes: int) -> None:
    c = moved.setdefault(kind, [0, 0])
    c[0] += 1
    c[1] += nbytes


def _conv_local(rule: ConvRule, real, blocks: dict, w: dict, b: dict, stride: int, padding: int, groups: int,
                exchange, sizes) -> dict:
    """Each rank's output block of a conv under ``rule`` (blocks, weights
    and biases by rank coord, already in the rule's placements): K1 on the
    block, or the halo exchange then K2.  ``real`` = (K1, K2): functions of
    K1's ``_conv`` and K2's ``_halo`` arguments returning the output."""
    conv, halo = real
    depthwise = groups > 1
    if rule.route != "K2":
        return {c: conv(x, w[c], b[c], stride, padding, x.shape[3] if depthwise else 1) for c, x in blocks.items()}
    k = w[next(iter(w))].shape[0]
    pad_w = padding
    if rule.w_dims:  # the W halos first: the H halos are then taken of the widened blocks
        side = exchange(blocks, 2, rule.wlo, rule.whi, rule.w_dims, sizes)
        blocks = {c: torch.cat([t for t in (side[c][0], x, side[c][1]) if t is not None], dim=2)
                  for c, x in blocks.items()}
        pad_w = 0
    halos = exchange(blocks, 1, rule.lo, rule.hi, rule.h_dims, sizes)
    out = {}
    for c, x in blocks.items():
        top, bot = halos[c]
        ho = x.shape[1] // stride
        wo = (x.shape[2] + 2 * pad_w - k) // stride + 1
        out[c] = halo(x, top, bot, w[c], b[c], stride, pad_w, x.shape[3] if depthwise else 1, rule.lo, rule.hi,
                      ho, wo)
    return out


# ---------------------------------------------------------------------------
# the dry run's route: the kernels' entry points on DTensors
# ---------------------------------------------------------------------------


@dataclass
class Call:
    """One kernel call as the collective pass met it: the kernel, its
    operands' global shapes and placements (as given, before the rule), its
    static arguments, the route taken and the collectives the rule issued
    (kind -> [calls, bytes])."""

    kernel: str
    shapes: tuple
    placements: tuple
    statics: tuple
    route: str = ""
    gathered: str = ""
    collectives: dict = field(default_factory=dict)

    def signature(self) -> str:
        shapes = " ".join("x".join(map(str, s)) if s is not None else "-" for s in self.shapes)
        pls = " ".join(_name(p) if p is not None else "-" for p in self.placements)
        return f"{self.kernel} [{shapes}] {pls} {self.statics} {self.route}"


def _dt(t, dmesh):
    """``t`` as a DTensor on ``dmesh`` (a plain tensor replicated)."""
    if t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, dmesh, [R] * dmesh.ndim, run_check=False)


def _local_call(fn, dmesh, args, in_pl, out_pl):
    """``fn`` on the local blocks of ``args`` redistributed to ``in_pl``
    (``local_map``), its outputs placed ``out_pl``; None args and outputs
    pass through."""
    from torch.distributed.tensor.experimental import local_map

    keep = [i for i, a in enumerate(args) if a is not None]

    def inner(*present):
        full = [None] * len(args)
        for i, a in zip(keep, present):
            full[i] = a
        outs = fn(*full)
        return tuple(o for o in outs if o is not None)

    outs_present = [i for i, p in enumerate(out_pl) if p is not None]
    got = local_map(inner, out_placements=tuple(out_pl[i] for i in outs_present),
                    in_placements=tuple(in_pl[i] for i in keep), device_mesh=dmesh,
                    redistribute_inputs=True)(*(args[i] for i in keep))
    got = got if isinstance(got, tuple) else (got,)
    full = [None] * len(out_pl)
    for i, t in zip(outs_present, got):
        full[i] = t
    return full


@contextlib.contextmanager
def ruled(dmesh, coll=None, log: list | None = None):
    """While entered, the kernels' entry points (``conv2d.ops._conv`` and
    ``conv2d_backward``, under ``Conv2dFunction`` too; ``attention.ops._attend``
    and ``attention_backward``, under ``FlashAttentionFunction`` too) take
    DTensors on ``dmesh`` by their rules, each operand redistributed first;
    plain operands go to the real entry point as before.  The rules'
    collectives are counted in ``coll`` (``launch.collectives``) under each
    call's signature, and each call is appended to ``log``."""
    from ..kernels.attention import ops as attn_ops
    from ..kernels.conv2d import ops as conv_ops
    from ..kernels.halo_conv import ops as halo_ops

    real_conv, real_bwd, real_halo = conv_ops._conv, conv_ops.conv2d_backward, halo_ops._halo
    real_attend, real_attn_bwd = attn_ops._attend, attn_ops.attention_backward
    sizes = tuple(dmesh.shape)
    origin = (0,) * len(sizes)
    exchange = _MetaExchange(coll)

    def scoped(call: Call):
        if log is not None:
            log.append(call)
        if coll is None:
            return contextlib.nullcontext()
        return coll.kernel(call.signature(), call.gathered)

    def conv(x, weights, bias, stride, padding, groups):
        if not any(isinstance(t, DTensor) for t in (x, weights, bias)):
            return real_conv(x, weights, bias, stride, padding, groups)
        x, weights, bias = (_dt(t, dmesh) for t in (x, weights, bias))
        rule = plan_conv(x.placements, weights.placements, tuple(x.shape), tuple(weights.shape), stride, padding,
                         groups, sizes)
        call = Call("K1", (tuple(x.shape), tuple(weights.shape), None if bias is None else tuple(bias.shape)),
                    (x.placements, weights.placements, None if bias is None else bias.placements),
                    (stride, padding, groups, str(x.dtype).removeprefix("torch.")), rule.route, rule.gathered)

        def local(xl, wl, bl):
            y = _conv_local(rule, (lambda *a: real_conv(*a)[0], lambda *a: real_halo(*a)[0]), {origin: xl},
                            {origin: wl}, {origin: bl}, stride, padding, groups, exchange, sizes)[origin]
            return (y,)

        with scoped(call):
            (y,) = _local_call(local, dmesh, (x, weights, bias), (rule.x, rule.w, rule.b), (rule.y,))
        return y, False

    def conv_backward(dy, x, weights, stride, padding, groups, needs):
        if not any(isinstance(t, DTensor) for t in (dy, x, weights)):
            return real_bwd(dy, x, weights, stride, padding, groups, needs)
        dy, x, weights = (_dt(t, dmesh) for t in (dy, x, weights))
        rule = plan_conv(x.placements, weights.placements, tuple(x.shape), tuple(weights.shape), stride, padding,
                         groups, sizes)
        br = conv_backward_rule(rule)
        call = Call("K1 backward", (tuple(dy.shape), tuple(x.shape), tuple(weights.shape)),
                    (dy.placements, x.placements, weights.placements),
                    (stride, padding, groups, str(x.dtype).removeprefix("torch."), tuple(needs)), rule.route,
                    rule.gathered)

        def local(dyl, xl, wl):
            return _conv_backward_local(rule, br, real_bwd, {origin: dyl}, {origin: xl}, {origin: wl}, stride,
                                        padding, groups, needs, sizes, tuple(x.shape))[origin]

        out_pl = tuple(p if need else None for p, need in zip((br["dx"], br["dw"], br["db"]), needs))
        with scoped(call):
            got = _local_call(local, dmesh, (dy, x, weights), (br["dy"], br["x"], rule.w), out_pl)
        return tuple(got)

    def attend(q, k, v, causal):
        if not any(isinstance(t, DTensor) for t in (q, k, v)):
            return real_attend(q, k, v, causal)
        q, k, v = (_dt(t, dmesh) for t in (q, k, v))
        rule = plan_attention(q.placements, k.placements, tuple(q.shape), tuple(k.shape), sizes)
        call = Call("K3", (tuple(q.shape), tuple(k.shape), tuple(v.shape)), (q.placements, k.placements,
                    v.placements), (causal, str(q.dtype).removeprefix("torch.")), "sliced" if rule.kv_sliced else "")
        h, hkv = q.shape[1], k.shape[1]

        def local(ql, kl, vl):
            if rule.kv_sliced:
                s = _kv_slice(rule, sizes, origin, h, hkv)
                kl, vl = kl[:, s], vl[:, s]
            return (real_attend(ql, kl, vl, causal),)

        with scoped(call):
            (o,) = _local_call(local, dmesh, (q, k, v), (rule.q, rule.kv, rule.kv), (rule.q,))
        return o

    def attention_backward(q, k, v, o, do, causal):
        if not any(isinstance(t, DTensor) for t in (q, k, v, o, do)):
            return real_attn_bwd(q, k, v, o, do, causal)
        q, k, v, o, do = (_dt(t, dmesh) for t in (q, k, v, o, do))
        rule = plan_attention(q.placements, k.placements, tuple(q.shape), tuple(k.shape), sizes)
        call = Call("K3 backward", (tuple(q.shape), tuple(k.shape), tuple(v.shape)),
                    (q.placements, k.placements, v.placements, o.placements, do.placements),
                    (causal, str(q.dtype).removeprefix("torch.")), "sliced" if rule.kv_sliced else "")
        h, hkv = q.shape[1], k.shape[1]
        dkv = _dkv_placements(rule)

        def local(ql, kl, vl, ol, dol):
            return _attention_backward_local(rule, real_attn_bwd, ql, kl, vl, ol, dol, causal, sizes, origin, h,
                                             hkv)

        with scoped(call):
            got = _local_call(local, dmesh, (q, k, v, o, do), (rule.q, rule.kv, rule.kv, rule.q, rule.q),
                              (rule.q, dkv, dkv))
        return tuple(got)

    with _hooked(conv, conv_backward, attend, attention_backward):
        yield


@contextlib.contextmanager
def _hooked(conv, conv_backward, attend, attention_backward):
    """The kernels' four entry points (``conv2d.ops._conv`` and
    ``conv2d_backward``, ``attention.ops._attend`` and
    ``attention_backward``) replaced by these while entered."""
    from ..kernels.attention import ops as attn_ops
    from ..kernels.conv2d import ops as conv_ops

    hooks = [(conv_ops, "_conv", conv), (conv_ops, "conv2d_backward", conv_backward), (attn_ops, "_attend", attend),
             (attn_ops, "attention_backward", attention_backward)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in hooks]
    for mod, name, fn in hooks:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _dkv_placements(rule: AttnRule) -> tuple:
    """dk / dv: as k / v, except Partial over the query-head dims where the
    KV heads are replicated and sliced."""
    return tuple(P if (rule.kv_sliced and j in rule.head_dims) else p for j, p in enumerate(rule.kv))


def _attention_backward_local(rule, real_bwd, q, k, v, o, do, causal, sizes, coord, h, hkv):
    if not rule.kv_sliced:
        return real_bwd(q, k, v, o, do, causal)
    s = _kv_slice(rule, sizes, coord, h, hkv)
    dq, dk_s, dv_s = real_bwd(q, k[:, s], v[:, s], o, do, causal)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    dk[:, s] = dk_s
    dv[:, s] = dv_s
    return dq, dk, dv


def _conv_backward_local(rule: ConvRule, br: dict, real_bwd, dy: dict, x: dict, w: dict, stride, padding, groups,
                         needs, sizes, x_shape) -> dict:
    """Each rank's (dx, dW, db) under the backward rule: the library /
    K1-dgrad backward on the blocks; for a halo-ruled conv, on the
    gathered x and dy, the rank keeping its rows of dx and the share of dW
    and db its own output rows give."""
    depthwise = groups > 1
    out = {}
    for c in dy:
        g = x[c].shape[3] if depthwise else 1
        if rule.route != "K2":
            out[c] = real_bwd(dy[c], x[c], w[c], stride, padding, g, needs)
            continue
        mine = _own(dy[c], rule, sizes, c, 1, 2)
        dx, _, _ = real_bwd(dy[c], x[c], w[c], stride, padding, g, (needs[0], False, False))
        _, dw, db = real_bwd(mine, x[c], w[c], stride, padding, g, (False, needs[1], needs[2]))
        if dx is not None:
            dx = _own(dx, rule, sizes, c, 1, 2, crop=True)
        out[c] = (dx, dw, db)
    return out


def _own(t: torch.Tensor, rule: ConvRule, sizes, coord, h_axis: int, w_axis: int, crop: bool = False):
    """A gathered tensor's rows (and columns) of the rank at ``coord``:
    cropped to them, or, without ``crop``, the others zeroed."""
    sl = [slice(None)] * t.dim()
    for axis, dims in ((h_axis, rule.h_dims), (w_axis, rule.w_dims)):
        if not dims:
            continue
        n = _ways(sizes, dims)
        r = 0
        for j in dims:
            r = r * sizes[j] + coord[j]
        step = t.shape[axis] // n
        sl[axis] = slice(r * step, (r + 1) * step)
    if crop:
        return t[tuple(sl)]
    if t.device.type == "meta":
        return t
    out = torch.zeros_like(t)
    out[tuple(sl)] = t[tuple(sl)]
    return out


# ---------------------------------------------------------------------------
# the emulation: every rank's block on one device
# ---------------------------------------------------------------------------


def local_of(t: torch.Tensor, pl, sizes, coord) -> torch.Tensor:
    """The block of the global tensor ``t`` that the rank at ``coord``
    holds under placements ``pl`` (Shard: ``torch.chunk``'s split, major
    mesh dims first; Replicate: all of it; Partial: all of it on the
    group's first rank, zeros on the others, which sum to it)."""
    for j, p in enumerate(pl):
        if isinstance(p, Shard):
            t = torch.chunk(t, sizes[j], dim=p.dim)[coord[j]]
        elif p.is_partial() and coord[j]:
            t = torch.zeros_like(t)
    return t


def assemble(blocks: dict, pl, sizes) -> torch.Tensor:
    """The global tensor of every rank's block under ``pl``: Shard blocks
    concatenated, Partial ones summed, Replicate ones taken from the first
    rank, the minor mesh dims first."""
    blocks = dict(blocks)
    for j in reversed(range(len(sizes))):
        merged = {}
        for c in blocks:
            if c[j]:
                continue
            line = [c[:j] + (i,) + c[j + 1:] for i in range(sizes[j])]
            parts = [blocks[q] for q in line]
            p = pl[j]
            if isinstance(p, Shard):
                merged[c] = torch.cat(parts, dim=p.dim)
            elif p.is_partial():
                merged[c] = torch.stack([q.float() for q in parts]).sum(0).to(parts[0].dtype)
            else:
                merged[c] = parts[0]
        blocks = merged
    return blocks[(0,) * len(sizes)]


def _redistribute(blocks: dict, src, dst, sizes, moved: dict) -> dict:
    """Every rank's block moved from placements ``src`` to ``dst`` by real
    device copies, as DTensor's redistribution does it (the minor mesh dims
    first): Shard -> Replicate an all-gather (``torch.cat`` of the line's
    blocks), Partial -> Replicate an all-reduce (their sum, in float32),
    Partial -> Shard a reduce-scatter, Replicate -> Shard a local slice,
    Shard -> Shard an all-to-all.  Rank 0's result bytes are added to
    ``moved`` by kind (an all-gather's result is the line's blocks at the
    largest block's size)."""
    cur = list(src)
    origin = (0,) * len(sizes)
    for j in reversed(range(len(sizes))):
        a, b = cur[j], dst[j]
        if a == b:
            continue
        if a.is_partial():
            new = {}
            for c in blocks:
                idx, line = _line(c, (j,), sizes)
                total = torch.stack([blocks[q].float() for q in line]).sum(0).to(blocks[c].dtype)
                new[c] = total if isinstance(b, Replicate) else torch.chunk(total, sizes[j], dim=b.dim)[idx].contiguous()
            if sizes[j] > 1:
                _add(moved, "all-reduce" if isinstance(b, Replicate) else "reduce-scatter",
                     _nbytes(new[origin].shape, new[origin].dtype))
            blocks, cur[j] = new, b
            continue
        new = {}
        for c in blocks:
            idx, line = _line(c, (j,), sizes)
            if isinstance(a, Shard) and isinstance(b, Replicate):
                new[c] = torch.cat([blocks[q] for q in line], dim=a.dim)
            elif isinstance(a, Replicate) and isinstance(b, Shard):
                new[c] = torch.chunk(blocks[c], sizes[j], dim=b.dim)[idx].contiguous()
            else:  # Shard(a) -> Shard(b)
                whole = torch.cat([blocks[q] for q in line], dim=a.dim)
                new[c] = torch.chunk(whole, sizes[j], dim=b.dim)[idx]
        if isinstance(a, Shard) and sizes[j] > 1:  # a group of one moves nothing
            kind = "all-gather" if isinstance(b, Replicate) else "all-to-all"
            block = blocks[origin]
            most = max(blocks[q].shape[a.dim] for q in _line(origin, (j,), sizes)[1])
            shape = list(block.shape)
            shape[a.dim] = most * (sizes[j] if kind == "all-gather" else 1)
            _add(moved, kind, _nbytes(shape, block.dtype))
        blocks = {c: t.contiguous() if isinstance(a, Shard) else t for c, t in new.items()}
        cur[j] = b
    return blocks


def _coords(sizes):
    return [tuple(c) for c in itertools.product(*(range(s) for s in sizes))]


def _public_conv(x, w, b, stride, padding, groups):
    from ..kernels.conv2d import conv2d_cuda

    return conv2d_cuda(x, w, b, stride=stride, padding=padding, groups=groups)


def _public_halo(x, top, bot, w, b, stride, padding, groups, lo, hi, ho, wo):
    from ..kernels.halo_conv import halo_conv2d_cuda

    return halo_conv2d_cuda(x, top, bot, w, b, stride=stride, padding=padding, groups=groups, lo=lo, hi=hi)


def emulate(call: Call, operands: tuple, sizes) -> tuple[tuple, dict, tuple]:
    """Replay one logged kernel call on every rank of a mesh of ``sizes``
    held on one device: each rank's operand blocks cut from the global
    ``operands`` by the logged placements, redistributed to the rule's by
    real device copies, the local launches through the kernels' wrappers
    (K1, K2 after a real halo exchange, K3; the backward), and the outputs
    assembled by the rule's output placements.  Returns (outputs, rank 0's
    moved bytes by kind -> [calls, bytes], rank 0's operand blocks as its
    local launch took them)."""
    from ..kernels.attention import ops as attn_ops
    from ..kernels.conv2d import ops as conv_ops

    coords = _coords(sizes)
    moved: dict = {}
    exchange = _LocalExchange(moved)

    def blocks_of(t, pl):  # each rank's own copy of its block
        return {c: local_of(t, pl, sizes, c).contiguous() for c in coords}

    def moved_to(t, src, dst):
        return _redistribute(blocks_of(t, src), src, dst, sizes, moved) if t is not None else dict.fromkeys(coords)

    if call.kernel == "K1":
        x, w, b = operands
        stride, padding, groups, _ = call.statics
        rule = plan_conv(call.placements[0], call.placements[1], tuple(x.shape), tuple(w.shape), stride, padding,
                         groups, sizes)
        xs = moved_to(x, call.placements[0], rule.x)
        ws = moved_to(w, call.placements[1], rule.w)
        bs = moved_to(b, call.placements[2], rule.b) if b is not None else dict.fromkeys(coords)
        if b is not None and rule.partial:  # the bias on the first rank of each Partial group only
            bs = {c: (t if all(c[j] == 0 for j in rule.partial) else None) for c, t in bs.items()}
        ys = _conv_local(rule, (_public_conv, _public_halo), xs, ws, bs, stride, padding, groups, exchange, sizes)
        origin = coords[0]
        return (assemble(ys, rule.y, sizes),), moved, (xs[origin], ws[origin])
    if call.kernel == "K1 backward":
        dy, x, w = operands
        stride, padding, groups, _, needs = call.statics
        rule = plan_conv(call.placements[1], call.placements[2], tuple(x.shape), tuple(w.shape), stride, padding,
                         groups, sizes)
        br = conv_backward_rule(rule)
        dys = moved_to(dy, call.placements[0], br["dy"])
        xs = moved_to(x, call.placements[1], br["x"])
        ws = moved_to(w, call.placements[2], rule.w)
        got = _conv_backward_local(rule, br, conv_ops.conv2d_backward, dys, xs, ws, stride, padding, groups, needs,
                                   sizes, tuple(x.shape))
        outs = tuple(assemble({c: got[c][i] for c in coords}, br[key], sizes) if needs[i] else None
                     for i, key in enumerate(OUTPUTS["K1 backward"]))
        return outs, moved, ()
    if call.kernel == "K3":
        q, k, v = operands
        causal, _ = call.statics
        rule = plan_attention(call.placements[0], call.placements[1], tuple(q.shape), tuple(k.shape), sizes)
        qs = moved_to(q, call.placements[0], rule.q)
        ks = moved_to(k, call.placements[1], rule.kv)
        vs = moved_to(v, call.placements[2], rule.kv)
        h, hkv = q.shape[1], k.shape[1]
        os_, used = {}, {}
        for c in coords:
            kl, vl = ks[c], vs[c]
            if rule.kv_sliced:
                s = _kv_slice(rule, sizes, c, h, hkv)
                kl, vl = kl[:, s], vl[:, s]
            used[c] = qs[c], kl, vl
            os_[c] = attn_ops._attend(qs[c], kl, vl, causal)
        return (assemble(os_, rule.q, sizes),), moved, used[coords[0]]
    if call.kernel == "K3 backward":
        q, k, v, o, do = operands
        causal, _ = call.statics
        rule = plan_attention(call.placements[0], call.placements[1], tuple(q.shape), tuple(k.shape), sizes)
        qs = moved_to(q, call.placements[0], rule.q)
        ks = moved_to(k, call.placements[1], rule.kv)
        vs = moved_to(v, call.placements[2], rule.kv)
        os_ = moved_to(o, call.placements[3], rule.q)
        dos = moved_to(do, call.placements[4], rule.q)
        h, hkv = q.shape[1], k.shape[1]
        got = {c: _attention_backward_local(rule, attn_ops.attention_backward, qs[c], ks[c], vs[c], os_[c], dos[c],
                                            causal, sizes, c, h, hkv) for c in coords}
        dkv = _dkv_placements(rule)
        outs = tuple(assemble({c: got[c][i] for c in coords}, pl, sizes) for i, pl in enumerate((rule.q, dkv, dkv)))
        return outs, moved, ()
    raise ValueError(f"no rule for {call.kernel}")


def _key(kernel: str, shapes) -> tuple:
    return kernel, tuple(None if s is None else tuple(s) for s in shapes)


@contextlib.contextmanager
def replaying(calls: list, sizes, hold=None):
    """While entered, every call of the kernels' entry points (plain
    tensors: the unsharded step on a device) runs as before and is then
    replayed by :func:`emulate` with the placements of the logged call of
    the same kernel and shapes, in order (``calls``: a collective pass's
    log at the same sizes).  Each replay appends a dict to the yielded
    list: the logged call, the outputs (``want`` unsharded, ``got``
    emulated), rank 0's moved bytes (``moved``), the whole ``operands`` and
    rank 0's ``blocks``; ``hold(record)`` is called on each as it is made
    (the caller's gate), and may drop the tensors."""
    from ..kernels.attention import ops as attn_ops
    from ..kernels.conv2d import ops as conv_ops

    queues: dict = {}
    for call in calls:
        queues.setdefault(_key(call.kernel, call.shapes), []).append(call)
    records: list = []
    real_conv, real_bwd = conv_ops._conv, conv_ops.conv2d_backward
    real_attend, real_attn_bwd = attn_ops._attend, attn_ops.attention_backward
    busy = []  # an emulation's own local calls are not replayed again

    def replay(kernel, shapes, operands, want):
        if busy:
            return
        queue = queues.get(_key(kernel, shapes))
        if not queue:
            raise RuntimeError(f"{kernel} {shapes}: no logged call left to replay")
        call = queue.pop(0)
        busy.append(call)
        try:
            with torch.no_grad():
                got, moved, blocks = emulate(call, operands, sizes)
        finally:
            busy.pop()
        rec = dict(call=call, want=want, got=got, moved=moved, operands=operands, blocks=blocks)
        records.append(rec)
        if hold is not None:
            hold(rec)

    def conv(x, weights, bias, stride, padding, groups):
        y, launched = real_conv(x, weights, bias, stride, padding, groups)
        replay("K1", (tuple(x.shape), tuple(weights.shape), None if bias is None else tuple(bias.shape)),
               (x, weights, bias), (y,))
        return y, launched

    def conv_backward(dy, x, weights, stride, padding, groups, needs):
        out = real_bwd(dy, x, weights, stride, padding, groups, needs)
        replay("K1 backward", (tuple(dy.shape), tuple(x.shape), tuple(weights.shape)), (dy, x, weights), out)
        return out

    def attend(q, k, v, causal):
        o = real_attend(q, k, v, causal)
        replay("K3", (tuple(q.shape), tuple(k.shape), tuple(v.shape)), (q, k, v), (o,))
        return o

    def attention_backward(q, k, v, o, do, causal):
        out = real_attn_bwd(q, k, v, o, do, causal)
        replay("K3 backward", (tuple(q.shape), tuple(k.shape), tuple(v.shape)), (q, k, v, o, do), out)
        return out

    with _hooked(conv, conv_backward, attend, attention_backward):
        yield records
