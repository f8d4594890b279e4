"""The collective half of the port's dry run (``repro_torch.launch.collectives``,
``parallel.placements``, ``parallel.kernel_rules``, ``launch.dryrun``'s
collective pass) on the CPU.

* Identities, exact, derived here from the step itself: (b) a dense product
  ``x[B, D]`` over data times ``w[D, F]``: 0 collectives with ``w`` sharded
  ``(None, "model")``; one all-reduce of ``[B/d, F]``'s bytes with ``w``
  sharded ``("model", None)`` and a replicated consumer; the all-gather of
  ``w``'s fsdp dim with ``w`` sharded ``("data", "model")``; (c) a SMOKE
  ViT train step on ``Mesh((2, 1))`` (every parameter replicated): one
  all-reduce of exactly the parameter bytes plus the loss's scalar, nothing
  else; (d) SMOKE ConvNeXt ``serve_b1`` with H over a 4-way data axis: one
  collective-permute a side for each 7x7 conv whose shards hold their
  halo (stage 1 by the config), of ``halo_sizes`` rows x W x C x 4 bytes,
  and all-gathers only for the convs the record lists as gathered; (e) a
  SMOKE moonshot MoE layer under ``base`` against ``ep_off``
  (``gather_experts``) on a 2-way model axis: one all-gather of the
  experts' outputs, E x capacity x d x itemsize, and nothing else apart.
* Against JAX's ``analyze_hlo`` of GSPMD's program (a subprocess with the
  case's mesh of forced host devices, ``tests/torch_collectives_jax_ref.py``):
  (c)'s all-reduce bytes equal; (d)'s collective-permutes of the stage-1
  halos ``[1, 3, 16, 32]`` equal in count and bytes.  JAX's program also has
  two permutes ``f32[1, 1, 2, 128]`` in stage 4, where a shard holds half a
  row and the port's rule all-gathers instead (ROADMAP.md §3).
* ``run_cell`` at SMOKE sizes on a three-axis mesh for each kind (serve,
  prefill, decode, gen, train) is ``ok`` with JAX's collective keys, its
  kernels' collectives within the step's, and no fake group left open; on
  a one-device mesh it runs no pass.  Only a view DTensor cannot take of a
  split runs replicated (any other DTensor error is raised), and a
  strided shard's estimated cost bans a move into ``Partial``.
* Rules: every kernel rule's assembled outputs, replayed on every rank of
  the mesh (``kernel_rules.replaying``: the plain versions on the CPU),
  equal to the unsharded call, and rank 0's exchanged bytes equal to the
  dry run's ``kernel_collectives``; the 2-D halo rule (H over data, W over
  model) and the depthwise one at a conv of their own; no rule marks the
  gradient of a weight replicated over a sharded batch Replicate.
"""
import functools
import json
import subprocess
import sys
import types
from collections import Counter
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs import get
from repro_torch.configs.steps import _shrink, _zeros, build, realize
from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref
from repro_torch.launch import collectives, dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe
from repro_torch.parallel import hints, kernel_rules, placements, variants
from repro_torch.parallel.sharding import Sharding, input_shardings, param_shardings, state_shardings
from repro_torch.spatial.halo import halo_sizes
from test_torch_dryrun import _smoke_arch

HERE = Path(__file__).resolve().parent
torch.set_num_threads(2)
MESH22 = Mesh(("data", "model"), (2, 2))


def _count(fn, state, state_sh, inputs, in_sh, out_sh, mesh, calls=None) -> collectives.Collectives:
    """A step of our own through the dry run's collective pass."""
    bundle = types.SimpleNamespace(fn=fn, state=_specs(state), inputs=_specs(inputs))
    return dryrun.collective_pass(bundle, mesh, state_sh, in_sh, out_sh, calls=calls)


def smoke_pass(arch: str, cell: str, mesh: Mesh, variant: str = "base", calls=None) -> collectives.Collectives:
    """The dry run's collective pass over a cell's float32 SMOKE step
    (``steps.build(smoke=True)``, as JAX's reference lowers it), with the
    shardings, hints and output shardings ``run_cell`` pins."""
    a = get(arch)
    c = _shrink(a.cells[cell])
    variants.set_variant(variant)
    dryrun._install_hints(mesh)
    try:
        b = build(a, cell, smoke=True)
        in_sh = input_shardings(b.inputs, a, c, mesh)
        state_sh = state_shardings(b.state, a, mesh) if b.kind == "train" else param_shardings(b.state, a, mesh)
        index = c.meta["seq_len"] - 1 if b.kind == "decode" else None
        inputs = {k: _zeros(v, "meta") for k, v in b.inputs.items()}
        if index is not None:
            inputs["index"] = index
        out = b.fn(_zeros(b.state, "meta"), **inputs)
        out_sh = dryrun._out_shardings(b.kind, dryrun._spec_of(out), mesh, state_sh, in_sh)
        return dryrun.collective_pass(b, mesh, state_sh, in_sh, out_sh, index, calls)
    finally:
        hints.clear_rules()
        variants.set_variant("base")


def _nbytes(shape, dtype=torch.float32) -> int:
    return collectives.shape_bytes(shape, dtype)


def _only(coll, **want):
    got = {k: v for k, v in coll.per_collective.items() if v}
    assert got == want, (got, want)


# ---------------------------------------------------------------------------
# (b) a dense product
# ---------------------------------------------------------------------------

B, D, F = 8, 16, 32


@pytest.mark.parametrize("w_spec,out_spec,want", [
    ((None, "model"), ("data", "model"), {}),
    (("model", None), ("data", None), {"all-reduce": _nbytes((B // 2, F))}),
    (("data", "model"), ("data", "model"), {"all-gather": _nbytes((D, F // 2))}),
])
def test_dense_product_identities(w_spec, out_spec, want):
    state = {"w": torch.empty(D, F, device="meta")}
    inputs = {"x": torch.empty(B, D, device="meta")}
    coll = _count(lambda s, x: x @ s["w"], state, {"w": Sharding(MESH22, w_spec)}, inputs,
                  {"x": Sharding(MESH22, ("data", None))}, Sharding(MESH22, out_spec), MESH22)
    _only(coll, **want)
    assert sum(coll.counts.values()) == len(want)


# ---------------------------------------------------------------------------
# (a) / dry run: the pass leaves no process group behind
# ---------------------------------------------------------------------------


def test_the_pass_closes_its_fake_group():
    rec = dryrun.run_cell(_smoke_arch("vit-l16"), "serve_b1", mesh=Mesh(("data", "model"), (2, 1)), verbose=False)
    assert rec["status"] == "ok" and rec["collective_trace_s"] > 0
    assert not dist.is_initialized()


def test_one_device_cell_runs_no_pass():
    """(a) without a pass: a one-device mesh moves nothing, so ``run_cell``
    records no collective and logs no kernel call of a pass."""
    calls = []
    rec = dryrun.run_cell(_smoke_arch("vit-l16"), "cls_224", mesh=Mesh(("data", "model"), (1, 1)), verbose=False,
                          calls=calls)
    assert rec["status"] == "ok" and calls == []
    assert rec["collectives"] == {**dict.fromkeys(collectives.KINDS, 0), "total": 0,
                                  "counts": dict.fromkeys(collectives.KINDS, 0)}
    assert rec["kernel_collectives"] == {} and rec["replicated_ops"] == {} and rec["estimated_costs"] == 0
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (c) data parallelism: the gradient all-reduce, against JAX
# ---------------------------------------------------------------------------


def _spec_bytes(tree) -> int:
    if isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[1], torch.dtype):
        return _nbytes(tree[0], tree[1])
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(_spec_bytes(v) for v in items)


@functools.cache
def _jax(arch: str, cell: str, data: int, model: int) -> dict:
    out = subprocess.run([sys.executable, str(HERE / "torch_collectives_jax_ref.py"), arch, cell, str(data),
                          str(model), "float32"], capture_output=True, text=True, timeout=600,
                         env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@functools.cache
def _vit_dp():
    calls = []
    coll = smoke_pass("vit-l16", "cls_224", Mesh(("data", "model"), (2, 1)), calls=calls)
    return coll, calls


def test_data_parallel_train_step_all_reduces_every_gradient_once():
    got, _ = _vit_dp()
    b = build(get("vit-l16"), "cls_224", smoke=True)
    params = _spec_bytes(b.state[0])
    metrics = _nbytes(())  # the loss, a float32 scalar
    coll = got.record()
    assert coll["all-reduce"] == params + metrics
    assert coll["total"] == coll["all-reduce"] and coll["counts"]["all-reduce"] == len(_leaves(b.state[0])) + 1
    assert not got.replicated_ops


def test_data_parallel_all_reduce_equals_jax():
    got, _ = _vit_dp()
    want = _jax("vit-l16", "cls_224", 2, 1)["per_collective"]
    assert got.per_collective["all-reduce"] == want["all-reduce"]
    assert got.record()["total"] == sum(want.values())


def _leaves(tree):
    if isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[1], torch.dtype):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [x for v in items for x in _leaves(v)]


def test_no_rule_marks_a_weight_gradient_over_a_sharded_batch_replicate():
    _, calls = _vit_dp()
    (bwd,) = [c for c in calls if c.kernel == "K1 backward"]
    rule = kernel_rules.plan_conv(bwd.placements[1], bwd.placements[2], bwd.shapes[1], bwd.shapes[2], *bwd.statics[:3],
                                  (2, 1))
    grads = kernel_rules.conv_backward_rule(rule)
    assert isinstance(rule.x[0], Shard) and rule.x[0].dim == 0 and isinstance(rule.w[0], Replicate)
    assert isinstance(grads["dw"][0], Partial) and isinstance(grads["db"][0], Partial)
    # every rule, at every placement of x a sharded batch or spatial dim gives
    for xp in (Shard(0), Shard(1), Shard(2)):
        for k, s, p in ((3, 1, 1), (1, 1, 0), (2, 2, 0)):
            r = kernel_rules.plan_conv((xp, Replicate()), (Replicate(), Replicate()), (4, 8, 8, 8), (k, k, 8, 8), s,
                                       p, 1, (2, 2))
            g = kernel_rules.conv_backward_rule(r)
            if isinstance(r.x[0], Shard) or r.route == "K2":
                assert isinstance(g["dw"][0], Partial), (xp, k, s, p, r, g)


# ---------------------------------------------------------------------------
# (d) the paper's spatial partition: the halo exchange, against JAX
# ---------------------------------------------------------------------------

SP = Mesh(("data", "model"), (4, 1))


@functools.cache
def _convnext_sp():
    calls = []
    return smoke_pass("convnext-b", "serve_b1", SP, calls=calls), calls


def _stage1_halos():
    """Stage 1 of SMOKE ConvNeXt at serve_b1: the 4x4 stem leaves 64 / 4
    rows, split 4 ways: 4 a shard, which holds a 7x7 halo of 3 rows."""
    cfg = get("convnext-b").smoke_cfg
    rows, w = cfg.img_res // 4, cfg.img_res // 4
    lo, hi = halo_sizes(7, 1, 3)
    assert rows // SP.shape["data"] >= max(lo, hi)
    return [(1, n, w, cfg.dims[0]) for _ in range(cfg.depths[0]) for n in (lo, hi)]


def test_height_sharded_convs_exchange_their_halos():
    got, calls = _convnext_sp()
    coll = got.record()
    halos = _stage1_halos()
    assert coll["collective-permute"] == sum(_nbytes(s) for s in halos)
    assert coll["counts"]["collective-permute"] == len(halos)
    # all-gathers: the convs listed as gathered, each its x whole (C unsharded: model is 1 wide)
    gathered = [c for c in calls if c.route == "gathered"]
    assert gathered and {c.signature() for c in gathered} == set(got.gathered)
    assert coll["all-gather"] == sum(_nbytes(c.shapes[0]) for c in gathered)
    assert coll["counts"]["all-gather"] == len(gathered)
    assert all("fewer than its halo" in why or "stride" in why for why in got.gathered.values())


def test_halo_permutes_equal_jax():
    want = _jax("convnext-b", "serve_b1", 4, 1)["permutes"]
    got = Counter(f"f32[{','.join(map(str, s))}]" for s in _stage1_halos())
    for shape, n in got.items():
        assert sum(c for t, c in want.items() if t.startswith(shape + "{")) == n, (shape, want)


# ---------------------------------------------------------------------------
# (e) expert parallelism against replicated experts
# ---------------------------------------------------------------------------


def _moe_layer(variant: str, mesh: Mesh) -> collectives.Collectives:
    arch = get("moonshot-v1-16b-a3b")
    mcfg = arch.smoke_cfg.moe
    tokens = 2 * 64
    params = moe.moe_init(torch.Generator(), mcfg, device="meta")
    variants.set_variant(variant)
    try:
        sh = param_shardings({"ffn": _specs(params)}, arch, mesh)
        return _count(lambda s, x: moe.moe_apply(s["ffn"], mcfg, x)[0], {"ffn": params}, sh,
                      {"x": torch.empty(tokens, mcfg.d_model, device="meta")},
                      {"x": Sharding(mesh, ("data", None))}, Sharding(mesh, ("data", None)), mesh)
    finally:
        variants.set_variant("base")


def _specs(tree):
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    return {k: _specs(v) for k, v in tree.items()}


def test_expert_parallel_moves_the_experts_outputs():
    mesh = Mesh(("data", "model"), (1, 2))
    mcfg = get("moonshot-v1-16b-a3b").smoke_cfg.moe
    tokens = 2 * 64
    capacity = max(1, int(mcfg.capacity_factor * tokens * mcfg.top_k / mcfg.n_experts))
    if tokens <= mcfg.dropless_below:
        capacity = max(capacity, tokens)
    ep, off = _moe_layer("base", mesh), _moe_layer("ep_off", mesh)
    diff = {k: ep.per_collective[k] - off.per_collective[k] for k in collectives.KINDS}
    assert diff == {**dict.fromkeys(collectives.KINDS, 0),
                    "all-gather": mcfg.n_experts * capacity * mcfg.d_model * 4}, (diff, ep.record(), off.record())


# ---------------------------------------------------------------------------
# the rules replayed on every rank, against the unsharded calls
# ---------------------------------------------------------------------------


def _replayed(arch: str, cell: str, mesh: Mesh, variant: str = "base"):
    calls = []
    coll = smoke_pass(arch, cell, mesh, variant, calls)
    variants.set_variant(variant)
    try:
        a = get(arch)
        b = build(a, cell, smoke=True)
        state, inputs = realize(a, b, torch.Generator().manual_seed(0))
        if b.kind == "decode":
            inputs["index"] = _shrink(a.cells[cell]).meta["seq_len"] - 1
        with kernel_rules.replaying(calls, mesh.sizes) as records:
            b.fn(state, **inputs)
    finally:
        variants.set_variant("base")
    return coll, calls, records


def _held(records):
    for r in records:
        for got, want in zip(r["got"], r["want"]):
            if want is None:
                continue
            assert got.shape == want.shape
            tol = 2e-5 * (1 + want.abs())
            if r["call"].kernel == "K1 backward":  # dW / db: sums over the ranks' shares
                tol = 1e-4 * (1 + want.abs().max())
            assert ((got - want).abs() <= tol).all(), (r["call"].signature(), (got - want).abs().max())


def _moved(records) -> dict:
    out = Counter()
    for r in records:
        for kind, (_, n) in r["moved"].items():
            out[kind] += n
    return dict(out)


def _dry_kernel(coll) -> dict:
    out = Counter()
    for per in coll.kernel_collectives.values():
        for kind, v in per.items():
            if kind != "calls":
                out[kind] += v[1]
    return dict(out)


@pytest.mark.parametrize("arch,cell,sizes,variant", [
    ("vit-l16", "cls_224", (2, 2), "base"),
    ("convnext-b", "serve_b1", (4, 1), "base"),
    ("convnext-b", "serve_b1", (2, 2), "base"),
    ("qwen3-4b", "prefill_32k", (2, 2), "base"),
    ("moonshot-v1-16b-a3b", "prefill_32k", (2, 2), "base"),
    ("dit-xl2", "gen_fast", (2, 2), "spatial2d"),
    ("efficientnet-b7", "serve_b1", (2, 2), "base"),
])
def test_rules_replayed_on_every_rank_equal_the_unsharded_calls(arch, cell, sizes, variant):
    coll, calls, records = _replayed(arch, cell, Mesh(("data", "model"), sizes), variant)
    assert len(records) == len(calls) > 0
    _held(records)
    assert _moved(records) == _dry_kernel(coll)


@pytest.mark.parametrize("groups", [1, 8])
def test_two_dimensional_halo_rule(groups):
    """A 3x3 conv of x [2, 16, 16, 8] with H over data and W over model
    (``spatial2d``'s layout): K2 after the W then the H halo exchange, two
    collective-permutes a side; its assembled output equals the whole conv."""
    mesh = MESH22
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 16, 8, generator=gen)
    w = torch.randn(3, 3, 1 if groups > 1 else 8, 8, generator=gen)
    b = torch.randn(8, generator=gen)
    calls = []
    coll = _count(lambda s, x: conv2d_cuda(x, s["w"], s["b"], stride=1, padding=1, groups=groups),
                  {"w": w.to("meta"), "b": b.to("meta")}, {"w": Sharding(mesh, ()), "b": Sharding(mesh, ())},
                  {"x": x.to("meta")}, {"x": Sharding(mesh, (None, "data", "model", None))},
                  Sharding(mesh, (None, "data", "model", None)), mesh, calls)
    (call,) = calls
    assert call.route == "K2"
    hs, ws = 8, 8
    side = [(2, hs, 1, 8), (2, hs, 1, 8), (2, 1, ws + 2, 8), (2, 1, ws + 2, 8)]
    _only(coll, **{"collective-permute": sum(_nbytes(s) for s in side)})
    (y,), moved, _ = kernel_rules.emulate(call, (x, w, b), mesh.sizes)
    want = conv2d_ref(x, w, b, stride=1, padding=1, groups=groups)
    assert ((y - want).abs() <= 2e-5 * (1 + want.abs())).all()
    assert moved == {"collective-permute": [4, sum(_nbytes(s) for s in side)]}


THREE_AXES = Mesh(("pod", "data", "model"), (2, 2, 2))


@pytest.mark.parametrize("arch,cell", [("vit-l16", "serve_b128"), ("qwen3-4b", "prefill_32k"),
                                       ("moonshot-v1-16b-a3b", "decode_32k"), ("dit-xl2", "gen_fast"),
                                       ("vit-l16", "cls_224")])
def test_each_kind_records_its_collectives(arch, cell):
    rec = dryrun.run_cell(_smoke_arch(arch), cell, mesh=THREE_AXES, verbose=False)
    assert rec["status"] == "ok"
    coll = rec["collectives"]
    assert set(coll) == set(collectives.KINDS) | {"total", "counts"}
    assert coll["total"] == sum(coll[k] for k in collectives.KINDS) > 0
    assert rec["collective_trace_s"] > 0 and isinstance(rec["replicated_ops"], dict)
    for kind in collectives.KINDS:
        ruled = sum(v.get(kind, [0, 0])[1] for v in rec["kernel_collectives"].values())
        assert ruled <= coll[kind]
    assert not dist.is_initialized()


def test_only_views_of_a_split_run_replicated():
    """A view DTensor cannot take of an unevenly split dim runs replicated
    after a counted all-gather and is listed; any other DTensor error (here
    operands on two meshes) is raised, not hidden as a replicated op."""
    from torch.distributed.tensor import DTensor

    with placements.device_mesh(MESH22) as dmesh, collectives.counting() as coll:
        x = placements.distribute(torch.empty(4, 6, 8, device="meta"), Sharding(MESH22, (None, ("data", "model"))),
                                  dmesh)
        y = x.view(4, 48)
        assert y.shape == (4, 48) and all(isinstance(p, Replicate) for p in y.placements)
        assert dict(coll.replicated_ops) == {"aten.view.default": 1}
        assert coll.per_collective["all-gather"] > 0
        a = DTensor.from_local(torch.empty(4, 8, device="meta"), dmesh, [Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(8, 8, device="meta"), dmesh["data"], [Replicate()], run_check=False)
        with pytest.raises(RuntimeError, match="different meshes"):
            a + b
        assert dict(coll.replicated_ops) == {"aten.view.default": 1}
    assert not dist.is_initialized()


def test_strided_costs_are_estimated_and_ban_moves_into_partial():
    """``dryrun._strided_costs``: a cost with a strided shard is estimated
    (counted), one collective of the device's bytes a changed mesh dim, and
    a move from a shard into ``Partial`` costs inf, as DTensor's own cost
    bans it (else a strategy can ask for a move DTensor cannot make)."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    from torch.distributed.tensor._ops import utils as op_utils
    from torch.distributed.tensor.placement_types import _StridedShard

    meta = TensorMeta(torch.Size([8, 8]), (8, 1), torch.float32)
    coll = collectives.Collectives()
    with placements.device_mesh(THREE_AXES) as dmesh, dryrun._strided_costs(coll):
        strided = DTensorSpec(dmesh, (Shard(0), _StridedShard(0, split_factor=2), Replicate()), tensor_meta=meta)

        def to(*pl):
            return op_utils.redistribute_cost(strided, DTensorSpec(dmesh, pl, tensor_meta=meta))

        assert to(Partial(), Replicate(), Replicate()) == float("inf")
        assert to(Replicate(), Replicate(), Replicate()) == 2 * _nbytes((2, 8)) / 2**30
    assert coll.estimated_costs == 2


def test_placements_follow_the_spec():
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    assert placements.placements(Sharding(mesh, (None, ("pod", "data"), "model"))) == (Shard(1), Shard(1), Shard(2))
    assert placements.placements(Sharding(mesh, ("model", None))) == (Replicate(), Replicate(), Shard(0))
    assert placements.placements(Sharding(mesh, ())) == (Replicate(),) * 3
    with pytest.raises(ValueError):  # a tuple out of the mesh's order
        placements.placements(Sharding(Mesh(("data", "model"), (2, 2)), (("model", "data"),)))


def test_coverage_twin_reports_the_port(tmp_path):
    """``tools/measure_coverage_torch.py`` over two port test files, in a
    subprocess: the JAX tool's JSON for ``src/repro_torch`` and the lines no
    test reached."""
    root = HERE.parent
    out = subprocess.run([sys.executable, str(root / "tools" / "measure_coverage_torch.py"),
                          str(HERE / "test_torch_rf.py"), str(HERE / "test_torch_build.py")],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path,
                         env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    rep = json.loads(out.stdout[out.stdout.index("{\n"):])
    assert set(rep) == {"pytest_exit", "covered", "total", "pct", "worst", "unreached"}
    assert 0 < rep["covered"] < rep["total"] and rep["pct"] == round(100.0 * rep["covered"] / rep["total"], 2)
    assert all(path.startswith("src/repro_torch/") for path, _ in rep["worst"])
    # the card's route of K1's wrapper is not reached on the CPU
    assert "src/repro_torch/kernels/conv2d/ops.py" in rep["unreached"]
