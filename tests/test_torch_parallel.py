"""The port's parallel modules (``repro_torch.parallel``: sharding rules,
hints, GPipe; ``launch.mesh``'s production mesh) against the JAX package, on
the CPU.

* Specs: every unskipped cell of every arch but VGG-16, on both production
  meshes, under ``base`` and under the variants whose knobs the family's
  rules read (LM ``vocab_shard``, ``fsdp_all``, ``ep_off``; diffusion
  ``spatial2d``): each leaf's spec and shard shape equal JAX's
  ``NamedSharding`` on an ``AbstractMesh``, leaf by leaf by path (the port's
  dicts keep their order, JAX's are sorted), for the state and the inputs;
  the per-device argument bytes equal the sum over JAX's shard shapes.
* Hints: the SMOKE Qwen3 and moonshot forwards call ``constrain`` with JAX's
  names, in JAX's order, on JAX's shapes (JAX's recorded by wrapping
  ``repro.parallel.hints.constrain``, whose scan body runs once a stack: its
  calls are repeated for each layer of the stack), and their outputs are
  bit-equal with the rules installed and without.
* Pipeline: ``bubble_fraction`` at ``tests/test_core_properties.py``'s
  cases; ``pipeline_apply`` over ViT SMOKE blocks at S = 2 / 4 and M = 1 / 3
  / 8 against JAX's under ``shard_map`` (``tests/torch_pipeline_jax_ref.py``,
  4 forced host devices, in a subprocess) within 2e-5 x (1 + |y|); over a
  4-rank gloo ``DistComm`` (``tests/torch_pipeline_dist_impl.py``) bit-equal
  to ``LocalComm``.
"""
import functools
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get as jget
from repro.configs import list_archs as jlist_archs
from repro.configs import steps as jsteps
from repro.models import transformer_lm as jlm
from repro.parallel import hints as jhints
from repro.parallel import sharding as jsharding
from repro.parallel import variants as jvariants
from repro_torch.configs import get, list_archs
from repro_torch.configs.steps import build
from repro_torch.launch.mesh import Mesh, dp_axes, fsdp_axes, make_production_mesh, mesh_axes
from repro_torch.models import transformer_lm as lm
from repro_torch.parallel import bubble_fraction, hints, pipeline_apply, sharding, variants
from repro_torch.spatial import LocalComm

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
TOL = 2e-5
MESHES = {"pod16x16": False, "pod2x16x16": True}
FAMILY_VARIANTS = {"lm": ("base", "vocab_shard", "fsdp_all", "ep_off"), "diffusion": ("base", "spatial2d"),
                   "vision": ("base",)}
CELLS = [(a, c) for a in jlist_archs() if a != "vgg16" for c, cell in jget(a).cells.items() if not cell.skip]
SPEC_CASES = [(a, c, mesh, v) for a, c in CELLS for mesh in MESHES for v in FAMILY_VARIANTS[jget(a).family]]


@functools.cache
def _jax_bundle(arch: str, cell: str):
    return jsteps.build(jget(arch), cell)


@functools.cache
def _port_bundle(arch: str, cell: str):
    return build(get(arch), cell)


@functools.cache
def _jax_mesh(multi_pod: bool):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


@pytest.fixture
def variant():
    """Sets a variant in both packages for the test, then restores ``base``."""
    def set_both(name):
        jvariants.set_variant(name)
        variants.set_variant(name)

    yield set_both
    set_both("base")


def _jax_named(tree) -> dict:
    return {jsharding._path_str(path): sh
            for path, sh in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]}


def _jax_leaves(tree) -> dict:
    return {jsharding._path_str(path): leaf for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _held(port_sh, port_specs, jax_sh, jax_specs) -> int:
    """Every leaf's spec and shard shape equal, by path; returns JAX's bytes
    a device (the sum of its shard shapes times the item sizes)."""
    mine = sharding.named_shardings(port_sh, port_specs)
    theirs, shapes = _jax_named(jax_sh), _jax_leaves(jax_specs)
    assert set(mine) == set(theirs) == set(shapes), sorted(set(mine) ^ set(theirs))
    total = 0
    for path, (sh, (shape, dtype)) in mine.items():
        jsh, leaf = theirs[path], shapes[path]
        assert sh.spec == tuple(jsh.spec), (path, sh.spec, jsh.spec)
        assert tuple(shape) == tuple(leaf.shape), path
        want = jsh.shard_shape(leaf.shape)
        assert sh.shard_shape(shape) == tuple(want), (path, sh.shard_shape(shape), want)
        total += int(np.prod(want, dtype=np.int64)) * leaf.dtype.itemsize
    return total


def test_production_mesh_matches_jax():
    for multi in (False, True):
        m, jm = make_production_mesh(multi_pod=multi), _jax_mesh(multi)
        assert m.axis_names == tuple(jm.axis_names) and m.shape == dict(jm.shape) and m.size == jm.size
        assert mesh_axes(m) == tuple(jm.axis_names)
        assert dp_axes(m) == jsharding.dp_axes(jm) and fsdp_axes(m) == jsharding.fsdp_axes(jm)
    with pytest.raises(ValueError):
        Mesh(("data", "data"), (2, 2))


@pytest.mark.parametrize("arch,cell,mesh,name", SPEC_CASES, ids=["-".join(c) for c in SPEC_CASES])
def test_shardings_match_jax(arch, cell, mesh, name, variant):
    variant(name)
    multi = MESHES[mesh]
    port_mesh, jmesh = make_production_mesh(multi_pod=multi), _jax_mesh(multi)
    jb, pb = _jax_bundle(arch, cell), _port_bundle(arch, cell)
    ja, pa = jget(arch), get(arch)
    if pb.kind == "train":
        st, jst = sharding.state_shardings(pb.state, pa, port_mesh), jsharding.state_shardings(jb.state, ja, jmesh)
    else:
        st, jst = sharding.param_shardings(pb.state, pa, port_mesh), jsharding.param_shardings(jb.state, ja, jmesh)
    state_bytes = _held(st, pb.state, jst, jb.state)
    ins = sharding.input_shardings(pb.inputs, pa, pa.cells[cell], port_mesh)
    jins = jsharding.input_shardings(jb.inputs, ja, ja.cells[cell], jmesh)
    input_bytes = _held(ins, pb.inputs, jins, jb.inputs)
    assert sharding.sharded_bytes((st, ins), (pb.state, pb.inputs)) == state_bytes + input_bytes


def test_every_unskipped_cell_is_covered():
    assert len(CELLS) == sum(1 for a in list_archs() if a != "vgg16" for c in get(a).cells.values() if not c.skip)
    assert {c[3] for c in SPEC_CASES} == {"base", "vocab_shard", "fsdp_all", "ep_off", "spatial2d"}


def test_sharding_shard_shape_refuses_an_uneven_split():
    s = sharding.Sharding(make_production_mesh(), ("data", None))
    assert s.shard_shape((32, 5)) == (2, 5)
    with pytest.raises(ValueError, match="does not divide"):
        s.shard_shape((24, 5))
    with pytest.raises(ValueError, match="more entries"):
        s.shard_shape((24,))


# ---------------------------------------------------------------------------
# hints
# ---------------------------------------------------------------------------


class _Recorder:
    """A rule that records the name and shape of each ``constrain`` call."""

    def __init__(self, name, log):
        self.name, self.log = name, log

    def shard_shape(self, shape):
        self.log.append((self.name, tuple(shape)))
        return tuple(shape)


HINT_NAMES = ("moe_tokens", "moe_slots", "lm_residual")


@pytest.mark.parametrize("arch", ["qwen3-4b", "moonshot-v1-16b-a3b"])
def test_hints_follow_jax(arch, monkeypatch):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, size=(2, 16), dtype=np.int32)
    # JAX's calls: its scan body (the block, then lm_residual) runs once a stack
    jlog = []
    monkeypatch.setattr(jhints, "constrain", lambda x, name: jlog.append((name, tuple(x.shape))) or x)
    jcfg = jget(arch).smoke_cfg
    jlm.forward(jlm.init(jax.random.PRNGKey(0), jcfg), jcfg, tokens)
    segments, cur = [], []
    for call in jlog:
        cur.append(call)
        if call[0] == "lm_residual":
            segments.append(cur)
            cur = []
    assert not cur and segments, jlog
    cfg = get(arch).smoke_cfg
    stacks = list(lm._stacks(cfg))
    assert len(stacks) == len(segments)
    want = [call for seg, (_, _, n, _) in zip(segments, stacks) for _ in range(n) for call in seg]

    params = get(arch).module.init(torch.Generator().manual_seed(0), cfg)
    t = torch.from_numpy(tokens)
    hints.clear_rules()
    plain, plain_lb = lm.forward(params, cfg, t)
    log = []
    hints.set_rules({name: _Recorder(name, log) for name in HINT_NAMES})
    try:
        ruled, ruled_lb = lm.forward(params, cfg, t)
    finally:
        hints.clear_rules()
    assert log == want
    assert torch.equal(plain, ruled) and torch.equal(plain_lb, ruled_lb)
    assert ("moe_slots" in {n for n, _ in log}) == (arch != "qwen3-4b")


def test_constrain_returns_its_input():
    x = torch.randn(32, 32, 8)
    hints.set_rules({"lm_residual": sharding.Sharding(make_production_mesh(), ("data", "model", None))})
    try:
        assert hints.constrain(x, "lm_residual") is x
        assert hints.constrain(x, "moe_tokens") is x  # no rule: x
        with pytest.raises(ValueError):  # a rule that cannot split x raises, as the pinned sharding would
            hints.constrain(torch.randn(32, 30, 8), "lm_residual")
    finally:
        hints.clear_rules()
    assert hints.constrain(torch.randn(4, 30, 8), "lm_residual").shape == (4, 30, 8)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


def test_bubble_fraction():
    assert bubble_fraction(2, 1) == pytest.approx(0.5)
    assert bubble_fraction(2, 14) == pytest.approx(1 / 15)
    assert bubble_fraction(8, 56) == pytest.approx(7 / 63)
    assert bubble_fraction(2, 8) == 1 / 9


@pytest.fixture(scope="module")
def jax_pipeline(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipeline") / "jax.npz"
    proc = subprocess.run([sys.executable, str(HERE / "torch_pipeline_jax_ref.py"), str(path)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return np.load(path)


def _local(data, s: int, m: int) -> torch.Tensor:
    from torch_pipeline_dist_impl import stage_fn, stage_params

    params = [stage_params(data, s, i) for i in range(s)]
    return pipeline_apply(params, torch.from_numpy(data[f"S{s}/M{m}/x"]), stage_fn, LocalComm(s, "cpu"))


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_pipeline_matches_jax_shard_map(jax_pipeline, s, m):
    from torch_pipeline_dist_impl import stage_fn, stage_params

    torch.set_num_threads(2)
    got = _local(jax_pipeline, s, m)
    want = jax_pipeline[f"S{s}/M{m}/y"]
    assert got.shape == want.shape
    assert np.all(np.abs(got.numpy() - want) <= TOL * (1 + np.abs(want))), np.abs(got.numpy() - want).max()
    # and each microbatch is the same blocks run unpipelined, bit for bit
    x = torch.from_numpy(jax_pipeline[f"S{s}/M{m}/x"])
    for i in range(m):
        y = x[i]
        for stage in range(s):
            y = stage_fn(stage_params(jax_pipeline, s, stage), y)
        assert torch.equal(got[i], y)


def test_pipeline_counts_every_tick(monkeypatch):
    calls = []

    def stage_fn(p, x):
        calls.append(p)
        return x + p

    x = torch.zeros(3, 2)
    out = pipeline_apply([1.0, 10.0], x, stage_fn, LocalComm(2, "cpu"))
    assert len(calls) == (2 + 3 - 1) * 2
    assert torch.equal(out, torch.full((3, 2), 11.0))
    with pytest.raises(ValueError, match="local stages"):
        pipeline_apply([1.0], x, stage_fn, LocalComm(2, "cpu"))


def test_pipeline_over_gloo_equals_local_comm(jax_pipeline, tmp_path):
    from torch_pipeline_dist_impl import S

    weights = tmp_path / "weights.npz"
    np.savez(weights, **{k: jax_pipeline[k] for k in jax_pipeline.files})
    proc = subprocess.run([sys.executable, str(HERE / "torch_pipeline_dist_impl.py"), str(weights), str(tmp_path)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    torch.set_num_threads(2)
    for m in (1, 3, 8):
        want = _local(jax_pipeline, S, m).numpy()
        for r in range(S):
            got = np.load(tmp_path / f"rank{r}.npz")[f"M{m}"]
            assert np.array_equal(got, want), (m, r)
