"""The port's spatial engine (``repro_torch.spatial.halo``) through
``LocalComm`` against the JAX package's ``conv2d_spatial`` /
``max_pool_spatial`` under ``shard_map``.

The JAX side runs once per module in a subprocess with 4 forced host devices
(``tests/torch_spatial_jax_ref.py``; the forced count must be set before JAX
starts), over the cases of ``tests/spatial_multidev_impl.py`` cut to 4
shards: the geometry sweep, the thin-shard case, the capacity-weighted and
tall-weighted convs, the weighted and equal pools and the 2-block weighted
VGG stack.  Every conv case runs through both of the port's engines and both
``overlap`` values; each is held to the JAX run of the matching engine and
schedule where JAX computed it, else to JAX's fused run (the tall and VGG
cases, which JAX runs fused only).  Tolerance 2e-5 (float32: the same
products summed in another order), as ``tests/test_kernels.py: _tol``.  A
4-rank gloo world checks that ``DistComm`` gives the shards ``LocalComm``
gives.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_spatial_jax_ref as ref
from _torch_parity import jax_vgg_params
from repro.models import vgg as jvgg
from repro_torch.kernels.halo_conv import halo_conv2d_cuda
from repro_torch.models import vgg
from repro_torch.models.common import params_from_jax
from repro_torch.spatial import (
    LocalComm,
    conv2d_spatial,
    features_spatial,
    max_pool_spatial,
    merge_padded_shards,
    to_padded_shards,
)

HERE = Path(__file__).resolve().parent
CASES = ref.cases()
VARIANTS = [("direct", False), ("direct", True), ("fused", True), ("fused", False)]
JAX_ENGINE = {"direct": "lax", "fused": "pallas"}


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_spatial") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(HERE / "torch_spatial_jax_ref.py"), str(out)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    return dict(np.load(out))


def _jax_key(name, engine, overlap, available):
    key = f"{name}/{JAX_ENGINE[engine]}/{overlap if engine == 'direct' else True}"
    return key if key in available else f"{name}/pallas/True"


def _shards(x, heights):
    """The local shards: the padded weighted blocks, or the equal split."""
    x = torch.from_numpy(x)
    return to_padded_shards(x, heights) if heights else list(x.chunk(ref.N, dim=1))


def _merge(ys, heights, s):
    return merge_padded_shards(ys, [h // s for h in heights]) if heights else torch.cat(ys, dim=1)


CONV_PARAMS = [(n, e, o) for n, c in CASES.items() if c["kind"] in ("conv", "vgg")
               for e, o in VARIANTS]


@pytest.mark.parametrize("name,engine,overlap", CONV_PARAMS,
                         ids=[f"{n}-{e}-ov{int(o)}" for n, e, o in CONV_PARAMS])
def test_spatial_conv_matches_jax_shard_map(jax_out, name, engine, overlap):
    c = CASES[name]
    hts = c.get("heights")
    comm = LocalComm(ref.N, "cpu")
    if c["kind"] == "vgg":
        cfg = jvgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10, blocks=ref.VGG_BLOCKS)
        feats = params_from_jax(jax_vgg_params(cfg, seed=7))["features"]
        tcfg = vgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10, blocks=ref.VGG_BLOCKS)
        ys = features_spatial(feats, tcfg.geom(), _shards(ref.pool_input(name, c["shape"]), hts),
                              comm=comm, heights=hts, engine=engine, overlap=overlap)
        got = _merge(ys, hts, 4)
    else:
        x, w, b = ref.conv_inputs(name, c["k"], c["shape"][3], c["c_out"], c["groups"], c["shape"])
        params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
        ys = conv2d_spatial(_shards(x, hts), params, c["k"], c["s"], c["p"], comm=comm,
                            overlap=overlap, groups=c["groups"], engine=engine, heights=hts)
        assert len(ys) == ref.N
        got = _merge(ys, hts, c["s"])
    want = jax_out[_jax_key(name, engine, overlap, jax_out)]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


POOLS = [n for n, c in CASES.items() if c["kind"] == "pool"]


@pytest.mark.parametrize("name", POOLS)
def test_spatial_pool_matches_jax_shard_map(jax_out, name):
    c = CASES[name]
    hts = c.get("heights")
    ys = max_pool_spatial(_shards(ref.pool_input(name, c["shape"]), hts), c["k"], c["s"],
                          comm=LocalComm(ref.N, "cpu"), heights=hts)
    got = _merge(ys, hts, c["s"])
    np.testing.assert_array_equal(got.numpy(), jax_out[name])


def test_weighted_layout_rows_past_valid_stay_zero():
    """The padded-layout invariant after a weighted conv and pool: every row
    past a shard's valid height is zero (what keeps depth lossless)."""
    name = "weighted-k3s1p1g1"
    c = CASES[name]
    x, w, b = ref.conv_inputs(name, 3, 3, 8, 1, c["shape"])
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    hts = ref.WEIGHTED_HEIGHTS
    for engine in ("direct", "fused"):
        ys = conv2d_spatial(_shards(x, hts), params, 3, 1, 1, engine=engine, heights=hts)
        ys = max_pool_spatial(ys, 2, 2, heights=hts)
        for y, h in zip(ys, hts):
            assert y.shape[1] == max(hts) // 2
            assert bool((y[:, h // 2:] == 0).all()) and bool((y[:, : h // 2] != 0).any())


def test_fused_engine_calls_per_shard(monkeypatch):
    """The fused engine calls the halo conv once per shard and, in the
    weighted layout with a bottom halo, one fix-up direct conv per shard
    (the counts chip_smoke.py checks on the card); the direct engine never
    calls the halo conv."""
    import repro_torch.spatial.halo as halo

    calls = {"halo": 0, "direct": 0}

    def count(kind, fn):
        def wrapped(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(halo, "halo_conv2d_cuda", count("halo", halo_conv2d_cuda))
    monkeypatch.setattr(halo, "conv2d_cuda", count("direct", halo.conv2d_cuda))
    name = "tall-k3s1p1g1"
    c = CASES[name]
    x, w, b = ref.conv_inputs(name, 3, 3, 8, 1, c["shape"])
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    conv2d_spatial(_shards(x, ref.TALL_HEIGHTS), params, 3, 1, 1, engine="fused",
                   heights=ref.TALL_HEIGHTS)
    assert calls == {"halo": ref.N, "direct": ref.N}
    conv2d_spatial(_shards(x, None), params, 3, 1, 1, engine="fused")
    assert calls == {"halo": 2 * ref.N, "direct": ref.N}
    conv2d_spatial(_shards(x, None), params, 3, 1, 1, engine="direct")
    assert calls["halo"] == 2 * ref.N


def test_dist_comm_matches_local_comm(tmp_path):
    """A 4-rank gloo world (one shard per rank, ``DistComm``) gives the
    shards ``LocalComm`` gives, for the weighted convs of both engines, the
    equal-split conv and the weighted pool (tests/torch_distcomm_impl.py)."""
    import torch_distcomm_impl as impl

    proc = subprocess.run([sys.executable, str(HERE / "torch_distcomm_impl.py"), str(tmp_path)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    want = impl.run_all(LocalComm(ref.N, "cpu"), list(range(ref.N)))
    for rank in range(ref.N):
        got = np.load(tmp_path / f"rank{rank}.npz")
        assert sorted(got.files) == sorted(want)
        for key, shards in want.items():
            np.testing.assert_allclose(got[key], shards[rank].numpy(), rtol=2e-5, atol=2e-5,
                                       err_msg=f"rank {rank}: {key}")
