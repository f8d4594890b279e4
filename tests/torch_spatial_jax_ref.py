"""The JAX side of tests/test_torch_spatial.py: the JAX package's
``conv2d_spatial`` / ``max_pool_spatial`` under ``shard_map`` on 4 forced host
devices, over the cases of ``tests/spatial_multidev_impl.py`` cut to 4 shards.

    python tests/torch_spatial_jax_ref.py OUT.npz

writes one global (merged) output per case and run.  Run in a subprocess: the
forced device count must be set before JAX starts.  The inputs come from
numpy with a seed (:func:`conv_inputs`, :func:`pool_input`), so the test rebuilds them exactly.
"""
import os
import sys
import zlib

import numpy as np

N = 4  # shards
# (k, s, p, c_in, c_out, h, groups): spatial_multidev_impl.py l.81-89
GEOMS = [
    (3, 1, 1, 3, 16, 64, 1),
    (1, 1, 0, 8, 16, 32, 1),
    (5, 1, 2, 4, 8, 64, 1),
    (7, 2, 3, 3, 16, 64, 1),
    (3, 2, 1, 8, 8, 64, 1),
    (2, 2, 0, 4, 4, 32, 1),
    (7, 1, 3, 8, 8, 56, 8),
]
# capacity-weighted cases (l.120-176), (k, s, p, c_in, c_out, groups) on 64 x 17 maps
H = 64
WEIGHTED_HEIGHTS = (24, 12, 4, 24)  # shard_heights(64, 4, ratios=(6, 3, 1, 6), align=2)
WEIGHTED_GEOMS = [(3, 1, 1, 3, 8, 1), (5, 1, 2, 4, 8, 1), (3, 2, 1, 8, 8, 1), (7, 2, 3, 3, 8, 1),
                  (7, 1, 3, 8, 8, 8)]
TALL_HEIGHTS = (22, 12, 6, 24)  # min 6: every geometry takes the fix-up branch
TALL_GEOMS = [(3, 1, 1, 3, 8, 1), (5, 1, 2, 4, 8, 1), (7, 2, 3, 3, 8, 1), (7, 1, 3, 8, 8, 8)]
# the 2-block weighted VGG stack (l.257-291): stride alignment 4
VGG_BLOCKS = ((2, 64), (2, 128))
VGG_HEIGHTS = (24, 16, 4, 20)  # shard_heights(64, 4, ratios=(4, 2, 1, 3), align=4)
# JAX (engine, overlap) runs; "pallas" ignores overlap.  The tall and VGG
# cases exist for the fused path (as in spatial_multidev_impl.py) and run it
# alone: each shard_map run costs seconds of compilation.
RUNS = [("lax", False), ("lax", True), ("pallas", True)]
FUSED_ONLY = [("pallas", True)]


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def conv_inputs(name, k, c_in, c_out, groups, shape):
    """Seeded numpy input, HWIO weights (He-scaled) and bias for a case."""
    rng = _rng(name)
    x = rng.standard_normal(shape, dtype=np.float32)
    w_in = 1 if groups > 1 else c_in
    w = (np.sqrt(2.0 / (k * k * w_in)) * rng.standard_normal((k, k, w_in, c_out))).astype(np.float32)
    b = (0.1 * rng.standard_normal(c_out)).astype(np.float32)
    return x, w, b


def cases():
    """name -> spec of every case; the test parametrises over these."""
    out = {}
    for k, s, p, ci, co, h, g in GEOMS:
        out[f"conv-k{k}s{s}p{p}g{g}"] = dict(kind="conv", k=k, s=s, p=p, groups=g,
                                             shape=(2, h, h, ci), c_out=co)
    out["thin-k7s1p3"] = dict(kind="conv", k=7, s=1, p=3, groups=1, shape=(1, 16, 16, 4), c_out=8)
    for k, s, p, ci, co, g in WEIGHTED_GEOMS:
        out[f"weighted-k{k}s{s}p{p}g{g}"] = dict(kind="conv", k=k, s=s, p=p, groups=g,
                                                 shape=(2, H, 17, ci), c_out=co,
                                                 heights=WEIGHTED_HEIGHTS)
    for k, s, p, ci, co, g in TALL_GEOMS:
        out[f"tall-k{k}s{s}p{p}g{g}"] = dict(kind="conv", k=k, s=s, p=p, groups=g,
                                             shape=(2, H, 17, ci), c_out=co, heights=TALL_HEIGHTS,
                                             runs=FUSED_ONLY)
    for k, s in ((2, 2), (3, 2)):
        out[f"pool-weighted-k{k}s{s}"] = dict(kind="pool", k=k, s=s, shape=(2, H, 16, 4),
                                              heights=WEIGHTED_HEIGHTS)
    out["pool-k2s2"] = dict(kind="pool", k=2, s=2, shape=(2, 64, 64, 4))
    out["vgg-weighted"] = dict(kind="vgg", shape=(2, 64, 64, 3), heights=VGG_HEIGHTS,
                               runs=FUSED_ONLY)
    return out


def pool_input(name, shape):
    return _rng(name).standard_normal(shape, dtype=np.float32)


def main(path):
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N}"
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    sys.path.insert(0, os.path.dirname(__file__))
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from _torch_parity import jax_vgg_params
    from repro.models import vgg
    from repro.spatial import (conv2d_spatial, max_pool_spatial, merge_padded_shards,
                               to_padded_shards)

    assert len(jax.devices()) == N, jax.devices()
    mesh = Mesh(np.array(jax.devices()).reshape(N), ("sp",))
    spec = P(None, "sp", None, None)
    results = {}
    for name, c in cases().items():
        hts = c.get("heights")
        if c["kind"] == "conv":
            x, w, b = conv_inputs(name, c["k"], c["shape"][3], c["c_out"], c["groups"], c["shape"])
            params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
            xin = jnp.asarray(x) if hts is None else to_padded_shards(jnp.asarray(x), hts)
            for engine, overlap in c.get("runs", RUNS):
                fn = shard_map(
                    partial(conv2d_spatial, k=c["k"], s=c["s"], p=c["p"], axis_name="sp",
                            overlap=overlap, groups=c["groups"], engine=engine, interpret=True,
                            heights=hts),
                    mesh=mesh, in_specs=(spec, P()), out_specs=spec, check_rep=False)
                y = fn(xin, params)
                if hts is not None:
                    y = merge_padded_shards(y, tuple(h // c["s"] for h in hts))
                results[f"{name}/{engine}/{overlap}"] = np.asarray(y)
        elif c["kind"] == "pool":
            x = jnp.asarray(pool_input(name, c["shape"]))
            xin = x if hts is None else to_padded_shards(x, hts)
            fn = shard_map(partial(max_pool_spatial, k=c["k"], s=c["s"], axis_name="sp", heights=hts),
                           mesh=mesh, in_specs=spec, out_specs=spec)
            y = fn(xin)
            if hts is not None:
                y = merge_padded_shards(y, tuple(h // c["s"] for h in hts))
            results[name] = np.asarray(y)
        else:
            cfg = vgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10, blocks=VGG_BLOCKS)
            feats = jax_vgg_params(cfg, seed=7)["features"]
            x = jnp.asarray(pool_input(name, c["shape"]))
            for engine, overlap in c["runs"]:

                def stack(xs, feats, engine=engine, overlap=overlap):
                    h_l = hts
                    for p_l, g in zip(feats, cfg.geom().layers):
                        if g.kind == "pool":
                            xs = max_pool_spatial(xs, g.k, g.s, axis_name="sp", heights=h_l)
                        else:
                            xs = jax.nn.relu(conv2d_spatial(
                                xs, p_l, g.k, g.s, g.p, axis_name="sp", overlap=overlap,
                                engine=engine, interpret=True, heights=h_l))
                        h_l = tuple(h // g.s for h in h_l)
                    return xs

                fn = shard_map(stack, mesh=mesh, in_specs=(spec, P()), out_specs=spec,
                               check_rep=False)
                y = fn(to_padded_shards(x, hts), feats)
                results[f"{name}/{engine}/{overlap}"] = np.asarray(
                    merge_padded_shards(y, tuple(h // 4 for h in hts)))
    np.savez(path, **results)
    print(f"wrote {len(results)} outputs")


if __name__ == "__main__":
    main(sys.argv[1])
