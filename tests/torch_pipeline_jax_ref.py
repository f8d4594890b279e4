"""The JAX side of tests/test_torch_parallel.py's pipeline checks.

    python tests/torch_pipeline_jax_ref.py OUT.npz

runs ``repro.parallel.pipeline.pipeline_apply`` under ``shard_map`` on 4
forced host devices, S = 2 and 4 stages of ViT SMOKE blocks
(``BLOCKS_PER_STAGE`` each, JAX's ``vit_block_init`` from a fixed key) over
M = 1, 3 and 8 microbatches of seeded numpy activations, and writes the
weights, the microbatches and the outputs to OUT.npz.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.configs.vit_l16 import SMOKE  # noqa: E402
from repro.models.vit import vit_block_apply, vit_block_init  # noqa: E402
from repro.parallel.pipeline import pipeline_apply  # noqa: E402

STAGES, MICRO, BLOCKS_PER_STAGE, MB = (2, 4), (1, 3, 8), 2, 2


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def main(path):
    assert len(jax.devices()) == 4, jax.devices()
    n_tok = SMOKE.n_tokens
    out = {}
    for s in STAGES:
        keys = jax.random.split(jax.random.PRNGKey(s), s * BLOCKS_PER_STAGE)
        blocks = [vit_block_init(k, SMOKE.d_model, SMOKE.n_heads, SMOKE.d_ff) for k in keys]
        # [S, blocks, ...] stacked: device i holds stage i's blocks
        stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs).reshape((s, BLOCKS_PER_STAGE) + xs[0].shape),
                                         *blocks)
        for i, b in enumerate(blocks):
            out.update({f"S{s}/w{i}/{k}": v for k, v in flat(b).items()})
        mesh = Mesh(np.array(jax.devices()[:s]), ("pp",))

        def stage_fn(p, x):
            for j in range(BLOCKS_PER_STAGE):
                x = vit_block_apply(jax.tree_util.tree_map(lambda a: a[j], p), x, SMOKE.n_heads)
            return x

        def run(p, x):
            return pipeline_apply(jax.tree_util.tree_map(lambda a: a[0], p), x, stage_fn, "pp")

        fn = jax.jit(jax.shard_map(run, mesh=mesh, in_specs=(P("pp"), P()), out_specs=P(), check_vma=False))
        for m in MICRO:
            rng = np.random.default_rng(100 * s + m)
            x = rng.standard_normal((m, MB, n_tok, SMOKE.d_model), dtype=np.float32)
            out[f"S{s}/M{m}/x"] = x
            out[f"S{s}/M{m}/y"] = np.asarray(fn(stacked, x))
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
