"""The gloo side of tests/test_torch_parallel.py's pipeline check.

    python tests/torch_pipeline_dist_impl.py WEIGHTS.npz OUT_DIR

starts a 4-rank ``torch.distributed`` world (gloo, ``file://`` rendezvous in
OUT_DIR), one pipeline stage per rank behind a ``DistComm``, runs
``pipeline_apply`` over the S = 4 case of WEIGHTS.npz
(``tests/torch_pipeline_jax_ref.py``'s file) at each of its microbatch counts
and writes each rank's result to OUT_DIR/rank{r}.npz.
"""
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

from torch_pipeline_jax_ref import BLOCKS_PER_STAGE, MICRO  # noqa: E402

S = 4


def stage_params(data, s: int, stage: int) -> list:
    """Stage ``stage``'s blocks of the S = ``s`` case, as torch trees."""
    out = []
    for j in range(BLOCKS_PER_STAGE):
        prefix = f"S{s}/w{stage * BLOCKS_PER_STAGE + j}/"
        tree: dict = {}
        for key in data.files:
            if key.startswith(prefix):
                group, leaf = key[len(prefix):].split("/")
                tree.setdefault(group, {})[leaf] = torch.from_numpy(data[key])
        out.append(tree)
    return out


def stage_fn(blocks, x):
    from repro_torch.configs.vit_l16 import SMOKE
    from repro_torch.models.vit import vit_block_apply

    for p in blocks:
        x = vit_block_apply(p, x, SMOKE.n_heads)
    return x


def _worker(rank, world, init, weights, out_dir):
    import torch.distributed as dist

    from repro_torch.parallel import pipeline_apply
    from repro_torch.spatial import DistComm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        data = np.load(weights)
        params = [stage_params(data, S, rank)]
        res = {f"M{m}": pipeline_apply(params, torch.from_numpy(data[f"S{S}/M{m}/x"]), stage_fn, DistComm("cpu"))
               .numpy() for m in MICRO}
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def main(weights, out_dir):
    import torch.multiprocessing as mp

    init = f"file://{Path(out_dir).resolve() / 'rendezvous'}"
    mp.spawn(_worker, args=(S, init, weights, out_dir), nprocs=S, join=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
