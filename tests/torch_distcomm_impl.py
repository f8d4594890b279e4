"""The gloo side of tests/test_torch_spatial.py::test_dist_comm_matches_local_comm.

    python tests/torch_distcomm_impl.py OUT_DIR

starts a 4-rank ``torch.distributed`` world (gloo, ``file://`` rendezvous in
OUT_DIR), one height shard per rank behind a ``DistComm``, runs
:func:`run_all` and writes each rank's output shards to OUT_DIR/rank{r}.npz.
"""
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

import torch_spatial_jax_ref as ref  # noqa: E402
from repro_torch.spatial import conv2d_spatial, max_pool_spatial, to_padded_shards  # noqa: E402


def run_all(comm, indices):
    """key -> output shards of ``indices`` (the local ones) for each check."""
    out = {}
    for name in ("weighted-k5s1p2g1", "weighted-k7s2p3g1", "conv-k3s1p1g1"):
        c = ref.cases()[name]
        x, w, b = ref.conv_inputs(name, c["k"], c["shape"][3], c["c_out"], c["groups"], c["shape"])
        params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
        hts = c.get("heights")
        xt = torch.from_numpy(x)
        blocks = to_padded_shards(xt, hts) if hts else list(xt.chunk(ref.N, dim=1))
        for engine, overlap in (("direct", True), ("direct", False), ("fused", True)):
            out[f"{name}/{engine}/{overlap}"] = conv2d_spatial(
                [blocks[j] for j in indices], params, c["k"], c["s"], c["p"], comm=comm,
                overlap=overlap, groups=c["groups"], engine=engine, heights=hts)
    name = "pool-weighted-k3s2"
    c = ref.cases()[name]
    blocks = to_padded_shards(torch.from_numpy(ref.pool_input(name, c["shape"])), c["heights"])
    out[name] = max_pool_spatial([blocks[j] for j in indices], c["k"], c["s"], comm=comm,
                                 heights=c["heights"])
    return out


def _worker(rank, world, init, out_dir):
    import torch.distributed as dist

    from repro_torch.spatial import DistComm

    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        res = run_all(DistComm("cpu"), [rank])
        np.savez(Path(out_dir) / f"rank{rank}.npz", **{k: v[0].numpy() for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def main(out_dir):
    import torch.multiprocessing as mp

    init = f"file://{Path(out_dir).resolve() / 'rendezvous'}"
    mp.spawn(_worker, args=(ref.N, init, out_dir), nprocs=ref.N, join=True)


if __name__ == "__main__":
    main(sys.argv[1])
