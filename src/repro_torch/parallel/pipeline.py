"""Pipeline parallelism, GPipe style, over a :class:`~..spatial.comm.Comm`
(twin of ``repro/parallel/pipeline.py``).

Each shard of the comm owns one *stage* (a slice of the layer stack);
microbatches stream through the stages with ``comm.shift(+1)`` between
them.  With S stages and M microbatches the schedule runs S + M - 1 ticks;
bubble fraction (S-1)/(S+M-1).  JAX's form is one stage a device along a
mesh axis inside ``shard_map`` (2 stages across pods): only the thin
activation boundary crosses the slow link, and it crosses while both sides
compute.  Here a :class:`~..spatial.comm.LocalComm` runs every stage in one
process (on one card the stages run in series, so every bubble tick is
paid) and a :class:`~..spatial.comm.DistComm` one stage a rank.

The schedule is JAX's tick for tick: at tick t stage 0 takes microbatch
min(t, M - 1), every stage runs ``stage_fn`` (in the bubble on what it
holds: zeros before its first microbatch arrives), and the last stage keeps
microbatch t - (S - 1) once t >= S - 1.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from ..spatial.comm import Comm, DistComm

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_stages + n_micro - 1)


def pipeline_apply(stage_params: Sequence, x_micro: torch.Tensor, stage_fn: Callable, comm: Comm) -> torch.Tensor:
    """Run a pipelined forward.

    stage_params: the parameters of this process's stages, one entry for
                  each of ``comm.indices`` (stage = shard index).
    x_micro: [M, mb, ...] microbatches (the same on every process; only
             stage 0 consumes them, the rest arrive by ``comm.shift``).
    stage_fn(params, x) -> y: one stage's computation on one microbatch;
             y has x's shape and type (it feeds the next stage).
    Returns the last stage's [M, mb, ...] outputs, the same on every process
    (JAX's closing ``psum`` of zeros and one real value; a ``DistComm``
    broadcasts them from rank S - 1).
    """
    if len(stage_params) != len(comm.indices):
        raise ValueError(f"{len(stage_params)} stages' parameters for {len(comm.indices)} local stages")
    s, m = comm.n, x_micro.shape[0]
    bufs = [torch.zeros_like(x_micro[0]) for _ in comm.indices]
    outs = torch.zeros_like(x_micro)
    for t in range(s + m - 1):
        ys = []
        for p, i, buf in zip(stage_params, comm.indices, bufs):
            y = stage_fn(p, x_micro[min(t, m - 1)] if i == 0 else buf)
            if i == s - 1 and t >= s - 1:
                outs[t - (s - 1)] = y
            ys.append(y)
        # activations move one stage forward; stage 0 receives zeros (JAX's
        # stage 0 ignores what the ring edge brings it)
        bufs = comm.shift(ys, +1)
    if isinstance(comm, DistComm) and s > 1:
        dist.broadcast(outs, src=s - 1)
    return outs
