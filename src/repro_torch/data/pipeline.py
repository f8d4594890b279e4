"""Deterministic synthetic data streams (twin of ``repro/data/pipeline.py``).

Every batch is a pure function of (seed, step), drawn through numpy's
``Philox(key=seed, counter=[step, salt, 0, 0])`` as JAX's streams draw it,
so each batch is bit-identical to the JAX package's and a restarted job
replays the exact stream (the fault-tolerant trainer's exactly-once
property).  Batches are CPU tensors; :func:`device_batch` puts one on the
device the step runs on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

__all__ = ["TokenStream", "ImageStream", "DiffusionStream", "device_batch"]


def _rng(seed: int, step: int, salt: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed, counter=[step, salt, 0, 0]))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclass
class TokenStream:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        g = _rng(self.seed, step, 1)
        toks = g.integers(0, self.vocab, (self.batch, self.seq_len + 1), dtype=np.int32)
        return {"tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:])}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclass
class ImageStream:
    img_res: int
    batch: int
    num_classes: int
    channels: int = 3
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        g = _rng(self.seed, step, 2)
        imgs = g.standard_normal((self.batch, self.img_res, self.img_res, self.channels), dtype=np.float32)
        labels = g.integers(0, self.num_classes, (self.batch,), dtype=np.int32)
        return {"images": _t(imgs), "labels": _t(labels)}


@dataclass
class DiffusionStream:
    latent_res: int
    batch: int
    latent_ch: int = 4
    n_classes: int = 1000
    ctx: tuple | None = None  # (len, dim) for text-conditioned models
    n_steps: int = 1000
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        g = _rng(self.seed, step, 3)
        shape = (self.batch, self.latent_res, self.latent_res, self.latent_ch)
        out = {
            "latents": _t(g.standard_normal(shape, dtype=np.float32)),
            "noise": _t(g.standard_normal(shape, dtype=np.float32)),
            "t": _t(g.integers(0, self.n_steps, (self.batch,), dtype=np.int32)),
        }
        if self.ctx is None:
            out["cond"] = _t(g.integers(0, self.n_classes, (self.batch,), dtype=np.int32))
        else:
            length, dim = self.ctx
            out["cond"] = _t(g.standard_normal((self.batch, length, dim), dtype=np.float32))
        return out


def device_batch(batch: dict, device: str | torch.device) -> dict:
    """A host batch on ``device`` (the port has no shardings: one device)."""
    return {k: v.to(device) for k, v in batch.items()}
