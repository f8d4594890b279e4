"""Training driver of the port (twin of ``repro/runtime/train.py``), used by
``launch/train.py`` and ``chip_smoke.py``: builds the step bundle for an
(arch, cell), wires the synthetic stream, and runs under the fault-tolerant
trainer on one device."""
from __future__ import annotations

import tempfile

import torch

from .. import resolve_device
from ..configs import get
from ..configs.steps import build, realize
from ..data.pipeline import DiffusionStream, ImageStream, TokenStream, device_batch
from .fault import FaultConfig, FaultTolerantTrainer

__all__ = ["make_trainer", "train_smoke"]

DEFAULT_CELLS = {"lm": "train_4k", "vision": "cls_224", "diffusion": "train_256"}


def _stream_for(bundle):
    cfg, ins = bundle.cfg, bundle.inputs
    if "tokens" in ins:
        b, s = ins["tokens"][0]
        return TokenStream(vocab=cfg.vocab, batch=b, seq_len=s)
    if "images" in ins:
        b, r = ins["images"][0][:2]
        return ImageStream(img_res=r, batch=b, num_classes=cfg.num_classes)
    if "latents" in ins:
        shape = ins["latents"][0]
        ctx = (cfg.ctx_len, cfg.ctx_dim) if hasattr(cfg, "ctx_dim") else None
        return DiffusionStream(latent_res=shape[1], batch=shape[0], latent_ch=shape[-1],
                               n_classes=getattr(cfg, "num_classes", 1000), ctx=ctx)
    raise ValueError(f"no stream for inputs {list(ins)}")


def make_trainer(
    arch_name: str,
    cell: str = "train_4k",
    *,
    smoke: bool = True,
    fault_cfg: FaultConfig | None = None,
    fault_hook=None,
    device: str | torch.device = "cuda",
    state=None,
):
    """Returns (trainer, initial_state) on ``device`` (``"cuda"`` by
    default; raises without a card).  The initial state is ``state`` when
    given (e.g. a JAX trainer's, by ``models.common.train_state_from_jax``),
    else ``realize``'s from a generator seeded with 0.  Each batch of
    the stream goes to ``device`` before the step."""
    dev = resolve_device(device)
    arch = get(arch_name)
    bundle = build(arch, cell, smoke=smoke)
    if state is None:
        state, _ = realize(arch, bundle, torch.Generator(device=dev).manual_seed(0))
    stream = _stream_for(bundle)

    def step_fn(state, **batch):
        return bundle.fn(state, **device_batch(batch, dev))

    trainer = FaultTolerantTrainer(step_fn, stream, fault_cfg or FaultConfig(), fault_hook=fault_hook)
    return trainer, state


def train_smoke(arch_name: str, n_steps: int = 5, cell: str | None = None,
                device: str | torch.device = "cuda") -> dict:
    """A few real optimizer steps of the smoke config; returns the loss
    trajectory."""
    cell = cell or DEFAULT_CELLS[get(arch_name).family]
    with tempfile.TemporaryDirectory() as d:
        trainer, state = make_trainer(arch_name, cell, device=device,
                                      fault_cfg=FaultConfig(ckpt_dir=d, ckpt_every=1000))
        state, stats = trainer.run(state, n_steps, resume=False)
    return {"losses": stats.losses, "steps": stats.steps}
