"""Fault-tolerant training demo on the port: train a reduced ViT for a few
hundred steps on synthetic data, inject two node failures, and show
checkpoint/restart producing the same final parameters as an uninterrupted
run.

The PyTorch port's twin of ``examples/train_fault_tolerant.py``: the same
flags, printed lines and final check over ``repro_torch`` (no ``jax``, no
``repro``), plus ``--device``.  The ViT's patch embedding runs through K1 and
its attention through K3, both under their autograd ``Function``s, on the
card.

    PYTHONPATH=src python examples/train_fault_tolerant_torch.py --steps 120
    PYTHONPATH=src python examples/train_fault_tolerant_torch.py --steps 12 --device cpu
"""
from __future__ import annotations

import argparse
import functools
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.runtime.fault import FaultConfig, InjectedFault  # noqa: E402
from repro_torch.runtime.train import make_trainer  # noqa: E402

FAULTS_AT = (37, 83)
CKPT_EVERY = 20
RTOL, ATOL = 1e-5, 1e-6  # the JAX script's final check


def run(
    steps: int = 120,
    arch: str = "vit-l16",
    device: str | torch.device = "cuda",
    faults_at: tuple[int, ...] = FAULTS_AT,
    ckpt_every: int = CKPT_EVERY,
    trainer_factory=None,
) -> dict:
    """A reference run of ``steps`` steps and a chaos run that fails at each
    step of ``faults_at``, both checkpointed every ``ckpt_every`` steps.

    ``trainer_factory(arch, cell, fault_cfg=..., fault_hook=...)`` returns
    ``(trainer, initial_state)``; by default it is
    ``runtime.train.make_trainer`` (the arch's smoke config) on ``device``.
    Returns both runs' losses, stats and final states, the steps where the
    chaos run failed, and ``ok``: every final parameter of the chaos run
    within ``ATOL + RTOL * |ref|`` of the reference run's (the JAX script's
    ``allclose``), in float32."""
    dev = resolve_device(device)
    factory = trainer_factory or functools.partial(make_trainer, device=dev)
    with tempfile.TemporaryDirectory() as d_ref, tempfile.TemporaryDirectory() as d_ft:
        t_ref, s_ref = factory(arch, "cls_224", fault_cfg=FaultConfig(ckpt_dir=d_ref, ckpt_every=ckpt_every))
        s_ref, st_ref = t_ref.run(s_ref, steps, resume=False)

        left, injected = list(faults_at), []

        def chaos(i):
            if left and i == left[0]:
                left.pop(0)
                injected.append(i)
                raise InjectedFault(f"node failure at step {i}")

        t_ft, s_ft = factory(arch, "cls_224", fault_cfg=FaultConfig(ckpt_dir=d_ft, ckpt_every=ckpt_every),
                             fault_hook=chaos)
        s_ft, st = t_ft.run(s_ft, steps, resume=False)

    ok = all(
        torch.allclose(a.float(), b.float(), rtol=RTOL, atol=ATOL)
        for a, b in zip(tree_leaves(s_ref[0]), tree_leaves(s_ft[0]))
    )
    return dict(device=str(dev), steps=steps, arch=arch, reference=st_ref, chaos=st, injected=injected,
                reference_state=s_ref, chaos_state=s_ft, ok=ok)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--arch", default="vit-l16")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run(args.steps, args.arch, args.device)

    st_ref, st = out["reference"], out["chaos"]
    print(f"== reference run ({args.steps} steps, no faults) ==")
    print(f"loss: {st_ref.losses[0]:.4f} -> {st_ref.losses[-1]:.4f} "
          f"(ema step {st_ref.ema_step_s*1e3:.0f}ms)")
    print(f"\n== chaos run: kill the job at steps {' and '.join(map(str, FAULTS_AT))} ==")
    for i in out["injected"]:
        print(f"  !! injected node failure at step {i}")
    print(f"failures={st.failures} restores={st.restores} "
          f"loss: {st.losses[0]:.4f} -> {st.losses[-1]:.4f}")
    print(f"\nfinal params identical to uninterrupted run: {out['ok']}")
    if not out["ok"]:
        raise AssertionError("the chaos run's final parameters part from the uninterrupted run's")
    return out


if __name__ == "__main__":
    main()
