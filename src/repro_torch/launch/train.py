"""Training launcher of the port (twin of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch vit-l16 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch vit-l16 --steps 5 --device cpu

Smoke-scale configs by default, ``--full`` for the arch's own; on the card
(``--device cuda``, the default) or, with ``--device cpu``, through the
kernels' plain versions.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get
    from repro_torch.runtime.fault import FaultConfig
    from repro_torch.runtime.train import DEFAULT_CELLS, make_trainer

    cell = args.cell or DEFAULT_CELLS[get(args.arch).family]
    trainer, state = make_trainer(
        args.arch, cell, smoke=not args.full, device=args.device,
        fault_cfg=FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
    )
    state, stats = trainer.run(state, args.steps, resume=not args.no_resume)
    print(f"arch={args.arch} cell={cell} steps={stats.steps} failures={stats.failures}")
    if stats.losses:
        print(f"loss[0]={stats.losses[0]:.4f} loss[-1]={stats.losses[-1]:.4f}")
        print(f"ema_step_s={stats.ema_step_s*1e3:.1f}ms stragglers={stats.stragglers}")


if __name__ == "__main__":
    main()
