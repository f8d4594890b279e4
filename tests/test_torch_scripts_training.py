"""The fault-tolerant training example's twin
(``examples/train_fault_tolerant_torch.py``) on the CPU.

The script's run at ViT-L/16's smoke config (``runtime.train.make_trainer``,
as the JAX script's), cut from 120 steps to 12 with the faults and the
checkpoint interval scaled to match (37 and 83 of 120 every 20 -> 4 and 8
of 12 every 2): the chaos run fails and restores twice, and its final state
equals the uninterrupted run's bit for bit, losses included.  ``main`` runs
to its end and prints the JAX script's lines.
"""
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "examples"))

import train_fault_tolerant_torch as tft  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

torch.set_num_threads(2)

STEPS, FAULTS_AT, CKPT_EVERY = 12, (4, 8), 2


def test_chaos_run_replays_the_uninterrupted_run_bit_for_bit():
    out = tft.run(STEPS, "vit-l16", "cpu", FAULTS_AT, CKPT_EVERY)
    ref, chaos = out["reference"], out["chaos"]
    assert out["injected"] == list(FAULTS_AT) and out["ok"]
    assert chaos.failures == chaos.restores == len(FAULTS_AT) and ref.failures == ref.restores == 0
    assert ref.steps == chaos.steps == STEPS and chaos.losses == ref.losses and len(ref.losses) == STEPS
    a, b = tree_leaves(out["reference_state"]), tree_leaves(out["chaos_state"])
    assert len(a) == len(b) > 3 and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    assert int(out["chaos_state"][2]) == STEPS


def test_a_trainer_factory_stands_in_for_make_trainer():
    """``trainer_factory`` (how chip_smoke passes its full-width trainer)
    receives the arch, the cell and the fault settings."""
    seen = []

    def factory(arch, cell, fault_cfg, fault_hook=None):
        seen.append((arch, cell, fault_cfg.ckpt_every, fault_hook is not None))
        return tft.make_trainer(arch, cell, fault_cfg=fault_cfg, fault_hook=fault_hook, device="cpu")

    out = tft.run(3, "vit-l16", "cpu", (1,), 1, trainer_factory=factory)
    assert seen == [("vit-l16", "cls_224", 1, False), ("vit-l16", "cls_224", 1, True)]
    assert out["ok"] and out["injected"] == [1] and out["chaos"].restores == 1


def test_main_runs_to_its_end(capsys, monkeypatch):
    out = tft.main(["--steps", "2", "--device", "cpu"])
    assert out["ok"] and out["injected"] == []  # the script's faults lie past step 2
    lines = capsys.readouterr().out.splitlines()
    ref = out["reference"]
    assert lines[0] == "== reference run (2 steps, no faults) =="
    assert lines[1].startswith(f"loss: {ref.losses[0]:.4f} -> {ref.losses[-1]:.4f} (ema step ")
    assert lines[3] == "== chaos run: kill the job at steps 37 and 83 =="
    assert lines[4].startswith("failures=0 restores=0 loss: ")
    assert lines[-1] == "final params identical to uninterrupted run: True" and len(lines) == 7
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tft.main(["--steps", "1"])
