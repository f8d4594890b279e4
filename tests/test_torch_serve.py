"""The port's serving engine and launcher against the JAX package's, on the CPU.

Both ``BatchingEngine``s are driven by the same fake clock and submissions;
they must form the same batches in the same earliest-deadline-first order and
report the same ``stats()``.  The port's ``serve`` on the smoke config must
give the logits of JAX ``run_plan`` + ``vgg.head`` on its own parameters and
images (float32, 2e-5: conv summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JCFG
from repro.core import plan_halp as jax_plan_halp
from repro.models import vgg as jvgg
from repro.runtime.serve import BatchingEngine as JaxEngine
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.spatial import run_plan as jax_run_plan
from repro_torch import resolve_device
from repro_torch.launch.serve import serve
from repro_torch.models import vgg
from repro_torch.runtime.serve import BatchingEngine, ServeConfig

# (time of arrival, relative deadline) of each submission; ties and
# out-of-order deadlines exercise the EDF heap
ARRIVALS = [(0.000, 0.50), (0.001, 0.10), (0.001, 0.10), (0.003, 0.05), (0.004, 0.90),
            (0.004, 0.20), (0.010, 0.02), (0.011, 0.30), (0.011, 0.30), (0.020, 0.40)]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(engine_cls, cfg_cls, stack, max_batch, pad_to_max, exec_s=0.03):
    """Submit ARRIVALS on a fake clock, polling after each arrival; every model
    call advances the clock by ``exec_s``.  Returns the batch compositions,
    the observer's widths, the completed requests and the stats."""
    clk = FakeClock()

    def fn(batch):
        clk.t += exec_s
        return batch * 2

    widths = []
    eng = engine_cls(fn, cfg_cls(max_batch=max_batch, max_delay_s=0.003, pad_to_max=pad_to_max),
                     clock=clk, observer=lambda n, dt: widths.append((n, round(dt, 9))))
    batches = []
    for i, (t, dl) in enumerate(ARRIVALS):
        clk.t = max(clk.t, t)
        eng.submit(stack(i), deadline_s=dl)
        done = eng.poll()
        if done:
            batches.append([r.rid for r in done])
    while eng.queue:
        batches.append([r.rid for r in eng.step()])
    return batches, widths, eng.completed, eng.stats()


@pytest.mark.parametrize("max_batch,pad", [(1, True), (3, True), (3, False), (4, True)])
def test_engine_matches_jax_engine(max_batch, pad):
    payload = np.arange(6, dtype=np.float32).reshape(2, 3)
    port = _drive(BatchingEngine, ServeConfig, lambda i: torch.from_numpy(payload + i),
                  max_batch, pad)
    ref = _drive(JaxEngine, JaxServeConfig, lambda i: jnp.asarray(payload + i), max_batch, pad)
    assert port[0] == ref[0]  # batch compositions, EDF order included
    assert port[1] == ref[1]  # executed widths and latencies seen by the observer
    assert [(r.rid, r.deadline, r.arrival, r.done) for r in port[2]] == [
        (r.rid, r.deadline, r.arrival, r.done) for r in ref[2]]
    for r, jr in zip(port[2], ref[2]):
        np.testing.assert_array_equal(r.result.numpy(), np.asarray(jr.result))
    assert port[3] == ref[3]


def test_engine_rejects_empty_batches_and_forwards_es_times():
    with pytest.raises(ValueError, match="max_batch"):
        ServeConfig(max_batch=0)
    seen = []
    eng = BatchingEngine(lambda b: b, ServeConfig(), es_observer=lambda *a: seen.append(a))
    eng.observe_es_time("e1", 2.0, 0.5)
    assert seen == [("e1", 2.0, 0.5)]
    assert eng.step() == [] and eng.stats()["completed"] == 0


def test_serve_smoke_matches_jax_run_plan_and_head():
    out = serve(vgg.SMOKE, n_requests=5, max_batch=2, device="cpu", seed=3)
    assert out["stats"]["completed"] == 5
    logits = out["logits"]
    assert tuple(logits.shape) == (5, vgg.SMOKE.num_classes)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), out["params"])
    x = jnp.asarray(out["images"].numpy())
    feats = jax_run_plan(jax_plan_halp(JCFG.geom(), overlap_rows=4), jp["features"],
                         jvgg.apply_layer, x)
    want = np.asarray(jvgg.head(jp, feats))
    np.testing.assert_allclose(logits.numpy(), want, rtol=2e-5, atol=2e-5)


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """Without CUDA the entry points raise unless the CPU is asked for; they
    never carry on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(vgg.SMOKE, n_requests=1)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
