"""The port's reliability model, traffic models, admission policy and
trace-scale serving loop against the JAX package's, on the CPU.

All of it is host arithmetic (``math`` and numpy), so parity is exact:
``==`` on every reliability number, ``np.array_equal`` on every arrival
stream and label, equal batch widths from ``choose_batch_size`` (0 -- shed --
included), and ``serve_trace`` outcomes (``fin``, ``shed``, ``met``,
``batch_size_counts``) bit for bit, for both of its code paths.  The port's
``serve_trace`` is also held to the port's own ``BatchingEngine`` stepped on
a ``VirtualClock``, as ``tests/test_serve.py`` holds the JAX one.
"""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - exercised only without hypothesis
    from _hypothesis_fallback import given, settings, st

from repro.core import reliability as jrel
from repro.runtime import serve as jserve
from repro.runtime import traffic as jtraffic
from repro_torch.core import reliability as rel
from repro_torch.runtime import serve, traffic

LAT = np.array([0.012, 0.016, 0.020, 0.024, 0.028, 0.032, 0.036, 0.040])


def _classes(T):
    return (
        T.DeadlineClass("premium", 0.15, target=0.999, share=0.2),
        T.DeadlineClass("standard", 0.4, target=0.99, share=0.5),
        T.DeadlineClass("bulk", 2.0, target=0.9, share=0.3),
    )


CLASSES, JCLASSES = _classes(traffic), _classes(jtraffic)


def _processes(T):
    """name -> (process, horizon s): a few thousand requests each."""
    return {
        "poisson": (T.PoissonProcess(rate_hz=80.0, seed=101), 60.0),
        "diurnal": (T.DiurnalProcess(base_rate_hz=60.0, amplitude=0.8, period_s=60.0, seed=202), 60.0),
        "flash_crowd": (T.FlashCrowdProcess(base_rate_hz=20.0, bursts=((10.0, 8.0, 400.0),), seed=303), 40.0),
        "flash_default": (T.FlashCrowdProcess(base_rate_hz=30.0, seed=7), 40.0),
    }


def _traces(name, seed=17):
    proc, horizon = _processes(traffic)[name]
    jproc, _ = _processes(jtraffic)[name]
    return traffic.make_trace(proc, CLASSES, horizon, seed=seed), jtraffic.make_trace(jproc, JCLASSES, horizon, seed=seed)


def _assert_served_equal(a, b):
    assert np.array_equal(a.fin, b.fin, equal_nan=True)
    assert np.array_equal(a.shed, b.shed)
    assert np.array_equal(a.met, b.met)
    assert a.n_batches == b.n_batches
    assert np.array_equal(a.batch_size_counts, b.batch_size_counts)


# ---------------------------------------------------------------------------
# the reliability model
# ---------------------------------------------------------------------------

RATES = (40e6, 60e6, 100e6, 2.5e9)
SIGMAS = (0.0, 1e-3, 5e-3, 14e-3, 18e-3)
TARGETS = (0.5, 0.9, 0.99, 0.999, 0.99999, 0.999999)


def test_reliability_math_equals_jax():
    for z in np.linspace(-9.5, 9.5, 97):
        assert rel.phi(float(z)) == jrel.phi(float(z))
    for t in TARGETS:
        assert rel.probit(t) == jrel.probit(t)
    for rate in RATES:
        for sigma in SIGMAS:
            for n_tasks in (1, 4, 8):
                ch = rel.OffloadChannel(rate, sigma, n_tasks)
                jch = jrel.OffloadChannel(rate, sigma, n_tasks)
                assert (ch.batch_bits, ch.mu_s) == (jch.batch_bits, jch.mu_s)
                assert rel.rate_fluctuation(ch) == jrel.rate_fluctuation(jch)
                for t_inf in (0.0, 5e-3, 17.77e-3, 32.43e-3, 0.2):
                    for d in (4 / 30, 0.05, 0.5):
                        assert rel.service_reliability(ch, t_inf, d) == jrel.service_reliability(jch, t_inf, d)
                    for t in TARGETS:
                        assert rel.required_slack(ch, t_inf, t) == jrel.required_slack(jch, t_inf, t)
    assert rel.IMAGE_BYTES == jrel.IMAGE_BYTES
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError):
            rel.probit(bad)
        with pytest.raises(ValueError):
            rel.required_slack(rel.OffloadChannel(1e8, 1e-3), 0.01, bad)


def test_reliability_is_exported_as_in_jax():
    from repro import core as jcore
    from repro_torch import core

    for name in ("OffloadChannel", "probit", "rate_fluctuation", "required_slack", "service_reliability"):
        assert hasattr(jcore, name) and getattr(core, name) is getattr(rel, name)


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(_processes(traffic)))
def test_arrival_streams_and_traces_equal_jax(name):
    proc, horizon = _processes(traffic)[name]
    jproc, _ = _processes(jtraffic)[name]
    t, jt = proc.times(horizon), jproc.times(horizon)
    assert t.size > 500 and np.array_equal(t, jt)
    tr, jtr = _traces(name)
    assert np.array_equal(tr.arrival, jtr.arrival) and np.array_equal(tr.cls, jtr.cls)
    assert tr.cls.dtype == jtr.cls.dtype and np.array_equal(tr.deadlines(), jtr.deadlines())
    assert len(tr) == len(jtr) <= 20_000


def test_diurnal_rate_and_validation_equal_jax():
    p = traffic.DiurnalProcess(5.0, amplitude=0.5, period_s=100.0, phase_s=3.0)
    jp = jtraffic.DiurnalProcess(5.0, amplitude=0.5, period_s=100.0, phase_s=3.0)
    ts = np.linspace(0.0, 200.0, 41)
    assert np.array_equal(p.rate_at(ts), jp.rate_at(ts))
    for T in (traffic, jtraffic):
        for bad in (lambda: T.PoissonProcess(0.0), lambda: T.DiurnalProcess(1.0, amplitude=1.5),
                    lambda: T.FlashCrowdProcess(1.0, bursts=((0.0, 0.0, 1.0),)),
                    lambda: T.DeadlineClass("x", 0.1, target=1.0), lambda: T.make_trace(T.PoissonProcess(1.0), (), 1.0),
                    lambda: T.Trace(np.array([1.0, 0.0]), np.zeros(2, dtype=np.int64), (T.DeadlineClass("x", 1.0),))):
            with pytest.raises(ValueError):
                bad()


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def test_choose_batch_size_equals_jax():
    rng = np.random.default_rng(5)
    widths = []
    for _ in range(40):
        base, slope = rng.uniform(1e-3, 0.08), rng.uniform(0.0, 0.02)
        curve = base + slope * np.arange(1, 17)
        rate, sigma = rng.choice(RATES[:3]), rng.choice(SIGMAS)
        d = rng.uniform(0.05, 0.3)
        for target in TARGETS[1:]:
            kw = dict(target=target, max_batch=int(rng.integers(1, 17)))
            w = serve.choose_batch_size(lambda b: float(curve[b - 1]), d, rel.OffloadChannel(rate, sigma), **kw)
            jw = jserve.choose_batch_size(lambda b: float(curve[b - 1]), d, jrel.OffloadChannel(rate, sigma), **kw)
            assert w == jw
            widths.append(w)
    assert 0 in widths and max(widths) > 1  # both shedding and batching occur


def test_virtual_clock_semantics():
    clk = serve.VirtualClock(1.5)
    assert clk() == clk.now() == 1.5
    assert clk.advance(0.5) == 2.0 and clk.advance_to(3.0) == 3.0
    with pytest.raises(ValueError):
        clk.advance(-1e-9)
    with pytest.raises(ValueError):
        clk.advance_to(2.9)


# ---------------------------------------------------------------------------
# trace-scale serving
# ---------------------------------------------------------------------------

CHANNELS = {"none": None, "gauss": (100e6, 2e-3), "det": (100e6, 0.0)}


def _cfgs(ch, **kw):
    if ch is None:
        return serve.ServeLoopConfig(**kw), jserve.ServeLoopConfig(**kw)
    return (serve.ServeLoopConfig(channel=rel.OffloadChannel(*ch), **kw),
            jserve.ServeLoopConfig(channel=jrel.OffloadChannel(*ch), **kw))


@pytest.mark.parametrize("admission", [True, False], ids=["admit", "no-admit"])
@pytest.mark.parametrize("channel", sorted(CHANNELS))
@pytest.mark.parametrize("name", ["poisson", "diurnal", "flash_crowd"])
def test_serve_trace_equals_jax(name, channel, admission):
    tr, jtr = _traces(name)
    cfg, jcfg = _cfgs(CHANNELS[channel], max_batch=8, max_delay_s=0.002, admission=admission, seed=23)
    out = serve.serve_trace(tr, LAT, cfg)
    _assert_served_equal(out, jserve.serve_trace(jtr, LAT, jcfg))
    assert out.stats() == jserve.serve_trace(jtr, LAT, jcfg).stats()
    n = len(tr)
    st_ = out.stats()
    assert st_["completed"] + st_["shed"] == n
    if not admission:
        assert not out.shed.any()
    assert out.class_stats().keys() == {"premium", "standard", "bulk"}


@pytest.mark.parametrize("name", ["poisson", "flash_crowd"])
def test_serve_trace_fast_path_equals_scalar_loop(name):
    tr, _ = _traces(name)
    for ch in (None, CHANNELS["gauss"]):
        for admission in (True, False):
            cfg, _ = _cfgs(ch, max_batch=8, admission=admission, seed=3)
            slow, _ = _cfgs(ch, max_batch=8, admission=admission, seed=3, fast_path=False)
            _assert_served_equal(serve.serve_trace(tr, LAT, cfg), serve.serve_trace(tr, LAT, slow))


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "scalar"])
def test_segmented_serve_trace_equals_jax(fast):
    tr, jtr = _traces("diurnal")
    table = np.stack([LAT, 1.5 * LAT, 0.75 * LAT, 3.0 * LAT])
    bounds = (12.5, 30.0, 44.0)
    cfg, jcfg = _cfgs(CHANNELS["gauss"], max_batch=8, segment_bounds=bounds, seed=9, fast_path=fast)
    out = serve.serve_trace(tr, table, cfg)
    _assert_served_equal(out, jserve.serve_trace(jtr, table, jcfg))
    cfg2, _ = _cfgs(CHANNELS["gauss"], max_batch=8, segment_bounds=bounds, seed=9, fast_path=not fast)
    _assert_served_equal(out, serve.serve_trace(tr, table, cfg2))


def test_serve_trace_validation_and_empty_trace():
    tr, _ = _traces("poisson")
    for table, cfg in ((LAT[:4], serve.ServeLoopConfig(max_batch=8)),
                       (np.stack([LAT, LAT]), serve.ServeLoopConfig()),
                       (np.where(np.arange(8) == 3, 0.0, LAT), serve.ServeLoopConfig())):
        with pytest.raises(ValueError):
            serve.serve_trace(tr, table, cfg)
    for bad in (dict(max_batch=0), dict(max_delay_s=-1.0), dict(segment_bounds=(2.0, 1.0))):
        with pytest.raises(ValueError):
            serve.ServeLoopConfig(**bad)
    empty = traffic.Trace(np.empty(0), np.empty(0, dtype=np.int64), CLASSES)
    out = serve.serve_trace(empty, LAT)
    assert out.n_batches == 0 and out.stats()["n"] == 0 and out.stats()["mean_batch"] == 0.0


def _engine_reference(tr, lat, mb, max_delay):
    """The port's BatchingEngine stepped on a VirtualClock (admission off, no
    channel): submit each arrival at its instant, launch on ``ready()`` when
    the one server is free, and charge ``lat[b-1]`` of virtual time per
    width-b batch.  Returns (fin per request, n_batches, width histogram)."""
    clk = serve.VirtualClock()
    eng = serve.BatchingEngine(lambda b: b, serve.ServeConfig(max_batch=mb, max_delay_s=max_delay,
                                                              pad_to_max=False), clock=clk)
    arr = tr.arrival
    rel_dl = np.array([c.deadline_s for c in tr.classes])[tr.cls]
    n = len(tr)
    fin = np.full(n, np.nan)
    counts = np.zeros(mb + 1, dtype=np.int64)
    n_batches = i = 0
    free = 0.0
    while i < n or eng.queue:
        now = clk.now()
        while i < n and arr[i] <= now:
            eng.submit(torch.zeros(()), deadline_s=float(rel_dl[i]))
            i += 1
        if eng.queue and now >= free:
            if eng.ready():
                batch = eng.step()
                t_fin = now + lat[len(batch) - 1]
                for r in batch:
                    fin[r.rid - 1] = t_fin  # rids: 1-based submission order
                free = t_fin
                counts[len(batch)] += 1
                n_batches += 1
                continue
            if eng._oldest_pending().arrival + max_delay <= now:
                # ready()'s (now - a) >= delay can round an ulp short of the
                # nominal expiry: step one ulp until the engine agrees
                clk.advance_to(float(np.nextafter(now, np.inf)))
                continue
        cands = [float(arr[i])] if i < n else []
        if eng.queue:
            cands.append(free if free > now else eng._oldest_pending().arrival + max_delay)
        clk.advance_to(min(cands))
    return fin, n_batches, counts


@settings(max_examples=8, deadline=None)
@given(
    rate=st.floats(min_value=20.0, max_value=200.0),
    seed=st.integers(min_value=0, max_value=10_000),
    mb=st.integers(min_value=2, max_value=6),
    delay=st.sampled_from([0.005, 0.02, 0.1]),
    fast=st.sampled_from([True, False]),
)
def test_serve_trace_matches_the_ports_batching_engine(rate, seed, mb, delay, fast):
    tr = traffic.make_trace(traffic.PoissonProcess(rate, seed=seed), CLASSES, 4.0, seed=seed + 1)
    out = serve.serve_trace(tr, LAT, serve.ServeLoopConfig(max_batch=mb, max_delay_s=delay,
                                                           admission=False, fast_path=fast))
    ref_fin, ref_batches, ref_counts = _engine_reference(tr, LAT, mb, delay)
    assert out.n_batches == ref_batches
    assert np.array_equal(out.batch_size_counts, ref_counts)
    assert np.allclose(out.fin, ref_fin, rtol=0.0, atol=1e-9, equal_nan=True)


def test_flash_crowd_shedding_protects_premium():
    """The figure the serving sweep reports: under a burst, shedding keeps
    every class's deadline-met share at or above the no-shed baseline."""
    tr, _ = _traces("flash_crowd")
    cfg, _ = _cfgs(CHANNELS["det"], max_batch=8)
    shed = serve.serve_trace(tr, LAT, cfg)
    cfg, _ = _cfgs(CHANNELS["det"], max_batch=8, admission=False)
    noshed = serve.serve_trace(tr, LAT, cfg)
    assert shed.stats()["shed_rate"] > 0.05 and shed.stats()["met_of_admitted"] == 1.0
    for name in ("premium", "standard", "bulk"):
        assert shed.class_stats()[name]["deadline_met_frac"] >= noshed.class_stats()[name]["deadline_met_frac"]
