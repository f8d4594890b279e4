"""The port's online re-planner (``repro_torch.core.replan``) and
``plan_aware_batch_size`` against the JAX package's, on the CPU.

Each case is a scenario of ``tests/test_replan.py`` written once over a
package ``M`` (``T`` the port's ``core``, ``J`` the JAX package's), run in
both, and compared by exact equality (``same``: leaf for leaf, leaf types
included): bucket indices, estimator rates, bucket keys, ``stats()`` dicts,
the ``key_hash`` of the controller's key, every adopted plan Segment for
Segment, ``predicted_latency`` / ``latency_table``, ``plan_aware_batch_size``
and ``replay_trace`` records under both planners.  The port's own values are
then held to the JAX test's assertions.  The two losslessness cases run the
re-planned plan through the port's ``run_plan`` (plain conv on the CPU)
against JAX's single-device forward at 2e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from _torch_parity import JCFG, jax_vgg_params
from repro.models import vgg as jvgg
from repro.runtime.serve import plan_aware_batch_size as jax_plan_aware_batch_size
from repro_torch.core.reliability import IMAGE_BYTES
from repro_torch.models import vgg
from repro_torch.models.common import params_from_jax
from repro_torch.runtime import plan_aware_batch_size
from repro_torch.spatial import run_plan
from test_torch_engines import same, smoke_net

NOMINAL = 120e6
PLAN_AWARE = {T: plan_aware_batch_size, J: jax_plan_aware_batch_size}


def small_topology(M):
    return M.CollabTopology(host="e0", secondaries=("a", "b"),
                            platforms={"e0": M.AGX_XAVIER, "a": M.AGX_XAVIER, "b": M.AGX_XAVIER},
                            default_link=M.Link(NOMINAL))


def fast_link_topology(M):
    """The same cluster on 50 Gbps links: compute-bound (the straggler regime)."""
    return M.CollabTopology(host="e0", secondaries=("a", "b"),
                            platforms={"e0": M.AGX_XAVIER, "a": M.AGX_XAVIER, "b": M.AGX_XAVIER},
                            default_link=M.Link(50e9))


def fast(M, **kw):
    """tests/test_replan.py: FAST, the closed-form objective."""
    return M.ReplanConfig(**dict(dict(use_simulator=False, alpha=1.0, hysteresis=1, bucket_frac=0.5), **kw))


def observe_rate(ctl, rate):
    for pair in (("e0", "b"), ("b", "e0")):
        ctl.observe_transfer(*pair, IMAGE_BYTES, 8.0 * IMAGE_BYTES / rate)


def observe_compute(ctl, es, flops_rate):
    ctl.observe_compute(es, 1e9, 1e9 / flops_rate)


def both(scenario):
    """The scenario's record in the port and in JAX, held equal; returns the
    port's."""
    rec, jrec = scenario(T), scenario(J)
    same(rec, jrec)
    return rec


def key_of(M, ctl):
    key = (ctl._fingerprint, ctl._active)
    return key, M.canonical_key(key), M.key_hash(key)


def jax_features(x):
    return np.asarray(jvgg.features(jax_vgg_params(), JCFG, jnp.asarray(x)))


def assert_lossless(plan):
    """The port's plan through its run_plan (plain conv) against JAX's
    single-device forward of the same seeded weights and image."""
    x = np.random.default_rng(1).standard_normal((1, 64, 64, 3), dtype=np.float32)
    p = params_from_jax(jax_vgg_params())
    out = run_plan(plan, p["features"], vgg.apply_layer, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), jax_features(x), rtol=2e-5, atol=2e-5)


# -- bucketing ----------------------------------------------------------------


def test_rate_bucket_bands():
    def scenario(M):
        f = 0.25
        rows = [(r, M.rate_bucket(r, f), M.rate_bucket(r * 1.001, f), M.bucket_rate(M.rate_bucket(r, f), f))
                for r in (40e6, 120e6, 2.5e9, 100e9)]
        return rows, [M.rate_bucket(10e6 * (1.3**i), f) for i in range(20)]

    rows, buckets = both(scenario)
    for r, b, b2, rep in rows:
        assert b2 in (b, b + 1) and rep / r < 1.25 and r / rep < 1.25
    assert buckets == sorted(buckets)


def test_rate_bucket_exact_mode_and_errors():
    both(lambda M: (M.rate_bucket(123.0e6, 0.0), M.bucket_rate(123.0e6, 0.0)))
    msgs = []
    for M in (T, J):
        with pytest.raises(ValueError) as exc:
            M.rate_bucket(0.0, 0.25)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_compute_bucket_anchored_at_nominal():
    def scenario(M):
        nom, f = M.AGX_XAVIER.eff_flops, 0.3
        b = M.compute_bucket(0.3 * nom, nom, f)
        ests = [nom * (0.25 * 1.2**i) for i in range(12)]
        return dict(zero=M.compute_bucket(nom, nom, f), rep0=M.compute_band_flops(0, nom, f), nom=nom,
                    b=b, rep=M.compute_band_flops(b, nom, f),
                    mono=[M.compute_bucket(e, nom, f) for e in ests],
                    jitter=M.compute_bucket(nom * 1.05, nom, f),
                    exact=(M.compute_bucket(1.23e12, nom, 0.0), M.compute_band_flops(1.23e12, nom, 0.0)))

    r = both(scenario)
    assert r["zero"] == 0 and r["rep0"] == r["nom"] and r["b"] < 0 and r["jitter"] == 0
    assert r["mono"] == sorted(r["mono"]) and r["exact"] == (1.23e12, 1.23e12)
    for M in (T, J):
        with pytest.raises(ValueError):
            M.compute_bucket(0.0, 1.0, 0.3)
        with pytest.raises(ValueError):
            M.compute_bucket(1.0, 0.0, 0.3)


def test_topology_fingerprint_excludes_eff_flops():
    def scenario(M):
        a = small_topology(M)
        b = M.CollabTopology(host="e0", secondaries=("a", "b"),
                             platforms={es: M.AGX_XAVIER.scaled(0.5) for es in ("e0", "a", "b")},
                             default_link=M.Link(NOMINAL))
        ka = M.ReplanController(smoke_net(M), a, fast(M))._bucket_key()
        kb = M.ReplanController(smoke_net(M), b, fast(M))._bucket_key()
        return M.topology_fingerprint(a), M.topology_fingerprint(b), ka, kb

    fa, fb, ka, kb = both(scenario)
    assert fa == fb and ka != kb


# -- estimators ---------------------------------------------------------------


def test_estimator_seeds_from_topology_and_ewma():
    def scenario(M):
        est = M.LinkRateEstimator.from_topology(small_topology(M), alpha=0.4)
        seeded = est.rates()
        est.observe("e0", "b", 125_000.0, 8 * 125_000.0 / 30e6)
        return seeded, est.rates(), sorted(small_topology(M).collab_pairs())

    seeded, after, pairs = both(scenario)
    assert sorted(seeded) == pairs and after[("e0", "b")] == pytest.approx(0.6 * NOMINAL + 0.4 * 30e6)
    assert after[("b", "e0")] == NOMINAL
    for M in (T, J):
        with pytest.raises(ValueError):
            M.LinkRateEstimator.from_topology(small_topology(M)).observe("e0", "b", 0.0, 1.0)
        with pytest.raises(ValueError):
            M.LinkRateEstimator({}, alpha=0.0)


def test_compute_estimator_seeds_from_topology_and_ewma():
    def scenario(M):
        est = M.ComputeRateEstimator.from_topology(small_topology(M), alpha=0.4)
        seeded = est.rates()
        nom = M.AGX_XAVIER.eff_flops
        est.observe("b", 1e9, 1e9 / (nom / 3.0))
        seen = est.observe_samples([("a", 2e9, 1e-2), ("e0", 1e9, 2e-3), ("a", 1e9, 5e-3)])
        return seeded, est.rates(), seen

    seeded, after, seen = both(scenario)
    nom = T.AGX_XAVIER.eff_flops
    assert set(seeded) == {"e0", "a", "b"} and after["b"] == pytest.approx(0.6 * nom + 0.4 * nom / 3.0)
    assert list(seen) == ["a", "e0"]
    for M in (T, J):
        est = M.ComputeRateEstimator.from_topology(small_topology(M))
        for bad in ((-1.0, 1.0), (1e9, 0.0)):
            with pytest.raises(ValueError):
                est.observe("b", *bad)
        with pytest.raises(ValueError):
            M.ComputeRateEstimator({}, alpha=1.5)


# -- plan cache ---------------------------------------------------------------


def test_plan_cache_lru_and_stats():
    def scenario(M):
        cache = M.PlanCache(capacity=2)
        a, b, c = ("ra",), ("rb",), ("rc",)
        out = [cache.get("a")]
        cache.put("a", a)
        cache.put("b", b)
        out.append(cache.get("a"))
        cache.put("c", c)
        out += [cache.get("b"), cache.get("a"), cache.get("c")]
        return out, cache.evictions, len(cache), cache.hits, cache.misses, cache.hit_rate, cache.entries()

    out, evictions, n, hits, misses, rate, entries = both(scenario)
    assert out == [None, ("ra",), None, ("ra",), ("rc",)]
    assert (evictions, n, hits, misses) == (1, 2, 3, 2) and rate == pytest.approx(0.6)
    assert entries == [("ra",), ("rc",)]
    with pytest.raises(ValueError):
        T.PlanCache(capacity=0)


# -- hysteresis -----------------------------------------------------------------


def _steps(M, cfg, rates):
    ctl = M.ReplanController(smoke_net(M), small_topology(M), cfg)
    out = []
    for rate in rates:
        observe_rate(ctl, rate)
        out.append(ctl.step())
    return out, ctl.replans, ctl._active, ctl.stats()


def test_hysteresis_debounces_single_epoch_excursions():
    steps, replans, _, _ = both(lambda M: _steps(
        M, M.ReplanConfig(alpha=1.0, hysteresis=3, bucket_frac=0.5),
        [30e6, NOMINAL, 30e6, 30e6, 30e6, 29e6]))
    assert steps == [False, False, False, False, True, False] and replans == 1


def test_hysteresis_leq_one_adopts_immediately():
    steps, replans, _, _ = both(lambda M: _steps(
        M, M.ReplanConfig(alpha=1.0, hysteresis=0, bucket_frac=0.5), [30e6]))
    assert steps == [True] and replans == 1


def test_hysteresis_not_starved_by_monotone_drift():
    steps, replans, _, _ = both(lambda M: _steps(
        M, M.ReplanConfig(alpha=1.0, hysteresis=2, bucket_frac=0.5), [60e6, 30e6]))
    assert steps == [False, True] and replans == 1


# -- controller + cache -------------------------------------------------------


def test_controller_cache_hits_on_bucket_revisit():
    def scenario(M):
        ctl = M.ReplanController(smoke_net(M), small_topology(M), fast(M))
        p_nominal = ctl.plan_for_epoch()
        observe_rate(ctl, 30e6)
        p_slow = ctl.plan_for_epoch()
        observe_rate(ctl, NOMINAL)
        back = ctl.plan_for_epoch() is p_nominal
        observe_rate(ctl, 30e6)
        again = ctl.plan_for_epoch() is p_slow
        return p_nominal, p_slow, back, again, ctl.stats(), key_of(M, ctl)

    *_, back, again, stats, _ = both(scenario)
    assert back and again
    assert (stats["cache_misses"], stats["cache_hits"], stats["optimizer_calls"], stats["replans"]) == (2, 2, 2, 3)


def test_shared_cache_across_controllers():
    def scenario(M):
        cache = M.PlanCache()
        a = M.ReplanController(smoke_net(M), small_topology(M), fast(M), cache=cache)
        a.plan_for_epoch()
        b = M.ReplanController(smoke_net(M), small_topology(M), fast(M), cache=cache)
        b.plan_for_epoch()
        c = M.ReplanController(smoke_net(M), small_topology(M), fast(M, bucket_frac=0.3), cache=cache)
        c.plan_for_epoch()
        return cache.hits, cache.misses, b.optimizer_calls, c.optimizer_calls, key_of(M, a), key_of(M, c)

    hits, misses, b_calls, c_calls, ka, kc = both(scenario)
    assert (hits, misses, b_calls, c_calls) == (1, 2, 0, 1) and ka[2] != kc[2]


def test_serving_reads_do_not_skew_epoch_telemetry():
    def scenario(M):
        ctl = M.ReplanController(smoke_net(M), small_topology(M), fast(M))
        ctl.plan_for_epoch()
        before = (ctl.cache.hits, ctl.cache.misses)
        reads = (ctl.plan, ctl.makespan, ctl.predicted_latency(4))
        ctl.observe_batch_latency(4, 0.01)
        after = (ctl.cache.hits, ctl.cache.misses)
        ctl.plan_for_epoch()
        return before, after, reads, ctl.stats()

    before, after, _, stats = both(scenario)
    assert before == after and stats["cache_hits"] == before[0] + 1


# -- joint compute+link adaptation --------------------------------------------


def test_undrifted_compute_matches_link_only_controller():
    def scenario(M):
        topo = small_topology(M)
        joint = M.ReplanController(smoke_net(M), topo, fast(M))
        link_only = M.ReplanController(smoke_net(M), topo, fast(M, adapt_compute=False))
        est = {es: joint.estimated_topology().platform_of(es).eff_flops for es in topo.es_names}
        plans = []
        for rate in (NOMINAL, 30e6, NOMINAL, 60e6):
            observe_rate(joint, rate)
            observe_rate(link_only, rate)
            plans.append((joint.plan_for_epoch(), link_only.plan_for_epoch()))
        return est, plans, joint.replans, link_only.replans

    est, plans, r_joint, r_link = both(scenario)
    assert all(v == T.AGX_XAVIER.eff_flops for v in est.values())
    assert all(a.parts == b.parts for a, b in plans) and r_joint == r_link >= 2


def test_compute_straggler_triggers_replan_and_cache_revisit():
    def scenario(M):
        ctl = M.ReplanController(smoke_net(M), fast_link_topology(M), fast(M))
        nom = M.AGX_XAVIER.eff_flops
        p0 = ctl.plan_for_epoch()
        observe_compute(ctl, "b", 0.3 * nom)
        switched = ctl.step()
        p_slow = ctl.current().plan
        observe_compute(ctl, "b", nom)
        back = ctl.plan_for_epoch() is p0
        observe_compute(ctl, "b", 0.3 * nom)
        again = ctl.plan_for_epoch() is p_slow
        return p0, p_slow, switched, back, again, ctl.stats(), key_of(M, ctl)

    p0, p_slow, switched, back, again, stats, _ = both(scenario)
    rows = lambda p: sum(pt.out["b"].rows for pt in p.parts)  # noqa: E731
    assert switched and back and again and rows(p_slow) < rows(p0)
    assert (stats["cache_misses"], stats["cache_hits"], stats["optimizer_calls"], stats["replans"]) == (2, 2, 2, 3)


def test_adapt_compute_false_freezes_compute_estimates():
    def scenario(M):
        ctl = M.ReplanController(smoke_net(M), fast_link_topology(M), fast(M, adapt_compute=False))
        key0 = ctl._bucket_key()
        observe_compute(ctl, "b", 0.2 * M.AGX_XAVIER.eff_flops)
        return ctl.compute_estimator.rates(), ctl._bucket_key() == key0, ctl.step()

    rates, unmoved, stepped = both(scenario)
    assert rates["b"] == T.AGX_XAVIER.eff_flops and unmoved and not stepped
    msgs = []
    for M in (T, J):
        ctl = M.ReplanController(smoke_net(M), fast_link_topology(M), fast(M, adapt_compute=False))
        for bad in (("nope", 1e9, 1.0), ("b", -1e9, 1.0)):
            with pytest.raises(ValueError) as exc:
                ctl.observe_compute(*bad)
            msgs.append(str(exc.value))
    assert msgs[:2] == msgs[2:]


def test_shared_hysteresis_debounces_compute_excursions():
    def scenario(M):
        ctl = M.ReplanController(smoke_net(M), fast_link_topology(M),
                                 M.ReplanConfig(alpha=1.0, hysteresis=2, bucket_frac=0.5))
        nom = M.AGX_XAVIER.eff_flops
        steps = []
        for rate in (0.3 * nom, nom, 0.3 * nom):
            observe_compute(ctl, "b", rate)
            steps.append(ctl.step())
        observe_rate(ctl, 10e6)
        steps.append(ctl.step())
        return steps, ctl.replans, ctl._active

    steps, replans, _ = both(scenario)
    assert steps == [False, False, False, True] and replans == 1


# -- eviction fallthrough and the calibration clamp ---------------------------


def test_active_result_falls_through_to_current_after_eviction():
    def scenario(M):
        cache = M.PlanCache(capacity=1)
        ctl = M.ReplanController(smoke_net(M), small_topology(M), fast(M), cache=cache)
        p0 = ctl.plan_for_epoch()
        calls = ctl.optimizer_calls
        cache.put(("someone", "else"), ("other",))
        evicted = cache.peek((ctl._fingerprint, ctl._active)) is None
        plan = ctl.plan
        return p0, plan, evicted, ctl.optimizer_calls - calls, ctl.plan is plan

    p0, plan, evicted, extra, cached = both(scenario)
    assert evicted and plan.parts == p0.parts and extra == 1 and cached


def test_observe_batch_latency_clamp_bounds():
    def scenario(M):
        ctl = M.ReplanController(smoke_net(M), small_topology(M), fast(M))
        base = ctl._raw_predicted_latency(2)
        out = [base]
        for b, dt in ((2, 1e6), (2, base * 1e-9), (2, 3.0 * base), (2, 0.0), (2, -1.0), (0, 1.0)):
            ctl.observe_batch_latency(b, dt)
            out.append(ctl.stats()["calibration"])
        return out

    out = both(scenario)
    assert out[1:3] == [10.0, 0.1] and out[3] == pytest.approx(3.0) and out[4:] == [out[3]] * 3


# -- trace + replay -----------------------------------------------------------


def test_gauss_markov_trace_deterministic_and_bounded():
    def scenario(M):
        tr = M.GaussMarkovTrace(lo=30e6, hi=120e6, corr=0.9, sigma_frac=0.2, seed=4)
        frozen = M.GaussMarkovTrace(lo=1.0, hi=2.0, corr=1.0, sigma_frac=0.0, start=1.5)
        return tr.rates(100), tr.rates(100), frozen.rates(5)

    rates, again, frozen = both(scenario)
    assert rates == again and all(30e6 <= r <= 120e6 for r in rates) and len(set(rates)) > 10
    assert frozen == [1.5] * 5
    for M in (T, J):
        with pytest.raises(ValueError):
            M.GaussMarkovTrace(lo=2.0, hi=1.0)
        with pytest.raises(ValueError):
            M.GaussMarkovTrace(lo=0.0, hi=1.0, corr=1.5)


def test_replay_validates_traces():
    msgs = []
    for M in (T, J):
        net, topo = smoke_net(M), small_topology(M)
        planner = M.StaticPlanner(M.optimize_static(net, topo, fast(M)).plan)
        short = {("e0", "b"): [NOMINAL] * 3, ("b", "e0"): [NOMINAL] * 3}
        for args, kw in (((net, topo, planner, {}), dict(n_tasks=1)),
                         ((net, topo, planner, short), dict(n_epochs=5, n_tasks=1))):
            with pytest.raises(ValueError) as exc:
                M.replay_rate_trace(*args, **kw)
            msgs.append(str(exc.value))
        msgs.append(M.replay_rate_trace(net, topo, planner, short, n_tasks=1))
    same(msgs[:3], msgs[3:])
    assert "at least one" in msgs[0] and "shortest trace" in msgs[1] and len(msgs[2]) == 3


def test_replay_trace_validates_compute_traces():
    def scenario(M):
        net, topo = smoke_net(M), fast_link_topology(M)
        planner = M.StaticPlanner(M.optimize_static(net, topo, fast(M)).plan)
        nom = M.AGX_XAVIER.eff_flops
        msgs = []
        for kw in (dict(), dict(compute_rates={"ghost": [1e12] * 3}), dict(compute_rates={"b": [0.0] * 3}),
                   dict(link_rates={("e0", "b"): [50e9] * 9}, compute_rates={"b": [nom] * 3}, n_epochs=5)):
            try:
                M.replay_trace(net, topo, planner, n_tasks=1, **kw)
                msgs.append(None)
            except ValueError as exc:
                msgs.append(str(exc))
        run = M.replay_trace(net, topo, planner, compute_rates={"b": [nom, 0.5 * nom, nom]}, n_tasks=1)
        return msgs, run

    msgs, run = both(scenario)
    for msg, want in zip(msgs, ("at least one", "not an ES", "positive", "shortest trace")):
        assert msg is not None and want in msg
    nom = T.AGX_XAVIER.eff_flops
    assert len(run) == 3 and run[1]["compute_rates"] == {"b": 0.5 * nom}
    assert run[1]["makespan"] > run[0]["makespan"]


def test_replay_joint_adaptation_beats_static_on_straggler():
    def scenario(M):
        net, topo = smoke_net(M), fast_link_topology(M)
        nom, n = M.AGX_XAVIER.eff_flops, 14
        trace = {"b": [nom] * 3 + [0.3 * nom] * (n - 3)}
        cfg = M.ReplanConfig(n_tasks=2, hysteresis=1, alpha=1.0)
        static = M.replay_trace(net, topo, M.StaticPlanner(M.optimize_static(net, topo, cfg).plan),
                                compute_rates=trace, n_tasks=2)
        link_ctl = M.ReplanController(net, topo, dataclasses.replace(cfg, adapt_compute=False))
        link_only = M.replay_trace(net, topo, link_ctl, compute_rates=trace, n_tasks=2)
        joint_ctl = M.ReplanController(net, topo, cfg)
        joint = M.replay_trace(net, topo, joint_ctl, compute_rates=trace, n_tasks=2)
        return static, link_only, joint, link_ctl.replans, joint_ctl.replans, joint_ctl.stats()

    static, link_only, joint, link_replans, joint_replans, _ = both(scenario)
    mean = lambda run: sum(r["makespan"] for r in run) / len(run)  # noqa: E731
    assert link_replans == 0 and mean(link_only) == pytest.approx(mean(static))
    assert joint_replans >= 1 and mean(joint) < 0.95 * mean(link_only)
    assert joint[-1]["makespan"] < link_only[-1]["makespan"]


def test_compute_replanned_plan_is_lossless():
    def scenario(M):
        ctl = M.ReplanController(smoke_net(M), fast_link_topology(M), fast(M))
        observe_compute(ctl, "b", 0.3 * M.AGX_XAVIER.eff_flops)
        return ctl.plan_for_epoch()

    plan = both(scenario)
    assert sum(pt.out["b"].rows for pt in plan.parts) < sum(pt.out["a"].rows for pt in plan.parts)
    assert_lossless(plan)


def test_replay_adaptive_beats_static_on_sustained_collapse():
    def scenario(M):
        net, topo = smoke_net(M), small_topology(M)
        n = 16
        trace = [NOMINAL] * 4 + [30e6] * (n - 4)
        link_rates = {("e0", "b"): trace, ("b", "e0"): trace}
        cfg = M.ReplanConfig(n_tasks=2, hysteresis=1)
        static = M.replay_rate_trace(net, topo, M.StaticPlanner(M.optimize_static(net, topo, cfg).plan),
                                     link_rates, n_tasks=2)
        ctl = M.ReplanController(net, topo, cfg)
        adaptive = M.replay_rate_trace(net, topo, ctl, link_rates, n_tasks=2)
        return static, adaptive, ctl.replans

    static, adaptive, replans = both(scenario)
    mean = lambda run: sum(r["makespan"] for r in run) / len(run)  # noqa: E731
    assert mean(adaptive) < 0.99 * mean(static) and replans >= 1
    assert "planner_stats" in adaptive[-1] and adaptive[-1]["makespan"] < static[-1]["makespan"]


# -- serving integration ------------------------------------------------------


def test_plan_aware_batch_size_tracks_channel():
    def scenario(M):
        ctl = M.ReplanController(smoke_net(M), small_topology(M), fast(M))
        channel = M.OffloadChannel(rate_bps=100e6, sigma_s=1e-3)
        pick = lambda d: PLAN_AWARE[M](ctl, d, channel, target=0.999, max_batch=8)  # noqa: E731
        out = dict(generous=pick(2.0), tight=pick(0.045), mid=pick(0.06), table=ctl.latency_table(8))
        observe_rate(ctl, 5e6)
        ctl.step()
        out.update(degraded=pick(0.06), degraded_table=ctl.latency_table(8), stats=ctl.stats())
        return out

    r = both(scenario)
    assert r["generous"] == 8 and r["tight"] == 0 and r["mid"] >= 1 and r["degraded"] <= r["mid"]
    assert r["table"].dtype == np.float64 and (r["degraded_table"] > r["table"]).all()


def test_observe_batch_latency_calibrates_predictions():
    def scenario(M):
        ctl = M.ReplanController(smoke_net(M), small_topology(M), fast(M))
        before = ctl.predicted_latency(2)
        ctl.observe_batch_latency(2, 3.0 * before)
        after = ctl.predicted_latency(2)
        ctl.observe_batch_latency(2, 1e6)
        return before, after, ctl.stats()["calibration"]

    before, after, calibration = both(scenario)
    assert after == pytest.approx(3.0 * before, rel=1e-6) and calibration <= 10.0


# -- losslessness of replanned plans and the latency memo -----------------------


def test_replanned_plan_is_lossless():
    def scenario(M):
        ctl = M.ReplanController(smoke_net(M), small_topology(M), fast(M))
        observe_rate(ctl, 30e6)
        return ctl.plan_for_epoch(), key_of(M, ctl)

    plan, _ = both(scenario)
    assert_lossless(plan)


def test_latency_memo_evicted_on_bucket_switch():
    def scenario(M):
        ctl = M.ReplanController(smoke_net(M), small_topology(M), fast(M))
        sizes = []
        ctl.latency_table(4)
        sizes.append(len(ctl._latency_memo))
        first = ctl._active
        observe_rate(ctl, 30e6)
        switched = ctl.step()
        only_active = all(k[1] == ctl._active for k in ctl._latency_memo)
        gone = not any(k[1] == first for k in ctl._latency_memo)
        ctl.latency_table(4)
        ctl.latency_table(4)
        sizes.append(len(ctl._latency_memo))
        observe_rate(ctl, NOMINAL)
        back = ctl.step()
        ctl.latency_table(2)
        sizes.append(len(ctl._latency_memo))
        return sizes, switched, only_active, gone, back, sorted(ctl._latency_memo.items())

    sizes, switched, only_active, gone, back, _ = both(scenario)
    assert sizes == [4, 4, 2] and switched and only_active and gone and back
