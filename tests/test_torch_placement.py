"""The port's per-task placement (``repro_torch.core.placement``) against the
JAX package's, on the CPU.

Each scenario of ``tests/test_placement.py`` is written once over a package
``M``, run in both and compared by exact equality (``same``): placements,
every per-task plan Segment for Segment, ``PlacementResult`` fields
(makespan, average delay, per-task finishes, knobs, ``evaluations``,
``history``), DES records, controller ``stats()``, ``predicted_latency``
and ``plan_aware_batch_size``.  The losslessness property runs every task's
plan through the port's ``run_plan`` (plain conv on the CPU) against JAX's
single-device forward at 2e-5, over fixed seeded pools in place of
hypothesis's draws.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from _torch_parity import jax_vgg_params
from repro.models import vgg as jvgg
from repro.runtime.serve import plan_aware_batch_size as jax_plan_aware_batch_size
from repro_torch.models import vgg
from repro_torch.models.common import params_from_jax
from repro_torch.runtime import plan_aware_batch_size
from repro_torch.spatial import run_plan
from test_torch_engines import same

PLAN_AWARE = {T: plan_aware_batch_size, J: jax_plan_aware_batch_size}


def hetero_pool(M, n=8, slow_links=True):
    """tests/test_placement.py: hetero_pool."""
    scales = (1.0, 1.0, 0.6, 0.6, 0.35, 0.35, 0.2, 0.2, 0.5, 0.9)[:n]
    secs = tuple(f"e{j}" for j in range(1, n + 1))
    platforms = {"e0": M.GTX_1080TI}
    links = {}
    for s, scale in zip(secs, scales):
        platforms[s] = M.GTX_1080TI.scaled(scale, f"es x{scale:g}")
        if slow_links and scale < 0.5:
            links[("e0", s)] = M.Link(10e9)
            links[(s, "e0")] = M.Link(10e9)
    return M.CollabTopology(host="e0", secondaries=secs, platforms=platforms, links=links,
                            default_link=M.Link(40e9))


def both(scenario):
    rec, jrec = scenario(T), scenario(J)
    same(rec, jrec)
    return rec


def errors(fn):
    """``fn(M)``'s ValueError message in each package, held equal."""
    msgs = []
    for M in (T, J):
        with pytest.raises(ValueError) as exc:
            fn(M)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


def result_record(res):
    """A PlacementResult's fields with the placement's own (the pool is a
    topology, compared through its plans)."""
    pl = res.placement
    return dict(assignments=pl.assignments, plans=pl.plans, makespan=res.makespan, avg_delay=res.avg_delay,
                per_task_finish=res.per_task_finish, knobs=res.knobs, evaluations=res.evaluations,
                history=res.history)


def des(run):
    return {k: v for k, v in run.items() if k != "sim"}


# ---------------------------------------------------------------------------
# TaskPlacement structure
# ---------------------------------------------------------------------------


def test_placement_validation():
    def plans(M):
        pool = hetero_pool(M, 4)
        net = M.vgg16_geom()
        return (pool, M.plan_halp_topology(net, pool.sub_topology(("e1", "e2"))),
                M.plan_halp_topology(net, pool.sub_topology(("e3", "e4"))))

    both(lambda M: M.TaskPlacement(pool=plans(M)[0], assignments=(("e1", "e2"), ("e3", "e4")),
                                   plans=plans(M)[1:]).plans)
    assert "more than one task" in errors(lambda M: M.TaskPlacement(
        pool=plans(M)[0], assignments=(("e1", "e2"), ("e1", "e2")), plans=(plans(M)[1],) * 2))
    assert "!= assignment" in errors(lambda M: M.TaskPlacement(
        pool=plans(M)[0], assignments=(("e3", "e4"),), plans=(plans(M)[1],)))
    assert "at least one task" in errors(lambda M: M.TaskPlacement(pool=plans(M)[0], assignments=(), plans=()))


def test_sub_topology_preserves_rates_and_order():
    def scenario(M):
        sub = hetero_pool(M, 6).sub_topology(("e5", "e2"))
        return sub.secondaries, sub.link_between("e0", "e5").rate_bps, sub.link_between("e0", "e2").rate_bps

    assert both(scenario) == (("e5", "e2"), 10e9, 40e9)
    errors(lambda M: hetero_pool(M, 6).sub_topology(("e1", "nope")))
    assert "duplicate" in errors(lambda M: hetero_pool(M, 6).sub_topology(("e1", "e1")))


def test_build_multitask_dag_validates():
    assert "at least one" in errors(lambda M: M.events.build_multitask_dag(M.Sim(), [], hetero_pool(M, 4)))

    def foreign(M):
        pool = hetero_pool(M, 4)
        p1 = M.plan_halp_topology(M.vgg16_geom(), pool.sub_topology(("e1", "e2")))
        other = M.plan_halp_topology(M.vgg16_geom(),
                                     M.CollabTopology.symmetric(M.GTX_1080TI, M.Link(40e9), host="h0"))
        M.events.build_multitask_dag(M.Sim(), [p1, other], pool)

    assert "host" in errors(foreign)


def test_multitask_dag_models_contention():
    def scenario(M):
        pool = hetero_pool(M, 4, slow_links=False)
        a = M.plan_halp_topology(M.vgg16_geom(), pool.sub_topology(("e1", "e2")))
        b = M.plan_halp_topology(M.vgg16_geom(), pool.sub_topology(("e3", "e4")))

        def makespan(plans):
            sim = M.Sim()
            heads = M.events.build_multitask_dag(sim, plans, pool)
            sim.run()
            return max(sim.finish_of(h) for h in heads)

        return makespan([a]), makespan([a, a]), makespan([a, b])

    one, shared, disjoint = both(scenario)
    assert one < shared < 2.0 * one and disjoint < shared


def test_single_task_multitask_dag_matches_simulate_halp():
    def scenario(M):
        pool = hetero_pool(M, 2)
        sub = pool.sub_topology(("e1", "e2"))
        plan = M.plan_halp_topology(M.vgg16_geom(), sub)
        sim = M.Sim()
        heads = M.events.build_multitask_dag(sim, [plan], pool)
        sim.run()
        return max(sim.finish_of(h) for h in heads), M.simulate_halp(M.vgg16_geom(), topology=sub, plan=plan)["total"]

    ours, ref = both(scenario)
    assert ours == pytest.approx(ref, rel=1e-12)


# ---------------------------------------------------------------------------
# the placement optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["batched", "scalar"])
def test_place_tasks_structure_and_quality(engine):
    def scenario(M):
        pool = hetero_pool(M, 8)
        res = M.place_tasks(M.vgg16_geom(), pool, 4, optimize_final=False, swap_rounds=2, engine=engine)
        return result_record(res), des(M.simulate_placement(M.vgg16_geom(), res.placement))

    r, sim = both(scenario)
    assigned = [s for g in r["assignments"] for s in g]
    assert sorted(assigned) == [f"e{j}" for j in range(1, 9)] and all(len(g) >= 2 for g in r["assignments"])
    assert not any({"e1", "e2"} <= set(g) for g in r["assignments"])
    assert r["makespan"] == pytest.approx(sim["total"], rel=1e-12)
    assert r["avg_delay"] == pytest.approx(sim["avg_delay"], rel=1e-12)
    assert r["evaluations"] >= len(r["history"]) > 0


def test_place_tasks_refined_matches_jax():
    """``optimize_final=True``: per-task ``optimize_plan`` refinement, warm
    started from the incumbent knobs and re-validated jointly."""
    r = both(lambda M: result_record(M.place_tasks(M.vgg16_geom(), hetero_pool(M, 6), 2, swap_rounds=1,
                                                   max_rounds=2, overlap_choices=(2, 4))))
    assert len(r["knobs"]) == 2 and r["evaluations"] > len(r["history"])


def test_place_tasks_beats_shared_plan_baseline():
    def scenario(M):
        pool = hetero_pool(M, 8)
        shared = des(M.simulate_placement(M.vgg16_geom(), M.shared_plan_placement(M.vgg16_geom(), pool, 4)))
        res = M.place_tasks(M.vgg16_geom(), pool, 4, optimize_final=False, swap_rounds=2)
        return shared, result_record(res)

    shared, r = both(scenario)
    assert r["avg_delay"] < shared["avg_delay"] and r["makespan"] < shared["total"]


def test_place_tasks_rejects_bad_inputs():
    assert "need >=" in errors(lambda M: M.place_tasks(M.vgg16_geom(), hetero_pool(M, 4), 3))
    assert "objective" in errors(lambda M: M.place_tasks(M.vgg16_geom(), hetero_pool(M, 4), 2, objective="latency"))
    assert "at least one task" in errors(lambda M: M.place_tasks(M.vgg16_geom(), hetero_pool(M, 4), 0))
    assert "engine" in errors(lambda M: M.place_tasks(M.vgg16_geom(), hetero_pool(M, 4), 2, engine="fast"))


def test_shared_plan_placement_is_pool_order_equal_split():
    pl = both(lambda M: M.shared_plan_placement(M.vgg16_geom(), hetero_pool(M, 8), 4).plans)
    assert [tuple(p.secondary_slots) for p in pl] == [("e1", "e2"), ("e3", "e4"), ("e5", "e6"), ("e7", "e8")]
    for plan in pl:
        a, b = (plan.parts[0].out[s].rows for s in plan.secondary_slots)
        assert abs(a - b) <= 8
    assert "needs >= 2 per task" in errors(lambda M: M.shared_plan_placement(M.vgg16_geom(), hetero_pool(M, 4), 3))


# ---------------------------------------------------------------------------
# the controller and its serving surface
# ---------------------------------------------------------------------------


def controller(M, pool, **options):
    opts = dict(optimize_final=False, swap_rounds=1)
    opts.update(options)
    return M.PlacementController(M.vgg16_geom(), pool, M.ReplanConfig(n_tasks=2, max_rounds=2),
                                 placement_options=opts)


def test_placement_controller_replaces_on_bucket_switch():
    def scenario(M):
        ctl = controller(M, hetero_pool(M, 4))
        first = ctl.placement_for_epoch()
        calls = ctl.optimizer_calls
        again = ctl.placement_for_epoch() is first
        for _ in range(4):
            ctl.observe_transfer("e1", "e0", 1e6, 8.0 * 1e6 / 4e9)
            ctl.observe_transfer("e0", "e1", 1e6, 8.0 * 1e6 / 4e9)
        ctl.placement_for_epoch()
        switched = ctl.placement_for_epoch()
        return first.plans, switched.plans, calls, again, ctl.stats(), type(switched).__name__

    _, _, calls, again, stats, kind = both(scenario)
    assert calls == 1 and again and stats["replans"] >= 1 and stats["optimizer_calls"] == 2
    assert kind == "TaskPlacement"


def test_placement_controller_replaces_on_compute_straggler():
    def scenario(M):
        pool = hetero_pool(M, 4)
        ctl = controller(M, pool)
        first = ctl.placement_for_epoch()
        t = next(t for t, g in enumerate(first.assignments) if "e1" in g)
        before = sum(pt.out["e1"].rows for pt in first.plans[t].parts if "e1" in pt.out)
        nom = pool.platform_of("e1").eff_flops
        for _ in range(4):
            ctl.observe_compute("e1", 1e9, 1e9 / (0.15 * nom))
            ctl.placement_for_epoch()
        switched = ctl.placement
        est = ctl.estimated_topology()
        tb = next(t for t, g in enumerate(switched.assignments) if "e1" in g)
        after = sum(pt.out["e1"].rows for pt in switched.plans[tb].parts if "e1" in pt.out)
        return dict(stats=ctl.stats(), moved=switched is not first, before=before, after=after, nom=nom,
                    e1=est.platform_of("e1").eff_flops, e2=est.platform_of("e2").eff_flops,
                    e2_nom=pool.platform_of("e2").eff_flops, assignments=switched.assignments)

    r = both(scenario)
    assert r["stats"]["replans"] >= 1 and r["stats"]["optimizer_calls"] >= 2 and r["moved"]
    assert r["e1"] < 0.35 * r["nom"] and r["e2"] == r["e2_nom"] and r["after"] < r["before"]


def test_placement_controller_serving_surface():
    def scenario(M):
        ctl = controller(M, hetero_pool(M, 4))
        ctl.placement_for_epoch()
        lat2, lat4 = ctl.predicted_latency(2), ctl.predicted_latency(4)
        ctl.observe_batch_latency(2, lat2 * 1.5)
        b = PLAN_AWARE[M](ctl, deadline_s=4.0 / 30.0, channel=M.OffloadChannel(rate_bps=60e6, sigma_s=5e-3),
                          max_batch=8)
        return lat2, lat4, ctl.predicted_latency(2), b, ctl.latency_table(6), ctl.stats()

    lat2, lat4, calibrated, b, _, _ = both(scenario)
    assert lat2 < lat4 < 3.0 * lat2 and calibrated > lat2 and 1 <= b <= 8
    msgs = []
    for M in (T, J):
        ctl = controller(M, hetero_pool(M, 4))
        with pytest.raises(TypeError, match="placement_for_epoch") as exc:
            ctl.plan_for_epoch()
        with pytest.raises(TypeError, match="placement") as exc2:
            ctl.plan  # noqa: B018
        msgs.append((str(exc.value), str(exc2.value)))
    assert msgs[0] == msgs[1]


def test_controller_kinds_share_one_cache_without_collisions():
    def scenario(M):
        pool = hetero_pool(M, 4)
        cache = M.PlanCache()
        plan_ctl = M.ReplanController(M.vgg16_geom(), pool, M.ReplanConfig(n_tasks=2, max_rounds=1), cache=cache)
        place_ctl = M.PlacementController(M.vgg16_geom(), pool, M.ReplanConfig(n_tasks=2, max_rounds=1),
                                          cache=cache, placement_options=dict(optimize_final=False, swap_rounds=1))
        plan_ctl.plan_for_epoch()
        place_ctl.placement_for_epoch()
        keys = [(c._fingerprint, c._active) for c in (plan_ctl, place_ctl)]
        return len(cache), plan_ctl.optimizer_calls, place_ctl.optimizer_calls, [M.key_hash(k) for k in keys]

    n, a, b, hashes = both(scenario)
    assert (n, a, b) == (2, 1, 1) and hashes[0] != hashes[1]


# ---------------------------------------------------------------------------
# property: every placement executes lossless (fixed seeded pools)
# ---------------------------------------------------------------------------


def random_pool(M, n_pool, seed):
    rng = random.Random(seed)
    secs = tuple(f"e{j}" for j in range(1, n_pool + 1))
    platforms = {"e0": M.GTX_1080TI}
    links = {}
    for s in secs:
        platforms[s] = M.GTX_1080TI.scaled(rng.uniform(0.2, 1.0), f"r{s}")
        rate = rng.choice((10e9, 25e9, 40e9))
        links[("e0", s)] = M.Link(rate)
        links[(s, "e0")] = M.Link(rate)
    return M.CollabTopology(host="e0", secondaries=secs, platforms=platforms, links=links, default_link=M.Link(40e9))


@pytest.mark.parametrize("n_pool,n_tasks,seed", [(4, 1, 0), (5, 2, 17), (6, 2, 4242), (6, 1, 9999)])
def test_placement_lossless_property(n_pool, n_tasks, seed):
    cfg, jcfg = vgg.VGGConfig(img_res=64, width_mult=0.25, num_classes=10), jvgg.VGGConfig(
        img_res=64, width_mult=0.25, num_classes=10)
    nets = {T: cfg.geom(), J: jcfg.geom()}
    r = both(lambda M: result_record(M.place_tasks(nets[M], random_pool(M, n_pool, seed), n_tasks,
                                                   optimize_final=False, swap_rounds=1)))
    jp = jax_vgg_params(jcfg, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal((1, 64, 64, 3), dtype=np.float32)
    ref = np.asarray(jvgg.features(jp, jcfg, jnp.asarray(x)))
    p = params_from_jax(jp)
    for plan in r["plans"]:
        out = run_plan(plan, p["features"], vgg.apply_layer, torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
