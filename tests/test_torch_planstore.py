"""The port's plan store (``repro_torch.core.planstore``) against the JAX
package's, on the CPU.

Each scenario of ``tests/test_planstore.py`` (and the store's invalidation
cases of ``tests/test_analysis.py``) is written once over a package ``M``,
run in both with a store file of its own, and compared by exact equality:
``canonical_key`` texts and ``key_hash`` of the same controller keys, store
and cache counters, ``stats()`` dicts, served results field for field, and
the key texts that land in the file.  The demo cluster, configs and
lattice walk are ``tools/precompute_plans.py``'s (``lattice_keys`` reads only
a controller's active key and nominal topology, so it walks either
package's).  One case only the port has: a row the JAX package wrote is
refused, counted in ``stale`` and left in the file.
"""
import dataclasses
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))  # tools/ is a plain directory, not a package

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from test_torch_analysis import mutate_part  # noqa: E402
from test_torch_engines import demo_topology, same, smoke_net  # noqa: E402
from tools.precompute_plans import lattice_keys  # noqa: E402


def demo_config(M, **kw):
    """tools/precompute_plans.py: demo_config."""
    return M.ReplanConfig(**dict(dict(use_simulator=False, alpha=1.0, hysteresis=1, bucket_frac=0.5), **kw))


def demo_scheme_config(M):
    """tools/precompute_plans.py: demo_scheme_config."""
    return M.ReplanConfig(use_simulator=True, n_tasks=1, alpha=1.0, hysteresis=1, bucket_frac=0.5,
                          schemes=M.SCHEMES)


def controller(M, store=None, config=None):
    return M.ReplanController(smoke_net(M), demo_topology(M), config if config is not None else demo_config(M),
                              store=store)


def precompute(M, path, link_shifts, compute_shifts, config=None):
    """tools/precompute_plans.py: precompute, in either package (no timing)."""
    with M.PlanStore(path) as store:
        ctl = controller(M, store, config)
        keys = lattice_keys(ctl, link_shifts, compute_shifts)
        for key in keys:
            ctl.prime(key)
        return dict(lattice_points=len(keys), optimizer_calls=ctl.optimizer_calls,
                    already_stored=ctl.cache.store_hits, store_entries=len(store), keys=store.keys())


def both(tmp_path, scenario):
    """The scenario run in the port and in JAX, each in a directory of its
    own, held equal; returns the port's record."""
    (tmp_path / "T").mkdir()
    (tmp_path / "J").mkdir()
    rec, jrec = scenario(T, tmp_path / "T"), scenario(J, tmp_path / "J")
    same(rec, jrec)
    return rec


# ---------------------------------------------------------------------------
# canonical_key
# ---------------------------------------------------------------------------

DISTINCT = [("1",), (1,), (1.0,), (True,), (None,), (("a",),), ("a",), ((),), (0.5,), (0.25 + 0.25,)]
NESTED = (("plan", ("e0", ("a", "b")), 0.5), ((("e0", "a"), -3),))


def test_canonical_key_is_type_distinct():
    texts = [T.canonical_key(k) for k in DISTINCT]
    assert texts == [J.canonical_key(k) for k in DISTINCT]
    assert [T.key_hash(k) for k in DISTINCT + [NESTED]] == [J.key_hash(k) for k in DISTINCT + [NESTED]]
    assert texts[8] == texts[9] and len(set(texts[:9])) == 9
    assert T.canonical_key(NESTED) == T.canonical_key(NESTED) and T.key_hash(NESTED) == T.key_hash(NESTED)


@pytest.mark.parametrize("bad", [({"a": 1},), (float("inf"),), (float("nan"),)], ids=["dict", "inf", "nan"])
def test_canonical_key_rejects_unsupported(bad):
    errs = []
    for M in (T, J):
        with pytest.raises((TypeError, ValueError)) as exc:
            M.canonical_key(bad)
        errs.append((type(exc.value).__name__, str(exc.value)))
    assert errs[0] == errs[1]


def test_controller_keys_and_hashes_equal_jax():
    """Every controller key the store is addressed by -- the halo-only and
    the scheme config, across a lattice -- has the same canonical text and
    sha256 in both packages (floats by ``repr``: band anchors, eff_flops)."""
    out = []
    for M in (T, J):
        rows = []
        for cfg in (demo_config(M), demo_scheme_config(M), demo_config(M, bucket_frac=0.0)):
            ctl = controller(M, config=cfg)
            for key in lattice_keys(ctl, [-1, 0, 1], [-2, 0]):
                full = (ctl._fingerprint, key)
                rows.append((full, M.canonical_key(full), M.key_hash(full)))
        out.append(rows)
    same(out[0], out[1])


# ---------------------------------------------------------------------------
# PlanStore: round trip, provenance, invalidation
# ---------------------------------------------------------------------------


def test_store_round_trip_bit_identical(tmp_path):
    def scenario(M, d):
        ctl = controller(M)
        result = ctl.current()
        key = (ctl._fingerprint, ctl._active)
        with M.PlanStore(d / "s.sqlite") as store:
            first = (store.get(key), store.misses)
            store.put(key, result, provenance={"engine": "batched", "note": "t"})
            loaded = store.get(key)
            prov = store.provenance(key)
            created = prov.pop("created_s")
            return dict(first=first, loaded=loaded, equal=loaded == result, result=result, prov=prov,
                        created=created > 0, keys=(store.keys(), store.keys(kind="plan"),
                                                   store.keys(kind="placement")),
                        stats={k: v for k, v in store.stats().items() if k != "path"})

    r = both(tmp_path, scenario)
    assert r["first"] == (None, 1) and r["equal"] and r["loaded"].makespan == r["result"].makespan
    assert r["prov"]["engine"] == "batched" and r["prov"]["note"] == "t" and r["created"]
    assert r["stats"]["hits"] == 1 and r["stats"]["writes"] == 1 and r["stats"]["entries"] == 1
    assert r["keys"][0] == r["keys"][1] and r["keys"][2] == []


def test_store_schema_version_invalidation(tmp_path):
    def scenario(M, d):
        path, key = d / "s.sqlite", (("plan", "k"), (1,))
        with M.PlanStore(path) as store:
            store.put(key, ("payload",))
        with M.PlanStore(path, schema_version=M.PLAN_SCHEMA_VERSION + 1) as bumped:
            got = bumped.get(key)
            counts = (bumped.stale, bumped.misses, len(bumped), bumped.prune_stale())
        with M.PlanStore(path) as reopened:
            return got, counts, reopened.get(key), M.PLAN_SCHEMA_VERSION

    got, counts, again, version = both(tmp_path, scenario)
    assert got is None and counts == (1, 1, 0, 1) and again is None and version == 2


def test_store_hash_collision_never_serves_wrong_plan(tmp_path):
    def scenario(M, d):
        key = (("plan", "k"), (1,))
        with M.PlanStore(d / "s.sqlite") as store:
            store.put(key, ("payload",))
            store._conn.execute("UPDATE plans SET key_text = ?", (M.canonical_key((("plan", "other"), (2,))),))
            store._conn.commit()
            return store.get(key), store.misses

    assert both(tmp_path, scenario) == (None, 1)


def test_store_invalidate_by_kind(tmp_path):
    def scenario(M, d):
        with M.PlanStore(d / "s.sqlite") as store:
            store.put((("plan", "a"), (1,)), 1)
            store.put((("placement", "b"), (2,)), 2)
            return (len(store), store.invalidate(kind="placement"), store.keys(kind="placement"),
                    len(store), store.invalidate(), len(store))

    assert both(tmp_path, scenario) == (2, 1, [], 1, 1, 0)


# ---------------------------------------------------------------------------
# the two-tier PlanCache
# ---------------------------------------------------------------------------


def test_two_tier_cache_store_outlives_lru_eviction(tmp_path):
    def scenario(M, d):
        with M.PlanStore(d / "s.sqlite") as store:
            cache = M.PlanCache(capacity=1, store=store)
            k1, k2 = (("plan", "x"), (1,)), (("plan", "x"), (2,))
            cache.put(k1, "r1")
            cache.put(k2, "r2")
            out = [cache.evictions, len(cache), len(store), cache.peek(k1), cache.get(k1),
                   cache.store_hits, cache.hits, cache.peek(k1), store.writes,
                   cache.get((("plan", "x"), (3,))), cache.misses]
            return out

    assert both(tmp_path, scenario) == [1, 1, 2, None, "r1", 1, 1, "r1", 2, None, 1]


def test_storeless_cache_counters_unchanged():
    out = []
    for M in (T, J):
        cache = M.PlanCache(capacity=2)
        cache.put("a", 1)
        out.append((cache.store, cache.get("a"), cache.get("b"), cache.hits, cache.misses, cache.store_hits))
    assert out[0] == out[1] == (None, 1, None, 1, 1, 0)


# ---------------------------------------------------------------------------
# controllers over a persistent store: warm starts, invalidation, sharing
# ---------------------------------------------------------------------------


def test_warm_restart_serves_first_plan_with_zero_optimizer_calls(tmp_path):
    def scenario(M, d):
        path = d / "plans.sqlite"
        with M.PlanStore(path) as store:
            cold = controller(M, store)
            r_cold = cold.current()
            cold_stats = cold.stats()
        with M.PlanStore(path) as store:
            warm = controller(M, store)
            r_warm = warm.current()
            return r_cold, r_warm, r_warm == r_cold, cold_stats, warm.stats()

    r_cold, r_warm, equal, cold_stats, warm_stats = both(tmp_path, scenario)
    assert cold_stats["optimizer_calls"] == 1 and cold_stats["store_entries"] == 1
    assert warm_stats["optimizer_calls"] == 0 and warm_stats["store_hits"] == 1
    assert equal and r_warm.plan == r_cold.plan and r_warm.makespan == r_cold.makespan


def test_optimizer_config_change_never_serves_stale_plan(tmp_path):
    def scenario(M, d):
        path = d / "plans.sqlite"
        with M.PlanStore(path) as store:
            controller(M, store).current()
        with M.PlanStore(path) as store:
            ctl = controller(M, store, demo_config(M, max_rounds=M.ReplanConfig().max_rounds + 1))
            ctl.current()
            return ctl.stats(), len(store)

    stats, n = both(tmp_path, scenario)
    assert stats["optimizer_calls"] == 1 and stats["store_hits"] == 0 and n == 2


def test_prime_fills_store_without_adopting(tmp_path):
    def scenario(M, d):
        with M.PlanStore(d / "plans.sqlite") as store:
            ctl = controller(M, store)
            before = ctl._active
            keys = lattice_keys(ctl, [-1, 0], [-1, 0])
            results = [ctl.prime(k) for k in keys]
            calls = ctl.optimizer_calls
            again = [ctl.prime(k) for k in keys]
            return (ctl._active == before, calls, len(keys), len(store), ctl.optimizer_calls,
                    results, again, store.keys())

    unmoved, calls, n_keys, n_store, calls_after, results, again, _ = both(tmp_path, scenario)
    assert unmoved and calls == n_keys == n_store == calls_after == 4 and results == again


# the port's lattice walk in a process of its own, importing only the port
PORT_PRECOMPUTE = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.core import AGX_XAVIER, SCHEMES, CollabTopology, Link, PlanStore, ReplanConfig, ReplanController
from repro_torch.models import vgg

topo = CollabTopology(host="e0", secondaries=("a", "b"),
                      platforms={{"e0": AGX_XAVIER, "a": AGX_XAVIER, "b": AGX_XAVIER}},
                      default_link=Link(120e6))
base = dict(alpha=1.0, hysteresis=1, bucket_frac=0.5)
for cfg, compute_shifts in ((ReplanConfig(use_simulator=False, **base), (-2, -1, 0)),
                            (ReplanConfig(use_simulator=True, n_tasks=1, schemes=SCHEMES, **base), (0,))):
    with PlanStore({path!r}) as store:
        ctl = ReplanController(vgg.SMOKE.geom(), topo, cfg, store=store)
        links, compute = ctl._active
        for dl in (-1, 0, 1):
            for dc in compute_shifts:
                ctl.prime((tuple(sorted((pair, b + dl) for pair, b in links)),
                           tuple(sorted((es, nom, b + dc if es == "b" else b) for es, nom, b in compute))))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
assert not bad, bad
"""


def test_cross_process_sharing_one_store_file(tmp_path):
    """A store filled by another process warm-starts a controller here: the
    port's lattice walk in a subprocess, then every point served with zero
    optimizer calls -- and the file holds exactly the key texts that the JAX
    package's ``tools/precompute_plans.py --smoke`` writes."""
    path, jpath = tmp_path / "plans.sqlite", tmp_path / "jax.sqlite"
    code = PORT_PRECOMPUTE.format(src=str(REPO / "src"), path=str(path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "precompute_plans.py"), "--store", str(jpath),
                           "--smoke"], capture_output=True, text=True, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    with T.PlanStore(path) as store, J.PlanStore(jpath) as jstore:
        assert len(store) == len(jstore) == 12
        assert store.keys() == jstore.keys()
        ctl = controller(T, store)
        for key in lattice_keys(ctl, [-1, 0, 1], [-2, -1, 0]):
            ctl.prime(key)
        assert ctl.optimizer_calls == 0 and ctl.cache.store_hits == 9
        sctl = controller(T, store, demo_scheme_config(T))
        for key in lattice_keys(sctl, [-1, 0, 1], [0]):
            sctl.prime(key)
        assert sctl.optimizer_calls == 0 and sctl.cache.store_hits == 3


def test_two_controllers_share_one_store_live(tmp_path):
    def scenario(M, d):
        path = d / "plans.sqlite"
        with M.PlanStore(path) as s1, M.PlanStore(path) as s2:
            a, b = controller(M, s1), controller(M, s2)
            a.current()
            b.current()
            return a.optimizer_calls, b.optimizer_calls, b.cache.store_hits, b.plan == a.plan, b.plan

    calls_a, calls_b, hits, equal, _ = both(tmp_path, scenario)
    assert (calls_a, calls_b, hits) == (1, 0, 1) and equal


def test_store_provenance_equal_jax(tmp_path):
    """The rows a lattice walk writes carry the same provenance in both
    packages: band-representative link rates and platforms, makespan,
    engine (the creation time aside)."""
    def scenario(M, d):
        with M.PlanStore(d / "plans.sqlite") as store:
            ctl = controller(M, store)
            rows = []
            for key in lattice_keys(ctl, [-1, 0], [-1, 0]):
                ctl.prime(key)
                prov = store.provenance((ctl._fingerprint, key))
                prov.pop("created_s")
                rows.append(prov)
            return rows

    rows = both(tmp_path, scenario)
    assert len(rows) == 4 and all(r["kind"] == "plan" and r["engine"] == "batched" for r in rows)


def test_precompute_is_idempotent(tmp_path):
    def scenario(M, d):
        path = str(d / "plans.sqlite")
        return precompute(M, path, [-1, 0], [0]), precompute(M, path, [-1, 0], [0])

    first, again = both(tmp_path, scenario)
    assert first["optimizer_calls"] == 2 and first["store_entries"] == 2
    assert again["optimizer_calls"] == 0 and again["already_stored"] == 2 and again["store_entries"] == 2


def test_precompute_scheme_lattice_idempotent_and_disjoint(tmp_path):
    def scenario(M, d):
        path = str(d / "plans.sqlite")
        first = precompute(M, path, [-1, 0], [0], config=demo_scheme_config(M))
        again = precompute(M, path, [-1, 0], [0], config=demo_scheme_config(M))
        return first, again, precompute(M, path, [-1, 0], [0])

    first, again, halo = both(tmp_path, scenario)
    assert first["optimizer_calls"] == 2 and first["store_entries"] == 2
    assert again["optimizer_calls"] == 0 and again["already_stored"] == 2
    assert halo["optimizer_calls"] == 2 and halo["store_entries"] == 4


def test_scheme_vocabulary_rekeys_but_engine_does_not(tmp_path):
    def scenario(M, d):
        path = d / "plans.sqlite"
        base = demo_config(M, use_simulator=True, n_tasks=1)
        with M.PlanStore(path) as store:
            cold = controller(M, store, base)
            r_base = cold.current()
            out = [cold.optimizer_calls]
        with M.PlanStore(path) as store:
            ctl = controller(M, store, dataclasses.replace(base, schemes=M.SCHEMES))
            ctl.current()
            out += [ctl.optimizer_calls, ctl.stats()["store_hits"], len(store)]
        with M.PlanStore(path) as store:
            ctl = controller(M, store, dataclasses.replace(base, engine="scalar"))
            r_warm = ctl.current()
            out += [ctl.optimizer_calls, ctl.stats()["store_hits"], r_warm == r_base]
        return out, r_warm

    out, _ = both(tmp_path, scenario)
    assert out == [1, 1, 0, 2, 0, 1, True]


# ---------------------------------------------------------------------------
# corrupt rows degrade to misses (tests/test_analysis.py:495-531)
# ---------------------------------------------------------------------------


def _res(M):
    return M.optimize_plan(smoke_net(M), demo_topology(M), max_rounds=1)


def test_store_garbage_payload_invalidated(tmp_path):
    def scenario(M, d):
        store, key = M.PlanStore(d / "s.sqlite"), (("plan", "k"), (0,))
        store.put(key, _res(M))
        served = store.get(key) is not None
        store._conn.execute("UPDATE plans SET payload = ?", (b"\x80garbage",))
        store._conn.commit()
        return served, store.get(key), store.invalid, store.misses, len(store)

    assert both(tmp_path, scenario) == (True, None, 1, 1, 0)


def test_store_corrupt_plan_invalidated(tmp_path):
    def scenario(M, d):
        store, key = M.PlanStore(d / "s.sqlite"), (("plan", "k"), (0,))
        res = _res(M)
        store.put(key, res)
        plan = res.plan
        slot = next(s for s in plan.es_names if plan.parts[0].out[s])
        seg = plan.parts[0].out[slot]
        bad = dataclasses.replace(res, plan=mutate_part(plan, 0, slot, out=M.Segment(seg.lo + 1, seg.hi)))
        store._conn.execute("UPDATE plans SET payload = ?", (pickle.dumps(bad),))
        store._conn.commit()
        return store.get(key), store.invalid, len(store), store.stats()["invalid"]

    assert both(tmp_path, scenario) == (None, 1, 0, 1)


def test_store_non_plan_payloads_pass_through(tmp_path):
    def scenario(M, d):
        store = M.PlanStore(d / "s.sqlite")
        store.put((("plan", "k"), (0,)), "just-a-string")
        return store.get((("plan", "k"), (0,))), store.hits, store.invalid

    assert both(tmp_path, scenario) == ("just-a-string", 1, 0)


# ---------------------------------------------------------------------------
# the port only: a row the JAX package wrote is another package's
# ---------------------------------------------------------------------------


def test_jax_written_row_is_a_stale_miss_and_stays(tmp_path):
    """The same operating point keys the same row in both packages; the
    port refuses JAX's payload (its classes are ``repro.core``'s), counts
    the read in ``stale`` and leaves the row, where JAX still serves it."""
    path = tmp_path / "plans.sqlite"
    with J.PlanStore(path) as jstore:
        jctl = controller(J, jstore)
        jres = jctl.current()
        jkey = (jctl._fingerprint, jctl._active)
    ctl = controller(T)
    key = (ctl._fingerprint, ctl._active)
    assert T.key_hash(key) == J.key_hash(jkey)
    with T.PlanStore(path) as store:
        assert store.get(key) is None
        assert (store.stale, store.misses, store.invalid, store.hits) == (1, 1, 0, 0)
        assert len(store) == 1 and store.keys() == [T.canonical_key(key)]
        assert store.provenance(key)["makespan"] == jres.makespan
    with J.PlanStore(path) as jstore:
        assert jstore.get(jkey) == jres


def test_port_payload_refuses_foreign_classes(tmp_path):
    """The unpickler resolves only ``repro_torch``, ``builtins``,
    ``collections``, ``copyreg`` and ``numpy`` names: an OrderedDict, numpy
    scalars and the port's own plan load, a class of any other module is a
    stale miss (never imported, never deleted)."""
    import collections
    import fractions

    import numpy as np

    store = T.PlanStore(tmp_path / "s.sqlite")
    ok = (collections.OrderedDict(a=np.float64(1.5)), np.arange(3), _res(T))
    store.put((("plan", "ok"), (0,)), ok)
    got = store.get((("plan", "ok"), (0,)))
    assert got[0] == ok[0] and (got[1] == ok[1]).all() and got[2] == ok[2]
    store.put((("plan", "bad"), (0,)), fractions.Fraction(1, 3))
    assert store.get((("plan", "bad"), (0,))) is None
    assert (store.stale, store.invalid, len(store)) == (1, 0, 2)
