"""The planner tools' twins (``tools/precompute_plans_torch.py``,
``tools/check_torch.py``) against the JAX tools, on the CPU.

``precompute``'s summaries, the key texts it writes and the plan stored at
every key are held ``==`` to ``tools/precompute_plans.py``'s (plans field
by field, ``test_torch_engines.same``).  ``check_benchmarks`` is held to
the JAX tool's section by section: the same findings (none) and the same
check count less one per accepted K2 geometry of two or more output rows
(the port's kernel pass has no ``kernel.tiles`` check: ROADMAP §3, "kept on
purpose").  The CLIs run to their ends: ``--smoke`` fills a store a
restarted controller serves with 0 optimizer calls, and ``check_torch
--store <it> --benchmarks`` exits 0.
"""
import sqlite3
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))  # the tools import each other by module name

import check as jcheck  # noqa: E402
import check_torch as tcheck  # noqa: E402
import precompute_plans as jpre  # noqa: E402
import precompute_plans_torch as tpre  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.analysis.kernel_check import plan_kernel_calls  # noqa: E402
from test_torch_engines import same  # noqa: E402

SMOKE = ([-1, 0, 1], [-2, -1, 0])


def test_demo_builders_equal_jax():
    same(tpre.demo_net(), jpre.demo_net())
    same(tpre.demo_topology(), jpre.demo_topology())
    same(tpre.demo_config(), jpre.demo_config())
    same(tpre.demo_scheme_config(), jpre.demo_scheme_config())
    assert tpre.NOMINAL_BPS == jpre.NOMINAL_BPS


@pytest.mark.parametrize("lattice", ["halo", "scheme"])
def test_precompute_equals_jax(tmp_path, lattice):
    """Both walks over the same lattice: summaries (timing and path aside),
    lattice keys, key texts in the file, and every stored plan."""
    links, computes = SMOKE if lattice == "halo" else (SMOKE[0], [0])
    tcfg, jcfg = ((tpre.demo_config(), jpre.demo_config()) if lattice == "halo"
                  else (tpre.demo_scheme_config(), jpre.demo_scheme_config()))
    tpath, jpath = str(tmp_path / "t.sqlite"), str(tmp_path / "j.sqlite")
    out, jout = tpre.precompute(tpath, links, computes, config=tcfg), jpre.precompute(jpath, links, computes,
                                                                                      config=jcfg)
    for o in (out, jout):
        o.pop("elapsed_s"), o.pop("store")
    assert out == jout and out["lattice_points"] == len(links) * len(computes)
    again = tpre.precompute(tpath, links, computes, config=tcfg)
    assert again["optimizer_calls"] == 0 and again["already_stored"] == out["lattice_points"]
    with T.PlanStore(tpath) as store, J.PlanStore(jpath) as jstore:
        assert store.keys() == jstore.keys()
        ctl = T.ReplanController(tpre.demo_net(), tpre.demo_topology(), tcfg, store=store)
        jctl = J.ReplanController(jpre.demo_net(), jpre.demo_topology(), jcfg, store=jstore)
        keys, jkeys = tpre.lattice_keys(ctl, links, computes), jpre.lattice_keys(jctl, links, computes)
        same(keys, jkeys)
        for key, jkey in zip(keys, jkeys):
            same(ctl.prime(key).plan, jctl.prime(jkey).plan)
        assert ctl.optimizer_calls == 0 and jctl.optimizer_calls == 0


def test_check_benchmarks_equals_jax_less_the_tile_checks():
    rep, jrep = tcheck.check_benchmarks(), jcheck.check_benchmarks()
    assert rep.ok and jrep.ok and rep.findings == [] and jrep.findings == []
    # one check fewer per accepted K2 geometry of >= 2 output rows, over the
    # plans whose kernels the pass probes (the two halo plans, and the halo
    # segments of the two scheme plans)
    topo = tpre.demo_topology()
    plans = [T.plan_halp_topology(net, topo) for net in (tpre.demo_net(), T.vgg16_geom())]
    for net in (T.vgg16_geom(), T.vit_l16_geom()):
        sp = T.plan_scheme(net, topo)
        plans += [sub for seg, sub in zip(sp.segments, sp.halo_plans)
                  if seg.scheme == T.SCHEME_HALO and sub is not None]
    tiles = sum(1 for p in plans for shapes in plan_kernel_calls(p).values()
                if shapes is not None and shapes["out"][1] >= 2)
    assert tiles > 0 and rep.checks == jrep.checks - tiles


def test_check_store_and_keying_equal_jax(tmp_path):
    tpath, jpath = str(tmp_path / "t.sqlite"), str(tmp_path / "j.sqlite")
    tpre.precompute(tpath, [-1, 0], [0])
    jpre.precompute(jpath, [-1, 0], [0])
    rep, jrep = tcheck.check_store(tpath), jcheck.check_store(jpath)
    assert rep.ok and jrep.ok and rep.checks == jrep.checks > 2
    missing = tcheck.check_store(str(tmp_path / "none.sqlite"))
    assert [(f.check, f.detail) for f in missing.findings] == [
        (f.check, f.detail) for f in jcheck.check_store(str(tmp_path / "none.sqlite")).findings]
    # a row the JAX tool wrote names repro.core classes: a finding, not an import
    foreign = tcheck.check_store(jpath)
    assert len(foreign.findings) == 2 and all(f.check == "store.payload" and "ForeignPayload" in f.detail
                                              for f in foreign.findings)
    assert tcheck.check_keying().ok and tcheck.check_keying().checks == jcheck.check_keying().checks


def test_the_clis_run_to_their_ends(tmp_path, capsys):
    """``precompute_plans_torch --smoke`` fills the store; a restarted
    controller serves every lattice point of both lattices from it with 0
    optimizer calls; ``check_torch --store <it> --benchmarks`` exits 0, and
    with a corrupted row exits 1 naming it."""
    path = str(tmp_path / "plans.sqlite")
    out = tpre.main(["--store", path, "--smoke"])
    assert out["base"]["lattice_points"] == 9 and out["scheme"]["lattice_points"] == 3
    assert out["scheme"]["store_entries"] == 12
    printed = capsys.readouterr().out.splitlines()
    assert [line.split(": ", 1)[1].split(" (")[0] for line in printed] == [
        "9 lattice points, 9 optimised, 0 already stored, 9 entries total",
        "3 lattice points, 3 optimised, 0 already stored, 12 entries total"]
    with T.PlanStore(path) as store:
        for config, computes in ((tpre.demo_config(), SMOKE[1]), (tpre.demo_scheme_config(), [0])):
            ctl = T.ReplanController(tpre.demo_net(), tpre.demo_topology(), config, store=store)
            keys = tpre.lattice_keys(ctl, SMOKE[0], computes)
            for key in keys:
                assert ctl.prime(key).plan is not None
            assert ctl.optimizer_calls == 0 and ctl.cache.store_hits == len(keys)
    assert tcheck.main(["--store", path, "--benchmarks"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("keying: ok (") and lines[1].startswith(f"store {path}: ok (")
    assert lines[2].startswith("benchmarks: ok (") and lines[3].startswith("total: 0 finding(s) in ")
    conn = sqlite3.connect(path)
    conn.execute("UPDATE plans SET payload = ? WHERE rowid = 1", (b"not a pickle",))
    conn.commit()
    conn.close()
    assert tcheck.main(["--store", path]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].startswith(f"store {path}: 1 finding(s) (")
    assert lines[2].startswith("  [store.payload] ") and "payload failed to deserialize" in lines[2]
    assert lines[3].startswith("total: 1 finding(s) in ")
