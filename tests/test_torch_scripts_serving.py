"""The serving examples' twins (``examples/quickstart_torch.py``,
``serve_halp_torch.py``, ``replan_channel_torch.py``) on the CPU.

Their host sections are held ``==`` to the JAX package's functions at the
scripts' own constants: quickstart's receptive-field chain, HALP partition,
latency table and reliability (sections 1, 2, 4, 5), and replan_channel's
channel replay and cache counters (sections 1-2).  Each twin then runs to
its end through ``main(["--device", "cpu", ...])`` at its default small
configuration: its forwards are held to the single-device forward, and its
printed lines are the JAX script's.  The JAX scripts themselves are not
run (the JAX quickstart compiles for ~30 s).
"""
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "examples"))

import quickstart_torch  # noqa: E402
import replan_channel_torch  # noqa: E402
import repro.core as J  # noqa: E402
import serve_halp_torch  # noqa: E402
from repro.models import vgg as jvgg  # noqa: E402
from repro_torch.models import vgg  # noqa: E402
from test_torch_engines import same  # noqa: E402

torch.set_num_threads(2)


def jax_quickstart_sections() -> dict:
    """examples/quickstart.py's sections 1, 2, 4 and 5, by the JAX package."""
    net = J.vgg16_geom()
    states = J.rf_chain(net.in_rows, net.layers)
    picked = list(zip(net.layers, states))[:4] + [(net.layers[-1], states[-1])]
    plan = J.plan_halp(net, overlap_rows=4)
    p0 = plan.parts[0]
    latency = []
    for plat in (J.GTX_1080TI, J.AGX_XAVIER):
        t_pre = J.standalone_time(net, plat)
        for rate in (40e9, 100e9):
            latency.append(dict(platform=plat.name, rate=rate, standalone=t_pre,
                                halp=J.simulate_halp(net, plat, J.Link(rate), n_tasks=4)["total"],
                                modnn=J.simulate_modnn(net, plat, J.Link(rate), 9)["total"]))
    ch = J.OffloadChannel(rate_bps=40e6, sigma_s=5e-3)
    return dict(
        receptive_fields=[dict(name=g.name, out=st.out, jump=st.jump, rf=st.rf) for g, st in picked],
        partition=dict(rows=[dict(es=es, lo=p0.out[es].lo, hi=p0.out[es].hi, rows=p0.out[es].rows)
                             for es in plan.es_names], message_bytes=plan.message_bytes(3, "e0", "e1")),
        latency=latency,
        reliability=[(name, J.service_reliability(ch, t, 4.0 / 30.0))
                     for name, t in (("standalone", 32.43e-3), ("HALP", 17.77e-3))])


def test_quickstart_equals_jax_and_runs_on_the_cpu(capsys):
    out = quickstart_torch.main(["--device", "cpu"])
    want = jax_quickstart_sections()
    for section in ("receptive_fields", "partition", "latency", "reliability"):
        same(out[section], want[section], section)
    assert out["device"] == "cpu" and out["lossless"]["shape"] == [1, 2, 2, 64]
    assert out["lossless"]["max_abs_err"] <= 2e-5 * (1 + out["lossless"]["ref_max_abs"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "== receptive-field chain (VGG-16) =="
    assert lines[1] == "  conv1_1    out= 224 jump=  1 rf=   3"
    assert "== losslessness: distributed == single-device forward  OK ==" in lines
    assert f"  host->e1 message after conv2_1: {want['partition']['message_bytes']:,.0f} bytes" in lines
    assert f"  HALP      : {want['reliability'][1][1]:.6f}" in lines
    assert lines[-1] == "quickstart complete." and len(lines) == 26


def test_quickstart_losslessness_raises_on_a_wrong_plan(monkeypatch):
    """Section 3's check is live: a run_plan that drops a row's contribution fails it."""
    real = quickstart_torch.run_plan

    def wrong(plan, params, apply_layer, x):
        y = real(plan, params, apply_layer, x)
        y[:, 0] += 1e-3
        return y

    monkeypatch.setattr(quickstart_torch, "run_plan", wrong)
    with pytest.raises(AssertionError, match="single-device"):
        quickstart_torch.losslessness(quickstart_torch.DEMO, torch.device("cpu"))


@pytest.mark.parametrize("mod", [quickstart_torch, serve_halp_torch, replan_channel_torch],
                         ids=lambda m: m.__name__)
def test_the_twins_run_on_the_card_by_default(mod, monkeypatch):
    """``--device`` defaults to cuda: without a card the twin raises
    (``resolve_device``) and does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([] if mod is not serve_halp_torch else ["--requests", "1"])


def test_serve_halp_serves_on_the_cpu(capsys):
    out = serve_halp_torch.main(["--requests", "10", "--device", "cpu"])
    cfg = out["cfg"]
    assert cfg == vgg.SMOKE and list(out["curve_s"]) == [1, 2, 4, 8]
    assert 1 <= out["max_batch"] <= 8
    stats = out["stats"]
    assert stats["completed"] == 10 and stats["deadline_met_frac"] == 1.0
    # the engine serves class ids; the plan's logits are recomputed to hold
    # them to the single-device forward, and each served class must be one
    # whose single-device logit is within that tolerance of the row's largest
    images, params, classes = out["images"], out["params"], out["classes"]
    single = vgg.apply(params, cfg, images)
    logits = vgg.head(params, serve_halp_torch.run_plan(out["plan"], params["features"], vgg.apply_layer, images))
    tol = 2e-5 * (1 + single.abs())
    assert images.shape == (10, 64, 64, 3) and classes.shape == (10,)
    assert bool(((logits - single).abs() <= tol).all())
    picked = single.gather(1, classes[:, None])[:, 0]
    assert bool((picked >= single.max(dim=-1).values - 2 * tol.max(dim=-1).values).all())
    assert set(out["es_rates"]) == set(out["plan"].es_names) and all(r > 0 for r in out["es_rates"].values())
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("latency curve: {1: '")
    assert lines[1] == f"reliability-chosen max_batch = {out['max_batch']}"
    assert lines[2].startswith("served 10 requests in ") and "deadline met: 100.0%, p99 " in lines[2]
    assert lines[3].startswith("measured per-ES compute (auto-attributed): {'e1': '") and len(lines) == 4


def jax_channel_replay() -> dict:
    """examples/replan_channel.py's sections 1-2, by the JAX package."""
    net = jvgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10).geom()
    topo = J.CollabTopology(host="e0", secondaries=("a", "b"),
                            platforms={"e0": J.AGX_XAVIER, "a": J.AGX_XAVIER, "b": J.AGX_XAVIER},
                            default_link=J.Link(120e6))
    cfg = J.ReplanConfig(n_tasks=4)
    trace_b = J.GaussMarkovTrace(lo=30e6, hi=120e6, mean=50e6, corr=0.9, sigma_frac=0.1, start=120e6,
                                 seed=5).rates(36)
    link_rates = {("e0", "b"): trace_b, ("b", "e0"): trace_b}
    static_run = J.replay_rate_trace(net, topo, J.StaticPlanner(J.optimize_static(net, topo, cfg).plan),
                                     link_rates, n_tasks=4)
    controller = J.ReplanController(net, topo, cfg)
    adaptive_run = J.replay_rate_trace(net, topo, controller, link_rates, n_tasks=4)

    def b_share(plan):
        rows = plan.parts[0].out
        return rows["b"].rows / sum(seg.rows for seg in rows.values())

    rows = [dict(epoch=a["epoch"], rate_b=s["rates"][("e0", "b")], static=s["makespan"],
                 adaptive=a["makespan"], b_share=b_share(a["plan"]))
            for s, a in zip(static_run, adaptive_run) if not a["epoch"] % 4]
    return dict(rows=rows, static_mean=sum(r["makespan"] for r in static_run) / len(static_run),
                adaptive_mean=sum(r["makespan"] for r in adaptive_run) / len(adaptive_run),
                stats=controller.stats())


def test_replan_channel_equals_jax_and_runs_on_the_cpu(capsys):
    want = jax_channel_replay()
    out = replan_channel_torch.main(["--device", "cpu"])
    same(out["replay"], want)
    assert want["stats"]["replans"] > 0 and want["adaptive_mean"] < want["static_mean"]
    # section 3 moves the controller on; its calibration and admission come
    # from measured CPU latencies, so they are checked for shape, not value
    served = out["serving"]
    assert 1 <= served["batch0"] <= 8 and 0 <= served["batch1"] <= 8
    assert served["stats"]["completed"] == replan_channel_torch.N_SERVED and served["classes"].shape == (12,)
    assert out["lossless"]["max_abs_err"] <= 2e-5 * (1 + out["lossless"]["ref_max_abs"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "== channel replay: secondary b drifts 120 -> ~50 Mbps =="
    assert lines[1] == f"{'epoch':>5s} {'b rate':>8s} {'static':>9s} {'adaptive':>9s} {'b share':>8s}"
    r = want["rows"][2]
    assert lines[4] == (f"{r['epoch']:5d} {r['rate_b']/1e6:6.0f}Mb {r['static']*1e3:7.2f}ms "
                        f"{r['adaptive']*1e3:7.2f}ms {r['b_share']*100:7.1f}%")
    st = want["stats"]
    assert (f"== plan cache == {st['epochs']} epochs -> {st['replans']} plan switches, {st['optimizer_calls']} "
            f"optimizer calls, hit rate {st['cache_hit_rate']:.2f}") in lines
    assert "== losslessness: adaptive plan forward == single-device forward  OK ==" in lines
    assert lines[-1] == "replan_channel complete."


def test_replan_channel_link_scale_scales_every_rate():
    """``link_scale`` (how chip_smoke reaches full-width VGG-16) is the
    ratio of feature bytes a row to the thin model's: 1 for the script's
    own configuration, 28 at full width, and it multiplies the topology's
    links and the trace."""
    assert replan_channel_torch.link_scale(replan_channel_torch.DEMO.geom()) == 1.0
    assert replan_channel_torch.link_scale(vgg.FULL.geom()) == 28.0
    assert replan_channel_torch.topology(28.0).default_link.rate_bps == 28 * 120e6
    replay = replan_channel_torch.channel_replay(vgg.FULL.geom())
    assert replay["rows"][0]["rate_b"] == 28 * 120e6 and replay["rows"][0]["epoch"] == 0
