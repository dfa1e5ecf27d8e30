"""The port's control plane (``repro_torch.noc.ctrl``) on the CPU plain
path: the committed ``ctrl_4x4.json`` fixture, the online-beats-stale
property, the hot-swap identity, and the re-planner, estimator, detector
and controlled runs held against the reference's."""

import dataclasses

import numpy as np
import pytest

from test_torch_oracle import golden_mismatches, load_golden, reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
from repro.noc import ctrl as jctrl  # noqa: E402
from repro.noc.simconfig import Algo as JAlgo, SimConfig as JCfg  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.noc import (Algo, CampaignSpec, DriftDetector,  # noqa: E402
                             LinkFail, ReplanConfig, Scenario, SimConfig,
                             TrafficDrift, TrafficEstimator, run_campaign,
                             run_controlled)
from repro_torch.noc import ctrl as tctrl  # noqa: E402
from repro_torch.noc.sim import run_sweep  # noqa: E402

GOLDEN = load_golden("ctrl_4x4.json")
TOPO = tcore.mesh2d(4, 4)
UNI = tcore.traffic.uniform(TOPO)
CFG = SimConfig(algo=Algo.BIDOR, cycles=1600, warmup=400,
                injection_rate=0.35)
FAIL_LINKS = ((5, 6), (6, 5))


def ctrl_spec() -> CampaignSpec:
    """``tests/goldens/regen.py::ctrl_spec`` on the port."""
    fail = (LinkFail(cycle=1200, links=FAIL_LINKS, bw_scale=0.25),)
    rc = ReplanConfig(epoch=400)
    return CampaignSpec(
        topo=TOPO, algos=(Algo.BIDOR,), patterns=("uniform",),
        rates=(0.35,), seeds=(0, 1),
        base=SimConfig(cycles=2400, warmup=400),
        scenarios=(Scenario("linkfail_stale", events=fail, policy="stale",
                            replan=rc),
                   Scenario("linkfail_online", events=fail,
                            policy="online", replan=rc)))


@pytest.fixture(scope="module")
def golden_result():
    return run_campaign(ctrl_spec(), device="cpu")


@pytest.fixture(scope="module")
def computed(golden_result):
    """``regen.compute_ctrl_goldens``'s record of each point."""
    points = {}
    for p in golden_result.points:
        r = p.result
        points[f"{p.scenario}/{p.algo.name}/r{p.rate}/s{p.seed}"] = {
            "injected": r.injected_flits, "ejected": r.ejected_flits,
            "in_flight": r.in_flight_flits, "reorder": r.reorder_value,
            "meas_cycles": r.meas_cycles,
            "throughput": round(r.throughput, 6),
            "avg_latency": round(r.avg_latency, 6),
            "p50_latency": round(r.p50_latency, 6),
            "p99_latency": round(r.p99_latency, 6),
            "link_load_max": round(r.link_load_max, 6),
            "lcv": round(r.lcv, 6)}
    return {"points": points}


def test_ctrl_golden_reproduced(computed):
    assert set(computed["points"]) == set(GOLDEN["points"])
    assert not golden_mismatches(GOLDEN, computed)


def test_online_beats_stale(computed):
    """``tests/test_goldens.py``'s headline property on the port."""
    pts = computed["points"]
    for key, pt in pts.items():
        assert pt["injected"] == pt["ejected"] + pt["in_flight"], key
        assert pt["reorder"] == 0, key
    for seed in (0, 1):
        stale = pts[f"linkfail_stale/BIDOR/r0.35/s{seed}"]
        online = pts[f"linkfail_online/BIDOR/r0.35/s{seed}"]
        assert online["link_load_max"] < stale["link_load_max"], seed
        assert online["throughput"] >= stale["throughput"] * 0.98, seed


def test_scenario_axis_accessors(golden_result):
    res = golden_result
    assert res.scenario_names == ("linkfail_stale", "linkfail_online")
    with pytest.raises(ValueError, match="ambiguous scenario"):
        res.grid("throughput", Algo.BIDOR, "uniform")
    g = res.grid("link_load_max", Algo.BIDOR, "uniform",
                 scenario="linkfail_online")
    assert g.shape == (1, 2)
    for j, seed in enumerate((0, 1)):
        (p,) = res.select(scenario="linkfail_online", seed=seed)
        assert g[0, j] == p.result.link_load_max
    rows = res.to_rows()
    scen_col = res.CSV_HEADER.index("scenario")
    assert sorted({r[scen_col] for r in rows}) == sorted(res.scenario_names)
    assert set(res.wall_clock_s) == {("BIDOR", "uniform", s)
                                     for s in res.scenario_names}
    assert "scenario=linkfail_online" in res.summary()


@pytest.mark.parametrize("algo", [Algo.XY, Algo.BIDOR],
                         ids=lambda a: a.name)
def test_empty_schedule_equals_run_sweep(algo):
    """The chunked, hot-swapping loop with no events equals the single
    sweep exactly: every SimResult field and the node loads."""
    cfg = CFG.replace(algo=algo)
    table = (tcore.build_plan_fast(TOPO, UNI, device="cpu").table
             if algo == Algo.BIDOR else None)
    ctrl = run_controlled(TOPO, UNI, cfg,
                          Scenario("empty", replan=ReplanConfig(epoch=300)),
                          rates=[0.2, 0.5], seeds=[3], bidor_table=table,
                          device="cpu")
    ref = run_sweep(TOPO, UNI, cfg, [0.2, 0.5], table, seeds=[3],
                    device="cpu")
    assert not ctrl.replans
    assert ctrl.epoch_bounds[0] == (0, 300)
    assert ctrl.epoch_bounds[-1] == (1500, 1600)
    for a, b in zip(ctrl.results, ref):
        for f in ("throughput", "offered", "avg_latency", "max_latency",
                  "lcv", "reorder_value", "ejected_flits", "injected_flits",
                  "in_flight_flits", "meas_cycles", "p50_latency",
                  "p99_latency", "link_load_max"):
            assert getattr(a, f) == getattr(b, f), f
        assert np.array_equal(a.node_load, b.node_load)


@pytest.mark.parametrize("use_fast", [True, False])
def test_replan_matches_reference(use_fast):
    """A degraded 4x4 (one link at bw 0.25, one dead), warm-started from
    the reference's own fixed point carried across."""
    jt = jcore.mesh2d(4, 4)
    t = jcore.traffic.tornado(jt)
    bw = jt.channel_bw.copy()
    bw[jt.channel_index(5, 6)] = 0.25
    bw[jt.channel_index(9, 10)] = 0.0
    with reference():
        prev = jcore.build_plan_fast(jt, t).nrank
        want_tab, want_nr = jctrl.replan(jt, t, bw, prev, use_fast=use_fast)
    got_tab, got_nr = tctrl.replan(TOPO, t, bw, convert.nrank_result(prev),
                                   use_fast=use_fast, device="cpu")
    assert np.array_equal(got_tab.choice, want_tab.choice)
    assert np.array_equal(got_tab.unroutable, want_tab.unroutable)
    assert got_tab.unroutable.any()
    assert got_nr.iterations == want_nr.iterations


def test_estimator_and_detector_match_reference():
    rng = np.random.default_rng(5)
    n = 6
    seqs = [rng.integers(0, 50, (n, n)) * (rng.random() < 0.8)
            for _ in range(12)]
    chans = [rng.integers(0, 30, 20) * (k % 5 != 3) for k in range(12)]
    prior = rng.random((n, n))
    j_est, t_est = (jctrl.TrafficEstimator(n, ema=0.3, prior=prior),
                    TrafficEstimator(n, ema=0.3, prior=prior))
    j_det, t_det = jctrl.DriftDetector(0.2), DriftDetector(0.2)
    for k, (sq, ch) in enumerate(zip(seqs, chans)):
        assert np.array_equal(j_est.matrix, t_est.matrix)
        j_est.update(sq)
        t_est.update(sq)
        assert j_det.update(ch) == t_det.update(ch)
        assert j_det.last_distance == t_det.last_distance
        if k == 6:
            j_det.reset()
            t_det.reset()
    assert np.array_equal(j_est.matrix, t_est.matrix)
    assert TrafficEstimator(n).matrix is None


def _jscen(name, events, policy, **rc):
    return jctrl.Scenario(name, events=events, policy=policy,
                          replan=jctrl.ReplanConfig(**rc))


CONTROLLED = {
    "drift_online": lambda t: _jscen(
        "d", (jctrl.TrafficDrift(cycle=800, traffic=t),), "online",
        epoch=400, drift_threshold=0.15),
    "failrecover_oracle": lambda t: _jscen(
        "fr", (jctrl.LinkFail(cycle=800, links=FAIL_LINKS, bw_scale=0.5),
               jctrl.LinkRecover(cycle=1200, links=FAIL_LINKS)), "oracle",
        epoch=400),
    "hard_online": lambda t: _jscen(
        "hard", (jctrl.LinkFail(cycle=800, links=FAIL_LINKS,
                                bw_scale=0.0),), "online", epoch=400),
}


@pytest.mark.parametrize("case", sorted(CONTROLLED))
def test_controlled_run_matches_reference(case):
    """A scenario converted from the reference's: the same replans and
    the same per-lane results, link peak included."""
    jt = jcore.mesh2d(4, 4)
    uni = jcore.traffic.uniform(jt)
    jscen = CONTROLLED[case](jcore.traffic.transpose(jt))
    jcfg = JCfg(algo=JAlgo.BIDOR, cycles=1600, warmup=400)
    with reference():
        plan = jcore.build_plan_fast(jt, uni)
        want = jctrl.run_controlled(jt, uni, jcfg, jscen, rates=[0.35],
                                    seeds=[0, 1], bidor_table=plan.table,
                                    nrank0=plan.nrank)
    got = run_controlled(
        TOPO, uni, SimConfig(algo=Algo.BIDOR, cycles=1600, warmup=400),
        convert.scenario(jscen), rates=[0.35], seeds=[0, 1],
        bidor_table=convert.plan_from_numpy(plan.table.choice,
                                            plan.table.port_tables),
        nrank0=convert.nrank_result(plan.nrank), device="cpu")
    assert got.replans and len(got.replan_ms) == len(got.replans)
    assert [(r.cycle, r.trigger, r.iterations, r.unroutable_pairs)
            for r in got.replans] == [
        (r.cycle, r.trigger, r.iterations, r.unroutable_pairs)
        for r in want.replans]
    np.testing.assert_allclose(got.link_peak, want.link_peak, rtol=1e-12)
    for a, b in zip(got.results, want.results):
        assert (a.injected_flits, a.ejected_flits, a.in_flight_flits,
                a.meas_cycles) == (b.injected_flits, b.ejected_flits,
                                   b.in_flight_flits, b.meas_cycles)
        assert a.saturated == b.saturated
        assert np.isclose(a.avg_latency, b.avg_latency, rtol=1e-12)


def test_hard_failure_sheds_and_conserves_flits():
    fail = (LinkFail(cycle=800, links=FAIL_LINKS, bw_scale=0.0),)
    res = run_controlled(
        TOPO, UNI, CFG, Scenario("hard", events=fail, policy="online",
                                 replan=ReplanConfig(epoch=400)),
        device="cpu")
    assert res.replans and res.replans[0].unroutable_pairs > 0
    r = res.results[0]
    assert r.injected_flits == r.ejected_flits + r.in_flight_flits
    assert r.ejected_flits > 0


def test_max_shed_guard_keeps_the_previous_table():
    """A replan that sheds more than ``max_shed`` of the demanded pairs
    is rejected: no replan is recorded and the run goes on."""
    fail = (LinkFail(cycle=800, links=FAIL_LINKS, bw_scale=0.0),)
    res = run_controlled(
        TOPO, UNI, CFG,
        Scenario("hard", events=fail, policy="online",
                 replan=ReplanConfig(epoch=400, max_shed=0.0)),
        device="cpu")
    assert not res.replans
    r = res.results[0]
    assert r.injected_flits == r.ejected_flits + r.in_flight_flits


def test_rate_scale_drift_event():
    ev = (TrafficDrift(cycle=800, traffic=UNI, rate_scale=0.0),)
    cfg = CFG.replace(algo=Algo.XY)
    res = run_controlled(TOPO, UNI, cfg,
                         Scenario("off", events=ev, policy="stale",
                                  replan=ReplanConfig(epoch=400)),
                         device="cpu")
    full = run_sweep(TOPO, UNI, cfg, [0.35], device="cpu")[0]
    assert res.results[0].injected_flits < full.injected_flits * 0.6


def test_cold_start_fault_replans_before_any_packet():
    """A fault in the first epoch at rate 0 (no packet observed) replans
    from the estimator's offline prior, and the table certifies."""
    fail = (LinkFail(cycle=1, links=FAIL_LINKS, bw_scale=0.25),)
    out = run_controlled(
        TOPO, UNI, CFG.replace(cycles=1200, warmup=100),
        Scenario("cold", events=fail, policy="online",
                 replan=ReplanConfig(epoch=400)),
        rates=[0.0], device="cpu")
    assert out.replans and out.replans[0].trigger == "fault"
    assert out.replans[0].cycle <= 400
    assert out.replans[0].unroutable_pairs == 0


def test_scenario_validation_and_conversion():
    with pytest.raises(ValueError):
        Scenario("bad", events=(LinkFail(cycle=100, links=FAIL_LINKS),
                                LinkFail(cycle=50, links=FAIL_LINKS)))
    with pytest.raises(ValueError):
        Scenario("bad", policy="psychic")
    with pytest.raises(ValueError):
        Scenario("bad", events=(LinkFail(cycle=0, links=FAIL_LINKS),))
    jscen = _jscen("x", (jctrl.LinkFail(cycle=5, links=FAIL_LINKS),
                         jctrl.TrafficDrift(cycle=9, traffic=np.eye(3),
                                            rate_scale=0.5)),
                   "oracle", epoch=77, max_shed=0.25)
    got = convert.scenario(jscen)
    assert got.policy == "oracle" and got.replan.epoch == 77
    assert got.replan.max_shed == 0.25
    assert isinstance(got.events[0], LinkFail)
    assert got.events[1].rate_scale == 0.5


@pytest.mark.parametrize("what", ["checkpoint", "tracer", "multi_device"])
def test_unported_control_options_raise(what, tmp_path):
    """The control plane's options that came after slice 2 run and leave
    the results as they are: the epoch-boundary checkpoint, the trace
    writer, and the lane split over devices (two lanes, each on a CPU
    device of its own, equal to the unsplit run)."""
    cfg = CFG.replace(algo=Algo.XY, cycles=600, warmup=200)
    scen = Scenario("f", events=(LinkFail(cycle=300, links=FAIL_LINKS,
                                          bw_scale=0.5),),
                    replan=ReplanConfig(epoch=200))
    if what == "multi_device":
        kw = dict(rates=[0.2, 0.4])
        plain = run_controlled(TOPO, UNI, cfg, scen, device="cpu", **kw)
        got = run_controlled(TOPO, UNI, cfg, scen, device=("cpu", "cpu"),
                             multi_device=True, **kw)
        for a, b in zip(got.results, plain.results):
            assert np.array_equal(a.node_load, b.node_load)
            assert dataclasses.replace(a, node_load=0) == \
                dataclasses.replace(b, node_load=0)
        assert got.epoch_bounds == plain.epoch_bounds
        assert np.array_equal(got.link_peak, plain.link_peak)
        return
    from repro_torch.noc import CellCheckpoint
    from repro_torch.obs import TraceWriter, read_trace

    plain = run_controlled(TOPO, UNI, cfg, scen, device="cpu")
    if what == "checkpoint":
        ck = CellCheckpoint(str(tmp_path / "ck.npz"))
        got = run_controlled(TOPO, UNI, cfg, scen, device="cpu",
                             checkpoint=ck)
        arrays, meta = ck.load()           # the last boundary's snapshot
        assert meta["bound_i"] == len(got.epoch_bounds) - 1
        resumed = run_controlled(TOPO, UNI, cfg, scen, device="cpu",
                                 checkpoint=ck)
        assert resumed.epoch_bounds == plain.epoch_bounds
        assert resumed.results[0].ejected_flits == \
            plain.results[0].ejected_flits
    else:
        path = str(tmp_path / "trace.jsonl")
        got = run_controlled(TOPO, UNI, cfg, scen, device="cpu",
                             tracer=TraceWriter(path))
        names = [e["name"] for e in read_trace(path)]
        assert names.count("epoch") == len(got.epoch_bounds)
        assert "LinkFail" in names
    assert got.epoch_bounds == plain.epoch_bounds
    assert np.array_equal(got.link_peak, plain.link_peak)
    assert got.results[0].ejected_flits == plain.results[0].ejected_flits
    assert got.results[0].avg_latency == plain.results[0].avg_latency
