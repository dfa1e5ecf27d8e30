"""The port's ``run_campaign`` (plain path, CPU) reproduces the committed
4x4 golden campaign, compared as ``tests/test_goldens.py`` compares it:
integer fields exact, float fields within rtol 1e-5."""

import dataclasses

import numpy as np
import pytest

from test_torch_oracle import (FLOAT_FIELDS, INT_FIELDS, golden_mismatches,
                               load_golden)
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

from repro_torch.core import mesh2d, traffic
from repro_torch.noc import (Algo, CampaignSpec, ReplanConfig, Scenario,
                             SimConfig, run_campaign)

GOLDEN = load_golden("campaign_4x4.json")


def golden_spec() -> CampaignSpec:
    """``tests/goldens/regen.py::golden_spec`` on the port."""
    return CampaignSpec(
        topo=mesh2d(4, 4), algos=(Algo.XY, Algo.BIDOR),
        patterns=("uniform", "tornado"), rates=(0.15, 0.5), seeds=(0, 1),
        base=SimConfig(cycles=1000, warmup=300, drain=100))


def campaign_points(res) -> dict:
    """``regen.compute_goldens``'s record of each point."""
    points = {}
    for p in res.points:
        r = p.result
        points[f"{p.pattern}/{p.algo.name}/r{p.rate}/s{p.seed}"] = {
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


@pytest.fixture(scope="module")
def result():
    return run_campaign(golden_spec(), device="cpu")


@pytest.fixture(scope="module")
def computed(result):
    return campaign_points(result)


def test_point_set(computed):
    assert set(computed["points"]) == set(GOLDEN["points"])


@pytest.mark.parametrize("key", sorted(GOLDEN["points"]))
def test_golden_point(computed, key):
    want, got = GOLDEN["points"][key], computed["points"][key]
    for f in INT_FIELDS:
        assert got[f] == want[f], f
    for f in FLOAT_FIELDS:
        assert np.isclose(got[f], want[f], rtol=1e-5, atol=1e-6), f


def test_whole_campaign(computed):
    assert not golden_mismatches(GOLDEN, computed)
    for key, pt in computed["points"].items():
        assert pt["injected"] == pt["ejected"] + pt["in_flight"], key
        assert pt["reorder"] == 0, key


def test_result_accessors(result):
    spec = result.spec
    g = result.grid("injected_flits", Algo.BIDOR, "tornado")
    assert g.shape == (len(spec.rates), len(spec.seeds))
    for i, rate in enumerate(spec.rates):
        for j, seed in enumerate(spec.seeds):
            (p,) = result.select(algo=Algo.BIDOR, pattern="tornado",
                                 rate=rate, seed=seed)
            assert g[i, j] == p.result.injected_flits
    rows = result.to_rows()
    assert len(rows) == 16
    assert all(len(r) == len(result.CSV_HEADER) for r in rows)
    assert set(result.wall_clock_s) == {(a.name, p) for a in spec.algos
                                        for p in spec.patterns}
    assert "16 points" in result.summary()


@pytest.mark.parametrize("algo", list(Algo))
def test_run_sweep_matches_reference(algo):
    """``run_sweep`` (one lane per (rate, seed)) against the reference's,
    SimResult field for field."""
    from test_torch_oracle import reference

    import repro.core as jcore
    from repro.noc import sim as jsim
    from repro.noc.simconfig import Algo as JAlgo, SimConfig as JCfg

    from repro_torch import convert
    from repro_torch.noc import sim as tsim

    jt = jcore.mesh2d(4, 4)
    tm = jcore.traffic.tornado(jt)
    jcfg = JCfg(algo=JAlgo(int(algo)), cycles=500, warmup=100, drain=50)
    with reference():
        table = (jcore.build_plan_fast(jt, tm).table
                 if algo == Algo.BIDOR else None)
        want = jsim.run_sweep(jt, tm, jcfg, [0.2, 0.7], table, seeds=[0, 3])
    ptable = (None if table is None
              else convert.plan_from_numpy(table.choice, table.port_tables))
    got = tsim.run_sweep(mesh2d(4, 4), tm,
                         SimConfig(algo=algo, cycles=500, warmup=100,
                                   drain=50),
                         [0.2, 0.7], ptable, seeds=[0, 3], device="cpu")
    for w, g in zip(want, got):
        for f in ("injection_rate", "throughput", "offered", "avg_latency",
                  "max_latency", "lcv", "reorder_value", "ejected_flits",
                  "injected_flits", "in_flight_flits", "seed",
                  "meas_cycles", "p50_latency", "p99_latency",
                  "link_load_max"):
            assert getattr(w, f) == getattr(g, f), f
        assert np.array_equal(w.node_load, g.node_load)


def test_bidor_tables_match_reference():
    """``run_campaign(bidor_tables=...)`` with host ``build_plan`` tables,
    as the paper-figure benchmarks call it, against the reference."""
    from test_torch_oracle import reference

    import repro.core as jcore
    from repro.noc import (Algo as JAlgo, CampaignSpec as JSpec,
                           SimConfig as JCfg, run_campaign as jrun)

    import repro_torch.core as tcore

    jt = jcore.mesh2d_edge_io(5, 5)
    tm = jcore.traffic.overturn(jt)
    base = dict(patterns=(("overturn", tm),), rates=(0.35,), seeds=(0, 2))
    with reference():
        plan = jcore.build_plan(jt, tm)
        want = jrun(JSpec(topo=jt, algos=(JAlgo.XY, JAlgo.BIDOR),
                          base=JCfg(cycles=600, warmup=200), **base),
                    bidor_tables={"overturn": plan.table.choice})
    tt = tcore.mesh2d_edge_io(5, 5)
    tplan = tcore.build_plan(tt, tm, device="cpu")
    assert np.array_equal(tplan.table.choice, plan.table.choice)
    got = run_campaign(CampaignSpec(topo=tt, algos=(Algo.XY, Algo.BIDOR),
                                    base=SimConfig(cycles=600, warmup=200),
                                    **base),
                       bidor_tables={"overturn": tplan.table.choice},
                       device="cpu")
    assert got.plan_wall_clock_s == 0.0        # no plan was built
    assert len(got.points) == len(want.points) == 4
    for g, w in zip(got.points, want.points):
        assert (g.algo.name, g.seed) == (w.algo.name, w.seed)
        for f in ("injected_flits", "ejected_flits", "in_flight_flits",
                  "meas_cycles", "avg_latency", "link_load_max"):
            assert getattr(g.result, f) == getattr(w.result, f), f
        assert np.array_equal(g.result.node_load, w.result.node_load)


def test_saturation_early_exit():
    """A chunked cell whose lanes all saturate stops early; per-lane
    ``meas_cnt`` keeps the statistics normalised."""
    spec = CampaignSpec(topo=mesh2d(4, 4), algos=(Algo.XY,),
                        patterns=("tornado",), rates=(2.0,), seeds=(0,),
                        base=SimConfig(cycles=1200, warmup=200), chunk=300)
    res = run_campaign(spec, device="cpu")
    r = res.points[0].result
    assert r.saturated and r.meas_cycles < spec.base.measure
    assert r.injected_flits == r.ejected_flits + r.in_flight_flits


def test_oddeven_refuses_a_topology_that_is_not_2d():
    """Odd-even is a 2-D turn model: a campaign on a 3-D torus refuses
    it with the reference's ``ValueError`` before any plan or cycle."""
    from repro_torch.core import torus

    spec = CampaignSpec(topo=torus(3, 3, 3), algos=(Algo.XY, Algo.ODDEVEN),
                        patterns=("uniform",), rates=(0.1,),
                        base=SimConfig(cycles=200, warmup=50))
    with pytest.raises(ValueError, match="2D turn model"):
        run_campaign(spec, device="cpu")


@pytest.mark.parametrize("what", ["telemetry", "watchdog", "scenarios",
                                  "workloads", "topos", "plan_cache"])
def test_unported_options_raise(what, tmp_path):
    """The options ported since the first slice (scenarios, telemetry,
    the watchdog, the topology axis, the plan cache, the ML workloads)
    run; none raises ``NotImplementedError`` any more."""
    topo = mesh2d(4, 4)
    kw = dict(topo=topo, algos=(Algo.XY,), patterns=("uniform",),
              rates=(0.1,), base=SimConfig(cycles=200, warmup=50))
    if what in ("telemetry", "watchdog"):
        # ported: the probes and the watchdog ride as extra state keys
        kw["base"] = kw["base"].replace(**{what: True})
        res = run_campaign(CampaignSpec(**kw), device="cpu")
        r = res.points[0].result
        assert r.injected_flits == r.ejected_flits + r.in_flight_flits
        plain = run_campaign(CampaignSpec(**dict(
            kw, base=kw["base"].replace(**{what: False}))), device="cpu")
        want = dataclasses.asdict(plain.points[0].result)
        got = dataclasses.asdict(r)          # a quiet cell: unchanged
        assert all(np.array_equal(got[k], want[k]) for k in want)
        return
    if what == "topos":
        # ported: the grid runs once per topology of the axis
        kw.update(topo=None, topos=(topo, mesh2d(3, 3)))
        res = run_campaign(CampaignSpec(**kw), device="cpu")
        assert [p.topo for p in res.points] == ["mesh2d_4x4", "mesh2d_3x3"]
        assert set(res.wall_clock_s) == {("mesh2d_4x4", "XY", "uniform"),
                                         ("mesh2d_3x3", "XY", "uniform")}
        return
    if what == "scenarios":
        # ported: a scenario cell runs through the control plane
        kw["scenarios"] = (Scenario("quiet",
                                    replan=ReplanConfig(epoch=100)),)
        res = run_campaign(CampaignSpec(**kw), device="cpu")
        assert [p.scenario for p in res.points] == ["quiet"]
        assert set(res.wall_clock_s) == {("XY", "uniform", "quiet")}
        r = res.points[0].result
        assert r.injected_flits == r.ejected_flits + r.in_flight_flits
        return
    if what == "plan_cache":
        # ported: a second run serves its plan from the cache
        from repro_torch.core.plan_cache import PlanCache

        kw["algos"] = (Algo.BIDOR,)
        cold = PlanCache(str(tmp_path))
        first = run_campaign(CampaignSpec(**kw), device="cpu",
                             plan_cache=cold)
        assert cold.stats.stores == 1 and cold.stats.device_builds == 1
        warm = PlanCache(str(tmp_path))
        again = run_campaign(CampaignSpec(**kw), device="cpu",
                             plan_cache=warm)
        assert warm.stats.hits == 1 and warm.stats.device_builds == 0
        want = dataclasses.asdict(first.points[0].result)
        got = dataclasses.asdict(again.points[0].result)
        assert all(np.array_equal(got[k], want[k]) for k in want)
        return
    # ported: a workload joins the pattern axis after the patterns, its
    # name in the workload column
    kw["workloads"] = (("w", traffic.uniform(topo)),)
    res = run_campaign(CampaignSpec(**kw), device="cpu")
    assert [(p.pattern, p.workload) for p in res.points] == [
        ("uniform", ""), ("w", "w")]
    a, b = (dataclasses.asdict(p.result) for p in res.points)
    assert all(np.array_equal(a[k], b[k]) for k in a)   # the same matrix


def test_entry_point_defaults_to_the_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_campaign(golden_spec())
