"""The port's chaos schedules (``repro_torch.noc.chaos``) against the
reference's, and the control plane's safety rails under them.

* ``chaos_schedule``, ``chaos_scenarios``, ``region_links`` and
  ``hotspot_traffic`` equal the reference's event for event (seeded
  numpy on both sides), for seeds 0–3 and the reference test's configs;
* the hot-swap guard: a tight ``max_shed`` rejects the emergency table
  of a dark region, a permissive one installs it, a single dead link
  replans normally; each run's replans and flit counts equal the
  reference's;
* two disjoint dark regions shed exactly the pairs no dimension order
  can serve;
* a compact storm through the online policy with the watchdog armed
  equals the reference's run.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
import repro.noc as jnoc  # noqa: E402
from repro.noc.service import _event_desc as j_event_desc  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.noc as tnoc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.bidor import route_feasibility  # noqa: E402
from repro_torch.core.routes import dimension_orders  # noqa: E402
from repro_torch.noc import (ChaosConfig, LinkFail, ReplanConfig,  # noqa: E402
                             Scenario, chaos_scenarios, chaos_schedule,
                             hotspot_traffic, region_links, run_controlled)
from repro_torch.noc.ctrl import replan  # noqa: E402
from repro_torch.noc.service import _event_desc  # noqa: E402

TOPO = tcore.mesh2d(4, 4)
UNI = tcore.traffic.uniform(TOPO)
CFG = tnoc.SimConfig(algo=tnoc.Algo.BIDOR, cycles=1200, warmup=300,
                     injection_rate=0.35)

# the reference test's configs (tests/test_chaos.py), seeds 0-3 besides
CONFIGS = {
    "default": lambda m: m.ChaosConfig(),
    "regions": lambda m: m.ChaosConfig(seed=3, flap_storms=0,
                                       region_failures=2),
    "bursts": lambda m: m.ChaosConfig(seed=4, drift_events=0, flap_bursts=5,
                                      flap_period=90),
    "tight": lambda m: m.ChaosConfig(seed=5, start=100, horizon=700),
    "degrade": lambda m: m.ChaosConfig(seed=6, flap_storms=4,
                                       region_failures=0, drift_events=3,
                                       bw_scale=0.25),
    **{f"seed{s}": (lambda m, s=s: m.ChaosConfig(seed=s)) for s in range(4)},
}


def _events(scen, desc):
    """A schedule as comparable records: the events' fields, the drift
    matrices by value."""
    out = []
    for e in scen.events:
        d = desc(e)
        if hasattr(e, "traffic"):
            d["matrix"] = np.asarray(e.traffic).tolist()
        out.append(d)
    return out


@pytest.mark.parametrize("rc", [None, 400])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_schedule_matches_reference(name, rc):
    jt = jcore.mesh2d(4, 4)
    jrc = None if rc is None else jnoc.ReplanConfig(epoch=rc)
    trc = None if rc is None else ReplanConfig(epoch=rc)
    want = jnoc.chaos_schedule(jt, CONFIGS[name](jnoc), policy="oracle",
                               replan=jrc)
    got = chaos_schedule(TOPO, CONFIGS[name](tnoc), policy="oracle",
                         replan=trc)
    assert got.name == want.name and got.policy == want.policy
    assert _events(got, _event_desc) == _events(want, j_event_desc)
    assert got.replan == trc
    # the reference's scenario carried across is the port's
    assert _events(convert.scenario(want), _event_desc) == _events(
        got, _event_desc)


def test_scenarios_one_per_seed_match_reference():
    base = dict(start=300, horizon=1100, flap_period=100)
    want = jnoc.chaos_scenarios(jcore.mesh2d(4, 4), [0, 1, 2, 3],
                                base=jnoc.ChaosConfig(**base))
    got = chaos_scenarios(TOPO, [0, 1, 2, 3], base=ChaosConfig(**base))
    assert [s.name for s in got] == ["chaos-s0", "chaos-s1", "chaos-s2",
                                     "chaos-s3"]
    for g, w in zip(got, want):
        assert _events(g, _event_desc) == _events(w, j_event_desc)


@pytest.mark.parametrize("center,radius", [(5, 1), (0, 0), (15, 2),
                                           (10, 1)])
def test_region_links_match_reference(center, radius):
    want = jnoc.region_links(jcore.mesh2d(4, 4), center, radius)
    got = region_links(TOPO, center, radius)
    assert got == tuple((int(u), int(v)) for u, v in want)
    for u, v in got:
        assert (v, u) in got


@pytest.mark.parametrize("seed", range(4))
def test_hotspot_traffic_matches_reference(seed):
    want = jnoc.hotspot_traffic(16, np.random.default_rng(seed),
                                hotspots=3, weight=9.0)
    got = hotspot_traffic(16, np.random.default_rng(seed), hotspots=3,
                          weight=9.0)
    assert np.array_equal(got, want)
    assert np.isclose(got.sum(), 1.0) and (np.diag(got) == 0).all()


@pytest.fixture(scope="module")
def plan():
    with reference():
        return jcore.build_plan(jcore.mesh2d(4, 4),
                                jcore.traffic.uniform(jcore.mesh2d(4, 4)))


def _both(plan, scen_of, cfg_kw=None, **run):
    """One scenario through the reference's and the port's control loop
    on the reference's plan: (reference result, port result)."""
    cfg_kw = cfg_kw or {}
    jt = jcore.mesh2d(4, 4)
    jcfg = jnoc.SimConfig(algo=jnoc.Algo.BIDOR, cycles=CFG.cycles,
                          warmup=CFG.warmup, injection_rate=0.35, **cfg_kw)
    with reference():
        want = jnoc.run_controlled(jt, jcore.traffic.uniform(jt), jcfg,
                                   scen_of(jnoc, jt),
                                   bidor_table=plan.table, **run)
    table = convert.plan_from_numpy(plan.table.choice,
                                    plan.table.port_tables)
    got = run_controlled(TOPO, UNI, CFG.replace(**cfg_kw),
                         scen_of(tnoc, TOPO), bidor_table=table,
                         device="cpu", **run)
    assert [dataclasses.astuple(r)[:4] for r in got.replans] == [
        dataclasses.astuple(r)[:4] for r in want.replans]
    for a, b in zip(got.results, want.results):
        assert (a.injected_flits, a.ejected_flits, a.in_flight_flits,
                a.meas_cycles, a.saturated) == (
            b.injected_flits, b.ejected_flits, b.in_flight_flits,
            b.meas_cycles, b.saturated)
        assert a.injected_flits == a.ejected_flits + a.in_flight_flits
        assert a.ejected_flits > 0
    np.testing.assert_allclose(got.link_peak, want.link_peak, rtol=1e-12)
    return want, got


@pytest.mark.parametrize("max_shed", [0.05, 0.95])
def test_hot_swap_guard_matches_reference(plan, max_shed):
    """A radius-1 region goes dark: a tight guard rejects the emergency
    table (no replan, the old table kept), a permissive one installs it."""
    def scen(m, t):
        return m.Scenario(
            "dark", events=(m.LinkFail(cycle=500,
                                       links=m.region_links(t, 5, 1),
                                       bw_scale=0.0),),
            policy="online",
            replan=m.ReplanConfig(epoch=250, max_shed=max_shed))

    _, got = _both(plan, scen)
    if max_shed < 0.5:
        assert got.replans == []
    else:
        assert got.replans and got.replans[0].unroutable_pairs > 0


def test_guard_does_not_block_a_moderate_shed(plan):
    def scen(m, t):
        return m.Scenario(
            "hard", events=(m.LinkFail(cycle=500, links=((5, 6), (6, 5)),
                                       bw_scale=0.0),),
            policy="online", replan=m.ReplanConfig(epoch=250))

    _, got = _both(plan, scen)
    assert got.replans and got.replans[0].unroutable_pairs > 0


def test_two_disjoint_regions_shed_exactly():
    """Two single-node regions at opposite corners: the offline replan's
    unroutable mask is the pairs no dimension order can serve, both dark
    nodes cut off both ways."""
    regions = (region_links(TOPO, 0, 0), region_links(TOPO, 15, 0))
    assert not set(regions[0]) & set(regions[1])
    down = np.array(sorted(TOPO.chan_id[(u, v)]
                           for reg in regions for (u, v) in reg))
    bw = np.asarray(TOPO.channel_bw, np.float64).copy()
    bw[down] = 0.0
    table, _ = replan(TOPO, UNI, bw, None, device="cpu")
    feas = route_feasibility(TOPO, dimension_orders(TOPO.ndim), down)
    expect = ~feas.any(axis=0)
    np.fill_diagonal(expect, False)
    assert np.array_equal(table.unroutable, expect)
    assert expect[0, 1:].all() and expect[1:, 0].all()
    assert expect[15, :15].all() and expect[:15, 15].all()
    res = run_controlled(
        TOPO, UNI, CFG,
        Scenario("2regions", events=tuple(
            LinkFail(cycle=c, links=r, bw_scale=0.0)
            for c, r in zip((400, 800), regions)), policy="oracle",
            replan=ReplanConfig(epoch=400, max_shed=0.9)),
        rates=[0.2], seeds=[0], device="cpu")
    assert [r.cycle for r in res.replans] == [400, 800]
    assert res.replans[-1].unroutable_pairs == int(expect.sum())
    r = res.results[0]
    assert r.injected_flits == r.ejected_flits + r.in_flight_flits


def test_storm_through_the_control_loop_matches_reference(plan):
    """A compact storm (a flap, a drift, a region loss) through the
    online policy with the watchdog armed: the reference's replans and
    counts, and the watchdog reports."""
    def scen(m, t):
        cc = m.ChaosConfig(seed=2, start=300, horizon=1100, flap_storms=1,
                           flap_links=2, flap_bursts=2, flap_period=100,
                           region_failures=1, region_radius=1,
                           drift_events=1)
        return m.chaos_schedule(t, cc, replan=m.ReplanConfig(epoch=200,
                                                             max_shed=0.5))

    want, got = _both(plan, scen, cfg_kw=dict(watchdog=True))
    assert got.watchdog is not None
    assert dataclasses.asdict(got.watchdog) == dataclasses.asdict(
        want.watchdog)
