"""The stall watchdog on the port (``repro_torch.noc.watchdog`` and the
twin's escape, stall ages, trips and livelock throttle), against the
reference's outputs on the CPU — the counterparts of
``tests/test_watchdog.py``:

* off, the state carries no ``wd_*`` key; on a healthy network it never
  fires, and the state minus its ``wd_*`` keys is the watchdog-off state;
* the port's state equals the reference's with the watchdog on, its own
  arrays included, from fresh and mid-flight states, in one tile and in
  several (the livelock throttle's set crosses tiles);
* the cyclic 2x2 ring trips the deadlock counter and drains through the
  escape lane; a tight hop limit trips the livelock counter; every run
  equal to the reference's, kept in ``tests/goldens/zoo.json``;
* the report, and ``run_sweep``'s order of extras.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
from repro.noc import sim as jsim  # noqa: E402
from repro.noc.simconfig import Algo as JAlgo, SimConfig as JCfg  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.noc import sim as tsim  # noqa: E402
from repro_torch.noc.simconfig import Algo, SimConfig  # noqa: E402
from repro_torch.noc.watchdog import WD_KEYS, WatchdogReport  # noqa: E402

# the cyclic ring's runs (the reference's tests/test_watchdog.py): BiDOR
# on the ring table at rate 0.6, without the watchdog, with it, and with
# a hop limit that its escapes' misroutes exceed
WEDGED = dict(cycles=3000, warmup=500, injection_rate=0.6)
WEDGED_RUNS = {
    "baseline": {},
    "watchdog": dict(watchdog=True, wd_stall_cycles=32),
    "livelock": dict(watchdog=True, wd_stall_cycles=32, wd_hop_limit=6,
                     wd_throttle_cycles=64)}
# a watchdog that fires within a short run: stalls escape, runaways
# throttle their sources
TRIGGER = dict(watchdog=True, wd_stall_cycles=8, wd_hop_limit=6,
               wd_throttle_cycles=10)


def ring_table(core):
    """All traffic clockwise around the 2x2 ring 0 → 1 → 3 → 2 → 0 of
    ``core.mesh2d(2, 2)``: a true cyclic channel dependency that wedges
    every VC (``core`` is the reference's or the port's)."""
    topo = core.mesh2d(2, 2)
    n = topo.num_nodes
    ring = [0, 1, 3, 2]
    nxt = {ring[i]: ring[(i + 1) % 4] for i in range(4)}
    neigh = np.asarray(topo.neighbor_table)
    pt = np.zeros((1, n, n), np.int8)
    for cur in range(n):
        for dst in range(n):
            pt[0, cur, dst] = (topo.port_local if cur == dst else
                               [k for k in range(neigh.shape[1])
                                if neigh[cur, k] == nxt[cur]][0])
    return core.BiDORTable(choice=np.zeros((n, n), np.int8),
                           orders=((0, 1),),
                           costs=np.zeros((1, n, n), np.float32),
                           port_tables=pt)


def _assert_states(want: dict, got: dict, ctx: str):
    got = convert.state_to_numpy(got)
    assert sorted(want) == sorted(got), ctx
    bad = [k for k in want if not (
        np.asarray(want[k]).dtype == got[k].dtype
        and np.array_equal(np.asarray(want[k]), got[k]))]
    assert not bad, f"port diverged from the reference on {bad} ({ctx})"


def _results_equal(a, b) -> bool:
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    return all(np.array_equal(da[k], db[k]) for k in da)


@functools.lru_cache(maxsize=None)
def _mesh_cell(algo: Algo, **kw):
    """(reference tables, meta, config; port tables, config) of a 4x4
    uniform cell (BiDOR on the reference's plan, carried across)."""
    topo = jcore.mesh2d(4, 4)
    tm = jcore.traffic.uniform(topo)
    with reference():
        table = (jcore.build_plan_fast(topo, tm).table
                 if algo == Algo.BIDOR else None)
        jt, meta = jsim.build_tables(topo, tm, table, 2)
    ptable = (None if table is None else convert.plan_from_numpy(
        table.choice, table.port_tables))
    tt, _ = tsim.build_tables(tcore.mesh2d(4, 4), tm, ptable, 2,
                              device="cpu")
    jcfg = JCfg(algo=JAlgo(int(algo)), cycles=4000, warmup=50, **kw)
    return jt, meta, jcfg, tt, SimConfig(algo=algo, cycles=4000, warmup=50,
                                         **kw)


def test_watchdog_off_state_carries_no_wd_keys():
    cfg = SimConfig(algo=Algo.XY)
    topo = tcore.mesh2d(4, 4)
    _, meta = tsim.build_tables(topo, tcore.traffic.uniform(topo), None, 2,
                                device="cpu")
    state = tsim.fresh_state(meta, cfg, 2, device="cpu")
    assert not any(k in state for k in WD_KEYS)
    on = tsim.fresh_state(meta, cfg.replace(watchdog=True), 2, device="cpu")
    assert all(k in on for k in WD_KEYS)
    assert on["wd_stall"].shape == (2, meta["NIN"])
    assert on["wd_throttle"].shape == (2, meta["N"])
    assert on["wd_trips"].shape == (2, 2)


def test_healthy_net_equals_the_reference_and_the_watchdog_off():
    """150 cycles of XY at rate 0.45 on a healthy 4x4 mesh: the port's
    watchdog-on state equals the reference's, ``wd_*`` arrays included;
    minus those arrays it equals the watchdog-off state; no trips."""
    jt, meta, jcfg, tt, tcfg = _mesh_cell(Algo.XY, watchdog=True)
    points = [(0.45, 7)]
    with reference():
        want = jax.device_get(jsim.get_runner(meta, jcfg, 150)(
            jt, jsim.make_states(meta, jcfg, points)))
    on = tsim.make_states(meta, tcfg, points, device="cpu")
    tsim.run_cycles(tt, meta, tcfg, on, 150)
    _assert_states(want, on, "healthy, watchdog on")
    off = tsim.make_states(meta, tcfg.replace(watchdog=False), points,
                           device="cpu")
    tsim.run_cycles(tt, meta, tcfg.replace(watchdog=False), off, 150)
    _assert_states({k: v for k, v in convert.state_to_numpy(on).items()
                    if k not in WD_KEYS}, off, "watchdog on vs off")
    wd = WatchdogReport.from_state(convert.state_to_numpy(on), tcfg)
    assert wd is not None and not wd.tripped


def test_healthy_net_results_identical_watchdog_on():
    """``run_sim`` end to end: the same SimResult with the watchdog armed,
    no report when off, a quiet one when on, each the reference's."""
    from repro.noc import run_sim as jrun

    cfg = SimConfig(algo=Algo.XY, cycles=1200, warmup=200,
                    injection_rate=0.3)
    topo = tcore.mesh2d(4, 4)
    tm = tcore.traffic.uniform(topo)
    r_off, wd_off = tsim.run_sim(topo, tm, cfg, return_watchdog=True,
                                 device="cpu")
    r_on, wd_on = tsim.run_sim(topo, tm, cfg.replace(watchdog=True),
                               return_watchdog=True, device="cpu")
    assert wd_off is None
    assert wd_on is not None and not wd_on.tripped
    assert wd_on.max_stall < cfg.wd_stall_cycles
    assert _results_equal(r_off, r_on)
    with reference():
        _, want = jrun(jcore.mesh2d(4, 4), tm,
                       JCfg(algo=JAlgo.XY, cycles=1200, warmup=200,
                            injection_rate=0.3, watchdog=True),
                       return_watchdog=True)
    assert wd_on.trace_args() == want.trace_args()


def test_bidor_plan_table_quiet_under_watchdog():
    """A certified plan table never trips the watchdog."""
    topo = tcore.mesh2d(4, 4)
    tm = tcore.traffic.uniform(topo)
    plan = tcore.build_plan(topo, tm, device="cpu")
    cfg = SimConfig(algo=Algo.BIDOR, cycles=1500, warmup=200,
                    injection_rate=0.35, watchdog=True, wd_stall_cycles=48)
    _, wd = tsim.run_sim(topo, tm, cfg, plan.table, return_watchdog=True,
                         device="cpu")
    assert wd is not None and wd.deadlock_trips == 0


@pytest.mark.parametrize("algo", [Algo.XY, Algo.ODDEVEN, Algo.VALIANT,
                                  Algo.BIDOR])
def test_trigger_happy_watchdog_equals_the_reference(algo):
    """A watchdog that fires (stall threshold 8, hop limit 6): 120 cycles
    from fresh state at rates 1.0 and 0.6, then 60 from the reference's
    mid-flight state in tiles of 4 nodes (the throttle's set and the
    escapes cross tiles): every key bit for bit, trips included."""
    jt, meta, jcfg, tt, tcfg = _mesh_cell(algo, **TRIGGER)
    points = [(1.0, 0), (0.6, 3)]
    with reference():
        mid = dict(jax.device_get(jsim.get_runner(meta, jcfg, 120)(
            jt, jsim.make_states(meta, jcfg, points))))
        want = jax.device_get(jsim.get_runner(meta, jcfg, 60)(
            jt, {k: jax.numpy.asarray(v) for k, v in mid.items()}))
    got = tsim.make_states(meta, tcfg, points, device="cpu")
    tsim.run_cycles(tt, meta, tcfg, got, 120)
    _assert_states(mid, got, f"fresh/{algo.name}")
    assert np.asarray(mid["wd_trips"]).sum() > 0
    got = convert.state_from_numpy(mid, device="cpu")
    tsim.run_cycles(tt, meta, tcfg.replace(sim_tile_nodes=4), got, 60)
    _assert_states(want, got, f"midflight/{algo.name}")


# ------------------------------------------------------------------ #
# true deadlock: detection and escape recovery
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def wedged():
    """The cyclic ring's three runs on the port's plain twin."""
    topo = tcore.mesh2d(2, 2)
    table = ring_table(tcore)
    tm = tcore.traffic.uniform(topo)
    return {label: tsim.run_sim(
        topo, tm, SimConfig(algo=Algo.BIDOR, **WEDGED, **kw), table,
        return_watchdog=True, device="cpu")
        for label, kw in WEDGED_RUNS.items()}


def test_wedged_ring_runs_equal_the_reference(wedged):
    """Each run's result and report, as the reference wrote them into
    ``zoo.json``."""
    from test_torch_zoo import golden, mismatches, record

    want = golden()["wedged"]
    assert want["sim"] == WEDGED and want["algo"] == "BIDOR"
    for label, (r, wd) in wedged.items():
        run = want["runs"][label]
        assert run["sim"] == WEDGED_RUNS[label]
        assert not mismatches({label: run["record"]}, {label: record(r)})
        assert (wd and wd.trace_args()) == run["report"], label


def test_cyclic_table_trips_deadlock_watchdog(wedged):
    (_, wd0), (_, wd1) = wedged["baseline"], wedged["watchdog"]
    assert wd0 is None                      # watchdog off: no report
    assert wd1.deadlock_trips > 0
    # detection is prompt: stall ages stay near the threshold
    assert wd1.max_stall < 4 * WEDGED_RUNS["watchdog"]["wd_stall_cycles"]


def test_escape_recovery_drains_the_ring(wedged):
    (r0, _), (r1, _) = wedged["baseline"], wedged["watchdog"]
    assert r1.ejected_flits > 4 * max(r0.ejected_flits, 1)
    assert r1.injected_flits == r1.ejected_flits + r1.in_flight_flits


def test_livelock_throttle_trips_on_runaway_packets(wedged):
    r, wd = wedged["livelock"]
    assert wd.livelock_trips > 0
    assert r.ejected_flits > 0
    assert r.injected_flits == r.ejected_flits + r.in_flight_flits


# ------------------------------------------------------------------ #
# report plumbing
# ------------------------------------------------------------------ #
def test_report_sums_over_lane_axis():
    cfg = SimConfig(watchdog=True, wd_stall_cycles=8)
    host = {"wd_trips": np.array([[2, 1], [3, 0]], np.int32),
            "wd_stall": np.array([[0, 9], [4, 0]], np.int32),
            "wd_throttle": np.array([[0, 5], [0, 0]], np.int32)}
    wd = WatchdogReport.from_state(host, cfg)
    assert wd == WatchdogReport(deadlock_trips=5, livelock_trips=1,
                                stalled_inputs=1, max_stall=9,
                                throttled_sources=1)
    assert wd.tripped and wd.trace_args()["deadlock_trips"] == 5
    assert WatchdogReport.from_state({}, cfg) is None


def test_run_sweep_appends_watchdog_after_telemetry():
    cfg = SimConfig(algo=Algo.XY, cycles=600, warmup=100, watchdog=True,
                    telemetry=True)
    topo = tcore.mesh2d(4, 4)
    res, tel, wd = tsim.run_sweep(topo, tcore.traffic.uniform(topo), cfg,
                                  [0.2], return_telemetry=True,
                                  return_watchdog=True, device="cpu")
    assert len(res) == 1 and tel is not None
    assert isinstance(wd, WatchdogReport) and not wd.tripped
    r, wd1 = tsim.run_sim(topo, tcore.traffic.uniform(topo),
                          cfg.replace(injection_rate=0.2),
                          return_watchdog=True, device="cpu")
    assert wd1 == wd and _results_equal(r, res[0])


def test_escape_table_built_only_with_the_watchdog(monkeypatch):
    """``build_tables(escape=False)`` leaves the escape table empty, the
    entry points ask for it only with the watchdog on, and the flit step
    refuses a watchdog cell without it."""
    topo = tcore.mesh2d(4, 4)
    tm = tcore.traffic.uniform(topo)
    full, meta = tsim.build_tables(topo, tm, None, 2, device="cpu")
    bare, _ = tsim.build_tables(topo, tm, None, 2, device="cpu",
                                escape=False)
    assert tuple(full.esc_port.shape) == (16, 16)
    assert tuple(bare.esc_port.shape) == (0, 0)
    for f in full._fields:
        if f != "esc_port":
            assert torch.equal(getattr(full, f), getattr(bare, f)), f
    asked = []
    real = tsim.build_tables

    def spy(*args, escape=True, **kw):
        asked.append(escape)
        return real(*args, escape=escape, **kw)

    monkeypatch.setattr(tsim, "build_tables", spy)
    cfg = SimConfig(algo=Algo.XY, cycles=200, warmup=50, injection_rate=0.2)
    tsim.run_sim(topo, tm, cfg, device="cpu")
    tsim.run_sim(topo, tm, cfg.replace(watchdog=True), device="cpu")
    assert asked == [False, True]
    on = cfg.replace(watchdog=True)
    state = tsim.fresh_state(meta, on, 1, device="cpu")
    with pytest.raises(ValueError, match="escape table"):
        tsim.run_cycles(bare, meta, on, state, 10)
