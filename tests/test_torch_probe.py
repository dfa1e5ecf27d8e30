"""The telemetry probes on the port (``repro_torch.obs.probe`` and the
twin's rings), against the reference's outputs on the CPU — the
counterparts of ``tests/test_obs.py``'s telemetry tests:

* the rings' shapes and the slot length; no ``tel_*`` key when off;
* switching the probes on moves no bit of the core statistics, and the
  rings equal the reference's;
* the rings' invariants, accessors and npz round trip;
* one tile against several (the rings fill in ``finish_fn``);
* the control plane's per-slot bandwidth timeline under a link failure,
  and the online-versus-stale gap read from the rings alone, each equal
  to the reference's;
* a fault-region cell with the watchdog and the telemetry on, against
  the reference's rings in ``tests/goldens/zoo.json``.
"""

import dataclasses
import functools
import os
import tempfile

import numpy as np
import pytest

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.noc import (Algo, LinkFail, ReplanConfig,  # noqa: E402
                             Scenario, SimConfig, run_controlled)
from repro_torch.noc import sim as tsim  # noqa: E402
from repro_torch.obs.probe import (TEL_COUNT_FIELDS, TEL_KEYS,  # noqa: E402
                                   Telemetry, resolved_epoch,
                                   telemetry_state)

TOPO = tcore.mesh2d(3, 3)
UNI = tcore.traffic.uniform(TOPO)
CFG = SimConfig(cycles=400, warmup=100, drain=50, injection_rate=0.2)
SCALAR_FIELDS = ("injected_flits", "ejected_flits", "in_flight_flits",
                 "reorder_value", "meas_cycles", "saturated",
                 "avg_latency", "max_latency", "throughput", "offered",
                 "lcv", "p50_latency", "p90_latency", "p99_latency",
                 "link_load_max")
RINGS = ("chan", "counts", "cycles", "lat", "qocc")
# the golden's telemetry cell: XY on the fault-region mesh (it drives
# packets into the dead region, so the watchdog trips), a 4-slot ring of
# 40 cycles that wraps in the 300-cycle run
TEL_CELL = {"topo": "fault_region_6x6_r2.2.3.3", "algo": "XY",
            "sim": dict(cycles=300, warmup=100, watchdog=True,
                        telemetry=True, tel_epoch=40, tel_slots=4)}


def _jcfg(cfg):
    """The reference's SimConfig with the port config's fields."""
    from repro.noc.simconfig import Algo as JAlgo, SimConfig as JCfg

    kw = dataclasses.asdict(cfg)
    kw["algo"] = JAlgo(int(cfg.algo))
    return JCfg(**kw)


def test_telemetry_state_shapes_and_epoch_resolution():
    cfg = CFG.replace(telemetry=True, tel_slots=8)
    _, meta = tsim.build_tables(TOPO, UNI, None, cfg.num_vcs, device="cpu")
    st = telemetry_state(meta, cfg, 3, "cpu")
    assert set(st) == set(TEL_KEYS)
    assert st["tel_chan"].shape == (3, 8, meta["C"])
    assert st["tel_counts"].shape == (3, 8, len(TEL_COUNT_FIELDS))
    assert st["tel_lat"].shape == (3, 8, cfg.lat_bins)
    assert st["tel_qocc"].shape == (3, 8, cfg.tel_occ_bins)
    # the auto epoch covers the run: ceil(400 / 8) = 50
    assert resolved_epoch(cfg) == 50
    assert resolved_epoch(cfg.replace(tel_epoch=25)) == 25
    assert resolved_epoch(cfg.replace(telemetry=False)) == 0
    off = tsim.fresh_state(meta, CFG, 1, device="cpu")
    assert not any(k in off for k in TEL_KEYS)


@functools.lru_cache(maxsize=None)
def _bidor_plan():
    return tcore.build_plan(TOPO, UNI, device="cpu")


def test_telemetry_off_on_bit_identity_and_the_reference():
    """Switching the probes on moves no bit of the core statistics, and
    the rings equal the reference's."""
    from repro.noc import run_sweep as jsweep

    plan = _bidor_plan()
    cfg = CFG.replace(algo=Algo.BIDOR)
    off = tsim.run_sweep(TOPO, UNI, cfg, [0.1, 0.2], plan.table, seeds=[0],
                         device="cpu")
    on_cfg = cfg.replace(telemetry=True, tel_slots=8)
    on, tel = tsim.run_sweep(TOPO, UNI, on_cfg, [0.1, 0.2], plan.table,
                             seeds=[0], return_telemetry=True, device="cpu")
    for a, b in zip(off, on):
        for f in SCALAR_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert np.array_equal(a.node_load, b.node_load)
    jtable = jcore.BiDORTable(choice=plan.table.choice,
                              orders=plan.table.orders,
                              costs=plan.table.costs,
                              port_tables=plan.table.port_tables)
    with reference():
        _, want = jsweep(jcore.mesh2d(3, 3), UNI, _jcfg(on_cfg), [0.1, 0.2],
                         jtable, seeds=[0], return_telemetry=True)
    for k in RINGS + ("bw",):
        assert np.array_equal(getattr(tel, k), getattr(want, k)), k
    assert tel.epoch_len == want.epoch_len


def test_telemetry_content_invariants_and_accessors():
    cfg = CFG.replace(telemetry=True, tel_slots=8)
    _, tel = tsim.run_sim(TOPO, UNI, cfg, return_telemetry=True,
                          device="cpu")
    assert tel.num_lanes == 1 and tel.num_slots == 8
    assert tel.cycles.sum() == cfg.cycles       # a cycle in one slot
    assert np.array_equal(tel.active_slots(), np.arange(8))
    offered, accepted = tel.count("offered"), tel.count("accepted")
    shed, delivered = tel.count("shed"), tel.count("delivered")
    assert (accepted <= offered).all()
    assert np.array_equal(shed, offered - accepted)
    assert 0 < delivered.sum() <= accepted.sum()
    assert tel.lat.sum() <= delivered.sum()
    assert tel.latency_percentile(0.5).shape == (1, 8)
    occ = tel.occupancy_mean()
    assert ((0 <= occ) & (occ <= 1)).all()
    tel = tel.with_bw(tsim.static_bw_slots(TOPO, cfg))
    peak = tel.peak_link_load()
    assert peak.shape == (1, 8) and np.isfinite(peak).all()
    assert (peak >= 0).all() and peak.max() <= 1.5
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tel.npz")
        tel.save(path)
        back = Telemetry.load(path)
    assert back.epoch_len == tel.epoch_len
    for k in RINGS + ("bw",):
        assert np.array_equal(getattr(back, k), getattr(tel, k)), k


@pytest.mark.parametrize("algo", [Algo.XY, Algo.ODDEVEN])
def test_tiles_carry_the_rings(algo):
    """The rings and the watchdog fill in the epilogue: three tiles of
    three nodes give the one-tile states bit for bit, over a ring that
    wraps (4 slots of 16 cycles, 90 cycles)."""
    cfg = CFG.replace(algo=algo, telemetry=True, tel_slots=4, tel_epoch=16,
                      watchdog=True, wd_stall_cycles=8, wd_hop_limit=6)
    tables, meta = tsim.build_tables(TOPO, UNI, None, 2, device="cpu")
    runs = []
    for tile in (0, 3):
        c = cfg.replace(sim_tile_nodes=tile)
        st = tsim.make_states(meta, c, [(0.9, 0), (0.4, 2)], device="cpu")
        tsim.run_cycles(tables, meta, c, st, 90)
        runs.append(convert.state_to_numpy(st))
    bad = [k for k in runs[0] if not np.array_equal(runs[0][k], runs[1][k])]
    assert not bad, bad
    assert runs[0]["tel_cycles"].sum() == 2 * 90


# ------------------------------------------------------------------ #
# the control plane's bandwidth timeline
# ------------------------------------------------------------------ #
LINK01 = ((0, 1), (1, 0))


@functools.lru_cache(maxsize=None)
def _linkfail_run(policy: str):
    """(port result, reference result) of a link failure at cycle 400
    under BiDOR with a 12-slot ring."""
    from repro.noc import (LinkFail as JFail, ReplanConfig as JRc,
                           Scenario as JScen, run_controlled as jrun)

    cfg = SimConfig(algo=Algo.BIDOR, cycles=1200, warmup=200, drain=200,
                    injection_rate=0.25, telemetry=True, tel_slots=12)
    tm = tcore.traffic.transpose(TOPO)
    plan = tcore.build_plan(TOPO, tm, device="cpu")
    got = run_controlled(
        TOPO, tm, cfg, Scenario("fail", events=(LinkFail(400, LINK01),),
                                policy=policy,
                                replan=ReplanConfig(epoch=200)),
        rates=[0.25], seeds=[0], bidor_table=plan.table,
        nrank0=plan.nrank, device="cpu")
    with reference():
        jtopo = jcore.mesh2d(3, 3)
        jplan = jcore.build_plan(jtopo, tm)
        want = jrun(jtopo, tm, _jcfg(cfg),
                    JScen("fail", events=(JFail(400, LINK01),),
                          policy=policy, replan=JRc(epoch=200)),
                    rates=[0.25], seeds=[0], bidor_table=jplan.table,
                    nrank0=jplan.nrank)
    return got, want


@pytest.mark.parametrize("policy", ["online", "stale"])
def test_run_controlled_bw_timeline_matches_reference(policy):
    """The rings and the per-slot bandwidth: full before the failure,
    the failed link's 0 after it, where its load reads 0; all equal to
    the reference's."""
    got, want = _linkfail_run(policy)
    tel = got.telemetry
    assert tel is not None and tel.bw is not None
    c01 = TOPO.channel_index(0, 1)
    starts = tel.slot_starts()
    assert (tel.bw[starts < 400, c01] > 0).all()
    assert (tel.bw[starts >= 400, c01] == 0).all()
    assert (tel.link_load()[:, starts >= 400, c01] == 0).all()
    for k in RINGS + ("bw",):
        assert np.array_equal(getattr(tel, k), getattr(want.telemetry, k)), k
    assert got.watchdog is None and want.watchdog is None


def test_probes_reproduce_online_vs_stale_gap():
    """From the rings alone: after the replan, the online policy's peak
    link load drops below the stale policy's."""
    stale = _linkfail_run("stale")[0].telemetry
    online = _linkfail_run("online")[0].telemetry
    starts = stale.slot_starts()
    post = [int(s) for s in stale.active_slots() if starts[s] >= 600]
    assert post
    g_stale = float(stale.peak_link_load()[0][post].mean())
    g_online = float(online.peak_link_load()[0][post].mean())
    assert g_online < g_stale, (g_online, g_stale)


# ------------------------------------------------------------------ #
# the golden's telemetry cell
# ------------------------------------------------------------------ #
def test_golden_telemetry_cell():
    """XY on the fault-region mesh with the watchdog and the telemetry on,
    rates 0.2 and 0.5: results, rings and trips as the reference wrote
    them into ``zoo.json``."""
    from test_torch_zoo import RATES, SEEDS, golden, mismatches, pair, \
        record

    cell = golden()["telemetry"]
    assert {k: cell[k] for k in TEL_CELL} == TEL_CELL
    _, topo = pair(cell["topo"])
    res, tel, wd = tsim.run_sweep(
        topo, tcore.traffic.uniform(topo),
        SimConfig(algo=Algo[cell["algo"]], **cell["sim"]), list(RATES),
        None, list(SEEDS), return_telemetry=True, return_watchdog=True,
        device="cpu")
    got = {f"r{r}/s{s}": record(out) for (r, s), out in zip(
        [(r, s) for r in RATES for s in SEEDS], res)}
    assert not mismatches(cell["records"], got)
    for k in RINGS:
        assert getattr(tel, k).tolist() == cell["rings"][k], k
    assert wd.trace_args() == cell["report"] and wd.tripped
