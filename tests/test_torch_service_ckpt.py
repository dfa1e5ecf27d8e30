"""Epoch-boundary checkpoints of the port's control plane
(``run_controlled(checkpoint=...)``) against the reference's, on the
reference test's run: mesh2d(3,3), 2 000 cycles, a link failure at 700
and a traffic drift at 1 200 under the oracle policy.

* at every boundary the port's snapshot is the reference's: the same
  keys, the integer arrays (the simulator state ``s_*`` among them)
  exact, the floats within rtol 1e-5 (the N-Rank fixed point ``nr_*``
  differs by the port's fp64 W sums), the same meta;
* resuming from a mid-run snapshot, the last one or the npz on disk
  ends exactly as the uninterrupted run, the watchdog's and the
  telemetry rings' state included;
* the port resumes a snapshot the reference took
  (:func:`repro_torch.convert.ctrl_snapshot`) and ends as the reference.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
import repro.noc as jnoc  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.noc import (Algo, CellCheckpoint, LinkFail,  # noqa: E402
                             ReplanConfig, Scenario, SimConfig,
                             TrafficDrift, run_controlled)
from repro_torch.noc import sim  # noqa: E402

LINK01 = ((0, 1), (1, 0))
RUN = dict(rates=[0.1, 0.3], seeds=[0])
SCALARS = ("injected_flits", "ejected_flits", "in_flight_flits",
           "reorder_value", "meas_cycles", "saturated", "avg_latency",
           "max_latency", "throughput", "offered", "lcv", "p50_latency",
           "p90_latency", "p99_latency", "link_load_max")


class Rec:
    """In-memory checkpointer: keeps every snapshot, and gives back the
    one it was preloaded with."""

    def __init__(self, preload=None):
        self.snaps = []
        self.preload = preload

    def save(self, arrays, meta):
        self.snaps.append(({k: np.array(v) for k, v in arrays.items()},
                           json.loads(json.dumps(meta))))

    def load(self):
        return self.preload


def _scenario(noc, drift):
    return noc.Scenario("dyn", events=(noc.LinkFail(700, LINK01),
                                       noc.TrafficDrift(1200, drift)),
                        policy="oracle",
                        replan=noc.ReplanConfig(epoch=400))


@pytest.fixture(scope="module")
def ref_run():
    """The reference's run, recorded, and its plan."""
    topo = jcore.mesh2d(3, 3)
    tm = jcore.traffic.uniform(topo)
    cfg = jnoc.SimConfig(algo=jnoc.Algo.BIDOR, cycles=2000, warmup=400,
                         drain=200)
    rec = Rec()
    with reference():
        plan = jcore.build_plan(topo, tm)
        res = jnoc.run_controlled(
            topo, tm, cfg, _scenario(jnoc, jcore.traffic.tornado(topo)),
            checkpoint=rec, bidor_table=plan.table, **RUN)
    return plan, res, rec.snaps


def _port(plan, checkpoint=None, **cfg_kw):
    topo = tcore.mesh2d(3, 3)
    cfg = SimConfig(algo=Algo.BIDOR, cycles=2000, warmup=400, drain=200,
                    **cfg_kw)
    table = convert.plan_from_numpy(plan.table.choice,
                                    plan.table.port_tables)
    return run_controlled(
        topo, tcore.traffic.uniform(topo), cfg,
        Scenario("dyn", events=(LinkFail(700, LINK01),
                                TrafficDrift(1200,
                                             tcore.traffic.tornado(topo))),
                 policy="oracle", replan=ReplanConfig(epoch=400)),
        checkpoint=checkpoint, bidor_table=table, device="cpu", **RUN)


@pytest.fixture(scope="module")
def port_run(ref_run):
    rec = Rec()
    res = _port(ref_run[0], checkpoint=rec)
    return res, rec.snaps


def _same(a, b, exact_replans=True):
    """Two controlled results end alike: boundaries, replans, link peaks
    and every lane statistic."""
    assert a.epoch_bounds == b.epoch_bounds
    key = (lambda r: dataclasses.astuple(r)) if exact_replans else (
        lambda r: (r.cycle, r.trigger, r.iterations, r.unroutable_pairs))
    assert [key(r) for r in a.replans] == [key(r) for r in b.replans]
    assert np.array_equal(a.link_peak, b.link_peak)
    for x, y in zip(a.results, b.results):
        for f in SCALARS:
            assert getattr(x, f) == getattr(y, f), f
        assert np.array_equal(x.node_load, y.node_load)


def test_snapshots_match_reference_at_every_boundary(ref_run, port_run):
    _, want_res, want = ref_run
    got_res, got = port_run
    assert len(got) == len(want) >= 3
    assert got_res.replans and len(got_res.replans) == len(want_res.replans)
    for (ga, gm), (wa, wm) in zip(got, want):
        gm, wm = copy.deepcopy(gm), copy.deepcopy(wm)
        assert set(ga) == set(wa)
        for k, w in wa.items():
            g = ga[k]
            assert g.shape == w.shape, k
            if np.issubdtype(w.dtype, np.floating):
                assert g.dtype == w.dtype, k
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=k)
            else:
                assert np.array_equal(g.astype(w.dtype), w), k
        # the port's own timing of each replan rides in its meta
        assert len(gm.pop("replan_ms")) == len(gm["replans"])
        assert len(gm["replans"]) == len(wm["replans"])
        for r, s in zip(gm.pop("replans"), wm.pop("replans")):
            assert r.pop("drift_distance") == pytest.approx(
                s.pop("drift_distance"), rel=1e-12)
            assert r == s
        assert gm == wm


def test_snapshot_state_is_exact(ref_run, port_run):
    """The simulator state of every snapshot, bit for bit, the PRNG keys
    and the reorder bits (uint32) included."""
    for (ga, _), (wa, _) in zip(port_run[1], ref_run[2]):
        for k, w in wa.items():
            if k.startswith("s_"):
                assert ga[k].dtype == w.dtype, k
                assert np.array_equal(ga[k], w), k


def test_recording_does_not_perturb_the_run(ref_run, port_run):
    _same(_port(ref_run[0]), port_run[0])


@pytest.mark.parametrize("which", ["mid", "last", "disk"])
def test_resume_is_bit_identical(tmp_path, ref_run, port_run, which):
    base, snaps = port_run
    snap = snaps[-1] if which == "last" else snaps[1]
    if which == "disk":
        ck = CellCheckpoint(str(tmp_path / "snap.npz"))
        ck.save(*snap)
        _same(_port(ref_run[0], checkpoint=ck), base)
        ck.clear()
        assert ck.load() is None
        return
    _same(_port(ref_run[0], checkpoint=Rec(snap)), base)


def test_resume_keeps_the_watchdog_and_the_rings(ref_run):
    """With the watchdog and the telemetry on, their state rides in the
    snapshot: a resumed run ends with the same rings and report."""
    kw = dict(watchdog=True, telemetry=True, tel_slots=8)
    rec = Rec()
    base = _port(ref_run[0], checkpoint=rec, **kw)
    assert {"s_wd_stall", "s_wd_trips", "s_tel_chan",
            "s_tel_lat"} <= set(rec.snaps[2][0])
    got = _port(ref_run[0], checkpoint=Rec(rec.snaps[2]), **kw)
    _same(got, base)
    for f in ("chan", "counts", "cycles", "lat", "qocc", "bw"):
        assert np.array_equal(getattr(got.telemetry, f),
                              getattr(base.telemetry, f)), f
    assert got.watchdog == base.watchdog


def test_state_round_trip_through_the_host():
    """``sim.state_from_host`` inverts ``state_to_host`` key for key."""
    topo = tcore.mesh2d(3, 3)
    cfg = SimConfig(cycles=300, warmup=50, watchdog=True, telemetry=True)
    tables, meta = sim.build_tables(topo, tcore.traffic.uniform(topo), None,
                                    2, "cpu", escape=True)
    st = sim.make_states(meta, cfg, [(0.3, 0), (0.5, 1)], "cpu")
    sim.run_cycles(tables, meta, cfg, st, 120)
    st["rbits"][0, 0, 1] = -2 ** 31          # the top bit of a window
    host = sim.state_to_host(st)
    back = sim.state_from_host(host, "cpu")
    assert set(back) == set(st)
    assert host["rbits"].dtype == np.uint32
    assert host["rbits"][0, 0, 1] == 2 ** 31
    for k, v in st.items():
        if k == "key":
            assert back[k].dtype == np.uint32
            assert np.array_equal(back[k], v)
        else:
            assert back[k].dtype == v.dtype and bool((back[k] == v).all()), k


def test_port_resumes_a_reference_snapshot(ref_run):
    """A snapshot the reference saved after its fault replan, carried
    across by ``convert.ctrl_snapshot``: the port finishes the run as the
    reference did."""
    plan, want, snaps = ref_run
    arrays, meta = convert.ctrl_snapshot(*snaps[2])
    assert meta["bound_i"] == 3 and meta["replans"]
    assert np.isnan(meta["replan_ms"]).all()
    got = _port(plan, checkpoint=Rec((arrays, meta)))
    _same(got, want, exact_replans=False)
    assert got.epoch_bounds == want.epoch_bounds
