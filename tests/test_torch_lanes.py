"""The lane split over devices (``multi_device``) on the CPU.

The reference's ``tests/test_multidevice.py`` on the port: a cell's
(rate, seed) lanes split into contiguous blocks, one a device
(``noc.sim.LaneGroups``), with the CPU named several times where the
reference forces host devices.  Lanes are independent, so every
statistic and every state bit equal the one-device run's:

* 8 lanes over 4 devices, XY and BiDOR (``run_campaign``);
* the chunked run with the saturation early exit;
* the raw state after 200 cycles against ``run_cycles``, every key;
* ``multi_device=True`` with one device, or with lanes that do not
  divide, raises as the reference does; ``None`` splits where the
  lanes divide and keeps one device where they do not;
* ``run_controlled`` with a link failure and online replans, split and
  unsplit; its epoch snapshot taken on 4 devices resumes on 2;
* the job fingerprint leaves ``multi_device`` out, so a service job
  resumes on another device count;
* against the reference's own ``multi_device=True`` campaign on its
  forced host devices (the ``multi_device_count`` fixture skips, with
  its reason, where they are missing).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a fixture)

from repro_torch.bench.lane_cards import point_fields
from repro_torch.core import build_plan, mesh2d, traffic
from repro_torch.noc import (Algo, CampaignSpec, LinkFail, ReplanConfig,
                             Scenario, SimConfig, run_campaign)
from repro_torch.noc import sim
from repro_torch.noc.ctrl import run_controlled
from repro_torch.noc.service import spec_fingerprint

pytestmark = pytest.mark.usefixtures("torch_one_thread")

TOPO = mesh2d(4, 4)
UNI = traffic.uniform(TOPO)
CPU4 = ("cpu",) * 4
BASE = SimConfig(cycles=300, warmup=100, drain=50)


def _spec(multi_device, rates, seeds, algos=(Algo.XY, Algo.BIDOR), **kw):
    return CampaignSpec(topo=TOPO, algos=algos,
                        patterns=(("uniform", UNI),), rates=rates,
                        seeds=seeds, base=BASE, multi_device=multi_device,
                        **kw)


def test_split_campaign_bit_identical():
    """8 lanes over 4 devices == one device, every statistic to the
    last bit."""
    rates, seeds = (0.1, 0.3, 0.5, 0.7), (0, 1)
    split = run_campaign(_spec(True, rates, seeds), device=CPU4)
    one = run_campaign(_spec(False, rates, seeds), device=CPU4)
    assert point_fields(split) == point_fields(one)


def test_split_campaign_with_chunked_early_exit():
    """The saturation early exit reads every group's queues after each
    chunk; a split run stops where the unsplit one does."""
    rates, seeds = (0.5, 0.7, 0.9, 1.0), (0, 1)
    base = BASE.replace(cycles=600, src_queue_pkts=2)

    def spec():
        return CampaignSpec(topo=TOPO, algos=(Algo.XY,),
                            patterns=("hotspot",), rates=rates, seeds=seeds,
                            base=base, chunk=100, sat_occupancy=0.5)

    split = run_campaign(spec(), device=("cpu", "cpu"))
    one = run_campaign(spec(), device="cpu")
    assert point_fields(split) == point_fields(one)
    # every lane saturated: the cell stopped before its last chunk
    assert all(p.result.saturated for p in one.points)
    assert max(p.result.meas_cycles for p in one.points) < 600 - 100 - 50


def test_split_state_parity():
    """The raw state after 200 cycles, every key (the PRNG keys, the
    packed flits, the locks, the counters) equal bit for bit."""
    points = [(r, s) for r in (0.1, 0.3, 0.5, 0.7) for s in (0, 1)]
    cfg = BASE.replace(cycles=200)
    tables, meta = sim.build_tables(TOPO, UNI, None, cfg.num_vcs, "cpu")
    lanes = sim.LaneGroups.fresh(tables, meta, cfg, points, CPU4)
    assert [len(st["key"]) for st in lanes.states] == [2, 2, 2, 2]
    lanes.run(120)
    lanes.run(80)
    got = lanes.to_host()
    state = sim.make_states(meta, cfg, points, "cpu")
    sim.run_cycles(tables, meta, cfg, state, 120)
    sim.run_cycles(tables, meta, cfg, state, 80)
    want = sim.state_to_host(state)
    assert got.keys() == want.keys()
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not bad, bad
    back = sim.LaneGroups.from_host(tables, meta, cfg, got, ("cpu",) * 2)
    assert all(np.array_equal(back.to_host()[k], want[k]) for k in want)


def test_lane_devices_chooses_as_the_reference():
    cpu = torch.device("cpu")
    assert sim.lane_devices(CPU4, 8) == (cpu,) * 4
    assert sim.lane_devices(CPU4, 6) == (cpu,)
    assert sim.lane_devices(CPU4, 8, False) == (cpu,)
    assert sim.lane_devices("cpu", 8) == (cpu,)
    with pytest.raises(ValueError, match="single device"):
        sim.lane_devices("cpu", 8, True)
    with pytest.raises(ValueError, match="divide"):
        sim.lane_devices(CPU4, 5, True)


@pytest.mark.parametrize("entry", ["campaign", "controlled"])
def test_multi_device_validates(entry):
    """``multi_device=True`` raises where the reference's runner does: on
    one device, and where the lanes do not divide over the devices."""
    cfg = BASE.replace(algo=Algo.XY)
    for device, rates, match in (("cpu", (0.1, 0.3), "single device"),
                                 (CPU4, (0.1, 0.3, 0.5), "divide")):
        with pytest.raises(ValueError, match=match):
            if entry == "campaign":
                run_campaign(_spec(True, rates, (0,), algos=(Algo.XY,)),
                             device=device)
            else:
                run_controlled(TOPO, UNI, cfg, rates=list(rates),
                               device=device, multi_device=True)


FAIL = Scenario("linkfail_online",
                events=(LinkFail(cycle=300, links=((5, 6), (6, 5)),
                                 bw_scale=0.25),),
                policy="online", replan=ReplanConfig(epoch=150))


def _controlled(**kw):
    plan = build_plan(TOPO, UNI, device="cpu")
    cfg = SimConfig(algo=Algo.BIDOR, cycles=600, warmup=150)
    return run_controlled(TOPO, UNI, cfg, FAIL, rates=[0.2, 0.3, 0.4, 0.5],
                          seeds=[0, 1], bidor_table=plan.table,
                          nrank0=plan.nrank, **kw)


def _assert_same(got, want):
    assert np.array_equal(got.link_peak, want.link_peak)
    assert got.epoch_bounds == want.epoch_bounds
    assert [dataclasses.asdict(r) for r in got.replans] == \
        [dataclasses.asdict(r) for r in want.replans]
    for a, b in zip(got.results, want.results):
        assert dataclasses.replace(a, node_load=0) == \
            dataclasses.replace(b, node_load=0)
        assert np.array_equal(a.node_load, b.node_load)


class _Stop(Exception):
    pass


class _MemoryCheckpoint:
    """An epoch-boundary checkpointer in memory that stops the run after
    ``stop_after`` saves."""

    def __init__(self, stop_after=None):
        self.snap, self.saves, self.stop_after = None, 0, stop_after

    def save(self, arrays, meta):
        self.snap = ({k: np.array(v) for k, v in arrays.items()}, dict(meta))
        self.saves += 1
        if self.stop_after is not None and self.saves >= self.stop_after:
            raise _Stop

    def load(self):
        return self.snap


def test_controlled_run_split_parity_and_resume_on_fewer_devices():
    """The control plane's epoch loop (events, counter reads, the online
    replan's hot swap into every group's tables) split over 4 devices
    equals the one-device run; a snapshot taken on 4 devices resumes on
    2 and ends the same, bit for bit."""
    one = _controlled(device="cpu")
    assert one.replans
    split = _controlled(device=CPU4, multi_device=True)
    _assert_same(split, one)
    ck = _MemoryCheckpoint(stop_after=2)
    with pytest.raises(_Stop):
        _controlled(device=CPU4, multi_device=True, checkpoint=ck)
    ck.stop_after = None
    resumed = _controlled(device=("cpu", "cpu"), checkpoint=ck)
    _assert_same(resumed, one)


def test_fingerprint_leaves_the_split_out():
    rates, seeds = (0.1, 0.3), (0,)
    assert spec_fingerprint(_spec(True, rates, seeds)) == \
        spec_fingerprint(_spec(None, rates, seeds)) == \
        spec_fingerprint(_spec(False, rates, seeds))


def test_split_against_the_reference_multi_device_campaign(
        multi_device_count):
    """The reference's ``shard_map`` campaign on its forced host devices
    against the port's split over as many CPU devices: integer fields
    exact, floats within the goldens' rtol 1e-5."""
    ndev = multi_device_count
    rates = tuple(0.1 + 0.2 * i for i in range(ndev // 2 or 1))
    seeds = (0, 1) if ndev > 1 else (0,)
    with reference():
        from repro.core import mesh2d as jmesh2d
        from repro.core import traffic as jtraffic
        from repro.noc import Algo as JAlgo
        from repro.noc import CampaignSpec as JSpec
        from repro.noc import SimConfig as JCfg
        from repro.noc import run_campaign as jrun

        jtopo = jmesh2d(4, 4)
        ref = jrun(JSpec(topo=jtopo, algos=(JAlgo.XY,),
                         patterns=(("uniform", jtraffic.uniform(jtopo)),),
                         rates=rates, seeds=seeds,
                         base=JCfg(cycles=300, warmup=100, drain=50),
                         multi_device=True))
    got = run_campaign(_spec(True, rates, seeds, algos=(Algo.XY,)),
                       device=("cpu",) * ndev)
    assert len(got.points) == len(ref.points) == len(rates) * len(seeds)
    for p, q in zip(got.points, ref.points):
        a, b = p.result, q.result
        assert (p.rate, p.seed) == (q.rate, q.seed)
        for f in ("injected_flits", "ejected_flits", "in_flight_flits",
                  "reorder_value", "meas_cycles"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("throughput", "avg_latency", "p50_latency",
                  "p99_latency", "link_load_max", "lcv"):
            assert np.isclose(getattr(a, f), getattr(b, f), rtol=1e-5,
                              atol=1e-6), f
