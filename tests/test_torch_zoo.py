"""The topology zoo on the port, against the reference on the CPU:

* the zoo's routes, DOR tables, deadlock certificates and simulator
  tables (the escape table included), array for array;
* BiDOR plans on the zoo, dead channels masked: choice and port tables,
  ``unroutable`` masks and certificate verdicts;
* a two-topology ``topos`` campaign point for point, and the topology
  axis's cell keys, ``select`` and ``grid``;
* the golden ``tests/goldens/zoo.json``, written by the reference
  (``python tests/test_torch_zoo.py`` rewrites it byte for byte), which
  ``chip_smoke.py`` holds the card's kernels to with no JAX at run time;
  the twin is held to it, and to the reference state by state, in
  ``test_torch_zoo_sim*.py``, ``test_torch_watchdog.py`` and
  ``test_torch_probe.py``.
"""

import dataclasses
import functools
import json
import os
import sys

import numpy as np
import pytest

from test_torch_oracle import GOLDEN_DIR, reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
from repro.core import certify as jcert, routes as jroutes  # noqa: E402
from repro.noc import sim as jsim  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import certify as tcert, routes as troutes  # noqa: E402
from repro_torch.noc import (Algo, CampaignSpec, Scenario,  # noqa: E402
                             SimConfig, campaign_cells, run_campaign)
from repro_torch.noc import sim as tsim  # noqa: E402

GOLDEN = "zoo.json"
GOLDEN_PATH = os.path.join(GOLDEN_DIR, GOLDEN)
# the zoo: (constructor, arguments); 7-port routers (the 3-D torus,
# multipod), 5-port (the concentrated and fault-region meshes) and
# 9-port (the express mesh)
ZOO = {"torus_4x4x4": ("torus", (4, 4, 4)),
       "cmesh_4x4c4": ("cmesh", (4, 4, 4)),
       "express_8x8i2": ("express_mesh", (8, 8)),
       "fault_region_6x6_r2.2.3.3": ("fault_region_mesh",
                                     (6, 6, (2, 2, 3, 3))),
       "multipod_2x3x3": ("multipod", (2, 3, 3))}
# the golden's cells: 300 cycles, rates 0.2 and 0.5, seed 0
SIM = dict(cycles=300, warmup=100)
RATES, SEEDS = (0.2, 0.5), (0,)


def pair(name):
    """(reference topology, port topology) of a zoo entry."""
    fn, args = ZOO[name]
    return getattr(jcore, fn)(*args), getattr(tcore, fn)(*args)


def admitted(topo) -> list:
    """Every routing algorithm the topology admits (odd-even: 2-D)."""
    return [a for a in Algo if a != Algo.ODDEVEN or topo.ndim == 2]


def _down(topo):
    down = topo.down_channels
    return down if down.size else None


@functools.lru_cache(maxsize=None)
def plans(name):
    """(reference plans, port plans) of the zoo entry's uniform and
    hotspot traffic, the topology's dead channels masked."""
    j, t = pair(name)
    tms = [jcore.traffic.uniform(j), jcore.traffic.hotspot(j)]
    with reference():
        jp = jcore.build_plans_batched(j, tms, down_channels=_down(j))
    tp = tcore.build_plans_batched(t, tms, down_channels=_down(t),
                                   device="cpu")
    return jp, tp


def cell_traffic(name, algo, plan=None):
    """The uniform traffic a zoo cell generates: BiDOR's with the pairs
    its plan cannot route shed, as the campaign deploys it."""
    tm = tcore.traffic.uniform(pair(name)[1])
    if algo == Algo.BIDOR:
        table = (plan or plans(name)[1][0]).table
        if table.unroutable is not None and table.unroutable.any():
            tm = np.where(table.unroutable, 0.0, tm)
    return tm


def record(r) -> dict:
    """A SimResult as the goldens keep it (``algos_5x5.json``'s fields:
    integers as they are, floats rounded to 6 places)."""
    return {"injected": int(r.injected_flits),
            "ejected": int(r.ejected_flits),
            "in_flight": int(r.in_flight_flits),
            "reorder": int(r.reorder_value),
            "meas_cycles": int(r.meas_cycles),
            "max_latency": float(r.max_latency),
            "throughput": round(float(r.throughput), 6),
            "avg_latency": round(float(r.avg_latency), 6),
            "p50_latency": round(float(r.p50_latency), 6),
            "p99_latency": round(float(r.p99_latency), 6),
            "link_load_max": round(float(r.link_load_max), 6),
            "lcv": round(float(r.lcv), 6)}


def mismatches(want: dict, got: dict) -> list[str]:
    """Integers exact, floats within rtol 1e-5 (atol 1e-6)."""
    bad = []
    for key, w in want.items():
        g = got[key]
        for f, x in w.items():
            ok = (x == g[f] if isinstance(x, int) else
                  bool(np.isclose(g[f], x, rtol=1e-5, atol=1e-6)))
            if not ok:
                bad.append(f"{key}.{f}: {g[f]} != {x}")
    return bad


@functools.lru_cache(maxsize=None)
def golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


# the watchdog and the telemetry of the state-by-state comparison (a ring
# of 4 slots of 40 cycles, which wraps in 300)
FEATURES = dict(watchdog=True, telemetry=True, tel_epoch=40, tel_slots=4)


def _tile(n: int) -> int:
    """A proper divisor of ``n`` for a tiled run: two or three tiles."""
    return n // min(d for d in range(2, n + 1) if n % d == 0)


def hold_cell(name, algo):
    """One zoo cell, 300 cycles from fresh state at rates 0.2 and 0.5:

    * with the watchdog and the telemetry on, every state key of the
      port (in tiles) against the reference's, bit for bit;
    * with both off, the results against the golden's points (the
      reference's, BiDOR on the port's own plan, as the card runs it),
      and the core keys against the on-run's where the watchdog stayed
      quiet.
    Returns the on-run's watchdog trips."""
    from repro.noc.simconfig import Algo as JAlgo, SimConfig as JCfg
    from test_torch_simstep import _assert_equal

    j, t = pair(name)
    (jplan, _), (tplan, _) = plans(name)
    bidor = algo == Algo.BIDOR
    tm = cell_traffic(name, algo)
    points = [(r, s) for r in RATES for s in SEEDS]
    on = dict(SIM, **FEATURES)
    with reference():
        jt, meta = jsim.build_tables(j, tm, jplan.table if bidor else None, 2)
        jcfg = JCfg(algo=JAlgo(int(algo)), **on)
        want = jax.device_get(jsim.get_runner(meta, jcfg, SIM["cycles"])(
            jt, jsim.make_states(meta, jcfg, points)))
    tt, _ = tsim.build_tables(t, tm, tplan.table if bidor else None, 2,
                              device="cpu")
    cfg = SimConfig(algo=algo, **on, sim_tile_nodes=_tile(meta["N"]))
    got = tsim.make_states(meta, cfg, points, device="cpu")
    tsim.run_cycles(tt, meta, cfg, got, SIM["cycles"])
    _assert_equal(want, got, f"{name}/{algo.name}")
    cfg_off = SimConfig(algo=algo, **SIM)
    off = tsim.make_states(meta, cfg_off, points, device="cpu")
    tsim.run_cycles(tt, meta, cfg_off, off, SIM["cycles"])
    host = tsim.state_to_host(off)
    recs = {f"{name}/{algo.name}/r{r}/s{s}": record(tsim.postprocess(
        tsim.lane(host, i), cfg_off, t, rate=r, seed=s))
        for i, (r, s) in enumerate(points)}
    assert not mismatches({k: golden()["points"][k] for k in recs}, recs)
    trips = int(np.asarray(want["wd_trips"]).sum())
    if trips == 0:
        _assert_equal({k: v for k, v in tsim.state_to_host(got).items()
                       if not k.startswith(("tel_", "wd_"))}, off,
                      f"{name}/{algo.name} features on vs off")
    return trips


def hold_sweep_rows(name):
    """The port's QUICK topology sweep on one zoo topology against the
    committed ``artifacts/bench/topo_sweep.csv``, row for row."""
    from repro_torch.bench import topo_sweep

    topo = pair(name)[1]
    res = run_campaign(topo_sweep.sweep_spec(True, [topo]), device="cpu")
    assert len(res.points) == 8
    assert not topo_sweep.compare_csv(res, topos={name})


# ------------------------------------------------------------------ #
# host arrays
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name", sorted(ZOO))
def test_topology_fields(name):
    j, t = pair(name)
    assert j.name == t.name == name
    for f in ("coords", "channels", "io_weights", "channel_bw", "distances",
              "neighbor_table", "channel_port", "port_of_channel_at_receiver",
              "coord_strides", "down_channels"):
        assert np.array_equal(getattr(j, f), getattr(t, f)), f
    assert (j.num_ports, j.port_local, j.route_horizon, j.ndim) == (
        t.num_ports, t.port_local, t.route_horizon, t.ndim)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_routes_and_dor_table(name):
    j, t = pair(name)
    for order in jroutes.dimension_orders(j.ndim):
        assert np.array_equal(jroutes.next_hop_table(j, order),
                              troutes.next_hop_table(t, order))
        assert np.array_equal(jroutes.next_port_table(j, order),
                              troutes.next_port_table(t, order))
        assert np.array_equal(jroutes.walk_routes(j, order),
                              troutes.walk_routes(t, order))
    jd, td = jcore.dor_table(j), tcore.dor_table(t)
    for f in ("choice", "costs", "port_tables"):
        assert np.array_equal(getattr(jd, f), getattr(td, f)), f


@pytest.mark.parametrize("name", sorted(ZOO))
def test_certify(name):
    """The certifier's verdict, arrays and channel-dependency graph on a
    random choice table over the zoo's DOR ports."""
    j, t = pair(name)
    rng = np.random.default_rng(7)
    ports = jcore.dor_table(j).port_tables
    choice = rng.integers(0, ports.shape[0],
                          (j.num_nodes,) * 2).astype(np.int8)
    cj = jcert.certify_ports(j, ports, choice)
    ct = tcert.certify_ports(t, ports, choice)
    assert (cj.verdict, cj.cyclic_nodes) == (ct.verdict, ct.cyclic_nodes)
    for k, a in cj.as_arrays().items():
        assert np.array_equal(a, ct.as_arrays()[k]), k
    assert np.array_equal(jcert.build_cdg(j, ports, choice)[0],
                          tcert.build_cdg(t, ports, choice)[0])


@pytest.mark.parametrize("name", sorted(ZOO))
def test_build_tables(name):
    """Every table field the port keeps, the watchdog's escape table
    (the first dimension order's routes) included."""
    j, t = pair(name)
    tm = jcore.traffic.uniform(j)
    with reference():
        jt, jmeta = jsim.build_tables(j, tm, None, 2)
        jt = type(jt)(*[np.asarray(x) for x in jt])
    tt, tmeta = tsim.build_tables(t, tm, None, 2, device="cpu")
    assert jmeta == tmeta
    assert "esc_port" in tt._fields and set(tt._fields) <= set(jt._fields)
    for f in tt._fields:
        a, b = getattr(jt, f), getattr(tt, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("name", sorted(ZOO))
def test_plans(name):
    """``build_plans_batched`` on uniform and hotspot traffic with the dead
    channels masked: the reference's choice and port tables, unroutable
    pairs and certificate verdicts."""
    jp, tp = plans(name)
    for a, b in zip(jp, tp):
        assert np.array_equal(a.table.choice, b.table.choice)
        assert np.array_equal(a.table.port_tables, b.table.port_tables)
        assert (a.table.unroutable is None) == (b.table.unroutable is None)
        if a.table.unroutable is not None:
            assert np.array_equal(a.table.unroutable, b.table.unroutable)
        assert a.cert.verdict == b.cert.verdict
    if name.startswith("fault_region"):
        assert tp[0].table.unroutable is not None


# ------------------------------------------------------------------ #
# the topology axis
# ------------------------------------------------------------------ #
TWO = (("cmesh", (3, 3, 2)), ("fault_region_mesh", (5, 5, (1, 1, 2, 2))))


def _two_spec(mod, cfg_cls, algo_cls):
    return dict(topo=None,
                topos=tuple(getattr(mod, fn)(*a) for fn, a in TWO),
                algos=(algo_cls.XY, algo_cls.BIDOR),
                patterns=("uniform", "hotspot"), rates=(0.1, 0.3),
                seeds=(0,), base=cfg_cls(cycles=400, warmup=100, drain=20))


@functools.lru_cache(maxsize=None)
def two_topology_campaign():
    """(reference result, port result) of a two-topology campaign."""
    from repro.noc import (Algo as JAlgo, CampaignSpec as JSpec,
                           SimConfig as JCfg, run_campaign as jrun)

    with reference():
        want = jrun(JSpec(**_two_spec(jcore, JCfg, JAlgo)))
    got = run_campaign(CampaignSpec(**_two_spec(tcore, SimConfig, Algo)),
                       device="cpu")
    return want, got


def test_topos_campaign_matches_reference():
    """Point for point, in the reference's order: the cell coordinates
    and every SimResult field, equal."""
    want, got = two_topology_campaign()
    assert len(got.points) == len(want.points) == 16
    for w, g in zip(want.points, got.points):
        assert (w.topo, w.pattern, w.algo.name, w.scenario, w.rate,
                w.seed) == (g.topo, g.pattern, g.algo.name, g.scenario,
                            g.rate, g.seed)
        dw, dg = dataclasses.asdict(w.result), dataclasses.asdict(g.result)
        dw["algo"], dg["algo"] = int(dw["algo"]), int(dg["algo"])
        bad = [k for k in dw if not np.array_equal(dw[k], dg[k])]
        assert not bad, (g.topo, g.pattern, g.algo.name, bad)
    assert set(got.wall_clock_s) == set(want.wall_clock_s)
    assert got.to_rows() == want.to_rows()


def test_select_and_grid_by_topology():
    _, res = two_topology_campaign()
    names = res.topo_names
    assert names == ("cmesh_3x3c2", "fault_region_5x5_r1.1.2.2")
    for name in names:
        pts = res.select(topo=name)
        assert len(pts) == 8 and {p.topo for p in pts} == {name}
        g = res.grid("throughput", Algo.XY, "uniform", topo=name)
        assert g.shape == (2, 1)
        assert g[0, 0] == res.select(topo=name, algo=Algo.XY,
                                     pattern="uniform",
                                     rate=0.1)[0].result.throughput
        assert res.saturation_throughput(Algo.XY, "uniform",
                                         topo=name) == g.max()
    with pytest.raises(ValueError, match="ambiguous topo axis"):
        res.grid("throughput", Algo.XY, "uniform")
    with pytest.raises(KeyError, match="unknown topo"):
        res.grid("throughput", Algo.XY, "uniform", topo="mesh2d_9x9")
    assert "topo=cmesh_3x3c2" in res.summary()


@pytest.mark.parametrize("topos,scenarios", [(1, 0), (1, 2), (2, 0), (2, 2)])
def test_cells_and_wall_keys_match_reference(topos, scenarios):
    """``campaign_cells`` in the reference's topology → pattern →
    algorithm → scenario order, and each cell's ``wall_key`` shape:
    ``(algo, pattern)``, ``+ (scenario,)``, the topology first where the
    axis has more than one."""
    from repro.noc import (Algo as JAlgo, CampaignSpec as JSpec,
                           Scenario as JScen, campaign_cells as jcells)

    def spec(mod, spec_cls, algo_cls, scen_cls):
        ts = tuple(getattr(mod, fn)(*a) for fn, a in TWO)[:topos]
        kw = dict(topo=ts[0], topos=ts if topos > 1 else (),
                  algos=(algo_cls.XY, algo_cls.BIDOR),
                  patterns=("uniform", ("mine", np.ones((9, 9)))),
                  rates=(0.1,),
                  scenarios=tuple(scen_cls(f"s{i}")
                                  for i in range(scenarios)))
        return spec_cls(**kw)

    js = spec(jcore, JSpec, JAlgo, JScen)
    ts = spec(tcore, CampaignSpec, Algo, Scenario)
    want, got = jcells(js), campaign_cells(ts)
    assert len(got) == len(want) == topos * 2 * 2 * max(scenarios, 1)
    assert ts.num_points == js.num_points
    for w, g in zip(want, got):
        assert (w.index, w.topo_i, w.topo, w.item_i, w.pattern, w.algo.name,
                w.scen_i, w.scenario) == (g.index, g.topo_i, g.topo,
                                          g.item_i, g.pattern, g.algo.name,
                                          g.scen_i, g.scenario)
        assert g.wall_key(ts) == w.wall_key(js)
    assert len(got[0].wall_key(ts)) == 2 + (topos > 1) + (scenarios > 0)


def test_spec_needs_a_topology():
    with pytest.raises(ValueError, match="topo or a non-empty topos"):
        CampaignSpec(topo=None, algos=(Algo.XY,), patterns=("uniform",),
                     rates=(0.1,))


def test_sweep_rows_torus():
    """The torus's rows of the QUICK topology sweep against the committed
    CSV (the other topologies' in ``test_torch_topo_sweep.py`` and
    ``test_torch_zoo_multipod.py``)."""
    hold_sweep_rows("torus_4x4x4")


# ------------------------------------------------------------------ #
# the golden
# ------------------------------------------------------------------ #
def test_golden_covers_the_zoo():
    """The golden holds every zoo topology under every algorithm it
    admits, with the constructors that rebuild it without JAX."""
    g = golden()
    assert g["sim"] == SIM and g["rates"] == list(RATES)
    assert set(g["topologies"]) == set(ZOO)
    for name, spec in g["topologies"].items():
        topo = getattr(tcore, spec["fn"])(*spec["args"])
        assert topo.name == name
        keys = {k for k in g["points"] if k.startswith(name + "/")}
        assert len(keys) == len(admitted(topo)) * len(RATES) * len(SEEDS)
    assert set(g["wedged"]["runs"]) == {"baseline", "watchdog", "livelock"}


def golden_text() -> str:
    """The golden as the reference computes it, serialised byte-stably."""
    from repro.noc import SimConfig as JCfg, run_sim as jsim_run
    from repro.noc import run_sweep as jsweep
    from repro.noc.simconfig import Algo as JAlgo

    points = {}
    for name in ZOO:
        j, _ = pair(name)
        jplan = plans(name)[0][0]
        for algo in admitted(j):
            table, tm = None, jcore.traffic.uniform(j)
            if algo == Algo.BIDOR:
                table = jplan.table
                if table.unroutable is not None and table.unroutable.any():
                    tm = np.where(table.unroutable, 0.0, tm)
            with reference():
                res = jsweep(j, tm, JCfg(algo=JAlgo(int(algo)), **SIM),
                             list(RATES), table, list(SEEDS))
            for (r, s), out in zip([(r, s) for r in RATES for s in SEEDS],
                                   res):
                points[f"{name}/{algo.name}/r{r}/s{s}"] = record(out)
    from test_torch_watchdog import WEDGED, WEDGED_RUNS, ring_table
    topo = jcore.mesh2d(2, 2)
    wedged = {}
    for label, kw in WEDGED_RUNS.items():
        with reference():
            r, wd = jsim_run(topo, jcore.traffic.uniform(topo),
                             JCfg(algo=JAlgo.BIDOR, **WEDGED, **kw),
                             ring_table(jcore), return_watchdog=True)
        wedged[label] = {"sim": kw, "record": record(r),
                         "report": wd and wd.trace_args()}
    from test_torch_probe import TEL_CELL
    name = TEL_CELL["topo"]
    j, _ = pair(name)
    with reference():
        res, tel, wd = jsweep(
            j, jcore.traffic.uniform(j),
            JCfg(algo=JAlgo[TEL_CELL["algo"]], **TEL_CELL["sim"]),
            list(RATES), None, list(SEEDS), return_telemetry=True,
            return_watchdog=True)
    cell = dict(TEL_CELL, rates=list(RATES), seeds=list(SEEDS),
                records={f"r{r}/s{s}": record(out) for (r, s), out in zip(
                    [(r, s) for r in RATES for s in SEEDS], res)},
                rings={k: getattr(tel, k).tolist()
                       for k in ("chan", "counts", "cycles", "lat", "qocc")},
                report=wd.trace_args())
    return json.dumps({
        "description": (
            "The topology zoo (torus 4x4x4, cmesh 4x4 c4, express 8x8, the "
            "6x6 mesh with a dead 2x2 region, multipod 2x3x3) under every "
            "routing algorithm each admits, uniform traffic (BiDOR on its "
            "plan with the dead channels masked and its unroutable pairs "
            "shed), rates 0.2 and 0.5, seed 0, 300 cycles (warmup 100); "
            "the cyclic 2x2 ring without and with the stall watchdog; and "
            "a fault-region XY cell with the watchdog and the telemetry "
            "on, its rings and trips. Written by the JAX reference: "
            "python tests/test_torch_zoo.py"),
        "sim": SIM, "rates": list(RATES), "seeds": list(SEEDS),
        "topologies": {name: {"fn": fn, "args": list(args)}
                       for name, (fn, args) in ZOO.items()},
        "points": points,
        "wedged": {"algo": "BIDOR", "sim": WEDGED, "runs": wedged},
        "telemetry": cell}, indent=1, sort_keys=True) + "\n"


if __name__ == "__main__":
    text = golden_text()
    with open(GOLDEN_PATH, "w") as f:
        f.write(text)
    print(f"wrote {GOLDEN_PATH}", file=sys.stderr)
