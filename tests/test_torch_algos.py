"""The paper's other routing algorithms (YX, O1TURN, VALIANT, ROMM,
ODDEVEN) and trace replay on the port, against the reference on the CPU:

* the draws they take from the metadata key (``bernoulli``, ``randint``,
  the 2-D ``uniform``) bit for bit against ``jax.random``, in bulk and
  node by node as the card's kernels hash them;
* every state key after fresh and mid-flight runs on the paper's 5x5
  edge-I/O mesh (the 4x4 mesh is in ``test_torch_simstep.py``);
* ``run_trace_sweep`` and ``clos_leaf_trace`` (Fig. 9's workload);
* odd-even's refusal of a topology that is not 2-D;
* the golden ``tests/goldens/algos_5x5.json``, written by the reference
  (``python tests/test_torch_algos.py`` rewrites it byte for byte), which
  ``chip_smoke.py`` holds the card's kernels to with no JAX at run time.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest

from test_torch_oracle import (FLOAT_FIELDS, GOLDEN_DIR, INT_FIELDS,
                               load_golden, reference)
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.kernels.simstep import ref as port_ref  # noqa: E402
from repro_torch.noc import (Algo, CampaignSpec, SimConfig,  # noqa: E402
                             clos_leaf_trace, run_campaign, run_sweep,
                             run_trace_sweep)
from repro_torch.noc import sim as tsim  # noqa: E402

GOLDEN = "algos_5x5.json"
GOLDEN_PATH = os.path.join(GOLDEN_DIR, GOLDEN)
NEW = [Algo.YX, Algo.O1TURN, Algo.VALIANT, Algo.ROMM, Algo.ODDEVEN]
FIG9 = [Algo.XY, Algo.O1TURN, Algo.VALIANT, Algo.ROMM, Algo.ODDEVEN,
        Algo.BIDOR]
DRAWN = [Algo.O1TURN, Algo.VALIANT, Algo.ROMM]
SIZES = [1, 2, 16, 25, 289, 1024]
KEY = prng.fold_in(prng.key(11), 12345)


def _np(x):
    return np.asarray(jax.device_get(x))


# ------------------------------------------------------------------ #
# the draws
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n", SIZES)
def test_bernoulli(n):
    with reference():
        want = _np(jax.random.bernoulli(KEY, 0.5, (n,)))
    got = prng.bernoulli(KEY, n)
    assert got.dtype == want.dtype == np.bool_
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_randint(n):
    with reference():
        want = _np(jax.random.randint(KEY, (n,), 0, n))
    got = prng.randint(KEY, n, 0, n)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_uniform_2d(n):
    for ndim in (2, 3):
        with reference():
            want = _np(jax.random.uniform(KEY, (n, ndim)))
        got = prng.uniform(KEY, (n, ndim))
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", [16, 25, 289, 1024])
@pytest.mark.parametrize("algo", DRAWN)
def test_draws_match_reference_and_the_kernels_node_hashing(algo, n):
    """Three cycles of ``split_rand`` on two lanes against the
    reference's, the algorithm's draw bit for bit; and the same draws
    hashed node by node (``node_draws``, one threefry block a node and
    draw, as the card's kernels hash them) at every node."""
    from repro.kernels.simstep import ref as jref
    from repro.noc.simconfig import Algo as JAlgo

    keys = np.stack([tsim.point_key(0, 0.3), tsim.point_key(5, 0.55)])
    name = {Algo.O1TURN: "ob", Algo.VALIANT: "ri", Algo.ROMM: "ur"}[algo]
    k_port = keys
    for _ in range(3):
        with reference():
            outs = [jref.split_rand(jax.numpy.asarray(k), JAlgo(int(algo)),
                                    n, 2) for k in k_port]
        km = prng.split(k_port, 5)[:, 3]
        k_port, rand = port_ref.split_rand(k_port, algo, n, 2)
        want = np.stack([_np(o[1][name]) for o in outs])
        got = rand[name].numpy()
        assert want.dtype == got.dtype and np.array_equal(want, got)
        node = port_ref.node_draws(algo, km, np.arange(n), n, 2)[name]
        assert np.array_equal(node, want)


# ------------------------------------------------------------------ #
# the 5x5 edge-I/O mesh, state by state
# ------------------------------------------------------------------ #
@functools.lru_cache(maxsize=None)
def _edge_cell(algo: Algo):
    """(reference tables, meta, cfg; port tables, cfg) on the paper's
    5x5 edge-I/O mesh under overturn traffic."""
    import repro.core as jcore
    from repro.noc import sim as jsim
    from repro.noc.simconfig import Algo as JAlgo, SimConfig as JCfg

    topo = jcore.mesh2d_edge_io(5, 5)
    tm = jcore.traffic.overturn(topo)
    with reference():
        jt, meta = jsim.build_tables(topo, tm, None, 2)
    jcfg = JCfg(algo=JAlgo(int(algo)), cycles=4000, warmup=60)
    tt, _ = tsim.build_tables(tcore.mesh2d_edge_io(5, 5), tm, None, 2,
                              device="cpu")
    return jt, meta, jcfg, tt, SimConfig(algo=algo, cycles=4000, warmup=60)


@pytest.mark.parametrize("algo", NEW)
def test_edge_io_fresh_then_midflight(algo):
    """150 cycles from fresh state at rates 0.35 and 0.9, then 60 more
    from the reference's state with injection stopping after 20 (the
    queues partly drained): every state key and the PRNG key bit for
    bit, the corner and edge routers included."""
    from repro.noc import sim as jsim
    from test_torch_simstep import _assert_equal

    jt, meta, jcfg, tt, tcfg = _edge_cell(algo)
    points = [(0.35, 0), (0.9, 4)]
    with reference():
        mid = dict(jax.device_get(jsim.get_runner(meta, jcfg, 150)(
            jt, jsim.make_states(meta, jcfg, points))))
    got = tsim.make_states(meta, tcfg, points, device="cpu")
    tsim.run_cycles(tt, meta, tcfg, got, 150)
    _assert_equal(mid, got, f"fresh/{algo.name}")
    mid["inject_until"] = np.full_like(mid["inject_until"], 170)
    with reference():
        want = jax.device_get(jsim.get_runner(meta, jcfg, 60)(
            jt, {k: jax.numpy.asarray(v) for k, v in mid.items()}))
    got = convert.state_from_numpy(mid, device="cpu")
    tsim.run_cycles(tt, meta, tcfg, got, 60)
    _assert_equal(want, got, f"midflight/{algo.name}")
    if algo != Algo.YX:        # the oblivious and adaptive ones reorder
        assert int(np.asarray(want["reorder_max"]).max()) > 0


def test_oddeven_refuses_a_topology_that_is_not_2d():
    """The reference's refusal, at each entry: the plain parts, the
    flit step and ``run_sweep`` raise ``ValueError`` on a 3-D torus."""
    topo = tcore.torus(3, 3, 3)
    tm = tcore.traffic.uniform(topo)
    cfg = SimConfig(algo=Algo.ODDEVEN, cycles=200, warmup=50)
    tables, meta = tsim.build_tables(topo, tm, None, 2, device="cpu")
    assert meta["NDIM"] == 3
    with pytest.raises(ValueError, match="2D turn model"):
        port_ref.make_cycle_parts(meta, cfg)
    st = tsim.make_states(meta, cfg, [(0.1, 0)], device="cpu")
    with pytest.raises(ValueError, match="2D turn model"):
        tsim.run_cycles(tables, meta, cfg, st, 10)
    with pytest.raises(ValueError, match="2D turn model"):
        run_sweep(topo, tm, cfg, [0.1], device="cpu")


def test_oddeven_credits_at_corner_edge_and_inner_routers():
    """The free slots odd-even reads behind each port, against the
    reference's own indexing of the pre-cycle sizes (``fs_pre[(neighbor ·
    P + recv_port) · V + k]``, a missing neighbour −1 wrapped then
    clamped) at a corner (0), an edge (1, 4) and an inner (5) router of
    the 4x4 mesh, from random sizes."""
    import torch

    import repro.core as jcore
    from repro.noc import sim as jsim

    tm = jcore.traffic.uniform(jcore.mesh2d(4, 4))
    with reference():
        jt, meta = jsim.build_tables(jcore.mesh2d(4, 4), tm, None, 2)
    tt, _ = tsim.build_tables(tcore.mesh2d(4, 4), tm, None, 2,
                              device="cpu")
    p, v, nin, b = meta["P"], meta["V"], meta["NIN"], 32
    fs = np.random.default_rng(1).integers(0, b + 1, (2, nin),
                                           dtype=np.int32)
    nodes = [0, 1, 4, 5]
    base = (np.asarray(jt.neighbor) * p + np.asarray(jt.recv_port)) * v
    assert (np.asarray(jt.neighbor)[0] == -1).any()     # the corner's
    with reference():
        want = np.stack([np.stack(
            [b - np.asarray(jax.numpy.asarray(fs[lane])[
                jax.numpy.asarray(base[nodes] + k)]) for k in range(v)], -1)
            for lane in range(2)])
    got = port_ref.receiver_free(tt, torch.as_tensor(fs),
                                 torch.as_tensor(nodes), v, b)
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------------ #
# trace replay (Fig. 9)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed", [7, 3])
def test_clos_leaf_trace_matches_reference(seed):
    import repro.core as jcore
    from repro.noc.workload import clos_leaf_trace as jclos

    with reference():
        want, want_agg = jclos(jcore.mesh2d_edge_io(5, 5), num_epochs=4,
                               base_rate=0.3, seed=seed)
    got, got_agg = clos_leaf_trace(tcore.mesh2d_edge_io(5, 5), num_epochs=4,
                                   base_rate=0.3, seed=seed)
    assert np.array_equal(want_agg, got_agg) and len(want) == len(got)
    for (wt, wr), (gt, gr) in zip(want, got):
        assert np.array_equal(wt, gt) and wr == gr


@functools.lru_cache(maxsize=None)
def _trace_case(epochs: int):
    """(segments, aggregate, the reference's plan of the aggregate) of a
    Clos leaf trace on the 5x5 edge-I/O mesh, as Fig. 9 makes it."""
    import repro.core as jcore

    segments, agg = clos_leaf_trace(tcore.mesh2d_edge_io(5, 5),
                                    num_epochs=epochs, base_rate=0.3)
    with reference():
        plan = jcore.build_plan(jcore.mesh2d_edge_io(5, 5), agg)
    return segments, agg, plan.table


def _trace_cfg(algo, cycles):
    return SimConfig(algo=algo, cycles=cycles, warmup=cycles // 4,
                     lat_bins=128, lat_bin_width=32)


@pytest.mark.parametrize("algo", FIG9)
def test_run_trace_sweep_matches_reference(algo):
    """2 epochs of 600 cycles, seeds 0 and 1 as lanes: every SimResult
    field equal (integers exact), the per-segment LCVs within 1e-6."""
    import repro.core as jcore
    from repro.noc import run_trace_sweep as jtrace
    from repro.noc.simconfig import Algo as JAlgo, SimConfig as JCfg

    segments, _, table = _trace_case(2)
    jcfg = JCfg(algo=JAlgo(int(algo)), cycles=600, warmup=150,
                lat_bins=128, lat_bin_width=32)
    with reference():
        want = jtrace(jcore.mesh2d_edge_io(5, 5), segments, jcfg,
                      bidor_table=table, seeds=[0, 1])
    ptable = convert.plan_from_numpy(table.choice, table.port_tables)
    got = run_trace_sweep(tcore.mesh2d_edge_io(5, 5), segments,
                          _trace_cfg(algo, 600), bidor_table=ptable,
                          seeds=[0, 1], device="cpu")
    for (w, wl), (g, gl) in zip(want, got):
        for f in ("injection_rate", "throughput", "offered", "avg_latency",
                  "max_latency", "lcv", "reorder_value", "ejected_flits",
                  "injected_flits", "in_flight_flits", "seed",
                  "meas_cycles", "p50_latency", "p99_latency",
                  "link_load_max"):
            assert getattr(w, f) == getattr(g, f), f
        assert np.array_equal(w.node_load, g.node_load)
        assert len(wl) == len(gl) == 2
        assert np.allclose(wl, gl, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ #
# the golden: the reference's numbers for the card's kernels
# ------------------------------------------------------------------ #
GOLDEN_RATES = (0.2, 0.55)
GOLDEN_PATTERNS = ("uniform", "overturn")
TRACE_EPOCHS, TRACE_CYCLES, TRACE_SEEDS = 2, 800, (0, 1)


def _record(r) -> dict:
    """A SimResult as the golden keeps it (``campaign_4x4.json``'s
    fields: integers as they are, floats rounded to 6 places)."""
    return {"injected": int(r.injected_flits),
            "ejected": int(r.ejected_flits),
            "in_flight": int(r.in_flight_flits),
            "reorder": int(r.reorder_value),
            "meas_cycles": int(r.meas_cycles),
            "throughput": round(float(r.throughput), 6),
            "avg_latency": round(float(r.avg_latency), 6),
            "p50_latency": round(float(r.p50_latency), 6),
            "p99_latency": round(float(r.p99_latency), 6),
            "link_load_max": round(float(r.link_load_max), 6),
            "lcv": round(float(r.lcv), 6)}


def campaign_records(res) -> dict:
    return {f"{p.pattern}/{p.algo.name}/r{p.rate}/s{p.seed}":
            _record(p.result) for p in res.points}


def trace_records(algo_name: str, runs) -> dict:
    out = {}
    for seed, (r, lcvs) in zip(TRACE_SEEDS, runs):
        rec = _record(r)
        rec["max_latency"] = float(r.max_latency)
        rec["lcvs"] = [round(float(x), 6) for x in lcvs]
        out[f"trace/{algo_name}/s{seed}"] = rec
    return out


def golden_base():
    """The campaign's shared parameters (mesh2d_edge_io(5, 5), seed 0)."""
    return dict(cycles=1500, warmup=500)


def golden_text() -> str:
    """The golden as the reference computes it, serialised byte-stably."""
    import repro.core as jcore
    from repro.noc import (Algo as JAlgo, CampaignSpec as JSpec,
                           SimConfig as JCfg, run_campaign as jrun,
                           run_trace_sweep as jtrace)

    topo = jcore.mesh2d_edge_io(5, 5)
    segments, _, table = _trace_case(TRACE_EPOCHS)
    with reference():
        res = jrun(JSpec(topo=topo, algos=tuple(JAlgo),
                         patterns=GOLDEN_PATTERNS, rates=GOLDEN_RATES,
                         seeds=(0,), base=JCfg(**golden_base())))
        points = campaign_records(res)
        for algo in FIG9:
            cfg = JCfg(algo=JAlgo(int(algo)), cycles=TRACE_CYCLES,
                       warmup=TRACE_CYCLES // 4, lat_bins=128,
                       lat_bin_width=32)
            points.update(trace_records(algo.name, jtrace(
                topo, segments, cfg, bidor_table=table,
                seeds=list(TRACE_SEEDS))))
    return json.dumps({
        "description": (
            "mesh2d_edge_io(5,5): every routing algorithm under uniform "
            "and overturn traffic at rates 0.2 and 0.55, seed 0, 1500 "
            "cycles (warmup 500); and a 2-epoch x 800-cycle Clos leaf "
            "trace replay (Fig. 9) per algorithm, seeds 0 and 1. Written "
            "by the JAX reference: python tests/test_torch_algos.py"),
        "points": points}, indent=1, sort_keys=True) + "\n"


def _mismatches(want: dict, got: dict) -> list[str]:
    bad = []
    for key, w in want.items():
        g = got[key]
        for f in INT_FIELDS + ("max_latency",):
            if f in w and g[f] != w[f]:
                bad.append(f"{key}.{f}: {g[f]} != {w[f]}")
        for f in FLOAT_FIELDS:
            if not np.isclose(g[f], w[f], rtol=1e-5, atol=1e-6):
                bad.append(f"{key}.{f}: {g[f]} != {w[f]}")
        if "lcvs" in w and not np.allclose(g["lcvs"], w["lcvs"], rtol=0,
                                           atol=1e-6):
            bad.append(f"{key}.lcvs: {g['lcvs']} != {w['lcvs']}")
    return bad


@pytest.fixture(scope="module")
def golden():
    return load_golden(GOLDEN)["points"]


@pytest.mark.parametrize("algo", list(Algo))
def test_golden_campaign(golden, algo):
    """``run_campaign`` on the CPU against the golden's points of one
    algorithm (both patterns, both rates); in-order algorithms deliver
    in order, the others reorder at the high rate."""
    res = run_campaign(CampaignSpec(
        topo=tcore.mesh2d_edge_io(5, 5), algos=(algo,),
        patterns=GOLDEN_PATTERNS, rates=GOLDEN_RATES, seeds=(0,),
        base=SimConfig(**golden_base())), device="cpu")
    got = campaign_records(res)
    want = {k: v for k, v in golden.items()
            if k.split("/")[1] == algo.name and not k.startswith("trace/")}
    assert set(got) == set(want) and len(got) == 4
    assert not _mismatches(want, got)
    for key, rec in got.items():
        assert rec["injected"] == rec["ejected"] + rec["in_flight"], key
        if algo in (Algo.XY, Algo.YX, Algo.BIDOR):
            assert rec["reorder"] == 0, key
    for pattern in GOLDEN_PATTERNS:
        thr = [p.result.throughput for p in res.select(pattern=pattern)]
        assert res.saturation_throughput(algo, pattern) == max(thr)


@pytest.mark.parametrize("algo", FIG9)
def test_golden_trace(golden, algo):
    """``run_trace_sweep`` on the CPU against the golden's trace of one
    algorithm (results and per-segment LCVs), BiDOR on the port's own
    plan of the trace's aggregate, as ``chip_smoke.py`` makes it."""
    topo = tcore.mesh2d_edge_io(5, 5)
    segments, agg = clos_leaf_trace(topo, num_epochs=TRACE_EPOCHS,
                                    base_rate=0.3)
    plan = tcore.build_plan(topo, agg, device="cpu") \
        if algo == Algo.BIDOR else None
    runs = run_trace_sweep(topo, segments, _trace_cfg(algo, TRACE_CYCLES),
                           bidor_table=plan and plan.table,
                           seeds=list(TRACE_SEEDS), device="cpu")
    got = trace_records(algo.name, runs)
    want = {k: golden[k] for k in got}
    assert not _mismatches(want, got)


if __name__ == "__main__":
    with open(GOLDEN_PATH, "w") as f:
        f.write(golden_text())
    print(f"wrote {GOLDEN_PATH}", file=sys.stderr)
