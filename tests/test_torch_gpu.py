"""The port's CUDA kernels against their plain versions, on the card.

Needs no JAX, so it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Every test skips where no CUDA device is visible (the kernels have no
CPU mode); the CPU-side cases here check the wrappers' dispatch rules.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch import convert, kernels
from repro_torch.bench.lane_cards import point_fields
from repro_torch.core import (build_plans_batched, mesh2d, mesh2d_edge_io,
                              torus)
from repro_torch.core import traffic
from repro_torch.kernels.possibility import (possibility_v,
                                             possibility_v_plain,
                                             possibility_weights_op,
                                             possibility_weights_plain,
                                             prepare_weights)
from repro_torch.kernels.possibility import kernel as poss_kernel
from repro_torch.kernels.simstep import draw_chunk, make_cycle_fn
from repro_torch.noc import sim
from repro_torch.noc.simconfig import Algo, SimConfig


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _poss_inputs(topo, integer, seed, nodes=False, dist=None):
    """du, dn, T (fp64), dist: du/dn gathered on the channels, or with
    ``nodes`` du = dn = dist (C = N, the planner's offset-0 pass)."""
    rng = np.random.default_rng(seed)
    n = topo.num_nodes
    t = (rng.integers(0, 7, (n, n)).astype(np.float64) if integer
         else rng.random((n, n)))
    dist = torch.as_tensor(topo.distances if dist is None else dist)
    if nodes:
        return dist, dist, torch.as_tensor(t), dist
    us = torch.as_tensor(topo.channels[:, 0])
    ns = torch.as_tensor(topo.channels[:, 1])
    return (dist[:, us].contiguous(), dist[ns, :].contiguous(),
            torch.as_tensor(t), dist)


POSS_TOPOS = {
    # N and C not multiples of any tile (C != N but for "nodes")
    "mesh8x8": lambda: mesh2d(8, 8),       # N = 64, C = 224
    "mesh12x11": lambda: mesh2d(12, 11),   # N = 132, C = 482
    "torus9x10": lambda: torus(9, 10),     # N = 90, C = 360
    "mesh12x11_nodes": lambda: mesh2d(12, 11),
}
CFGS = [None] + list(range(len(poss_kernel.THREAD_TILES)))


def _pinned_v(du, dn, t, dist, offset, cfg):
    """possibility_v launched with thread tile ``cfg``, whatever the
    layout would choose at this size."""
    n, c = du.shape
    return poss_kernel._launch_v(du, dn, t, dist, offset,
                                 poss_kernel._layout(n, c, cfg))


def _pinned_weights(du, dn, dsn, tn, t, dist, offset, cfg):
    n, c = du.shape
    return poss_kernel._launch_weights(du, dn, dsn, tn, t, dist, offset,
                                       poss_kernel._layout(n, c, cfg))


@pytest.mark.gpu
@pytest.mark.parametrize("integer", [True, False], ids=["intT", "realT"])
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("topo_fn", sorted(POSS_TOPOS))
def test_possibility_kernel_vs_plain(cuda, topo_fn, offset, integer):
    """The layout's own tile and every other: integer T bit for bit, real
    T to rtol 1e-12 (fp64 sums over ascending s, the twin's einsum in
    another order)."""
    args = _poss_inputs(POSS_TOPOS[topo_fn](), integer, seed=offset,
                        nodes=topo_fn.endswith("nodes"))
    want = possibility_v_plain(*args, offset=offset).numpy()
    on = [a.to(cuda) for a in args]
    before = kernels.LAUNCHES["possibility_v"]
    got = possibility_v(*on, offset=offset)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["possibility_v"] == before + 1
    for cfg in CFGS:
        if cfg is not None:
            got = _pinned_v(*on, offset, cfg)
        if integer:
            assert np.array_equal(got.cpu().numpy(), want), cfg
        else:
            np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-12,
                                       err_msg=f"cfg {cfg}")


WEIGHT_TOPOS = {
    # C and N not multiples of the kernel's tiles
    "mesh6x5": lambda: mesh2d(6, 5),       # N = 30, C = 98
    "torus5x7": lambda: torus(5, 7),       # N = 35, C = 140
    "mesh8x8": lambda: mesh2d(8, 8),       # N = 64, C = 224
    "mesh12x11": lambda: mesh2d(12, 11),   # N = 132, C = 482
    "torus9x10": lambda: torus(9, 10),     # N = 90, C = 360
    # N = 256: eight destination tiles, summed by the second launch
    "torus16x16": lambda: torus(16, 16),   # N = 256, C = 1024
}


def _check_weights(got, want, integer, c, what=""):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (c,)
        if integer:
            assert np.array_equal(g.cpu().numpy(), w.numpy()), what
        else:
            np.testing.assert_array_max_ulp(g.cpu().numpy(), w.numpy(), 1)


@pytest.mark.gpu
@pytest.mark.parametrize("integer", [True, False], ids=["intT", "realT"])
@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("topo_fn", sorted(WEIGHT_TOPOS))
def test_possibility_weights_kernel_vs_plain(cuda, topo_fn, offset,
                                             integer):
    """fp64 sums in another order, one rounding to float32: integer T bit
    for bit, real T within one float32 ulp; the layout's own tile and
    every other."""
    topo = WEIGHT_TOPOS[topo_fn]()
    rng = np.random.default_rng(offset)
    n, c = topo.num_nodes, topo.num_channels
    t = (rng.integers(0, 7, (n, n)).astype(np.float64) if integer
         else rng.random((n, n)))
    args = prepare_weights(topo.distances, t, topo.channels, "cpu")
    want = possibility_weights_plain(*args, offset=offset)
    on = [a.to(cuda) for a in args]
    before = kernels.LAUNCHES["possibility_weights"]
    got = possibility_weights_op(*on, offset=offset)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["possibility_weights"] == before + 1
    if topo_fn == "torus16x16":
        assert poss_kernel.possibility_layout(n, c, True).splits > 1
    _check_weights(got, want, integer, c)
    for cfg in CFGS[1:]:
        _check_weights(_pinned_weights(*on, offset, cfg), want, integer, c,
                       f"cfg {cfg}")


@pytest.mark.gpu
def test_possibility_kernels_take_the_unreachable_sentinel(cuda):
    """Distances of unreachable pairs are int32 max // 4: du + offset +
    dn stays within int32 and matches as the twins' sums do."""
    topo = mesh2d(6, 5)
    dist = topo.distances.astype(np.int32).copy()
    cut = [3, 17]                      # nodes no other node reaches
    far = np.iinfo(np.int32).max // 4
    for v in cut:
        dist[:, v] = far
        dist[v, :] = far
        dist[v, v] = 0
    for offset in (0, 1, 2):
        args = _poss_inputs(topo, True, offset, dist=dist)
        want = possibility_v_plain(*args, offset=offset).numpy()
        for cfg in CFGS:
            got = (possibility_v(*[a.to(cuda) for a in args], offset=offset)
                   if cfg is None else _pinned_v(
                       *[a.to(cuda) for a in args], offset, cfg))
            assert np.array_equal(got.cpu().numpy(), want), (offset, cfg)
        t = np.random.default_rng(offset).integers(0, 7, (30, 30))
        wargs = prepare_weights(dist, t, topo.channels, "cpu")
        wwant = possibility_weights_plain(*wargs, offset=offset)
        for cfg in CFGS[1:]:
            _check_weights(_pinned_weights(
                *[a.to(cuda) for a in wargs], offset, cfg), wwant, True,
                topo.num_channels, f"offset {offset}, cfg {cfg}")


@pytest.mark.gpu
def test_possibility_two_launches_give_the_same_bits(cuda):
    """Fixed sum orders and no atomics: the same real T twice gives the
    same bits, V and (with eight destination tiles) W and W_drn."""
    topo = torus(16, 16)
    t = np.random.default_rng(5).random((256, 256))
    v_args = [a.to(cuda) for a in _poss_inputs(topo, False, 5, nodes=True)]
    assert torch.equal(possibility_v(*v_args, offset=0),
                       possibility_v(*v_args, offset=0))
    w_args = prepare_weights(topo.distances, t, topo.channels, cuda)
    for a, b in zip(possibility_weights_op(*w_args),
                    possibility_weights_op(*w_args)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_possibility_weights_is_v_summed(cuda):
    """Independent check through the other kernel: W = V.sum(1) and
    W_drn = V[c, n_c] (since dn[c, n_c] = 0), to float32 rounding."""
    topo = mesh2d(8, 8)
    t = np.random.default_rng(3).random((64, 64)).astype(np.float32)
    du, dn, dsn, tn, t32, dist = prepare_weights(topo.distances, t,
                                                 topo.channels, cuda)
    w, w_drn = possibility_weights_op(du, dn, dsn, tn, t32, dist)
    v = possibility_v(du, dn, t32.double(), dist, offset=1)
    ns = torch.as_tensor(topo.channels[:, 1], device=cuda)
    idx = torch.arange(topo.num_channels, device=cuda)
    np.testing.assert_array_max_ulp(
        w.cpu().numpy(), v.sum(1).float().cpu().numpy(), 1)
    np.testing.assert_array_max_ulp(
        w_drn.cpu().numpy(), v[idx, ns].float().cpu().numpy(), 1)


def _simstep_cell(topo_fn, algo, seed_points):
    """(tables on the CPU, meta, cfg, a plain mid-flight host state)."""
    topo = {"mesh4x4": lambda: mesh2d(4, 4),
            "edge5x5": lambda: mesh2d_edge_io(5, 5),
            "mesh16x16": lambda: mesh2d(16, 16),
            "mesh17x17": lambda: mesh2d(17, 17)}[topo_fn]()
    tm = traffic.uniform(topo)
    table = (build_plans_batched(topo, [tm], device="cpu")[0].table
             if algo == Algo.BIDOR else None)
    cfg = SimConfig(algo=algo, cycles=4000, warmup=50)
    tables, meta = sim.build_tables(topo, tm, table, 2, device="cpu")
    mid = sim.make_states(meta, cfg, seed_points, device="cpu")
    sim.run_cycles(tables, meta, cfg, mid, 80)
    return tables, meta, cfg, convert.state_to_numpy(mid)


def _on(tables, device):
    return convert.tables_from_numpy(
        {f: getattr(tables, f).numpy() for f in tables._fields}, device)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", list(Algo))
@pytest.mark.parametrize("topo_fn", ["mesh4x4", "edge5x5"])
def test_simstep_kernels_vs_plain(cuda, topo_fn, algo):
    """From a plain mid-flight state, chunks of 1, 40 and 997 cycles of
    the chunk kernel at the whole-network tile (one block a lane) and at
    a proper divisor (a cluster of blocks) against the plain twin: every
    state key bit for bit, the PRNG key included, and one launch a
    chunk."""
    tables, meta, cfg, host = _simstep_cell(topo_fn, algo,
                                            [(1.0, 0), (0.4, 1)])
    tcard = _on(tables, cuda)
    n = meta["N"]
    for cycles in (1, 40, 997):
        plain = convert.state_from_numpy(host, "cpu")
        sim.run_cycles(tables, meta, cfg, plain, cycles)
        want = convert.state_to_numpy(plain)
        for tile in (n, 4 if n % 4 == 0 else 5):
            card = convert.state_from_numpy(host, cuda)
            before = kernels.LAUNCHES["simstep_chunk"]
            sim.run_cycles(tcard, meta, cfg.replace(sim_tile_nodes=tile),
                           card, cycles)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["simstep_chunk"] == before + 1
            got = convert.state_to_numpy(card)
            assert set(got) == set(want)
            bad = [k for k in want if not np.array_equal(want[k], got[k])]
            assert not bad, f"tile={tile} cycles={cycles}: {bad}"


@pytest.mark.gpu
@pytest.mark.parametrize("topo_fn,tile", [("edge5x5", 25), ("edge5x5", 5),
                                          ("mesh16x16", 64)])
def test_simstep_chunk_is_deterministic(cuda, topo_fn, tile):
    """Two runs of 300 cycles from the same state give the same bits (a
    race between a cycle's phases or the blocks of a cluster would show
    here as a difference)."""
    _deterministic(topo_fn, tile, "simstep_chunk", cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [17, 1])
def test_simstep_grid_is_deterministic(cuda, tile):
    """The grid kernel at 17x17 (17 and 289 units a lane): two runs of 300
    cycles from the same state give the same bits (a race between the
    blocks of the grid would show here)."""
    _deterministic("mesh17x17", tile, "simstep_grid", cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", [Algo.VALIANT, Algo.ODDEVEN])
@pytest.mark.parametrize("topo_fn,tile,kernel", [
    ("mesh16x16", 64, "simstep_chunk"), ("mesh17x17", 17, "simstep_grid")])
def test_simstep_routing_algorithms_are_deterministic(cuda, topo_fn, tile,
                                                      kernel, algo):
    """Two-phase and adaptive routing across a cluster and the grid:
    odd-even reads its neighbours' credits in other blocks, VALIANT
    sends packets across the network; two runs agree."""
    _deterministic(topo_fn, tile, kernel, cuda, algo)


def _deterministic(topo_fn, tile, kernel, cuda, algo=Algo.XY):
    """Two 300-cycle runs of 4 lanes from one plain mid-flight state, one
    ``kernel`` launch each, must agree on every state key."""
    tables, meta, cfg, host = _simstep_cell(
        topo_fn, algo, [(1.2, 0), (0.9, 1), (0.6, 2), (0.3, 3)])
    tcard = _on(tables, cuda)
    cfg = cfg.replace(sim_tile_nodes=tile)
    runs = []
    for _ in range(2):
        card = convert.state_from_numpy(host, cuda)
        before = kernels.LAUNCHES[kernel]
        sim.run_cycles(tcard, meta, cfg, card, 300)
        assert kernels.LAUNCHES[kernel] == before + 1
        runs.append(convert.state_to_numpy(card))
    bad = [k for k in runs[0] if not np.array_equal(runs[0][k], runs[1][k])]
    assert not bad, bad
    assert int(runs[0]["eject_total"].sum()) > 0


def _plain_run(tables, meta, cfg, state, cycles, device):
    """``run_cycles`` as the plain twin computes it, on ``device``."""
    keys, rand = draw_chunk(state["key"], cycles, meta["N"], device,
                            cfg.algo, meta["NDIM"])
    cycle_fn = make_cycle_fn(meta, cfg)
    for c in range(cycles):
        cycle_fn(tables, state, {k: x[c] for k, x in rand.items()}, c)
    state["key"] = keys
    state["cycle0"] += cycles


@pytest.mark.gpu
@pytest.mark.parametrize("side,algo,lanes", [
    *((17, a, 2) for a in Algo), (64, Algo.XY, 2), (96, Algo.XY, 4)])
def test_simstep_grid_vs_plain(cuda, side, algo, lanes):
    """Meshes no cluster of the chunk kernel holds take the grid kernel
    (17x17: 289 nodes fit neither one block's shared memory nor 16
    blocks; 64x64; 96x96, whose 4 lanes take each block through 3 node
    rounds).  From a mid-flight state, chunks of 1 and 40 cycles at the
    auto tile and at another, against the plain twin on the card: every
    state key bit for bit, the PRNG key included, and one
    ``simstep_grid`` launch a chunk."""
    topo = mesh2d(side, side)
    tm = traffic.uniform(topo)
    table = (build_plans_batched(topo, [tm], device=cuda)[0].table
             if algo == Algo.BIDOR else None)
    cfg = SimConfig(algo=algo, cycles=4000, warmup=50)
    tables, meta = sim.build_tables(topo, tm, table, 2, device=cuda)
    points = [(1.0, 0), (0.4, 1), (0.7, 2), (1.2, 3)][:lanes]
    mid = sim.make_states(meta, cfg, points, device=cuda)
    _plain_run(tables, meta, cfg, mid, 80, cuda)
    host = convert.state_to_numpy(mid)
    for cycles in (1, 40):
        plain = convert.state_from_numpy(host, cuda)
        _plain_run(tables, meta, cfg, plain, cycles, cuda)
        want = convert.state_to_numpy(plain)
        for tile in (0, {17: 1, 64: 32, 96: 48}[side]):
            card = convert.state_from_numpy(host, cuda)
            before = dict(kernels.LAUNCHES)
            sim.run_cycles(tables, meta, cfg.replace(sim_tile_nodes=tile),
                           card, cycles)
            torch.cuda.synchronize()
            grew = {k: kernels.LAUNCHES[k] - before[k] for k in before}
            assert grew["simstep_grid"] == 1
            assert grew["simstep_chunk"] == 0
            got = convert.state_to_numpy(card)
            assert set(got) == set(want)
            bad = [k for k in want if not np.array_equal(want[k], got[k])]
            assert not bad, f"tile={tile} cycles={cycles}: {bad}"


ZOO_SHAPES = {
    "torus4x4x4": ("torus", (4, 4, 4)),          # 7-port routers, 3-D
    "express8x8": ("express_mesh", (8, 8)),      # 9-port routers
    "fault6x6": ("fault_region_mesh", (6, 6, (2, 2, 3, 3))),
    "multipod2x4x4": ("multipod", (2, 4, 4)),    # a half-bandwidth axis
    "express17x17": ("express_mesh", (17, 17)),  # 9 ports, the grid kernel
}
INSTR = dict(watchdog=True, wd_stall_cycles=8, wd_hop_limit=12,
             wd_throttle_cycles=16, telemetry=True, tel_epoch=16, tel_slots=4)


def _zoo_cell(name, algo, cuda, **kw):
    """(tables, meta, cfg, plain mid-flight state) of a zoo cell on the
    card: uniform traffic, BiDOR on its plan with dead channels masked
    and its unroutable pairs shed."""
    from repro_torch import core

    fn, args = ZOO_SHAPES[name]
    topo = getattr(core, fn)(*args)
    tm = traffic.uniform(topo)
    table = None
    if algo == Algo.BIDOR:
        down = topo.down_channels
        table = build_plans_batched(
            topo, [tm], down_channels=down if down.size else None,
            device=cuda)[0].table
        if table.unroutable is not None and table.unroutable.any():
            tm = np.where(table.unroutable, 0.0, tm)
    cfg = SimConfig(algo=algo, cycles=4000, warmup=50, **kw)
    tables, meta = sim.build_tables(topo, tm, table, 2, device=cuda)
    mid = sim.make_states(meta, cfg, [(1.0, 0), (0.4, 1), (0.7, 2)],
                          device=cuda)
    _plain_run(tables, meta, cfg, mid, 60, cuda)
    return tables, meta, cfg, convert.state_to_numpy(mid)


def _hold_card(tables, meta, cfg, host, cuda, cycles, tiles):
    """Chunks of ``cycles`` on the card at each of ``tiles`` against the
    plain twin on the card: every state key bit for bit, one launch."""
    plain = convert.state_from_numpy(host, cuda)
    _plain_run(tables, meta, cfg, plain, cycles, cuda)
    want = convert.state_to_numpy(plain)
    for tile in tiles:
        card = convert.state_from_numpy(host, cuda)
        before = dict(kernels.LAUNCHES)
        sim.run_cycles(tables, meta, cfg.replace(sim_tile_nodes=tile), card,
                       cycles)
        torch.cuda.synchronize()
        assert sum(kernels.LAUNCHES[k] - before[k] for k in before) == 1
        got = convert.state_to_numpy(card)
        bad = [k for k in want if not np.array_equal(want[k], got[k])]
        assert not bad, f"tile={tile} cycles={cycles}: {bad}"
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("algo", [Algo.XY, Algo.ROMM, Algo.BIDOR,
                                  Algo.VALIANT])
@pytest.mark.parametrize("name", sorted(ZOO_SHAPES))
def test_simstep_zoo_vs_plain(cuda, name, algo):
    """The zoo's router shapes (7 and 9 ports, NDIM 3, dead routers,
    fractional bandwidth on a static run) on the kernel each takes, from
    a plain mid-flight state: chunks of 1 and 40 cycles at the auto tile
    and at another, against the plain twin, bit for bit."""
    tables, meta, cfg, host = _zoo_cell(name, algo, cuda)
    other = {"express17x17": 1}.get(name, meta["N"] // 2)
    for cycles in (1, 40):
        _hold_card(tables, meta, cfg, host, cuda, cycles, (0, other))


@pytest.mark.gpu
@pytest.mark.parametrize("algo", [Algo.XY, Algo.ODDEVEN, Algo.O1TURN,
                                  Algo.BIDOR])
@pytest.mark.parametrize("name", ["fault6x6", "express17x17"])
def test_simstep_instrumented_vs_plain(cuda, name, algo):
    """The instrumented instance (a watchdog that trips, the telemetry
    rings) on the chunk and the grid kernel against the plain twin, the
    ``tel_*`` and ``wd_*`` keys bit for bit with the rest."""
    tables, meta, cfg, host = _zoo_cell(name, algo, cuda, **INSTR)
    other = {"express17x17": 1}.get(name, meta["N"] // 2)
    want = _hold_card(tables, meta, cfg, host, cuda, 40, (0, other))
    assert want["tel_cycles"].sum() == 3 * (60 + 40)


@pytest.mark.gpu
@pytest.mark.parametrize("name,tile", [("fault6x6", 12),
                                       ("express17x17", 17)])
def test_simstep_instrumented_is_deterministic(cuda, name, tile):
    """Two 300-cycle runs of the instrumented instance from one state give
    the same bits: the rings' and trips' atomics, the throttle written
    across blocks, race nowhere."""
    tables, meta, cfg, host = _zoo_cell(name, Algo.XY, cuda, **INSTR)
    cfg = cfg.replace(sim_tile_nodes=tile)
    runs = []
    for _ in range(2):
        card = convert.state_from_numpy(host, cuda)
        sim.run_cycles(tables, meta, cfg, card, 300)
        runs.append(convert.state_to_numpy(card))
    bad = [k for k in runs[0] if not np.array_equal(runs[0][k], runs[1][k])]
    assert not bad, bad
    assert runs[0]["wd_trips"].sum() > 0


@pytest.mark.gpu
def test_ctrl_golden_on_the_card(cuda):
    """``tests/goldens/ctrl_4x4.json`` through the control plane on the
    card: a link retrains at 25 % width, stale and online policies;
    integers exact, floats within rtol 1e-5."""
    from repro_torch.noc import (CampaignSpec, LinkFail, ReplanConfig,
                                 Scenario, run_campaign)

    with open(os.path.join(os.path.dirname(__file__), "goldens",
                           "ctrl_4x4.json")) as f:
        golden = json.load(f)["points"]
    fail = (LinkFail(cycle=1200, links=((5, 6), (6, 5)), bw_scale=0.25),)
    rc = ReplanConfig(epoch=400)
    spec = CampaignSpec(
        topo=mesh2d(4, 4), algos=(Algo.BIDOR,), patterns=("uniform",),
        rates=(0.35,), seeds=(0, 1), base=SimConfig(cycles=2400, warmup=400),
        scenarios=tuple(Scenario(f"linkfail_{p}", events=fail, policy=p,
                                 replan=rc) for p in ("stale", "online")))
    before = dict(kernels.LAUNCHES)
    res = run_campaign(spec, device=cuda)
    assert kernels.LAUNCHES["simstep_chunk"] > before["simstep_chunk"]
    assert kernels.LAUNCHES["possibility_v"] > before["possibility_v"]
    assert len(res.points) == len(golden)
    for p in res.points:
        r = p.result
        want = golden[f"{p.scenario}/{p.algo.name}/r{p.rate}/s{p.seed}"]
        assert (r.injected_flits, r.ejected_flits, r.in_flight_flits,
                r.reorder_value, r.meas_cycles) == (
            want["injected"], want["ejected"], want["in_flight"],
            want["reorder"], want["meas_cycles"])
        for f, v in (("throughput", r.throughput),
                     ("avg_latency", r.avg_latency),
                     ("p50_latency", r.p50_latency),
                     ("p99_latency", r.p99_latency),
                     ("link_load_max", r.link_load_max), ("lcv", r.lcv)):
            assert np.isclose(round(v, 6), want[f], rtol=1e-5, atol=1e-6), f


def test_cpu_tensors_take_the_plain_path():
    """A CPU tensor never reaches a kernel: no launch is counted."""
    before = dict(kernels.LAUNCHES)
    args = _poss_inputs(mesh2d(4, 4), True, 0)
    possibility_v(*args, offset=1)
    topo = mesh2d(4, 4)
    possibility_weights_op(*prepare_weights(
        topo.distances, traffic.uniform(topo), topo.channels, "cpu"))
    cfg = SimConfig(cycles=400, warmup=50)
    tables, meta = sim.build_tables(topo, traffic.uniform(topo), None, 2,
                                    device="cpu")
    st = sim.make_states(meta, cfg, [(0.5, 0)], device="cpu")
    sim.run_cycles(tables, meta, cfg, st, 5)
    assert kernels.LAUNCHES == before


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = _poss_inputs(mesh2d(4, 4), True, 0)
    with pytest.raises(TypeError):
        possibility_v(*[a.to(cuda) for a in args[:2]],
                      args[2].float().to(cuda), args[3].to(cuda))
    with pytest.raises(ValueError):
        possibility_v(args[0].to(cuda), args[1].to(cuda),
                      args[2].to(cuda), args[3])
    topo = mesh2d(4, 4)
    wargs = prepare_weights(topo.distances, traffic.uniform(topo),
                            topo.channels, cuda)
    with pytest.raises(TypeError):      # T must be float32
        possibility_weights_op(*wargs[:4], wargs[4].double(), wargs[5])
    with pytest.raises(ValueError):     # all on one device
        possibility_weights_op(*wargs[:5], wargs[5].cpu())


# --------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------- #
# name: (B, Sq, Skv, H, KV, D, causal, mask)
FLASH_CASES = {
    "encoder_full_ragged": (2, 150, 150, 4, 4, 64, False, None),
    "cross_prefill": (2, 16, 150, 4, 4, 64, False, None),
    "cross_decode": (3, 1, 150, 4, 4, 64, False, None),
    "cache_prefill_2d": (2, 16, 48, 4, 4, 64, False, "2d"),
    "cache_decode_2d": (2, 1, 48, 4, 4, 64, False, "2d"),
    "causal_gqa_d128": (1, 200, 200, 8, 4, 128, True, None),
    "causal_sq_lt_skv_d80": (2, 40, 100, 4, 4, 80, True, None),
    "mask_1d_d16": (2, 70, 90, 2, 1, 16, False, "1d"),
    "causal_mask_2d_d48": (2, 20, 64, 4, 2, 48, True, "2d"),
}


def _flash_inputs(b, sq, skv, h, kv, d, mask, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g).to(dtype)
    k = torch.randn((b, skv, kv, d), generator=g).to(dtype)
    v = torch.randn((b, skv, kv, d), generator=g).to(dtype)
    if mask == "1d":
        ml = torch.randint(1, skv + 1, (b,), generator=g, dtype=torch.int32)
    elif mask == "2d":
        index = torch.randint(0, skv - sq + 1, (b, 1), generator=g)
        ml = (index + torch.arange(sq)[None] + 1).to(torch.int32)
    else:
        ml = None
    return q, k, v, ml


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernel_vs_plain(cuda, case, dtype):
    """2e-5 in float32, the reference's tolerance; 8e-3 (one bfloat16
    unit) in bfloat16, tighter than the reference's 2e-2."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    b, sq, skv, h, kv, d, causal, mask = FLASH_CASES[case]
    dt = getattr(torch, dtype)
    q, k, v, ml = _flash_inputs(b, sq, skv, h, kv, d, mask, dt)
    want = flash_attention_ref(q, k, v, causal=causal, bias_mask_len=ml)
    before = kernels.LAUNCHES["flash_attention"]
    got = flash_attention(*[None if x is None else x.to(cuda)
                            for x in (q, k, v)], causal=causal,
                          mask_len=None if ml is None else ml.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dt and got.shape == (b, sq, h, d)
    tol = 2e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_flash_attention_kernel_takes_strided_views(cuda):
    """A cache slice and a broadcast length, as the decoder passes them."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    q, k, v, _ = _flash_inputs(2, 3, 64, 4, 2, 32, None, torch.float32)
    kc = torch.zeros((3, 2, 64, 2, 32))
    kc[1] = k
    ml = (torch.arange(3, dtype=torch.int32) + 30)[None].expand(2, 3)
    want = flash_attention_ref(q, k, v, causal=False, bias_mask_len=ml)
    got = flash_attention(q.to(cuda), kc.to(cuda)[1], v.to(cuda)[:, :, :],
                          causal=False, mask_len=ml.to(cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.gpu
def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(
        cuda):
    from repro_torch.kernels.flash_attention import flash_attention

    from repro_torch.kernels.flash_attention import flash_attention_ref

    q, k, v, ml = (x.to(cuda) for x in _flash_inputs(
        1, 4, 8, 2, 2, 16, "1d", torch.float32))
    # a head dim that is no multiple of 16 is padded to a built pair and
    # runs the kernel: the twin's result, at Dv
    before = kernels.LAUNCHES["flash_attention"]
    got = flash_attention(q[..., :8], k[..., :8], v[..., :8], causal=True)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_ref(*(x[..., :8].cpu() for x in (q, k, v)),
                               causal=True)
    assert got.shape == (1, 4, 2, 8)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="up to 256"):  # past the widest
        wide = torch.zeros((1, 4, 2, 264), device=cuda)
        flash_attention(wide, wide, wide, causal=True)
    with pytest.raises(TypeError):      # float16 is not a kernel type
        flash_attention(q.half(), k.half(), v.half(), causal=True)
    with pytest.raises(TypeError):      # lengths must be int32
        flash_attention(q, k, v, causal=False, mask_len=ml.long())
    with pytest.raises(ValueError):     # last dimension must be contiguous
        flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3), k,
                        v, causal=True)
    shifted = torch.empty(k.numel() + 1, device=cuda)[1:].view(k.shape)
    shifted.copy_(k)
    with pytest.raises(ValueError):     # rows must start on 16 bytes
        flash_attention(q, shifted, v, causal=True)


# name: (B, Sq, Skv, H, KV, D, causal, mask) — each lands on one path of
# the op (ops.choose_path) or on its edge: 64 packed rows (Sq * H/KV)
# still split, 65 do not; Skv not a multiple of the 64-key tile or of a
# range; GQA 64/8 at D 128 (Jamba), D 64 (whisper); (B, Sq) lengths;
# causal with Sq < Skv
PATH_CASES = {
    "split_rows64_gqa_d128": (1, 8, 200, 64, 8, 128, False, None),
    "rows65_d64": (1, 13, 100, 5, 1, 64, False, None),
    "split_jamba_decode_2d": (2, 1, 2080, 64, 8, 128, False, "2d"),
    "split_whisper_cross_decode": (2, 1, 1500, 8, 8, 64, False, None),
    "split_cross_prefill_ragged": (2, 16, 333, 4, 4, 64, False, None),
    "split_causal_sq_lt_skv": (2, 4, 150, 8, 2, 64, True, None),
    "split_mask_1d_d80": (3, 2, 90, 6, 2, 80, False, "1d"),
    "split_self_one_range_2d": (2, 16, 48, 4, 4, 64, False, "2d"),
    "wide_causal_sq_lt_skv": (1, 130, 300, 4, 2, 64, True, None),
    "wide_mask_2d_d128": (1, 100, 164, 8, 8, 128, False, "2d"),
    "wide_gqa_causal_d96": (2, 150, 150, 8, 2, 96, True, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_flash_attention_paths_vs_plain(cuda, case, dtype):
    """Each path against the twin (2e-5 fp32, 8e-3 bf16); the op counts
    one launch and its path's kernels."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.kernel import PATH_LAUNCHES
    from repro_torch.kernels.flash_attention.ops import choose_path

    b, sq, skv, h, kv, d, causal, mask = PATH_CASES[case]
    dt = getattr(torch, dtype)
    path = choose_path(dt, b, sq, h, kv, skv)
    assert path.kind == ("split" if case.startswith("split")
                         else "tc" if dtype == "bfloat16" else "simt")
    q, k, v, ml = _flash_inputs(b, sq, skv, h, kv, d, mask, dt, seed=3)
    want = flash_attention_ref(q, k, v, causal=causal, bias_mask_len=ml)
    before = kernels.LAUNCHES["flash_attention"]
    paths = dict(PATH_LAUNCHES)
    got = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), causal=causal,
                          mask_len=None if ml is None else ml.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    grew = {k: PATH_LAUNCHES[k] - paths[k] for k in paths}
    assert grew[path.kind] == 1
    assert grew["combine"] == (path.kind == "split" and path.splits > 1)
    assert got.dtype == dt and got.shape == (b, sq, h, d)
    tol = 2e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)


# MLA's head dims, Dk 96 and Dv 64 (minicpm3): name: (B, Sq, Skv, H, KV,
# causal, mask) → the path it takes; the split path at one range and
# several (with the combine), at 1, 8, 16 and 32 packed rows (the fp32
# kernel's 1, 8, 16 and 64-row tiles, the bf16 kernel's 4, 4, 4 and 2
# warps a 64-key tile), the tensor-core and CUDA-core prefill kernels
DV_CASES = {
    "mla_decode_one_range": ((4, 1, 48, 40, 40, False, "2d"), "split"),
    "mla_long_decode_ranges": ((1, 1, 2080, 40, 40, False, "2d"), "split"),
    "mla_prefill_rows16_ranges": ((2, 16, 100, 4, 4, False, "2d"),
                                  "split"),
    "mla_rows8_mask_1d": ((2, 2, 60, 8, 2, False, "1d"), "split"),
    "mla_rows32_ranges": ((1, 4, 700, 16, 2, False, None), "split"),
    "mla_wide_causal": ((2, 150, 150, 4, 4, True, None), "wide"),
    "mla_wide_mask_2d": ((1, 100, 164, 8, 8, False, "2d"), "wide"),
}


def _dv_inputs(b, sq, skv, h, kv, mask, dtype, seed):
    """Q and K of head dim 96, V of 64 sliced from a (…, 128) tensor as
    MLA slices ``kv_up``'s output: its rows start 64 elements into each
    head and its head stride is 128."""
    q, k, _, ml = _flash_inputs(b, sq, skv, h, kv, 96, mask, dtype, seed)
    g = torch.Generator().manual_seed(seed + 1)
    kvu = torch.randn((b, skv, kv, 128), generator=g).to(dtype)
    return q, k, kvu, ml


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DV_CASES))
def test_flash_attention_dv_below_dk_vs_plain(cuda, case, dtype):
    """Dk 96, Dv 64 on each path against the twin (2e-5 fp32, 8e-3
    bf16), V a strided slice; one launch, the path's kernels, and the
    combine exactly where there are several ranges."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.kernel import PATH_LAUNCHES
    from repro_torch.kernels.flash_attention.ops import _sm_count, choose_path

    (b, sq, skv, h, kv, causal, mask), kind = DV_CASES[case]
    dt = getattr(torch, dtype)
    path = choose_path(dt, b, sq, h, kv, skv, sms=_sm_count(cuda.index))
    want_kind = kind if kind == "split" else (
        "tc" if dtype == "bfloat16" else "simt")
    assert path.kind == want_kind
    assert (path.splits > 1) == ("ranges" in case)
    q, k, kvu, ml = _dv_inputs(b, sq, skv, h, kv, mask, dt, seed=7)
    v = kvu[..., 64:]
    want = flash_attention_ref(q, k, v, causal=causal, bias_mask_len=ml)
    before = kernels.LAUNCHES["flash_attention"]
    paths = dict(PATH_LAUNCHES)
    kvu_card = kvu.to(cuda)
    got = flash_attention(q.to(cuda), k.to(cuda), kvu_card[..., 64:],
                          causal=causal,
                          mask_len=None if ml is None else ml.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    grew = {n: PATH_LAUNCHES[n] - paths[n] for n in paths}
    assert grew[path.kind] == 1
    assert grew["combine"] == (path.kind == "split" and path.splits > 1)
    assert got.dtype == dt and got.shape == (b, sq, h, 64)
    tol = 2e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["split", "tc", "simt"])
def test_flash_attention_every_built_head_dim_pair_launches(cuda, kind):
    """Each (Dk, Dv) pair of ``ops.HEAD_DIMS`` on each path that builds
    it (split and tc up to ``TILED_MAX_HEAD_DIM``, simt all) against
    the twin (a pair the C side lacks would raise)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import (HEAD_DIMS, Path,
                                                         TILED_MAX_HEAD_DIM)

    dt = torch.float32 if kind == "simt" else torch.bfloat16
    path = Path(kind, 1, 128) if kind == "split" else Path(kind, 1, 0)
    sq = 2 if kind == "split" else 70
    g = torch.Generator().manual_seed(9)
    for dk, dv in HEAD_DIMS:
        if kind != "simt" and max(dk, dv) > TILED_MAX_HEAD_DIM:
            continue
        q, k, v = (torch.randn(s, generator=g).to(dt) for s in (
            (1, sq, 4, dk), (1, 100, 2, dk), (1, 100, 2, dv)))
        want = flash_attention_ref(q, k, v, causal=True)
        got = flash_attention_cuda(q.to(cuda), k.to(cuda), v.to(cuda), True,
                                   None, dk ** -0.5, path)
        tol = 2e-5 if dt == torch.float32 else 8e-3
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().numpy(), rtol=tol, atol=tol,
                                   err_msg=f"{kind} {(dk, dv)}")


# (Dk, Dv) pairs no kernel is built for: minicpm3's smoke (24, 16) and
# two more, padded by the op to (32, 32), (48, 48), (80, 80); name: (B,
# Sq, Skv, H, KV, causal, mask) → the path
PADDED_CASES = {
    "split_decode_2d": ((4, 1, 48, 4, 4, False, "2d"), "split"),
    "split_ranges": ((1, 2, 700, 8, 2, False, None), "split"),
    "wide_causal": ((2, 100, 100, 4, 4, True, None), "wide"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(24, 16), (40, 40), (72, 72)],
                         ids=["24_16", "40_40", "72_72"])
@pytest.mark.parametrize("case", sorted(PADDED_CASES))
def test_flash_attention_padded_head_dims_vs_plain(cuda, case, dims, dtype):
    """A pair no kernel is built for runs its covering pair's kernel on
    split, tc and simt: one launch, the twin's result at the true Dk's
    scale and V's own head dim (2e-5 fp32, 8e-3 bf16)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.kernel import PATH_LAUNCHES
    from repro_torch.kernels.flash_attention.ops import _sm_count, choose_path

    (b, sq, skv, h, kv, causal, mask), kind = PADDED_CASES[case]
    dk, dv = dims
    dt = getattr(torch, dtype)
    path = choose_path(dt, b, sq, h, kv, skv, sms=_sm_count(cuda.index))
    assert path.kind == (kind if kind == "split" else
                         "tc" if dtype == "bfloat16" else "simt")
    q, k, _, ml = _flash_inputs(b, sq, skv, h, kv, dk, mask, dt, seed=11)
    g = torch.Generator().manual_seed(12)
    v = torch.randn((b, skv, kv, dv), generator=g).to(dt)
    want = flash_attention_ref(q, k, v, causal=causal, bias_mask_len=ml)
    before = kernels.LAUNCHES["flash_attention"]
    paths = dict(PATH_LAUNCHES)
    got = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), causal=causal,
                          mask_len=None if ml is None else ml.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    assert PATH_LAUNCHES[path.kind] - paths[path.kind] == 1
    assert got.dtype == dt and got.shape == (b, sq, h, dv)
    assert got.is_contiguous()
    tol = 2e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["split_jamba_decode_2d",
                                  "split_self_one_range_2d",
                                  "wide_causal_sq_lt_skv"])
def test_flash_attention_two_launches_give_the_same_bits(cuda, case):
    from repro_torch.kernels.flash_attention import flash_attention

    b, sq, skv, h, kv, d, causal, mask = PATH_CASES[case]
    q, k, v, ml = (None if x is None else x.to(cuda) for x in _flash_inputs(
        b, sq, skv, h, kv, d, mask, torch.bfloat16, seed=4))
    first = flash_attention(q, k, v, causal=causal, mask_len=ml)
    second = flash_attention(q, k, v, causal=causal, mask_len=ml)
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_serve_golden_on_the_card(cuda):
    """``tests/goldens/serve_whisper_smoke.json`` (the reference's fp32
    logits and greedy tokens) through the port's serving path on the card,
    every attention call a kernel launch."""
    from repro_torch.models import encdec
    from repro_torch.serve import ServeEngine, golden

    with open(os.path.join(os.path.dirname(__file__), "goldens",
                           golden.GOLDEN_NAME)) as f:
        want = json.load(f)
    cfg = golden.config()
    tree, frames, prompts = golden.numpy_case(cfg)
    model = convert.encdec_params_from_numpy(tree, cfg, cuda)
    before = kernels.LAUNCHES["flash_attention"]
    enc = encdec.encode(cfg, model, torch.as_tensor(frames, device=cuda))
    max_len = golden.PROMPT_LEN + golden.NEW_TOKENS + golden.CACHE_SLACK
    toks, logits = ServeEngine(cfg, model, max_len).generate(
        prompts, golden.NEW_TOKENS, enc_out=enc, return_logits=True)
    n_dec = cfg.n_layers * 2 * golden.NEW_TOKENS
    assert kernels.LAUNCHES["flash_attention"] - before == (
        cfg.enc_layers + n_dec)
    logits = [x.cpu() for x in logits]
    assert not golden.mismatches(want, logits[0], logits[1:], toks, 1e-5)


# --------------------------------------------------------------------- #
# selective scan and Jamba serving
# --------------------------------------------------------------------- #
# name: (B, S, Di, Ds, h0)
SCAN_CASES = {
    "prefill_like": (2, 300, 512, 16, False),       # several staged chunks
    "prefill_h0": (2, 300, 512, 16, True),
    "decode": (4, 1, 1024, 16, True),
    "decode_b1_from_zero": (1, 1, 300, 16, False),
    "ragged_ds4": (2, 33, 100, 4, True),            # Di not a block multiple
    "ds8": (1, 96, 256, 8, False),
    "ds1_one_channel": (3, 5, 1, 1, True),
    # states that do not fill their float4s (spare states in the chunked
    # kernel's last one); Di 1; S not a multiple of the 16-step chunk
    "ds5": (2, 37, 96, 5, True),
    "ds7": (1, 50, 130, 7, False),
    "ds13": (2, 40, 70, 13, True),
    "di1_ds16": (2, 21, 1, 16, True),
    "s_not_a_chunk_multiple": (2, 45, 256, 16, True),
}


def _scan_inputs(b, s, di, ds, h0, seed=0):
    g = torch.Generator().manual_seed(seed)
    delta = 0.1 * torch.nn.functional.softplus(
        torch.randn((b, s, di), generator=g))
    a = -torch.exp(0.2 * torch.randn((di, ds), generator=g))
    bm, cm = (torch.randn((b, s, ds), generator=g) for _ in "bc")
    x = torch.randn((b, s, di), generator=g)
    return delta, a, bm, cm, x, (torch.randn((b, di, ds), generator=g)
                                 if h0 else None)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_selective_scan_kernel_vs_plain(cuda, case):
    """Against the twin on the card: h_last bit for bit (every state
    rounds alike, --fmad=false), y within 1e-5 of the twin's largest value
    (its sum over the state runs in another order).  Against the twin on
    the CPU, which ``test_torch_scan.py`` holds to the JAX reference: y
    and h_last within 1e-5 of its largest value."""
    from repro_torch.kernels.mamba_scan import (selective_scan,
                                                selective_scan_ref)

    host = _scan_inputs(*SCAN_CASES[case])
    args = [None if t is None else t.to(cuda) for t in host]
    want_y, want_h = selective_scan_ref(*args[:5], args[5])
    cpu_y, cpu_h = selective_scan_ref(*host[:5], host[5])
    before = kernels.LAUNCHES["selective_scan"]
    y, h = selective_scan(*args[:5], h0=args[5])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["selective_scan"] == before + 1
    for got, want in ((y, want_y), (h, want_h)):
        assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(h, want_h)
    lim = 1e-5 * float(want_y.abs().max())
    assert float((y - want_y).abs().max()) <= lim
    for got, want in ((y, cpu_y), (h, cpu_h)):
        lim = 1e-5 * float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= lim


@pytest.mark.gpu
@pytest.mark.parametrize("ds", [16, 13, 4])
def test_selective_scan_kernel_takes_unaligned_views(cuda, ds):
    """Contiguous views that start 4 bytes into their storage take the
    4-byte copies and loads, with the same bits as aligned copies."""
    from repro_torch.kernels.mamba_scan import selective_scan

    args = [t.to(cuda) for t in _scan_inputs(2, 19, 36, ds, True, seed=4)]

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=cuda)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    want = selective_scan(*args[:5], h0=args[5])
    got = selective_scan(*[shifted(t) for t in args[:5]],
                         h0=shifted(args[5]))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_selective_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.mamba_scan import selective_scan

    args = [t.to(cuda) for t in _scan_inputs(1, 4, 8, 17, True)]
    with pytest.raises(ValueError):     # a state wider than 16
        selective_scan(*args[:5], h0=args[5])
    args = [t.to(cuda) for t in _scan_inputs(1, 4, 8, 4, True)]
    with pytest.raises(TypeError):      # float32 only
        selective_scan(*args[:4], args[4].half())
    with pytest.raises(ValueError):     # contiguous inputs
        selective_scan(args[0], args[1].t().contiguous().t(), *args[2:5])
    with pytest.raises(ValueError):     # all on one device
        selective_scan(*args[:5], h0=args[5].cpu())


@pytest.mark.gpu
def test_jamba_golden_on_the_card(cuda):
    """``tests/goldens/serve_jamba_smoke.json`` (the reference's fp32
    logits and greedy tokens) through the port's serving path on the card,
    every Mamba layer's scan and every attention call a kernel launch."""
    from repro_torch.serve import ServeEngine, golden

    with open(os.path.join(os.path.dirname(__file__), "goldens",
                           golden.JAMBA_GOLDEN_NAME)) as f:
        want = json.load(f)
    cfg = golden.jamba_config()
    tree, prompts = golden.jamba_numpy_case(cfg)
    model = convert.hybrid_params_from_numpy(tree, cfg, cuda)
    before = dict(kernels.LAUNCHES)
    max_len = golden.JAMBA_PROMPT_LEN + golden.NEW_TOKENS + golden.CACHE_SLACK
    toks, logits = ServeEngine(cfg, model, max_len).generate(
        prompts, golden.NEW_TOKENS, return_logits=True)
    n_attn = cfg.n_layers // cfg.attn_period
    assert kernels.LAUNCHES["flash_attention"] - before["flash_attention"] \
        == n_attn * golden.NEW_TOKENS
    assert kernels.LAUNCHES["selective_scan"] - before["selective_scan"] \
        == (cfg.n_layers - n_attn) * golden.NEW_TOKENS
    logits = [x.cpu() for x in logits]
    assert not golden.mismatches(want, logits[0], logits[1:], toks, 1e-5)


@pytest.mark.gpu
def test_service_job_on_the_card(cuda, tmp_path):
    """The reference's campaign-service stage at its QUICK length through
    the port's service on the card, interrupted after every cell: the
    rows of ``tests/goldens/service_4x4.json``, every cell a flit-step
    launch, no retry; then a controlled run resumed from a mid-run
    snapshot on the card ends bit for bit as the uninterrupted run."""
    import sys

    from repro_torch import core as tcore, noc as tnoc
    from repro_torch.noc import (CampaignJob, LinkFail, ReplanConfig,
                                 Scenario, run_controlled)
    from repro_torch.obs.report import load_metrics

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    with open(os.path.join(os.path.dirname(__file__), "goldens",
                           "service_4x4.json")) as f:
        want = json.load(f)["specs"]["campaign_service"]
    spec = chip_smoke.service_specs(tcore, tnoc, quick=True)[
        "campaign_service"]
    assert tnoc.spec_fingerprint(spec) == want["fingerprint"]
    before = kernels.LAUNCHES["simstep_chunk"]
    runs = 0
    while True:
        job = CampaignJob(spec, root=str(tmp_path), job_id="q", device=cuda)
        runs += 1
        done = job.run(max_cells=1)
        assert not [m for m in load_metrics(job.metrics_path)
                    if m["event"] in ("cell_retry", "cell_error")]
        if done:
            break
    assert runs == len(job.cells)
    assert kernels.LAUNCHES["simstep_chunk"] - before >= len(job.cells)
    with open(job.csv_path) as f:
        assert f.read().splitlines() == want["rows"]

    class Rec:
        def __init__(self, preload=None):
            self.snaps, self.preload = [], preload

        def save(self, arrays, meta):
            self.snaps.append((arrays, meta))

        def load(self):
            return self.preload

    topo = mesh2d(4, 4)
    cfg = SimConfig(algo=Algo.BIDOR, cycles=1600, warmup=400,
                    watchdog=True, telemetry=True)
    scen = Scenario("f", events=(LinkFail(cycle=700, links=((5, 6), (6, 5))),
                                 ), policy="online",
                    replan=ReplanConfig(epoch=300))
    kw = dict(rates=[0.2, 0.4], seeds=[0], device=cuda)
    rec = Rec()
    base = run_controlled(topo, traffic.uniform(topo), cfg, scen,
                          checkpoint=rec, **kw)
    got = run_controlled(topo, traffic.uniform(topo), cfg, scen,
                         checkpoint=Rec(rec.snaps[2]), **kw)
    assert base.replans and got.replans == base.replans
    assert np.array_equal(got.link_peak, base.link_peak)
    for a, b in zip(got.results, base.results):
        assert a.ejected_flits == b.ejected_flits
        assert a.avg_latency == b.avg_latency
        assert np.array_equal(a.node_load, b.node_load)
    assert np.array_equal(got.telemetry.chan, base.telemetry.chan)
    assert got.watchdog == base.watchdog


def _chip_smoke():
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    return chip_smoke


@pytest.mark.gpu
def test_mltraffic_stage_on_the_card(cuda):
    """The ML-traffic stage on the card from the reference's recorded HLO
    against ``tests/goldens/mltraffic.json``: ops, totals, matrices,
    max link loads, the plan's and the refined choice tables (the
    possibility pair at N = 8), certificates; the campaign's rows at 200
    and 2 000 cycles."""
    from repro_torch import noc

    cs = _chip_smoke()
    with open(cs.MLTRAFFIC_GOLDEN) as f:
        want = json.load(f)
    before = dict(kernels.LAUNCHES)
    recs, wls, tables = cs.mltraffic_plans(np, cuda)
    assert kernels.LAUNCHES["possibility_v"] > before["possibility_v"]
    assert not cs.mltraffic_plan_mismatches(np, want, recs)
    for cycles in (200, 2000):
        res = noc.run_campaign(cs.mltraffic_spec(noc, torus(2, 4), wls,
                                                 cycles),
                               bidor_tables=tables, device=cuda)
        rows = [cs.point_record(p) for p in res.points]
        assert not cs.mltraffic_row_mismatches(want["campaign"][str(cycles)],
                                               rows)


@pytest.mark.gpu
def test_dense_golden_on_the_card(cuda):
    """``tests/goldens/serve_dense_smoke.json`` (the reference's fp32
    logits and greedy tokens of the three dense smoke configurations)
    through the port's serving path on the card, every attention call a
    kernel launch."""
    from repro_torch.configs import get_arch
    from repro_torch.serve import ServeEngine, golden

    with open(os.path.join(os.path.dirname(__file__), "goldens",
                           golden.DENSE_GOLDEN_NAME)) as f:
        want = json.load(f)
    max_len = (golden.DENSE_PROMPT_LEN + golden.DENSE_NEW_TOKENS
               + golden.CACHE_SLACK)
    for arch in golden.DENSE_ARCHS:
        cfg = get_arch(arch).smoke
        tree, prompts = golden.dense_numpy_case(cfg)
        model = convert.dense_params_from_numpy(tree, cfg, cuda)
        before = kernels.LAUNCHES["flash_attention"]
        toks, logits = ServeEngine(cfg, model, max_len).generate(
            prompts, golden.DENSE_NEW_TOKENS, return_logits=True)
        assert kernels.LAUNCHES["flash_attention"] - before \
            == cfg.n_layers * golden.DENSE_NEW_TOKENS
        logits = [x.cpu() for x in logits]
        assert not golden.mismatches(want[cfg.name], logits[0], logits[1:],
                                     toks, 1e-5), arch


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["moe", "mla"])
def test_moe_and_mla_goldens_on_the_card(cuda, name):
    """``tests/goldens/serve_moe_smoke.json`` (qwen2-moe, dbrx and Jamba
    with its experts: logits, greedy tokens, each call's aux and dropped
    pairs) and ``serve_mla_smoke.json`` (minicpm3's smoke: the compressed
    cache and the latents' expansion on the card, its attention at
    (Dk, Dv) = (24, 16) padded to the (32, 32) kernels) through the
    port's serving path on the card, every attention call a kernel
    launch."""
    from repro_torch.configs import get_arch
    from repro_torch.models.layers.ffn import moe_stats
    from repro_torch.serve import ServeEngine, golden

    gname, archs = {"moe": (golden.MOE_GOLDEN_NAME, golden.MOE_ARCHS),
                    "mla": (golden.MLA_GOLDEN_NAME, golden.MLA_ARCHS)}[name]
    with open(os.path.join(os.path.dirname(__file__), "goldens",
                           gname)) as f:
        want = json.load(f)
    max_len = (golden.DENSE_PROMPT_LEN + golden.DENSE_NEW_TOKENS
               + golden.CACHE_SLACK)
    for arch in archs:
        cfg = get_arch(arch).smoke
        tree, prompts = golden.lm_numpy_case(cfg)
        conv = (convert.hybrid_params_from_numpy if cfg.family == "hybrid"
                else convert.dense_params_from_numpy)
        model = conv(tree, cfg, cuda)
        before = kernels.LAUNCHES["flash_attention"]
        with moe_stats() as stats:
            toks, logits = ServeEngine(cfg, model, max_len).generate(
                prompts, golden.DENSE_NEW_TOKENS, return_logits=True)
        n_attn = (cfg.n_layers // cfg.attn_period if cfg.family == "hybrid"
                  else cfg.n_layers)
        assert kernels.LAUNCHES["flash_attention"] - before \
            == n_attn * golden.DENSE_NEW_TOKENS
        rec = want[cfg.name]
        logits = [x.cpu() for x in logits]
        assert not golden.mismatches(rec, logits[0], logits[1:], toks,
                                     1e-5), arch
        if cfg.is_moe:
            assert not golden.moe_mismatches(
                rec, *golden.call_stats(cfg, stats)), arch


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["vlm", "ssm"])
def test_vlm_and_ssm_goldens_on_the_card(cuda, name):
    """``tests/goldens/serve_vlm_smoke.json`` (qwen2-vl's smoke: the
    served record, every attention call a kernel launch, and the
    image-style prefill at patch-grid M-RoPE ids with its decode steps)
    and ``serve_ssm_smoke.json`` (xLSTM's smoke: no kernel launched)
    through the port on the card: tokens exact, fp32 logits within
    1e-5."""
    from repro_torch.configs import get_arch
    from repro_torch.serve import ServeEngine, golden

    gname, (arch,) = {"vlm": (golden.VLM_GOLDEN_NAME, golden.VLM_ARCHS),
                      "ssm": (golden.SSM_GOLDEN_NAME, golden.SSM_ARCHS)}[name]
    with open(os.path.join(os.path.dirname(__file__), "goldens",
                           gname)) as f:
        want = json.load(f)
    cfg = get_arch(arch).smoke
    tree, prompts = golden.lm_numpy_case(cfg)
    conv = (convert.xlstm_params_from_numpy if name == "ssm"
            else convert.dense_params_from_numpy)
    model = conv(tree, cfg, cuda)
    max_len = (golden.DENSE_PROMPT_LEN + golden.DENSE_NEW_TOKENS
               + golden.CACHE_SLACK)
    before = dict(kernels.LAUNCHES)
    toks, logits = ServeEngine(cfg, model, max_len).generate(
        prompts, golden.DENSE_NEW_TOKENS, return_logits=True)
    grew = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    flash = cfg.n_layers * golden.DENSE_NEW_TOKENS if name == "vlm" else 0
    assert grew == {k: flash if k == "flash_attention" else 0 for k in grew}
    logits = [x.cpu() for x in logits]
    assert not golden.mismatches(want[cfg.name], logits[0], logits[1:],
                                 toks, 1e-5)
    if name == "vlm":
        before = kernels.LAUNCHES["flash_attention"]
        toks, logits = golden.image_generate(cfg, model,
                                             *golden.vlm_image_case(cfg))
        assert kernels.LAUNCHES["flash_attention"] - before == \
            cfg.n_layers * (1 + golden.IMAGE_STEPS)
        logits = [x.cpu() for x in logits]
        assert not golden.mismatches(want["image"], logits[0], logits[1:],
                                     toks, 1e-5)


# ---------------------------------------------------------------------- #
# training: the forward's lse, the backward kernel, the wide head dims
# ---------------------------------------------------------------------- #
# name: (B, Sq, Skv, H, KV, Dk, Dv, causal) — causal and full, GQA, Sq ≠
# Skv (whisper's cross-attention), Dk 96 with Dv 64, a length that fills
# no 64-row tile, and internlm2's training shape
BWD_CASES = {
    "causal_square": (2, 128, 128, 4, 4, 64, 64, True),
    "full_gqa": (2, 96, 96, 8, 2, 64, 64, False),
    "causal_sq_lt_skv": (1, 40, 100, 4, 2, 32, 32, True),
    "cross_sq_ne_skv": (2, 24, 300, 8, 8, 64, 64, False),
    "dk96_dv64": (1, 70, 70, 4, 2, 96, 64, True),
    "ragged_length": (2, 77, 77, 4, 2, 128, 128, True),
    "internlm2_train": (8, 128, 128, 16, 8, 128, 128, True),
}


def _bwd_case(shape, seed):
    b, sq, skv, h, kv, dk, dv, _ = shape
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=g) for s in (
        (b, sq, h, dk), (b, skv, kv, dk), (b, skv, kv, dv), (b, sq, h, dv)))


def _op_grads(q, k, v, dout, causal):
    """(out, dq, dk, dv) of ``flash_attention`` differentiated."""
    from repro_torch.kernels.flash_attention import flash_attention

    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    out.backward(dout)
    return (out.detach(), *(x.grad for x in leaves))


def _twin_grads(q, k, v, dout, causal):
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

    o, lse = flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    return (o, *flash_attention_bwd_ref(q, k, v, o, lse, dout,
                                        causal=causal))


def _hold_grads(got, twin, exact, label):
    """fp32: each gradient within 1e-4 of its largest |value|; bf16: the
    kernels' error against the fp32 twin at most twice the bf16 twin's
    (the ratio rule of the serving checks)."""
    for name, g, t, e in zip(("out", "dq", "dk", "dv"), got, twin, exact):
        g, t, e = g.float().cpu(), t.float().cpu(), e.float().cpu()
        top = e.abs().max().item()
        if got[0].dtype == torch.float32:
            err = (g - e).abs().max().item()
            assert err <= 1e-4 * top, f"{label} {name}: {err} of {top}"
        else:
            err, ref = ((g - e).abs().max().item(),
                        (t - e).abs().max().item())
            assert err <= 2 * ref + 1e-6 * top, \
                f"{label} {name}: {err} against the twin's {ref}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_backward_kernel_vs_twin(cuda, case, dtype):
    """The op differentiated on the card (forward kernel with its lse,
    then ``flash_attention_bwd``: one backward launch) against the twins
    on the same inputs, by ``_hold_grads``' rules."""
    dt = getattr(torch, dtype)
    shape = BWD_CASES[case]
    causal = shape[-1]
    q, k, v, dout = (x.to(dt) for x in _bwd_case(shape, seed=len(case)))
    before = dict(kernels.LAUNCHES)
    got = _op_grads(*(x.to(cuda) for x in (q, k, v, dout)), causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert kernels.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    twin = _twin_grads(*(x.to(cuda) for x in (q, k, v, dout)), causal)
    exact = _twin_grads(*(x.float().to(cuda) for x in (q, k, v, dout)),
                        causal)
    _hold_grads(got, twin, exact, f"{case} {dtype}")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["tc", "simt"])
def test_flash_forward_lse_vs_twin(cuda, kind):
    """The forward kernels' lse (tc in bf16, simt in fp32 and at 256)
    against the twin's on the same inputs: natural log, (B, Sq, KV, G);
    2e-5 in fp32, 1e-4 in bf16 (the scores are fp32 sums of bf16
    products in both)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import Path

    dims = [(64, 64), (128, 128), (96, 64)] + (
        [(192, 192), (256, 256)] if kind == "simt" else [])
    for dt in ((torch.bfloat16,) if kind == "tc"
               else (torch.float32, torch.bfloat16)):
        for dk, dv in dims:
            for causal in (True, False):
                q, k, v, _ = (x.to(dt) for x in _bwd_case(
                    (2, 70, 90, 4, 2, dk, dv, causal), seed=dk))
                o, lse = flash_attention_cuda(
                    q.to(cuda), k.to(cuda), v.to(cuda), causal, None,
                    dk ** -0.5, Path(kind, 1, 0), return_lse=True)
                _, want = flash_attention_ref(q, k, v, causal=causal,
                                              return_lse=True)
                tol = 2e-5 if dt == torch.float32 else 1e-4
                assert lse.shape == want.shape == (2, 70, 2, 2)
                np.testing.assert_allclose(
                    lse.cpu().numpy(), want.numpy(), rtol=tol, atol=tol,
                    err_msg=f"{kind} {dt} {(dk, dv)} causal={causal}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(192, 192), (256, 256), (136, 136)],
                         ids=["192", "256", "136_padded"])
def test_flash_attention_wide_head_dims_on_simt(cuda, dims, dtype):
    """Head dims above 128 run on the CUDA-core kernel in both dtypes
    (136 padded to 192), forward (decode and prefill shapes) and backward,
    against the twins: forward 2e-5 fp32 / 2e-2 bf16, backward by
    ``_hold_grads``."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.kernel import PATH_LAUNCHES

    dt = getattr(torch, dtype)
    dk, dv = dims
    for sq, skv, causal in ((1, 80, False), (12, 80, False), (90, 90, True)):
        q, k, v, dout = (x.to(dt) for x in _bwd_case(
            (2, sq, skv, 4, 2, dk, dv, causal), seed=sq))
        before = PATH_LAUNCHES["simt"]
        got = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                              causal=causal)
        assert PATH_LAUNCHES["simt"] == before + 1
        want = flash_attention_ref(q, k, v, causal=causal)
        tol = 2e-5 if dt == torch.float32 else 2e-2
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().numpy(), rtol=tol, atol=tol)
        got = _op_grads(*(x.to(cuda) for x in (q, k, v, dout)), causal)
        twin = _twin_grads(*(x.to(cuda) for x in (q, k, v, dout)), causal)
        exact = _twin_grads(*(x.float().to(cuda) for x in (q, k, v, dout)),
                            causal)
        _hold_grads(got, twin, exact, f"{dims} {dtype} sq={sq}")


@pytest.mark.gpu
def test_flash_backward_two_runs_give_the_same_bits(cuda):
    """No atomics, a fixed order: the same call twice, equal bit for
    bit."""
    q, k, v, dout = (x.to(torch.bfloat16).to(cuda) for x in _bwd_case(
        BWD_CASES["internlm2_train"], seed=1))
    a = _op_grads(q, k, v, dout, True)
    b = _op_grads(q, k, v, dout, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# the tensor-core backward's (Dk, Dv) pairs; ragged shapes (no length a
# tile multiple): (B, Sq, Skv, causal) — square causal and full, a query
# block shorter than the keys, full (cross-attention) and causal (the
# diagonal aligned at the end)
TC_BWD_DIMS = tuple((d, d) for d in range(16, 129, 16)) + ((96, 64),)
TC_BWD_SHAPES = ((2, 77, 77, True), (2, 45, 130, False), (1, 40, 100, True),
                 (1, 70, 70, False))


@pytest.mark.gpu
@pytest.mark.parametrize("dims", TC_BWD_DIMS, ids=lambda p: f"{p[0]}_{p[1]}")
def test_flash_backward_tc_every_pair_vs_twins(cuda, dims):
    """The tensor-core backward (bf16, ``route="tc"``, through the op's
    autograd) at every (Dk, Dv) pair it is built for, causal and full,
    GQA 1, 2 and 8, ragged Sq and Skv, against the twins by
    ``_hold_grads``' ratio rule; one tc launch a call."""
    from repro_torch.kernels.flash_attention.kernel import BWD_PATH_LAUNCHES

    dk, dv = dims
    for b, sq, skv, causal in TC_BWD_SHAPES:
        for g in (1, 2, 8):
            shape = (b, sq, skv, 2 * g, 2, dk, dv, causal)
            q, k, v, dout = (x.to(torch.bfloat16) for x in _bwd_case(
                shape, seed=sq + g))
            before = dict(BWD_PATH_LAUNCHES)
            got = _op_grads(*(x.to(cuda) for x in (q, k, v, dout)), causal)
            torch.cuda.synchronize()
            assert BWD_PATH_LAUNCHES == {"tc": before["tc"] + 1,
                                         "simt": before["simt"]}
            twin = _twin_grads(*(x.to(cuda) for x in (q, k, v, dout)), causal)
            exact = _twin_grads(*(x.float().to(cuda)
                                  for x in (q, k, v, dout)), causal)
            _hold_grads(got, twin, exact, f"{dims} {shape}")


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["tc", "simt"])
def test_flash_backward_routes_at_one_shape(cuda, route):
    """``flash_attention_bwd_cuda(route=...)`` runs either kernel on the
    same bf16 call (internlm2's training shape and MLA's pair), each
    within the ratio rule of the twins, each giving the same bits twice;
    the tc route refuses fp32."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention.kernel import (
        BWD_PATH_LAUNCHES, flash_attention_bwd_cuda)

    for shape in (BWD_CASES["internlm2_train"], BWD_CASES["dk96_dv64"]):
        causal = shape[-1]
        q, k, v, dout = (x.to(torch.bfloat16).to(cuda)
                         for x in _bwd_case(shape, seed=7))
        o, lse = (x.contiguous() for x in flash_attention_ref(
            q, k, v, causal=causal, return_lse=True))
        scale = shape[5] ** -0.5
        before = BWD_PATH_LAUNCHES[route]
        got = flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal, scale,
                                       route=route)
        again = flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal,
                                         scale, route=route)
        torch.cuda.synchronize()
        assert BWD_PATH_LAUNCHES[route] == before + 2
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        twin = _twin_grads(q, k, v, dout, causal)
        exact = _twin_grads(*(x.float() for x in (q, k, v, dout)), causal)
        _hold_grads((twin[0], *got), twin, exact, f"{route} {shape}")
        if route == "tc":
            with pytest.raises(ValueError, match="route 'tc'"):
                flash_attention_bwd_cuda(q.float(), k.float(), v.float(),
                                         o.float(), lse, dout.float(),
                                         causal, scale, route="tc")


@pytest.mark.gpu
def test_bf16_train_step_backward_goes_through_tc(cuda):
    """A bf16 training step of internlm2's smoke config: every attention
    call's backward on the tensor-core route."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.kernel import BWD_PATH_LAUNCHES
    from repro_torch.launch.train import make_batch
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, value_and_grads

    cfg = get_arch("internlm2-1.8b").smoke.replace(dtype="bfloat16")
    state = init_train_state(cfg, OptConfig(peak_lr=1e-2, warmup_steps=0),
                             seed=0, device=cuda)
    batch = make_batch(cfg, SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=4)).get_batch(0), cuda)
    before = dict(BWD_PATH_LAUNCHES)
    loss, _, grads = value_and_grads(cfg, state["params"], batch)
    assert BWD_PATH_LAUNCHES == {"tc": before["tc"] + cfg.n_layers,
                                 "simt": before["simt"]}
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(g).all() for g in grads.values())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-base"])
def test_smoke_train_step_on_the_card_vs_twins(cuda, arch, monkeypatch):
    """One training step of the smoke config (fp32) on the card: its loss
    and gradients through the kernels (the forward on simt with its lse,
    the backward kernel: one launch each a layer's attention call)
    against the same step through the twins of both kernels (1e-5
    relative for the loss, 1e-4 of each leaf's largest gradient), then
    one ``make_train_step`` step whose loss falls on the next batch."""
    from types import SimpleNamespace

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.launch.train import make_batch
    from repro_torch.models.layers import attention
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              value_and_grads)

    cfg = get_arch(arch).smoke
    state = init_train_state(cfg, OptConfig(peak_lr=1e-2, warmup_steps=0),
                             seed=0, device=cuda)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4))
    batch = make_batch(cfg, data.get_batch(0), cuda)
    before = dict(kernels.LAUNCHES)
    loss, _, grads = value_and_grads(cfg, state["params"], batch)
    calls = (cfg.enc_layers + 2 * cfg.n_layers if cfg.family == "encdec"
             else cfg.n_layers)
    assert kernels.LAUNCHES["flash_attention"] - before["flash_attention"] \
        == calls
    assert kernels.LAUNCHES["flash_attention_bwd"] \
        - before["flash_attention_bwd"] == calls

    def twin(q, k, v, *, causal, mask_len=None, q_chunk=512, kv_chunk=512):
        assert mask_len is None
        return FlashAttention.apply(q, k, v, causal, q.shape[3] ** -0.5,
                                    q_chunk, kv_chunk, None)

    with monkeypatch.context() as m:
        m.setattr(attention, "flash_ops",
                  SimpleNamespace(flash_attention=twin))
        want_loss, _, want = value_and_grads(cfg, state["params"], batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for n, g in grads.items():
        top = float(want[n].abs().max())
        assert float((g - want[n]).abs().max()) <= 1e-4 * max(top, 1e-30), n
    step = make_train_step(cfg, OptConfig(peak_lr=1e-2, warmup_steps=0))
    state, first = step(state, batch)
    _, after = step(state, batch)
    assert float(after["loss"]) < float(first["loss"])


# name: (B, S, Di, Ds, h0, dh_last)
SCAN_BWD_CASES = {
    "chunks": (2, 64, 256, 16, True, True),
    "from_zero": (2, 64, 256, 16, False, False),
    "ragged_di_s": (2, 37, 100, 16, True, False),    # Di, S not multiples
    "ds5": (1, 29, 130, 5, False, True),
    "ds1": (3, 9, 33, 1, True, True),
    "one_step": (2, 1, 70, 13, True, True),
    "shorter_than_a_chunk": (1, 5, 128, 16, True, False),
}


def _scan_bwd_case(b, s, di, ds, h0, dh_last, seed=0):
    args = _scan_inputs(b, s, di, ds, h0, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    dy = torch.randn((b, s, di), generator=g)
    dh = torch.randn((b, di, ds), generator=g) if dh_last else None
    return args, dy, dh


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SCAN_BWD_CASES))
def test_selective_scan_backward_kernel_vs_twin(cuda, case):
    """Through the op's autograd on the card (the forward kernel, then
    ``selective_scan_bwd``: one launch each) against the backward twin on
    the card: every gradient within 1e-4 of its largest |value| (dB, dC
    and dA sum over Di, S and B in another order)."""
    from repro_torch.kernels.mamba_scan import (selective_scan,
                                                selective_scan_bwd_ref)

    host, dy, dh = _scan_bwd_case(*SCAN_BWD_CASES[case])
    args = [None if t is None else t.to(cuda) for t in host]
    dy, dh = dy.to(cuda), None if dh is None else dh.to(cuda)
    leaves = [t.clone().requires_grad_(True) for t in args if t is not None]
    before = dict(kernels.LAUNCHES)
    y, h = selective_scan(*leaves[:5], h0=leaves[5] if len(leaves) > 5
                          else None)
    got = torch.autograd.grad((y, h), leaves, (dy, torch.zeros_like(h)
                                               if dh is None else dh))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["selective_scan"] == before["selective_scan"] + 1
    for name in ("selective_scan_bwd", "selective_scan_bwd_reduce"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    want = selective_scan_bwd_ref(*args, dy, dh)
    for name, g, w in zip(("ddelta", "da", "db", "dc", "dx", "dh0"), got,
                          want):
        assert g.shape == w.shape, name
        top = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * max(top, 1e-30), name


def _scan_bwd_kernel(args, dy, dh):
    """The backward kernel on the card as the training path calls it:
    from the checkpoints the forward kernel writes."""
    from repro_torch.kernels.mamba_scan.kernel import (
        selective_scan_bwd_cuda, selective_scan_cuda)

    _, _, ckpt = selective_scan_cuda(*args, ckpt=True)
    return selective_scan_bwd_cuda(*args[:5], ckpt, dy, dh)


@pytest.mark.gpu
def test_selective_scan_backward_two_runs_give_the_same_bits(cuda):
    """No atomics, the partials summed in a fixed order: the same call
    twice, equal bit for bit."""
    host, dy, dh = _scan_bwd_case(*SCAN_BWD_CASES["chunks"], seed=3)
    args = [t.to(cuda) for t in host]
    a = _scan_bwd_kernel(args, dy.to(cuda), dh.to(cuda))
    b = _scan_bwd_kernel(args, dy.to(cuda), dh.to(cuda))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["chunks", "ragged_di_s", "ds5", "ds1",
                                  "one_step"])
def test_selective_scan_forward_writes_the_backwards_checkpoints(cuda, case):
    """The forward kernel asked for checkpoints gives y and h_last bit for
    bit as without, and checkpoint k is the state before step 8 k: h0
    (zeros without one), then the last state of the forward over the
    first 8 k steps, bit for bit."""
    from repro_torch.kernels.mamba_scan.kernel import selective_scan_cuda

    host, _, _ = _scan_bwd_case(*SCAN_BWD_CASES[case], seed=5)
    args = [None if t is None else t.to(cuda) for t in host]
    y, h = selective_scan_cuda(*args)
    y2, h2, ckpt = selective_scan_cuda(*args, ckpt=True)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    b, s, di, ds = SCAN_BWD_CASES[case][:4]
    assert ckpt.shape == (b, -(-s // 8), di, ds)
    h0 = args[5]
    assert torch.equal(ckpt[:, 0], torch.zeros_like(h) if h0 is None else h0)
    delta, a, bm, cm, x = args[:5]
    for k in range(1, ckpt.shape[1]):
        t = 8 * k
        _, upto = selective_scan_cuda(
            delta[:, :t].contiguous(), a, bm[:, :t].contiguous(),
            cm[:, :t].contiguous(), x[:, :t].contiguous(), h0)
        assert torch.equal(ckpt[:, k], upto), k


@pytest.mark.gpu
def test_smoke_jamba_train_step_on_the_card_vs_twins(cuda, monkeypatch):
    """One training step of Jamba's smoke config (fp32, its experts) on
    the card: its loss and gradients through the kernels (the scan and
    its backward in each Mamba layer, attention's forward and backward)
    against the same step through the twins of all four, 1e-5 relative
    for the loss and 1e-4 of each leaf's largest gradient; then the loss
    falls over two ``make_train_step`` steps."""
    from types import SimpleNamespace

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.kernels.mamba_scan import SelectiveScan
    from repro_torch.launch.train import make_batch
    from repro_torch.models.layers import attention, recurrent
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              value_and_grads)

    cfg = get_arch("jamba-1.5-large-398b").smoke
    state = init_train_state(cfg, OptConfig(peak_lr=1e-2, warmup_steps=0),
                             seed=0, device=cuda)
    batch = make_batch(cfg, SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=4)).get_batch(0), cuda)
    before = dict(kernels.LAUNCHES)
    loss, _, grads = value_and_grads(cfg, state["params"], batch)
    n_attn = cfg.n_layers // cfg.attn_period
    grew = {k: kernels.LAUNCHES[k] - before[k] for k in (
        "selective_scan", "selective_scan_bwd", "selective_scan_bwd_reduce",
        "flash_attention", "flash_attention_bwd")}
    assert grew == {"selective_scan": cfg.n_layers - n_attn,
                    "selective_scan_bwd": cfg.n_layers - n_attn,
                    "selective_scan_bwd_reduce": cfg.n_layers - n_attn,
                    "flash_attention": n_attn, "flash_attention_bwd": n_attn}

    def flash_twin(q, k, v, *, causal, mask_len=None, q_chunk=512,
                   kv_chunk=512):
        assert mask_len is None
        return FlashAttention.apply(q, k, v, causal, q.shape[3] ** -0.5,
                                    q_chunk, kv_chunk, None)

    def scan_twin(delta, a, b, c, x, h0=None):
        return SelectiveScan.apply(delta, a, b, c, x, h0, False)

    with monkeypatch.context() as m:
        m.setattr(attention, "flash_ops",
                  SimpleNamespace(flash_attention=flash_twin))
        m.setattr(recurrent, "scan_ops",
                  SimpleNamespace(selective_scan=scan_twin))
        mid = dict(kernels.LAUNCHES)
        want_loss, _, want = value_and_grads(cfg, state["params"], batch)
        assert kernels.LAUNCHES == mid
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for n, g in grads.items():
        top = float(want[n].abs().max())
        assert float((g - want[n]).abs().max()) <= 1e-4 * max(top, 1e-30), n
    step = make_train_step(cfg, OptConfig(peak_lr=1e-2, warmup_steps=0))
    state, first = step(state, batch)
    _, after = step(state, batch)
    assert float(after["loss"]) < float(first["loss"])


@pytest.mark.gpu
def test_train_lm_tiny_on_the_card(cuda, tmp_path, capsys):
    """The ported example on the card: the reference's lines, one
    forward and one backward flash launch a layer and microbatch, the
    loss finite."""
    from repro_torch.examples import train_lm

    before = dict(kernels.LAUNCHES)
    state = train_lm.main(["--preset", "tiny", "--steps", "3", "--batch",
                           "2", "--seq", "16", "--ckpt-every", "100",
                           "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "step    0 loss" in out and "done; final loss" in out
    calls = 3 * 2 * train_lm.PRESETS["tiny"].n_layers   # steps × microbatches
    assert kernels.LAUNCHES["flash_attention"] \
        - before["flash_attention"] == calls
    assert kernels.LAUNCHES["flash_attention_bwd"] \
        - before["flash_attention_bwd"] == calls
    assert int(state["opt"]["step"]) == 3
    assert "nan" not in out.split("done; final loss")[1]


_MESH_RANK = """
import os, sys
import torch
import torch.distributed as dist
from repro_torch.launch import train
os.environ["LOCAL_RANK"] = "0"
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=sys.argv[1], world_size=2,
                        rank=int(sys.argv[2]))
try:
    train.main(sys.argv[3:])
finally:
    dist.destroy_process_group()
"""


def _checkpoint_leaves(directory) -> list:
    from repro_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(directory))
    d = mgr._step_dir(mgr.latest_step())
    with open(os.path.join(d, "manifest.json")) as f:
        n = json.load(f)["num_leaves"]
    return [np.load(os.path.join(d, f"leaf_{i:05d}.npy")) for i in range(n)]


@pytest.mark.gpu
def test_model_split_mesh_on_the_card_equals_one_device(cuda, tmp_path):
    """internlm2's smoke on a 1x2 mesh, two gloo ranks on ``cuda:0`` (the
    shard, layer-wise gather and update path on CUDA tensors), against
    the same run on one device in this process: every step's metrics
    (not their seconds and peak bytes, which are measurements) and
    every leaf of the final checkpoint bit for bit."""
    import socket
    import subprocess
    import sys

    from repro_torch.launch import train

    argv = ["--arch", "internlm2-1.8b", "--smoke", "--steps", "4", "--seq",
            "16", "--device", "cuda", "--ckpt-every", "100"]
    train.main(argv + ["--ckpt-dir", str(tmp_path / "one"), "--metrics",
                       str(tmp_path / "one.jsonl")])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    mesh = argv + ["--mesh", "1x2", "--ckpt-dir", str(tmp_path / "mesh"),
                   "--metrics", str(tmp_path / "mesh.jsonl")]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MESH_RANK, f"tcp://localhost:{port}",
         str(r), *mesh], cwd=root, env=env) for r in range(2)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0, 0]
    def steps(name):
        rows = [json.loads(line) for line in
                (tmp_path / name).read_text().splitlines()]
        return [{k: v for k, v in r.items()
                 if k not in ("seconds", "peak_bytes")} for r in rows]

    one = steps("one.jsonl")
    assert len(one) == 4 and steps("mesh.jsonl") == one
    for a, b in zip(_checkpoint_leaves(tmp_path / "one"),
                    _checkpoint_leaves(tmp_path / "mesh")):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# the lane split over cards (multi_device)
# --------------------------------------------------------------------- #
@pytest.fixture
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs two or more CUDA devices for the lane split "
                    f"across cards ({n} visible)")
    return [torch.device("cuda", i) for i in range(n)]


def _lane_spec(multi_device):
    from repro_torch.noc import CampaignSpec

    return CampaignSpec(
        topo=mesh2d(16, 16), algos=(Algo.XY, Algo.BIDOR),
        patterns=("uniform", "transpose"), rates=(0.1, 0.3), seeds=(0, 1),
        base=SimConfig(cycles=1500, warmup=500), chunk=500,
        multi_device=multi_device)


@pytest.mark.gpu
def test_lane_split_across_cards_bit_for_bit(cards):
    """4 lanes a cell split over 2 (or 4) cards, each card holding its
    block and a copy of the tables: every statistic equal to one card's,
    and every card ran flit-step kernels (the profiler's device index)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.noc import run_campaign

    use = cards[:4] if len(cards) >= 4 else cards[:2]
    one = run_campaign(_lane_spec(False), device=cards[0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        split = run_campaign(_lane_spec(True), device=use)
    assert point_fields(split) == point_fields(one)
    busy = {e.device_index for e in prof.events()
            if "simstep" in e.name
            and e.device_type == torch.autograd.DeviceType.CUDA}
    if busy:
        assert busy == set(range(len(use)))


@pytest.mark.gpu
def test_lane_groups_state_across_cards_bit_for_bit(cards):
    """The raw state of 4 lanes after two chunks on 2 cards, every key,
    against one card; a snapshot gathered from the cards resumes on
    one."""
    topo = mesh2d(16, 16)
    cfg = SimConfig(cycles=1000, warmup=200)
    points = [(r, s) for r in (0.1, 0.3) for s in (0, 1)]
    tables, meta = sim.build_tables(topo, traffic.uniform(topo), None,
                                    cfg.num_vcs, cards[0])
    hosts = []
    for devs in (cards[:1], cards[:2]):
        lanes = sim.LaneGroups.fresh(tables, meta, cfg, points, devs)
        assert [st["fifo_size"].device for st in lanes.states] == devs
        lanes.run(300)
        lanes.run(200)
        hosts.append(lanes.to_host())
    for k in hosts[0]:
        assert np.array_equal(hosts[0][k], hosts[1][k]), k
    back = sim.LaneGroups.from_host(tables, meta, cfg, hosts[1], cards[:1])
    back.run(100)
    again = sim.LaneGroups.from_host(tables, meta, cfg, hosts[1], cards[:2])
    again.run(100)
    a, b = back.to_host(), again.to_host()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.gpu
def test_lane_split_on_one_card_named_twice(cuda):
    """One card named twice holds two blocks, each launched on it: the
    campaign equals the one-block run, bit for bit."""
    from repro_torch.noc import run_campaign

    one = run_campaign(_lane_spec(False), device=cuda)
    two = run_campaign(_lane_spec(True), device=(cuda, cuda))
    assert point_fields(two) == point_fields(one)
