"""The flit step against the reference's fused cycle (``make_cycle_fn``,
the dense path its campaign runners take on the CPU): every state key,
bit for bit — from fresh state, and from reference mid-flight states
carried in by ``convert``.  Then the tiled paths against one tile.  The
CUDA kernels are held against the plain version on the card by
``tests/test_torch_gpu.py``."""

import functools

import numpy as np
import pytest

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
from repro.noc import sim as jsim  # noqa: E402
from repro.noc.simconfig import Algo as JAlgo, SimConfig as JCfg  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.simstep import ops  # noqa: E402
from repro_torch.noc import sim as tsim  # noqa: E402
from repro_torch.noc.simconfig import Algo, SimConfig  # noqa: E402

ALGOS = list(Algo)


@functools.lru_cache(maxsize=None)
def _cell(algo: Algo, pattern: str = "uniform"):
    """(reference tables, meta, cfg; port tables, cfg) for a 4x4 cell."""
    topo = jcore.mesh2d(4, 4)
    tm = jcore.traffic.PATTERNS[pattern](topo)
    with reference():
        table = (jcore.build_plan_fast(topo, tm).table
                 if algo == Algo.BIDOR else None)
        jt, meta = jsim.build_tables(topo, tm, table, 2)
    jcfg = JCfg(algo=JAlgo(int(algo)), cycles=4000, warmup=50)
    ptable = (None if table is None else convert.plan_from_numpy(
        table.choice, table.port_tables))
    tt, _ = tsim.build_tables(tcore.mesh2d(4, 4), tm, ptable, 2,
                              device="cpu")
    tcfg = SimConfig(algo=algo, cycles=4000, warmup=50)
    return jt, meta, jcfg, tt, tcfg


def _ref_run(algo, state, cycles):
    jt, meta, jcfg, _, _ = _cell(algo)
    with reference():
        return jax.device_get(jsim.get_runner(meta, jcfg, cycles)(jt, state))


def _assert_equal(want: dict, got: dict, ctx: str):
    got = convert.state_to_numpy(got)
    assert set(want) == set(got)
    bad = [k for k in want
           if not (np.asarray(want[k]).dtype == got[k].dtype
                   and np.array_equal(np.asarray(want[k]), got[k]))]
    assert not bad, f"port diverged from the reference on {bad} ({ctx})"


@pytest.mark.parametrize("algo", ALGOS)
def test_fresh_state_150_cycles(algo):
    jt, meta, jcfg, tt, tcfg = _cell(algo)
    points = [(0.25, 0), (0.8, 1)]
    with reference():
        start = jsim.make_states(meta, jcfg, points)
    want = _ref_run(algo, start, 150)
    got = tsim.make_states(meta, tcfg, points, device="cpu")
    tsim.run_cycles(tt, meta, tcfg, got, 150)
    _assert_equal(want, got, f"fresh/{algo.name}")


def _midflight(algo, rate, seed, drain):
    """A reference state after 90 cycles at ``rate`` (optionally with
    injection stopping 20 cycles later: partially drained queues)."""
    jt, meta, jcfg, _, _ = _cell(algo)
    with reference():
        mid = dict(jax.device_get(jsim.get_runner(meta, jcfg, 90)(
            jt, jsim.make_states(meta, jcfg, [(rate, seed), (0.4, 7)]))))
    if drain:
        mid["inject_until"] = np.full_like(mid["inject_until"], 110)
    return mid


@pytest.mark.parametrize("drain", [False, True], ids=["inject", "drain"])
@pytest.mark.parametrize("algo", ALGOS)
def test_midflight_60_cycles(algo, drain):
    _, meta, _, tt, tcfg = _cell(algo)
    mid = _midflight(algo, 0.9, 3, drain)
    want = _ref_run(algo, {k: jax.numpy.asarray(v) for k, v in mid.items()},
                    60)
    got = convert.state_from_numpy(mid, device="cpu")
    tsim.run_cycles(tt, meta, tcfg, got, 60)
    _assert_equal(want, got, f"midflight/{algo.name}/drain={drain}")


@pytest.mark.parametrize("tile", [1, 4, 16])
@pytest.mark.parametrize("algo", ALGOS)
def test_tiles_match_one_tile(algo, tile):
    """Tiles of 1, 4 and 16 nodes vs the whole network as one tile, from
    a reference mid-flight state (the reference's blocked-path contract)."""
    _, meta, _, tt, tcfg = _cell(algo)
    mid = _midflight(algo, 1.1, 5, False)
    one = convert.state_from_numpy(mid, device="cpu")
    tiled = convert.state_from_numpy(mid, device="cpu")
    tsim.run_cycles(tt, meta, tcfg, one, 40)
    tsim.run_cycles(tt, meta, tcfg.replace(sim_tile_nodes=tile), tiled, 40)
    _assert_equal(convert.state_to_numpy(one), tiled, f"tile={tile}")


def test_resolve_path():
    _, meta, _, _, tcfg = _cell(Algo.XY)
    assert ops.resolve_path(meta, tcfg, 4, "cpu") == 16
    assert ops.resolve_path(meta, tcfg.replace(sim_tile_nodes=4), 4,
                            "cpu") == 4
    with pytest.raises(ValueError, match="divisor"):
        ops.resolve_path(meta, tcfg.replace(sim_tile_nodes=3), 4, "cpu")
