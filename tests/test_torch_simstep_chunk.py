"""The pieces the chunk kernel computes differently from the plain
twin, held on the CPU: the per-node draws (``node_uniform``) against
``jax.random.uniform`` and ``prng.uniform``; the O(1) reorder count
against the full-row scan over a run from a reference mid-flight state;
``FlitStep.run`` against the per-cycle loop; the card's tile layout
(``card_tile``), the kernel it picks by shape (``card_kernel``: the
chunk kernel, or the grid kernel where no cluster holds a lane), the
grid kernel's launch size (``grid_layout``) and the refusals; the
launch records against the C structs.  The kernels themselves are held
against the twin on the card by ``tests/test_torch_gpu.py``."""

import os
import re

import numpy as np
import pytest
import torch

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)
from test_torch_simstep import _cell, _midflight

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

from repro_torch import convert, prng  # noqa: E402
from repro_torch.kernels.simstep import (card_kernel,  # noqa: E402
                                         card_tile, chunk_tiles, draw_chunk,
                                         grid_layout, make_cycle_fn,
                                         make_cycle_parts, make_step,
                                         node_uniform, reorder_occupancy,
                                         reorder_occupancy_update)
from repro_torch.kernels.simstep import kernel as skernel  # noqa: E402
from repro_torch.noc import sim as tsim  # noqa: E402
from repro_torch.noc.simconfig import (F_SRC, F_TAIL, NF, Algo,  # noqa: E402
                                       SimConfig)

KEYS = [prng.key(0), prng.fold_in(prng.key(11), 12345),
        prng.split(prng.key(3), 5)[2], tsim.point_key(1, 0.55)]


@pytest.mark.parametrize("n", [1, 2, 16, 25, 1024])
def test_node_uniform_equals_uniform(n):
    """Node by node, the draw the kernel hashes for each node alone is
    the whole vector's entry, at odd N (where block h − 1 hashes
    (h − 1, 0)) and even N, for several keys; and the vector is JAX's."""
    for k in KEYS:
        got = node_uniform(k, np.arange(n), n)
        want = prng.uniform(k, n)
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        with reference():
            jwant = np.asarray(jax.device_get(jax.random.uniform(k, (n,))))
        assert np.array_equal(got.view(np.uint32), jwant.view(np.uint32))


def test_node_uniform_broadcasts_over_lanes_and_cycles():
    """A (cycles, L, 2) key chain and per-node indices: the kernel's draw
    for every (cycle, lane, node) equals ``draw_chunk``'s."""
    keys = np.stack([tsim.point_key(s, r) for r, s in [(0.2, 0), (0.9, 4)]])
    n = 25
    _, kg, kd, _ = prng.chain_keys(keys, 30)
    _, rand = draw_chunk(keys, 30, n, "cpu")
    nodes = np.arange(n)
    for keyset, want in ((kg, rand["u"]), (kd, rand["ud"])):
        got = node_uniform(keyset[..., None, :], nodes, n)
        assert np.array_equal(got.view(np.uint32),
                              want.numpy().view(np.uint32))


@pytest.mark.parametrize("algo", list(Algo))
def test_reorder_count_incremental_equals_full_scan(algo):
    """150 cycles of the plain twin from a reference mid-flight state
    whose reorder windows are filled with random bits (in-order routing
    alone leaves them empty): the count updated by popc(new) − popc(old)
    at each tail ejection equals the full-row scan after every cycle."""
    _, meta, _, tt, tcfg = _cell(algo)
    mid = _midflight(algo, 1.1, 5, False)
    rng = np.random.default_rng(int(algo))
    mid["rbits"] = rng.integers(0, 2**32, mid["rbits"].shape,
                                dtype=np.uint64).astype(np.uint32)
    st = convert.state_from_numpy(mid, device="cpu")
    n, p_local = meta["N"], meta["P_LOCAL"]
    tile_fn, finish_fn = make_cycle_parts(meta, tcfg)
    _, rand = draw_chunk(mid["key"], 150, n, "cpu", algo, meta["NDIM"])
    lanes = st["fifo_size"].shape[0]
    li = torch.arange(lanes)[:, None]
    nodes = torch.arange(n)
    occ = reorder_occupancy(st["rbits"])
    moved = 0
    for c in range(150):
        mov, parts = tile_fn(tt, st, {k: x[c] for k, x in rand.items()},
                             st["fifo_size"].clone(), c, 0, n)
        wl = mov[:, :, p_local]
        tail = (wl[..., NF + 3] != 0) & (wl[..., F_TAIL] != 0)
        src = torch.where(tail, wl[..., F_SRC], 0).long()
        old = st["rbits"][li, nodes, src].clone()
        finish_fn(tt, st, mov, parts, c)
        new = st["rbits"][li, nodes, src]
        moved += int((old != new).sum())
        occ = reorder_occupancy_update(occ, old, new)
        assert torch.equal(occ, reorder_occupancy(st["rbits"])), c
    assert moved > 50            # the windows really moved


@pytest.mark.parametrize("algo", list(Algo))
def test_flitstep_run_equals_per_cycle_loop(algo):
    """``FlitStep.run`` on the CPU (at the whole network and at tiles of
    4) equals the chunk's draws followed by the plain cycle, cycle by
    cycle, every state key, and returns the same advanced keys."""
    _, meta, _, tt, tcfg = _cell(algo)
    mid = _midflight(algo, 0.9, 3, False)
    want = convert.state_from_numpy(mid, device="cpu")
    keys, rand = draw_chunk(mid["key"], 60, meta["N"], "cpu", algo,
                            meta["NDIM"])
    cycle_fn = make_cycle_fn(meta, tcfg)
    for c in range(60):
        cycle_fn(tt, want, {k: x[c] for k, x in rand.items()}, c)
    for tile in (0, 4):
        got = convert.state_from_numpy(mid, device="cpu")
        step = make_step(meta, tcfg.replace(sim_tile_nodes=tile), tt, got)
        new_keys = step.run(60, mid["key"])
        assert np.array_equal(new_keys, keys) and new_keys.dtype == np.uint32
        bad = [k for k in want if k != "key"
               and not torch.equal(want[k], got[k])]
        assert not bad, f"tile={tile}: {bad}"
    assert np.array_equal(make_step(meta, tcfg, tt, got).run(0, keys), keys)


def test_card_tile_layouts():
    """The card's auto tile at P·V = 10: the whole network as one block
    while one round of 32 warps holds it (up to 96 nodes), else the
    cluster of the most blocks that needs the fewest node rounds times
    waves of the SMs: 16 blocks at 16x16 and 32x32, fewer and larger
    blocks once the lanes outgrow a wave."""
    assert card_tile(16, 5, 2, 96, 4, sms=132) == 16
    assert card_tile(25, 5, 2, 96, 4, sms=132) == 25
    assert card_tile(96, 5, 2, 96, 4, sms=132) == 96
    assert card_tile(100, 5, 2, 96, 4, sms=132) == 10
    assert card_tile(256, 5, 2, 96, 4, sms=132) == 16
    assert card_tile(1024, 5, 2, 96, 4, sms=132) == 64
    assert card_tile(1024, 5, 2, 96, 4, sms=132, cluster_max=8) == 128
    # 1 024 lanes of 16x16: 16-node blocks need more waves than 32-node
    assert card_tile(256, 5, 2, 96, 1024, sms=132) == 32
    assert card_tile(256, 5, 2, 96, 1024, sms=13_200) == 16
    for tile in (5, 25):
        assert card_tile(25, 5, 2, 96, 4, tile, sms=132) == tile


@pytest.mark.parametrize("n,tile,cluster_max,match", [
    (1024, 64, 8, "needs 16 blocks a lane; one cluster holds 8"),
    (1024, 32, 16, "needs 32 blocks a lane; one cluster holds 16"),
    (25, 1, 16, "needs 25 blocks"),
    (16, 2, 4, "needs 8 blocks a lane; one cluster holds 4"),
    (1024, 1024, 16, "bytes of shared memory"),
    (256, 256, 16, "bytes of shared memory"),
    (25, 3, 8, "divisor"),
    (289, 3, 16, "divisor"),                 # 17x17: the grid kernel's
    (4096, 128, 16, "96 nodes a grid-kernel block"),   # rules, 64x64
])
def test_card_tile_refuses_a_pinned_tile_it_cannot_lay_out(
        n, tile, cluster_max, match):
    """A pinned tile the card cannot lay out raises ``ValueError``; it is
    never swapped for another tile or kernel."""
    with pytest.raises(ValueError, match=match):
        card_tile(n, 5, 2, 96, 4, tile, sms=132, cluster_max=cluster_max)


def test_card_tile_refuses_routers_past_the_kernel():
    with pytest.raises(ValueError, match="inputs"):
        card_tile(64, 9, 4, 96, 4, sms=132)                # P·V = 36
    with pytest.raises(ValueError, match="inputs"):
        card_tile(64, 1, 1, 96, 4, sms=132)                # P·V = 1
    with pytest.raises(ValueError, match="inputs"):
        card_kernel(4096, 17, 1, 96)                       # P = 17


@pytest.mark.parametrize("side,kernel", [
    (4, "chunk"), (5, "chunk"), (16, "chunk"), (17, "grid"), (18, "chunk"),
    (19, "grid"), (32, "chunk"), (34, "grid"), (48, "chunk"), (64, "grid"),
    (96, "grid")])
def test_card_kernel_by_shape(side, kernel):
    """The chunk kernel where some tile lays a lane out as one cluster of
    at most 16 blocks within a block's shared memory, else the grid
    kernel: a
    17x17 lane (289 nodes) fits neither one block nor 17 blocks of 17, a
    64x64 one (4 096) needs blocks of 256 nodes."""
    n = side * side
    assert card_kernel(n, 5, 2, 96) == kernel
    assert bool(chunk_tiles(n, 5, 2, 96)) == (kernel == "chunk")
    assert card_kernel(n, 5, 2, 96, cluster_max=8) == (
        "chunk" if side in (4, 5, 16, 18, 32) else "grid")


@pytest.mark.parametrize("side,lanes,tile,blocks,rounds", [
    (17, 1, 17, 17, 1), (17, 4, 17, 68, 1), (17, 64, 17, 544, 2),
    (64, 1, 64, 64, 1), (64, 4, 64, 128, 2), (64, 64, 16, 656, 25),
    (96, 1, 96, 96, 1), (96, 4, 96, 128, 3), (96, 64, 96, 131, 47)])
def test_grid_layout(side, lanes, tile, blocks, rounds):
    """The grid kernel on 132 SMs at P·V = 10, at its 64-register budget
    (an SM holds 32 of its warps, so blocks of ``⌈tile / 3⌉`` warps fit
    ``32 // warps`` an SM): the auto tile takes the fewest rounds, then
    the largest tile; the ``lanes × n / tile`` units go out in runs of
    ``rounds``, one a block, and no block is left without a unit.  A pin
    that divides N and fits a block is kept."""
    n = side * side
    assert card_kernel(n, 5, 2, 96) == "grid"
    assert card_tile(n, 5, 2, 96, lanes, sms=132) == tile
    assert grid_layout(n, 10, lanes, tile, sms=132) == (blocks, rounds)
    units = lanes * n // tile
    assert (blocks - 1) * rounds < units <= blocks * rounds
    assert blocks <= 132 * skernel.grid_blocks_per_sm(tile, 10)
    assert skernel.grid_threads(tile, 10) == 32 * -(-tile // 3)
    assert card_tile(n, 5, 2, 96, lanes, 1, sms=132) == 1
    # a card whose occupancy beats the budget takes no more rounds
    more = 2 * skernel.grid_blocks_per_sm(tile, 10)
    assert grid_layout(n, 10, lanes, tile, sms=132, per_sm=more)[1] <= rounds


def _c_fields(source: str, struct: str):
    """(pointer fields, int fields) of a ``struct`` in a CUDA source, in
    order; and the source."""
    path = os.path.join(os.path.dirname(skernel.__file__), "..", "csrc",
                        source)
    with open(path) as f:
        src = f.read()
    body = src[src.index(f"struct {struct} {{"):]
    body = body[:body.index("};")]
    ptrs = re.findall(r"^\s*(?:const\s+)?\w+\*\s+(\w+);", body, re.M)
    ints = [name for line in re.findall(r"^\s*int\s+([^*;][^;]*);", body,
                                        re.M)
            for name in re.split(r",\s*", line.strip())]
    return tuple(ptrs), tuple(ints), src


def test_launch_record_matches_the_c_struct():
    """The ctypes record lists ``struct SimArgs``'s fields in its order,
    pointers first, and the block layout's word count is the source's."""
    ptrs, ints, src = _c_fields("simstep.cu", "SimArgs")
    assert ptrs == skernel.PTR_FIELDS
    assert ints == skernel.INT_FIELDS
    lay = src[src.index("inline Layout layout("):]
    lay = lay[:lay.index("return s;")]
    per = {"ti": 0, "hm": 0, "po": 0, "pm": 0, "tn": 0, "bins": 0,
           "N_SUMS": 0, "N_KEYS": 0}
    for term in re.findall(r"w \+= (\w+);", lay):
        per[term] += 1
    tile, p, v, bins = 7, 5, 2, 96
    words = (per["ti"] * tile * p * v + per["hm"] * tile * p * v * NF
             + per["po"] * tile * p
             + per["pm"] * tile * p * NF + per["tn"] * tile
             + per["bins"] * bins + 16 * per["N_SUMS"] + 18 * per["N_KEYS"])
    assert re.search(r"N_SUMS = 16;", src) and re.search(r"N_KEYS = 18;",
                                                         src)
    assert skernel.N_KEYS == 18
    assert 4 * words == skernel.smem_bytes(tile, p, v, bins)


def test_grid_record_matches_the_c_struct():
    """The grid kernel's ctypes record lists ``struct GridArgs``'s fields
    in its order, pointers first, and a block's shared memory per lane
    slot is the source's (keys, sums, four lane words, the histogram)."""
    ptrs, ints, src = _c_fields("simstep.cu", "GridArgs")
    assert ptrs == skernel.GRID_PTR_FIELDS
    assert ints == skernel.GRID_INT_FIELDS
    assert {f for f, _ in skernel.GridArgs._fields_} == set(ptrs + ints)
    fixed = re.search(r"G_HIST = N_KEYS \+ N_SUMS \+ (\d+);", src)
    assert fixed and 18 + 16 + int(fixed.group(1)) == skernel._GRID_SLOT_FIXED
    assert re.search(r"return G_HIST \+ bins;", src)
    # runs of 3 units at 17 units a lane span at most 2 of the 4 lanes
    assert skernel.grid_smem_bytes(3, 17, 4, 96) == 4 * 2 * (38 + 96)
    assert skernel.grid_smem_bytes(40, 17, 64, 96) == 4 * 4 * (38 + 96)


def test_the_cpu_path_never_builds_the_record():
    """A CPU step keeps no launch record: nothing there reaches ctypes."""
    _, meta, _, tt, tcfg = _cell(Algo.XY)
    st = tsim.make_states(meta, tcfg, [(0.5, 0)], device="cpu")
    step = make_step(meta, SimConfig(cycles=400, warmup=50), tt, st)
    assert not hasattr(step, "args") and not hasattr(step, "launcher")
    with pytest.raises(ValueError, match="card"):
        step.floor(10)
