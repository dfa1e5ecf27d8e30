"""Public op: the flit step of one simulation cell, by device.

:func:`make_step` binds a cell's tables and lane-batched state to a
:class:`FlitStep`, whose ``run(num_cycles, keys)`` advances every lane
by a chunk of cycles in place and returns the advanced PRNG keys.

For state on the card it makes one launch a chunk of a CUDA kernel
(``csrc/simstep.cu``) that runs the key chain, the draws and every
cycle there, chosen by the cell's shape (:func:`card_kernel`):

* ``chunk``: a lane is one block or one cluster of up to 16 blocks,
  each block holding its nodes' per-input state in shared memory.
* ``grid``, for the cells no such layout fits (17x17, 64x64, 96x96;
  :func:`card_kernel` lists the square meshes): one cooperative launch
  over the whole card, the per-input state in global memory, two
  grid-wide barriers a cycle (:func:`grid_layout`).

With the watchdog or the telemetry on, either kernel runs its
instrumented instance, which routes every algorithm.

For state on the CPU it runs the plain version (:mod:`.ref`): the
chunk's draws, then per cycle ``tile_fn`` tile by tile and
``finish_fn``.  Neither stands in for the other.

:func:`resolve_path` picks the node tile.  The reference sized it to the
TPU's 10 MiB VMEM budget; on the card a tile is the nodes one CUDA
block carries (:func:`card_tile`).
"""

from __future__ import annotations

import numpy as np
import torch

from ...noc.simconfig import NF, NQ, Algo, SimConfig, check_topology
from .kernel import (INT_FIELDS, MAX_CLUSTER, MAX_P, MAX_PV, MAX_WARPS,
                     MAX_NDIM, MIN_PV, WARP, GridArgs, Launcher,
                     block_threads, draw_lanes,
                     grid_blocks_per_sm, grid_occupancy, grid_smem_bytes,
                     rounds, sim_args, smem_bytes)
from ...obs.probe import resolved_epoch
from .ref import MOV_W, N_PART, draw_chunk, make_cycle_parts

# an H100 SM (sm_90): dynamic shared memory one block may use, and the
# shared memory and threads the SM holds for all its resident blocks
SMEM_MAX = 232_448
SM_SMEM = 233_472
SM_THREADS = 2048

TABLE_DTYPES = dict(port=torch.int32, choice=torch.int32,
                    neighbor=torch.int32, recv_port=torch.int32,
                    cdf=torch.float32, p_gen=torch.float32,
                    chan_of=torch.int32, chan_bw=torch.float32,
                    coords=torch.int32, strides=torch.int32,
                    esc_port=torch.int32)


def _shapes(meta: dict, cfg: SimConfig, lanes: int) -> dict:
    """The shape of every table and state tensor the kernel indexes."""
    n, p, v, nin, c = meta["N"], meta["P"], meta["V"], meta["NIN"], meta["C"]
    s = cfg.tel_slots
    lane = {k: (lanes,) for k in (
        "rate", "cycle0", "inject_until", "measure_until", "lat_sum",
        "lat_cnt", "lat_max", "reorder_max", "injected", "offered",
        "dropped", "eject_total", "meas_cnt")}
    return dict(
        lane, port=(meta["O"], n, n), choice=(n, n), neighbor=(n, p),
        recv_port=(n, p), cdf=(n, n), p_gen=(n,), chan_of=(n, p),
        chan_bw=(c,), coords=(n, meta["NDIM"]), strides=(meta["NDIM"],),
        esc_port=(n, n),
        flits=(lanes, nin, cfg.buf_per_vc, NF),
        fifo_start=(lanes, nin), fifo_size=(lanes, nin),
        lock_op=(lanes, nin), lock_ov=(lanes, nin),
        out_held=(lanes, n, p, v), rr=(lanes, n, p),
        qpkts=(lanes, n, cfg.src_queue_pkts, NQ), q_start=(lanes, n),
        q_size=(lanes, n), prog=(lanes, n), next_seq=(lanes, n, n),
        exp_seq=(lanes, n, n), rbits=(lanes, n, n), node_fwd=(lanes, n),
        eject_flits=(lanes, n), chan_fwd=(lanes, c), chan_seen=(lanes, c),
        lat_hist=(lanes, cfg.lat_bins),
        tel_chan=(lanes, s, c), tel_counts=(lanes, s, 4),
        tel_cycles=(lanes, s), tel_lat=(lanes, s, cfg.lat_bins),
        tel_qocc=(lanes, s, cfg.tel_occ_bins), wd_stall=(lanes, nin),
        wd_throttle=(lanes, n), wd_trips=(lanes, 2))


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def chunk_tiles(n: int, p: int, v: int, lat_bins: int,
                cluster_max: int = MAX_CLUSTER) -> list[int]:
    """The tiles with which the chunk kernel lays out an ``n``-node
    lane: divisors of ``n`` that leave at most ``cluster_max`` blocks
    (one cluster) and fit a block's per-input state and head flits in
    its shared memory (``SMEM_MAX``)."""
    return [d for d in _divisors(n) if n // d <= cluster_max
            and smem_bytes(d, p, v, lat_bins) <= SMEM_MAX]


def card_kernel(n: int, p: int, v: int, lat_bins: int,
                cluster_max: int = MAX_CLUSTER) -> str:
    """The card's flit-step kernel for a shape: ``"chunk"`` where some
    tile lays a lane out as one cluster (:func:`chunk_tiles`), else
    ``"grid"``.  At P·V = 10 a block holds at most 213 nodes and a lane
    16 blocks, so a lane fits where ``n`` has a divisor from ``n / 16``
    to 213: every square mesh up to 16x16, and 18x18 to 48x48 bar 19,
    23, 29, 31, 34, 37, 38, 41, 43, 46 and 47 a side.  Those, 17x17,
    and every side from 49 to 96 bar 52 and 56 (64x64 and 96x96 among
    them) take the grid kernel."""
    if not MIN_PV <= p * v <= MAX_PV or p > MAX_P:
        raise ValueError(f"P·V = {p * v} (P = {p}) is outside the kernels' "
                         f"{MIN_PV}–{MAX_PV} inputs ({MAX_P} ports) per "
                         f"router")
    return "chunk" if chunk_tiles(n, p, v, lat_bins, cluster_max) else "grid"


def grid_max_tile(pv: int) -> int:
    """The most nodes a grid-kernel block carries a round: 32 warps of
    ``32 // pv`` nodes."""
    return MAX_WARPS * (WARP // pv)


def grid_layout(n: int, pv: int, lanes: int, tile: int, *, sms: int,
                per_sm: int | None = None) -> tuple[int, int]:
    """``(blocks, rounds)`` of the grid kernel's launch.  A unit is
    ``tile`` consecutive nodes of one lane; the ``lanes × n / tile``
    units are dealt out in runs of ``rounds`` consecutive units, one run
    a block, over at most ``sms × per_sm`` blocks, all resident at once
    (a cooperative launch).  ``per_sm`` is the card's occupancy for the
    block (:func:`.kernel.grid_occupancy`); by default the kernel's
    64-register budget (:func:`.kernel.grid_blocks_per_sm`)."""
    if per_sm is None:
        per_sm = grid_blocks_per_sm(tile, pv)
    units = lanes * (n // tile)
    rounds_ = -(-units // min(sms * per_sm, units))
    return -(-units // rounds_), rounds_


def _grid_tile(n: int, pv: int, lanes: int, tile: int, sms: int) -> int:
    """The grid kernel's tile: a divisor of ``n`` of at most
    :func:`grid_max_tile` nodes.  Auto: the fewest rounds
    (:func:`grid_layout`), then the largest tile (fewer blocks, so a
    cheaper grid barrier)."""
    most = grid_max_tile(pv)
    if tile > 0:
        if n % tile:
            raise ValueError(f"sim_tile_nodes={tile} must be a positive "
                             f"divisor of the node count ({n})")
        if tile > most:
            raise ValueError(f"sim_tile_nodes={tile} exceeds the {most} "
                             f"nodes a grid-kernel block carries a round "
                             f"({MAX_WARPS} warps of {WARP // pv})")
        return tile
    fit = [d for d in _divisors(n) if d <= most]
    return min(fit, key=lambda d: (
        grid_layout(n, pv, lanes, d, sms=sms)[1], -d))


def card_tile(n: int, p: int, v: int, lat_bins: int, lanes: int,
              tile: int = 0, *, sms: int,
              cluster_max: int = MAX_CLUSTER) -> int:
    """Nodes per block for an ``n``-node cell of ``lanes`` lanes on a
    card of ``sms`` SMs, for the kernel :func:`card_kernel` picks.

    Chunk kernel: a lane is ``n / tile`` blocks, one cluster, so a tile
    must divide ``n``, leave at most ``cluster_max`` blocks and fit its
    per-input state in a block's shared memory.  A pinned ``tile > 0``
    that breaks any of these raises ``ValueError``; it is never swapped
    for another tile or kernel.

    Auto (0): the whole network as one block where its warps hold every
    node in one round (a ``__syncthreads`` barrier costs ~0.02 µs, a
    cluster's ~0.7 µs on an H100).  Otherwise the tile of least cost,
    node rounds per phase times the waves its ``lanes × n / tile``
    blocks need on the SMs (a lane that waits for a wave waits a whole
    chunk), then the smallest: a cycle is bound by each SM's issue of
    its warps' dependent chains, so a lane spread over more SMs runs
    faster (NVIDIA H100, PERF.md).  At P·V = 10 and 4 lanes: one block
    up to 96 nodes, 16 blocks at 16x16 and at 32x32.

    The grid kernel: see :func:`_grid_tile` (64 nodes a block at 64x64,
    17 at 17x17, 96 at 96x96).
    """
    if card_kernel(n, p, v, lat_bins, cluster_max) == "grid":
        return _grid_tile(n, p * v, lanes, tile, sms)

    def why_not(d: int) -> str | None:
        if n % d:
            return f"must be a positive divisor of the node count ({n})"
        if n // d > cluster_max:
            return (f"needs {n // d} blocks a lane; one cluster holds "
                    f"{cluster_max}")
        if smem_bytes(d, p, v, lat_bins) > SMEM_MAX:
            return (f"needs {smem_bytes(d, p, v, lat_bins)} bytes of shared "
                    f"memory a block; the card has {SMEM_MAX}")
        return None

    if tile > 0:
        reason = why_not(tile)
        if reason:
            raise ValueError(f"sim_tile_nodes={tile} {reason}")
        return tile
    fit = chunk_tiles(n, p, v, lat_bins, cluster_max)

    def cost(d: int) -> int:
        per_sm = min(SM_SMEM // smem_bytes(d, p, v, lat_bins),
                     SM_THREADS // block_threads(d, p * v))
        waves = -(-lanes * (n // d) // (sms * max(per_sm, 1)))
        return rounds(d, p * v) * waves

    if n in fit and rounds(n, p * v) == 1:
        return n
    return min(fit, key=lambda d: (cost(d), d))


def resolve_path(meta: dict, cfg: SimConfig, num_lanes: int,
                 device) -> int:
    """Node-tile size for a cell.

    ``cfg.sim_tile_nodes > 0`` pins it; it must divide the node count.
    On the CPU auto (0) is the whole network, one plain pass, and any
    divisor runs tile by tile (the reference's blocked-path contract).
    On the card the tile is the nodes of one block and
    :func:`card_tile` checks a pin or picks one for the kernel
    :func:`card_kernel` chooses.  With ``tile == N``
    this is the reference's whole-array path, with a proper divisor its
    blocked path.
    """
    n = meta["N"]
    tile = int(cfg.sim_tile_nodes)
    device = torch.device(device)
    if device.type == "cpu":
        if tile > 0 and n % tile:
            raise ValueError(
                f"sim_tile_nodes={tile} must be a positive divisor of the "
                f"node count ({n})")
        return tile or n
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return card_tile(n, meta["P"], meta["V"], cfg.lat_bins, num_lanes, tile,
                     sms=sms)


class FlitStep:
    """One cell's flit step, bound to its tables and state.

    The state dict is updated in place; its tensors must stay the same
    objects while the step is in use (rebinding a key needs a new
    step)."""

    def __init__(self, meta: dict, cfg: SimConfig, tables, state: dict):
        check_topology(cfg, meta["NDIM"])
        if cfg.watchdog and tables.esc_port.numel() == 0:
            raise ValueError("the watchdog needs the escape table: "
                             "build_tables(..., escape=True)")
        self.meta, self.cfg = meta, cfg
        self.tables, self.state = tables, state
        self.device = state["fifo_size"].device
        self.lanes = state["fifo_size"].shape[0]
        self.tile_nodes = resolve_path(meta, cfg, self.lanes, self.device)
        self.ntiles = meta["N"] // self.tile_nodes
        if self.device.type == "cuda":
            self.kernel = card_kernel(meta["N"], meta["P"], meta["V"],
                                      cfg.lat_bins)
            self._bind_cuda()
        elif self.device.type == "cpu":
            self.kernel = "plain"
            self._tile_fn, self._finish_fn = make_cycle_parts(meta, cfg)
        else:
            raise ValueError(f"unsupported device {self.device}")

    # ------------------------------------------------------------- #
    def _bind_cuda(self) -> None:
        meta, cfg, t, st = self.meta, self.cfg, self.tables, self.state
        ndim, pv = meta["NDIM"], meta["P"] * meta["V"]
        if Algo(cfg.algo) == Algo.ROMM and ndim > MAX_NDIM:
            raise ValueError(f"ROMM on the card takes at most {MAX_NDIM} "
                             f"dimensions; the topology has {ndim}")
        if pv < 2 + draw_lanes(int(cfg.algo), ndim):
            raise ValueError(
                f"{Algo(cfg.algo).name} hashes its draws on "
                f"{2 + draw_lanes(int(cfg.algo), ndim)} lanes of a router; "
                f"P·V = {pv}")
        shapes = _shapes(meta, cfg, self.lanes)
        ptrs = {}
        for name, dt in TABLE_DTYPES.items():
            if name == "esc_port" and not cfg.watchdog:
                continue   # null: the watchdog's table, left out
            ptrs[name] = self._checked(name, getattr(t, name), dt,
                                       shapes[name])
        for name, x in st.items():
            if name == "key":
                continue
            dt = torch.float32 if name == "rate" else torch.int32
            ptrs[name] = self._checked(f"state[{name!r}]", x, dt,
                                       shapes[name])
        for name, on in (("tel_chan", cfg.telemetry),
                         ("wd_stall", cfg.watchdog)):
            if (name in st) != bool(on):
                raise ValueError(f"state[{name!r}] does not match the "
                                 f"config's telemetry and watchdog")
        self.key = torch.zeros((self.lanes, 2), dtype=torch.int32,
                               device=self.device)
        ptrs["key"] = self.key
        if cfg.telemetry:
            # the lanes' source-queue totals by cycle parity (scratch)
            self.tel_qsum = torch.zeros((self.lanes, 2), dtype=torch.int32,
                                        device=self.device)
            ptrs["tel_qsum"] = self.tel_qsum
        sizes = dict(
            L=self.lanes, N=meta["N"], P=meta["P"], V=meta["V"],
            NIN=meta["NIN"], C=meta["C"], O=meta["O"], B=cfg.buf_per_vc,
            Q=cfg.src_queue_pkts, PKT=cfg.packet_len,
            p_local=meta["P_LOCAL"], algo=int(cfg.algo), NDIM=ndim,
            tile_nodes=self.tile_nodes, ntiles=self.ntiles, num_cycles=0,
            warmup=cfg.warmup, lat_bins=cfg.lat_bins,
            lat_bin_width=cfg.lat_bin_width, watchdog=int(cfg.watchdog),
            wd_stall_cycles=cfg.wd_stall_cycles,
            wd_hop_limit=cfg.wd_hop_limit,
            wd_throttle_cycles=cfg.wd_throttle_cycles,
            tel_epoch=resolved_epoch(cfg), tel_slots=cfg.tel_slots,
            tel_occ_bins=cfg.tel_occ_bins)
        assert set(sizes) == set(INT_FIELDS)
        self.args = sim_args(ptrs, sizes)
        gargs = None
        if self.kernel == "grid":
            gargs = self._grid_args()
        self.launcher = Launcher(self.device, self.args, self.kernel, gargs)

    def _grid_args(self) -> GridArgs:
        """The grid kernel's launch size (the card's occupancy for its
        block) and scratch: the two credit buffers, the push targets and
        the reorder counts, kept alive on the step."""
        n, p, v = self.meta["N"], self.meta["P"], self.meta["V"]
        nin, lanes, tile = self.meta["NIN"], self.lanes, self.tile_nodes
        sms = torch.cuda.get_device_properties(
            self.device).multi_processor_count
        # occupancy at the shared memory of the budget's layout, whose
        # rounds (and so lane slots) are at least the final layout's
        _, rounds_ = grid_layout(n, p * v, lanes, tile, sms=sms)
        per_sm = grid_occupancy(tile, p, v, grid_smem_bytes(
            rounds_, self.ntiles, lanes, self.cfg.lat_bins), self.cfg.algo,
            self.cfg.watchdog or self.cfg.telemetry)
        self.grid, self.rounds = grid_layout(n, p * v, lanes, tile, sms=sms,
                                             per_sm=per_sm)
        i32 = torch.int32
        fs = torch.empty((2, lanes, nin), dtype=i32, device=self.device)
        self.scratch = dict(
            fs0=fs[0], fs1=fs[1],
            push_to=torch.empty((lanes, nin), dtype=i32, device=self.device),
            occ=torch.empty((lanes, n), dtype=i32, device=self.device))
        return sim_args(self.scratch, dict(grid=self.grid), GridArgs)

    def _checked(self, name: str, x: torch.Tensor, dtype,
                 shape: tuple) -> torch.Tensor:
        if x.device != self.device:
            raise ValueError(f"{name} is on {x.device}, not {self.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        return x

    # ------------------------------------------------------------- #
    def run(self, num_cycles: int, keys) -> np.ndarray:
        """Advance every lane by ``num_cycles`` cycles in place, starting
        from the (L, 2) uint32 PRNG ``keys``; returns the advanced keys.

        On the card: one launch of the cell's kernel, the keys in and out
        through an 8·L-byte tensor.  On the CPU: the chunk's draws, then
        cycle by cycle the plain parts."""
        keys = np.asarray(keys, np.uint32).reshape(self.lanes, 2)
        if self.kernel != "plain":
            if num_cycles <= 0:
                return keys.copy()
            self.key.copy_(torch.from_numpy(keys.view(np.int32)))
            self.args.num_cycles = int(num_cycles)
            self.launcher.launch(self.args)
            return self.key.cpu().numpy().view(np.uint32).copy()
        new_keys, rand = draw_chunk(keys, num_cycles, self.meta["N"],
                                    self.device, self.cfg.algo,
                                    self.meta["NDIM"])
        for c in range(num_cycles):
            self._plain_cycle({k: x[c] for k, x in rand.items()}, c)
        return new_keys

    def _plain_cycle(self, rand: dict, cycle: int) -> None:
        """One cycle of the plain twin, tile by tile: stages 1–6 read
        credits from a snapshot of ``fifo_size`` taken before the tiles
        run, then the receive pushes and statistics."""
        st = self.state
        lanes, n, p = self.lanes, self.meta["N"], self.meta["P"]
        fs_pre = st["fifo_size"].clone()
        mov = torch.zeros((lanes, n, p, MOV_W), dtype=torch.int32)
        parts = torch.zeros((lanes, self.ntiles, N_PART), dtype=torch.int32)
        tn = self.tile_nodes
        for i in range(self.ntiles):
            mov[:, i * tn:(i + 1) * tn], parts[:, i] = self._tile_fn(
                self.tables, st, rand, fs_pre, cycle, i * tn, tn)
        self._finish_fn(self.tables, st, mov,
                        parts.sum(1, dtype=torch.int32), cycle)

    def floor(self, num_cycles: int) -> None:
        """The card kernel's launch shape and per-cycle barriers with an
        empty body (its latency floor; the state is untouched).  Card
        only: a measurement, not a step."""
        if self.kernel == "plain":
            raise ValueError("the latency floor is a card measurement")
        self.args.num_cycles = int(num_cycles)
        self.launcher.floor(self.args)


def make_step(meta: dict, cfg: SimConfig, tables, state: dict) -> FlitStep:
    """Bind one cell's tables and state to its flit step."""
    return FlitStep(meta, cfg, tables, state)
