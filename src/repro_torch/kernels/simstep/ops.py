"""Public op: the flit step of one simulation cell, by device.

:func:`make_step` binds a cell's tables and lane-batched state to a
:class:`FlitStep`, whose ``step(u, ud, cycle)`` advances every lane by
one cycle in place.  Each cycle is two wrappers:

* :meth:`FlitStep.simstep_tile` — stages 1–6 over every node tile;
* :meth:`FlitStep.simstep_finish` — receive pushes and statistics.

For state on the card each wrapper launches its CUDA kernel
(``csrc/simstep.cu``); for state on the CPU it runs the plain version
(:mod:`.ref`), tile by tile.  Neither stands in for the other.

:func:`resolve_path` picks the node tile.  The reference sized it to the
TPU's 10 MiB VMEM budget; here a tile is one CUDA block with one thread
per node, so it is bounded by the 1024 threads a block may hold and
chosen so that the (lane × tile) grid covers the card's SMs.
"""

from __future__ import annotations

import torch

from ...noc.simconfig import NF, NQ, SimConfig, check_supported
from .kernel import INT_FIELDS, MAX_PV, Launcher, sim_args
from .ref import MOV_W, N_PART, make_cycle_parts

MAX_THREADS_PER_BLOCK = 1024
WARP = 32

TABLE_DTYPES = dict(port=torch.int32, choice=torch.int32,
                    neighbor=torch.int32, recv_port=torch.int32,
                    cdf=torch.float32, p_gen=torch.float32,
                    chan_of=torch.int32, chan_bw=torch.float32)


def _shapes(meta: dict, cfg: SimConfig, lanes: int) -> dict:
    """The shape of every table and state tensor the kernels index."""
    n, p, v, nin, c = meta["N"], meta["P"], meta["V"], meta["NIN"], meta["C"]
    lane = {k: (lanes,) for k in (
        "rate", "cycle0", "inject_until", "measure_until", "lat_sum",
        "lat_cnt", "lat_max", "reorder_max", "injected", "offered",
        "dropped", "eject_total", "meas_cnt")}
    return dict(
        lane, port=(meta["O"], n, n), choice=(n, n), neighbor=(n, p),
        recv_port=(n, p), cdf=(n, n), p_gen=(n,), chan_of=(n, p),
        chan_bw=(c,), flits=(lanes, nin, cfg.buf_per_vc, NF),
        fifo_start=(lanes, nin), fifo_size=(lanes, nin),
        lock_op=(lanes, nin), lock_ov=(lanes, nin),
        out_held=(lanes, n, p, v), rr=(lanes, n, p),
        qpkts=(lanes, n, cfg.src_queue_pkts, NQ), q_start=(lanes, n),
        q_size=(lanes, n), prog=(lanes, n), next_seq=(lanes, n, n),
        exp_seq=(lanes, n, n), rbits=(lanes, n, n), node_fwd=(lanes, n),
        eject_flits=(lanes, n), chan_fwd=(lanes, c), chan_seen=(lanes, c),
        lat_hist=(lanes, cfg.lat_bins))


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def resolve_path(meta: dict, cfg: SimConfig, num_lanes: int,
                 device) -> int:
    """Node-tile size for a cell.

    ``cfg.sim_tile_nodes > 0`` pins it (it must divide the node count
    and fit one block).  Auto (0) on the CPU is the whole network, one
    plain pass.  Auto on the card: among divisors of N that fit a block
    and fill at least one warp (or are N itself), the largest whose
    ``lanes × N / tile`` blocks still cover every SM; else the smallest
    such tile, which spreads the cell over the most SMs.  With
    ``tile == N`` this is the reference's whole-array path, with a
    proper divisor its blocked path.
    """
    n = meta["N"]
    tile = int(cfg.sim_tile_nodes)
    if tile > 0:
        if n % tile:
            raise ValueError(
                f"sim_tile_nodes={tile} must be a positive divisor of the "
                f"node count ({n})")
        if tile > MAX_THREADS_PER_BLOCK:
            raise ValueError(
                f"sim_tile_nodes={tile} exceeds the {MAX_THREADS_PER_BLOCK} "
                f"threads of one CUDA block")
        return tile
    device = torch.device(device)
    if device.type == "cpu":
        return n
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fit = [d for d in _divisors(n) if d <= MAX_THREADS_PER_BLOCK]
    full = [d for d in fit if d >= WARP or d == n]
    if not full:
        return max(fit)
    spread = [d for d in full if num_lanes * (n // d) >= sms]
    return max(spread) if spread else min(full)


class FlitStep:
    """One cell's per-cycle transition, bound to its tables and state.

    The state dict is updated in place; its tensors must stay the same
    objects while the step is in use (rebinding a key needs a new
    step)."""

    def __init__(self, meta: dict, cfg: SimConfig, tables, state: dict):
        check_supported(cfg)
        self.meta, self.cfg = meta, cfg
        self.tables, self.state = tables, state
        self.device = state["fifo_size"].device
        lanes = state["fifo_size"].shape[0]
        n, p = meta["N"], meta["P"]
        self.tile_nodes = resolve_path(meta, cfg, lanes, self.device)
        self.ntiles = n // self.tile_nodes
        i32 = torch.int32
        self.fs_pre = torch.empty_like(state["fifo_size"])
        self.mov = torch.zeros((lanes, n, p, MOV_W), dtype=i32,
                               device=self.device)
        self.parts = torch.zeros((lanes, self.ntiles, N_PART), dtype=i32,
                                 device=self.device)
        if self.device.type == "cuda":
            self._bind_cuda(lanes)
        elif self.device.type == "cpu":
            self._tile_fn, self._finish_fn = make_cycle_parts(meta, cfg)
        else:
            raise ValueError(f"unsupported device {self.device}")

    # ------------------------------------------------------------- #
    def _bind_cuda(self, lanes: int) -> None:
        meta, cfg, t, st = self.meta, self.cfg, self.tables, self.state
        if meta["P"] * meta["V"] > MAX_PV:
            raise ValueError(f"P·V = {meta['P'] * meta['V']} exceeds the "
                             f"kernel's {MAX_PV} inputs per router")
        shapes = _shapes(meta, cfg, lanes)
        ptrs = {}
        for name, dt in TABLE_DTYPES.items():
            ptrs[name] = self._checked(name, getattr(t, name), dt,
                                       shapes[name])
        for name, x in st.items():
            if name == "key":
                continue
            dt = torch.float32 if name == "rate" else torch.int32
            ptrs[name] = self._checked(f"state[{name!r}]", x, dt,
                                       shapes[name])
        ptrs.update(fs_pre=self.fs_pre, mov=self.mov, parts=self.parts)
        sizes = dict(
            L=lanes, N=meta["N"], P=meta["P"], V=meta["V"],
            NIN=meta["NIN"], C=meta["C"], O=meta["O"], B=cfg.buf_per_vc,
            Q=cfg.src_queue_pkts, PKT=cfg.packet_len,
            p_local=meta["P_LOCAL"], algo=int(cfg.algo),
            tile_nodes=self.tile_nodes, ntiles=self.ntiles, cycle=0,
            warmup=cfg.warmup, lat_bins=cfg.lat_bins,
            lat_bin_width=cfg.lat_bin_width)
        assert set(sizes) == set(INT_FIELDS)
        self.args = sim_args(ptrs, sizes)
        self.launcher = Launcher(self.device)

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

    def _check_draws(self, u: torch.Tensor, ud: torch.Tensor) -> None:
        want = (self.fs_pre.shape[0], self.meta["N"])
        for name, x in (("u", u), ("ud", ud)):
            self._checked(name, x, torch.float32, want)

    # ------------------------------------------------------------- #
    def simstep_tile(self, u: torch.Tensor, ud: torch.Tensor,
                     cycle: int) -> None:
        """Stages 1–6 for every (lane, tile), reading credits from a
        snapshot of ``fifo_size`` taken before the tiles run."""
        self._check_draws(u, ud)
        if self.device.type == "cuda":
            self.args.u = u.data_ptr()
            self.args.ud = ud.data_ptr()
            self.args.cycle = int(cycle)
            self.launcher.tile(self.args)
            return
        self.fs_pre.copy_(self.state["fifo_size"])
        tn = self.tile_nodes
        for i in range(self.ntiles):
            mov, parts = self._tile_fn(self.tables, self.state, u, ud,
                                       self.fs_pre, cycle, i * tn, tn)
            self.mov[:, i * tn:(i + 1) * tn] = mov
            self.parts[:, i] = parts

    def simstep_finish(self, cycle: int) -> None:
        """Receive pushes from ``mov`` and the statistics."""
        if self.device.type == "cuda":
            self.args.cycle = int(cycle)
            self.launcher.finish(self.args)
            return
        self._finish_fn(self.tables, self.state, self.mov,
                        self.parts.sum(1, dtype=torch.int32), cycle)

    def step(self, u: torch.Tensor, ud: torch.Tensor, cycle: int) -> None:
        """One cycle for every lane, in place."""
        self.simstep_tile(u, ud, cycle)
        self.simstep_finish(cycle)


def make_step(meta: dict, cfg: SimConfig, tables, state: dict) -> FlitStep:
    """Bind one cell's tables and state to its flit step."""
    return FlitStep(meta, cfg, tables, state)
