"""Launch binding of ``csrc/simstep.cu`` (ctypes, plain C ABI).

Both card kernels take one :class:`SimArgs` record: every table and
state pointer of a simulation cell (the telemetry rings and the
watchdog's arrays null where the config leaves them off), the lanes'
PRNG key words, the telemetry's queue-total scratch and the sizes.  The record is built once per cell (:func:`sim_args`); a chunk
sets ``num_cycles`` and makes one ctypes call.  The grid kernel takes a
second record, :class:`GridArgs`: its global-memory scratch (the two
credit buffers, the push targets, the reorder counts) and the number of
blocks of its cooperative launch.  The field orders must match
``struct SimArgs`` and ``struct GridArgs`` in the source.
"""

from __future__ import annotations

import ctypes

import torch

from ...noc.simconfig import NF
from .. import LAUNCHES
from ..build import library

PTR_FIELDS = (
    "port", "choice", "neighbor", "recv_port", "cdf", "p_gen", "chan_of",
    "chan_bw", "coords", "strides", "key", "flits", "fifo_start", "fifo_size", "lock_op",
    "lock_ov", "out_held", "rr", "qpkts", "q_start", "q_size", "prog",
    "next_seq", "rate", "cycle0", "inject_until", "measure_until",
    "exp_seq", "rbits", "node_fwd", "eject_flits", "chan_fwd", "chan_seen",
    "lat_sum", "lat_cnt", "lat_max", "lat_hist", "reorder_max", "injected",
    "offered", "dropped", "eject_total", "meas_cnt", "esc_port",
    "tel_chan", "tel_counts", "tel_cycles", "tel_lat", "tel_qocc",
    "tel_qsum", "wd_stall", "wd_throttle", "wd_trips",
)
INT_FIELDS = (
    "L", "N", "P", "V", "NIN", "C", "O", "B", "Q", "PKT", "p_local", "algo",
    "NDIM", "tile_nodes", "ntiles", "num_cycles", "warmup", "lat_bins",
    "lat_bin_width", "watchdog", "wd_stall_cycles", "wd_hop_limit",
    "wd_throttle_cycles", "tel_epoch", "tel_slots", "tel_occ_bins",
)
GRID_PTR_FIELDS = ("fs0", "fs1", "push_to", "occ")
GRID_INT_FIELDS = ("grid",)
# the chunk kernel's compile-time bounds: inputs per router (P·V), ports, and
# the blocks of one lane's cluster (past 8, the non-portable size Hopper
# allows)
MIN_PV = 2
MAX_PV = 32
MAX_P = 16
MAX_CLUSTER = 16
WARP = 32
MAX_WARPS = 32
# ROMM's coordinates on the card (its per-node draws, one lane each)
MAX_NDIM = 4
# int32 words of a block's shared memory besides its per-node arrays
# (``struct Layout`` in the source): the per-block sums and the keys (two
# cycles of eight words and the chain's two)
N_KEYS = 18
_FIXED_WORDS = 16 + N_KEYS


def draw_lanes(algo: int, ndim: int) -> int:
    """Lanes of a router's segment that hash a pushed packet's draws
    besides ``u`` and ``ud`` (``algo_draw_lanes`` in the source): one
    for O1TURN, two for VALIANT (the high and low words), ``ndim`` for
    ROMM."""
    return {2: 1, 3: 2, 4: ndim}.get(int(algo), 0)


def smem_bytes(tile: int, p: int, v: int, lat_bins: int) -> int:
    """Shared-memory bytes of a block of ``tile`` nodes (``layout`` in
    the source): per input ten words and the NF words of its head flit;
    per (node, port) three and the NF words of the flit it pushes; six
    per node; the latency histogram and a few fixed words."""
    return 4 * ((10 + NF) * tile * p * v + (3 + NF) * tile * p + 6 * tile
                + lat_bins + _FIXED_WORDS)


def node_warps(tile: int, pv: int) -> int:
    """Warps that carry nodes: one segment of ``pv`` lanes per node,
    ``32 // pv`` nodes a warp, at most 32 warps (more nodes run in
    rounds)."""
    per_warp = WARP // pv
    return min(-(-tile // per_warp), MAX_WARPS)


def block_threads(tile: int, pv: int) -> int:
    """Threads of a block: the node warps and, where a block has room,
    one spare warp that runs the key chain."""
    w = node_warps(tile, pv)
    return WARP * (w + 1 if w < MAX_WARPS else w)


def rounds(tile: int, pv: int) -> int:
    """Node rounds each warp runs per phase of a cycle."""
    return -(-tile // (node_warps(tile, pv) * (WARP // pv)))


# The grid kernel: per lane slot of a block, the keys, the sums, four lane
# constants and the latency histogram (``grid_slot_words`` in the source);
# a 64-register budget a thread (its launch bounds), so an SM holds 32 of
# its warps; and at most 32 resident blocks an SM (sm_90).
_GRID_SLOT_FIXED = N_KEYS + 16 + 4
GRID_REG_WARPS = 32
SM_BLOCKS = 32


def grid_threads(tile: int, pv: int) -> int:
    """Threads of a grid-kernel block: one segment of ``pv`` lanes per
    node of its unit of ``tile`` nodes, ``32 // pv`` nodes a warp."""
    return WARP * -(-tile // (WARP // pv))


def grid_lane_slots(rounds: int, tiles_a_lane: int, lanes: int) -> int:
    """Lanes a block's ``rounds`` consecutive units can span."""
    return min((rounds - 1) // tiles_a_lane + 2, lanes)


def grid_smem_bytes(rounds: int, tiles_a_lane: int, lanes: int,
                    lat_bins: int) -> int:
    """Shared-memory bytes of a grid-kernel block."""
    return 4 * grid_lane_slots(rounds, tiles_a_lane, lanes) * (
        _GRID_SLOT_FIXED + lat_bins)


def grid_blocks_per_sm(tile: int, pv: int) -> int:
    """Grid-kernel blocks an SM holds at the kernel's 64-register budget
    (what cudaOccupancyMaxActiveBlocksPerMultiprocessor gives when the
    compiler uses all 64; fewer registers can only raise it)."""
    return min(GRID_REG_WARPS // (grid_threads(tile, pv) // WARP),
               SM_BLOCKS)


class SimArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in PTR_FIELDS]
                + [(f, ctypes.c_int) for f in INT_FIELDS])


class GridArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in GRID_PTR_FIELDS]
                + [(f, ctypes.c_int) for f in GRID_INT_FIELDS])


def sim_args(pointers: dict, sizes: dict, record=SimArgs):
    """A launch record (:class:`SimArgs` or :class:`GridArgs`) from
    tensors (by field name; a missing one is null) and ints."""
    args = record()
    ptrs = PTR_FIELDS if record is SimArgs else GRID_PTR_FIELDS
    ints = INT_FIELDS if record is SimArgs else GRID_INT_FIELDS
    for f in ptrs:
        x = pointers.get(f)
        setattr(args, f, x.data_ptr() if x is not None else None)
    for f in ints:
        setattr(args, f, int(sizes[f]))
    return args


def _fn(name: str, *records):
    fn = getattr(library("simstep"), name)
    fn.argtypes = [*(ctypes.POINTER(r) for r in records), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(what: str, c_value, binding_value) -> None:
    if c_value != binding_value:
        raise RuntimeError(f"simstep {what} mismatch: C {c_value}, binding "
                           f"{binding_value}")


class Launcher:
    """The launch functions of one cell's card kernel (``"chunk"`` or
    ``"grid"``), resolved once per cell; the C side's layout arithmetic
    is checked against the binding's."""

    def __init__(self, device: torch.device, args: SimArgs, kernel: str,
                 gargs: GridArgs | None = None):
        lib = library("simstep")
        _check("SimArgs bytes", lib.simstep_args_size(),
               ctypes.sizeof(SimArgs))
        self.kernel, self.gargs, self.device = kernel, gargs, device
        pv = args.P * args.V
        if kernel == "chunk":
            _check("chunk block (smem bytes, threads)",
                   (lib.simstep_smem_bytes(args.tile_nodes, args.P, args.V,
                                           args.lat_bins),
                    lib.simstep_block_threads(args.tile_nodes, args.P,
                                              args.V)),
                   (smem_bytes(args.tile_nodes, args.P, args.V,
                               args.lat_bins),
                    block_threads(args.tile_nodes, pv)))
            self.launch_fn = _fn("simstep_chunk_launch", SimArgs)
            self.floor_fn = _fn("simstep_floor_launch", SimArgs)
            self.extra = ()
            return
        _check("GridArgs bytes", lib.simstep_grid_args_size(),
               ctypes.sizeof(GridArgs))
        n_rounds = -(-args.L * args.ntiles // gargs.grid)
        _check("grid block (smem bytes, threads)",
               (lib.simstep_grid_smem_bytes(n_rounds, args.ntiles, args.L,
                                            args.lat_bins),
                lib.simstep_grid_threads(args.tile_nodes, args.P, args.V)),
               (grid_smem_bytes(n_rounds, args.ntiles, args.L,
                                args.lat_bins),
                grid_threads(args.tile_nodes, pv)))
        self.launch_fn = _fn("simstep_grid_launch", SimArgs, GridArgs)
        self.floor_fn = _fn("simstep_grid_floor_launch", SimArgs, GridArgs)
        self.extra = (ctypes.byref(gargs),)

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def launch(self, args: SimArgs) -> None:
        """Advance every lane by ``args.num_cycles`` cycles: one launch of
        ``simstep_chunk`` or ``simstep_grid``, on the cell's card (the
        runtime launches, and sets the kernels' attributes, on the
        calling thread's current device, whatever the stream's)."""
        with torch.cuda.device(self.device):
            err = self.launch_fn(ctypes.byref(args), *self.extra,
                                 self._stream())
        LAUNCHES[f"simstep_{self.kernel}"] += 1
        if err:
            raise RuntimeError(f"simstep_{self.kernel} launch failed: "
                               f"cudaError {err}")

    def floor(self, args: SimArgs) -> None:
        """The kernel's launch shape and per-cycle barriers with an empty
        body: its latency floor, for measurement (not counted, and the
        state is untouched)."""
        with torch.cuda.device(self.device):
            err = self.floor_fn(ctypes.byref(args), *self.extra,
                                self._stream())
        if err:
            raise RuntimeError(f"simstep_{self.kernel} floor launch failed: "
                               f"cudaError {err}")


def grid_occupancy(tile: int, p: int, v: int, smem: int, algo: int,
                   instrumented: bool) -> int:
    """Grid-kernel blocks of ``tile`` nodes one SM of the current card
    holds with ``smem`` bytes of shared memory each, for the kernel's
    instance that routes ``algo`` (the instrumented one, with the
    watchdog and the telemetry, where ``instrumented``; the occupancy
    API)."""
    got = library("simstep").simstep_grid_blocks_per_sm(
        tile, p, v, smem, int(algo), int(bool(instrumented)))
    if got <= 0:
        raise RuntimeError(f"simstep_grid occupancy query failed: {got}")
    return got
