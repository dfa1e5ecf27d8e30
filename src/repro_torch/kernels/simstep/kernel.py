"""Launch binding of ``csrc/simstep.cu`` and ``csrc/simstep_pair.cu``
(ctypes, plain C ABI).

The chunk kernel takes one :class:`SimArgs` record: every table and
state pointer of a simulation cell, the lanes' PRNG key words and the
sizes.  The record is built once per cell (:func:`sim_args`); a chunk
sets ``num_cycles`` and makes one ctypes call.  The kernel pair, for
cells the chunk kernel cannot lay out, takes a :class:`PairArgs` record
with the cycle's draws, the scratch and the cycle index in place of the
key and ``num_cycles``; a cycle sets those and makes two ctypes calls.
The field orders must match ``struct SimArgs`` and ``struct PairArgs``
in the sources.
"""

from __future__ import annotations

import ctypes

import torch

from ...noc.simconfig import NF
from .. import LAUNCHES
from ..build import library

PTR_FIELDS = (
    "port", "choice", "neighbor", "recv_port", "cdf", "p_gen", "chan_of",
    "chan_bw", "key", "flits", "fifo_start", "fifo_size", "lock_op",
    "lock_ov", "out_held", "rr", "qpkts", "q_start", "q_size", "prog",
    "next_seq", "rate", "cycle0", "inject_until", "measure_until",
    "exp_seq", "rbits", "node_fwd", "eject_flits", "chan_fwd", "chan_seen",
    "lat_sum", "lat_cnt", "lat_max", "lat_hist", "reorder_max", "injected",
    "offered", "dropped", "eject_total", "meas_cnt",
)
INT_FIELDS = (
    "L", "N", "P", "V", "NIN", "C", "O", "B", "Q", "PKT", "p_local", "algo",
    "tile_nodes", "ntiles", "num_cycles", "warmup", "lat_bins",
    "lat_bin_width",
)
PAIR_PTR_FIELDS = (
    "port", "choice", "neighbor", "recv_port", "cdf", "p_gen", "chan_of",
    "chan_bw", "u", "ud", "flits", "fifo_start", "fifo_size", "fs_pre",
    "lock_op", "lock_ov", "out_held", "rr", "qpkts", "q_start", "q_size",
    "prog", "next_seq", "rate", "cycle0", "inject_until", "measure_until",
    "mov", "parts", "exp_seq", "rbits", "node_fwd", "eject_flits",
    "chan_fwd", "chan_seen", "lat_sum", "lat_cnt", "lat_max", "lat_hist",
    "reorder_max", "injected", "offered", "dropped", "eject_total",
    "meas_cnt",
)
PAIR_INT_FIELDS = (
    "L", "N", "P", "V", "NIN", "C", "O", "B", "Q", "PKT", "p_local", "algo",
    "tile_nodes", "ntiles", "cycle", "warmup", "lat_bins", "lat_bin_width",
)
# the pair's block: one thread per node of a tile
PAIR_MAX_THREADS = 1024
# the chunk kernel's compile-time bounds: inputs per router (P·V), ports, and
# the blocks of one lane's cluster (past 8, the non-portable size Hopper
# allows)
MIN_PV = 2
MAX_PV = 32
MAX_P = 16
MAX_CLUSTER = 16
WARP = 32
MAX_WARPS = 32
# int32 words of a block's shared memory besides its per-node arrays
# (``struct Layout`` in the source): the per-block sums and the keys
_FIXED_WORDS = 16 + 10


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


class SimArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in PTR_FIELDS]
                + [(f, ctypes.c_int) for f in INT_FIELDS])


class PairArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in PAIR_PTR_FIELDS]
                + [(f, ctypes.c_int) for f in PAIR_INT_FIELDS])


def sim_args(pointers: dict, sizes: dict, record=SimArgs):
    """A launch record (:class:`SimArgs` or :class:`PairArgs`) from
    tensors (by field name; a missing one is null) and ints."""
    args = record()
    ptrs = PTR_FIELDS if record is SimArgs else PAIR_PTR_FIELDS
    ints = INT_FIELDS if record is SimArgs else PAIR_INT_FIELDS
    for f in ptrs:
        x = pointers.get(f)
        setattr(args, f, x.data_ptr() if x is not None else None)
    for f in ints:
        setattr(args, f, int(sizes[f]))
    return args


def _fn(lib: str, name: str, record):
    fn = getattr(library(lib), name)
    fn.argtypes = [ctypes.POINTER(record), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class Launcher:
    """The chunk launch function, resolved once per cell."""

    def __init__(self, device: torch.device, args: SimArgs):
        lib = library("simstep")
        size = lib.simstep_args_size()
        if size != ctypes.sizeof(SimArgs):
            raise RuntimeError(f"SimArgs layout mismatch: C {size} bytes, "
                               f"ctypes {ctypes.sizeof(SimArgs)}")
        want = smem_bytes(args.tile_nodes, args.P, args.V, args.lat_bins)
        got = lib.simstep_smem_bytes(args.tile_nodes, args.P, args.V,
                                     args.lat_bins)
        threads = lib.simstep_block_threads(args.tile_nodes, args.P, args.V)
        if (got, threads) != (want, block_threads(args.tile_nodes,
                                                  args.P * args.V)):
            raise RuntimeError(f"simstep block layout mismatch: C {got} "
                               f"bytes / {threads} threads, binding {want}")
        self.chunk_fn = _fn("simstep", "simstep_chunk_launch", SimArgs)
        self.floor_fn = _fn("simstep", "simstep_floor_launch", SimArgs)
        self.device = device

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def chunk(self, args: SimArgs) -> None:
        """Advance every lane by ``args.num_cycles`` cycles."""
        err = self.chunk_fn(ctypes.byref(args), self._stream())
        LAUNCHES["simstep_chunk"] += 1
        if err:
            raise RuntimeError(f"simstep_chunk launch failed: cudaError {err}")

    def floor(self, args: SimArgs) -> None:
        """The chunk kernel's launch shape and per-cycle barriers with an
        empty body: its latency floor, for measurement (not counted, and
        the state is untouched)."""
        err = self.floor_fn(ctypes.byref(args), self._stream())
        if err:
            raise RuntimeError(f"simstep_floor launch failed: cudaError {err}")


class PairLauncher:
    """The kernel pair's two launch functions, resolved once per cell."""

    def __init__(self, device: torch.device):
        size = library("simstep_pair").simstep_pair_args_size()
        if size != ctypes.sizeof(PairArgs):
            raise RuntimeError(f"PairArgs layout mismatch: C {size} bytes, "
                               f"ctypes {ctypes.sizeof(PairArgs)}")
        self.tile_fn = _fn("simstep_pair", "simstep_tile_launch", PairArgs)
        self.finish_fn = _fn("simstep_pair", "simstep_finish_launch",
                             PairArgs)
        self.device = device

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def tile(self, args: PairArgs) -> None:
        """Snapshot ``fifo_size`` into ``fs_pre``, then run stages 1–6
        over every (lane, tile) block."""
        err = self.tile_fn(ctypes.byref(args), self._stream())
        LAUNCHES["simstep_tile"] += 1
        if err:
            raise RuntimeError(f"simstep_tile launch failed: cudaError {err}")

    def finish(self, args: PairArgs) -> None:
        """Receive pushes and statistics, one thread per (lane, node)."""
        err = self.finish_fn(ctypes.byref(args), self._stream())
        LAUNCHES["simstep_finish"] += 1
        if err:
            raise RuntimeError(
                f"simstep_finish launch failed: cudaError {err}")
