"""Launch binding of ``csrc/simstep.cu`` (ctypes, plain C ABI).

Both kernels take one :class:`SimArgs` record: every table, state and
scratch pointer of a simulation cell plus its sizes.  The record is
built once per cell (:func:`sim_args`) and only the per-cycle fields
(the draw pointers and the cycle index) change between launches, which
keeps the host cost of a cycle at two ctypes calls.  The field order
must match ``struct SimArgs`` in the source.
"""

from __future__ import annotations

import ctypes

import torch

from .. import LAUNCHES
from ..build import library

PTR_FIELDS = (
    "port", "choice", "neighbor", "recv_port", "cdf", "p_gen", "chan_of",
    "chan_bw", "u", "ud", "flits", "fifo_start", "fifo_size", "fs_pre",
    "lock_op", "lock_ov", "out_held", "rr", "qpkts", "q_start", "q_size",
    "prog", "next_seq", "rate", "cycle0", "inject_until", "measure_until",
    "mov", "parts", "exp_seq", "rbits", "node_fwd", "eject_flits",
    "chan_fwd", "chan_seen", "lat_sum", "lat_cnt", "lat_max", "lat_hist",
    "reorder_max", "injected", "offered", "dropped", "eject_total",
    "meas_cnt",
)
INT_FIELDS = (
    "L", "N", "P", "V", "NIN", "C", "O", "B", "Q", "PKT", "p_local", "algo",
    "tile_nodes", "ntiles", "cycle", "warmup", "lat_bins", "lat_bin_width",
)
# the kernels' compile-time bound on inputs per router (P·V)
MAX_PV = 32


class SimArgs(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in PTR_FIELDS]
                + [(f, ctypes.c_int) for f in INT_FIELDS])


def sim_args(pointers: dict, sizes: dict) -> SimArgs:
    """A :class:`SimArgs` record from tensors (by field name) and ints."""
    args = SimArgs()
    for f in PTR_FIELDS:
        x = pointers.get(f)
        setattr(args, f, x.data_ptr() if x is not None else None)
    for f in INT_FIELDS:
        setattr(args, f, int(sizes[f]))
    return args


def _fn(name: str):
    fn = getattr(library("simstep"), name)
    fn.argtypes = [ctypes.POINTER(SimArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class Launcher:
    """The two launch functions, resolved once per cell."""

    def __init__(self, device: torch.device):
        size = library("simstep").simstep_args_size()
        if size != ctypes.sizeof(SimArgs):
            raise RuntimeError(f"SimArgs layout mismatch: C {size} bytes, "
                               f"ctypes {ctypes.sizeof(SimArgs)}")
        self.tile_fn = _fn("simstep_tile_launch")
        self.finish_fn = _fn("simstep_finish_launch")
        self.device = device

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def tile(self, args: SimArgs) -> None:
        """Snapshot ``fifo_size`` into ``fs_pre``, then run stages 1–6
        over every (lane, tile) block."""
        err = self.tile_fn(ctypes.byref(args), self._stream())
        LAUNCHES["simstep_tile"] += 1
        if err:
            raise RuntimeError(f"simstep_tile launch failed: cudaError {err}")

    def finish(self, args: SimArgs) -> None:
        """Receive pushes and statistics, one thread per (lane, node)."""
        err = self.finish_fn(ctypes.byref(args), self._stream())
        LAUNCHES["simstep_finish"] += 1
        if err:
            raise RuntimeError(
                f"simstep_finish launch failed: cudaError {err}")
