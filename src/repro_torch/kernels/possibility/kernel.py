"""Launch bindings of ``csrc/possibility.cu`` (ctypes, plain C ABI), and
the launch layout both passes share.

A thread of the kernel holds a (channels × destinations) register tile,
a warp 4 × 8 threads and a block 2 × 2 warps, so a block covers
``8·tc`` channels × ``16·td`` destinations (:data:`THREAD_TILES`, the
table of ``launch`` in the source).  The grid is (destination tiles,
channel tiles); for ``possibility_weights`` each destination tile is a
split whose fp64 partials a second launch sums, unless there is one.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .. import LAUNCH_SIZES, LAUNCHES
from ..build import library

# (channels, destinations) a thread, by configuration number
THREAD_TILES = ((8, 4), (4, 2), (2, 2))
LANES = (4, 8)   # a warp's lanes along (channels, destinations)
WARPS = (2, 2)   # a block's warps along (channels, destinations)
BLOCK_THREADS = 32 * WARPS[0] * WARPS[1]

# the C entries' arguments: pointers, then ints, then the stream
_ARGTYPES = {
    "possibility_v_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    "possibility_weights_launch": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
    + [ctypes.c_void_p]}


@dataclass(frozen=True)
class Layout:
    """One launch's configuration: ``cfg`` indexes :data:`THREAD_TILES`;
    ``tile`` is a block's (channels, destinations) and ``grid`` the
    (destination tiles, channel tiles) that cover (N, C)."""
    cfg: int
    tile: tuple[int, int]
    grid: tuple[int, int]

    @property
    def splits(self) -> int:
        """Destination tiles: the partial sums of ``possibility_weights``
        (one needs no second launch)."""
        return self.grid[0]


def _cost(n: int, c: int, cfg: int, weights: bool, sms: int) -> float:
    """Issue slots on the busiest scheduler, roughly: a thread's
    instructions a source row (four a triple, its shared loads, the
    float32 T's widening, the loop) times the rows, times the warps each
    of the card's 4·sms schedulers holds, at least two (one warp alone
    stalls on its own loads)."""
    tc, td = THREAD_TILES[cfg]
    tbytes = 4 if weights else 8
    loads = -(-4 * tc // 16) + -(-4 * td // 16) + -(-tbytes * td // 16)
    per_row = 4 * tc * td + loads + (td if weights else 0) + 2
    lay = _layout(n, c, cfg)
    warps = lay.grid[0] * lay.grid[1] * BLOCK_THREADS // 32
    return n * per_row * max(2.0, warps / (4 * sms))


def _layout(n: int, c: int, cfg: int) -> Layout:
    tc, td = THREAD_TILES[cfg]
    tile = (WARPS[0] * LANES[0] * tc, WARPS[1] * LANES[1] * td)
    return Layout(cfg, tile, (-(-n // tile[1]), -(-c // tile[0])))


def possibility_layout(n: int, c: int, weights: bool,
                       sms: int = 132) -> Layout:
    """The launch for N nodes and C channels on a card of ``sms`` SMs:
    the thread tile of least estimated issue time (:func:`_cost`)."""
    if n <= 0 or c <= 0:
        raise ValueError(f"empty pass: N={n}, C={c}")
    return _layout(n, c, min(range(len(THREAD_TILES)),
                             key=lambda k: _cost(n, c, k, weights, sms)))


def weights_scratch(lay: Layout, c: int, device) -> torch.Tensor | None:
    """The (splits, C) fp64 partials of W, or None where one destination
    tile stores W itself."""
    if lay.splits == 1:
        return None
    return torch.empty((lay.splits, c), dtype=torch.float64, device=device)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(n: int, c: int, *xs: torch.Tensor) -> int:
    """1 when every staged row starts 16-byte aligned (16-byte copies)."""
    return int(n % 4 == 0 and c % 4 == 0
               and all(x.data_ptr() % 16 == 0 for x in xs))


@functools.cache
def _launcher(name: str):
    fn = getattr(library("possibility"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _count(name: str, n: int, c: int) -> None:
    LAUNCHES[name] += 1
    LAUNCH_SIZES[(name, n, c)] += 1


def possibility_v_cuda(du: torch.Tensor, dn: torch.Tensor, t: torch.Tensor,
                       dist: torch.Tensor, offset: int) -> torch.Tensor:
    """Launch the kernel on the current stream; inputs already checked
    (see :func:`repro_torch.kernels.possibility.ops.possibility_v`)."""
    n, c = du.shape
    lay = possibility_layout(n, c, False, _sms(du.device.index or 0))
    return _launch_v(du, dn, t, dist, offset, lay)


def possibility_weights_cuda(du, dn, dsn, tn, t, dist,
                             offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream; inputs already checked
    (see :func:`repro_torch.kernels.possibility.ops.possibility_weights_op`)."""
    n, c = du.shape
    lay = possibility_layout(n, c, True, _sms(du.device.index or 0))
    return _launch_weights(du, dn, dsn, tn, t, dist, offset, lay)


def _launch_v(du, dn, t, dist, offset: int, lay: Layout) -> torch.Tensor:
    """``possibility_v`` in the layout ``lay`` (the kernel tests pass each
    thread tile's)."""
    n, c = du.shape
    v = torch.empty((c, n), dtype=torch.float64, device=du.device)
    err = _launcher("possibility_v_launch")(
        du.data_ptr(), dn.data_ptr(), t.data_ptr(), dist.data_ptr(),
        v.data_ptr(), n, c, int(offset), lay.cfg, *lay.grid,
        _aligned(n, c, du, t, dist),
        torch.cuda.current_stream(du.device).cuda_stream)
    _count("possibility_v", n, c)
    if err:
        raise RuntimeError(f"possibility_v launch failed: cudaError {err}")
    return v


def _launch_weights(du, dn, dsn, tn, t, dist, offset: int,
                    lay: Layout) -> tuple[torch.Tensor, torch.Tensor]:
    """``possibility_weights`` in the layout ``lay`` (the kernel tests
    pass each thread tile's)."""
    n, c = du.shape
    w = torch.empty(c, dtype=torch.float32, device=du.device)
    w_drn = torch.empty(c, dtype=torch.float32, device=du.device)
    part_w = weights_scratch(lay, c, du.device)
    err = _launcher("possibility_weights_launch")(
        du.data_ptr(), dn.data_ptr(), dsn.data_ptr(), tn.data_ptr(),
        t.data_ptr(), dist.data_ptr(), w.data_ptr(), w_drn.data_ptr(),
        None if part_w is None else part_w.data_ptr(),
        n, c, int(offset), lay.cfg, *lay.grid,
        _aligned(n, c, du, dsn, tn, t, dist),
        torch.cuda.current_stream(du.device).cuda_stream)
    _count("possibility_weights", n, c)
    if err:
        raise RuntimeError(
            f"possibility_weights launch failed: cudaError {err}")
    return w, w_drn
