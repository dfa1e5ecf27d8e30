"""Launch bindings of ``csrc/selective_scan.cu`` (the scan, which also
writes the backward's checkpoints when asked) and
``csrc/selective_scan_bwd.cu`` (its gradient: a kernel over the chunks
and a second that sums the partials, one entry), ctypes, plain C ABI.

``LAUNCHES["selective_scan"]`` counts one per forward call and
``LAUNCHES["selective_scan_bwd"]`` one per backward call (two kernels).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import LAUNCHES
from ..build import library

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def _launcher():
    fn = library("selective_scan").selective_scan_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd():
    """The backward's entry and its (chunk, channels a block, terms)
    sizes, which size the scratch the caller allocates."""
    lib = library("selective_scan_bwd")
    fn = lib.selective_scan_bwd_launch
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn, (lib.selective_scan_bwd_chunk(),
                lib.selective_scan_bwd_channels(),
                lib.selective_scan_bwd_terms())


def bwd_scratch_shapes(bs: int, s: int, di: int, ds: int, block: int,
                       terms: int) -> dict[str, tuple]:
    """The backward's scratch: the channel blocks' dB/dC terms, the rows'
    dA."""
    return {"part_bc": (-(-di // block), bs, s, terms), "part_a": (bs, di, ds)}


def _ptr(t):
    return None if t is None else t.data_ptr()


def selective_scan_cuda(delta, a, b, c, x, h0, ckpt: bool = False):
    """Launch the kernel on the current stream; inputs already checked
    (see :func:`repro_torch.kernels.mamba_scan.ops.selective_scan`).
    Returns new (y (B, S, Di), h_last (B, Di, Ds)) float32 tensors; with
    ``ckpt`` also the state before every 8th step, (B, ceil(S / 8), Di,
    Ds), which :func:`selective_scan_bwd_cuda` walks back from."""
    bs, s, di = x.shape
    ds = a.shape[1]
    y = torch.empty((bs, s, di), dtype=torch.float32, device=x.device)
    h_last = torch.empty((bs, di, ds), dtype=torch.float32, device=x.device)
    states = None
    if ckpt:
        chunk = library("selective_scan").selective_scan_ckpt_chunk()
        states = torch.empty((bs, -(-s // chunk), di, ds),
                             dtype=torch.float32, device=x.device)
    err = _launcher()(delta.data_ptr(), a.data_ptr(), b.data_ptr(),
                      c.data_ptr(), x.data_ptr(), _ptr(h0),
                      y.data_ptr(), h_last.data_ptr(), _ptr(states), bs, s,
                      di, ds, torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES["selective_scan"] += 1
    if err:
        raise RuntimeError(f"selective_scan launch failed: cudaError {err}")
    return (y, h_last, states) if ckpt else (y, h_last)


def selective_scan_bwd_cuda(delta, a, b, c, x, ckpt, dy, dh_last=None):
    """The backward kernels on the current stream: new (ddelta, da, db,
    dc, dx, dh0) float32 tensors in the inputs' shapes (dh0 (B, Di, Ds)).
    The forward's inputs as it took them but h0, the checkpoints
    :func:`selective_scan_cuda` wrote with ``ckpt=True`` (which hold h0),
    ``dy`` (B, S, Di) and ``dh_last`` (B, Di, Ds) or None, float32 and
    contiguous, all checked by the caller (:class:`..ops.SelectiveScan`)
    but the checkpoints' shape."""
    bs, s, di = x.shape
    ds = a.shape[1]
    fn, (chunk, block, terms) = _bwd()
    want = (bs, -(-s // chunk), di, ds)
    if tuple(ckpt.shape) != want or not ckpt.is_contiguous():
        raise ValueError(f"ckpt: {tuple(ckpt.shape)}, expected the forward's "
                         f"{want}, contiguous")
    dev = x.device

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    ddelta, dx, dh0 = new(bs, s, di), new(bs, s, di), new(bs, di, ds)
    da, db, dc = new(di, ds), new(bs, s, ds), new(bs, s, ds)
    # held until the launches are enqueued
    scratch = bwd_scratch_shapes(bs, s, di, ds, block, terms)
    part_bc, part_a = new(*scratch["part_bc"]), new(*scratch["part_a"])
    err = fn(delta.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
             x.data_ptr(), ckpt.data_ptr(), dy.data_ptr(), _ptr(dh_last),
             ddelta.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
             dx.data_ptr(), dh0.data_ptr(), part_bc.data_ptr(),
             part_a.data_ptr(), bs, s, di, ds,
             torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["selective_scan_bwd"] += 1
    LAUNCHES["selective_scan_bwd_reduce"] += 1
    if err:
        raise RuntimeError(f"selective_scan_bwd launch failed: cudaError "
                           f"{err}")
    return ddelta, da, db, dc, dx, dh0
