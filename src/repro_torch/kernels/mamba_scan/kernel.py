"""Launch bindings of ``csrc/selective_scan.cu`` (the scan) and
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

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def _launcher():
    fn = library("selective_scan").selective_scan_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd():
    """The backward's entry and its (chunk, block, terms) sizes, which
    size the scratch the caller allocates."""
    lib = library("selective_scan_bwd")
    fn = lib.selective_scan_bwd_launch
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn, (lib.selective_scan_bwd_chunk(),
                lib.selective_scan_bwd_threads(),
                lib.selective_scan_bwd_terms())


def _ptr(t):
    return None if t is None else t.data_ptr()


def selective_scan_cuda(delta, a, b, c, x, h0):
    """Launch the kernel on the current stream; inputs already checked
    (see :func:`repro_torch.kernels.mamba_scan.ops.selective_scan`).
    Returns new (y (B, S, Di), h_last (B, Di, Ds)) float32 tensors."""
    bs, s, di = x.shape
    ds = a.shape[1]
    y = torch.empty((bs, s, di), dtype=torch.float32, device=x.device)
    h_last = torch.empty((bs, di, ds), dtype=torch.float32, device=x.device)
    err = _launcher()(delta.data_ptr(), a.data_ptr(), b.data_ptr(),
                      c.data_ptr(), x.data_ptr(), _ptr(h0),
                      y.data_ptr(), h_last.data_ptr(), bs, s, di, ds,
                      torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES["selective_scan"] += 1
    if err:
        raise RuntimeError(f"selective_scan launch failed: cudaError {err}")
    return y, h_last


def selective_scan_bwd_cuda(delta, a, b, c, x, h0, dy, dh_last=None):
    """The backward kernels on the current stream: new (ddelta, da, db,
    dc, dx, dh0) float32 tensors in the inputs' shapes (dh0 (B, Di, Ds)
    whether or not ``h0`` was given).  The forward's inputs as it took
    them, ``dy`` (B, S, Di) and ``dh_last`` (B, Di, Ds) or None, float32
    and contiguous, all checked by the caller
    (:class:`..ops.SelectiveScan`)."""
    bs, s, di = x.shape
    ds = a.shape[1]
    fn, (chunk, block, terms) = _bwd()
    dev = x.device

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    ddelta, dx, dh0 = new(bs, s, di), new(bs, s, di), new(bs, di, ds)
    da, db, dc = new(di, ds), new(bs, s, ds), new(bs, s, ds)
    # the chunks' starting states, the channel blocks' dB/dC terms, the
    # rows' dA: held until the launches are enqueued
    ckpt = new(bs, -(-s // chunk), di, ds)
    part_bc = new(-(-di // block), bs, s, terms)
    part_a = new(bs, di, ds)
    err = fn(delta.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
             x.data_ptr(), _ptr(h0), dy.data_ptr(), _ptr(dh_last),
             ddelta.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
             dx.data_ptr(), dh0.data_ptr(), ckpt.data_ptr(),
             part_bc.data_ptr(), part_a.data_ptr(), bs, s, di, ds,
             torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["selective_scan_bwd"] += 1
    LAUNCHES["selective_scan_bwd_reduce"] += 1
    if err:
        raise RuntimeError(f"selective_scan_bwd launch failed: cudaError "
                           f"{err}")
    return ddelta, da, db, dc, dx, dh0
