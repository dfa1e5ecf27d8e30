"""Launch binding of ``csrc/selective_scan.cu`` (ctypes, plain C ABI)."""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import LAUNCHES
from ..build import library

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def _launcher():
    fn = library("selective_scan").selective_scan_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def selective_scan_cuda(delta, a, b, c, x, h0):
    """Launch the kernel on the current stream; inputs already checked
    (see :func:`repro_torch.kernels.mamba_scan.ops.selective_scan`).
    Returns new (y (B, S, Di), h_last (B, Di, Ds)) float32 tensors."""
    bs, s, di = x.shape
    ds = a.shape[1]
    y = torch.empty((bs, s, di), dtype=torch.float32, device=x.device)
    h_last = torch.empty((bs, di, ds), dtype=torch.float32, device=x.device)
    err = _launcher()(delta.data_ptr(), a.data_ptr(), b.data_ptr(),
                      c.data_ptr(), x.data_ptr(),
                      None if h0 is None else h0.data_ptr(),
                      y.data_ptr(), h_last.data_ptr(), bs, s, di, ds,
                      torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES["selective_scan"] += 1
    if err:
        raise RuntimeError(f"selective_scan launch failed: cudaError {err}")
    return y, h_last
