"""Launch bindings of ``csrc/possibility_v.cu`` and
``csrc/possibility_weights.cu`` (ctypes, plain C ABI)."""

from __future__ import annotations

import ctypes

import torch

from .. import LAUNCHES
from ..build import library

_V_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_W_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def possibility_v_cuda(du: torch.Tensor, dn: torch.Tensor, t: torch.Tensor,
                       dist: torch.Tensor, offset: int) -> torch.Tensor:
    """Launch the kernel on the current stream; inputs already checked
    (see :func:`repro_torch.kernels.possibility.ops.possibility_v`)."""
    lib = library("possibility_v")
    fn = lib.possibility_v_launch
    fn.argtypes = _V_ARGTYPES
    fn.restype = ctypes.c_int
    n, c = du.shape
    v = torch.empty((c, n), dtype=torch.float64, device=du.device)
    err = fn(du.data_ptr(), dn.data_ptr(), t.data_ptr(), dist.data_ptr(),
             v.data_ptr(), n, c, int(offset),
             torch.cuda.current_stream(du.device).cuda_stream)
    LAUNCHES["possibility_v"] += 1
    if err:
        raise RuntimeError(f"possibility_v launch failed: cudaError {err}")
    return v


def possibility_weights_cuda(du, dn, dsn, tn, t, dist,
                             offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream; inputs already checked
    (see :func:`repro_torch.kernels.possibility.ops.possibility_weights_op`)."""
    lib = library("possibility_weights")
    fn = lib.possibility_weights_launch
    fn.argtypes = _W_ARGTYPES
    fn.restype = ctypes.c_int
    n, c = du.shape
    w = torch.empty(c, dtype=torch.float32, device=du.device)
    w_drn = torch.empty(c, dtype=torch.float32, device=du.device)
    err = fn(du.data_ptr(), dn.data_ptr(), dsn.data_ptr(), tn.data_ptr(),
             t.data_ptr(), dist.data_ptr(), w.data_ptr(), w_drn.data_ptr(),
             n, c, int(offset),
             torch.cuda.current_stream(du.device).cuda_stream)
    LAUNCHES["possibility_weights"] += 1
    if err:
        raise RuntimeError(
            f"possibility_weights launch failed: cudaError {err}")
    return w, w_drn
