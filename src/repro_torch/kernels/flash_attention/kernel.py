"""Launch binding of ``csrc/flash_attention.cu`` (ctypes, plain C ABI)."""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import LAUNCHES
from ..build import library

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 11 + [ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, mask_len: torch.Tensor | None,
                         scale: float) -> torch.Tensor:
    """Launch the kernel on the current stream; inputs already checked
    (see :func:`repro_torch.kernels.flash_attention.ops.flash_attention`).
    Returns a new contiguous (B, Sq, H, D) tensor in q's dtype."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if mask_len is None:
        lens, len_sb, len_sq = None, 0, 0
    else:
        lens = mask_len.data_ptr()
        len_sb = mask_len.stride(0)
        len_sq = mask_len.stride(1) if mask_len.ndim == 2 else 0
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), lens,
                      _DTYPE_CODE[q.dtype], b, h, kvh, sq, skv, d,
                      *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                      len_sb, len_sq, int(causal), float(scale),
                      torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["flash_attention"] += 1
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    return o
