"""Launch bindings of the attention kernels (ctypes, plain C ABI):
``csrc/flash_attention_split.cu`` (the split path in both dtypes and its
combine, one entry), ``csrc/flash_attention_tc.cu`` (tensor cores, bf16
prefill), ``csrc/flash_attention.cu`` (CUDA cores, fp32 prefill and any
head dim above 128) and ``csrc/flash_attention_bwd.cu`` (the backward:
dQ, then dK and dV, one entry).

The split and tensor-core entries take one launch record, packed by
:data:`_RECORD`, so a call crosses into C once with two arguments.
``LAUNCHES["flash_attention"]`` counts one per forward call, whatever
the path and however many kernels it launches, and
``LAUNCHES["flash_attention_bwd"]`` one per backward call (two kernels);
:data:`PATH_LAUNCHES` counts each forward kernel of each path.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from .. import LAUNCHES
from ..build import library

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# FlashArgs of csrc/flash_attention_split.cu and csrc/flash_attention_tc.cu:
# q, k, v, o, part, lens, lse; eleven strides; dtype, b, h, kvh, sq, skv,
# d, dv, splits, chunk, causal; scale; native alignment, padded to 8 bytes
_RECORD = struct.Struct("@7P11q11if0q")

# kernel launches by path: "split" (first kernel of the split path),
# "combine" (its second kernel, when splits > 1), "tc", "simt"
PATH_LAUNCHES = {"split": 0, "combine": 0, "tc": 0, "simt": 0}


def reset_path_launches() -> None:
    for k in PATH_LAUNCHES:
        PATH_LAUNCHES[k] = 0


def _record_entry(lib: str, name: str):
    so = library(lib)
    size = so.flash_attention_args_size()
    if size != _RECORD.size:
        raise RuntimeError(f"FlashArgs layout mismatch in {lib}: C {size} "
                           f"bytes, binding {_RECORD.size}")
    fn = getattr(so, name)
    fn.argtypes = [ctypes.c_char_p, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _split():
    return _record_entry("flash_attention_split",
                         "flash_attention_split_launch")


@functools.cache
def _tc():
    return _record_entry("flash_attention_tc", "flash_attention_tc_launch")


@functools.cache
def _simt():
    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = [_P] * 6 + [_I] * 8 + [_L] * 11 + [_I, ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd():
    fn = library("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [_P] * 10 + [_I] * 8 + [_L] * 9 + [_I, ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


def _raise(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"flash_attention {what} launch failed: "
                           f"cudaError {err}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, mask_len: torch.Tensor | None,
                         scale: float, path, return_lse: bool = False):
    """Launch ``path`` (:func:`..ops.choose_path`) on the current stream;
    inputs already checked (see
    :func:`repro_torch.kernels.flash_attention.ops.flash_attention`).
    Returns a new contiguous (B, Sq, H, Dv) tensor in q's dtype; with
    ``return_lse`` (the tc and simt paths) also each row's log-sum-exp,
    fp32 (B, Sq, KV, H/KV)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dv = v.shape[3]
    o = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    lse = None
    if return_lse:
        if path.kind == "split":
            raise ValueError("the split path is inference-only: no lse")
        lse = torch.empty((b, sq, kvh, h // kvh), dtype=torch.float32,
                          device=q.device)
    lse_ptr = 0 if lse is None else lse.data_ptr()
    if mask_len is None:
        lens, len_sb, len_sq = 0, 0, 0
    else:
        lens = mask_len.data_ptr()
        len_sb = mask_len.stride(0)
        len_sq = mask_len.stride(1) if mask_len.ndim == 2 else 0
    q_sb, q_ss, q_sh, _ = q.stride()
    k_sb, k_ss, k_sh, _ = k.stride()
    v_sb, v_ss, v_sh, _ = v.stride()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dtype = _DTYPE_CODE[q.dtype]
    kind = path.kind
    LAUNCHES["flash_attention"] += 1
    if kind == "simt":
        err = _simt()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), lens or None, lse_ptr or None, dtype, b,
                      h, kvh, sq, skv, d, dv, q_sb, q_ss, q_sh, k_sb, k_ss,
                      k_sh, v_sb, v_ss, v_sh, len_sb, len_sq, int(causal),
                      float(scale), stream)
        PATH_LAUNCHES["simt"] += 1
        _raise(err, "CUDA-core")
        return (o, lse) if return_lse else o
    part = 0
    if kind == "split" and path.splits > 1:
        # m and l, then acc, of every (range, batch, KV head, packed row);
        # held until the launch is enqueued
        scratch = torch.empty(path.splits * b * sq * h * (dv + 2),
                              dtype=torch.float32, device=q.device)
        part = scratch.data_ptr()
    record = _RECORD.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), part, lens,
        lse_ptr, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
        len_sb, len_sq, dtype, b, h, kvh, sq, skv, d, dv, path.splits,
        path.chunk, int(causal), scale)
    if kind == "split":
        err = _split()(record, stream)
        PATH_LAUNCHES["split"] += 1
        PATH_LAUNCHES["combine"] += path.splits > 1
        _raise(err, "split")
    elif kind == "tc":
        if q.dtype != torch.bfloat16:
            raise TypeError(f"the tensor-core path takes bfloat16, got "
                            f"{q.dtype}")
        err = _tc()(record, stream)
        PATH_LAUNCHES["tc"] += 1
        _raise(err, "tensor-core")
    else:
        raise ValueError(f"unknown path {kind!r}")
    return (o, lse) if return_lse else o


def flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal: bool,
                             scale: float):
    """The backward kernels on the current stream: (dq, dk, dv), new
    contiguous tensors in q's dtype.  q, k, v as the forward took them;
    o, dout (B, Sq, H, Dv) and lse (B, Sq, KV, H/KV) fp32 contiguous, all
    checked by the caller (:class:`..ops.FlashAttention`)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dv = v.shape[3]
    dev = q.device
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, skv, kvh, d), dtype=q.dtype, device=dev)
    dvv = torch.empty((b, skv, kvh, dv), dtype=q.dtype, device=dev)
    delta = torch.empty((b, sq, h), dtype=torch.float32, device=dev)
    q_sb, q_ss, q_sh, _ = q.stride()
    k_sb, k_ss, k_sh, _ = k.stride()
    v_sb, v_ss, v_sh, _ = v.stride()
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES["flash_attention_bwd"] += 1
    err = _bwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dvv.data_ptr(), delta.data_ptr(),
                 _DTYPE_CODE[q.dtype], b, h, kvh, sq, skv, d, dv, q_sb, q_ss,
                 q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, int(causal),
                 float(scale), stream)
    _raise(err, "backward")
    return dq, dk, dvv
