"""Launch bindings of the attention kernels (ctypes, plain C ABI):
``csrc/flash_attention_split.cu`` (the split path in both dtypes and its
combine, one entry), ``csrc/flash_attention_tc.cu`` (tensor cores, bf16
prefill), ``csrc/flash_attention.cu`` (CUDA cores, fp32 prefill and any
head dim above 128) and the backward's two routes (:func:`bwd_route`),
``csrc/flash_attention_bwd_tc.cu`` (bf16 up to 128, the tensor cores)
and ``csrc/flash_attention_bwd.cu`` (the CUDA cores: fp32, and 192 and
256), each dQ, then dK and dV, one entry.

The split and tensor-core entries take one launch record, packed by
:data:`_RECORD`, so a call crosses into C once with two arguments.
``LAUNCHES["flash_attention"]`` counts one per forward call, whatever
the path and however many kernels it launches, and
``LAUNCHES["flash_attention_bwd"]`` one per backward call (two kernels);
:data:`PATH_LAUNCHES` counts each forward kernel of each path and
:data:`BWD_PATH_LAUNCHES` each backward call by route.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from .. import LAUNCHES
from ..build import library

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the (Dk, Dv) pairs the kernels are built for: Dv = Dk at every multiple
# of 16 up to 128, and MLA's (96, 64) (minicpm3: 64 + 32 rope dims, V 64),
# on every path; (192, 192) and (256, 256) on the CUDA-core kernels alone
HEAD_DIMS = (tuple((d, d) for d in range(16, 129, 16)) + ((96, 64),)
             + ((192, 192), (256, 256)))
TILED_MAX_HEAD_DIM = 128  # the widest pair of the split and tc kernels
# FlashArgs of csrc/flash_attention_split.cu and csrc/flash_attention_tc.cu:
# q, k, v, o, part, lens, lse; eleven strides; dtype, b, h, kvh, sq, skv,
# d, dv, splits, chunk, causal; scale; native alignment, padded to 8 bytes
_RECORD = struct.Struct("@7P11q11if0q")

# kernel launches by path: "split" (first kernel of the split path),
# "combine" (its second kernel, when splits > 1), "tc", "simt"
PATH_LAUNCHES = {"split": 0, "combine": 0, "tc": 0, "simt": 0}
# backward calls by route (:func:`bwd_route`), one a call
BWD_PATH_LAUNCHES = {"tc": 0, "simt": 0}


def reset_path_launches() -> None:
    for counts in (PATH_LAUNCHES, BWD_PATH_LAUNCHES):
        for k in counts:
            counts[k] = 0


def bwd_route(dtype: torch.dtype, d: int, dv: int) -> str:
    """The backward kernel for a call at built head dims (``d``, ``dv``):
    ``"tc"`` (``csrc/flash_attention_bwd_tc.cu``) for bf16 up to
    :data:`TILED_MAX_HEAD_DIM`, else ``"simt"``
    (``csrc/flash_attention_bwd.cu``: fp32, and 192 and 256).  Raises on
    what neither takes."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the backward kernels take {KERNEL_DTYPES}, got "
                        f"{dtype}")
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"the backward kernels are built for the (Dk, Dv) "
                         f"head dims {list(HEAD_DIMS)}, got {(d, dv)}")
    if dtype == torch.bfloat16 and max(d, dv) <= TILED_MAX_HEAD_DIM:
        return "tc"
    return "simt"


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


# the tc backward's dK/dV blocks walk the query tiles of 64 rows that see
# their keys, for each of a KV head's G query heads; where the longest
# walk is at least this many (tile, head) pairs, the G heads are split
# over two blocks
TC_SPLIT_PAIRS = 16


def bwd_tc_splits(sq: int, h: int, kvh: int) -> int:
    """Blocks a KV head's query heads are split over in the tc backward's
    dK/dV launch: 2 where G = H/KV is even and the first key tile's walk
    is at least :data:`TC_SPLIT_PAIRS` (tile, head) pairs (their sums then
    added by a third launch, which costs more than it saves on a short
    walk), else 1."""
    g = h // kvh
    return 2 if g % 2 == 0 and -(-sq // 64) * g >= TC_SPLIT_PAIRS else 1


@functools.cache
def _bwd(route: str):
    lib, name = {"tc": ("flash_attention_bwd_tc",
                        "flash_attention_bwd_tc_launch"),
                 "simt": ("flash_attention_bwd",
                          "flash_attention_bwd_launch")}[route]
    fn = getattr(library(lib), name)
    # the tc entry takes one pointer more, the dK/dV halves' scratch
    fn.argtypes = ([_P] * (11 if route == "tc" else 10) + [_I] * 8
                   + [_L] * 9 + [_I, ctypes.c_float, _P])
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
                             scale: float, route: str | None = None):
    """The backward kernels of ``route`` (:func:`bwd_route`'s choice when
    None) on the current stream: (dq, dk, dv), new contiguous tensors in
    q's dtype.  q, k, v as the forward took them; o, dout (B, Sq, H, Dv)
    and lse (B, Sq, KV, H/KV) fp32 contiguous, checked by the caller
    (:class:`..ops.FlashAttention`).  Raises on a route that does not
    take the call, and on tensors off the card."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dv = v.shape[3]
    dev = q.device
    fit = bwd_route(q.dtype, d, dv)
    route = fit if route is None else route
    if route not in BWD_PATH_LAUNCHES or (route == "tc" and fit != "tc"):
        raise ValueError(f"the backward route {route!r} does not take "
                         f"{q.dtype} at (Dk, Dv) {(d, dv)} (its route: "
                         f"{fit!r})")
    if dev.type != "cuda":
        raise ValueError(f"the backward kernels take CUDA tensors, got "
                         f"{dev}")
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, skv, kvh, d), dtype=q.dtype, device=dev)
    dvv = torch.empty((b, skv, kvh, dv), dtype=q.dtype, device=dev)
    delta = torch.empty((b, sq, h), dtype=torch.float32, device=dev)
    q_sb, q_ss, q_sh, _ = q.stride()
    k_sb, k_ss, k_sh, _ = k.stride()
    v_sb, v_ss, v_sh, _ = v.stride()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dvv.data_ptr(), delta.data_ptr()]
    if route == "tc":
        # the dK/dV halves' fp32 sums (bwd_tc_splits), held until the
        # launches are enqueued
        part = (torch.empty(2 * b * skv * kvh * (d + dv), dtype=torch.float32,
                            device=dev) if bwd_tc_splits(sq, h, kvh) == 2
                else None)
        ptrs.append(None if part is None else part.data_ptr())
    LAUNCHES["flash_attention_bwd"] += 1
    BWD_PATH_LAUNCHES[route] += 1
    err = _bwd(route)(*ptrs, _DTYPE_CODE[q.dtype], b, h, kvh, sq, skv, d,
                      dv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                      v_sh, int(causal), float(scale), stream)
    _raise(err, f"backward ({route})")
    return dq, dk, dvv
