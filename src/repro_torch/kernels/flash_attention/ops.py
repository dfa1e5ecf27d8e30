"""Public op: attention in the model layout, dispatched by the device of
its inputs.

Tensors on the card go through the CUDA kernels; tensors on the CPU go
through the plain twin.  The two never stand in for each other.  On the
card, :func:`choose_path` picks one of three kernels by shape and dtype:

* ``"split"`` — few query rows per KV head (decode, cross-attention,
  cached self-attention): Sq·(H/KV) ≤ 64.  The rows that share a KV head
  are packed into one tile and the keys are cut into ``splits`` ranges,
  one block each; a second kernel combines the ranges (none when there
  is one range).  bf16 and fp32.
* ``"tc"`` — bf16 prefill and encoder: the tensor-core kernel.
* ``"simt"`` — fp32 prefill and encoder: the CUDA-core kernel (TF32
  would not meet fp32's 2e-5); and every call with a head dim above
  :data:`TILED_MAX_HEAD_DIM`, bf16 too (the only kernel built at 192
  and 256).

The kernels are built for the (Dk, Dv) pairs of :data:`HEAD_DIMS` (split
and tc for those up to :data:`TILED_MAX_HEAD_DIM`).  Any other pair up to
:data:`MAX_HEAD_DIM` runs on the built pair of least Dk′ + Dv′ that
covers it (:func:`padded_dims`): q and k are zero-padded to Dk′ and v to
Dv′ (:func:`pad_head_dims`), the kernel scales by the true Dk^-0.5, and
the output is cut back to Dv.  Zero columns add nothing to q·k and give
zero output columns, so the function is the unpadded one; only the
unbuilt pairs pay the copy.

Training: when grad mode is on and an input requires grad, the op runs
through :class:`FlashAttention`, whose forward also returns each row's
log-sum-exp (the tc kernel in bf16, simt in fp32 or above 128, whatever
the row count) and whose backward is one of two kernels, chosen by
:func:`.kernel.bwd_route`: ``csrc/flash_attention_bwd_tc.cu`` (bf16 up
to 128, the tensor cores) or ``csrc/flash_attention_bwd.cu`` (fp32, and
192 and 256: the CUDA cores); on
the CPU the two twins (:func:`flash_attention_ref` with ``return_lse``,
:func:`flash_attention_bwd_ref`).  Padding and its cut are plain torch
ops, so autograd carries the gradient through them.  Otherwise every
path launches exactly what it launches for serving.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .kernel import (HEAD_DIMS, KERNEL_DTYPES, TILED_MAX_HEAD_DIM,
                     flash_attention_bwd_cuda, flash_attention_cuda)
from .ref import flash_attention_bwd_ref, flash_attention_ref

MAX_HEAD_DIM = 256      # the widest built tile, for Dk and Dv alike
SPLIT_MAX_ROWS = 64     # packed query rows a split block holds
SPLIT_TILE = 64         # keys a split block loads at a time
SPLIT_BLOCKS_PER_SM = 1  # one wave of split blocks (see choose_path)
H100_SMS = 132


class Path(NamedTuple):
    kind: str           # "split", "tc" or "simt"
    splits: int         # key ranges of the split path (1 elsewhere)
    chunk: int          # keys a range holds (a tile multiple; 0 elsewhere)


@functools.lru_cache(maxsize=256)
def choose_path(dtype: torch.dtype, b: int, sq: int, h: int, kv: int,
                skv: int, sms: int = H100_SMS, *,
                dims: tuple[int, int] = (0, 0), grad: bool = False) -> Path:
    """The kernel the op launches for these shapes, at the built head
    dims ``dims``.  A head dim above :data:`TILED_MAX_HEAD_DIM` takes
    simt; with ``grad`` (training: the forward writes the lse) bf16
    takes tc and fp32 simt, whatever the row count.  The split path cuts
    the Skv keys into ranges of whole tiles, as many as keep B·KV·splits
    within ``SPLIT_BLOCKS_PER_SM`` blocks per SM (one wave: a second,
    part-filled wave would take as long as the first); on the card each
    range stops at its rows' largest limit, so the lengths, which live on
    the card, need not be read back."""
    if max(dims) > TILED_MAX_HEAD_DIM:
        return Path("simt", 1, 0)
    if grad:
        return Path("tc" if dtype == torch.bfloat16 else "simt", 1, 0)
    rows = sq * (h // kv)
    if rows <= SPLIT_MAX_ROWS:
        tiles = max(1, math.ceil(skv / SPLIT_TILE))
        want = max(1, SPLIT_BLOCKS_PER_SM * sms // (b * kv))
        per = math.ceil(tiles / min(want, tiles))
        return Path("split", math.ceil(tiles / per), per * SPLIT_TILE)
    if dtype == torch.bfloat16:
        return Path("tc", 1, 0)
    return Path("simt", 1, 0)


def _check(q, k, v, mask_len):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, S, heads, D)")
    b, sq, h, dk = q.shape
    kb, skv, kvh, kd = k.shape
    vb, vs, vh, _ = v.shape
    if kb != b or vb != b or vs != skv or vh != kvh or kd != dk:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    dt = q.dtype
    if k.dtype != dt or v.dtype != dt:
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    if (k.device != dev or v.device != dev
            or (mask_len is not None and mask_len.device != dev)):
        xs = [q, k, v] + ([] if mask_len is None else [mask_len])
        raise ValueError(f"inputs on several devices: "
                         f"{ {x.device for x in xs} }")
    if mask_len is not None and (mask_len.shape not in ((b,), (b, sq))):
        raise ValueError(f"mask_len must be (B,) or (B, Sq), got "
                         f"{tuple(mask_len.shape)}")


@functools.lru_cache(maxsize=64)
def padded_dims(dk: int, dv: int) -> tuple[int, int]:
    """The built (Dk′, Dv′) a call at (Dk, Dv) launches: the pair itself
    where it is built, else the built pair of least Dk′ + Dv′ with
    Dk′ ≥ Dk and Dv′ ≥ Dv.  Raises past :data:`MAX_HEAD_DIM`."""
    if (dk, dv) in HEAD_DIMS:
        return dk, dv
    fits = [p for p in HEAD_DIMS if p[0] >= dk and p[1] >= dv]
    if not fits:
        raise ValueError(f"the kernels take head dims up to {MAX_HEAD_DIM} "
                         f"(the built (Dk, Dv) pairs {list(HEAD_DIMS)}), "
                         f"got ({dk}, {dv})")
    return min(fits, key=lambda p: (p[0] + p[1], p))


def pad_head_dims(q, k, v, dims: tuple[int, int]):
    """q and k zero-padded to Dk′ = ``dims[0]``, v to Dv′ = ``dims[1]``
    along the last axis (new contiguous tensors; an input already at its
    width is returned as it is)."""
    dk, dv = dims

    def pad(x, n):
        return x if x.shape[3] == n else F.pad(x, (0, n - x.shape[3]))

    return pad(q, dk), pad(k, dk), pad(v, dv)


def _check_kernel(q, k, v, mask_len):
    """What every path of the kernels takes; raises on anything else."""
    dims = (q.shape[3], v.shape[3])
    if dims not in HEAD_DIMS:
        raise ValueError(f"the kernels are built for the (Dk, Dv) head dims "
                         f"{list(HEAD_DIMS)}, got {dims}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the kernel takes {KERNEL_DTYPES}, got {q.dtype}")
    # the split and tensor-core paths copy 16-byte pieces of each row
    vec = 16 // q.element_size()
    for x in (q, k, v):
        sb, ss, sh, sd = x.stride()
        if sd != 1:
            raise ValueError("the kernel takes a contiguous last dimension")
        if x.data_ptr() % 16 or (sb | ss | sh) % vec:
            raise ValueError("the kernel takes rows that start on 16 bytes "
                             "(aligned storage, strides a multiple of "
                             f"{vec} elements)")
    if mask_len is not None and mask_len.dtype != torch.int32:
        raise TypeError(f"mask_len must be int32, got {mask_len.dtype}")


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward: ``apply(q, k, v, causal, scale,
    q_chunk, kv_chunk, path)``.  On the card (``path`` a :class:`Path`,
    tc or simt, inputs already checked) the forward kernel with its lse
    and the backward kernel; on the CPU (``path`` None) the twins, whose
    chunks ``q_chunk``/``kv_chunk`` set.  Saves q, k, v, the output and
    the lse (the reference's residuals)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_chunk, kv_chunk, path):
        if path is None:
            o, lse = flash_attention_ref(q, k, v, causal=causal,
                                         q_chunk=q_chunk, kv_chunk=kv_chunk,
                                         scale=scale, return_lse=True)
        else:
            o, lse = flash_attention_cuda(q, k, v, causal, None, scale, path,
                                          return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, q_chunk, kv_chunk, path)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, q_chunk, kv_chunk, path = ctx.args
        if path is None:
            grads = flash_attention_bwd_ref(q, k, v, o, lse, dout,
                                            causal=causal, q_chunk=q_chunk,
                                            kv_chunk=kv_chunk, scale=scale)
        else:
            grads = flash_attention_bwd_cuda(q, k, v, o, lse,
                                             dout.contiguous(), causal, scale)
        return (*grads, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, mask_len: torch.Tensor | None = None,
                    q_chunk: int = 512, kv_chunk: int = 512) -> torch.Tensor:
    """q (B, Sq, H, Dk), k (B, Skv, KV, Dk), v (B, Skv, KV, Dv) →
    (B, Sq, H, Dv) in q's dtype.

    ``causal`` aligns the diagonal at the end (query i sees keys
    ≤ i + Skv − Sq); ``mask_len`` — int32 (B,) or (B, Sq) — masks keys
    ≥ the length.  ``q_chunk``/``kv_chunk`` are the plain twin's chunks
    (the kernels have their own tiles).  The CPU twin takes Dv ≠ Dk, as
    the reference's oracle does.  On the card: Dk and Dv up to
    :data:`MAX_HEAD_DIM` (a pair not in :data:`HEAD_DIMS` padded, see
    :func:`padded_dims`), float32 or bfloat16, each input's last
    dimension contiguous and its rows on 16 bytes (K and V may have
    different strides, as MLA's sliced V does).  The scale is
    Dk^-0.5.

    Differentiable: with grad mode on and an input that requires grad,
    through :class:`FlashAttention` (no length mask on the card: the
    reference differentiates only its unmasked op, and on the CPU a
    masked call differentiates through the twin's own ops)."""
    _check(q, k, v, mask_len)
    grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    dev = q.device
    b, sq, h, d = q.shape
    if dev.type == "cpu":
        if grad and mask_len is None:
            return FlashAttention.apply(q, k, v, causal, d ** -0.5, q_chunk,
                                        kv_chunk, None)
        return flash_attention_ref(q, k, v, causal=causal, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk, bias_mask_len=mask_len)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if grad and mask_len is not None:
        raise NotImplementedError(
            "the flash backward kernel takes no length mask (the "
            "reference differentiates only its unmasked attention)")
    dv = v.shape[3]
    dims = padded_dims(d, dv)
    if dims != (d, dv):
        q, k, v = pad_head_dims(q, k, v, dims)
    _check_kernel(q, k, v, mask_len)
    skv, kvh = k.shape[1], k.shape[2]
    path = choose_path(q.dtype, b, sq, h, kvh, skv, sms=_sm_count(dev.index),
                       dims=dims, grad=grad)
    if grad:
        o = FlashAttention.apply(q, k, v, causal, d ** -0.5, q_chunk,
                                 kv_chunk, path)
    else:
        o = flash_attention_cuda(q, k, v, causal, mask_len, d ** -0.5, path)
    return o if o.shape[3] == dv else o[..., :dv].contiguous()


@functools.cache
def _sm_count(index: int | None) -> int:
    return torch.cuda.get_device_properties(
        index if index is not None else torch.cuda.current_device()
    ).multi_processor_count
