"""Public op: attention in the model layout, dispatched by the device of
its inputs.

Tensors on the card go through the CUDA kernel; tensors on the CPU go
through the plain twin.  The two never stand in for each other.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import flash_attention_ref

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, mask_len):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, S, heads, D)")
    b, sq, h, _ = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != q.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over "
                         f"{k.shape[2]} kv heads")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    xs = [q, k, v] + ([] if mask_len is None else [mask_len])
    devs = {x.device for x in xs}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if mask_len is not None and (mask_len.shape not in ((b,), (b, sq))):
        raise ValueError(f"mask_len must be (B,) or (B, Sq), got "
                         f"{tuple(mask_len.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, mask_len: torch.Tensor | None = None,
                    q_chunk: int = 512, kv_chunk: int = 512) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, KV, D) → (B, Sq, H, D) in q's dtype.

    ``causal`` aligns the diagonal at the end (query i sees keys
    ≤ i + Skv − Sq); ``mask_len`` — int32 (B,) or (B, Sq) — masks keys
    ≥ the length.  ``q_chunk``/``kv_chunk`` are the plain twin's chunks
    (the kernel has its own tiles).  On the card: D a multiple of 16 up to
    128, float32 or bfloat16, each input's last dimension contiguous."""
    _check(q, k, v, mask_len)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk, bias_mask_len=mask_len)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    d = q.shape[3]
    if d % 16 or not 0 < d <= 128:
        raise ValueError(f"the kernel takes a head dim that is a multiple "
                         f"of 16 up to 128, got {d}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the kernel takes {KERNEL_DTYPES}, got {q.dtype}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("the kernel takes a contiguous last dimension")
    if mask_len is not None and mask_len.dtype != torch.int32:
        raise TypeError(f"mask_len must be int32, got {mask_len.dtype}")
    return flash_attention_cuda(q, k, v, causal, mask_len, d ** -0.5)
