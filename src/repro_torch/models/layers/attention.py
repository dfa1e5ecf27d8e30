"""Attention: the op dispatch, the GQA layer with its KV cache, and the
encoder–decoder cross-attention layer.

The reference's ``hint_*`` sharding annotations have no meaning on one
device and are dropped.  Its training-only custom VJP (the flash
backward) and MLA wait for later slices (ROADMAP item 11).
"""

from __future__ import annotations

import torch
from torch import nn

from ...kernels.flash_attention import ops as flash_ops
from ..common import ModelConfig, dense_init
from .rope import apply_rope


def attention_op(cfg: ModelConfig, q, k, v, *, causal, mask_len=None):
    """On the card always the flash kernel (every call, cached or not);
    on the CPU its plain twin, chunked as the config says."""
    return flash_ops.flash_attention(q, k, v, causal=causal,
                                     mask_len=mask_len,
                                     q_chunk=cfg.attn_q_chunk,
                                     kv_chunk=cfg.attn_kv_chunk)


# ---------------------------------------------------------------------- #
# GQA attention layer
# ---------------------------------------------------------------------- #
class GQA(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = cfg.torch_dtype
        self.wq = dense_init(gen, (d, h * hd), dt, device=device)
        self.wk = dense_init(gen, (d, kv * hd), dt, device=device)
        self.wv = dense_init(gen, (d, kv * hd), dt, device=device)
        self.wo = dense_init(gen, (h * hd, d), dt, device=device)


def gqa_apply(cfg: ModelConfig, p: GQA, x, *, angles=None, causal=True,
              cache=None, cache_index=None):
    """x: (B, S, d).  ``angles``: optional RoPE angles (B, S, hd/2),
    applied to q and k before the cache write.  ``cache``: optional
    dict(k, v) of (B, T, KV, hd) for decoding — new K/V are written at
    ``cache_index`` (in place, where the reference returns an updated
    copy) and attention runs over the whole cache, query t seeing keys
    < cache_index + t + 1; returns (out, cache)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.matmul(x, p.wq).reshape(b, s, h, hd)
    k = torch.matmul(x, p.wk).reshape(b, s, kv, hd)
    v = torch.matmul(x, p.wv).reshape(b, s, kv, hd)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_index:cache_index + s] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + s] = v.to(cv.dtype)
        mask_len = (torch.arange(s, dtype=torch.int32, device=x.device)
                    + (cache_index + 1))[None].expand(b, s)
        out = attention_op(cfg, q, ck.to(q.dtype), cv.to(q.dtype),
                           causal=False, mask_len=mask_len)
    else:
        out = attention_op(cfg, q, k, v, causal=causal)
    out = torch.matmul(out.reshape(b, s, h * hd), p.wo)
    return out.to(x.dtype), cache


# ---------------------------------------------------------------------- #
# cross attention (enc-dec): a GQA layer's parameters, applied to the
# encoder output's keys and values
# ---------------------------------------------------------------------- #
def cross_apply(cfg: ModelConfig, p: GQA, x, enc_kv):
    """enc_kv: dict(k, v) precomputed from the encoder output."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = torch.matmul(x, p.wq).reshape(b, s, h, hd)
    out = attention_op(cfg, q, enc_kv["k"], enc_kv["v"], causal=False)
    out = torch.matmul(out.reshape(b, s, h * hd), p.wo)
    return out.to(x.dtype)


def cross_kv(cfg: ModelConfig, p: GQA, enc_out):
    b, se, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    k = torch.matmul(enc_out, p.wk).reshape(b, se, kv, hd)
    v = torch.matmul(enc_out, p.wv).reshape(b, se, kv, hd)
    return {"k": k, "v": v}
