"""Attention: the op dispatch, the GQA layer with its KV cache, the
encoder–decoder cross-attention layer, and MLA (multi-head latent
attention, MiniCPM3 / DeepSeek-V2) with its compressed cache.

The reference's ``hint_*`` sharding annotations have no meaning on one
device and are dropped.  Its training-only custom VJP (the flash
backward) waits for training (ROADMAP item 11.6).
"""

from __future__ import annotations

import torch
from torch import nn

from ...kernels.flash_attention import ops as flash_ops
from ..common import ModelConfig, dense_init
from .basic import RMSNorm, rms_norm
from .rope import apply_rope, rope_angles


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


# ---------------------------------------------------------------------- #
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------- #
class MLA(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dvh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        dt = cfg.torch_dtype
        self.q_down = dense_init(gen, (d, qr), dt, device=device)
        self.q_norm = RMSNorm(qr, device)
        self.q_up = dense_init(gen, (qr, h * (dn + dr)), dt, device=device)
        self.kv_down = dense_init(gen, (d, kvr + dr), dt, device=device)
        self.kv_norm = RMSNorm(kvr, device)
        self.kv_up = dense_init(gen, (kvr, h * (dn + dvh)), dt,
                                device=device)
        self.wo = dense_init(gen, (h * dvh, d), dt, device=device)


def mla_apply(cfg: ModelConfig, p: MLA, x, *, positions, causal=True,
              cache=None, cache_index=None):
    """x (B, S, d), positions (B, S) int.  RoPE turns only the
    ``qk_rope_dim`` sub-dims of q and the one shared k_rope.  ``cache``:
    optional dict(c_kv (B, T, kv_lora_rank), k_rope (B, T, qk_rope_dim)),
    the compressed latents, written at ``cache_index`` in place; the
    latents of the whole cache are then expanded per head (the
    reference's expansion, not the absorbed product) and attention runs
    with Dk = nope + rope dims, Dv = ``v_head_dim``, query t seeing keys
    < cache_index + t + 1.  Returns (out, cache)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dvh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    q = rms_norm(p.q_norm, torch.matmul(x, p.q_down), cfg.norm_eps)
    q = torch.matmul(q, p.q_up).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ang = rope_angles(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, ang)

    ckv = torch.matmul(x, p.kv_down)
    c_kv = rms_norm(p.kv_norm, ckv[..., :kvr], cfg.norm_eps)
    k_rope = apply_rope(ckv[:, :, None, kvr:], ang)[:, :, 0]

    mask_len = None
    if cache is not None:
        cc, cr = cache["c_kv"], cache["k_rope"]
        cc[:, cache_index:cache_index + s] = c_kv.to(cc.dtype)
        cr[:, cache_index:cache_index + s] = k_rope.to(cr.dtype)
        c_kv, k_rope = cc, cr
        mask_len = (torch.arange(s, dtype=torch.int32, device=x.device)
                    + (cache_index + 1))[None].expand(b, s)
        causal = False

    skv = c_kv.shape[1]
    kvu = torch.matmul(c_kv.to(x.dtype), p.kv_up).reshape(b, skv, h,
                                                          dn + dvh)
    k = torch.cat([kvu[..., :dn],
                   k_rope[:, :, None, :].to(x.dtype).expand(b, skv, h, dr)],
                  dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = attention_op(cfg, q_full, k, kvu[..., dn:], causal=causal,
                       mask_len=mask_len)
    out = torch.matmul(out.reshape(b, s, h * dvh), p.wo)
    return out.to(x.dtype), cache
