"""Hybrid Mamba + attention stack (Jamba, arXiv:2403.19887).

Layer pattern as the reference's ``models/hybrid.py``: one attention
layer per ``attn_period`` (Jamba: 1 in 8) and an FFN after every mixer,
organised as ``n_layers / attn_period`` super-blocks.  The reference
stacks each super-block's parameters on a leading axis and scans over
them; here super-blocks are ``ModuleList`` entries and the scan is a
Python loop.  With ``cfg.remat`` and grad mode on, each super-block is
recomputed in the backward (``common.remat``), as the reference's
``jax.checkpoint``.

FFN j of a super-block is the top-k MoE where the global layer index is
MoE (every ``moe_period``-th layer, Jamba: 2), else the dense SwiGLU;
the parameters sit in ``ffn_moe`` and ``ffn_dense`` in that order, as
the reference stacks them.  With ``moe_experts=0`` every FFN is dense.

Decode state per super-block: one KV cache and ``attn_period − 1``
(conv, ssm) Mamba states, in the reference's stacked layout — kv
(nsb, B, T, KV, hd), conv (nsb, ap−1, B, d_conv−1, d_inner) in the
config dtype, ssm (nsb, ap−1, B, d_inner, d_state) float32 — updated in
place.  The prefill is a decode step at index 0 over the whole prompt,
as in the reference, so it fills the same caches.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .common import ModelConfig, remat
from .layers.attention import GQA, gqa_apply
from .layers.basic import Embedding, Head, RMSNorm, embed, rms_norm, unembed
from .layers.ffn import MoE, SwiGLU, moe_apply, swiglu
from .layers.recurrent import Mamba, _mamba_dims, mamba_apply, mamba_step
from .layers.rope import rope_angles


def _superblock_layout(cfg: ModelConfig):
    """(layers a super-block, its MoE FFNs' indices, its dense ones'):
    layer 0 is attention, the rest Mamba; FFN j is MoE iff the global
    layer index is, which needs attn_period % moe_period == 0."""
    ap = cfg.attn_period
    if ap <= 0 or cfg.n_layers % ap:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of attn_period {ap} > 0")
    if cfg.is_moe and ap % cfg.moe_period:
        raise ValueError(f"{cfg.name}: attn_period {ap} is not a multiple "
                         f"of moe_period {cfg.moe_period}")
    moe_js = [j for j in range(ap)
              if cfg.is_moe and j % cfg.moe_period == cfg.moe_period - 1]
    dense_js = [j for j in range(ap) if j not in moe_js]
    return ap, moe_js, dense_js


class SuperBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        ap, moe_js, dense_js = _superblock_layout(cfg)
        d = cfg.d_model
        self.attn = GQA(cfg, gen, device)
        self.attn_ln = RMSNorm(d, device)
        self.mamba = nn.ModuleList(Mamba(cfg, gen, device)
                                   for _ in range(ap - 1))
        self.mamba_ln = nn.ModuleList(RMSNorm(d, device)
                                      for _ in range(ap - 1))
        self.ffn_ln = nn.ModuleList(RMSNorm(d, device) for _ in range(ap))
        self.ffn_dense = nn.ModuleList(SwiGLU(cfg, gen, device=device)
                                       for _ in dense_js)
        self.ffn_moe = (nn.ModuleList(MoE(cfg, gen, device) for _ in moe_js)
                        if moe_js else None)


def _superblock_apply(cfg: ModelConfig, p: SuperBlock, x, *, angles,
                      cache=None, sb=0, cache_index=None):
    """One super-block: (x, its summed MoE auxiliary loss); with
    ``cache``, super-block ``sb``'s states are read and written in
    place."""
    eps = cfg.norm_eps
    ap, moe_js, dense_js = _superblock_layout(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(ap):
        if j == 0:
            h = rms_norm(p.attn_ln, x, eps)
            kv = (None if cache is None else
                  {"k": cache["kv"]["k"][sb], "v": cache["kv"]["v"][sb]})
            attn, _ = gqa_apply(cfg, p.attn, h, angles=angles, cache=kv,
                                cache_index=cache_index)
            x = x + attn
        else:
            h = rms_norm(p.mamba_ln[j - 1], x, eps)
            if cache is None:
                x = x + mamba_apply(cfg, p.mamba[j - 1], h)
            else:
                st = {"conv": cache["conv"][sb, j - 1],
                      "ssm": cache["ssm"][sb, j - 1]}
                y, new = mamba_step(cfg, p.mamba[j - 1], h, st)
                st["conv"].copy_(new["conv"])
                st["ssm"].copy_(new["ssm"])
                x = x + y
        h = rms_norm(p.ffn_ln[j], x, eps)
        if j in moe_js:
            y, a = moe_apply(cfg, p.ffn_moe[moe_js.index(j)], h)
            aux = aux + a
        else:
            y = swiglu(p.ffn_dense[dense_js.index(j)], h)
        x = x + y
    return x, aux


class Hybrid(nn.Module):
    """Parameters of the whole model, named as the reference's tree."""

    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        nsb = cfg.n_layers // _superblock_layout(cfg)[0]
        dt = cfg.torch_dtype
        self.embed = Embedding(gen, cfg.vocab, cfg.d_model, dt, device)
        self.blocks = nn.ModuleList(SuperBlock(cfg, gen, device)
                                    for _ in range(nsb))
        self.ln_f = RMSNorm(cfg.d_model, device)
        self.head = Head(gen, cfg.vocab, cfg.d_model, dt, device)


def init(cfg: ModelConfig, seed: int = 0, device=None) -> Hybrid:
    """Random parameters from ``seed``, drawn on ``device`` (default: the
    card; ``"meta"`` allocates nothing)."""
    if device is not None and torch.device(device).type == "meta":
        return Hybrid(cfg, None, "meta")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Hybrid(cfg, gen, dev)


def _run(cfg, params: Hybrid, x, positions, cache=None, cache_index=None):
    """(logits, the auxiliary loss summed over the super-blocks)."""
    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for sb, p in enumerate(params.blocks):
        if cache is None:
            x, a = remat(cfg, _superblock_apply, cfg, p, x, angles=angles,
                         sb=sb)
        else:
            x, a = _superblock_apply(cfg, p, x, angles=angles, cache=cache,
                                     sb=sb, cache_index=cache_index)
        aux = aux + a
    x = rms_norm(params.ln_f, x, cfg.norm_eps)
    return unembed(params.embed, params.head, x, cfg.tie_embeddings), aux


def _positions(b, s, start, device):
    return (torch.arange(s, dtype=torch.int32, device=device)
            + start)[None].expand(b, s)


def forward(cfg: ModelConfig, params: Hybrid, tokens, positions=None,
            embeds=None):
    """Logits (B, S, vocab) in fp32 and the MoE auxiliary loss (0: no
    experts)."""
    x = embeds if embeds is not None else embed(params.embed, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = _positions(b, s, 0, x.device)
    return _run(cfg, params, x, positions)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    dt = dtype or cfg.torch_dtype
    dev = resolve_device(device)
    ap = _superblock_layout(cfg)[0]
    nsb = cfg.n_layers // ap
    di, _, ds, dc = _mamba_dims(cfg)
    kv = (nsb, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": {"k": torch.zeros(kv, dtype=dt, device=dev),
                   "v": torch.zeros(kv, dtype=dt, device=dev)},
            "conv": torch.zeros((nsb, ap - 1, batch, dc - 1, di), dtype=dt,
                                device=dev),
            "ssm": torch.zeros((nsb, ap - 1, batch, di, ds),
                               dtype=torch.float32, device=dev)}


def decode_step(cfg: ModelConfig, params: Hybrid, tokens, cache, index: int,
                positions=None):
    """Tokens (B, S) appended at ``index``: logits (B, S, vocab) in fp32,
    and the cache (updated in place)."""
    x = embed(params.embed, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = _positions(b, s, index, x.device)
    return _run(cfg, params, x, positions, cache, index)[0], cache


def prefill(cfg: ModelConfig, params: Hybrid, tokens, cache,
            positions=None):
    return decode_step(cfg, params, tokens, cache, 0, positions)
