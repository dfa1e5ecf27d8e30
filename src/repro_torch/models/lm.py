"""Decoder-only LM: the dense family (codeqwen1.5-7b, internlm2-1.8b,
stablelm-3b).

The reference's ``models/lm.py`` also covers the MoE FFN, MLA and the
vlm's M-RoPE; here a configuration with any of them raises (ROADMAP
queue 1, items 11.2–11.4).  Blocks are ``ModuleList`` entries and the
reference's ``lax.scan`` over stacked layers is a Python loop; its
``hint_bsd`` sharding annotation has no meaning on one device.  Every
attention call goes through ``attention_op``: on the card the
hand-written flash kernel, on the CPU its plain twin.

Decode state: the reference's stacked KV layout, k and v each
(n_layers, B, T, KV, hd) in the config dtype, written in place.

API (as the reference's):
  init(cfg, seed, device) -> params
  forward(cfg, params, tokens, positions=None, embeds=None) -> (logits, aux)
  init_cache(cfg, batch, max_len) -> cache
  prefill(cfg, params, tokens, cache, positions=None) -> (logits, cache)
  decode_step(cfg, params, tokens, cache, index, positions=None)
      -> (logits, cache)
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .common import ModelConfig
from .layers.attention import GQA, gqa_apply
from .layers.basic import Embedding, Head, RMSNorm, embed, rms_norm, unembed
from .layers.ffn import SwiGLU, swiglu
from .layers.rope import rope_angles


def _check_config(cfg: ModelConfig) -> None:
    """Raise for the parts of the reference's LM the port lacks."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN is not ported yet (ROADMAP item 11.2)")
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP item "
            f"11.3)")
    if cfg.mrope_sections:
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE is not ported yet (ROADMAP item 11.4)")


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.attn = GQA(cfg, gen, device)
        self.ffn = SwiGLU(cfg, gen, device=device)


def _block_apply(cfg: ModelConfig, p: Block, x, *, angles, cache=None,
                 cache_index=None):
    h = rms_norm(p.ln1, x, cfg.norm_eps)
    attn, _ = gqa_apply(cfg, p.attn, h, angles=angles, cache=cache,
                        cache_index=cache_index)
    x = x + attn
    h = rms_norm(p.ln2, x, cfg.norm_eps)
    return x + swiglu(p.ffn, h)


class LM(nn.Module):
    """Parameters of the whole model, named as the reference's tree."""

    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        _check_config(cfg)
        dt = cfg.torch_dtype
        self.embed = Embedding(gen, cfg.vocab, cfg.d_model, dt, device)
        self.blocks = nn.ModuleList(Block(cfg, gen, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, device)
        self.head = (None if cfg.tie_embeddings else
                     Head(gen, cfg.vocab, cfg.d_model, dt, device))


def init(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """Random parameters from ``seed``, drawn on ``device`` (default: the
    card; ``"meta"`` allocates nothing)."""
    if device is not None and torch.device(device).type == "meta":
        return LM(cfg, None, "meta")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, gen, dev)


def _positions(b, s, start, device):
    return (torch.arange(s, dtype=torch.int32, device=device)
            + start)[None].expand(b, s)


def _run(cfg, params: LM, x, positions, cache=None, cache_index=None):
    angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    for i, p in enumerate(params.blocks):
        kv = (None if cache is None else
              {"k": cache["k"][i], "v": cache["v"][i]})
        x = _block_apply(cfg, p, x, angles=angles, cache=kv,
                         cache_index=cache_index)
    x = rms_norm(params.ln_f, x, cfg.norm_eps)
    return unembed(params.embed, params.head, x, cfg.tie_embeddings)


def forward(cfg: ModelConfig, params: LM, tokens, positions=None,
            embeds=None):
    """tokens (B, S) int, or ``embeds`` (B, S, d): logits (B, S, vocab)
    in fp32 and the MoE auxiliary loss (0: no experts)."""
    x = embeds if embeds is not None else embed(params.embed, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = _positions(b, s, 0, x.device)
    logits = _run(cfg, params, x, positions)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    _check_config(cfg)
    dt = dtype or cfg.torch_dtype
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def decode_step(cfg: ModelConfig, params: LM, tokens, cache, index: int,
                positions=None):
    """Tokens (B, S) appended at ``index``: logits (B, S, vocab) in fp32,
    and the cache (updated in place)."""
    x = embed(params.embed, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = _positions(b, s, index, x.device)
    return _run(cfg, params, x, positions, cache, index), cache


def prefill(cfg: ModelConfig, params: LM, tokens, cache, positions=None):
    return decode_step(cfg, params, tokens, cache, 0, positions)
