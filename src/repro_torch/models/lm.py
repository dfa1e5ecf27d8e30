"""Decoder-only LM: the dense family (codeqwen1.5-7b, internlm2-1.8b,
stablelm-3b), the MoE family (qwen2-moe-a2.7b, dbrx-132b: every layer's
FFN the top-k MoE), MLA (minicpm3-4b) and the vlm (qwen2-vl-2b).

The vlm differs only in its positions: (3, B, S) t/h/w ids drive
M-RoPE where ``cfg.mrope_sections`` is set, and a stub modality
frontend hands in merged patch and token embeddings (``embeds=``).
Without ids the positions count from the call's cache index, equal on
all three rows, as the reference's.  Blocks are
``ModuleList`` entries and the reference's ``lax.scan`` over stacked
layers is a Python loop; its ``hint_bsd`` sharding annotation has no
meaning on one device.  With ``cfg.remat`` and grad mode on, each block
is recomputed in the backward (``common.remat``), as the reference's
``jax.checkpoint``.  Every attention call goes through
``attention_op``: on the card the hand-written flash kernel, on the CPU
its plain twin.

Decode state: the reference's stacked layouts, written in place: k and
v each (n_layers, B, T, KV, hd) in the config dtype; with MLA the
compressed latents c_kv (n_layers, B, T, kv_lora_rank) and k_rope
(n_layers, B, T, qk_rope_dim).

API (as the reference's):
  init(cfg, seed, device) -> params
  forward(cfg, params, tokens, positions=None, embeds=None) -> (logits, aux)
  init_cache(cfg, batch, max_len) -> cache
  prefill(cfg, params, tokens, cache, positions=None, embeds=None)
      -> (logits, cache)
  decode_step(cfg, params, tokens, cache, index, positions=None)
      -> (logits, cache)
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .common import ModelConfig, remat
from .layers.attention import GQA, MLA, gqa_apply, mla_apply
from .layers.basic import Embedding, Head, RMSNorm, embed, rms_norm, unembed
from .layers.ffn import MoE, SwiGLU, moe_apply, swiglu
from .layers.rope import mrope_angles, rope_angles


def _uses_moe(cfg: ModelConfig) -> bool:
    return cfg.is_moe and cfg.moe_period == 1


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.attn = (MLA if cfg.mla else GQA)(cfg, gen, device)
        self.ffn = (MoE(cfg, gen, device) if _uses_moe(cfg)
                    else SwiGLU(cfg, gen, device=device))


def _block_apply(cfg: ModelConfig, p: Block, x, *, angles, positions,
                 cache=None, cache_index=None):
    """One layer: (x, the MoE auxiliary loss or None)."""
    h = rms_norm(p.ln1, x, cfg.norm_eps)
    if cfg.mla:
        attn, _ = mla_apply(cfg, p.attn, h, positions=positions,
                            cache=cache, cache_index=cache_index)
    else:
        attn, _ = gqa_apply(cfg, p.attn, h, angles=angles, cache=cache,
                            cache_index=cache_index)
    x = x + attn
    h = rms_norm(p.ln2, x, cfg.norm_eps)
    if _uses_moe(cfg):
        y, aux = moe_apply(cfg, p.ffn, h)
        return x + y, aux
    return x + swiglu(p.ffn, h), None


class LM(nn.Module):
    """Parameters of the whole model, named as the reference's tree."""

    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
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


def _default_positions(cfg: ModelConfig, b, s, start, device):
    """(B, S) int32 from ``start``; (3, B, S), the rows equal, with
    M-RoPE."""
    pos = (torch.arange(s, dtype=torch.int32, device=device)
           + start)[None].expand(b, s)
    return pos[None].expand(3, b, s) if cfg.mrope_sections else pos


def _angles_for(cfg: ModelConfig, positions):
    """positions: (B, S) int, or (3, B, S) t/h/w ids for M-RoPE (a
    configuration without it reads row 0)."""
    if cfg.mla:
        return None  # MLA turns its rope sub-dims itself
    if cfg.mrope_sections:
        if positions.ndim != 3:
            raise ValueError(f"{cfg.name}: M-RoPE needs (3, B, S) position "
                             f"ids, got {tuple(positions.shape)}")
        return mrope_angles(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    if positions.ndim == 3:
        positions = positions[0]
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _run(cfg, params: LM, x, positions, cache=None, cache_index=None):
    """(logits, the summed auxiliary loss, fp32)."""
    angles = _angles_for(cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(params.blocks):
        if cache is None:
            x, a = remat(cfg, _block_apply, cfg, p, x, angles=angles,
                         positions=positions)
        else:
            layer = {k: c[i] for k, c in cache.items()}
            x, a = _block_apply(cfg, p, x, angles=angles, positions=positions,
                                cache=layer, cache_index=cache_index)
        if a is not None:
            aux = aux + a
    x = rms_norm(params.ln_f, x, cfg.norm_eps)
    return unembed(params.embed, params.head, x, cfg.tie_embeddings), aux


def forward(cfg: ModelConfig, params: LM, tokens, positions=None,
            embeds=None):
    """tokens (B, S) int, or ``embeds`` (B, S, d): logits (B, S, vocab)
    in fp32 and the MoE auxiliary loss summed over the layers (0: no
    experts)."""
    x = embeds if embeds is not None else embed(params.embed, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = _default_positions(cfg, b, s, 0, x.device)
    return _run(cfg, params, x, positions)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    dt = dtype or cfg.torch_dtype
    dev = resolve_device(device)
    lead = (cfg.n_layers, batch, max_len)
    if cfg.mla:
        return {"c_kv": torch.zeros((*lead, cfg.kv_lora_rank), dtype=dt,
                                    device=dev),
                "k_rope": torch.zeros((*lead, cfg.qk_rope_dim), dtype=dt,
                                      device=dev)}
    shape = (*lead, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _apply_with_cache(cfg, params: LM, tokens, cache, index, positions,
                      embeds):
    x = embeds if embeds is not None else embed(params.embed, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = _default_positions(cfg, b, s, index, x.device)
    return _run(cfg, params, x, positions, cache, index)[0], cache


def decode_step(cfg: ModelConfig, params: LM, tokens, cache, index: int,
                positions=None):
    """Tokens (B, S) appended at ``index``: logits (B, S, vocab) in fp32,
    and the cache (updated in place)."""
    return _apply_with_cache(cfg, params, tokens, cache, index, positions,
                             None)


def prefill(cfg: ModelConfig, params: LM, tokens, cache, positions=None,
            embeds=None):
    """The prompt from index 0: ``tokens`` (B, S), or ``embeds`` (B, S, d)
    from a stub frontend (``tokens`` then unread)."""
    return _apply_with_cache(cfg, params, tokens, cache, 0, positions,
                             embeds)
