"""Whisper-style encoder–decoder backbone (arXiv:2212.04356).

The conv audio frontend is a stub: ``encode`` consumes precomputed frame
embeddings (B, S_audio, d).  Encoder: bidirectional self-attention + GELU
MLP, sinusoidal positions.  Decoder: causal self-attention +
cross-attention + GELU MLP, learned positions; decoding caches self-KV
per layer and recomputes the cross-KV from the encoder output on every
call, as the reference does.  LayerNorm (not RMS) throughout, pre-norm.

The reference stacks each layer's parameters on a leading axis and scans
over them; here the layers are ``ModuleList`` entries and the scan is a
Python loop.  The KV cache keeps the reference's stacked layout,
(L, B, T, KV, hd), and is updated in place.  With ``cfg.remat`` and
grad mode on, each block is recomputed in the backward
(``common.remat``), as the reference's ``jax.checkpoint`` (a decoder
block without its ``cross_kv``, which the reference computes outside
the checkpoint too).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .common import ModelConfig, dense_init, remat
from .layers.attention import GQA, cross_apply, cross_kv, gqa_apply
from .layers.basic import Embedding, LayerNorm, embed, layer_norm, unembed
from .layers.ffn import GeluMLP, gelu_mlp

MAX_DEC_POS = 32768  # learned decoder positions (whisper-base: 448; the
                     # 32k prefill/decode shapes need 32k)


@functools.lru_cache(maxsize=8)
def _sinusoid_np(length: int, d: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    dim = np.arange(0, d, 2)[None]
    ang = pos / np.power(10000.0, dim / d)
    out = np.zeros((length, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def _sinusoid(length: int, d: int, device) -> torch.Tensor:
    return torch.as_tensor(_sinusoid_np(length, d), device=device)


# ------------------------------ blocks -------------------------------- #
class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, device)
        self.attn = GQA(cfg, gen, device)
        self.ln2 = LayerNorm(cfg.d_model, device)
        self.mlp = GeluMLP(cfg, gen, device=device)


def _enc_block_apply(cfg, p: EncBlock, x):
    h = layer_norm(p.ln1, x, cfg.norm_eps)
    attn, _ = gqa_apply(cfg, p.attn, h, causal=False)
    x = x + attn
    h = layer_norm(p.ln2, x, cfg.norm_eps)
    return x + gelu_mlp(p.mlp, h)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, device)
        self.attn = GQA(cfg, gen, device)
        self.ln_x = LayerNorm(cfg.d_model, device)
        self.xattn = GQA(cfg, gen, device)
        self.ln2 = LayerNorm(cfg.d_model, device)
        self.mlp = GeluMLP(cfg, gen, device=device)


def _dec_block_apply(cfg, p: DecBlock, x, enc_kv, cache=None,
                     cache_index=None):
    h = layer_norm(p.ln1, x, cfg.norm_eps)
    attn, new_cache = gqa_apply(cfg, p.attn, h, causal=True, cache=cache,
                                cache_index=cache_index)
    x = x + attn
    h = layer_norm(p.ln_x, x, cfg.norm_eps)
    x = x + cross_apply(cfg, p.xattn, h, enc_kv)
    h = layer_norm(p.ln2, x, cfg.norm_eps)
    return x + gelu_mlp(p.mlp, h), new_cache


# ------------------------------ model --------------------------------- #
class EncDec(nn.Module):
    """Parameters of the whole model, named as the reference's tree."""

    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, gen, device) for _ in range(cfg.enc_layers))
        self.enc_ln = LayerNorm(cfg.d_model, device)
        self.embed = Embedding(gen, cfg.vocab, cfg.d_model, cfg.torch_dtype,
                               device)
        self.pos = dense_init(gen, (MAX_DEC_POS, cfg.d_model),
                              cfg.torch_dtype, scale=0.02, device=device)
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, gen, device) for _ in range(cfg.n_layers))
        self.dec_ln = LayerNorm(cfg.d_model, device)


def init(cfg: ModelConfig, seed: int = 0, device=None) -> EncDec:
    """Random parameters from ``seed``, drawn on ``device`` (default: the
    card; ``"meta"`` allocates nothing)."""
    if device is not None and torch.device(device).type == "meta":
        return EncDec(cfg, None, "meta")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return EncDec(cfg, gen, dev)


def encode(cfg: ModelConfig, params: EncDec, frames: torch.Tensor):
    """frames: (B, S_audio, d) stub frontend output."""
    x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                           frames.device).to(frames.dtype)
    for p in params.enc_blocks:
        x = remat(cfg, _enc_block_apply, cfg, p, x)
    return layer_norm(params.enc_ln, x, cfg.norm_eps)


def decode(cfg: ModelConfig, params: EncDec, tokens: torch.Tensor, enc_out,
           caches=None, cache_index=None):
    """Decoder logits (B, S, vocab) in fp32, and the caches (updated in
    place, or None)."""
    _, s = tokens.shape
    start = cache_index if cache_index is not None else 0
    x = embed(params.embed, tokens) + params.pos[start:start + s]
    for i, p in enumerate(params.dec_blocks):
        enc_kv = cross_kv(cfg, p.xattn, enc_out)
        if caches is None:
            x, _ = remat(cfg, _dec_block_apply, cfg, p, x, enc_kv)
            continue
        cache = {"k": caches["k"][i], "v": caches["v"][i]}
        x, _ = _dec_block_apply(cfg, p, x, enc_kv, cache=cache,
                                cache_index=cache_index)
    x = layer_norm(params.dec_ln, x, cfg.norm_eps)
    logits = unembed(params.embed, None, x, tie=True)  # whisper ties
    return logits, caches


def forward(cfg: ModelConfig, params: EncDec, tokens, positions=None,
            embeds=None):
    """Training-step layout: ``embeds`` = audio frames, tokens = text."""
    if embeds is None:
        raise ValueError("enc-dec needs frame embeddings")
    enc = encode(cfg, params, embeds)
    logits, _ = decode(cfg, params, tokens, enc)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    dt = dtype or cfg.torch_dtype
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def decode_step(cfg: ModelConfig, params: EncDec, tokens, cache, index: int,
                enc_out=None, positions=None):
    """One decoder token against cached self-KV + encoder output."""
    if enc_out is None:
        raise ValueError("decode_step needs the encoder output")
    return decode(cfg, params, tokens, enc_out, caches=cache,
                  cache_index=index)


def prefill(cfg: ModelConfig, params: EncDec, tokens, cache, enc_out=None,
            positions=None):
    return decode(cfg, params, tokens, enc_out, caches=cache, cache_index=0)
