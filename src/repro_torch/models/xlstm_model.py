"""xLSTM language model (arXiv:2405.04517): mLSTM blocks with periodic
sLSTM blocks (xLSTM[7:1] → ``slstm_period = 8``), as the reference's
``models/xlstm_model.py``.

``d_ff = 0`` in the published configuration: mLSTM blocks carry their
own 2× up/down projection; an sLSTM block is followed by a GLU FFN of
d_ff = int(4d/3).  The model is ``n_layers / slstm_period`` super-blocks
of 1 sLSTM and ``slstm_period − 1`` mLSTM layers.  The reference stacks
the super-blocks (and inside each the mLSTM layers) on leading axes and
scans over them; here they are ``ModuleList`` entries and the scan is a
Python loop.  Its ``hint_bsd`` has no meaning here; with ``cfg.remat``
and grad mode on, each super-block is recomputed in the backward
(``common.remat``), as the reference's ``jax.checkpoint``.

Decode state, the only cache: per mLSTM layer a matrix memory C
(H × dh × dh) and a normaliser n (H × dh), per sLSTM layer (c, n, h, m),
all float32 and O(1) in sequence length, in the reference's stacked
layout — sLSTM (nsb, B, H, d/H), mLSTM c (nsb, sp−1, B, H, dh, dh) and
n (nsb, sp−1, B, H, dh) — updated in place.  The prefill is a decode
step over the whole prompt, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .common import ModelConfig, remat
from .layers.basic import Embedding, Head, RMSNorm, embed, rms_norm, unembed
from .layers.ffn import SwiGLU, swiglu
from .layers.recurrent import (MLSTM, SLSTM, mlstm_apply, mlstm_init_state,
                               mlstm_step, slstm_apply, slstm_init_state,
                               slstm_step)


def _layout(cfg: ModelConfig) -> int:
    """Layers a super-block (1 sLSTM + the rest mLSTM)."""
    sp = cfg.slstm_period if cfg.slstm_period > 0 else cfg.n_layers
    if cfg.n_layers % sp:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of slstm_period {sp}")
    return sp


class SuperBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        sp = _layout(cfg)
        d = cfg.d_model
        self.slstm = SLSTM(cfg, gen, device)
        self.slstm_ln = RMSNorm(d, device)
        self.slstm_ffn = SwiGLU(cfg, gen, d_ff=int(d * 4 / 3), device=device)
        self.slstm_ffn_ln = RMSNorm(d, device)
        self.mlstm = nn.ModuleList(MLSTM(cfg, gen, device)
                                   for _ in range(sp - 1))
        self.mlstm_ln = nn.ModuleList(RMSNorm(d, device)
                                      for _ in range(sp - 1))


def _superblock_apply(cfg: ModelConfig, p: SuperBlock, x, state=None):
    """One super-block; with ``state`` (this super-block's slices of the
    cache) the layers step from it and write it in place."""
    eps = cfg.norm_eps
    h = rms_norm(p.slstm_ln, x, eps)
    if state is None:
        x = x + slstm_apply(cfg, p.slstm, h)
    else:
        x = x + slstm_step(cfg, p.slstm, h, state["slstm"])[0]
    h = rms_norm(p.slstm_ffn_ln, x, eps)
    x = x + swiglu(p.slstm_ffn, h)
    for j, (mp, ln) in enumerate(zip(p.mlstm, p.mlstm_ln)):
        h = rms_norm(ln, x, eps)
        if state is None:
            x = x + mlstm_apply(cfg, mp, h)
        else:
            st = {k: a[j] for k, a in state["mlstm"].items()}
            x = x + mlstm_step(cfg, mp, h, st)[0]
    return x


class XLSTM(nn.Module):
    """Parameters of the whole model, named as the reference's tree."""

    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        nsb = cfg.n_layers // _layout(cfg)
        dt = cfg.torch_dtype
        self.embed = Embedding(gen, cfg.vocab, cfg.d_model, dt, device)
        self.blocks = nn.ModuleList(SuperBlock(cfg, gen, device)
                                    for _ in range(nsb))
        self.ln_f = RMSNorm(cfg.d_model, device)
        self.head = Head(gen, cfg.vocab, cfg.d_model, dt, device)


def init(cfg: ModelConfig, seed: int = 0, device=None) -> XLSTM:
    """Random parameters from ``seed``, drawn on ``device`` (default: the
    card; ``"meta"`` allocates nothing)."""
    if device is not None and torch.device(device).type == "meta":
        return XLSTM(cfg, None, "meta")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return XLSTM(cfg, gen, dev)


def _run(cfg, params: XLSTM, x, cache=None):
    for sb, p in enumerate(params.blocks):
        if cache is None:
            x = remat(cfg, _superblock_apply, cfg, p, x)
            continue
        state = {part: {k: a[sb] for k, a in cache[part].items()}
                 for part in ("slstm", "mlstm")}
        x = _superblock_apply(cfg, p, x, state)
    x = rms_norm(params.ln_f, x, cfg.norm_eps)
    return unembed(params.embed, params.head, x, cfg.tie_embeddings)


def forward(cfg: ModelConfig, params: XLSTM, tokens, positions=None,
            embeds=None):
    """Logits (B, S, vocab) in fp32 from a zero state, and an auxiliary
    loss of 0; ``positions`` is unread (no position embedding)."""
    x = embeds if embeds is not None else embed(params.embed, tokens)
    logits = _run(cfg, params, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, dtype=None,
               device=None):
    """The zero recurrent state, float32 whatever ``dtype`` says; no
    sequence axis at all (``max_len`` is unread, as in the reference)."""
    dev = resolve_device(device)
    sp = _layout(cfg)
    nsb = cfg.n_layers // sp
    sl = slstm_init_state(cfg, batch, dev)
    ml = mlstm_init_state(cfg, batch, dev)
    return {"slstm": {k: a[None].repeat(nsb, *(1,) * a.ndim)
                      for k, a in sl.items()},
            "mlstm": {k: a[None, None].repeat(nsb, sp - 1, *(1,) * a.ndim)
                      for k, a in ml.items()}}


def decode_step(cfg: ModelConfig, params: XLSTM, tokens, cache, index: int,
                positions=None):
    """Tokens (B, S) stepped through the recurrent state (``index`` and
    ``positions`` unread): logits (B, S, vocab) in fp32, and the cache
    (updated in place)."""
    return _run(cfg, params, embed(params.embed, tokens), cache), cache


def prefill(cfg: ModelConfig, params: XLSTM, tokens, cache, positions=None):
    return decode_step(cfg, params, tokens, cache, 0, positions)
