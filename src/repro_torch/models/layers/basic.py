"""Norms, embeddings, and dense projections.

Each layer is a small ``nn.Module`` that holds the reference's parameter
names as frozen parameters; the function beside it takes the module as
the reference's function takes its parameter dict, ``f(p, x)``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..common import const_param, dense_init, gather_layer


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = const_param((d,), 1.0, torch.float32, device)


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # statistics in fp32; the normalised activation stays in x's dtype
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p.scale.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = const_param((d,), 1.0, torch.float32, device)
        self.bias = const_param((d,), 0.0, torch.float32, device)


def layer_norm(p: LayerNorm, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Statistics and the affine map in fp32, result in x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * p.scale + p.bias
    return y.to(dt)


class Embedding(nn.Module):
    def __init__(self, gen, vocab: int, d: int, dtype, device=None):
        super().__init__()
        self.table = dense_init(gen, (vocab, d), dtype, scale=1.0,
                                device=device)


def embed(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return p.table[tokens]


class Head(nn.Module):
    """An untied output projection (vocab, d), fan-in init over the vocab
    axis as the reference's ``head_init``."""

    def __init__(self, gen, vocab: int, d: int, dtype, device=None):
        super().__init__()
        self.w = dense_init(gen, (vocab, d), dtype, device=device)


def unembed(p_emb: Embedding, p_head, x: torch.Tensor,
            tie: bool) -> torch.Tensor:
    """Vocabulary logits in fp32, accumulated in fp32 (tied to the
    embedding, or through ``p_head.w`` (vocab, d)).  The operands are
    upcast first: a bf16 matmul would round its output to bf16."""
    w = p_emb.table if tie else p_head.w
    return torch.matmul(x.float(), w.float().t())


def token_embeddings(params, tokens: torch.Tensor, tie: bool):
    """(``params.embed``'s rows of ``tokens``, the table gathered for
    the head where it is tied to it, else None), the table gathered
    (``common.gather_layer``) once for both ends of a tied model."""
    emb = gather_layer(params.embed)
    return embed(emb, tokens), (emb if tie else None)


def head_logits(params, x: torch.Tensor, tie: bool, emb=None):
    """:func:`unembed` through ``params.head`` gathered here, or the
    tied table: ``emb`` where :func:`token_embeddings` gathered it."""
    if not tie:
        return unembed(None, gather_layer(params.head), x, False)
    return unembed(emb if emb is not None else gather_layer(params.embed),
                   None, x, True)


class Linear(nn.Module):
    def __init__(self, gen, d_in: int, d_out: int, dtype, bias: bool = False,
                 device=None):
        super().__init__()
        self.w = dense_init(gen, (d_in, d_out), dtype, device=device)
        self.b = const_param((d_out,), 0.0, dtype, device) if bias else None


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p.w).to(x.dtype)
    if p.b is not None:
        y = y + p.b
    return y
