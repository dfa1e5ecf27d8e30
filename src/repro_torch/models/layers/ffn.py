"""FFN layers: SwiGLU and the GELU MLP.  The top-k MoE waits for the moe
family (ROADMAP item 11)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..common import ModelConfig, const_param, dense_init


class SwiGLU(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, d_ff: int | None = None,
                 device=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        dt = cfg.torch_dtype
        self.w_gate = dense_init(gen, (d, f), dt, device=device)
        self.w_up = dense_init(gen, (d, f), dt, device=device)
        self.w_down = dense_init(gen, (f, d), dt, device=device)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, p.w_gate)
    u = torch.matmul(x, p.w_up)
    h = (F.silu(g.float()) * u.float()).to(x.dtype)
    return torch.matmul(h, p.w_down)


class GeluMLP(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, d_ff: int | None = None,
                 device=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        dt = cfg.torch_dtype
        self.w_in = dense_init(gen, (d, f), dt, device=device)
        self.b_in = const_param((f,), 0.0, dt, device)
        self.w_out = dense_init(gen, (f, d), dt, device=device)
        self.b_out = const_param((d,), 0.0, dt, device)


def gelu_mlp(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu`` is the tanh approximation by
    default; ``F.gelu``'s default is the exact erf form."""
    h = torch.matmul(x, p.w_in) + p.b_in
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return torch.matmul(h, p.w_out) + p.b_out
