"""Recurrent sequence mixers: Mamba (selective SSM, arXiv:2312.00752).

Same contract as the reference's ``layers/recurrent.py``:

* ``mamba_apply(cfg, p, x)``        — full sequence from a zero state;
* ``mamba_step(cfg, p, x, state)``  — tokens appended to a carried
  (conv, ssm) state, as the hybrid's prefill and decode steps call it;
* ``mamba_init_state(cfg, batch)``  — the zero state.

The recurrence itself is one call of the selective-scan op: the CUDA
kernel on the card, its plain twin on the CPU.  The reference computes
the same function with an associative scan inside chunks and builds the
(B, S, d_inner, d_state) decay and input tensors to do so; the op keeps
the state in registers instead, so nothing of that size is made here.
mLSTM and sLSTM wait for the ssm family (ROADMAP item 11).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...kernels.mamba_scan import ops as scan_ops
from ..common import ModelConfig, const_param, dense_init


def _mamba_dims(cfg: ModelConfig):
    di = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, -(-cfg.d_model // 16))
    return di, dt_rank, cfg.mamba_d_state, cfg.mamba_d_conv


class Mamba(nn.Module):
    """The reference's ``mamba_init`` parameters, by the same names."""

    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        d = cfg.d_model
        di, dtr, ds, dc = _mamba_dims(cfg)
        dt = cfg.torch_dtype
        f32 = torch.float32
        self.in_proj = dense_init(gen, (d, 2 * di), dt, device=device)
        self.conv_w = dense_init(gen, (dc, di), dt, scale=dc ** -0.5,
                                 device=device)
        self.conv_b = const_param((di,), 0.0, dt, device)
        self.x_proj = dense_init(gen, (di, dtr + 2 * ds), dt, device=device)
        self.dt_proj = dense_init(gen, (dtr, di), dt, device=device)
        # softplus⁻¹(0.01): the reference's dt_init
        self.dt_bias = const_param((di,), math.log(math.expm1(0.01)), f32,
                                   device)
        a_log = torch.log(torch.arange(1, ds + 1, dtype=f32, device=device))
        self.a_log = nn.Parameter(a_log.expand(di, ds).contiguous(),
                                  requires_grad=False)
        self.d_skip = const_param((di,), 1.0, f32, device)
        self.out_proj = dense_init(gen, (di, d), dt, device=device)


def _mamba_inner(cfg: ModelConfig, p: Mamba, xz, conv_state=None,
                 ssm_state=None):
    """xz: (B, S, 2·di) after in_proj.  Returns (y, new_conv, new_ssm);
    the states are None unless ``ssm_state`` (B, di, ds) was given."""
    di, dtr, ds, dc = _mamba_dims(cfg)
    x, z = xz.chunk(2, dim=-1)                            # (B, S, di)
    s = x.shape[1]
    f32 = torch.float32

    # depthwise causal conv along S, one shifted window at a time
    if conv_state is not None:
        xin = torch.cat([conv_state, x], dim=1)           # (B, dc-1+S, di)
        new_conv = xin[:, -(dc - 1):]
    else:
        xin = F.pad(x, (0, 0, dc - 1, 0))
        new_conv = None
    w = p.conv_w.to(f32)
    xc = xin[:, 0:s].to(f32) * w[0]
    for i in range(1, dc):
        xc.add_(xin[:, i:i + s].to(f32) * w[i])
    xc = F.silu(xc + p.conv_b.to(f32)).to(x.dtype)

    proj = torch.matmul(xc, p.x_proj).to(f32)
    dt_in, b_in, c_in = proj.split([dtr, ds, ds], dim=-1)
    delta = F.softplus(torch.matmul(dt_in, p.dt_proj.to(f32))
                       + p.dt_bias)                       # (B, S, di)
    a = -torch.exp(p.a_log)                               # (di, ds)
    xf = xc.to(f32)
    y, h_last = scan_ops.selective_scan(
        delta, a, b_in.contiguous(), c_in.contiguous(), xf, h0=ssm_state)
    y = y + p.d_skip * xf
    y = (y * F.silu(z.to(f32))).to(x.dtype)
    new_ssm = h_last if ssm_state is not None else None
    return y, new_conv, new_ssm


def mamba_apply(cfg: ModelConfig, p: Mamba, x):
    xz = torch.matmul(x, p.in_proj)
    y, _, _ = _mamba_inner(cfg, p, xz)
    return torch.matmul(y, p.out_proj).to(x.dtype)


def mamba_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None):
    di, _, ds, dc = _mamba_dims(cfg)
    return {"conv": torch.zeros((batch, dc - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, ds), dtype=torch.float32,
                               device=device)}


def mamba_step(cfg: ModelConfig, p: Mamba, x, state):
    """x: (B, S, d) appended to ``state`` = dict(conv (B, dc-1, di),
    ssm (B, di, ds) float32); returns (out, new state).  ``state`` is not
    written: the caller stores the new one."""
    xz = torch.matmul(x, p.in_proj)
    y, new_conv, new_ssm = _mamba_inner(
        cfg, p, xz, conv_state=state["conv"].to(x.dtype),
        ssm_state=state["ssm"])
    out = torch.matmul(y, p.out_proj).to(x.dtype)
    return out, {"conv": new_conv.to(state["conv"].dtype), "ssm": new_ssm}
