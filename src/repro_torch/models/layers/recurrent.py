"""Recurrent sequence mixers: Mamba (selective SSM, arXiv:2312.00752) and
xLSTM's mLSTM and sLSTM (arXiv:2405.04517).

Same contract as the reference's ``layers/recurrent.py``:

* ``*_apply(cfg, p, x)``          — full sequence from a zero state;
* ``*_step(cfg, p, x, state)``    — tokens appended to a carried state,
  as the hybrid's and xLSTM's prefill and decode steps call it;
* ``*_init_state(cfg, batch)``    — the zero state.

Mamba's recurrence is one call of the selective-scan op: the CUDA
kernel on the card, its plain twin on the CPU; a gradient flows through
the op's backward kernel (or twin) to ``a_log``, ``dt_bias``,
``dt_proj`` and ``x_proj``.  The reference computes
the same function with an associative scan inside chunks and builds the
(B, S, d_inner, d_state) decay and input tensors to do so; the op keeps
the state in registers instead, so nothing of that size is made here.

mLSTM is the chunkwise linear-attention form with scalar exponential
gates a head (matrix memory C, normaliser n); sLSTM a sequential scan
with block-diagonal recurrent weights and the stabiliser m.  Neither has
a kernel of the reference's: their products are ``torch.matmul`` and
``einsum``, as the reference's are jnp einsums, and the reference's
``lax.scan`` over chunks or steps is a Python loop.  Gates and states
are float32 (the gate weights ``wi``, ``bi``, ``wf``, ``bf``, ``r`` and
``b`` stay float32 in a bf16 model); the norm and the SiLU gate return to
x's dtype.  Unlike Mamba's step, the xLSTM steps write the new state
into the ``state`` they are given (the mLSTM's C is H·dh² floats a
request) and return it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...kernels.mamba_scan import ops as scan_ops
from ..common import ModelConfig, const_param, dense_init
from .basic import RMSNorm, rms_norm


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


# ---------------------------------------------------------------------- #
# mLSTM (chunkwise linear-attention form)
# ---------------------------------------------------------------------- #
def _mlstm_dims(cfg: ModelConfig):
    dp = int(cfg.xlstm_proj_factor * cfg.d_model)
    h = cfg.n_heads
    return dp, h, dp // h


class MLSTM(nn.Module):
    """The reference's ``mlstm_init`` parameters, by the same names."""

    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        d = cfg.d_model
        dp, h, _ = _mlstm_dims(cfg)
        dt, f32 = cfg.torch_dtype, torch.float32
        self.up = dense_init(gen, (d, 2 * dp), dt, device=device)
        self.wq = dense_init(gen, (dp, dp), dt, device=device)
        self.wk = dense_init(gen, (dp, dp), dt, device=device)
        self.wv = dense_init(gen, (dp, dp), dt, device=device)
        self.wi = dense_init(gen, (dp, h), f32, device=device)
        self.bi = const_param((h,), 0.0, f32, device)
        self.wf = dense_init(gen, (dp, h), f32, device=device)
        self.bf = const_param((h,), 3.0, f32, device)  # forget bias > 0
        self.norm = RMSNorm(dp, device)
        self.down = dense_init(gen, (dp, d), dt, device=device)


def _mlstm_core(cfg: ModelConfig, p: MLSTM, c_in, state):
    """c_in: (B, S, dp).  ``state``: dict(c (B, H, dh, dh), n (B, H, dh))
    float32, written in place, or None (a zero state).  Returns
    (y (B, S, dp) float32, the state)."""
    dp, h, dh = _mlstm_dims(cfg)
    b, s, _ = c_in.shape
    f32 = torch.float32
    q = torch.matmul(c_in, p.wq).reshape(b, s, h, dh).to(f32) * dh ** -0.5
    k = torch.matmul(c_in, p.wk).reshape(b, s, h, dh).to(f32)
    v = torch.matmul(c_in, p.wv).reshape(b, s, h, dh).to(f32)
    cf32 = c_in.to(f32)
    logf = F.logsigmoid(torch.matmul(cf32, p.wf) + p.bf)   # (B, S, H) ≤ 0
    logi = torch.clamp(torch.matmul(cf32, p.wi) + p.bi, max=8.0)

    chunk = max(1, min(cfg.xlstm_chunk, s))
    npad = (-s) % chunk
    if npad:        # a ragged last chunk: its pad rows get no input gate
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, npad)) for x in (q, k, v))
        logf = F.pad(logf, (0, 0, 0, npad))
        logi = F.pad(logi, (0, 0, 0, npad), value=-1e30)
    if state is None:
        cmat = torch.zeros((b, h, dh, dh), dtype=f32, device=c_in.device)
        nvec = torch.zeros((b, h, dh), dtype=f32, device=c_in.device)
    else:
        cmat, nvec = state["c"], state["n"]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=c_in.device).tril()[None, :, :, None]
    ys = []
    for lo in range(0, s + npad, chunk):
        qx, kx, vx = (x[:, lo:lo + chunk] for x in (q, k, v))
        fx, ix = logf[:, lo:lo + chunk], logi[:, lo:lo + chunk]
        cf = torch.cumsum(fx, dim=1)                    # (B, chunk, H)
        # intra-chunk: decay(t, s) = exp(cf_t − cf_s + i_s) for s ≤ t
        dmat = cf[:, :, None, :] - cf[:, None, :, :] + ix[:, None, :, :]
        w = torch.exp(torch.where(tri, dmat, -1e30))    # (B, t, s, H)
        scores = torch.einsum("bthd,bshd->btsh", qx, kx) * w
        y_intra = torch.einsum("btsh,bshd->bthd", scores, vx)
        n_intra = torch.einsum("btsh,bshd->bthd", w, kx)
        # inter-chunk: the carried memory, decayed to each row
        decay_t = torch.exp(cf)
        y_inter = (torch.einsum("bthd,bhde->bthe", qx, cmat)
                   * decay_t[..., None])
        n_inter = torch.einsum("bthd,bhd->bth", qx, nvec) * decay_t
        n_full = torch.einsum("bthd,bthd->bth", qx, n_intra) + n_inter
        ys.append((y_intra + y_inter)
                  / torch.clamp(n_full.abs(), min=1.0)[..., None])
        # the state to the chunk's end
        wk = torch.exp(cf[:, -1:] - cf + ix)[..., None] * kx
        last = torch.exp(cf[:, -1])                     # (B, H)
        upd = torch.einsum("bshd,bshe->bhde", wk, vx)
        if state is None:   # a fresh state: new tensors, differentiable
            cmat = cmat * last[..., None, None] + upd
            nvec = nvec * last[..., None] + wk.sum(1)
        else:               # a carried state: written in place
            cmat.mul_(last[..., None, None]).add_(upd)
            nvec.mul_(last[..., None]).add_(wk.sum(1))
    y = torch.cat(ys, dim=1)[:, :s]
    return y.reshape(b, s, dp), {"c": cmat, "n": nvec}


def mlstm_apply(cfg: ModelConfig, p: MLSTM, x, state=None,
                return_state=False):
    u = torch.matmul(x, p.up)
    c_in, gate = u.chunk(2, dim=-1)
    y, new_state = _mlstm_core(cfg, p, c_in, state)
    y = rms_norm(p.norm, y.to(x.dtype), cfg.norm_eps)
    y = y * F.silu(gate.to(torch.float32)).to(x.dtype)
    out = torch.matmul(y, p.down).to(x.dtype)
    return (out, new_state) if return_state else out


def mlstm_init_state(cfg: ModelConfig, batch: int, device=None):
    _, h, dh = _mlstm_dims(cfg)
    return {"c": torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, h, dh), dtype=torch.float32,
                             device=device)}


def mlstm_step(cfg: ModelConfig, p: MLSTM, x, state):
    """x: (B, S, d) appended to ``state`` (written in place): (out,
    state)."""
    return mlstm_apply(cfg, p, x, state=state, return_state=True)


# ---------------------------------------------------------------------- #
# sLSTM (sequential scan, block-diagonal recurrence, stabilised gates)
# ---------------------------------------------------------------------- #
class SLSTM(nn.Module):
    """The reference's ``slstm_init`` parameters: ``w`` packs (z i f o)
    in four d-wide blocks; ``r`` (H, dh, 4·dh) and ``b`` float32."""

    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        dt, f32 = cfg.torch_dtype, torch.float32
        self.w = dense_init(gen, (d, 4 * d), dt, device=device)
        self.r = dense_init(gen, (h, dh, 4 * dh), f32, device=device)
        self.b = nn.Parameter(torch.cat([
            torch.zeros(2 * d, dtype=f32, device=device),
            torch.full((d,), 3.0, dtype=f32, device=device),
            torch.zeros(d, dtype=f32, device=device)]), requires_grad=False)
        self.out = dense_init(gen, (d, d), dt, device=device)


def slstm_init_state(cfg: ModelConfig, batch: int, device=None):
    d, h = cfg.d_model, cfg.n_heads
    shape = (batch, h, d // h)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return {"c": z, "n": z + 1e-6, "h": z.clone(), "m": z.clone()}


def _slstm_cell(cfg: ModelConfig, p: SLSTM, wx_t, bias, st):
    """One recurrence step.  wx_t: (B, 4d) input projection; ``bias``
    the (H, dh, 4) rearranged ``b``."""
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    b = wx_t.shape[0]
    rh = torch.einsum("bhd,hdf->bhf", st["h"], p.r)      # (B, H, 4dh)
    # wx packs (z i f o) in four d-wide blocks; rebuild per head
    wx = wx_t.reshape(b, 4, d).transpose(1, 2).reshape(b, h, dh, 4)
    pre = wx + rh.reshape(b, h, dh, 4) + bias
    z_t = torch.tanh(pre[..., 0])
    i_t = pre[..., 1]
    o_t = torch.sigmoid(pre[..., 3])
    logf = F.logsigmoid(pre[..., 2])
    m_new = torch.maximum(logf + st["m"], i_t)
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(logf + st["m"] - m_new)
    c_new = f_s * st["c"] + i_s * z_t
    n_new = f_s * st["n"] + i_s
    h_new = o_t * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_apply(cfg: ModelConfig, p: SLSTM, x, state=None,
                return_state=False):
    """x: (B, S, d); ``state`` (c, n, h, m), each (B, H, dh) float32,
    is written in place at the end."""
    b, s, d = x.shape
    h = cfg.n_heads
    wx = torch.matmul(x, p.w).to(torch.float32)
    bias = p.b.reshape(4, d).t().reshape(h, d // h, 4)
    st = state if state is not None else slstm_init_state(cfg, b, x.device)
    hs = []
    for t in range(s):
        st = _slstm_cell(cfg, p, wx[:, t], bias, st)
        hs.append(st["h"])
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    out = torch.matmul(y, p.out).to(x.dtype)
    if state is not None:
        for key, a in st.items():
            state[key].copy_(a)
        st = state
    return (out, st) if return_state else out


def slstm_step(cfg: ModelConfig, p: SLSTM, x, state):
    """x: (B, S, d) appended to ``state`` (written in place): (out,
    state)."""
    return slstm_apply(cfg, p, x, state=state, return_state=True)
