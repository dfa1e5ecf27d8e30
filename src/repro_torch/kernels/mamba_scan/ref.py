"""Plain twins of the selective-scan kernels: the sequential recurrence
of the reference's oracle (``ref.selective_scan`` of the JAX package's
``kernels/mamba_scan``), in torch, and its gradient walked back step by
step.

They are the functions the kernels compute, so they are what the CPU
path runs and what the kernels are held against on the card.  Like the
oracle, and unlike the TPU kernel (which starts from zero and returns y
only), the scan takes an initial state and returns the last one: the
port's Mamba layer carries the state from the prefill into every decode
step.
"""

from __future__ import annotations

import torch


def selective_scan_ref(delta, a, b, c, x, h0=None):
    """h_t = exp(Δ_t A) ⊙ h_{t−1} + (Δ_t x_t) B_t;  y_t = h_t · C_t.

    delta, x: (B, S, Di); a: (Di, Ds); b, c: (B, S, Ds); h0: (B, Di, Ds)
    or None (zeros), all float32.  Returns (y (B, S, Di), h_last
    (B, Di, Ds)); ``h0`` is not written.  Each step rounds as the kernel
    does: Δ·A, its exp, Δ·x, the two products of the update and their
    sum one at a time.
    """
    bs, s, di = x.shape
    h = (torch.zeros((bs, di, a.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0)
    y = torch.empty((bs, s, di), dtype=torch.float32, device=x.device)
    for t in range(s):
        ad = torch.exp(delta[:, t, :, None] * a)
        h = ad * h + (delta[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        y[:, t] = (h * c[:, t, None, :]).sum(-1)
    return y, h


def selective_scan_bwd_ref(delta, a, b, c, x, h0, dy, dh_last=None):
    """The scan's gradient: with g_t = ∂L/∂h_t and ā_t = exp(Δ_t A),

        g_S = dh_last + dy_S C_S;   g_t = ā_{t+1} ⊙ g_{t+1} + dy_t C_t
        dC_t = Σ_d dy_t h_t          dB_t = Σ_d g_t Δ_t x_t
        dx_t = Δ_t Σ_n g_t B_t
        dΔ_t = x_t Σ_n g_t B_t + Σ_n g_t h_{t−1} ā_t A
        dA = Σ_{b,t} g_t h_{t−1} ā_t Δ_t;    dh0 = ā_1 ⊙ g_1

    The forward's inputs as it took them (``h0`` may be None: zeros),
    ``dy`` (B, S, Di), ``dh_last`` (B, Di, Ds) or None (zeros).  Returns
    (ddelta, da, db, dc, dx, dh0) in the inputs' shapes.  The states are
    recomputed as the forward rounds them and all kept (B·S·Di·Ds
    floats), then walked back one step at a time."""
    bs, s, di = x.shape
    ds = a.shape[1]
    dev = x.device
    h = (torch.zeros((bs, di, ds), dtype=torch.float32, device=dev)
         if h0 is None else h0)
    hs = [h]
    for t in range(s):
        ad = torch.exp(delta[:, t, :, None] * a)
        h = ad * h + (delta[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        hs.append(h)
    gd = (torch.zeros((bs, di, ds), dtype=torch.float32, device=dev)
          if dh_last is None else dh_last)
    ddelta = torch.empty((bs, s, di), dtype=torch.float32, device=dev)
    dx = torch.empty_like(ddelta)
    db = torch.empty((bs, s, ds), dtype=torch.float32, device=dev)
    dc = torch.empty_like(db)
    da = torch.zeros((di, ds), dtype=torch.float32, device=dev)
    for t in reversed(range(s)):
        dl = delta[:, t, :, None]
        ad = torch.exp(dl * a)
        g = gd + dy[:, t, :, None] * c[:, t, None, :]
        dc[:, t] = (dy[:, t, :, None] * hs[t + 1]).sum(1)
        db[:, t] = (g * (delta[:, t] * x[:, t])[..., None]).sum(1)
        gb = (g * b[:, t, None, :]).sum(-1)
        dx[:, t] = delta[:, t] * gb
        q = g * hs[t] * ad
        ddelta[:, t] = x[:, t] * gb + (q * a).sum(-1)
        da += (q * dl).sum(0)
        gd = ad * g
    return ddelta, da, db, dc, dx, gd
