"""Plain twin of the selective-scan kernel: the sequential recurrence of
the reference's oracle (``ref.selective_scan`` of the JAX package's
``kernels/mamba_scan``), in torch.

It is the function the kernel computes, so it is what the CPU path runs
and what the kernel is held against on the card.  Like the oracle, and
unlike the TPU kernel (which starts from zero and returns y only), it
takes an initial state and returns the last one: the port's Mamba layer
carries the state from the prefill into every decode step.
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
