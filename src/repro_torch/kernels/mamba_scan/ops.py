"""Public op: the selective scan, dispatched by the device of its inputs.

Tensors on the card go through the CUDA kernel; tensors on the CPU go
through the plain twin.  The two never stand in for each other.  Both
take the same inputs: float32, contiguous, shapes as below; anything
else raises on either device.

Training: when grad mode is on and an input requires grad, the op runs
through :class:`SelectiveScan`, whose forward on the card also writes
the backward's checkpoints and whose backward is
``csrc/selective_scan_bwd.cu`` on the card and
:func:`selective_scan_bwd_ref` on the CPU.  Otherwise it launches
exactly what it launches for serving.
"""

from __future__ import annotations

import torch

from .kernel import selective_scan_bwd_cuda, selective_scan_cuda
from .ref import selective_scan_bwd_ref, selective_scan_ref

MAX_STATE = 16      # the kernels keep a channel's state in registers


def _check(delta, a, b, c, x, h0):
    if x.ndim != 3 or a.ndim != 2:
        raise ValueError("x must be (B, S, Di) and a (Di, Ds)")
    bs, s, di = x.shape
    ds = a.shape[1]
    want = {"delta": (delta, (bs, s, di)), "a": (a, (di, ds)),
            "b": (b, (bs, s, ds)), "c": (c, (bs, s, ds))}
    if h0 is not None:
        want["h0"] = (h0, (bs, di, ds))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape} (x {tuple(x.shape)}, a "
                             f"{tuple(a.shape)})")
    xs = [x] + [t for t, _ in want.values()]
    bad = sorted({str(t.dtype) for t in xs if t.dtype != torch.float32})
    if bad:
        raise TypeError(f"the scan takes float32 inputs, got {bad}")
    if any(not t.is_contiguous() for t in xs):
        raise ValueError("the scan takes contiguous inputs")
    devs = {t.device for t in xs}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if min(bs, s, di, ds) < 1:
        raise ValueError(f"empty scan: B {bs}, S {s}, Di {di}, Ds {ds}")


class SelectiveScan(torch.autograd.Function):
    """The scan with its backward: ``apply(delta, a, b, c, x, h0,
    kernel)``.  With ``kernel`` (inputs on the card, already checked) the
    forward and backward kernels; without it the twins, on any device.
    Saves the forward's inputs, and on the card the forward kernel's
    checkpoints (the state before every 8th step, 268 MB at Jamba's
    training call): the backward recomputes the states from them."""

    @staticmethod
    def forward(ctx, delta, a, b, c, x, h0, kernel):
        if kernel:
            y, h_last, ckpt = selective_scan_cuda(delta, a, b, c, x, h0,
                                                  ckpt=True)
        else:
            (y, h_last), ckpt = selective_scan_ref(delta, a, b, c, x, h0), None
        ctx.save_for_backward(delta, a, b, c, x, h0, ckpt)
        ctx.kernel = kernel
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        delta, a, b, c, x, h0, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        if ctx.kernel:
            grads = selective_scan_bwd_cuda(delta, a, b, c, x, ckpt, dy,
                                            dh_last)
        else:
            grads = selective_scan_bwd_ref(delta, a, b, c, x, h0, dy, dh_last)
        ddelta, da, db, dc, dx, dh0 = grads
        return ddelta, da, db, dc, dx, (None if h0 is None else dh0), None


def selective_scan(delta: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, x: torch.Tensor,
                   h0: torch.Tensor | None = None):
    """h_t = exp(Δ_t A) ⊙ h_{t−1} + (Δ_t x_t) B_t;  y_t = h_t · C_t.

    delta, x: (B, S, Di); a: (Di, Ds); b, c: (B, S, Ds); h0: (B, Di, Ds)
    or None (zeros); float32 and contiguous.  Returns (y (B, S, Di),
    h_last (B, Di, Ds)) as new tensors.  On the card Ds is at most 16.

    Differentiable with respect to every input: with grad mode on and an
    input that requires grad, through :class:`SelectiveScan`."""
    _check(delta, a, b, c, x, h0)
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    kernel = dev.type == "cuda"
    if kernel and a.shape[1] > MAX_STATE:
        raise ValueError(f"the kernel takes a state of at most {MAX_STATE}, "
                         f"got {a.shape[1]}")
    xs = (delta, a, b, c, x, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in xs):
        return SelectiveScan.apply(*xs, kernel)
    if kernel:
        return selective_scan_cuda(*xs)
    return selective_scan_ref(*xs)
