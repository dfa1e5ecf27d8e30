"""AdamW with optional int8 block-quantized moments, the reference's
``train/optimizer.py`` in torch.

The arithmetic is the reference's, op for op, in fp32: the global norm
and the clip, bias correction, weight decay where :func:`decay_mask`
says, and each parameter updated in fp32 and cast back to its dtype (a
bf16 parameter keeps no fp32 master copy, as in the reference).  The
quantized mode (8-bit Adam) stores each moment as int8 codes in the
parameter's shape with fp32 absmax scales per block of 256 along the
last axis; the update dequantizes, runs in fp32 and quantizes again.

The state is keyed by the port's parameter names (``named_parameters``):
``{"m": {name: moment}, "v": {name: moment}, "step": int32 0-d}``, a
moment being an fp32 tensor or ``{"q": int8 codes, "s": fp32 scales}``.
Where the reference returns new parameters, :func:`adamw_update` writes
them into the module in place (no second copy of the weights), and
replaces each moment in the given state's dicts as it goes (no second
copy of the moments: 15 GB at internlm2-1.8b's width).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

Q_BLOCK = 256
# leaf names the reference leaves undecayed, by substring (norm scales,
# biases, xLSTM's gate biases "bi"/"bf", Mamba's dt and conv biases)
NO_DECAY = ("scale", "bias", "b_in", "b_out", "bi", "bf", "dt_bias",
            "conv_b")


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"      # "float32" | "int8"
    z_loss: float = 1e-4               # unread, as in the reference


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to ``min_lr`` at
    ``decay_steps``; fp32."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


# ---------------------------------------------------------------------- #
# int8 block quantization
# ---------------------------------------------------------------------- #
def _block_of(shape) -> int:
    """Block size along the last axis: the codes keep the parameter's
    exact shape."""
    last = shape[-1] if shape else 1
    return Q_BLOCK if last % Q_BLOCK == 0 else last


def quantize_i8(x: torch.Tensor):
    """fp32 → (int8 codes in x.shape, fp32 scales (*, last/block)); codes
    rounded half to even, as ``jnp.round``."""
    blk = _block_of(x.shape)
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // blk, blk)
    scale = xb.abs().amax(-1) / 127.0
    codes = torch.round(xb / torch.clamp(scale[..., None], min=1e-12))
    return codes.to(torch.int8).reshape(x.shape), scale


def dequantize_i8(codes: torch.Tensor, scale: torch.Tensor, shape):
    blk = _block_of(shape)
    xb = codes.reshape(*shape[:-1], shape[-1] // blk, blk)
    return (xb.to(torch.float32) * scale[..., None]).reshape(shape)


# ---------------------------------------------------------------------- #
# state
# ---------------------------------------------------------------------- #
def _zero_moment(cfg: OptConfig, p: torch.Tensor):
    if cfg.moment_dtype == "int8":
        blk = _block_of(p.shape)
        sshape = (*p.shape[:-1], p.shape[-1] // blk)
        return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "s": torch.zeros(sshape, dtype=torch.float32,
                                 device=p.device)}
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_opt_state(cfg: OptConfig, params: nn.Module) -> dict:
    named = list(params.named_parameters())
    dev = named[0][1].device
    return {"m": {n: _zero_moment(cfg, p) for n, p in named},
            "v": {n: _zero_moment(cfg, p) for n, p in named},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _read_moment(cfg: OptConfig, mom, shape):
    if cfg.moment_dtype == "int8":
        return dequantize_i8(mom["q"], mom["s"], shape)
    return mom


def _write_moment(cfg: OptConfig, val):
    if cfg.moment_dtype == "int8":
        q, s = quantize_i8(val)
        return {"q": q, "s": s}
    return val


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every tensor's fp32 sum of squares."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.to(torch.float32))) for x in tensors])))


def decay_mask(name: str) -> bool:
    """Weight decay on matrices only: the reference's ``_decay_mask`` on
    its leaf's key.  ``name`` is a port parameter name; its last part is
    the reference's leaf key (the port names every parameter as the
    reference's tree does, which ``convert`` walks), a ``ModuleList``
    index being no leaf."""
    leaf = [k for k in name.split(".") if not k.isdigit()][-1]
    return not any(s in leaf for s in NO_DECAY)


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: nn.Module, grads: dict,
                 opt_state: dict):
    """One AdamW step: writes the new parameters into ``params`` and the
    new moments into ``opt_state["m"]`` and ``["v"]`` (entry by entry);
    returns (the new optimizer state, which holds those dicts, and
    metrics ``grad_norm`` and ``lr``, 0-d fp32 tensors on the
    parameters' device).  ``grads`` maps each parameter's name to its
    gradient (any float dtype)."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    named = list(params.named_parameters())
    gnorm = global_norm(grads[n] for n, _ in named)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    moms_m, moms_v = opt_state["m"], opt_state["v"]
    for name, p in named:
        g = grads[name].to(torch.float32) * clip
        m = _read_moment(cfg, moms_m[name], p.shape)
        v = _read_moment(cfg, moms_v[name], p.shape)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        upd = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay > 0 and decay_mask(name):
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * upd)
        moms_m[name] = _write_moment(cfg, m)
        moms_v[name] = _write_moment(cfg, v)
    opt = {"m": moms_m, "v": moms_v, "step": step}
    return opt, {"grad_norm": gnorm, "lr": lr}
