"""FFN layers: SwiGLU, the GELU MLP and the capacity-based top-k MoE.

The MoE is the reference's scatter dispatch (``models/layers/ffn.py``):
each (token, slot) pair is placed at (expert, position) in a buffer of
``capacity`` rows an expert, the expert products run over every expert's
buffer, and the outputs are gathered back; pairs past an expert's
capacity are dropped.  The products are the reference's einsums as
batched matmuls, no kernel of their own.  :func:`moe_stats` records each
call's routes, drops and auxiliary loss for a run that asks for them.

On a mesh whose batch is split over data ranks (:func:`data_parallel`),
the dispatch is the global microbatch's: the capacity comes from the
global token count, a pair's queue place counts the pairs of the ranks
below (the global token order is rank 0's rows, then rank 1's, …), and
the auxiliary loss reads the global means.  Each rank computes its own
tokens; a token's output depends only on whether it is kept, as in the
one-device dispatch.
"""

from __future__ import annotations

import contextlib

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


# ---------------------------------------------------------------------- #
# MoE
# ---------------------------------------------------------------------- #
def expert_buffers(cfg: ModelConfig) -> int:
    """Experts the buffers hold: ``moe_pad_to``'s dummy experts pad E up
    (the router never picks them)."""
    e = cfg.moe_experts
    return max(cfg.moe_pad_to, e) if cfg.moe_pad_to else e


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Rows an expert's buffer holds for ``tokens`` tokens: the
    reference's ``int(max(1, ceil(T·k/E)) · capacity_factor)``, E
    unpadded."""
    e, k = cfg.moe_experts, cfg.moe_topk
    return int(max(1, -(-tokens * k // e)) * cfg.capacity_factor)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
        ep = expert_buffers(cfg)
        dt = cfg.torch_dtype
        self.router = dense_init(gen, (d, e), torch.float32, device=device)
        self.w_gate = dense_init(gen, (ep, d, f), dt, device=device)
        self.w_up = dense_init(gen, (ep, d, f), dt, device=device)
        self.w_down = dense_init(gen, (ep, f, d), dt, device=device)
        self.shared = (SwiGLU(cfg, gen, d_ff=cfg.moe_shared * f,
                              device=device) if cfg.moe_shared > 0 else None)


_STATS: list | None = None
# the batch's split over data ranks (a ``sharding.state.Grid``)
_DP = None
_REPLAY: list | None = None
# a checkpointed block's replayed routes (None where a call took its own
# top-k): recorded by its first run ("record"), taken back in order by its
# recomputation in the backward ("replay")
_TAPE: list | None = None
_TAPE_MODE = ""


@contextlib.contextmanager
def moe_stats(replay: list | None = None):
    """Within this scope every :func:`moe_apply` call appends a dict to
    the yielded list: ``experts`` (T, k) and ``keep`` (T, k) bool, the
    routes and which of them fit their expert's capacity, ``dropped``
    (a 0-d int tensor) and ``aux``, all left on the device.  With
    ``replay`` (an earlier run's ``experts``, in call order) call i takes
    ``replay[i]``'s routes in place of its own top-k, their gates read
    from its own probabilities: two runs then route alike and differ
    only in their arithmetic (a near-tie the two break apart would
    otherwise send a token through other experts)."""
    global _STATS, _REPLAY
    prev = _STATS, _REPLAY
    _STATS, _REPLAY = [], replay
    try:
        yield _STATS
    finally:
        _STATS, _REPLAY = prev


@contextlib.contextmanager
def data_parallel(dp):
    """Within this scope :func:`moe_apply` dispatches over the global
    microbatch split over ``dp``'s data ranks (a ``sharding.state.Grid``;
    None: this rank's tokens are the whole batch)."""
    global _DP
    prev = _DP
    _DP = dp
    try:
        yield
    finally:
        _DP = prev


@contextlib.contextmanager
def _taping(routes: list, mode: str, dp):
    global _TAPE, _TAPE_MODE, _DP
    prev = _TAPE, _TAPE_MODE, _DP
    _TAPE, _TAPE_MODE, _DP = routes, mode, dp
    try:
        yield
    finally:
        _TAPE, _TAPE_MODE, _DP = prev


def recompute_contexts():
    """The ``context_fn`` of a checkpointed block (``models.common.
    remat``): its first run records, for each :func:`moe_apply` call,
    the routes it replayed (or None: its own top-k), and the
    recomputation in the backward takes them back in order, so it runs
    the first run's ops on the first run's routes, and records no
    :func:`moe_stats` entry, so a step's stats count each call once.
    The recomputation also runs under the first run's
    :func:`data_parallel` split, which the backward is outside of: the
    global capacity and queue places again, not this rank's own."""
    routes: list = []
    dp = _DP
    return _taping(routes, "record", dp), _taping(routes, "replay", dp)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index, as
    ``jax.lax.top_k`` (``torch.topk`` promises no order among ties on
    the card): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """x (B, S, d) → (y in x's dtype, the router's auxiliary loss, fp32)."""
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    e_buf = expert_buffers(cfg)
    t = b * s
    xt = x.reshape(t, d)
    probs = torch.softmax(torch.matmul(xt.float(), p.router), dim=-1)
    recomputing = _TAPE_MODE == "replay"
    if recomputing:
        experts = _TAPE.pop(0)
    else:
        experts = _REPLAY[len(_STATS)] if _REPLAY is not None else None
        if _TAPE_MODE == "record":
            _TAPE.append(experts)
    if experts is not None:
        gate_vals = probs.gather(-1, experts)
    else:
        gate_vals, experts = _top_k(probs, k)                # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # the load-balance loss (Switch/GShard) over the unpadded experts
    routed = F.one_hot(experts, e).float().sum(1)            # (T, E)
    flat = experts.reshape(-1)
    hot = F.one_hot(flat, e_buf)                             # (T·k, E_buf)
    if _DP is None:
        me, ce = probs.mean(0), routed.mean(0)
        cap = capacity(cfg, t)
        before = 0
    else:
        t_all = t * _DP.data_size
        me = _DP.sum_with_grad(probs.sum(0)) / t_all
        ce = _DP.sum(routed.sum(0)) / t_all
        cap = capacity(cfg, t_all)
        before = _DP.exclusive_prefix(hot.sum(0))            # (E_buf,)
    aux = cfg.router_aux_coef * e * torch.sum(me * ce)

    # each (token, slot) pair's place in its expert's queue, token-major:
    # pairs past the capacity are dropped, the later first
    pos = torch.cumsum(hot, 0) - 1 + before
    pos = pos.gather(1, flat[:, None])[:, 0]
    keep = pos < cap
    # dropped pairs go to a spare row past the buffers, never read
    slot = torch.where(keep, flat * cap + pos, e_buf * cap)
    src = xt.repeat_interleave(k, dim=0) if k > 1 else xt
    buf = torch.zeros((e_buf * cap + 1, d), dtype=xt.dtype, device=x.device)
    buf[slot] = src
    buf = buf[:-1].reshape(e_buf, cap, d)

    g = torch.bmm(buf, p.w_gate)
    u = torch.bmm(buf, p.w_up)
    h = (F.silu(g.float()) * u.float()).to(xt.dtype)
    out = torch.bmm(h, p.w_down).reshape(e_buf * cap, d)

    gathered = out[slot.clamp_max(e_buf * cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)
    y = (gathered.reshape(t, k, d)
         * gate_vals[..., None].to(xt.dtype)).sum(1)
    if p.shared is not None:
        y = y + swiglu(p.shared, xt)
    if _STATS is not None and not recomputing:
        _STATS.append({"experts": experts, "keep": keep.reshape(t, k),
                       "dropped": (~keep).sum(), "aux": aux})
    return y.reshape(b, s, d), aux
