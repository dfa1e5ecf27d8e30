"""N-Rank — the evolutionary model of paper §3.2, stage by stage.

Pipeline (all offline, eq. numbers from the paper):

1. possibility sets / weights  (eq. 4–7)   → ``possibility_weights``
2. transfer & draining probabilities (8–9) → ``transition_probabilities``
3. evolution: init (1), iterate (2–3), terminate → ``evolve`` (torch)

The minimal-path predicate stands in for the 2D-mesh "minimum rectangle"
of eq. (4)::

    ⟨s,d⟩ ∈ P^{u,n}  ⇔  dist(s,u) + 1 + dist(n,d) == dist(s,d)

This is the host oracle behind :func:`repro_torch.core.qstar.build_plan`;
the campaign and the control plane use the device pipeline
(:mod:`repro_torch.core.plan_fast`).  With ``use_kernel=True`` the
possibility weights come from the ``possibility_weights`` CUDA kernel
(:mod:`repro_torch.kernels.possibility`), which reads traffic as float32
as the reference op does, and the joint possibility from
:func:`repro_torch.core.plan_fast.joint_possibility_fast`.  Both
evolutions run in torch on ``device`` (default: the card), each in the
reference's precision: the node-level one in float32 (the reference's
jitted loop runs with x64 off), the channel-level one in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .topology import Topology

__all__ = [
    "NRankResult",
    "possibility_weights",
    "transition_probabilities",
    "evolve",
    "nrank",
    "nrank_channel",
    "joint_possibility",
    "initial_weights",
    "W_TH",
    "ITER_TH",
]

# paper §3.2.1 defaults
W_TH = 0.01
ITER_TH = 100


@dataclasses.dataclass(frozen=True)
class NRankResult:
    """Output of the N-Rank evolution."""

    w_nr: np.ndarray          # (N,) NR-weights — likelihood of heavy load
    w0: np.ndarray            # (N,) initial weights (eq. 1)
    w_final: np.ndarray       # (N,) residual weight at termination
    iterations: int
    p: np.ndarray             # (C,) transfer probability per channel (eq. 8)
    p_drn: np.ndarray         # (C,) draining probability per channel (eq. 9)
    w_possibility: np.ndarray  # (C,) possibility weight W^{u,n} (eq. 5)


def possibility_weights(dist: np.ndarray, traffic: np.ndarray,
                        channels: np.ndarray,
                        chunk: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Possibility weights ``W`` (eq. 5) and draining weights ``W_drn``
    (eq. 7) for every channel, each (C,) float64 (numpy, chunked over
    channels).  The O(C·N²) hot spot of N-Rank; the CUDA kernel
    :func:`repro_torch.kernels.possibility.possibility_weights` computes
    the same on the card."""
    dist = np.asarray(dist, dtype=np.int64)
    traffic = np.asarray(traffic, dtype=np.float64)
    c = channels.shape[0]
    w = np.empty(c, dtype=np.float64)
    w_drn = np.empty(c, dtype=np.float64)
    for lo in range(0, c, chunk):
        hi = min(lo + chunk, c)
        us = channels[lo:hi, 0]
        ns = channels[lo:hi, 1]
        # mask[b, s, d] = channel b on a minimal s→d path
        lhs = dist[:, us].T[:, :, None] + 1 + dist[ns, :][:, None, :]
        mask = lhs == dist[None, :, :]
        w[lo:hi] = (mask * traffic[None]).sum(axis=(1, 2))
        # draining: additionally d == n (eq. 6) ⇒ dist(s,u)+1 == dist(s,n)
        drn_mask = (dist[:, us].T + 1) == dist[:, ns].T  # (b, s)
        w_drn[lo:hi] = (drn_mask * traffic[:, ns].T).sum(axis=1)
    return w, w_drn


def _kernel_weights(topo: Topology, traffic: np.ndarray, channels,
                    device) -> tuple[np.ndarray, np.ndarray]:
    """(W, W_drn) from the kernel op (float32 out), widened to float64."""
    from ..kernels.possibility import possibility_weights as op

    w, w_drn = op(topo.distances, traffic, channels, device=device)
    return (w.cpu().numpy().astype(np.float64),
            w_drn.cpu().numpy().astype(np.float64))


def transition_probabilities(
        topo: Topology, traffic: np.ndarray,
        w: np.ndarray | None = None,
        w_drn: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Transfer/draining probabilities (eq. 8–9) and dense transition
    matrices for the evolution.

    Returns:
      p:    (C,) transfer probability per channel.
      p_drn:(C,) draining probability per channel.
      A:    (N, N) with A[u, n] = p^{u,n}            (for eq. 3)
      A_drn:(N, N) with A_drn[u, n] = p^{u,n}(1 − p_drn^{u,n})  (for eq. 2)
    """
    if w is None or w_drn is None:
        w, w_drn = possibility_weights(topo.distances, traffic, topo.channels)
    n = topo.num_nodes
    us, ns = topo.channels[:, 0], topo.channels[:, 1]
    denom = np.zeros(n, dtype=np.float64)
    np.add.at(denom, us, w)
    with np.errstate(invalid="ignore", divide="ignore"):
        p = np.where(denom[us] > 0, w / np.maximum(denom[us], 1e-300), 0.0)
        p_drn = np.where(w > 0, w_drn / np.maximum(w, 1e-300), 0.0)
    p_drn = np.clip(p_drn, 0.0, 1.0)
    a = np.zeros((n, n), dtype=np.float64)
    a_drn = np.zeros((n, n), dtype=np.float64)
    a[us, ns] = p
    a_drn[us, ns] = p * (1.0 - p_drn)
    return p, p_drn, a, a_drn


def _iterate(w: torch.Tensor, w_nr: torch.Tensor, arrive: torch.Tensor,
             move: torch.Tensor, w_th: float, iter_th: int):
    """Eq. (2)–(3) until Σw < w_th or iter ≥ iter_th, in the dtype of the
    inputs (the threshold is compared in that dtype too)."""
    th = torch.tensor(w_th, dtype=w.dtype, device=w.device)
    it = 0
    while it < iter_th and bool(w.sum() >= th):
        w_nr = w_nr + w @ arrive        # Σ_u w^u p^{u,n}     (eq. 3 term)
        w = w @ move                    # eq. (2)
        it += 1
    return w, w_nr, it


def evolve(a: np.ndarray, a_drn: np.ndarray, w0: np.ndarray,
           w_th: float = W_TH, iter_th: int = ITER_TH, device=None):
    """Run the node-level evolution in float32 on ``device``; returns
    (w_final, w_nr, iterations) with float32 weights.

    ``w0`` is the full initial-weight carry: the quasi-static re-planner
    (:mod:`repro_torch.noc.ctrl`) seeds it with the previous plan's
    residual fixed point on top of eq. (1).  float32 is the reference's
    precision here (its jitted loop runs with x64 off); the float32
    products use no TF32 unless the caller turned
    ``torch.backends.cuda.matmul.allow_tf32`` on.
    """
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    w0_t = f32(w0)
    w, w_nr, it = _iterate(w0_t, w0_t, f32(a), f32(a_drn), w_th,
                           int(iter_th))
    return w.cpu().numpy(), w_nr.cpu().numpy(), it


def initial_weights(traffic: np.ndarray) -> np.ndarray:
    """Eq. (1): w0[n] = Σ_{n'} T[n, n']."""
    return np.asarray(traffic, dtype=np.float64).sum(axis=1)


def joint_possibility(topo: Topology, traffic: np.ndarray,
                      chunk: int = 4096,
                      use_kernel: bool = False, device=None) -> np.ndarray:
    """Joint possibility weights for *consecutive* channels, dense (C, C):

        J[c1, c2] = Σ_{s,d} T[s,d] · [dist(s,u) + 2 + dist(n',d) == dist(s,d)]

    for c1 = (u, n), c2 = (n, n'), n' ≠ u; zero elsewhere.  The host loop
    is O(P·N²); ``use_kernel=True`` takes the device path on ``device``
    (:func:`repro_torch.core.plan_fast.joint_possibility_fast`, fp64).
    """
    if use_kernel:
        from .plan_fast import joint_possibility_fast
        return joint_possibility_fast(topo, traffic, device=device)
    dist = np.asarray(topo.distances, np.int64)
    t = np.asarray(traffic, np.float64)
    c = topo.num_channels
    chans = topo.channels
    j = np.zeros((c, c), np.float64)
    out_of: dict[int, list[int]] = {}
    for ci, (u, n) in enumerate(chans):
        out_of.setdefault(int(u), []).append(ci)
    pairs = []
    for c1, (u, n) in enumerate(chans):
        for c2 in out_of.get(int(n), []):
            n2 = int(chans[c2, 1])
            if n2 != int(u):  # a u→n→u continuation is never minimal anyway
                pairs.append((c1, c2, int(u), n2))
    pairs = np.array(pairs, np.int64).reshape(-1, 4)
    for lo in range(0, len(pairs), chunk):
        blk = pairs[lo:lo + chunk]
        us, n2s = blk[:, 2], blk[:, 3]
        lhs = dist[:, us].T[:, :, None] + 2 + dist[n2s, :][:, None, :]
        mask = lhs == dist[None, :, :]
        j[blk[:, 0], blk[:, 1]] = (mask * t[None]).sum(axis=(1, 2))
    return j


def nrank_channel(topo: Topology, traffic: np.ndarray,
                  w_th: float = W_TH, iter_th: int = ITER_TH,
                  w0: np.ndarray | None = None,
                  use_kernel: bool = False, device=None) -> NRankResult:
    """N-Rank with channel-level evolution state (what ``build_plan``
    uses by default): a quantum of weight can only continue onto
    channels that share a minimal path with the channel it arrived on.

    ``w0`` (optional, node-level) overrides the eq. (1) initial weights —
    the warm-start carry of the online re-planner; channel-level initial
    weights are rescaled per source.  ``use_kernel=True`` computes the
    possibility stages (eq. 5/7 and the joint) on the device paths.  The
    evolution runs in float64 on ``device``.
    """
    dev = resolve_device(device)
    traffic = np.asarray(traffic, dtype=np.float64)
    n, c = topo.num_nodes, topo.num_channels
    chans = topo.channels
    us, ns = chans[:, 0], chans[:, 1]
    if use_kernel:
        w, w_drn = _kernel_weights(topo, traffic, chans, dev)
    else:
        w, w_drn = possibility_weights(topo.distances, traffic, chans)
    with np.errstate(invalid="ignore", divide="ignore"):
        p_drn = np.where(w > 0, w_drn / np.maximum(w, 1e-300), 0.0)
    p_drn = np.clip(p_drn, 0.0, 1.0)
    j = joint_possibility(topo, traffic, use_kernel=use_kernel, device=dev)
    row = j.sum(1)
    with np.errstate(invalid="ignore", divide="ignore"):
        q = np.where(row[:, None] > 0, j / np.maximum(row, 1e-300)[:, None],
                     0.0)
    # transfer matrix: arrive at n, drain p_drn, continue per q
    m = q * (1.0 - p_drn)[:, None]            # (C, C)
    # initial channel weights: split each source's traffic equally over
    # its minimal outgoing channels per destination
    dist = np.asarray(topo.distances, np.int64)
    mask = (1 + dist[ns, :]) == dist[us, :]   # c on a minimal u → d path
    counts = np.zeros((n, n), np.float64)
    np.add.at(counts, us, mask.astype(np.float64))
    share = np.where(mask, traffic[us, :], 0.0)
    denom = counts[us, :]
    with np.errstate(invalid="ignore", divide="ignore"):
        w0c = np.where(denom > 0, share / np.maximum(denom, 1e-300),
                       0.0).sum(1)
    w0_node = initial_weights(traffic)
    if w0 is not None:
        w0_eff = np.asarray(w0, np.float64)
        outdeg = np.bincount(us, minlength=n).astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            scale = np.where(w0_node > 0,
                             w0_eff / np.maximum(w0_node, 1e-300), 0.0)
            extra = np.where(w0_node > 0, 0.0, w0_eff)
        w0c = w0c * scale[us] + extra[us] / np.maximum(outdeg[us], 1.0)
        w0_node = w0_eff
    # aggregation matrix: node arrivals from channel weights
    agg = np.zeros((c, n), np.float64)
    agg[np.arange(c), ns] = 1.0

    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    wcf, w_nr, it = _iterate(f64(w0c), f64(w0_node), f64(agg), f64(m),
                             w_th, int(iter_th))
    w_final = np.zeros(n)
    np.add.at(w_final, ns, wcf.cpu().numpy())
    p, p_drn_n, _, _ = transition_probabilities(topo, traffic, w, w_drn)
    return NRankResult(w_nr=w_nr.cpu().numpy(), w0=w0_node, w_final=w_final,
                       iterations=it, p=p, p_drn=p_drn_n, w_possibility=w)


def nrank(topo: Topology, traffic: np.ndarray,
          w_th: float = W_TH, iter_th: int = ITER_TH,
          use_kernel: bool = False,
          w0: np.ndarray | None = None, device=None) -> NRankResult:
    """Full N-Rank with the literal node-level evolution (eq. 2–3):
    topology + traffic distribution → NR-weights (float32, the
    reference's precision for this mode).

    ``w0`` (optional) replaces the eq. (1) initial weights — the online
    re-planner's warm-start carry.
    """
    dev = resolve_device(device)
    traffic = np.asarray(traffic, dtype=np.float64)
    if traffic.shape != (topo.num_nodes,) * 2:
        raise ValueError(
            f"traffic shape {traffic.shape} != {(topo.num_nodes,)*2}")
    if use_kernel:
        w, w_drn = _kernel_weights(topo, traffic, topo.channels, dev)
    else:
        w, w_drn = possibility_weights(topo.distances, traffic, topo.channels)
    p, p_drn, a, a_drn = transition_probabilities(topo, traffic, w, w_drn)
    if w0 is None:
        w0 = initial_weights(traffic)
    else:
        w0 = np.asarray(w0, dtype=np.float64)
    w_final, w_nr, it = evolve(a, a_drn, w0, w_th, iter_th, device=dev)
    return NRankResult(w_nr=w_nr, w0=w0, w_final=w_final, iterations=it,
                       p=p, p_drn=p_drn, w_possibility=w)
