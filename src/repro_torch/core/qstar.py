"""Q-StaR facade: N-Rank + BiDOR (paper Fig. 3 workflow).

``build_plan`` is the complete offline pipeline, stage by stage:

    (topology, traffic distribution) ──N-Rank──▶ w_NR ──BiDOR──▶ bitmaps

The returned :class:`QStarPlan` holds the NR-weights, the BiDOR routing
artifact and, on the gated paths of :mod:`repro_torch.core.plan_fast`,
its deadlock certificate.  ``predicted_node_load`` / ``link_load``
evaluate a routing choice against a traffic matrix without running the
simulator (:func:`repro_torch.core.bidor.greedy_refine` uses
``link_load``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .bidor import BiDORTable, bidor, bidor_k
from .nrank import NRankResult, nrank, nrank_channel
from .routes import walk_routes
from .topology import Topology

__all__ = ["QStarPlan", "build_plan", "predicted_node_load", "link_load",
           "link_load_stats"]


@dataclasses.dataclass(frozen=True)
class QStarPlan:
    topology: Topology
    traffic: np.ndarray
    nrank: NRankResult
    table: BiDORTable
    # deadlock-freedom certificate (repro_torch.core.certify) attached by the
    # build gates; None for plans assembled outside the gated paths
    cert: object = None

    @property
    def w_nr(self) -> np.ndarray:
        return self.nrank.w_nr

    @property
    def choice(self) -> np.ndarray:
        return self.table.choice


def build_plan(topo: Topology, traffic: np.ndarray, *,
               k_orders: bool = False,
               mode: str = "channel",
               w_th: float = 0.01, iter_th: int = 100,
               use_kernel: bool = False,
               w0: np.ndarray | None = None,
               down_channels: np.ndarray | None = None,
               device=None) -> QStarPlan:
    """Offline Q-StaR pipeline (not certified: the gated planners are
    :func:`repro_torch.core.plan_fast.build_plan_fast` and
    ``build_plans_batched``).

    Args:
      k_orders: False → paper-faithful binary BiDOR (XY/YX); True → the
        BiDOR-k generalization over all dimension orders.
      mode: "channel" (default) — channel-level evolution; "node" — the
        literal node-level eq. (2)–(3) evolution, in float32.
      use_kernel: compute the possibility stages on the device kernels
        (``possibility_weights``; in channel mode also the joint through
        ``possibility_v``) instead of the host numpy loops.
      w0: warm-start carry for the N-Rank evolution (node-level initial
        weights).
      down_channels: hard-failed channel mask/ids over ``topo.channels``;
        dimension orders whose route crosses one leave the BiDOR
        minimization (see :func:`repro_torch.core.bidor.bidor_k`).
      device: where the evolution (and, with ``use_kernel``, the
        kernels) run; default the card.
    """
    if mode == "channel":
        nr = nrank_channel(topo, traffic, w_th=w_th, iter_th=iter_th, w0=w0,
                           use_kernel=use_kernel, device=device)
    elif mode == "node":
        nr = nrank(topo, traffic, w_th=w_th, iter_th=iter_th,
                   use_kernel=use_kernel, w0=w0, device=device)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if k_orders:
        table = bidor_k(topo, nr.w_nr, down_channels=down_channels)
    else:
        table = bidor(topo, nr.w_nr, down_channels=down_channels)
    return QStarPlan(topology=topo, traffic=np.asarray(traffic), nrank=nr,
                     table=table)


def _route_seqs(topo: Topology,
                orders: tuple[tuple[int, ...], ...]) -> list[np.ndarray]:
    """Node sequences of every DOR route, one ``(N, N, L+1)`` array per
    order (L = diameter; routes are padded by repeating the destination).
    Per-pair order selection is applied by the callers via the BiDOR
    ``choice`` table."""
    return [walk_routes(topo, o) for o in orders]


def predicted_node_load(topo: Topology, traffic: np.ndarray,
                        table: BiDORTable) -> np.ndarray:
    """Per-node forwarding load implied by a routing table: the static
    analogue of the 'data forwarding rate' of Fig. 1.

    load[n] = Σ_{s,d} T[s,d] · [n on route(s,d)]  (endpoints included).
    """
    n = topo.num_nodes
    load = np.zeros(n, dtype=np.float64)
    seqs = _route_seqs(topo, table.orders)
    t = np.asarray(traffic, dtype=np.float64)
    if table.unroutable is not None:
        t = np.where(table.unroutable, 0.0, t)
    for oi, seq in enumerate(seqs):
        sel = table.choice == oi  # (N, N)
        w = np.where(sel, t, 0.0)
        hops = seq.shape[-1]
        prev = None
        for h in range(hops):
            nodes = seq[..., h]  # (N, N)
            if prev is not None:
                w_step = np.where(nodes != prev, w, 0.0)  # only while moving
            else:
                w_step = w
            np.add.at(load, nodes.reshape(-1), w_step.reshape(-1))
            prev = nodes
    return load


def link_load(topo: Topology, traffic: np.ndarray,
              table: BiDORTable) -> np.ndarray:
    """Per-channel load (bandwidth-normalized) implied by a routing table.

    Used to score ICI collective schedules: completion time of a decomposed
    collective ∝ max link load.
    """
    load = np.zeros(topo.num_channels, dtype=np.float64)
    seqs = _route_seqs(topo, table.orders)
    t = np.asarray(traffic, dtype=np.float64)
    if table.unroutable is not None:
        t = np.where(table.unroutable, 0.0, t)  # shed traffic contributes 0
    n = topo.num_nodes
    chan_lut = np.full((n, n), -1, dtype=np.int64)
    chan_lut[topo.channels[:, 0], topo.channels[:, 1]] = np.arange(
        topo.num_channels)
    for oi, seq in enumerate(seqs):
        sel = table.choice == oi
        w = np.where(sel, t, 0.0)
        hops = seq.shape[-1]
        for h in range(hops - 1):
            a, b = seq[..., h], seq[..., h + 1]
            moving = (a != b) & (chan_lut[a, b] >= 0)
            if not (a != b).any():
                break
            ids = chan_lut[a[moving], b[moving]]
            np.add.at(load, ids, w[moving])
    # a hard-failed (bw == 0) channel carrying planned load is an
    # infinite bottleneck, not a division error
    bw = topo.channel_bw
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(bw > 0, load / np.where(bw > 0, bw, 1.0),
                       np.where(load > 0, np.inf, 0.0))
    return out


def link_load_stats(topo: Topology, traffic: np.ndarray,
                    table: BiDORTable) -> dict:
    """Max and CV of the finite bandwidth-normalized link loads — the
    collective completion-time bound and its dispersion (infinite
    entries, i.e. planned load over a dead link, are excluded; detect
    them via :func:`link_load` directly)."""
    ll = link_load(topo, traffic, table)
    live = ll[np.isfinite(ll)]
    mean = float(live.mean()) if live.size else 0.0
    return {"max": float(live.max()) if live.size else 0.0,
            "cv": float(live.std() / mean) if mean else 0.0}
