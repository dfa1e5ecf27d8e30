"""BiDOR — bi-modal dimension-order routing guided by N-Rank (paper §3.3).

For every ⟨s, d⟩, compare the cumulative ``w_NR`` along the XY and YX routes
(eq. 10) and pick the cheaper one; the choice is stored one bit per
destination in a per-source bitmap (eq. 11) for O(1) runtime lookup.

``bidor_k`` generalizes the binary choice to all k! dimension orders on
k-dimensional topologies (used for the multi-pod ICI fabric); with
``orders=dimension_orders(2)`` it reduces exactly to the paper's scheme.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .topology import Topology
from .routes import dimension_orders, route_costs, next_port_table

__all__ = ["BiDORTable", "bidor", "bidor_k", "dor_table", "TIE_TOL"]

# Relative tolerance of the eq. 10 minimization's tie detection.  Shared
# with the device-resident pipeline (repro_torch.core.plan_fast), whose choice
# tables must be identical to this oracle's.
TIE_TOL = 1e-5


@dataclasses.dataclass(frozen=True)
class BiDORTable:
    """Offline routing artifact deployed to the routers.

    Attributes:
      choice: (N, N) int8 — DOR-order index for every ⟨s, d⟩ (0 = XY).
        For the binary paper scheme this *is* the bitmap of eq. (11):
        ``bitmap[s] = choice[s, :]``.
      orders: the dimension orders the indices refer to.
      costs: (len(orders), N, N) cumulative w_NR per route (diagnostics).
      port_tables: (len(orders), N, N) int8 — next output port for
        (current-node, destination) under each order; routers follow
        ``port_tables[choice[s, d], cur, d]``.
    """

    choice: np.ndarray
    orders: tuple[tuple[int, ...], ...]
    costs: np.ndarray
    port_tables: np.ndarray
    # (N, N) bool — pairs for which NO dimension order avoids the down
    # channels (set by fault-aware planning; None on intact topologies).
    # Their traffic must be shed (admission control) — the stored choice
    # would cross a dead link.
    unroutable: np.ndarray | None = None

    @property
    def bitmaps(self) -> np.ndarray:
        """Per-source |N|-bitmaps (eq. 11); valid for the binary scheme."""
        if len(self.orders) > 2:
            raise ValueError("bitmaps are defined for the binary (XY/YX) scheme")
        return self.choice.astype(np.uint8)

    def packed_bitmaps(self) -> np.ndarray:
        """(N, ceil(N/8)) uint8 — the hardware bitmap layout."""
        return np.packbits(self.bitmaps, axis=1)


def dor_table(topo: Topology,
              orders: list[tuple[int, ...]] | None = None) -> BiDORTable:
    """Plan-table artifact for plain dimension-order routing.

    The table-routed simulator consumes (``port_tables``, ``choice``) for
    EVERY algorithm; the DOR baselines (XY, YX, O1Turn, Valiant, ROMM)
    route over this trivial artifact — binary orders, all-XY choice, no
    costs — so the simulator needs no routing logic of its own beyond the
    table gather.
    """
    if orders is None:
        orders = dimension_orders(topo.ndim, binary_only=True)
    n = topo.num_nodes
    ports = np.stack([next_port_table(topo, o) for o in orders])
    return BiDORTable(choice=np.zeros((n, n), np.int8),
                      orders=tuple(map(tuple, orders)),
                      costs=np.zeros((len(orders), n, n)),
                      port_tables=ports)


def route_feasibility(topo: Topology,
                      orders: list[tuple[int, ...]],
                      down: np.ndarray) -> np.ndarray:
    """(O, N, N) bool — order o's DOR route s→d avoids every down channel.

    ``down`` is a boolean per-channel mask (or an index array) over
    ``topo.channels``.  Works on the *intact* channel indexing: DOR routes
    are functions of coordinates alone, so feasibility is just a walk of
    each route against the down set.
    """
    from .routes import walk_routes

    down = np.asarray(down)
    if down.dtype != bool:
        m = np.zeros(topo.num_channels, dtype=bool)
        m[down] = True
        down = m
    n = topo.num_nodes
    down_pair = np.zeros((n, n), dtype=bool)
    down_pair[topo.channels[down, 0], topo.channels[down, 1]] = True
    feas = np.ones((len(orders), n, n), dtype=bool)
    for oi, order in enumerate(orders):
        seq = walk_routes(topo, order)               # (N, N, L+1)
        for h in range(seq.shape[-1] - 1):
            a, b = seq[..., h], seq[..., h + 1]
            hit = (a != b) & down_pair[a, b]
            feas[oi] &= ~hit
    return feas


def bidor_k(topo: Topology, w_nr: np.ndarray,
            orders: list[tuple[int, ...]] | None = None,
            tie_break: str = "xy",
            down_channels: np.ndarray | None = None) -> BiDORTable:
    """Choose, per ⟨s, d⟩, the DOR order with minimal Σ w_NR (eq. 10).

    ``tie_break``: "xy" (paper default — lowest order index) or "hash"
    (deterministic per-pair split across tied orders).  Flip-symmetric
    patterns (Overturn) tie on EVERY pair; measurements (EXPERIMENTS.md
    §Fidelity) show tie→XY dominates, so it stays the default.

    ``down_channels`` (fault-aware planning): boolean mask or index array
    over ``topo.channels`` of hard-failed channels.  Orders whose route
    crosses a down channel are masked out of the eq. (10) minimization, so
    every selected route stays a pure DOR route inside its own VC class —
    the fallback keeps the quasi-static scheme deadlock-free by
    construction.  Pairs no order can serve are flagged in
    ``BiDORTable.unroutable`` (their traffic must be shed upstream).
    """
    if orders is None:
        orders = dimension_orders(topo.ndim)
    costs = route_costs(topo, w_nr, orders)          # (O, N, N)
    unroutable = None
    if down_channels is not None and np.asarray(down_channels).size:
        feas = route_feasibility(topo, orders, down_channels)
        unroutable = ~feas.any(axis=0)
        np.fill_diagonal(unroutable, False)
        # infeasible orders leave the minimization; unroutable pairs keep
        # their unmasked costs so `choice` stays well-defined (and shed).
        big = np.where(unroutable[None], costs, np.inf)
        costs = np.where(feas, costs, big)
    # Ties are resolved with a tolerance (w_NR is float32; ties on
    # symmetric topologies are symmetry-exact) and broken by a
    # deterministic per-pair hash across the tied orders.  Flip-symmetric
    # patterns (e.g. Overturn) tie on EVERY pair — always defaulting to XY
    # would degenerate BiDOR to pure XY there, contradicting the paper's
    # own Table 1; the hash splits tied pairs evenly while staying fully
    # deterministic/offline (same bitmap artifact, same in-order property).
    n = topo.num_nodes
    best = costs.min(axis=0)
    tol = TIE_TOL * (1.0 + np.abs(best))
    is_min = costs <= best + tol                      # (O, N, N)
    if tie_break == "hash":
        num_min = is_min.sum(axis=0)                  # (N, N)
        sid = np.arange(n, dtype=np.uint64)
        mix = (sid[:, None] * np.uint64(2654435761)
               ^ (sid[None, :] * np.uint64(40503) + np.uint64(0x9E3779B9)))
        rank = ((mix >> np.uint64(13)).astype(np.int64)
                % np.maximum(num_min, 1))
        cum = np.cumsum(is_min, axis=0) - 1           # rank of tied order
        pick = is_min & (cum == rank[None])
        choice = np.argmax(pick, axis=0).astype(np.int8)
    else:
        choice = np.argmax(is_min, axis=0).astype(np.int8)  # first minimal
    np.fill_diagonal(choice, 0)
    ports = np.stack([next_port_table(topo, o) for o in orders])
    return BiDORTable(choice=choice, orders=tuple(map(tuple, orders)),
                      costs=costs, port_tables=ports,
                      unroutable=unroutable)


def bidor(topo: Topology, w_nr: np.ndarray,
          down_channels: np.ndarray | None = None) -> BiDORTable:
    """Paper-faithful binary BiDOR: XY vs YX only."""
    return bidor_k(topo, w_nr, dimension_orders(topo.ndim, binary_only=True),
                   down_channels=down_channels)


def greedy_refine(topo: Topology, traffic, table: BiDORTable,
                  sweeps: int = 4) -> BiDORTable:
    """BiDOR-G (beyond paper): greedy max-link-load refinement.

    BiDOR minimizes each pair's *own* path cost against the static w_NR
    field; it never sees the load its choice induces on others.  BiDOR-G
    post-processes the table: sweep pairs in decreasing traffic order and
    flip a pair's dimension order whenever that lowers the current maximum
    link load (recomputed incrementally).  Still fully offline/quasi-static
    — the output is the same bitmap artifact.
    """
    import numpy as _np
    from .routes import walk_routes
    from .qstar import link_load as _link_load

    t = _np.asarray(traffic, dtype=_np.float64)
    n = topo.num_nodes
    orders = table.orders
    seqs = [walk_routes(topo, o) for o in orders]
    chan_lut = _np.full((n, n), -1, _np.int64)
    chan_lut[topo.channels[:, 0], topo.channels[:, 1]] = _np.arange(
        topo.num_channels)

    def pair_links(oi, s, d):
        """Channel ids of route (s, d) under order oi; None if the route
        crosses a channel absent from the (possibly degraded) graph."""
        seq = seqs[oi][s, d]
        ids = []
        for h in range(len(seq) - 1):
            a, b = int(seq[h]), int(seq[h + 1])
            if a == b:
                break
            c = int(chan_lut[a, b])
            if c < 0:
                return None
            ids.append(c)
        return ids

    choice = table.choice.copy()
    load = _link_load(topo, t,
                      BiDORTable(choice=choice, orders=orders,
                                 costs=table.costs,
                                 port_tables=table.port_tables,
                                 unroutable=table.unroutable))
    bw = _np.where(topo.channel_bw > 0, topo.channel_bw, 1e-12)
    unroutable = table.unroutable
    pairs = [(s, d) for s in range(n) for d in range(n)
             if s != d and t[s, d] > 0
             and not (unroutable is not None and unroutable[s, d])]
    pairs.sort(key=lambda p: -t[p])
    for _ in range(sweeps):
        changed = 0
        for s, d in pairs:
            cur = int(choice[s, d])
            cur_links = pair_links(cur, s, d)
            if cur_links is None:
                continue  # current route leaves the degraded graph
            best_oi, best_peak = cur, max(
                (load[c] for c in cur_links), default=0.0)
            for oi in range(len(orders)):
                if oi == cur:
                    continue
                alt = pair_links(oi, s, d)
                if alt is None:
                    continue
                # peak among affected links if we moved this pair
                peak = 0.0
                for c in alt:
                    peak = max(peak, load[c]
                               + (0 if c in cur_links else t[s, d] / bw[c]))
                if peak < best_peak - 1e-15:
                    best_oi, best_peak = oi, peak
            if best_oi != cur:
                for c in cur_links:
                    load[c] -= t[s, d] / bw[c]
                for c in pair_links(best_oi, s, d):
                    load[c] += t[s, d] / bw[c]
                choice[s, d] = best_oi
                changed += 1
        if changed == 0:
            break
    return BiDORTable(choice=choice, orders=orders, costs=table.costs,
                      port_tables=table.port_tables,
                      unroutable=table.unroutable)
