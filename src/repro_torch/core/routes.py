"""Dimension-order routes (XY / YX and their k-dim generalizations).

BiDOR (paper §3.3) chooses between the two DOR routes ``R_0 = XY`` and
``R_1 = YX`` for every ⟨s, d⟩ pair.  On k-dimensional topologies we
generalize to the k! dimension orders; order index 0 is always the
ascending order (X-first — "XY") and order 1 on 2D topologies is YX, so the
paper's binary scheme is the ``orders[:2]`` special case.

Everything here is offline numpy (route tables are computed once and
hard-coded, mirroring the paper's bitmap deployment model).
"""

from __future__ import annotations

import itertools
import numpy as np

from .topology import Topology

__all__ = [
    "dimension_orders",
    "next_hop_table",
    "next_port_table",
    "route_nodes",
    "route_costs",
    "walk_routes",
    "min_rect_contains_channel",
]


def dimension_orders(ndim: int, binary_only: bool = False) -> list[tuple[int, ...]]:
    """All DOR orders.  2D → [(0, 1), (1, 0)] = [XY, YX]."""
    orders = sorted(itertools.permutations(range(ndim)))
    if binary_only:
        # paper-faithful pair: ascending and descending
        return [orders[0], orders[-1]]
    return orders


def _step_dir(cur: np.ndarray, dst: np.ndarray, size: int, wrap: bool) -> np.ndarray:
    """Per-node signed step (−1/0/+1) along one dimension toward dst."""
    delta = dst - cur
    if not wrap:
        return np.sign(delta)
    fwd = (dst - cur) % size
    bwd = (cur - dst) % size
    step = np.where(fwd == 0, 0, np.where(fwd <= bwd, 1, -1))
    return step


def _express_steps(topo: Topology) -> dict[int, list[tuple[int, np.ndarray]]]:
    """Express-hop availability per dimension: dim → [(magnitude, (N, 2)
    bool per node and sign)], magnitudes descending.  Empty dict when the
    topology has only unit-step channels (the common case)."""
    classes = topo._express_classes
    if not classes:
        return {}
    avail = {cls: np.zeros((topo.num_nodes, 2), bool) for cls in classes}
    for u, n in topo.channels:
        k, step = topo._channel_step(int(u), int(n))
        if abs(step) > 1:
            avail[(k, abs(step))][int(u), 0 if step > 0 else 1] = True
    out: dict[int, list[tuple[int, np.ndarray]]] = {}
    for (k, mag), av in sorted(avail.items(), key=lambda kv: -kv[0][1]):
        out.setdefault(k, []).append((mag, av))
    return out


def next_hop_table(topo: Topology, order: tuple[int, ...]) -> np.ndarray:
    """(N, N) int32: next node on the DOR route (cur, dst) → nxt.

    ``table[n, n] == n``.  On wrapping dimensions the minimal direction is
    taken (ties go to +, deterministically).  Where the topology has
    express channels, the walker takes the longest non-overshooting hop
    available at the current node (monotone progress within the active
    dimension, so DOR's turn restrictions — and deadlock freedom — are
    untouched); on unit-step topologies this is exactly the classic
    coordinate walk.
    """
    n = topo.num_nodes
    coords = topo.coords  # (N, ndim)
    cur = coords[:, None, :]  # (N, 1, ndim)
    dst = coords[None, :, :]  # (1, N, ndim)
    nxt_coord = np.broadcast_to(cur, (n, n, topo.ndim)).copy()
    moved = np.zeros((n, n), dtype=bool)
    express = _express_steps(topo)
    for k in order:
        size, wrap = topo.dims[k], topo.wrap[k]
        step = _step_dir(cur[..., k], dst[..., k], size, wrap)
        take = (~moved) & (step != 0)
        mag = np.ones((n, n), dtype=np.int64)
        if k in express and not wrap:
            need = np.abs(dst[..., k] - cur[..., k])  # (N, N)
            for m, av in express[k]:                  # magnitudes desc
                has = np.where(step > 0, av[:, :1], av[:, 1:])  # (N, N)
                use = (mag == 1) & has & (m <= need)
                mag = np.where(use, m, mag)
        nxt_coord[..., k] = np.where(
            take, (nxt_coord[..., k] + step * mag) % size,
            nxt_coord[..., k])
        moved |= take
    # collapse coordinates back to node ids
    table = (nxt_coord * topo.coord_strides).sum(-1).astype(np.int32)
    return table


def next_port_table(topo: Topology, order: tuple[int, ...]) -> np.ndarray:
    """(N, N) int8: output port of the DOR next hop; local port at dst."""
    nh = next_hop_table(topo, order)
    n = topo.num_nodes
    ports = np.full((n, n), topo.port_local, dtype=np.int8)
    neigh = topo.neighbor_table  # (N, P)
    for p in range(topo.num_ports - 1):
        match = (nh == neigh[:, p][:, None]) & (nh != np.arange(n)[:, None])
        ports[match] = p
    return ports


def walk_routes(topo: Topology, order: tuple[int, ...]) -> np.ndarray:
    """(N, N, L+1) int32 node sequences of every DOR route, padded with the
    destination (L = the route horizon — the BFS diameter on unit-step
    topologies; express shortcuts can push BFS distances below route
    lengths, so the horizon is the safe bound)."""
    nh = next_hop_table(topo, order)
    n = topo.num_nodes
    diam = topo.route_horizon
    seq = np.empty((n, n, diam + 1), dtype=np.int32)
    cur = np.broadcast_to(np.arange(n)[:, None], (n, n)).copy()
    dst = np.broadcast_to(np.arange(n)[None, :], (n, n))
    seq[..., 0] = cur
    for h in range(1, diam + 1):
        cur = nh[cur, dst]
        seq[..., h] = cur
    return seq


def route_nodes(topo: Topology, s: int, d: int, order: tuple[int, ...]) -> list[int]:
    """The explicit node sequence s → d under a DOR order (both endpoints
    included, as in the paper's Fig. 7 example)."""
    nh = next_hop_table(topo, order)
    seq = [s]
    cur = s
    for _ in range(topo.num_nodes + 1):
        if cur == d:
            break
        cur = int(nh[cur, d])
        seq.append(cur)
    else:  # pragma: no cover
        raise RuntimeError(f"route {s}->{d} did not terminate")
    return seq


def route_costs(topo: Topology, w_nr: np.ndarray,
                orders: list[tuple[int, ...]]) -> np.ndarray:
    """(len(orders), N, N) cumulative w_NR along every DOR route — eq. (10).

    Cost includes both endpoints (Fig. 7 sums all nodes on the path).
    Vectorized as a table walk: N² routes advance one hop per step.
    """
    n = topo.num_nodes
    w_nr = np.asarray(w_nr, dtype=np.float64)
    diam = topo.route_horizon
    costs = np.empty((len(orders), n, n), dtype=np.float64)
    dst = np.broadcast_to(np.arange(n)[None, :], (n, n))
    for oi, order in enumerate(orders):
        nh = next_hop_table(topo, order)
        cur = np.broadcast_to(np.arange(n)[:, None], (n, n)).copy()
        acc = w_nr[cur].copy()
        for _ in range(diam):
            nxt = nh[cur, dst]
            acc += np.where(nxt != cur, w_nr[nxt], 0.0)
            cur = nxt
        costs[oi] = acc
    return costs


def min_rect_contains_channel(topo: Topology, s: int, d: int,
                              u: int, n: int) -> bool:
    """Literal eq. (4) predicate for 2D meshes: Chan(u,n) ⊂ MinRect(s,d)
    *and* oriented toward d (no detours).  Used by tests to validate the
    general graph predicate in :mod:`repro_torch.core.nrank`."""
    if topo.ndim != 2 or any(topo.wrap):
        raise ValueError("MinRect is defined for non-wrapping 2D meshes")
    (sx, sy), (dx, dy) = topo.coords[s], topo.coords[d]
    (ux, uy), (nx, ny) = topo.coords[u], topo.coords[n]
    lox, hix = min(sx, dx), max(sx, dx)
    loy, hiy = min(sy, dy), max(sy, dy)
    inside = (lox <= ux <= hix and lox <= nx <= hix and
              loy <= uy <= hiy and loy <= ny <= hiy)
    if not inside:
        return False
    # direction consistency: the hop must move toward d
    step_x, step_y = nx - ux, ny - uy
    if step_x != 0:
        return np.sign(step_x) == np.sign(dx - sx) and dx != sx
    return np.sign(step_y) == np.sign(dy - sy) and dy != sy
