"""Traffic matrices — the second input of N-Rank (paper §3.2).

``T[s, d]`` is the fraction of total traffic sourced at node ``s`` destined
to node ``d`` (``Σ T = 1``, zero diagonal).  The synthetic patterns follow
Dally & Towles [3] and the paper's evaluation (§4.2): Uniform, Shuffle,
Permutation, Overturn.  All builders respect the topology's ``io_weights``
so the edge-I/O configuration (Fig. 1c/1d) falls out naturally.
"""

from __future__ import annotations

import numpy as np

from .topology import Topology

__all__ = [
    "uniform",
    "shuffle",
    "permutation",
    "overturn",
    "transpose",
    "hotspot",
    "tornado",
    "alltoall",
    "from_pair_counts",
    "PATTERNS",
]


def _endpoint_weights(topo: Topology) -> np.ndarray:
    w = np.asarray(topo.io_weights, dtype=np.float64)
    if w.sum() <= 0:
        raise ValueError("topology has no I/O-capable nodes")
    return w


def _normalize(t: np.ndarray) -> np.ndarray:
    np.fill_diagonal(t, 0.0)
    s = t.sum()
    if s <= 0:
        raise ValueError("empty traffic matrix")
    return t / s


def uniform(topo: Topology) -> np.ndarray:
    """Uniformly distributed traffic over I/O-weighted endpoint pairs."""
    w = _endpoint_weights(topo)
    return _normalize(np.outer(w, w))


def _bits(n: int) -> int:
    b = 0
    while (1 << b) < n:
        b += 1
    return b


def shuffle(topo: Topology) -> np.ndarray:
    """Perfect shuffle: destination = rotate-left of the source id's bits.

    Endpoints without I/O (weight 0) re-target the nearest following
    I/O-capable node so the pattern stays total on edge-I/O topologies.
    """
    n = topo.num_nodes
    w = _endpoint_weights(topo)
    b = max(_bits(n), 1)
    t = np.zeros((n, n), dtype=np.float64)
    io_nodes = np.nonzero(w > 0)[0]
    for s in io_nodes:
        d = ((s << 1) | (s >> (b - 1))) & ((1 << b) - 1)
        d %= n
        if w[d] <= 0:  # snap to the closest I/O node
            d = int(io_nodes[np.argmin(np.abs(io_nodes - d))])
        if d == s:
            d = int(io_nodes[(np.searchsorted(io_nodes, s) + 1) % len(io_nodes)])
        t[s, d] = w[s]
    return _normalize(t)


def permutation(topo: Topology, seed: int = 0) -> np.ndarray:
    """A fixed random permutation over the I/O-capable nodes (seeded)."""
    w = _endpoint_weights(topo)
    io_nodes = np.nonzero(w > 0)[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(io_nodes))
    # de-fix any fixed points by rotating them
    fixed = np.nonzero(io_nodes[perm] == io_nodes)[0]
    if len(fixed):
        perm[fixed] = np.roll(perm[fixed], 1)
    t = np.zeros((topo.num_nodes,) * 2, dtype=np.float64)
    t[io_nodes, io_nodes[perm]] = w[io_nodes]
    return _normalize(t)


def overturn(topo: Topology) -> np.ndarray:
    """Overturn: each node sends to its spatial complement — the network
    "flipped upside down": coord_k → dims_k − 1 − coord_k."""
    n = topo.num_nodes
    w = _endpoint_weights(topo)
    dims = np.array(topo.dims)
    flipped = dims - 1 - topo.coords
    t = np.zeros((n, n), dtype=np.float64)
    for s in range(n):
        if w[s] <= 0:
            continue
        d = topo.node_id(flipped[s])
        if d == s or w[d] <= 0:
            continue
        t[s, d] = w[s]
    return _normalize(t)


def transpose(topo: Topology) -> np.ndarray:
    """Matrix-transpose pattern: (x, y) → (y, x) (2D only)."""
    if topo.ndim != 2 or topo.dims[0] != topo.dims[1]:
        raise ValueError("transpose needs a square 2D topology")
    n = topo.num_nodes
    w = _endpoint_weights(topo)
    t = np.zeros((n, n), dtype=np.float64)
    for s in range(n):
        if w[s] <= 0:
            continue
        x, y = topo.coords[s]
        d = topo.node_id((y, x))
        if d != s:
            t[s, d] = w[s]
    return _normalize(t)


def tornado(topo: Topology) -> np.ndarray:
    """Tornado: half-way shift along dimension 0 (adversarial on rings)."""
    n = topo.num_nodes
    w = _endpoint_weights(topo)
    t = np.zeros((n, n), dtype=np.float64)
    half = (topo.dims[0] - 1) // 2
    for s in range(n):
        if w[s] <= 0:
            continue
        c = topo.coords[s].copy()
        c[0] = (c[0] + half) % topo.dims[0]
        d = topo.node_id(c)
        if d != s:
            t[s, d] = w[s]
    return _normalize(t)


def hotspot(topo: Topology, hot_frac: float = 0.5,
            num_hot: int = 1, seed: int = 0) -> np.ndarray:
    """Uniform traffic with ``hot_frac`` of it redirected to hot nodes."""
    base = uniform(topo)
    w = _endpoint_weights(topo)
    io_nodes = np.nonzero(w > 0)[0]
    rng = np.random.default_rng(seed)
    hot = rng.choice(io_nodes, size=num_hot, replace=False)
    t = base * (1.0 - hot_frac)
    extra = np.zeros_like(base)
    extra[:, hot] = w[:, None]
    return _normalize(t + _normalize(extra) * hot_frac)


def alltoall(topo: Topology, skew: np.ndarray | None = None) -> np.ndarray:
    """Expert-parallel all-to-all: every I/O node sends to every other,
    optionally skewed per *destination* (hot experts receive more).

    ``skew`` is an (N,) relative weight per destination node (default
    uniform).  This is the ICI collective-scheduling matrix used by the
    linkload analyses and ``examples/qstar_ici_demo.py``.
    """
    w = _endpoint_weights(topo)
    s = np.ones(topo.num_nodes) if skew is None else np.asarray(
        skew, np.float64)
    if s.shape != (topo.num_nodes,):
        raise ValueError(f"skew shape {s.shape} != ({topo.num_nodes},)")
    return _normalize(np.outer(w, w * s))


def from_pair_counts(topo: Topology, counts: np.ndarray) -> np.ndarray:
    """Build T from measured (s, d) packet counts — the paper's 'statistical
    information' path for realistic workloads (§4.1)."""
    t = np.asarray(counts, dtype=np.float64).copy()
    if t.shape != (topo.num_nodes,) * 2:
        raise ValueError(f"counts shape {t.shape} != {(topo.num_nodes,)*2}")
    return _normalize(t)


PATTERNS = {
    "alltoall": alltoall,
    "uniform": uniform,
    "shuffle": shuffle,
    "permutation": permutation,
    "overturn": overturn,
    "transpose": transpose,
    "tornado": tornado,
    "hotspot": hotspot,
}
