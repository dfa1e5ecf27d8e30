"""NoC / ICI topology graphs.

A :class:`Topology` is the first of the two inputs of N-Rank (paper §3.2):
it provides the *connection relationships* (each node's upstream set ``U^n``
and downstream set ``D^n``) and, implicitly, the *spatial attributes* used by
the possibility sets of eq. (4).

The same abstraction covers

* the paper's evaluation topologies — ``mesh2d`` (5×5 2DMesh, Fig. 1b) and
  ``mesh2d_edge_io`` (2DMesh with I/O only at edge nodes, Fig. 1c/1d),
* the TPU-adaptation topologies — ``torus`` for a single-pod ICI fabric
  (16×16, or 3D: ``torus(4, 4, 4)``) and ``multipod`` for the 2×16×16
  production mesh, where the inter-pod dimension has distinct (DCN)
  bandwidth, and
* the topology zoo beyond the paper's two graphs: ``cmesh`` (concentrated
  mesh — several cores share one router), ``express_mesh`` (2D mesh with
  express channels skipping intermediate routers), and
  ``fault_region_mesh`` (a mesh with a dead rectangular region — the
  irregular-graph stress case for plan-table routing).

All construction is offline (numpy); the arrays are consumed by the
planner (:mod:`repro_torch.core.plan_fast`) and by the simulator.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np

__all__ = [
    "Topology",
    "mesh2d",
    "mesh2d_edge_io",
    "torus",
    "multipod",
    "cmesh",
    "express_mesh",
    "fault_region_mesh",
    "PORT_LOCAL",
]

# Port encoding used by the routers/simulator: for dimension k, port 2k is the
# +k direction and port 2k+1 the −k direction.  Express channels (axis-aligned
# hops of magnitude > 1) get dedicated port pairs after the 2·ndim base ports,
# one (+, −) pair per distinct (dimension, magnitude) class, so the even/odd
# port pairing (+dir ⇄ −dir) holds for every network port.  The final port is
# local inject/eject.  (5-port router for a plain 2D mesh, as in paper §4.1.)
PORT_LOCAL = -1  # resolved per-topology as ``num_ports - 1``


@dataclasses.dataclass(frozen=True)
class Topology:
    """A directed channel graph with spatial coordinates.

    Attributes:
      name: human-readable identifier.
      dims: per-dimension extents, e.g. ``(5, 5)`` for the paper's mesh
        (dimension 0 is "x", the first dimension traversed by XY routing).
      wrap: per-dimension wrap-around flags (True ⇒ torus links).
      coords: ``(N, ndim)`` integer coordinates of each node.
      channels: ``(C, 2)`` directed channels ``(u, n)`` — "u has a channel
        towards n", so ``n ∈ D^u`` and ``u ∈ U^n``.
      io_weights: ``(N,)`` traffic-endpoint weight of each node.  1 for every
        node in a plain mesh; in the edge-I/O variant interior nodes get 0 and
        corner nodes 2 (20 I/O ports over 16 edge nodes, paper §4.1).
      channel_bw: ``(C,)`` relative bandwidth of each channel (1.0 = one flit
        per cycle; inter-pod DCN links get < 1).
    """

    name: str
    dims: tuple[int, ...]
    wrap: tuple[bool, ...]
    coords: np.ndarray
    channels: np.ndarray
    io_weights: np.ndarray
    channel_bw: np.ndarray

    # ------------------------------------------------------------------ #
    # basic derived quantities
    # ------------------------------------------------------------------ #
    @property
    def num_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def num_channels(self) -> int:
        return self.channels.shape[0]

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def num_ports(self) -> int:
        """Router ports: 2 per dimension + express port pairs + 1 local."""
        return self.port_local + 1

    @property
    def port_local(self) -> int:
        return 2 * self.ndim + 2 * len(self._express_classes)

    def node_id(self, coord: Sequence[int]) -> int:
        """Row-major in reversed-dim order: id = Σ coord[k] * stride[k], with
        dimension 0 the fastest-varying (so a 5×5 mesh numbers nodes row by
        row, matching Fig. 1/7 of the paper)."""
        nid = 0
        for k in reversed(range(self.ndim)):
            nid = nid * self.dims[k] + int(coord[k])
        return nid

    @functools.cached_property
    def chan_id(self) -> dict[tuple[int, int], int]:
        """(u, n) → channel index."""
        return {(int(u), int(n)): c for c, (u, n) in enumerate(self.channels)}

    @functools.cached_property
    def downstream(self) -> list[np.ndarray]:
        """D^n for every node (paper §3.2)."""
        out: list[list[int]] = [[] for _ in range(self.num_nodes)]
        for u, n in self.channels:
            out[int(u)].append(int(n))
        return [np.array(sorted(v), dtype=np.int32) for v in out]

    @functools.cached_property
    def upstream(self) -> list[np.ndarray]:
        """U^n for every node (paper §3.2)."""
        out: list[list[int]] = [[] for _ in range(self.num_nodes)]
        for u, n in self.channels:
            out[int(n)].append(int(u))
        return [np.array(sorted(v), dtype=np.int32) for v in out]

    @functools.cached_property
    def adjacency(self) -> np.ndarray:
        """(N, N) boolean adjacency (directed)."""
        a = np.zeros((self.num_nodes, self.num_nodes), dtype=bool)
        a[self.channels[:, 0], self.channels[:, 1]] = True
        return a

    @functools.cached_property
    def distances(self) -> np.ndarray:
        """(N, N) hop distances via BFS (int32; unreachable ⇒ large).

        One BFS level for every source at once: ``nxt[s, v]`` is set when
        any in-neighbour of ``v`` is on the frontier of ``s``.  Gathering
        over the padded in-neighbour lists costs O(N²·degree) a level,
        where a boolean matrix product costs O(N³) (numpy runs it without
        BLAS); the distances are the same."""
        n = self.num_nodes
        dist = np.full((n, n), np.iinfo(np.int32).max // 4, dtype=np.int32)
        np.fill_diagonal(dist, 0)
        reach = np.eye(n, dtype=bool)
        frontier = np.eye(n, dtype=bool)
        # in-neighbour lists padded with an always-False column n
        deg = max((len(u) for u in self.upstream), default=0)
        up = np.full((n, max(deg, 1)), n, dtype=np.int64)
        for v, us in enumerate(self.upstream):
            up[v, :len(us)] = us
        d = 0
        while frontier.any():
            d += 1
            padded = np.concatenate([frontier, np.zeros((n, 1), bool)], 1)
            nxt = padded[:, up].any(-1) & ~reach
            if not nxt.any():
                break
            dist[nxt] = d
            reach |= nxt
            frontier = nxt
        return dist

    def _channel_step(self, u: int, n: int) -> tuple[int, int]:
        """(dimension, signed step) of channel (u, n); wrap-corrected."""
        cu, cn = self.coords[int(u)], self.coords[int(n)]
        delta = cn - cu
        nz = np.nonzero(delta)[0]
        if len(nz) != 1:  # pragma: no cover - malformed channel
            raise ValueError(f"channel {u}->{n} is not axis-aligned")
        k = int(nz[0])
        step = int(delta[k])
        if self.wrap[k] and abs(step) == self.dims[k] - 1:
            step = int(-np.sign(step))  # wrap link: +dim edge goes size-1 → 0
        return k, step

    @functools.cached_property
    def _express_classes(self) -> tuple[tuple[int, int], ...]:
        """Distinct (dimension, magnitude) classes of express channels
        (axis-aligned steps with magnitude > 1), sorted.  Each class owns a
        (+, −) port pair after the 2·ndim unit-step base ports."""
        classes = set()
        for u, n in self.channels:
            k, step = self._channel_step(int(u), int(n))
            if abs(step) > 1:
                classes.add((k, abs(step)))
        return tuple(sorted(classes))

    @functools.cached_property
    def coord_strides(self) -> np.ndarray:
        """(ndim,) int64 strides mapping coordinates to node ids
        (dimension 0 fastest-varying): ``node_id = coords @ coord_strides``.
        Single source of truth for the numbering convention."""
        strides = np.ones(self.ndim, dtype=np.int64)
        for k in range(1, self.ndim):
            strides[k] = strides[k - 1] * self.dims[k - 1]
        return strides

    @property
    def route_horizon(self) -> int:
        """Upper bound on DOR route length (hops), per-dimension monotone:
        every hop makes ≥ 1 coordinate progress, so a route takes at most
        the unit-step diameter even when express channels shorten the BFS
        distances below route lengths.  Equals the BFS diameter on plain
        meshes/tori — the route walkers use this as their scan length."""
        return sum(d // 2 if w else d - 1
                   for d, w in zip(self.dims, self.wrap))

    @functools.cached_property
    def channel_port(self) -> np.ndarray:
        """(C,) output-port index at ``u`` of each channel (u, n).

        Unit steps use the base ports 2k (+) / 2k+1 (−); express classes
        use port pairs ``2·ndim + 2j`` (+) / ``2·ndim + 2j + 1`` (−) in
        ``_express_classes`` order.  The +/− pairing is even/odd for every
        class, which ``port_of_channel_at_receiver`` relies on.
        """
        express = {cls: 2 * self.ndim + 2 * j
                   for j, cls in enumerate(self._express_classes)}
        ports = np.zeros(self.num_channels, dtype=np.int32)
        for c, (u, n) in enumerate(self.channels):
            k, step = self._channel_step(int(u), int(n))
            base = 2 * k if abs(step) == 1 else express[(k, abs(step))]
            ports[c] = base if step > 0 else base + 1
        return ports

    @functools.cached_property
    def neighbor_table(self) -> np.ndarray:
        """(N, num_ports) neighbor node per output port; −1 if absent.

        The local port maps to the node itself.
        """
        table = np.full((self.num_nodes, self.num_ports), -1, dtype=np.int32)
        for c, (u, n) in enumerate(self.channels):
            table[int(u), self.channel_port[c]] = int(n)
        table[:, self.port_local] = np.arange(self.num_nodes)
        return table

    @functools.cached_property
    def port_of_channel_at_receiver(self) -> np.ndarray:
        """(C,) input-port index at ``n`` where channel (u, n) arrives.

        A +k channel arrives at the receiver's −k port and vice versa.
        """
        p = self.channel_port
        return np.where(p % 2 == 0, p + 1, p - 1).astype(np.int32)

    # ------------------------------------------------------------------ #
    # fault modelling (control plane)
    # ------------------------------------------------------------------ #
    @property
    def down_channels(self) -> np.ndarray:
        """Indices of channels with no usable bandwidth (hard-failed)."""
        return np.nonzero(self.channel_bw <= 0)[0]

    def channel_index(self, u: int, n: int) -> int:
        """Channel id of the directed link (u, n); raises if absent."""
        key = (int(u), int(n))
        if key not in self.chan_id:
            raise KeyError(f"no channel {u}->{n} in {self.name}")
        return self.chan_id[key]

    def degrade(self, failed: Sequence, bw_scale: float = 0.0,
                drop: bool = False) -> "Topology":
        """Topology with the listed channels failed or degraded.

        Args:
          failed: channel ids, or (u, n) node pairs, identifying directed
            channels.  A physical link is two directed channels; pass both
            if the whole link is down.
          bw_scale: multiplier applied to the failed channels' bandwidth.
            0 models a hard failure; fractions model a link retrained at
            reduced width (lane failure).
          drop: remove the failed channels from the graph entirely instead
            of keeping them at scaled bandwidth.  The planner view: hop
            distances, possibility sets and adjacency then reflect the
            degraded connectivity.  The simulator keeps the full channel
            set (same indexing) and models the failure through
            ``channel_bw`` instead, so only use ``drop`` for offline
            planning artifacts.

        Returns a new :class:`Topology`; ``self`` is unchanged.
        """
        ids = []
        for f in failed:
            if isinstance(f, (tuple, list, np.ndarray)):
                ids.append(self.channel_index(f[0], f[1]))
            else:
                ids.append(int(f))
        mask = np.zeros(self.num_channels, dtype=bool)
        mask[ids] = True
        if drop:
            return dataclasses.replace(
                self, name=self.name + "_degraded",
                channels=self.channels[~mask],
                channel_bw=self.channel_bw[~mask])
        bw = self.channel_bw.copy()
        bw[mask] = bw[mask] * float(bw_scale)
        return dataclasses.replace(self, name=self.name + "_degraded",
                                   channel_bw=bw)


# ---------------------------------------------------------------------- #
# constructors
# ---------------------------------------------------------------------- #
def _grid(dims: Sequence[int], wrap: Sequence[bool], name: str,
          io_weights: np.ndarray | None = None,
          inter_dim_bw: dict[int, float] | None = None) -> Topology:
    dims = tuple(int(d) for d in dims)
    wrap = tuple(bool(w) for w in wrap)
    ndim = len(dims)
    n = int(np.prod(dims))
    # coords with dimension 0 fastest-varying
    grids = np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")
    coords = np.stack([g.reshape(-1) for g in grids], axis=-1)
    # reorder so node_id = y*W + x for 2D (dim 0 fastest)
    order = np.lexsort(tuple(coords[:, k] for k in range(ndim)))
    coords = coords[order]

    strides = np.ones(ndim, dtype=np.int64)
    for k in range(1, ndim):
        strides[k] = strides[k - 1] * dims[k - 1]

    def nid(c):
        return int((c * strides).sum())

    chans: list[tuple[int, int]] = []
    bws: list[float] = []
    for i in range(n):
        c = coords[i]
        for k in range(ndim):
            for step in (+1, -1):
                cc = c.copy()
                cc[k] += step
                if 0 <= cc[k] < dims[k]:
                    pass
                elif wrap[k] and dims[k] > 2:
                    cc[k] %= dims[k]
                else:
                    continue
                chans.append((i, nid(cc)))
                bw = 1.0
                if inter_dim_bw and k in inter_dim_bw:
                    bw = inter_dim_bw[k]
                bws.append(bw)
    channels = np.array(sorted(set(chans)), dtype=np.int32)
    # re-derive bw aligned with the sorted/unique channel list
    bw_map = {}
    for ch, bw in zip(chans, bws):
        bw_map[ch] = bw
    channel_bw = np.array([bw_map[(int(u), int(v))] for u, v in channels])

    if io_weights is None:
        io_weights = np.ones(n, dtype=np.float64)
    return Topology(name=name, dims=dims, wrap=wrap, coords=coords,
                    channels=channels, io_weights=io_weights,
                    channel_bw=channel_bw)


def mesh2d(width: int, height: int) -> Topology:
    """Plain 2D mesh; every node has one I/O port (Fig. 1b setting)."""
    return _grid((width, height), (False, False), f"mesh2d_{width}x{height}")


def mesh2d_edge_io(width: int, height: int) -> Topology:
    """2D mesh where only edge nodes carry I/O ports (paper §4.1, Fig. 1c/d).

    The paper's 5×5 NoC exposes 20 I/O ports, 5 per edge, over 16 distinct
    edge nodes — corners therefore carry two ports and get weight 2.
    """
    topo = _grid((width, height), (False, False),
                 f"mesh2d_edge_io_{width}x{height}")
    x, y = topo.coords[:, 0], topo.coords[:, 1]
    on_x_edge = (x == 0) | (x == width - 1)
    on_y_edge = (y == 0) | (y == height - 1)
    w = on_x_edge.astype(np.float64) + on_y_edge.astype(np.float64)
    return dataclasses.replace(topo, io_weights=w)


def torus(*dims: int, name: str | None = None) -> Topology:
    """k-ary n-dimensional torus — the single-pod TPU ICI fabric."""
    return _grid(dims, (True,) * len(dims),
                 name or "torus_" + "x".join(map(str, dims)))


def multipod(num_pods: int, pod_x: int, pod_y: int,
             interpod_bw: float = 0.5) -> Topology:
    """Multi-pod fabric: per-pod 2D ICI torus + a (non-wrapping) pod axis.

    The pod axis models DCN/OCI connectivity between corresponding chips of
    adjacent pods with reduced relative bandwidth ``interpod_bw``.
    Dimension layout: (x, y, pod) so DOR orders generalize naturally.
    """
    return _grid(
        (pod_x, pod_y, num_pods),
        (True, True, False),
        f"multipod_{num_pods}x{pod_x}x{pod_y}",
        inter_dim_bw={2: interpod_bw},
    )


# ---------------------------------------------------------------------- #
# topology zoo (beyond the paper's mesh/torus pair)
# ---------------------------------------------------------------------- #
def cmesh(width: int, height: int, concentration: int = 4) -> Topology:
    """Concentrated mesh: a ``width×height`` router mesh where every router
    serves ``concentration`` cores (CMesh of Balfour & Dally).

    The router graph is a plain 2D mesh; concentration shows up as the
    per-router traffic-endpoint weight, so every traffic builder and the
    injection model scale naturally (``concentration`` I/O ports per node).
    """
    topo = _grid((width, height), (False, False),
                 f"cmesh_{width}x{height}c{concentration}")
    return dataclasses.replace(
        topo, io_weights=np.full(topo.num_nodes, float(concentration)))


def express_mesh(width: int, height: int, interval: int = 2,
                 express_bw: float = 1.0) -> Topology:
    """2D mesh with express channels (Dally's express cubes): every node at
    a coordinate multiple of ``interval`` gets a bidirectional channel
    skipping ``interval − 1`` routers along each dimension.

    Express channels are extra directed channels with |step| = interval;
    they carry their own router-port pair (see ``channel_port``) and appear
    in hop distances, possibility sets, and DOR next-hop tables (the route
    walker takes the longest non-overshooting hop), so the whole
    N-Rank → BiDOR → plan-table pipeline sees them as plain graph edges.
    """
    if interval < 2:
        raise ValueError("express interval must be >= 2")
    base = _grid((width, height), (False, False),
                 f"express_{width}x{height}i{interval}")
    chans = [(int(u), int(v)) for u, v in base.channels]
    extra: list[tuple[int, int]] = []
    for i in range(base.num_nodes):
        c = base.coords[i]
        for k in range(2):
            if c[k] % interval:
                continue
            cc = c.copy()
            cc[k] += interval
            if cc[k] < base.dims[k]:
                j = base.node_id(cc)
                extra.extend([(i, j), (j, i)])
    bw = {ch: 1.0 for ch in chans}
    bw.update({ch: float(express_bw) for ch in extra})
    channels = np.array(sorted(bw), dtype=np.int32)
    channel_bw = np.array([bw[(int(u), int(v))] for u, v in channels])
    return dataclasses.replace(base, channels=channels,
                               channel_bw=channel_bw)


def fault_region_mesh(width: int, height: int,
                      region: tuple[int, int, int, int],
                      bw_scale: float = 0.0) -> Topology:
    """Irregular mesh: a rectangular region of routers is failed.

    ``region`` is the inclusive rectangle (x0, y0, x1, y1).  Channels
    touching a region node keep their indices but lose their bandwidth
    (scaled by ``bw_scale``; 0 = hard fault) — the simulator models the
    fault through ``channel_bw``, while planners mask the down channels
    (``down_channels``) so hop distances and possibility sets see the
    irregular graph.  Region nodes also lose their I/O weight: dead
    routers neither source nor sink traffic.
    """
    x0, y0, x1, y1 = region
    # the region is part of the identity: two different fault regions on
    # the same grid must not collide in campaign CSVs / select() keys
    name = (f"fault_region_{width}x{height}_"
            f"r{x0}.{y0}.{x1}.{y1}"
            + (f"b{bw_scale:g}" if bw_scale else ""))
    topo = _grid((width, height), (False, False), name)
    x, y = topo.coords[:, 0], topo.coords[:, 1]
    dead = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    if dead.all():
        raise ValueError("fault region covers the whole mesh")
    failed = np.nonzero(dead[topo.channels[:, 0]]
                        | dead[topo.channels[:, 1]])[0]
    out = topo.degrade(failed, bw_scale=bw_scale)
    return dataclasses.replace(
        out, name=name, io_weights=np.where(dead, 0.0, topo.io_weights))
