"""Deadlock-freedom certification of plan-table routing artifacts.

Q-StaR's predictability claim rests on every deployed table being
deadlock-free.  The planner argues this *by construction* — each route is
a pure dimension-order route inside its own virtual-channel class — but
nothing verified the claim, and nothing at all protects hand-supplied
tables, degraded topologies, or future non-DOR planners.  This module
closes that gap with the classic channel-dependency-graph (CDG) argument
of Dally & Seitz:

* :func:`build_cdg` derives the CDG implied by (``port_tables``,
  ``choice``) over any :class:`~repro_torch.core.topology.Topology` — every
  consecutive channel pair of every routed ⟨s, d⟩ route is a dependency
  edge.  The CDG node is the *virtual channel resource*
  ``(channel, order class, dateline layer)``:

  - **order class** — the simulator dedicates a VC class per dimension
    order (a flit's VC is its route's order index), so routes of
    different orders never block on the same buffer; the CDG therefore
    splits per order, which is exactly why mixing XY and YX pairs (the
    O1Turn hazard) stays deadlock-free here.
  - **dateline layer** — wrap (torus) channels are modelled with the
    standard dateline split: layer 1 is entered when the route crosses a
    wrap channel of that dimension (minimal DOR crosses each dateline at
    most once, so two layers suffice).  This mirrors the dateline VC
    discipline of torus wormhole routing; it is an explicit modelling
    assumption, stated here and in EXPERIMENTS.md.

* :func:`certify_table` runs an **iterative** Tarjan SCC over the CDG
  (explicit stack — no recursion limits at 64×64) and certifies the
  table clean, or — when cycles exist — attempts a **minimal
  turn-prohibition repair**: repeatedly forbid the lowest-weight turn
  inside a cyclic SCC (weight = traffic routed through the turn, scaled
  by the pivot node's N-Rank weight when available, so lightly-ranked
  turns are cut first), re-route the affected pairs onto an alternate
  order whose route avoids every prohibited turn, and shed pairs no
  order can serve.  The outcome is a :class:`Certificate` with verdict
  ``clean`` / ``repaired`` / ``rejected``.

Everything is offline numpy.  The clean-path check is fully vectorized
(one ``O(L·N²)`` table walk + a linear-time SCC), cheap enough to gate
every plan build and every online replan (``benchmarks/run.py
certify_scale``).  The repair path walks routes per pair in Python — it
only ever runs on genuinely broken tables, never in the standard
pipeline.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .bidor import BiDORTable
from .topology import Topology

__all__ = ["Certificate", "CertificationError", "build_cdg",
           "certify_table", "certify_ports", "apply_repair",
           "cyclic_scc_nodes", "has_cycle_bruteforce"]


class CertificationError(RuntimeError):
    """A routing table failed certification and could not be repaired."""


@dataclasses.dataclass(frozen=True)
class Certificate:
    """Outcome of one deadlock-freedom check.

    ``verdict``: ``"clean"`` (the CDG is acyclic as supplied),
    ``"repaired"`` (cycles were broken by turn prohibition —
    ``choice`` / ``shed`` hold the repaired assignment), or
    ``"rejected"`` (cycles survived the repair budget; the table must
    not be deployed).
    """

    verdict: str
    cdg_nodes: int
    cdg_edges: int
    cyclic_nodes: int             # CDG nodes inside cyclic SCCs (pre-repair)
    prohibited_turns: np.ndarray  # (K, 2) int32 forbidden (chan, chan) turns
    # repaired per-pair assignment; None unless verdict == "repaired"
    choice: np.ndarray | None = None
    shed: np.ndarray | None = None      # (N, N) bool pairs shed by repair
    invalid_pairs: int = 0              # routes leaving the channel graph
    wall_ms: float = 0.0

    @property
    def ok(self) -> bool:
        return self.verdict in ("clean", "repaired")

    @property
    def shed_pairs(self) -> int:
        return int(self.shed.sum()) if self.shed is not None else 0

    # ---- (de)serialization: rides inside plan-cache npz payloads ---- #
    _VERDICTS = ("clean", "repaired", "rejected")

    def as_arrays(self) -> dict[str, np.ndarray]:
        out = {
            "cert_verdict": np.int64(self._VERDICTS.index(self.verdict)),
            "cert_nodes": np.int64(self.cdg_nodes),
            "cert_edges": np.int64(self.cdg_edges),
            "cert_cyclic": np.int64(self.cyclic_nodes),
            "cert_invalid": np.int64(self.invalid_pairs),
            "cert_prohibited": np.asarray(self.prohibited_turns,
                                          np.int32).reshape(-1, 2),
        }
        if self.choice is not None:
            out["cert_choice"] = np.asarray(self.choice, np.int8)
        if self.shed is not None:
            out["cert_shed"] = np.asarray(self.shed, bool)
        return out

    @classmethod
    def from_arrays(cls, arrays) -> "Certificate | None":
        if "cert_verdict" not in arrays:
            return None     # pre-certifier payload: caller re-certifies
        return cls(
            verdict=cls._VERDICTS[int(arrays["cert_verdict"])],
            cdg_nodes=int(arrays["cert_nodes"]),
            cdg_edges=int(arrays["cert_edges"]),
            cyclic_nodes=int(arrays["cert_cyclic"]),
            invalid_pairs=int(arrays["cert_invalid"]),
            prohibited_turns=np.asarray(arrays["cert_prohibited"],
                                        np.int32).reshape(-1, 2),
            choice=(np.asarray(arrays["cert_choice"], np.int8)
                    if "cert_choice" in arrays else None),
            shed=(np.asarray(arrays["cert_shed"], bool)
                  if "cert_shed" in arrays else None))

    def trace_args(self) -> dict:
        """Compact JSON-able summary for trace instants / metrics."""
        return {"verdict": self.verdict, "nodes": self.cdg_nodes,
                "edges": self.cdg_edges, "cyclic": self.cyclic_nodes,
                "prohibited": int(self.prohibited_turns.shape[0]),
                "shed": self.shed_pairs, "invalid": self.invalid_pairs,
                "wall_ms": round(self.wall_ms, 3)}


# --------------------------------------------------------------------- #
# channel attributes (dateline layering) + node-id packing
# --------------------------------------------------------------------- #
def _channel_geometry(topo: Topology):
    """Per-channel (dimension, is-wrap) arrays, vectorized."""
    u, v = topo.channels[:, 0], topo.channels[:, 1]
    delta = topo.coords[v] - topo.coords[u]          # (C, ndim)
    dim = np.abs(delta).argmax(axis=1).astype(np.int64)
    mag = np.abs(delta[np.arange(delta.shape[0]), dim])
    wrap = np.asarray(topo.wrap, bool)
    dims = np.asarray(topo.dims, np.int64)
    # a wrap link's raw coordinate delta spans the whole dimension; only
    # dimensions of extent > 2 have distinct wrap links (the grid builder
    # skips duplicates at extent 2)
    is_wrap = wrap[dim] & (mag == dims[dim] - 1) & (dims[dim] > 2)
    return dim, is_wrap


def _chan_lut(topo: Topology) -> np.ndarray:
    lut = np.full((topo.num_nodes, topo.num_nodes), -1, np.int64)
    lut[topo.channels[:, 0], topo.channels[:, 1]] = np.arange(
        topo.num_channels)
    return lut


def _next_tables(topo: Topology, port_tables: np.ndarray) -> np.ndarray:
    """(O, N, N) next-node tables implied by arbitrary port tables.

    The local port maps to the node itself (``neighbor_table``
    convention), so a route parks on its destination exactly like
    :func:`repro_torch.core.routes.walk_routes`; ports with no channel resolve
    to −1 (an invalid marker the walkers treat as a broken route).
    """
    neigh = topo.neighbor_table                       # (N, P)
    n = topo.num_nodes
    pt = np.clip(np.asarray(port_tables, np.int64), 0, topo.num_ports - 1)
    return neigh[np.arange(n)[:, None], pt].astype(np.int64)


# CDG node id: ((channel * num_orders) + order class) * 2 + layer.
def _pack(cid, cls, layer, num_orders):
    return 2 * (cid * num_orders + cls) + layer


def _unpack_channel(node, num_orders):
    return (node // 2) // num_orders


# --------------------------------------------------------------------- #
# CDG construction (vectorized)
# --------------------------------------------------------------------- #
def build_cdg(topo: Topology, port_tables: np.ndarray,
              choice: np.ndarray, *,
              active: np.ndarray | None = None,
              traffic: np.ndarray | None = None,
              max_hops: int | None = None):
    """Channel-dependency graph of a routed table.

    Walks every active ⟨s, d⟩ route through its chosen order's port
    table (``O(L·N²)`` numpy, no per-pair Python) and accumulates the
    consecutive-channel dependency edges over the
    ``(channel, order class, dateline layer)`` node space (see the
    module docstring).

    Returns ``(edges, weights, invalid)``: unique ``(E, 2)`` int64 edge
    array over packed node ids, per-edge float64 weight (traffic routed
    through the turn; pair count when ``traffic`` is None), and the
    (N, N) bool mask of invalid pairs — routes that leave the channel
    graph or fail to reach their destination within ``max_hops``.
    """
    n = topo.num_nodes
    num_orders = int(np.asarray(port_tables).shape[0])
    choice = np.asarray(choice, np.int64)
    if active is None:
        active = ~np.eye(n, dtype=bool)
    else:
        active = np.asarray(active, bool) & ~np.eye(n, dtype=bool)
    hops = int(max_hops) if max_hops is not None else max(
        topo.route_horizon, 1)
    dim, is_wrap = _channel_geometry(topo)
    lut = _chan_lut(topo)
    nxt_tables = _next_tables(topo, port_tables)      # (O, N, N)
    w = (np.asarray(traffic, np.float64) if traffic is not None
         else np.ones((n, n)))

    src = np.broadcast_to(np.arange(n)[:, None], (n, n))
    dst = np.broadcast_to(np.arange(n)[None, :], (n, n))
    cur = src.copy()
    live = active.copy()                # still walking, still valid
    invalid = np.zeros((n, n), bool)
    prev_node = np.full((n, n), -1, np.int64)   # previous CDG node id
    wrapped = np.zeros((n, n), np.int64)        # per-dim wrap bitmask
    edge_chunks: list[np.ndarray] = []
    weight_chunks: list[np.ndarray] = []

    for _ in range(hops):
        nh = nxt_tables[choice, cur, dst]
        moving = live & (nh != cur)
        if not moving.any():
            break
        bad = moving & (nh < 0)
        cid = np.where(moving & ~bad, lut[cur, np.where(nh >= 0, nh, 0)],
                       -1)
        bad |= moving & (cid < 0)
        invalid |= bad
        live &= ~bad
        moving &= ~bad
        if moving.any():
            safe_cid = np.maximum(cid, 0)
            k = dim[safe_cid]
            wrap_hop = moving & is_wrap[safe_cid]
            layer = ((wrapped >> k) & 1) | wrap_hop.astype(np.int64)
            node = _pack(cid, choice, layer, num_orders)
            has_prev = moving & (prev_node >= 0)
            if has_prev.any():
                edge_chunks.append(np.stack(
                    [prev_node[has_prev], node[has_prev]], axis=-1))
                weight_chunks.append(w[src[has_prev], dst[has_prev]])
            wrapped = np.where(wrap_hop, wrapped | (1 << k), wrapped)
            prev_node = np.where(moving, node, prev_node)
        cur = np.where(moving, nh, cur)
        live &= (cur != dst)

    # pairs still short of their destination after the hop budget:
    # parked early (bogus local port) or non-terminating
    invalid |= live
    num_nodes = 2 * num_orders * topo.num_channels
    if edge_chunks:
        edges = np.concatenate(edge_chunks)
        wts = np.concatenate(weight_chunks)
        keys = edges[:, 0] * num_nodes + edges[:, 1]
        uniq, inv = np.unique(keys, return_inverse=True)
        weights = np.zeros(uniq.shape[0])
        np.add.at(weights, inv, wts)
        edges = np.stack([uniq // num_nodes, uniq % num_nodes], axis=-1)
    else:
        edges = np.zeros((0, 2), np.int64)
        weights = np.zeros(0)
    return edges, weights, invalid


# --------------------------------------------------------------------- #
# cycle detection: iterative Tarjan + the brute-force oracle
# --------------------------------------------------------------------- #
def cyclic_scc_nodes(num_nodes: int, edges: np.ndarray) -> np.ndarray:
    """Bool mask of CDG nodes on some dependency cycle.

    Tarjan's strongly-connected-components algorithm with an explicit
    stack (no recursion — a 64×64 torus CDG has ~130k nodes, far past
    Python's recursion limit).  A node is cyclic iff its SCC has size
    > 1 or it carries a self-loop.
    """
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    cyclic = np.zeros(num_nodes, bool)
    if edges.shape[0] == 0:
        return cyclic
    order = np.argsort(edges[:, 0], kind="stable")
    heads, tails = edges[order, 0], edges[order, 1]
    starts = np.searchsorted(heads, np.arange(num_nodes + 1))
    cyclic[edges[edges[:, 0] == edges[:, 1], 0]] = True   # self-loops

    UNVISITED = -1
    index = np.full(num_nodes, UNVISITED, np.int64)
    low = np.zeros(num_nodes, np.int64)
    on_stack = np.zeros(num_nodes, bool)
    stack: list[int] = []
    counter = 0
    # only nodes with outgoing edges can root a non-trivial SCC, but the
    # DFS must still visit edge *targets*; iterating heads suffices since
    # an SCC of size > 1 has every node on an edge head
    for root in np.unique(heads):
        root = int(root)
        if index[root] != UNVISITED:
            continue
        work = [(root, int(starts[root]))]
        index[root] = low[root] = counter
        counter += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, ei = work[-1]
            if ei < starts[v + 1]:
                work[-1] = (v, ei + 1)
                u = int(tails[ei])
                if index[u] == UNVISITED:
                    index[u] = low[u] = counter
                    counter += 1
                    stack.append(u)
                    on_stack[u] = True
                    work.append((u, int(starts[u])))
                elif on_stack[u]:
                    low[v] = min(low[v], index[u])
            else:
                work.pop()
                if work:
                    p = work[-1][0]
                    low[p] = min(low[p], low[v])
                if low[v] == index[v]:          # v roots an SCC
                    comp = []
                    while True:
                        u = stack.pop()
                        on_stack[u] = False
                        comp.append(u)
                        if u == v:
                            break
                    if len(comp) > 1:
                        cyclic[comp] = True
    return cyclic


def has_cycle_bruteforce(num_nodes: int, edges: np.ndarray) -> bool:
    """Brute-force cycle existence via DFS back-edge detection.

    The property-test oracle (``tests/test_certify.py``): an independent,
    obviously-correct implementation the Tarjan verdict is checked
    against on small random graphs.  Iterative (explicit stack), with
    the classic white/gray/black coloring.
    """
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    adj: list[list[int]] = [[] for _ in range(num_nodes)]
    for a, b in edges:
        adj[int(a)].append(int(b))
    color = np.zeros(num_nodes, np.int8)        # 0 white 1 gray 2 black
    for root in range(num_nodes):
        if color[root]:
            continue
        work = [(root, 0)]
        color[root] = 1
        while work:
            v, ei = work[-1]
            if ei < len(adj[v]):
                work[-1] = (v, ei + 1)
                u = adj[v][ei]
                if color[u] == 1:
                    return True                 # back edge: cycle
                if color[u] == 0:
                    color[u] = 1
                    work.append((u, 0))
            else:
                color[v] = 2
                work.pop()
    return False


# --------------------------------------------------------------------- #
# certification + repair
# --------------------------------------------------------------------- #
def certify_ports(topo: Topology, port_tables: np.ndarray,
                  choice: np.ndarray, *,
                  unroutable: np.ndarray | None = None,
                  traffic: np.ndarray | None = None,
                  w_nr: np.ndarray | None = None,
                  repair: bool = True,
                  max_repair_rounds: int = 64,
                  tracer=None, label: str = "") -> Certificate:
    """Certify (or repair) an arbitrary (``port_tables``, ``choice``).

    Args:
      port_tables: (O, N, N) int next-output-port tables.
      choice: (N, N) per-pair order index.
      unroutable: pairs already shed upstream — excluded from the CDG
        (their traffic never enters the network).
      traffic: turn weights for the repair policy (uniform when None).
      w_nr: per-node N-Rank weights; when given, a turn's repair weight
        is scaled by the weight of the node the turn pivots on, so
        repair prohibits the lowest-N-Rank-weight turns first.
      repair: attempt turn-prohibition repair on a cyclic CDG; False
        certifies only (verdict ``clean`` or ``rejected``).
      tracer: optional tracer (``enabled``, ``now_us``,
        ``complete``, ``instant``); emits a
        ``certify`` span plus a per-check verdict instant.

    Returns a :class:`Certificate`.  Raising on rejection is the
    caller's policy (the plan gates raise :class:`CertificationError`).
    """
    t0 = time.perf_counter()
    tr0 = tracer.now_us() if tracer is not None and tracer.enabled else 0.0
    n = topo.num_nodes
    port_tables = np.asarray(port_tables)
    num_orders = int(port_tables.shape[0])
    choice = np.asarray(choice, np.int64)
    active = ~np.eye(n, dtype=bool)
    if unroutable is not None:
        active &= ~np.asarray(unroutable, bool)
    # arbitrary tables may take non-minimal paths; the N-hop cap keeps
    # the walk finite on ANY table, while well-formed DOR-like tables
    # (local port on the diagonal) get the tight route-horizon bound
    hops = max(topo.route_horizon, 1) if _ejects_at_destination(
        topo, port_tables) else n
    edges, _, invalid = build_cdg(
        topo, port_tables, choice, active=active, traffic=traffic,
        max_hops=hops)
    num_cdg_nodes = 2 * num_orders * topo.num_channels
    cyc = cyclic_scc_nodes(num_cdg_nodes, edges)
    cyclic0 = int(cyc.sum())

    if cyclic0 == 0 or not repair:
        cert = Certificate(
            verdict="clean" if cyclic0 == 0 else "rejected",
            cdg_nodes=num_cdg_nodes, cdg_edges=int(edges.shape[0]),
            cyclic_nodes=cyclic0,
            prohibited_turns=np.zeros((0, 2), np.int32),
            invalid_pairs=int(invalid.sum()),
            wall_ms=(time.perf_counter() - t0) * 1e3)
    else:
        cert = _repair(topo, port_tables, choice, active, traffic, w_nr,
                       hops, max_repair_rounds, num_cdg_nodes,
                       int(edges.shape[0]), cyclic0, int(invalid.sum()),
                       t0)
    if tracer is not None and tracer.enabled:
        tracer.complete("certify", tr0, tracer.now_us() - tr0,
                        cat="certify",
                        args=dict(cert.trace_args(), label=label))
        tracer.instant(f"certify_{cert.verdict}", cat="certify",
                       args=dict(cert.trace_args(), label=label))
    return cert


def _ejects_at_destination(topo: Topology,
                           port_tables: np.ndarray) -> bool:
    """Every order parks routes on their destination (local port on the
    (d, d) diagonal) — the precondition for the route-horizon hop cap."""
    idx = np.arange(topo.num_nodes)
    diag = np.asarray(port_tables)[..., idx, idx]
    return bool((diag == topo.port_local).all())


def _route_turns(nxt_tables, lut, dim, is_wrap, num_orders,
                 oi: int, cls: int, s: int, d: int, max_hops: int):
    """One route's packed (node, node) turn list; None if invalid."""
    cur, turns, prev, wrapped = s, [], -1, 0
    for _ in range(max_hops):
        if cur == d:
            return turns
        nh = int(nxt_tables[oi, cur, d])
        if nh == cur or nh < 0:
            return None
        c = int(lut[cur, nh])
        if c < 0:
            return None
        k = int(dim[c])
        wrap_hop = bool(is_wrap[c])
        layer = ((wrapped >> k) & 1) | int(wrap_hop)
        node = _pack(c, cls, layer, num_orders)
        if prev >= 0:
            turns.append((prev, node))
        if wrap_hop:
            wrapped |= 1 << k
        prev = node
        cur = nh
    return turns if cur == d else None


def _repair(topo, port_tables, choice, active, traffic, w_nr, hops,
            max_rounds, num_cdg_nodes, edges0, cyclic0, invalid0, t0):
    """Turn-prohibition repair (pair-level Python; broken tables only)."""
    n = topo.num_nodes
    num_orders = int(port_tables.shape[0])
    dim, is_wrap = _channel_geometry(topo)
    lut = _chan_lut(topo)
    nxt_tables = _next_tables(topo, port_tables)
    t = (np.asarray(traffic, np.float64) if traffic is not None
         else np.ones((n, n)))
    wn = np.asarray(w_nr, np.float64) if w_nr is not None else None
    chan_head = topo.channels[:, 1]     # turn (c1 -> c2) pivots on head(c1)

    choice = np.asarray(choice, np.int64).copy()
    shed = np.zeros((n, n), bool)
    prohibited: set[tuple[int, int]] = set()    # channel-level turns

    def pair_turns(oi, s, d):
        return _route_turns(nxt_tables, lut, dim, is_wrap, num_orders,
                            oi, oi, s, d, hops)

    def uses_prohibited(turns):
        return any((_unpack_channel(a, num_orders),
                    _unpack_channel(b, num_orders)) in prohibited
                   for a, b in turns)

    def try_reroute(s, d):
        """Move (s, d) to an order avoiding all prohibited turns, else
        shed it."""
        for oi in range(num_orders):
            if oi == int(choice[s, d]):
                continue
            alt = pair_turns(oi, s, d)
            if alt is None or uses_prohibited(alt):
                continue
            choice[s, d] = oi
            routes[(s, d)] = alt
            return
        shed[s, d] = True
        del routes[(s, d)]

    # per-pair turn lists of the CURRENT assignment
    routes: dict[tuple[int, int], list] = {}
    for s in range(n):
        for d in range(n):
            if not active[s, d]:
                continue
            turns = pair_turns(int(choice[s, d]), s, d)
            if turns is None:
                shed[s, d] = True       # invalid route: shed outright
            else:
                routes[(s, d)] = turns

    for _ in range(max_rounds):
        # rebuild the edge multiset + weights from live routes
        edge_w: dict[tuple[int, int], float] = {}
        edge_pairs: dict[tuple[int, int], list] = {}
        for (s, d), turns in routes.items():
            for e in turns:
                edge_w[e] = edge_w.get(e, 0.0) + float(t[s, d])
                edge_pairs.setdefault(e, []).append((s, d))
        if not edge_w:
            break
        earr = np.array(sorted(edge_w), np.int64).reshape(-1, 2)
        cyc = cyclic_scc_nodes(num_cdg_nodes, earr)
        in_cycle = [e for e in edge_w if cyc[e[0]] and cyc[e[1]]]
        if not in_cycle:
            break
        # lowest-weight turn inside a cyclic SCC; N-Rank scaling prefers
        # cutting turns that pivot on lightly-ranked routers
        def turn_weight(e):
            wgt = edge_w[e]
            if wn is not None:
                wgt *= float(wn[chan_head[_unpack_channel(e[0],
                                                          num_orders)]])
            return (wgt, e)             # deterministic tie-break
        cut = min(in_cycle, key=turn_weight)
        prohibited.add((_unpack_channel(cut[0], num_orders),
                        _unpack_channel(cut[1], num_orders)))
        # re-route every pair whose current route now uses a prohibited
        # turn (the channel-level ban can hit several layered edges)
        for (s, d) in [p for e in list(edge_pairs)
                       if (_unpack_channel(e[0], num_orders),
                           _unpack_channel(e[1], num_orders)) in prohibited
                       for p in edge_pairs[e]]:
            if (s, d) in routes and uses_prohibited(routes[(s, d)]):
                try_reroute(s, d)
    else:
        return Certificate(
            verdict="rejected", cdg_nodes=num_cdg_nodes, cdg_edges=edges0,
            cyclic_nodes=cyclic0,
            prohibited_turns=np.array(sorted(prohibited),
                                      np.int32).reshape(-1, 2),
            invalid_pairs=invalid0,
            wall_ms=(time.perf_counter() - t0) * 1e3)

    # final verification of the repaired assignment
    final_edges = set()
    for turns in routes.values():
        final_edges.update(turns)
    earr = (np.array(sorted(final_edges), np.int64).reshape(-1, 2)
            if final_edges else np.zeros((0, 2), np.int64))
    verdict = ("rejected" if cyclic_scc_nodes(num_cdg_nodes, earr).any()
               else "repaired")
    return Certificate(
        verdict=verdict, cdg_nodes=num_cdg_nodes, cdg_edges=edges0,
        cyclic_nodes=cyclic0,
        prohibited_turns=(np.array(sorted(prohibited),
                                   np.int32).reshape(-1, 2)
                          if prohibited else np.zeros((0, 2), np.int32)),
        choice=choice.astype(np.int8) if verdict == "repaired" else None,
        shed=shed if verdict == "repaired" else None,
        invalid_pairs=invalid0,
        wall_ms=(time.perf_counter() - t0) * 1e3)


def certify_table(topo: Topology, table: BiDORTable, *,
                  traffic: np.ndarray | None = None,
                  w_nr: np.ndarray | None = None,
                  repair: bool = True,
                  tracer=None, label: str = "") -> Certificate:
    """Certify a :class:`~repro_torch.core.bidor.BiDORTable` (see
    :func:`certify_ports`).  Pairs the table already sheds
    (``table.unroutable``) are excluded from the CDG."""
    return certify_ports(topo, table.port_tables, table.choice,
                         unroutable=table.unroutable, traffic=traffic,
                         w_nr=w_nr, repair=repair, tracer=tracer,
                         label=label)


def apply_repair(table: BiDORTable, cert: Certificate) -> BiDORTable:
    """Fold a ``repaired`` certificate back into the table artifact:
    the repaired choice replaces the original, and repair-shed pairs
    merge into ``unroutable`` (admission control sheds them upstream)."""
    if cert.verdict != "repaired":
        raise ValueError(f"certificate verdict is {cert.verdict!r}")
    unroutable = cert.shed.copy()
    if table.unroutable is not None:
        unroutable |= table.unroutable
    return dataclasses.replace(table, choice=cert.choice,
                               unroutable=unroutable)
