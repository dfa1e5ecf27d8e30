"""Device-resident Q-StaR planner in torch (fp64 on the card).

The same pipeline as the reference's ``build_plan_fast`` — possibility
pass, consecutive-channel joint possibility, sparse channel-level
evolution (eq. 1–3) and BiDOR's eq. 10 minimisation — written as plain
torch ops over a batch of traffic matrices, with the one O(N³) step, the
on-path traffic

    OP[u, d] = Σ_s T[s,d] · [dist(s,u) + dist(u,d) == dist(s,d)],

running in the ``possibility_v`` CUDA kernel on the card
(:mod:`repro_torch.kernels.possibility`).  Every other weight is a
cheap contraction of it (see the reference module for the
factorisation): ``V[c,d] = dag[c,d]·OP[u_c,d]``, eq. 5 is ``V·1``, eq. 7
the gather ``V[c, n_c]``, and the joint possibility
``J[c1,c2] = Σ_d V[c1,d]·[dist(n,d) == 1 + dist(n2,d)]``.

The planner runs in fp64 on every device: the H100 has native fp64, and
the reference's CPU plans and the committed fixtures are fp64, so the
choice tables come out identical to the reference's.  Hard-failed
channels are masked (``live``) with degraded hop distances passed as
data, exactly as in the reference.

``cache`` (a :class:`repro_torch.core.plan_cache.PlanCache`) serves and
stores cold builds by content key (:func:`plan_cache_key`); a lane that
hits is never planned, and when every lane hits the planner does not run
at all.  ``tracer`` (a :class:`repro_torch.obs.trace.TraceWriter`)
records each build as a span and the cache's hits and misses as
instants.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.possibility import possibility_v
from ..obs.trace import NULL_TRACER
from .bidor import TIE_TOL, BiDORTable
from .certify import CertificationError, apply_repair, certify_table
from .nrank import ITER_TH, W_TH, NRankResult, initial_weights
from .qstar import QStarPlan
from .routes import dimension_orders, next_hop_table, next_port_table
from .topology import Topology

__all__ = ["build_plan_fast", "build_plans_batched", "plan_statics",
           "gate_plan", "joint_possibility_fast", "plan_cache_key"]

F64 = torch.float64
_TINY = 1e-300


@dataclasses.dataclass
class PlanStatics:
    """Host-built constants of one topology: channel and pair indexing,
    DOR next-hop and next-port tables."""

    n: int
    c: int
    npairs: int
    diam: int
    orders: tuple
    us: np.ndarray           # (C,) channel sources
    ns: np.ndarray           # (C,) channel heads
    pair_c1: np.ndarray      # (P,) consecutive-pair first channel
    pair_c2: np.ndarray      # (P,) consecutive-pair second channel
    nh: np.ndarray           # (O, N, N) DOR next-hop tables
    port_tables: np.ndarray  # (O, N, N) int8 (BiDOR artifact)


_STATICS_CACHE: dict[tuple, PlanStatics] = {}
_DIST_CACHE: dict[tuple, np.ndarray] = {}
_CACHE_CAP = 16


def _topo_key(topo: Topology) -> tuple:
    return (topo.name, topo.dims, topo.wrap, topo.channels.tobytes())


def _consecutive_pairs(channels: np.ndarray, n: int):
    """(c1, c2) channel pairs with head(c1) == src(c2), u-turns excluded.

    ``channels`` is lexicographically sorted (topology construction), so
    the out-channels of node ``v`` are the contiguous run starting at
    ``searchsorted(us, v)``.
    """
    us = channels[:, 0].astype(np.int64)
    ns = channels[:, 1].astype(np.int64)
    c = len(channels)
    outdeg = np.bincount(us, minlength=n)
    start = np.concatenate([[0], np.cumsum(outdeg)])
    reps = outdeg[ns]                          # out-degree at each head
    c1 = np.repeat(np.arange(c), reps)
    pos = np.arange(len(c1)) - np.repeat(np.cumsum(reps) - reps, reps)
    c2 = start[ns[c1]] + pos
    keep = ns[c2] != us[c1]                    # u→n→u is never minimal
    return c1[keep].astype(np.int64), c2[keep].astype(np.int64)


def plan_statics(topo: Topology, *, binary_only: bool = True) -> PlanStatics:
    """Host-built constants for the planner (cached per topology)."""
    key = _topo_key(topo) + (binary_only,)
    hit = _STATICS_CACHE.get(key)
    if hit is not None:
        return hit
    n, c = topo.num_nodes, topo.num_channels
    orders = tuple(map(tuple, dimension_orders(topo.ndim,
                                               binary_only=binary_only)))
    c1, c2 = _consecutive_pairs(topo.channels, n)
    statics = PlanStatics(
        n=n, c=c, npairs=len(c1), diam=topo.route_horizon, orders=orders,
        us=topo.channels[:, 0].astype(np.int64),
        ns=topo.channels[:, 1].astype(np.int64),
        pair_c1=c1, pair_c2=c2,
        nh=np.stack([next_hop_table(topo, o) for o in orders]).astype(
            np.int64),
        port_tables=np.stack([next_port_table(topo, o) for o in orders]))
    if len(_STATICS_CACHE) >= _CACHE_CAP:
        _STATICS_CACHE.pop(next(iter(_STATICS_CACHE)))
    _STATICS_CACHE[key] = statics
    return statics


def _down_ids(topo: Topology, down_channels) -> np.ndarray:
    if down_channels is None:
        return np.zeros(0, np.int64)
    down = np.asarray(down_channels)
    if down.dtype == bool:
        return np.nonzero(down)[0]
    return np.unique(down.astype(np.int64))


def _distances_for(topo: Topology, down: np.ndarray) -> np.ndarray:
    """Hop distances of the graph minus the down channels (cached)."""
    if down.size == 0:
        return topo.distances
    key = (_topo_key(topo), down.tobytes())
    hit = _DIST_CACHE.get(key)
    if hit is None:
        hit = topo.degrade(down, drop=True).distances
        if len(_DIST_CACHE) >= _CACHE_CAP:
            _DIST_CACHE.pop(next(iter(_DIST_CACHE)))
        _DIST_CACHE[key] = hit
    return hit


def _fault_arrays(topo: Topology, statics: PlanStatics, down_channels):
    """(down ids, degraded distances, live mask, down node-pair mask)."""
    down = _down_ids(topo, down_channels)
    dist = _distances_for(topo, down)
    live = np.ones(statics.c, bool)
    live[down] = False
    down_pair = np.zeros((statics.n, statics.n), bool)
    if down.size:
        down_pair[topo.channels[down, 0], topo.channels[down, 1]] = True
    return down, dist, live, down_pair


class _StageClock:
    """Milliseconds of each planner stage, added into ``out``: host
    stages by the host clock, each closed by a device synchronise, and
    device stages by CUDA events on the card.  A no-op when ``out`` is
    None."""

    def __init__(self, out: dict | None, dev: torch.device):
        self.out, self.cuda = out, dev.type == "cuda"

    def _add(self, name: str, ms: float) -> None:
        self.out[name] = self.out.get(name, 0.0) + ms

    @contextlib.contextmanager
    def host(self, name: str):
        if self.out is None:
            yield
            return
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if self.cuda:
            torch.cuda.synchronize()
        self._add(name, (time.perf_counter() - t0) * 1e3)

    @contextlib.contextmanager
    def device(self, name: str):
        if self.out is None or not self.cuda:
            with self.host(name):
                yield
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield
        end.record()
        end.synchronize()
        self._add(name, start.elapsed_time(end))


def _seg(x: torch.Tensor, idx: torch.Tensor, num: int) -> torch.Tensor:
    """Segment sum over the last axis of ``x`` (batched)."""
    out = torch.zeros(x.shape[:-1] + (num,), dtype=x.dtype, device=x.device)
    return out.index_add_(x.dim() - 1, idx, x)


def _factored_v(dist: torch.Tensor, t: torch.Tensor, us, ns,
                clock: _StageClock) -> torch.Tensor:
    """V (G, C, N): the on-path traffic OP from the possibility pass at
    offset 0 (one launch per traffic matrix), gathered per channel and
    masked by the channel's membership of d's minimal-path DAG."""
    with clock.device("possibility_v"):
        ops = [possibility_v(dist, dist, tg, dist, offset=0) for tg in t]
    op = torch.stack(ops)                               # (G, N, N)
    dag = (dist[us, :] == 1 + dist[ns, :]).to(t.dtype)  # (C, N)
    return dag[None] * op[:, us, :]


def _joint_vals(dist, v, ns, pair_c1, pair_c2) -> torch.Tensor:
    """J on the consecutive pairs: Σ_d V[c1,d]·[dist(n,d) == 1+dist(n2,d)]."""
    n1, n2 = ns[pair_c1], ns[pair_c2]
    jmask = (dist[n1, :] == 1 + dist[n2, :]).to(v.dtype)   # (P, N)
    return (v[:, pair_c1] * jmask[None]).sum(2)


def _plan_core(st: PlanStatics, dist, t, w0_eff, use_w0, live, down_pair,
               w_th: float, iter_th: int, clock: _StageClock) -> dict:
    """The batched plan computation: ``t`` (G, N, N) fp64 on the device;
    returns a dict of (G, ...) tensors."""
    dev = t.device
    n, c = st.n, st.c
    us = torch.as_tensor(st.us, device=dev)
    ns = torch.as_tensor(st.ns, device=dev)
    c1 = torch.as_tensor(st.pair_c1, device=dev)
    c2 = torch.as_tensor(st.pair_c2, device=dev)
    livef = live.to(F64)
    g = t.shape[0]

    # ---- possibility pass: eq. 5/7 and the joint, from V ---- #
    v = _factored_v(dist, t, us, ns, clock) * livef[None, :, None]
    w = v.sum(2)                                          # eq. (5)
    w_drn = v[:, torch.arange(c, device=dev), ns]         # eq. (7): d == n
    jflat = _joint_vals(dist, v, ns, c1, c2) * livef[c2]
    rowsum = _seg(jflat, c1, c)
    p_drn_c = torch.clip(torch.where(
        w > 0, w_drn / torch.clamp_min(w, _TINY), 0.0), 0.0, 1.0)
    rs = rowsum[:, c1]
    mvals = torch.where(rs > 0, jflat / torch.clamp_min(rs, _TINY),
                        0.0) * (1.0 - p_drn_c[:, c1])

    # ---- initial channel weights (eq. 1 split over min channels) ---- #
    mask_cd = ((1 + dist[ns, :]) == dist[us, :]) & live[:, None]   # (C, N)
    cnt = _seg(mask_cd.to(F64).T, us, n).T                         # (N, N)
    share = mask_cd[None] * t[:, us, :]
    denom = cnt[us]
    w0c = torch.where(denom[None] > 0,
                      share / torch.clamp_min(denom, _TINY)[None],
                      0.0).sum(2)
    w0_base = t.sum(2)                                             # eq. (1)
    outdeg = _seg(livef, us, n)
    scale = torch.where(w0_base > 0,
                        w0_eff / torch.clamp_min(w0_base, _TINY), 0.0)
    extra = torch.where(w0_base > 0, 0.0, w0_eff)
    w0c_warm = (w0c * scale[:, us]
                + extra[:, us] / torch.clamp_min(outdeg[us], 1.0)) * livef
    w0c = torch.where(use_w0[:, None], w0c_warm, w0c * livef)
    w0_node = torch.where(use_w0[:, None], w0_eff, w0_base)

    # ---- evolution: eq. (2)-(3), sparse over consecutive pairs ---- #
    # each lane stops at its own termination (the batched loop freezes
    # finished lanes, as a vmapped while_loop does)
    wc, w_nr = w0c, w0_node
    it = torch.zeros(g, dtype=torch.int32, device=dev)
    while True:
        active = (wc.sum(1) >= w_th) & (it < iter_th)
        if not bool(active.any()):
            break
        w_nr = torch.where(active[:, None], w_nr + _seg(wc, ns, n), w_nr)
        wc = torch.where(active[:, None], _seg(wc[:, c1] * mvals, c2, c), wc)
        it = it + active.to(torch.int32)
    w_final = _seg(wc, ns, n)

    # ---- node-level transfer probabilities (eq. 8-9 diagnostics) ---- #
    denom_n = _seg(w, us, n)[:, us]
    p = torch.where(denom_n > 0, w / torch.clamp_min(denom_n, _TINY), 0.0)

    # ---- BiDOR: eq. 10 cost walk + fault feasibility ---- #
    nh = torch.as_tensor(st.nh, device=dev)
    dst = torch.arange(n, device=dev)[None, :].expand(n, n)
    costs, feas = [], []
    for oi in range(nh.shape[0]):
        cur = torch.arange(n, device=dev)[:, None].expand(n, n)
        acc = w_nr[:, :, None].expand(g, n, n)
        ok = torch.ones((n, n), dtype=torch.bool, device=dev)
        for _ in range(st.diam):
            nxt = nh[oi][cur, dst]
            moving = nxt != cur
            acc = acc + torch.where(moving[None], w_nr[:, nxt], 0.0)
            ok = ok & ~(moving & down_pair[cur, nxt])
            cur = nxt
        costs.append(acc)
        feas.append(ok)
    costs = torch.stack(costs, 1)                       # (G, O, N, N)
    feas = torch.stack(feas)                            # (O, N, N)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    unroutable = ~feas.any(0) & ~eye
    big = torch.where(unroutable[None, None], costs, torch.inf)
    costs_m = torch.where(feas[None], costs, big)
    best = costs_m.min(1).values
    tol = TIE_TOL * (1.0 + best.abs())
    is_min = (costs_m <= (best + tol)[:, None]).to(torch.uint8)
    choice = torch.where(eye[None], 0, is_min.argmax(1)).to(torch.int8)
    return dict(choice=choice, costs=costs_m,
                unroutable=unroutable[None].expand(g, n, n),
                w_nr=w_nr, w0=w0_node, w_final=w_final, it=it,
                p=p, p_drn=p_drn_c, w=w)


def _assemble_plan(topo: Topology, traffic: np.ndarray, statics: PlanStatics,
                   out: dict, have_down: bool) -> QStarPlan:
    unroutable = np.asarray(out["unroutable"]) if have_down else None
    nr = NRankResult(
        w_nr=np.asarray(out["w_nr"], np.float64),
        w0=np.asarray(out["w0"], np.float64),
        w_final=np.asarray(out["w_final"], np.float64),
        iterations=int(out["it"]),
        p=np.asarray(out["p"], np.float64),
        p_drn=np.asarray(out["p_drn"], np.float64),
        w_possibility=np.asarray(out["w"], np.float64))
    table = BiDORTable(
        choice=np.asarray(out["choice"], np.int8), orders=statics.orders,
        costs=np.asarray(out["costs"], np.float64),
        port_tables=statics.port_tables, unroutable=unroutable)
    return QStarPlan(topology=topo, traffic=np.asarray(traffic), nrank=nr,
                     table=table)


def gate_plan(topo: Topology, plan: QStarPlan, *, tracer=None,
              label: str = "") -> QStarPlan:
    """Mandatory deadlock-freedom gate on every plan-producing path.

    Certifies the plan's table (:mod:`repro_torch.core.certify`),
    attaches the certificate (``plan.cert``), folds a turn-prohibition
    repair back into the table when the certifier had to intervene, and
    raises :class:`CertificationError` when cycles survive repair.
    Clean plans pass through bit-unchanged.
    """
    cert = certify_table(topo, plan.table, traffic=plan.traffic,
                         w_nr=plan.nrank.w_nr, tracer=tracer, label=label)
    if not cert.ok:
        raise CertificationError(
            f"plan for {topo.name} failed deadlock certification "
            f"({cert.cyclic_nodes} cyclic CDG nodes survive repair; "
            f"label={label!r})")
    if cert.verdict == "repaired":
        plan = dataclasses.replace(plan,
                                   table=apply_repair(plan.table, cert))
    return dataclasses.replace(plan, cert=cert)


def plan_cache_key(topo: Topology, traffic, *, down_channels=None,
                   k_orders: bool = False, w_th: float = W_TH,
                   iter_th: int = ITER_TH) -> str:
    """The content key a cold :func:`build_plan_fast` or
    :func:`build_plans_batched` lane with these arguments uses against a
    plan cache."""
    from .plan_cache import plan_key

    return plan_key(topo, traffic, down_channels=down_channels,
                    k_orders=k_orders, w_th=w_th, iter_th=iter_th)


def _cache_lookup(cache, topo, traffic, down_channels, k_orders, w_th,
                  iter_th, w0):
    """(key, hit) in the plan cache; (None, None) for a build that is not
    cached (warm-started, or no cache)."""
    if cache is None or w0 is not None:
        return None, None
    key = plan_cache_key(topo, traffic, down_channels=down_channels,
                         k_orders=k_orders, w_th=w_th, iter_th=iter_th)
    return key, cache.get(key, topo)


def _admit_cached(cache, key: str, hit: QStarPlan, topo: Topology, *,
                  tracer=None, label: str = "") -> QStarPlan:
    """Admission of a cached plan: a stored clean certificate satisfies
    the deadlock gate; anything else is certified again."""
    cert = cache.get_cert(key)
    if cert is not None and cert.verdict == "clean":
        return dataclasses.replace(hit, cert=cert)
    return gate_plan(topo, hit, tracer=tracer, label=label)


def _build(topo: Topology, tms, w0s, *, k_orders, w_th, iter_th,
           down_channels, dev, stage_ms, tracer, label) -> list[QStarPlan]:
    """The batched planner proper: one device computation over every
    matrix, then each plan through :func:`gate_plan`."""
    clock = _StageClock(stage_ms, dev)
    with clock.host("host_tables"):
        statics = plan_statics(topo, binary_only=not k_orders)
        down, dist, live, down_pair = _fault_arrays(topo, statics,
                                                    down_channels)
    with clock.host("device"):
        t_b = torch.as_tensor(np.stack(tms), device=dev)
        w0_b = torch.as_tensor(np.stack(
            [initial_weights(t) if w0 is None else np.asarray(w0, np.float64)
             for t, w0 in zip(tms, w0s)]), device=dev)
        use_b = torch.as_tensor(np.array([w0 is not None for w0 in w0s]),
                                device=dev)
        out = _plan_core(
            statics, torch.as_tensor(np.asarray(dist, np.int32), device=dev),
            t_b, w0_b, use_b, torch.as_tensor(live, device=dev),
            torch.as_tensor(down_pair, device=dev), float(w_th),
            int(iter_th), clock)
        out = {k: v.cpu().numpy() for k, v in out.items()}
    plans = []
    with clock.host("certify"):
        for i, tm in enumerate(tms):
            lane = {k: v[i] for k, v in out.items()}
            plan = _assemble_plan(topo, tm, statics, lane,
                                  have_down=bool(down.size))
            plans.append(gate_plan(topo, plan, tracer=tracer, label=label))
    return plans


def build_plans_batched(topo: Topology, traffics, *, w0s=None,
                        k_orders: bool = False,
                        w_th: float = W_TH, iter_th: int = ITER_TH,
                        down_channels=None, device=None,
                        stage_ms: dict | None = None,
                        cache=None, tracer=None) -> list[QStarPlan]:
    """Plans for many traffic matrices on one topology in one batched
    device computation; each plan is certified by :func:`gate_plan`.

    ``down_channels`` (one fault pattern shared by the batch) masks the
    failed channels out of every plan, as in the reference.  ``device``
    defaults to the card (``cuda``); pass ``"cpu"`` for the plain path.
    A ``stage_ms`` dict gets the milliseconds of each stage added in:
    ``host_tables`` (hop distances by BFS, DOR tables, channel pairs),
    ``device`` (the batched computation and its copy back, with
    ``possibility_v``, the kernel's own time, inside it) and ``certify``
    (the deadlock certificate of every plan).

    ``cache`` serves and stores the cold lanes by content key; the misses
    are planned in one batched call, and when every lane hits the planner
    does not run.  ``tracer`` records the build as a span and each
    lane's hit or miss as an instant.
    """
    dev = resolve_device(device)
    tracer = tracer if tracer is not None else NULL_TRACER
    tms = [np.asarray(t, np.float64) for t in traffics]
    if w0s is None:
        w0s = [None] * len(tms)
    if cache is not None:
        plans: dict[int, QStarPlan] = {}
        keys: dict[int, str] = {}
        for i, (tm, w0) in enumerate(zip(tms, w0s)):
            key, hit = _cache_lookup(cache, topo, tm, down_channels,
                                     k_orders, w_th, iter_th, w0)
            if hit is not None:
                plans[i] = _admit_cached(cache, key, hit, topo, tracer=tracer,
                                         label=f"cache_hit:{i}")
                tracer.instant("plan_cache_hit", cat="plan",
                               args={"lane": i, "nodes": topo.num_nodes})
            elif key is not None:
                keys[i] = key
                tracer.instant("plan_cache_miss", cat="plan",
                               args={"lane": i, "nodes": topo.num_nodes})
        need = [i for i in range(len(tms)) if i not in plans]
        if need:
            built = build_plans_batched(
                topo, [tms[i] for i in need], w0s=[w0s[i] for i in need],
                k_orders=k_orders, w_th=w_th, iter_th=iter_th,
                down_channels=down_channels, device=dev, stage_ms=stage_ms,
                tracer=tracer)
            for i, plan in zip(need, built):
                plans[i] = plan
                if i in keys:
                    cache.put(keys[i], plan, k_orders=k_orders,
                              cert=plan.cert)
            cache.stats.device_builds += 1
        return [plans[i] for i in range(len(tms))]
    t_span = tracer.now_us()
    plans = _build(topo, tms, w0s, k_orders=k_orders, w_th=w_th,
                   iter_th=iter_th, down_channels=down_channels, dev=dev,
                   stage_ms=stage_ms, tracer=tracer,
                   label="build_plans_batched")
    if tracer.enabled:
        tracer.complete("build_plans_batched", t_span,
                        tracer.now_us() - t_span, cat="plan",
                        args={"nodes": topo.num_nodes, "lanes": len(tms),
                              "faults": int(_down_ids(topo,
                                                      down_channels).size)})
    return plans


def build_plan_fast(topo: Topology, traffic: np.ndarray, *,
                    k_orders: bool = False,
                    w_th: float = W_TH, iter_th: int = ITER_TH,
                    w0: np.ndarray | None = None,
                    down_channels=None, device=None,
                    cache=None, tracer=None) -> QStarPlan:
    """One plan: the batched planner over a single matrix, with the
    optional warm-start carry ``w0``.  ``cache`` serves and stores a cold
    build (a warm one is never cached); ``tracer`` records the build as
    a span, its host stages and the rest split in its args, and a cache
    hit as an instant."""
    dev = resolve_device(device)
    tracer = tracer if tracer is not None else NULL_TRACER
    key, hit = _cache_lookup(cache, topo, traffic, down_channels, k_orders,
                             w_th, iter_th, w0)
    if hit is not None:
        tracer.instant("plan_cache_hit", cat="plan",
                       args={"nodes": topo.num_nodes})
        return _admit_cached(cache, key, hit, topo, tracer=tracer,
                             label="cache_hit")
    t_all = tracer.now_us()
    stage = {} if tracer.enabled else None
    plan = _build(topo, [np.asarray(traffic, np.float64)], [w0],
                  k_orders=k_orders, w_th=w_th, iter_th=iter_th,
                  down_channels=down_channels, dev=dev, stage_ms=stage,
                  tracer=tracer, label="build_plan_fast")[0]
    if cache is not None:
        cache.stats.device_builds += 1
    if tracer.enabled:
        statics_ms = stage.get("host_tables", 0.0)
        tracer.complete(
            "build_plan_fast", t_all, tracer.now_us() - t_all, cat="plan",
            args={"nodes": topo.num_nodes, "warm": w0 is not None,
                  "faults": int(_down_ids(topo, down_channels).size),
                  "statics_ms": round(statics_ms, 3),
                  "device_ms": round(sum(stage.values()) - statics_ms, 3)})
    if key is not None:
        cache.put(key, plan, k_orders=k_orders, cert=plan.cert)
    return plan


def joint_possibility_fast(topo: Topology, traffic: np.ndarray, *,
                           device=None) -> np.ndarray:
    """Device path for :func:`repro_torch.core.nrank.joint_possibility`:
    the dense (C, C) consecutive-channel joint weights (fp64, on the
    host) from the factored V — one ``possibility_v`` launch, then the
    O(P·N) contraction — instead of the host loop's O(P·N²)."""
    dev = resolve_device(device)
    st = plan_statics(topo)
    dist = torch.as_tensor(np.asarray(topo.distances, np.int32), device=dev)
    t = torch.as_tensor(np.asarray(traffic, np.float64), device=dev)[None]
    us, ns, c1, c2 = (torch.as_tensor(a, device=dev)
                      for a in (st.us, st.ns, st.pair_c1, st.pair_c2))
    v = _factored_v(dist, t, us, ns, _StageClock(None, dev))
    flat = _joint_vals(dist, v, ns, c1, c2)[0].cpu().numpy()
    j = np.zeros((st.c, st.c), np.float64)
    j[st.pair_c1, st.pair_c2] = flat
    return j
