"""Persistent content-addressed cache of Q-StaR plans.

A sweep re-plans the same (topology, traffic, fault mask) triples over
and over: every re-run of a campaign, every resumed job, and every
scenario whose initial plan equals an earlier cell's.  This module makes
the plan a cacheable artifact, as the reference's ``plan_cache`` does:

* **Keyed by content.**  :func:`plan_key` hashes the topology's
  fingerprint (name, dims, wrap, coords, channels, io_weights,
  channel_bw: everything the planner reads), the traffic matrix's bytes,
  the down-channel mask and the planner's knobs (``k_orders``, ``w_th``,
  ``iter_th``, precision).  The port plans in fp64 on every device, so
  its precision is always ``"fp64"``; on the CPU the reference resolves
  to the same, and the two packages' keys are equal strings.
* **Atomic npz entries.**  One ``<key>.npz`` a plan, written to a temp
  name and renamed into place: a reader never sees a partial entry.
* **Only cold builds.**  A warm-started (``w0``) replan depends on the
  run's history, not on content, and is never stored.
* **Stats.**  :attr:`PlanCache.stats` counts hits, misses and stores;
  :mod:`repro_torch.core.plan_fast` adds one to ``device_builds`` each
  time the batched planner actually runs (where the possibility kernel
  launches), so a warm re-run can be shown to have planned nothing.

An entry holds the plan's outputs (choice, costs, unroutable and the
N-Rank arrays) and its certificate; the port tables and dimension orders
are rebuilt from the topology by :func:`plan_statics`.

The port keeps its own entries: the reference sums W in float32 where
the port sums in fp64, so an entry written by one package is not the
other's build.  The campaign service gives the port its own root.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile

import numpy as np

from .bidor import BiDORTable
from .certify import Certificate
from .nrank import NRankResult
from .qstar import QStarPlan
from .topology import Topology

__all__ = ["CacheStats", "PlanCache", "plan_key", "topology_fingerprint"]

PRECISION = "fp64"


def _hash_update_array(h, a: np.ndarray) -> None:
    a = np.ascontiguousarray(a)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())


def topology_fingerprint(topo: Topology) -> str:
    """Content hash of everything the planner reads from a topology
    (also the topology's part of a campaign job's key)."""
    h = hashlib.sha256()
    h.update(topo.name.encode())
    h.update(json.dumps([list(topo.dims),
                         [bool(w) for w in topo.wrap]]).encode())
    for a in (topo.coords, topo.channels, topo.io_weights,
              topo.channel_bw):
        _hash_update_array(h, np.asarray(a))
    return h.hexdigest()


def plan_key(topo: Topology, traffic: np.ndarray, *,
             down_channels=None, k_orders: bool = False,
             w_th: float, iter_th: int, precision: str = PRECISION) -> str:
    """Content key of one cold plan build (see the module docstring)."""
    h = hashlib.sha256()
    h.update(topology_fingerprint(topo).encode())
    _hash_update_array(h, np.asarray(traffic, np.float64))
    if down_channels is None:
        down = np.zeros(0, np.int64)
    else:
        down = np.asarray(down_channels)
        if down.dtype == bool:
            down = np.nonzero(down)[0]
        down = np.unique(down.astype(np.int64))
    _hash_update_array(h, down)
    h.update(json.dumps({"k_orders": bool(k_orders),
                         "w_th": float(w_th), "iter_th": int(iter_th),
                         "precision": str(precision)}).encode())
    return h.hexdigest()


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    stores: int = 0
    # batched planner runs (each launches the possibility kernel once a
    # traffic matrix); a warm re-run leaves it at 0
    device_builds: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PlanCache:
    """On-disk plan store; safe to share between jobs and processes."""

    def __init__(self, directory: str):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.stats = CacheStats()

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.npz")

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def get(self, key: str, topo: Topology) -> QStarPlan | None:
        """The plan stored under ``key`` (None on a miss).  ``topo`` is
        the topology the key was computed from: the port tables and
        orders are rebuilt from it."""
        from .plan_fast import plan_statics

        path = self._path(key)
        if not os.path.exists(path):
            self.stats.misses += 1
            return None
        with np.load(path, allow_pickle=False) as z:
            d = {k: z[k] for k in z.files}
        statics = plan_statics(topo, binary_only=not bool(d["k_orders"]))
        unroutable = (d["unroutable"].astype(bool)
                      if d["unroutable"].size else None)
        table = BiDORTable(
            choice=d["choice"].astype(np.int8), orders=statics.orders,
            costs=d["costs"], port_tables=statics.port_tables,
            unroutable=unroutable)
        nr = NRankResult(
            w_nr=d["w_nr"], w0=d["w0"], w_final=d["w_final"],
            iterations=int(d["iterations"]), p=d["p"], p_drn=d["p_drn"],
            w_possibility=d["w_possibility"])
        self.stats.hits += 1
        return QStarPlan(topology=topo, traffic=d["traffic"], nrank=nr,
                         table=table)

    def get_cert(self, key: str) -> Certificate | None:
        """The certificate stored with the plan; None on a miss or for an
        entry without one (the caller then certifies again).  Leaves the
        hit and miss counts alone."""
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with np.load(path, allow_pickle=False) as z:
            d = {k: z[k] for k in z.files if k.startswith("cert_")}
        return Certificate.from_arrays(d)

    def put(self, key: str, plan: QStarPlan, *, k_orders: bool = False,
            cert: Certificate | None = None) -> None:
        """Store a plan atomically (a key already present is kept).
        ``cert`` defaults to the certificate the build gate attached."""
        path = self._path(key)
        if os.path.exists(path):
            return
        if cert is None:
            cert = plan.cert
        t, nr = plan.table, plan.nrank
        payload = dict(
            choice=t.choice,
            costs=np.asarray(t.costs, np.float64),
            unroutable=(t.unroutable if t.unroutable is not None
                        else np.zeros(0, bool)),
            w_nr=np.asarray(nr.w_nr, np.float64),
            w0=np.asarray(nr.w0, np.float64),
            w_final=np.asarray(nr.w_final, np.float64),
            iterations=np.int64(nr.iterations),
            p=np.asarray(nr.p, np.float64),
            p_drn=np.asarray(nr.p_drn, np.float64),
            w_possibility=np.asarray(nr.w_possibility, np.float64),
            traffic=np.asarray(plan.traffic, np.float64),
            k_orders=np.bool_(k_orders),
        )
        if cert is not None:
            payload.update(cert.as_arrays())
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self.stats.stores += 1
