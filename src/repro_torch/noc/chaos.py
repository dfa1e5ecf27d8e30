"""Chaos scenario generator: seeded compound fault and drift schedules.

Single events (one link failure, one drift) exercise the control plane
one at a time.  Real networks fail in bursts: links flap, whole regions
die while a replan is still settling, traffic shifts land back to back
with faults.  This module composes the control plane's events
(:class:`repro_torch.noc.ctrl.LinkFail`, ``LinkRecover``,
``TrafficDrift``) into deterministic storms from one seed, so a chaos
campaign replays exactly like any other scenario.  The draws are seeded
numpy, so a schedule equals the reference's event for event.

Three compound patterns, mixed by :func:`chaos_schedule`:

* **link-flap storm**: a cluster of bidirectional links fails and
  recovers on a short period, several times in a row;
* **region failure**: every link incident to a contiguous node region
  dies at once, one control epoch after a drift slot, so a replan is
  still settling when the region goes; the hot-swap guard
  (:class:`repro_torch.noc.ctrl.ReplanConfig` ``max_shed``) keeps a
  mostly-shed emergency table from being installed;
* **traffic drift**: the generation matrix swaps to a seeded hotspot
  pattern, optionally rate-scaled.

Everything returns plain :class:`repro_torch.noc.ctrl.Scenario` objects,
so chaos schedules run through the unmodified control loop, the campaign
service and the trace and report planes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.topology import Topology
from .ctrl import LinkFail, LinkRecover, Scenario, TrafficDrift

__all__ = ["ChaosConfig", "hotspot_traffic", "region_links",
           "chaos_schedule", "chaos_scenarios"]


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Shape of one seeded chaos schedule (cycles are absolute)."""

    seed: int = 0
    start: int = 1_000          # first event lands here
    horizon: int = 10_000       # last event strictly before this cycle
    flap_storms: int = 2        # link-flap storm count
    flap_links: int = 3         # bidirectional links per storm
    flap_bursts: int = 3        # fail->recover rounds per storm
    flap_period: int = 300      # cycles between a fail and its recover
    region_failures: int = 1    # region-loss events
    region_radius: int = 1      # Chebyshev radius of the lost region
    drift_events: int = 2       # traffic-swap events
    drift_hotspots: int = 4     # hot destinations per drifted matrix
    drift_rate_scale: float = 1.0
    bw_scale: float = 0.0       # 0 = hard failure, (0, 1) = degrade


def hotspot_traffic(num_nodes: int, rng: np.random.Generator,
                    hotspots: int = 4, weight: float = 8.0) -> np.ndarray:
    """Uniform background + ``hotspots`` hot destination columns."""
    m = np.ones((num_nodes, num_nodes), np.float64)
    hot = rng.choice(num_nodes, size=min(hotspots, num_nodes),
                     replace=False)
    m[:, hot] *= weight
    np.fill_diagonal(m, 0.0)
    return m / m.sum()


def region_links(topo: Topology, center: int,
                 radius: int = 1) -> tuple[tuple[int, int], ...]:
    """All directed channels incident to the node region within
    Chebyshev ``radius`` of ``center`` (both directions — the region
    goes fully dark, like a power-domain loss)."""
    coords = np.asarray(topo.coords)
    cheb = np.abs(coords - coords[center]).max(axis=1)
    region = set(np.flatnonzero(cheb <= radius).tolist())
    return tuple((u, v) for (u, v) in topo.chan_id
                 if u in region or v in region)


def _undirected_links(topo: Topology) -> list[tuple[int, int]]:
    """Deduplicated undirected link list (u < v), deterministic order."""
    seen = set()
    out = []
    for (u, v) in topo.chan_id:
        key = (min(u, v), max(u, v))
        if key not in seen:
            seen.add(key)
            out.append(key)
    return out


def chaos_schedule(topo: Topology, cc: ChaosConfig = ChaosConfig(),
                   *, policy: str = "online",
                   replan=None) -> Scenario:
    """Compose one seeded compound schedule into a :class:`Scenario`.

    Event cycles are spread deterministically over
    ``[cc.start, cc.horizon)``; ties are resolved by stable sort, so the
    schedule satisfies the Scenario ordering contract for any config."""
    rng = np.random.default_rng(cc.seed)
    n = topo.num_nodes
    links = _undirected_links(topo)
    events: list = []

    # window per compound pattern, so storms don't all pile on cc.start
    total = cc.flap_storms + cc.region_failures + cc.drift_events
    span = max(cc.horizon - cc.start, 1)
    slots = iter(np.linspace(cc.start, cc.start + span,
                             num=max(total, 1), endpoint=False))

    for _ in range(cc.flap_storms):
        t0 = int(next(slots))
        pick = rng.choice(len(links), size=min(cc.flap_links, len(links)),
                          replace=False)
        flap = tuple(pair for i in pick
                     for pair in ((links[i][0], links[i][1]),
                                  (links[i][1], links[i][0])))
        for b in range(cc.flap_bursts):
            t_fail = t0 + 2 * b * cc.flap_period
            t_rec = t_fail + cc.flap_period
            if t_rec >= cc.horizon:
                break
            events.append(LinkFail(cycle=max(t_fail, 1), links=flap,
                                   bw_scale=cc.bw_scale))
            events.append(LinkRecover(cycle=t_rec, links=flap))

    for _ in range(cc.drift_events):
        t0 = int(next(slots))
        events.append(TrafficDrift(
            cycle=max(t0, 1),
            traffic=hotspot_traffic(n, rng, cc.drift_hotspots),
            rate_scale=cc.drift_rate_scale))

    epoch = getattr(replan, "epoch", 500) if replan is not None else 500
    for _ in range(cc.region_failures):
        t0 = int(next(slots))
        center = int(rng.integers(n))
        # one control epoch after the slot start: when the slot carries
        # a drift (above), the replan it triggers is still settling
        t_fail = min(max(t0 + epoch, 1), cc.horizon - 1)
        events.append(LinkFail(cycle=t_fail,
                               links=region_links(topo, center,
                                                  cc.region_radius),
                               bw_scale=cc.bw_scale))

    events.sort(key=lambda e: e.cycle)
    return Scenario(name=f"chaos-s{cc.seed}", events=tuple(events),
                    policy=policy, replan=replan)


def chaos_scenarios(topo: Topology, seeds, *, policy: str = "online",
                    replan=None,
                    base: ChaosConfig = ChaosConfig()) -> list[Scenario]:
    """One :func:`chaos_schedule` per seed (same shape, different draws)."""
    return [chaos_schedule(topo, dataclasses.replace(base, seed=int(s)),
                           policy=policy, replan=replan)
            for s in seeds]
