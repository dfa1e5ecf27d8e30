"""Realistic-workload synthesis for the paper's §4.3 evaluation.

The paper traces port-pair traffic of a leaf switch inside an ns-3 Clos
network running the HPCC workload [12], and observes (Fig. 2a) a *sparse,
highly skewed, bursty* port-pair matrix.  ns-3 is out of scope here; this
module synthesizes traffic with matched statistics:

* a small set of hot flows with Zipf-distributed intensity (rack-to-rack
  elephants) over the edge-I/O nodes,
* a light uniform background (mice),
* epoch-level burstiness: each epoch re-samples which hot flows are active
  (on/off flows), while the *aggregate* matrix — what Q-StaR's offline
  statistics would see — stays fixed.

``clos_leaf_trace`` returns (segments, aggregate_matrix) for
:func:`repro_torch.noc.sim.run_trace`.
"""

from __future__ import annotations

import numpy as np

from ..core.topology import Topology

__all__ = ["clos_leaf_trace"]


def clos_leaf_trace(
    topo: Topology,
    num_epochs: int = 8,
    num_hot_flows: int = 12,
    active_frac: float = 0.5,
    zipf_a: float = 1.2,
    background: float = 0.15,
    base_rate: float = 0.25,
    seed: int = 7,
) -> tuple[list[tuple[np.ndarray, float]], np.ndarray]:
    """Synthesize an epoch trace of a Clos leaf switch.

    Args:
      topo: NoC topology (I/O-weighted nodes are the switch ports).
      num_epochs: number of piecewise-constant traffic epochs.
      num_hot_flows: total distinct elephant flows across the trace.
      active_frac: fraction of hot flows active in any given epoch.
      zipf_a: Zipf exponent of flow intensities.
      background: fraction of traffic that is uniform background.
      base_rate: mean injection rate (flits/cycle/port); epochs are scaled
        by their relative activity, giving burstiness.
      seed: RNG seed.

    Returns:
      (segments, aggregate): segments = [(traffic_matrix, rate), ...];
      aggregate is the statistics matrix Q-StaR builds its plan from.
    """
    rng = np.random.default_rng(seed)
    n = topo.num_nodes
    io = np.nonzero(topo.io_weights > 0)[0]
    # sample hot flows (distinct ordered port pairs)
    flows = set()
    while len(flows) < num_hot_flows:
        s, d = rng.choice(io, 2, replace=False)
        flows.add((int(s), int(d)))
    flows = sorted(flows)
    intensity = (1.0 / np.arange(1, num_hot_flows + 1) ** zipf_a)
    intensity /= intensity.sum()
    rng.shuffle(intensity)

    bg = np.outer(topo.io_weights, topo.io_weights).astype(np.float64)
    np.fill_diagonal(bg, 0)
    bg /= bg.sum()

    segments: list[tuple[np.ndarray, float]] = []
    agg = np.zeros((n, n), np.float64)
    for _ in range(num_epochs):
        active = rng.random(num_hot_flows) < active_frac
        if not active.any():
            active[rng.integers(num_hot_flows)] = True
        hot = np.zeros((n, n), np.float64)
        for (s, d), w, a in zip(flows, intensity, active):
            if a:
                hot[s, d] += w
        hot /= hot.sum()
        t = background * bg + (1 - background) * hot
        t /= t.sum()
        # epoch rate scales with how much of the flow mass is active
        rate = base_rate * (0.5 + intensity[active].sum())
        segments.append((t, float(rate)))
        agg += t * rate
    agg /= agg.sum()
    return segments, agg
