"""In-sim stall watchdog: deadlock and livelock detection, escape recovery.

The static certifier proves a table deadlock-free, but the simulator
also takes hand-built tables.  With ``SimConfig.watchdog`` on, the
lane-batched state carries three int32 arrays:

* ``wd_stall`` (L, NIN) — each input's stall age: +1 every cycle its
  head flit does not move, 0 when it moves.  A head stalled for
  ``wd_stall_cycles`` escapes: its next hop follows the escape table
  (``Tables.esc_port``, first-dimension-order routing, acyclic) on the
  highest VC, through the usual eligibility, credits and allocation.
* ``wd_throttle`` (L, N) — a moving flit whose hop count passes
  ``wd_hop_limit`` is livelocked, and its source generates nothing for
  ``wd_throttle_cycles`` cycles.  Only the generation mask changes; the
  random draws are made as before.
* ``wd_trips`` (L, 2) — deadlock and livelock trips, each episode
  counted once, as it crosses its threshold.

With ``watchdog=False`` the state has none of these keys and the cycle
is unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["WD_KEYS", "watchdog_state", "WatchdogReport"]

# Watchdog state keys, in the order fresh_state creates them.
WD_KEYS = ("wd_stall", "wd_throttle", "wd_trips")


def watchdog_state(meta: dict, cfg, num_lanes: int, device) -> dict:
    """Fresh zeroed watchdog state for ``num_lanes`` lanes on ``device``
    ({} when the watchdog is off)."""
    if not getattr(cfg, "watchdog", False):
        return {}

    def z(*shape):
        return torch.zeros((num_lanes,) + shape, dtype=torch.int32,
                           device=device)

    return dict(wd_stall=z(meta["NIN"]), wd_throttle=z(meta["N"]),
                wd_trips=z(2))


@dataclasses.dataclass(frozen=True)
class WatchdogReport:
    """Host-side watchdog summary of one cell, summed over its lanes."""

    deadlock_trips: int
    livelock_trips: int
    stalled_inputs: int        # inputs at or over the stall threshold now
    max_stall: int             # the worst current stall age (cycles)
    throttled_sources: int     # sources throttled now

    @property
    def tripped(self) -> bool:
        return self.deadlock_trips > 0 or self.livelock_trips > 0

    @classmethod
    def from_state(cls, host_state: dict, cfg) -> "WatchdogReport | None":
        """From a host (numpy) state, with or without a leading lane
        axis; None when the state carries no watchdog."""
        if "wd_trips" not in host_state:
            return None
        trips = np.asarray(host_state["wd_trips"], np.int64).reshape(-1, 2)
        stall = np.asarray(host_state["wd_stall"], np.int64)
        throttle = np.asarray(host_state["wd_throttle"], np.int64)
        return cls(
            deadlock_trips=int(trips[:, 0].sum()),
            livelock_trips=int(trips[:, 1].sum()),
            stalled_inputs=int((stall >= int(cfg.wd_stall_cycles)).sum()),
            max_stall=int(stall.max()) if stall.size else 0,
            throttled_sources=int((throttle > 0).sum()))

    def trace_args(self) -> dict:
        """JSON-able summary for trace instants and metrics records."""
        return {"deadlock_trips": self.deadlock_trips,
                "livelock_trips": self.livelock_trips,
                "stalled_inputs": self.stalled_inputs,
                "max_stall": self.max_stall,
                "throttled_sources": self.throttled_sources}
