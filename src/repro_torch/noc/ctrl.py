"""Quasi-static control plane: fault injection, drift detection, and
online N-Rank re-planning.

Q-StaR's premise (paper §3.1) is *quasi-static* routing: plans are cheap
enough to recompute at a coarse timescale as topology and traffic change.
This module closes the loop around the simulator:

* an **event schedule** (:class:`LinkFail` / :class:`LinkRecover` /
  :class:`TrafficDrift`) perturbs a running simulation — link bandwidth
  changes flow through the per-channel gating of the flit step, traffic
  epochs swap the generation tables;
* an **online estimator** (:class:`TrafficEstimator`) accumulates an
  observed traffic matrix from the per-flow injection counters, and a
  **drift detector** (:class:`DriftDetector`) watches the per-channel
  forwarding profile for distribution shift;
* a **re-planner** (:func:`replan`) re-runs N-Rank warm-started from the
  previous fixed point, rebuilds BiDOR against the degraded topology,
  refines with BiDOR-G against the degraded bandwidths, certifies the
  table, and sheds unroutable pairs at the source (admission control);
* the new tables **hot-swap** into the running simulation between
  chunks (:func:`repro_torch.noc.sim.retarget_tables`) without touching
  in-flight state.

Three policies bracket the design space: ``"oracle"`` replans from ground
truth at every event, ``"stale"`` never replans, ``"online"`` replans
from its own estimates when a fault is signalled or drift is detected.

Each control epoch is one :func:`repro_torch.noc.sim.run_cycles` chunk.
The host key chain in ``state["key"]`` carries across chunks, so the
epoch grid cannot change a random draw: an empty schedule reproduces
:func:`repro_torch.noc.sim.run_sweep` bit for bit.  A run can snapshot
itself at every epoch boundary (``checkpoint=``) and resume from the
snapshot bit for bit, and it can record its control-plane events to a
trace writer (``tracer=``).  Not ported yet: the lane split across cards
(``multi_device=True``), ROADMAP queue 1, item 5, which raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.bidor import BiDORTable, bidor, greedy_refine
from ..core.certify import CertificationError, apply_repair, certify_table
from ..core.nrank import NRankResult, initial_weights, nrank_channel
from ..core.plan_fast import build_plan_fast
from ..core.topology import Topology
from ..device import resolve_device
from ..obs.log import EventLog
from ..obs.probe import Telemetry, resolved_epoch
from ..obs.trace import NULL_TRACER
from .sim import (build_tables, lane, make_states, postprocess,
                  queue_occupancy, retarget_tables, run_cycles,
                  source_queue_meta, state_from_host, state_to_host)
from .watchdog import WatchdogReport
from .simconfig import Algo, SimConfig, SimResult

__all__ = [
    "LinkFail", "LinkRecover", "TrafficDrift", "Scenario",
    "TrafficEstimator", "DriftDetector", "ReplanConfig", "Replan",
    "ControlledResult", "replan", "run_controlled",
]


# ---------------------------------------------------------------------- #
# events & scenarios
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class LinkFail:
    """Fail (bw_scale = 0) or degrade (0 < bw_scale < 1) directed channels
    at an absolute cycle.  ``links`` holds (u, n) node pairs; a full
    bidirectional link is two entries."""

    cycle: int
    links: tuple
    bw_scale: float = 0.0


@dataclasses.dataclass(frozen=True)
class LinkRecover:
    """Restore the listed channels to their original bandwidth."""

    cycle: int
    links: tuple


@dataclasses.dataclass(frozen=True)
class TrafficDrift:
    """Swap the generation traffic matrix (a new epoch) and optionally
    scale every lane's injection rate."""

    cycle: int
    traffic: np.ndarray
    rate_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named event schedule plus the control policy that faces it.

    ``policy``: "stale" (never replan), "oracle" (replan from ground truth
    at every event), or "online" (replan from observed estimates on fault
    signals and detected drift).  Non-BiDOR algorithms ignore the policy —
    events still apply (they are the environment, not the plan).
    """

    name: str
    events: tuple = ()
    policy: str = "stale"
    replan: "ReplanConfig | None" = None

    def __post_init__(self):
        cycles = [e.cycle for e in self.events]
        if cycles != sorted(cycles):
            raise ValueError("scenario events must be sorted by cycle")
        if any(c <= 0 for c in cycles):
            raise ValueError(
                "event cycles must be >= 1 (events apply at chunk "
                "boundaries after the cycle; bake cycle-0 conditions "
                "into the topology/traffic instead)")
        if self.policy not in ("stale", "oracle", "online"):
            raise ValueError(f"unknown policy {self.policy!r}")


# ---------------------------------------------------------------------- #
# online estimation & drift detection
# ---------------------------------------------------------------------- #
class TrafficEstimator:
    """Observed traffic matrix from the simulator's per-flow counters.

    The per-epoch delta of the per-(source, destination) sequence numbers
    (``next_seq``) is the observed pair-count matrix; an exponential
    moving average over epochs keeps the estimate current under drift.

    ``prior`` is the offline matrix the initial plan was built from: it
    backs :attr:`matrix` until the first packets are observed, so a
    cold-start replan plans from the best statistics available.  The
    prior never mixes into the EMA — the first observed epoch replaces
    it — and an all-zero observation window keeps the current estimate.
    """

    def __init__(self, num_nodes: int, ema: float = 0.5,
                 prior: np.ndarray | None = None):
        self.ema = float(ema)
        self._m: np.ndarray | None = None
        self._n = int(num_nodes)
        self._prior = (np.asarray(prior, np.float64).copy()
                       if prior is not None else None)

    def update(self, pair_counts: np.ndarray) -> None:
        """Fold one epoch's (N, N) pair-count delta into the estimate."""
        c = np.asarray(pair_counts, np.float64)
        if c.shape != (self._n, self._n):
            raise ValueError(f"pair_counts shape {c.shape}")
        tot = c.sum()
        if tot <= 0:
            return
        obs = c / tot
        if self._m is None:
            self._m = obs
        else:
            self._m = (1.0 - self.ema) * self._m + self.ema * obs

    @property
    def matrix(self) -> np.ndarray | None:
        """Current normalized estimate — the observed EMA once any
        packets have been seen, else the offline prior; None only when
        neither carries any demand."""
        m = self._m if self._m is not None else self._prior
        if m is None:
            return None
        m = m.copy()
        np.fill_diagonal(m, 0.0)
        s = m.sum()
        return m / s if s > 0 else None


class DriftDetector:
    """Distribution-shift detector over the per-channel forwarding profile.

    The reference profile is pinned at plan time; each epoch's observed
    profile (``chan_seen`` deltas, normalized to unit sum) is compared by
    total-variation distance.  Distance above ``threshold`` flags drift —
    the re-planner then resets the reference.
    """

    def __init__(self, threshold: float = 0.25):
        self.threshold = float(threshold)
        self._ref: np.ndarray | None = None
        self.last_distance = 0.0

    def reset(self) -> None:
        """Forget the reference (called after a replan)."""
        self._ref = None
        self.last_distance = 0.0

    def update(self, chan_counts: np.ndarray) -> bool:
        """Feed one epoch's per-channel counts; True ⇔ drift detected."""
        c = np.asarray(chan_counts, np.float64)
        tot = c.sum()
        if tot <= 0:
            return False
        prof = c / tot
        if self._ref is None:
            self._ref = prof
            return False
        self.last_distance = 0.5 * float(np.abs(prof - self._ref).sum())
        return self.last_distance > self.threshold


# ---------------------------------------------------------------------- #
# re-planning
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ReplanConfig:
    """Knobs of the online re-planner."""

    epoch: int = 500            # control period (cycles) between checks
    drift_threshold: float = 0.25
    ema: float = 0.5            # estimator smoothing
    warm: bool = True           # carry the previous N-Rank fixed point
    greedy_sweeps: int = 2      # BiDOR-G refinement against degraded bw
    sat_occupancy: float = 0.9  # source-queue fraction flagging saturation
    # hot-swap guard: reject a replan whose shed fraction (unroutable
    # pairs among the pairs with demand) exceeds this, keeping the
    # previous table instead of silently wedging most of the traffic
    max_shed: float = 0.5


@dataclasses.dataclass(frozen=True)
class Replan:
    """One re-planning action (for logs/plots/tests)."""

    cycle: int
    trigger: str                # "fault" | "drift" | "event"
    iterations: int             # N-Rank evolution iterations
    unroutable_pairs: int
    drift_distance: float = 0.0


def replan(topo: Topology, traffic: np.ndarray, channel_bw: np.ndarray,
           prev: NRankResult | None = None, *,
           warm: bool = True, greedy_sweeps: int = 2,
           use_fast: bool = True, tracer=None, device=None,
           ) -> tuple[BiDORTable, NRankResult]:
    """One quasi-static re-planning step against a degraded fabric.

    Args:
      topo: the intact topology (full channel indexing).
      traffic: the (estimated or true) traffic matrix to plan for.
      channel_bw: current per-channel bandwidth; 0 marks hard-failed
        channels.
      prev: previous :class:`~repro_torch.core.nrank.NRankResult` for the
        warm-start carry (its residual fixed point seeds the new
        evolution on top of the fresh eq. (1) weights).
      use_fast: the device planner
        (:func:`repro_torch.core.plan_fast.build_plan_fast`, hard-failed
        channels masked) instead of the stage-by-stage host oracle
        (:func:`repro_torch.core.nrank.nrank_channel` on the degraded
        graph, then BiDOR).  Both give the same choice tables.
      tracer: optional trace writer; the plan build and the
        certificates are recorded as spans.
      device: where the planner runs (default: the card).

    Returns (table, nrank_result).  ``table.unroutable`` flags pairs no
    dimension order can serve; shed their generation upstream.
    """
    bw = np.asarray(channel_bw, np.float64)
    down = np.nonzero(bw <= 0)[0]
    plan_topo = dataclasses.replace(topo, channel_bw=bw)
    w0 = None
    if warm and prev is not None:
        w0 = initial_weights(traffic) + np.asarray(prev.w_final, np.float64)
    if use_fast:
        plan = build_plan_fast(plan_topo, traffic, w0=w0,
                               down_channels=down if down.size else None,
                               device=device, tracer=tracer)
        table, nr = plan.table, plan.nrank
    else:
        # N-Rank sees the degraded connectivity (hard-failed channels
        # leave the possibility sets); BiDOR masks them from the choice.
        nr_topo = (plan_topo.degrade(down, drop=True) if down.size
                   else plan_topo)
        nr = nrank_channel(nr_topo, traffic, w0=w0, device=device)
        table = bidor(plan_topo, nr.w_nr,
                      down_channels=down if down.size else None)
    if greedy_sweeps > 0:
        table = greedy_refine(plan_topo, traffic, table,
                              sweeps=greedy_sweeps)
    # deadlock gate on the hot-swap artifact: greedy refinement (and the
    # host-oracle path) re-shape the choice table after the planner's own
    # gate, so certify what actually ships
    cert = certify_table(plan_topo, table, traffic=traffic, w_nr=nr.w_nr,
                         tracer=tracer, label="replan")
    if not cert.ok:
        raise CertificationError(
            f"replan for {topo.name} failed deadlock certification "
            f"({cert.cyclic_nodes} cyclic CDG nodes survive repair)")
    if cert.verdict == "repaired":
        table = apply_repair(table, cert)
    return table, nr


# ---------------------------------------------------------------------- #
# the controlled run
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class ControlledResult:
    """Output of one controlled (event-driven) run."""

    scenario: str
    policy: str
    points: list                 # [(rate, seed), ...] lane order
    results: list                # [SimResult, ...] per lane
    replans: list                # [Replan, ...]
    # time-resolved load: per lane, the peak over control epochs of the
    # max bandwidth-normalized link load (the completion-time bottleneck
    # metric; a saturated degraded link pins it at ≈ 1)
    link_peak: np.ndarray
    epoch_bounds: list           # [(t0, t1), ...] control epochs
    # host milliseconds of each replan, in order (planner + refinement +
    # certificate + table swap)
    replan_ms: list = dataclasses.field(default_factory=list)
    # in-sim probe rings (cfg.telemetry on), normalised against the
    # bandwidth in effect in each telemetry slot (faults followed)
    telemetry: Telemetry | None = None
    # stall-watchdog summary over all lanes (cfg.watchdog on)
    watchdog: WatchdogReport | None = None

    def result_with_peak(self, i: int) -> SimResult:
        """Lane i's SimResult with the time-resolved link peak in
        ``link_load_max`` (the static field would normalize by the intact
        bandwidths)."""
        return dataclasses.replace(self.results[i],
                                   link_load_max=float(self.link_peak[i]))


def _apply_events(events, bw, topo, base_bw):
    """Fold one boundary's events into the environment; returns the new
    (bw, traffic, rate_scale, kinds) with traffic/rate None if unchanged."""
    traffic = None
    rate_scale = None
    kinds = set()
    for ev in events:
        if isinstance(ev, LinkFail):
            ids = [topo.channel_index(*l) for l in ev.links]
            bw = bw.copy()
            bw[ids] = base_bw[ids] * ev.bw_scale
            kinds.add("fault")
        elif isinstance(ev, LinkRecover):
            ids = [topo.channel_index(*l) for l in ev.links]
            bw = bw.copy()
            bw[ids] = base_bw[ids]
            kinds.add("fault")
        elif isinstance(ev, TrafficDrift):
            traffic = np.asarray(ev.traffic, np.float64)
            rate_scale = float(ev.rate_scale)
            kinds.add("drift")
        else:
            raise TypeError(f"unknown event {ev!r}")
    return bw, traffic, rate_scale, kinds


def _bw_slots(bw_hist, epoch: int, slots: int, total: int) -> np.ndarray:
    """(slots, C) channel bandwidth for the telemetry's load
    normalisation.  ``bw_hist`` is [(cycle, bw), ...], the bandwidth in
    effect from each cycle on.  A slot takes the bandwidth at the end of
    its last accumulation window (when the ring wraps, the later window
    wins, as its counts dominate the slot)."""
    out = np.zeros((slots, bw_hist[0][1].shape[0]))
    for j in range(slots):
        last = min(j * epoch + epoch, total) - 1   # the slot's last cycle
        t = j * epoch + epoch * slots
        while t < total:                            # the ring wraps
            last = min(t + epoch, total) - 1
            t += epoch * slots
        bw = bw_hist[0][1]
        for cyc, b in bw_hist:
            if cyc <= last:
                bw = b
        out[j] = bw
    return out


def _counters(state: dict) -> tuple[np.ndarray, ...]:
    """The counters the controller reads each epoch, as int64 numpy."""
    return tuple(state[k].cpu().numpy().astype(np.int64)
                 for k in ("next_seq", "chan_seen", "chan_fwd", "meas_cnt"))


_NR_FIELDS = ("w_nr", "w0", "w_final", "p", "p_drn", "w_possibility")


def _ctrl_snapshot(state, *, bound_i, sat, link_peak, bw, cur_traffic,
                   cur_gen, cur_unroutable, fault_pending, estimator,
                   detector, replans, replan_ms, table, nr_prev, bw_hist):
    """Serialisable (arrays, meta) state of a controlled run at the top
    of boundary iteration ``bound_i``: everything up to
    ``bounds[bound_i - 1]`` (events, replans, counters) applied, the next
    epoch not yet run.  The layout is the reference's (the simulator
    state as ``s_<key>``, ``rbits`` as uint32, the PRNG keys as a (L, 2)
    uint32 array), plus the replans' host milliseconds in the meta;
    :func:`run_controlled` restores it bit for bit."""
    arrays = {f"s_{k}": v for k, v in state_to_host(state).items()}
    arrays.update(sat=sat.copy(), link_peak=link_peak.copy(), bw=bw.copy(),
                  cur_traffic=np.asarray(cur_traffic, np.float64),
                  cur_gen=np.asarray(cur_gen, np.float64))
    if cur_unroutable is not None:
        arrays["cur_unroutable"] = np.asarray(cur_unroutable, bool)
    if estimator._m is not None:
        arrays["est_m"] = estimator._m
    if detector._ref is not None:
        arrays["det_ref"] = detector._ref
    if table is not None:
        arrays["tab_choice"] = np.asarray(table.choice, np.int8)
    if bw_hist:
        arrays["bwh"] = np.stack([b for _, b in bw_hist])
    if nr_prev is not None:
        for f in _NR_FIELDS:
            arrays[f"nr_{f}"] = np.asarray(getattr(nr_prev, f), np.float64)
    meta = dict(bound_i=int(bound_i),
                bwh_cycles=[int(c) for c, _ in (bw_hist or [])],
                fault_pending=bool(fault_pending),
                last_distance=float(detector.last_distance),
                has_nr=nr_prev is not None,
                nr_iterations=(int(nr_prev.iterations)
                               if nr_prev is not None else 0),
                replans=[dataclasses.asdict(r) for r in replans],
                replan_ms=[float(x) for x in replan_ms])
    return arrays, meta


def run_controlled(topo: Topology, traffic: np.ndarray, cfg: SimConfig,
                   scenario: Scenario | None = None, *,
                   rates: list[float] | None = None,
                   seeds: list[int] | None = None,
                   bidor_table: BiDORTable | None = None,
                   nrank0: NRankResult | None = None,
                   sat_occupancy: float | None = None,
                   multi_device: bool | None = None,
                   checkpoint=None,
                   verbose: bool = False,
                   tracer=None, device=None) -> ControlledResult:
    """Run a simulation under an event schedule with a control policy.

    Lanes are the (rate, seed) grid, batched exactly as
    :func:`repro_torch.noc.sim.run_sweep` (same per-point PRNG streams):
    with an empty scenario the chunked, hot-swapping loop equals the
    single-call sweep bit for bit.

    The run advances in control epochs (``scenario.replan.epoch`` cycles,
    event cycles added as extra boundaries).  At each boundary the
    environment applies due events, the controller reads the device
    counters, and — policy permitting — re-plans and hot-swaps tables.
    ``device`` defaults to the card; ``"cpu"`` runs the plain path.

    ``checkpoint``: an optional epoch-boundary checkpointer (duck-typed:
    ``save(arrays, meta)`` keeps a flat dict of numpy arrays and a
    JSON-able dict; ``load()`` gives back the latest pair or None).  At
    the top of every boundary after the first the whole run state is
    saved (the simulator state, the environment, the estimator and the
    detector, the warm-start fixed point, the replans); on entry a
    stored snapshot is restored and the epochs it covers are skipped.
    The boundary grid is deterministic, so a resumed run ends bit for
    bit as the uninterrupted one.  A snapshot the reference took comes
    across through :func:`repro_torch.convert.ctrl_snapshot`.

    ``tracer``: an optional trace writer; the loop records each epoch as
    a span, the drift distance as a counter, detections, environment
    events and hot swaps as instants and each replan as a span.  An
    epoch span waits for the card (``torch.cuda.synchronize``) before it
    closes, so it times the device's work; without a tracer nothing
    waits.  Tracing never changes a result.
    """
    if multi_device:
        raise NotImplementedError(
            "the lane split across cards is not ported yet (ROADMAP "
            "queue 1, item 5)")
    tracer = tracer if tracer is not None else NULL_TRACER
    dev = resolve_device(device)
    log = EventLog(verbose=verbose)
    scenario = scenario or Scenario("static")
    rc = scenario.replan or ReplanConfig()
    policy = scenario.policy
    rates = [float(r) for r in (rates or [cfg.injection_rate])]
    seeds = [int(s) for s in (seeds or [cfg.seed])]
    points = [(r, s) for r in rates for s in seeds]

    table = bidor_table
    nr_prev = nrank0   # seed plan's fixed point: first replan warm-starts
    if cfg.algo == Algo.BIDOR and table is None:
        plan0 = build_plan_fast(topo, traffic, device=dev)
        table, nr_prev = plan0.table, plan0.nrank
    tables, meta = build_tables(
        topo, traffic, table if cfg.algo == Algo.BIDOR else None,
        cfg.num_vcs, dev, escape=cfg.watchdog)
    state = make_states(meta, cfg, points, dev)
    q_meta = source_queue_meta(tables, cfg)   # refresh on gen retargets

    # environment state
    base_bw = np.asarray(topo.channel_bw, np.float64)
    bw = base_bw.copy()
    bw_hist = [(0, bw.copy())]   # (cycle, bw): the telemetry's normaliser
    cur_traffic = np.asarray(traffic, np.float64)
    cur_gen = cur_traffic    # what the simulator generates from now
    fault_pending = False
    cur_unroutable = None    # active admission-control mask (shed pairs)

    # the offline matrix rides along as the estimator's cold-start prior
    # (never the ground-truth current matrix — that would be the oracle)
    estimator = TrafficEstimator(topo.num_nodes, ema=rc.ema, prior=traffic)
    detector = DriftDetector(threshold=rc.drift_threshold)
    replans: list[Replan] = []
    replan_ms: list[float] = []

    # boundary grid: control epochs ∪ event cycles ∪ end of run
    total = int(cfg.cycles)
    bounds = set(range(rc.epoch, total, rc.epoch)) | {total}
    bounds |= {int(e.cycle) for e in scenario.events if 0 < e.cycle < total}
    bounds = sorted(bounds)

    nlanes = len(points)
    prev_seq = np.zeros((nlanes,) + (meta["N"],) * 2, np.int64)
    prev_seen = np.zeros((nlanes, meta["C"]), np.int64)
    prev_fwd = np.zeros((nlanes, meta["C"]), np.int64)
    prev_meas = np.zeros(nlanes, np.int64)
    link_peak = np.zeros(nlanes)
    epoch_bounds = []
    sat_th = rc.sat_occupancy if sat_occupancy is None else sat_occupancy
    sat = np.zeros(nlanes, bool)

    # ---- resume from an epoch-boundary snapshot, if one exists ---- #
    resume_i = 0
    snap = checkpoint.load() if checkpoint is not None else None
    if snap is not None:
        arrays, cmeta = snap
        resume_i = int(cmeta["bound_i"])
        state = state_from_host({k[2:]: v for k, v in arrays.items()
                                 if k.startswith("s_")}, dev)
        sat = np.asarray(arrays["sat"], bool).copy()
        link_peak = np.asarray(arrays["link_peak"], np.float64).copy()
        bw = np.asarray(arrays["bw"], np.float64)
        if "bwh" in arrays and cmeta.get("bwh_cycles"):
            bwh = np.asarray(arrays["bwh"], np.float64)
            bw_hist = [(int(c), bwh[k].copy())
                       for k, c in enumerate(cmeta["bwh_cycles"])]
        else:   # a snapshot without the history: current bw stands in
            bw_hist = [(0, bw.copy())]
        cur_traffic = np.asarray(arrays["cur_traffic"], np.float64)
        cur_gen = np.asarray(arrays["cur_gen"], np.float64)
        cur_unroutable = (np.asarray(arrays["cur_unroutable"], bool)
                          if "cur_unroutable" in arrays else None)
        fault_pending = bool(cmeta["fault_pending"])
        estimator._m = (np.asarray(arrays["est_m"], np.float64)
                        if "est_m" in arrays else None)
        detector._ref = (np.asarray(arrays["det_ref"], np.float64)
                         if "det_ref" in arrays else None)
        detector.last_distance = float(cmeta["last_distance"])
        replans = [Replan(**r) for r in cmeta["replans"]]
        replan_ms = [float(x) for x in cmeta["replan_ms"]]
        if cmeta["has_nr"]:
            nr_prev = NRankResult(
                iterations=int(cmeta["nr_iterations"]),
                **{f: np.asarray(arrays[f"nr_{f}"], np.float64)
                   for f in _NR_FIELDS})
        # re-point the tables at the snapshot's environment (retargeting
        # is deterministic in its inputs, so fields the run never
        # changed rebuild to the same values)
        choice = arrays.get("tab_choice")
        if choice is not None and table is not None:
            # keep the live table in step, so that a later snapshot
            # records the replanned choice, not the seed plan's
            table = dataclasses.replace(table,
                                        choice=np.asarray(choice, np.int8))
        tables = retarget_tables(
            tables, topo, traffic=cur_gen,
            choice=(choice if cfg.algo == Algo.BIDOR
                    and choice is not None else None),
            channel_bw=bw)
        q_meta = source_queue_meta(tables, cfg)
        prev_seq = np.asarray(arrays["s_next_seq"], np.int64)
        prev_seen = np.asarray(arrays["s_chan_seen"], np.int64)
        prev_fwd = np.asarray(arrays["s_chan_fwd"], np.int64)
        prev_meas = np.asarray(arrays["s_meas_cnt"], np.int64)
        t_prev = 0
        for j in range(resume_i):
            epoch_bounds.append((t_prev, bounds[j]))
            t_prev = bounds[j]

    t0 = bounds[resume_i - 1] if resume_i else 0
    for bound_i in range(resume_i, len(bounds)):
        t1 = bounds[bound_i]
        if checkpoint is not None and bound_i > resume_i:
            checkpoint.save(*_ctrl_snapshot(
                state, bound_i=bound_i, sat=sat, link_peak=link_peak,
                bw=bw, cur_traffic=cur_traffic, cur_gen=cur_gen,
                cur_unroutable=cur_unroutable,
                fault_pending=fault_pending, estimator=estimator,
                detector=detector, replans=replans, replan_ms=replan_ms,
                table=table, nr_prev=nr_prev, bw_hist=bw_hist))
        # tables swap only here, between chunks: a chunk's draws and its
        # cycles all see the tables it was handed
        te0 = tracer.now_us() if tracer.enabled else 0.0
        run_cycles(tables, meta, cfg, state, t1 - t0)
        if tracer.enabled:
            if dev.type == "cuda":
                # wait, so the span times the card's work, not the launch
                torch.cuda.synchronize(dev)
            tracer.complete(
                "epoch", te0, tracer.now_us() - te0, cat="sim",
                args={"t0": t0, "t1": t1, "scenario": scenario.name,
                      "policy": policy})
        epoch_bounds.append((t0, t1))
        t0 = t1

        # ---- read counters (one small host transfer) ---- #
        seq, seen, fwd, meas = _counters(state)
        d_seq, d_seen = seq - prev_seq, seen - prev_seen
        d_fwd, d_meas = fwd - prev_fwd, meas - prev_meas
        prev_seq, prev_seen, prev_fwd, prev_meas = seq, seen, fwd, meas

        # time-resolved max normalized link load (this epoch's bw)
        live = bw > 0
        for i in range(nlanes):
            if d_meas[i] > 0 and live.any():
                loads = d_fwd[i, live] / float(d_meas[i]) / bw[live]
                link_peak[i] = max(link_peak[i], float(loads.max()))

        if t1 > cfg.warmup:
            # saturation accumulates from post-warmup reads only — a
            # transient warmup spike must not permanently latch a lane
            sat |= queue_occupancy(tables, cfg, state["q_size"],
                                   q_meta) >= sat_th

        estimator.update(d_seq.sum(axis=0))
        drifted = detector.update(d_seen.sum(axis=0))
        if tracer.enabled:
            tracer.counter("drift_tv", {"tv": detector.last_distance},
                           cat="ctrl")
            if drifted:
                tracer.instant(
                    "drift_detected", cat="ctrl",
                    args={"cycle": t1, "tv": detector.last_distance})

        if t1 >= total:
            break

        # ---- apply due events (the environment) ---- #
        due = [e for e in scenario.events if e.cycle == t1]
        if due:
            bw, new_traffic, rate_scale, event_kinds = _apply_events(
                due, bw, topo, base_bw)
            if tracer.enabled:
                for ev in due:
                    a = {"cycle": t1}
                    if isinstance(ev, LinkFail):
                        a["bw_scale"] = ev.bw_scale
                    tracer.instant(type(ev).__name__, cat="env", args=a)
            if "fault" in event_kinds:
                bw_hist.append((t1, bw.copy()))
            gen_traffic = new_traffic
            if new_traffic is not None and cur_unroutable is not None:
                # an active shed outlives a traffic epoch: the dead link
                # is still dead, so the new matrix generates under the
                # same admission-control mask until the next replan
                gen_traffic = np.where(cur_unroutable, 0.0, new_traffic)
            tables = retarget_tables(
                tables, topo, traffic=gen_traffic,
                channel_bw=bw if "fault" in event_kinds else None)
            if gen_traffic is not None:
                cur_gen = gen_traffic
                q_meta = source_queue_meta(tables, cfg)
            if new_traffic is not None:
                cur_traffic = new_traffic
            if rate_scale is not None:
                # absolute vs base: rate_scale=1.0 restores the original
                # injection rates after a previously scaled epoch
                state["rate"] = torch.tensor(
                    [r * rate_scale for r, _ in points],
                    dtype=torch.float32, device=dev)
            fault_pending |= "fault" in event_kinds

        # ---- control decision ---- #
        if cfg.algo != Algo.BIDOR or policy == "stale":
            continue
        if policy == "oracle":
            do, trigger, m = bool(due), "event", cur_traffic
        else:  # online
            # faults are signalled out of band (hardware link state);
            # traffic drift must be *detected*
            trigger = "fault" if fault_pending else "drift"
            do = fault_pending or drifted
            # backs off to the offline prior until the first packets
            # arrive; None only when there is no demand to plan for
            m = estimator.matrix
            if m is None:
                do = False
        if not do:
            continue
        drift_dist = detector.last_distance
        tr0 = time.perf_counter()
        ts0 = tracer.now_us() if tracer.enabled else 0.0
        table, nr_prev = replan(
            topo, m, bw, nr_prev,
            warm=rc.warm, greedy_sweeps=rc.greedy_sweeps, tracer=tracer,
            device=dev)
        # hot-swap guard: a replan that sheds most of the demanded pairs
        # would silently wedge the run behind a near-empty table — keep
        # the previous (still-certified) table and record the rejection
        if table.unroutable is not None:
            demanded = np.asarray(cur_traffic) > 0
            n_dem = int(demanded.sum())
            shed_frac = (int((table.unroutable & demanded).sum()) / n_dem
                         if n_dem else 0.0)
            if shed_frac > rc.max_shed:
                if tracer.enabled:
                    tracer.instant(
                        "hot_swap_rejected", cat="ctrl",
                        args={"cycle": t1, "trigger": trigger,
                              "shed_frac": round(shed_frac, 4),
                              "max_shed": rc.max_shed})
                log.event("replan_rejected",
                          f"ctrl[{scenario.name}/{policy}] hot-swap "
                          f"rejected @ {t1}: shed {shed_frac:.0%} > "
                          f"max {rc.max_shed:.0%}", cycle=t1,
                          trigger=trigger)
                detector.reset()
                fault_pending = False
                continue
        # admission control: shed unroutable pairs from generation; when
        # the new plan can serve everything (e.g. after LinkRecover),
        # restore the full current matrix
        gen = cur_traffic
        cur_unroutable = None
        if table.unroutable is not None and table.unroutable.any():
            cur_unroutable = table.unroutable
            gen = np.where(cur_unroutable, 0.0, cur_traffic)
        tables = retarget_tables(tables, topo, choice=table.choice,
                                 traffic=gen)
        cur_gen = gen
        q_meta = source_queue_meta(tables, cfg)
        detector.reset()
        fault_pending = False
        replan_ms.append((time.perf_counter() - tr0) * 1e3)
        replans.append(Replan(
            cycle=t1, trigger=trigger, iterations=nr_prev.iterations,
            unroutable_pairs=int(table.unroutable.sum())
            if table.unroutable is not None else 0,
            drift_distance=drift_dist))
        if tracer.enabled:
            tracer.complete(
                "replan", ts0, tracer.now_us() - ts0, cat="ctrl",
                args={"cycle": t1, "trigger": trigger,
                      "warm": rc.warm and nr_prev is not None,
                      "iterations": int(nr_prev.iterations),
                      "unroutable": replans[-1].unroutable_pairs,
                      "drift_tv": drift_dist})
            tracer.instant("hot_swap", cat="ctrl", args={"cycle": t1})
        log.event("replan",
                  f"ctrl[{scenario.name}/{policy}] replan @ {t1} "
                  f"({trigger}), {nr_prev.iterations} iters",
                  cycle=t1, trigger=trigger)

    host = state_to_host(state)
    results = [postprocess(lane(host, i), cfg, topo, rate=rate, seed=seed,
                           saturated=bool(sat[i]))
               for i, (rate, seed) in enumerate(points)]
    telemetry = Telemetry.from_state(host, cfg)
    if telemetry is not None:
        telemetry = telemetry.with_bw(_bw_slots(
            bw_hist, resolved_epoch(cfg), cfg.tel_slots, total))
    watchdog = WatchdogReport.from_state(host, cfg)
    if watchdog is not None and watchdog.tripped and tracer.enabled:
        tracer.instant("watchdog_tripped", cat="ctrl",
                       args=watchdog.trace_args())
    return ControlledResult(
        scenario=scenario.name, policy=policy, points=points,
        results=results, replans=replans, link_peak=link_peak,
        epoch_bounds=epoch_bounds, replan_ms=replan_ms,
        telemetry=telemetry, watchdog=watchdog)
