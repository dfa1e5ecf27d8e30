"""Batched simulation-campaign engine.

A :class:`CampaignSpec` names a grid of (topology × traffic pattern ×
algorithm × scenario × rate × seed).  Every (rate, seed) point of a
cell — one (topology, pattern, algorithm, scenario) — is one lane of a
single lane-batched state.  A static cell advances in ``chunk``-cycle
slices with the reference's warmup → measure → drain phasing and its
saturation early exit: after each post-warmup slice the host reads
source-queue occupancy, and once every lane is saturated the remaining
cycles are skipped (per-lane ``meas_cnt`` keeps the statistics
normalised).  A scenario cell runs the control plane's event-driven loop
(:func:`repro_torch.noc.ctrl.run_controlled`), and its
``link_load_max`` is the time-resolved peak.

BiDOR plans come from one batched planner call a topology
(:func:`repro_torch.core.plan_fast.build_plans_batched`, with the
topology's dead channels masked), each gated by the deadlock certifier,
unless ``run_campaign(bidor_tables=...)`` supplies a pattern's choice
table; with a plan cache (:class:`repro_torch.core.plan_cache.PlanCache`)
the cached plans are served first and only the misses are planned.
Cells run one at a time in any order (:class:`CampaignExecutor`), which
is what the campaign service (:mod:`repro_torch.noc.service`) checkpoints
and resumes.  ML workloads (:mod:`repro_torch.noc.mltraffic`) join the
pattern axis as extra items, tagged in the ``workload`` column.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Sequence

import numpy as np

from ..core import traffic as traffic_mod
from ..core.bidor import dor_table
from ..core.plan_fast import build_plans_batched
from ..core.topology import Topology
from ..device import resolve_devices
from ..obs.log import EventLog
from ..obs.trace import NULL_TRACER
from .ctrl import run_controlled
from .sim import (LaneGroups, build_tables, lane, lane_devices,
                  postprocess, queue_occupancy, source_queue_meta,
                  static_bw_slots)
from ..obs.probe import Telemetry
from .simconfig import Algo, SimConfig, SimResult, check_topology

__all__ = ["CampaignSpec", "CampaignPoint", "CampaignResult",
           "run_campaign", "CellKey", "CellOutcome", "campaign_cells",
           "CampaignExecutor", "csv_rows"]


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """Declarative grid of simulations.

    Attributes:
      topo: the network under test.
      topos: optional topology axis: when non-empty the whole grid runs
        once per listed topology (``topo`` is then ignored and may be
        None); string patterns are resolved and BiDOR plans built (with
        the topology's dead channels masked) per topology.
      algos: routing algorithms to sweep.
      patterns: traffic patterns — names from
        ``repro_torch.core.traffic.PATTERNS`` or ``(name, matrix)`` pairs.
      rates: injection rates (flits/cycle/I/O-port).
      seeds: RNG seeds; each (rate, seed) is one lane of the batch.
      base: parameters shared by every point (``algo`` is overridden per
        cell, ``injection_rate`` and ``seed`` per lane).
      chunk: host-loop granularity in cycles for the saturation early
        exit; 0 runs each cell as one chunk of ``base.cycles``.
      sat_occupancy: source-queue occupancy fraction above which a lane
        is declared saturated.
      scenarios: optional fault/drift dynamics axis —
        :class:`repro_torch.noc.ctrl.Scenario` entries; each (pattern,
        algo, scenario) cell runs through the control plane.  Empty ()
        keeps the static grid.
      workloads: ML-workload axis — :class:`repro_torch.noc.mltraffic.MLWorkload`
        entries (anything with ``.name`` and ``.matrix_for(topo)``) or
        ``(name, pair counts)`` pairs, normalised by
        ``traffic.from_pair_counts``.  They join the pattern axis as extra
        items after the patterns (the same plans, plan cache, certifier
        gate and cell enumeration), with their name in the ``workload``
        column.
      multi_device: the lane split — ``True`` splits each cell's (rate,
        seed) lanes over every device of the run (``run_campaign(device=)``:
        by default every visible card; a sequence of devices, the CPU
        named several times on the host), in contiguous blocks, each
        device holding a copy of the tables; ``False`` pins the first
        device; ``None`` (default) splits whenever more than one device
        is given and the lane count divides evenly.  Results are bit
        for bit the same either way (``tests/test_torch_lanes.py``);
        ``True`` with one device, or lanes that do not divide, raises.
    """

    topo: Topology | None
    algos: tuple[Algo, ...]
    patterns: tuple
    rates: tuple[float, ...]
    seeds: tuple[int, ...] = (0,)
    base: SimConfig = SimConfig()
    chunk: int = 0
    sat_occupancy: float = 0.9
    scenarios: tuple = ()
    topos: tuple[Topology, ...] = ()
    multi_device: bool | None = None
    workloads: tuple = ()

    def __post_init__(self):
        if not (self.algos and (self.patterns or self.workloads)
                and self.rates and self.seeds):
            raise ValueError("campaign grid must be non-empty on all axes")
        if self.topo is None and not self.topos:
            raise ValueError("provide topo or a non-empty topos axis")

    @property
    def topo_axis(self) -> tuple[Topology, ...]:
        return self.topos or (self.topo,)

    @property
    def num_points(self) -> int:
        return (len(self.algos)
                * (len(self.patterns) + len(self.workloads))
                * len(self.rates)
                * len(self.seeds) * max(len(self.scenarios), 1)
                * len(self.topo_axis))

    def pattern_items(self, topo: Topology | None = None,
                      ) -> list[tuple[str, np.ndarray]]:
        """The pattern axis, then the workload axis, on ``topo`` (default
        ``self.topo``) as (name, traffic matrix) pairs (``campaign_cells``
        indexes items in this order)."""
        topo = self.topo if topo is None else topo
        items = []
        for p in self.patterns:
            if isinstance(p, str):
                if p not in traffic_mod.PATTERNS:
                    raise KeyError(
                        f"unknown traffic pattern {p!r}; available: "
                        f"{sorted(traffic_mod.PATTERNS)}")
                items.append((p, traffic_mod.PATTERNS[p](topo)))
            else:
                name, tm = p
                items.append((str(name), np.asarray(tm, np.float64)))
        for w in self.workloads:
            if hasattr(w, "matrix_for"):
                items.append((str(w.name), w.matrix_for(topo)))
            else:
                name, counts = w
                items.append((str(name), traffic_mod.from_pair_counts(
                    topo, np.asarray(counts, np.float64))))
        return items


def check_spec(spec: CampaignSpec) -> None:
    """Raise for an algorithm the spec's topologies cannot run."""
    for algo in spec.algos:
        for topo in spec.topo_axis:
            check_topology(spec.base.replace(algo=algo), topo.ndim)


@dataclasses.dataclass(frozen=True)
class CampaignPoint:
    """One grid point: the cell coordinates plus its SimResult."""

    algo: Algo
    pattern: str
    rate: float
    seed: int
    result: SimResult
    scenario: str = "static"
    topo: str = ""
    workload: str = ""


@dataclasses.dataclass
class CampaignResult:
    """Structured campaign output.

    ``points`` is ordered (topo, pattern, algo, scenario, rate, seed)
    nested-loop major.  ``wall_clock_s`` maps one key a cell to the
    wall-clock of its batched run (plan building excluded; it is
    ``plan_wall_clock_s``, split by stage in ``plan_stage_ms`` as
    :func:`repro_torch.core.plan_fast.build_plans_batched` reports it,
    summed over topologies).  The key is ``(algo name, pattern)``, then
    ``+ (scenario,)`` with a scenario axis, and with a topology axis of
    more than one topology the topology's name comes first.
    """

    spec: CampaignSpec
    points: list[CampaignPoint]
    wall_clock_s: dict[tuple[str, ...], float]
    total_wall_clock_s: float
    plan_wall_clock_s: float = 0.0
    plan_stage_ms: dict[str, float] = dataclasses.field(default_factory=dict)

    def select(self, algo: Algo | None = None, pattern: str | None = None,
               rate: float | None = None, seed: int | None = None,
               scenario: str | None = None, topo: str | None = None,
               workload: str | None = None) -> list[CampaignPoint]:
        return [p for p in self.points
                if (algo is None or p.algo == algo)
                and (pattern is None or p.pattern == pattern)
                and (rate is None or p.rate == rate)
                and (seed is None or p.seed == seed)
                and (scenario is None or p.scenario == scenario)
                and (topo is None or p.topo == topo)
                and (workload is None or p.workload == workload)]

    @property
    def scenario_names(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.spec.scenarios) or ("static",)

    @property
    def topo_names(self) -> tuple[str, ...]:
        return tuple(t.name for t in self.spec.topo_axis)

    def _resolve_axis(self, name: str, value: str | None,
                      options: tuple[str, ...]) -> str:
        """Default a cell axis only when it has one value: pooling points
        across scenarios or topologies would overlay them into one
        grid."""
        if value is not None:
            if value not in options:
                raise KeyError(f"unknown {name} {value!r}; campaign has "
                               f"{list(options)}")
            return value
        if len(options) == 1:
            return options[0]
        raise ValueError(
            f"ambiguous {name} axis: this campaign has {list(options)}; "
            f"pass {name}=... to the accessor")

    def grid(self, field: str, algo: Algo, pattern: str,
             scenario: str | None = None,
             topo: str | None = None) -> np.ndarray:
        """(num_rates, num_seeds) array of a SimResult field for ONE cell
        (``scenario`` and ``topo`` are required where the campaign has
        several)."""
        scenario = self._resolve_axis("scenario", scenario,
                                      self.scenario_names)
        topo = self._resolve_axis("topo", topo, self.topo_names)
        rates, seeds = list(self.spec.rates), list(self.spec.seeds)
        g = np.zeros((len(rates), len(seeds)))
        filled = np.zeros((len(rates), len(seeds)), bool)
        for p in self.select(algo=algo, pattern=pattern, scenario=scenario,
                             topo=topo):
            ij = rates.index(p.rate), seeds.index(p.seed)
            if filled[ij]:
                raise ValueError(
                    f"duplicate point for (rate={p.rate}, seed={p.seed}) "
                    f"in cell ({algo.name}, {pattern!r}, {scenario!r}, "
                    f"{topo!r}); use explicit (name, matrix) labels")
            filled[ij] = True
            g[ij] = getattr(p.result, field)
        if not filled.all():
            raise ValueError(
                f"cell ({algo.name}, {pattern!r}, {scenario!r}, {topo!r}) "
                f"is missing {int((~filled).sum())} of the {filled.size} "
                f"points")
        return g

    def mean_over_seeds(self, field: str, algo: Algo, pattern: str,
                        scenario: str | None = None,
                        topo: str | None = None) -> np.ndarray:
        """(num_rates,) seed average of a SimResult field for one cell."""
        return self.grid(field, algo, pattern, scenario=scenario,
                         topo=topo).mean(axis=1)

    def saturation_throughput(self, algo: Algo, pattern: str,
                              scenario: str | None = None,
                              topo: str | None = None) -> float:
        """Max seed-averaged accepted throughput across the rate sweep
        (paper Fig. 8)."""
        return float(self.mean_over_seeds("throughput", algo, pattern,
                                          scenario=scenario,
                                          topo=topo).max())

    CSV_HEADER = ["topo", "scenario", "pattern", "workload", "algo",
                  "rate", "seed", "throughput", "offered", "avg_lat",
                  "p50_lat", "p90_lat", "p99_lat", "max_lat", "lcv",
                  "link_load_max", "reorder", "saturated", "meas_cycles"]

    def to_rows(self) -> list[list]:
        return csv_rows(self.points)

    def _wall_key_labels(self, key: tuple[str, ...]) -> list[str]:
        """The parts of one ``wall_clock_s`` key, each named by its axis."""
        labels = ["topo"] if len(self.spec.topo_axis) > 1 else []
        labels += ["algo", "pattern"]
        if self.spec.scenarios:
            labels.append("scenario")
        if len(labels) != len(key):     # a foreign key: its parts bare
            return [str(part) for part in key]
        return [f"{lab}={part}" for lab, part in zip(labels, key)]

    def summary(self) -> str:
        lines = [f"campaign: {self.spec.num_points} points in "
                 f"{self.total_wall_clock_s:.1f}s wall-clock"]
        for key, dt in self.wall_clock_s.items():
            cell = " ".join(f"{part:22s}"
                            for part in self._wall_key_labels(key))
            lines.append(f"  cell {cell} {dt:6.2f}s")
        return "\n".join(lines)


def csv_rows(points: Sequence[CampaignPoint]) -> list[list]:
    """CSV rows (matching ``CampaignResult.CSV_HEADER``) for points."""
    rows = []
    for p in points:
        r = p.result
        rows.append([p.topo, p.scenario, p.pattern, p.workload,
                     p.algo.name, p.rate, p.seed,
                     f"{r.throughput:.4f}", f"{r.offered:.4f}",
                     f"{r.avg_latency:.1f}", f"{r.p50_latency:.1f}",
                     f"{r.p90_latency:.1f}", f"{r.p99_latency:.1f}",
                     f"{r.max_latency:.0f}", f"{r.lcv:.3f}",
                     f"{r.link_load_max:.4f}", r.reorder_value,
                     int(r.saturated), r.meas_cycles])
    return rows


def _run_cell(spec: CampaignSpec, cfg: SimConfig, tables, meta,
              points: list[tuple[float, int]], devices):
    """Advance one (algo, pattern) cell; returns (host state, sat flags).

    The cell is one lane batch over ``points``, split over ``devices``
    as ``spec.multi_device`` says (:func:`repro_torch.noc.sim.lane_devices`),
    advanced in chunk-cycle slices; the host stops the whole batch once
    every lane of every group is saturated.
    """
    lanes = LaneGroups.fresh(
        tables, meta, cfg, points,
        lane_devices(devices, len(points), spec.multi_device))
    total = int(cfg.cycles)
    chunk = int(spec.chunk) or total
    sat = np.zeros(len(points), bool)
    q_meta = source_queue_meta(tables, cfg)   # static for the whole cell
    done = 0
    while done < total:
        step_cycles = min(chunk, total - done)
        lanes.run(step_cycles)
        done += step_cycles
        if done > cfg.warmup:
            # saturation accumulates from post-warmup reads only — a
            # transient warmup spike must not latch a lane; the read
            # comes after every group's chunk was launched
            occ = queue_occupancy(tables, cfg, lanes.read("q_size"),
                                  q_meta)
            sat |= occ >= spec.sat_occupancy
            if done < total and sat.all():
                break  # every lane saturated: verdict reached
    return lanes.to_host(), sat


@dataclasses.dataclass(frozen=True)
class CellKey:
    """Coordinates of one campaign cell in the spec's enumeration order
    (topology → pattern item → algo → scenario); ``scen_i`` is -1 for
    the static (no-scenario) cell."""

    index: int
    topo_i: int
    topo: str
    item_i: int
    pattern: str
    algo: Algo
    scen_i: int = -1
    scenario: str = "static"
    # the workload axis's name when the cell's item is a workload
    # (item_i >= len(spec.patterns)); "" for a pattern's cell
    workload: str = ""

    @property
    def slug(self) -> str:
        """Filesystem-safe unique cell name (the checkpoint file's stem)."""
        parts = (self.topo, f"i{self.item_i}", self.pattern,
                 self.algo.name, self.scenario)
        clean = "_".join(re.sub(r"[^A-Za-z0-9.+-]+", "-", p)
                         for p in parts)
        return f"cell{self.index:04d}_{clean}"

    def wall_key(self, spec: CampaignSpec) -> tuple[str, ...]:
        """The cell's ``CampaignResult.wall_clock_s`` key."""
        key = (self.algo.name, self.pattern)
        if self.scen_i >= 0:
            key += (self.scenario,)
        if len(spec.topo_axis) > 1:
            key = (self.topo,) + key
        return key


@dataclasses.dataclass
class CellOutcome:
    """One executed cell: its per-lane results plus wall-clock."""

    key: CellKey
    results: list[SimResult]    # one per (rate, seed) lane, rate-major
    wall_s: float
    # the lanes' probe rings when cfg.telemetry is on, normalised by the
    # topology's bandwidths (static cells) or the per-slot fault timeline
    # (scenario cells); None otherwise
    telemetry: Telemetry | None = None


def campaign_cells(spec: CampaignSpec) -> list[CellKey]:
    """The spec's cells in canonical execution order: topology → pattern
    item (the patterns, then the workloads) → algo → scenario."""
    names = [p if isinstance(p, str) else str(p[0]) for p in spec.patterns]
    names += [str(w.name) if hasattr(w, "matrix_for") else str(w[0])
              for w in spec.workloads]
    n_pat = len(spec.patterns)
    scens = list(enumerate(spec.scenarios)) or [(-1, None)]
    cells = [(ti, topo.name, i, name, algo, k, scen)
             for ti, topo in enumerate(spec.topo_axis)
             for i, name in enumerate(names)
             for algo in spec.algos for k, scen in scens]
    return [CellKey(index=idx, topo_i=ti, topo=tname, item_i=i,
                    pattern=name, algo=algo, scen_i=k,
                    scenario="static" if scen is None else scen.name,
                    workload=name if i >= n_pat else "")
            for idx, (ti, tname, i, name, algo, k, scen) in enumerate(cells)]


@dataclasses.dataclass
class _ItemPrep:
    """Per-(topology, pattern item) execution inputs."""

    tm: np.ndarray
    table: object | None       # BiDORTable (None when BiDOR absent)
    nrank: object | None       # warm-start fixed point for replans
    bidor_tm: np.ndarray       # admission-controlled generation matrix


class CampaignExecutor:
    """Executes campaign cells one at a time, in any order.

    Plans are built on a topology's first use: one batched planner call
    covers every pattern of that topology that needs one, so resuming a
    job at cell k does not plan topologies whose cells are all done.
    ``bidor_tables`` (pattern name → (N, N) choice table) overrides a
    pattern's plan; scenario cells still build the plan, whose N-Rank
    fixed point seeds their replans.  ``plan_cache`` serves plans by
    content key; when every pattern of a topology hits, the planner does
    not run for it.  ``tracer`` records each cell as a span, the cache's
    hits as instants and the scenario cells' control plane.  ``device``
    is what ``device.resolve_devices`` reads: plans and tables are built
    on the first device, and a cell's lanes split over all of them as
    ``spec.multi_device`` says."""

    def __init__(self, spec: CampaignSpec, *,
                 bidor_tables: dict[str, np.ndarray] | None = None,
                 plan_cache=None, verbose: bool = False, tracer=None,
                 device=None):
        check_spec(spec)
        self.spec = spec
        self.bidor_tables = bidor_tables or {}
        self.plan_cache = plan_cache
        self.verbose = verbose
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.log = EventLog(verbose=verbose)
        self.devices = resolve_devices(device)
        self.device = self.devices[0]
        self.points = [(float(r), int(s))
                       for r in spec.rates for s in spec.seeds]
        self._prepped: dict[int, list[_ItemPrep]] = {}
        self.plan_s = 0.0           # wall-clock spent building plans
        self.plan_stage_ms: dict[str, float] = {}

    def _build_plans(self, topo: Topology, items, need: list[int]) -> dict:
        """Plans for the needed pattern items: one batched planner call,
        through the plan cache when one is set (hits served, the misses
        planned together)."""
        down = topo.down_channels
        return dict(zip(need, build_plans_batched(
            topo, [items[i][1] for i in need],
            down_channels=down if down.size else None, device=self.device,
            stage_ms=self.plan_stage_ms, cache=self.plan_cache,
            tracer=self.tracer)))

    def _prep_topo(self, topo_i: int) -> list[_ItemPrep]:
        if topo_i in self._prepped:
            return self._prepped[topo_i]
        spec = self.spec
        topo = spec.topo_axis[topo_i]
        items = spec.pattern_items(topo)
        given = self.bidor_tables
        plans: dict[int, object] = {}
        if Algo.BIDOR in spec.algos:
            # keyed by item index: explicit (name, matrix) patterns may
            # repeat a name with different matrices
            need = [i for i, (name, _) in enumerate(items)
                    if name not in given or spec.scenarios]
            if need:
                t0 = time.perf_counter()
                plans = self._build_plans(topo, items, need)
                self.plan_s += time.perf_counter() - t0
        prepped = []
        for i, (name, tm) in enumerate(items):
            table = nrank = None
            if Algo.BIDOR in spec.algos:
                plan = plans.get(i)
                table = dor_table(topo) if plan is None else plan.table
                nrank = None if plan is None else plan.nrank
                if name in given:
                    table = dataclasses.replace(
                        table, choice=np.asarray(given[name], np.int8))
            # admission control: pairs no dimension order can serve on a
            # degraded topology are shed from BiDOR's generation matrix
            bidor_tm = tm
            if (table is not None and table.unroutable is not None
                    and table.unroutable.any()):
                bidor_tm = np.where(table.unroutable, 0.0, tm)
            prepped.append(_ItemPrep(tm=tm, table=table, nrank=nrank,
                                     bidor_tm=bidor_tm))
        self._prepped[topo_i] = prepped
        return prepped

    def run_cell(self, key: CellKey, *, checkpoint=None) -> CellOutcome:
        """Execute one cell: all its (rate, seed) lanes, one batch.

        ``checkpoint``: an optional epoch-boundary checkpointer handed to
        the control plane for a scenario cell
        (:func:`repro_torch.noc.ctrl.run_controlled`); a static cell runs
        in one chunked call and is kept only once complete."""
        spec = self.spec
        topo = spec.topo_axis[key.topo_i]
        prep = self._prep_topo(key.topo_i)[key.item_i]
        cfg = spec.base.replace(algo=key.algo)
        t0 = time.perf_counter()
        tc0 = self.tracer.now_us() if self.tracer.enabled else 0.0
        bidor = key.algo == Algo.BIDOR
        cell_tm = prep.bidor_tm if bidor else prep.tm
        if key.scen_i < 0:
            tables, meta = build_tables(
                topo, cell_tm, prep.table if bidor else None, cfg.num_vcs,
                self.device, escape=cfg.watchdog)
            host, sat = _run_cell(spec, cfg, tables, meta, self.points,
                                  self.devices)
            results = [postprocess(lane(host, i), cfg, topo, rate=rate,
                                   seed=seed, saturated=bool(sat[i]))
                       for i, (rate, seed) in enumerate(self.points)]
            telemetry = Telemetry.from_state(host, cfg)
            if telemetry is not None:
                telemetry = telemetry.with_bw(static_bw_slots(topo, cfg))
        else:
            ctrl = run_controlled(
                topo, cell_tm, cfg, spec.scenarios[key.scen_i],
                rates=[float(r) for r in spec.rates],
                seeds=[int(s) for s in spec.seeds],
                bidor_table=prep.table if bidor else None,
                nrank0=prep.nrank if bidor else None,
                sat_occupancy=spec.sat_occupancy,
                multi_device=spec.multi_device, checkpoint=checkpoint,
                verbose=self.verbose, tracer=self.tracer,
                device=self.devices)
            results = [ctrl.result_with_peak(i)
                       for i in range(len(self.points))]
            telemetry = ctrl.telemetry
        dt = time.perf_counter() - t0
        if self.tracer.enabled:
            self.tracer.complete(
                "cell", tc0, self.tracer.now_us() - tc0, cat="campaign",
                args={"slug": key.slug, "topo": key.topo,
                      "pattern": key.pattern, "algo": key.algo.name,
                      "scenario": key.scenario,
                      "lanes": len(self.points)})
        self.log.event("cell_done",
                       f"campaign cell {key.topo:16s} {key.pattern:12s} "
                       f"{key.algo.name:8s} {key.scenario:12s} "
                       f"{len(self.points)} pts in {dt:.2f}s",
                       cell=key.slug, wall_s=round(dt, 3))
        return CellOutcome(key=key, results=results, wall_s=dt,
                           telemetry=telemetry)

    def cell_points(self, outcome: CellOutcome) -> list[CampaignPoint]:
        """The cell's CampaignPoints, in canonical lane order."""
        k = outcome.key
        return [CampaignPoint(algo=k.algo, pattern=k.pattern, rate=rate,
                              seed=seed, result=res, scenario=k.scenario,
                              topo=k.topo, workload=k.workload)
                for (rate, seed), res in zip(self.points, outcome.results)]


def run_campaign(spec: CampaignSpec, *,
                 bidor_tables: dict[str, np.ndarray] | None = None,
                 plan_cache=None, verbose: bool = False,
                 tracer=None, device=None) -> CampaignResult:
    """Execute the full campaign grid on ``device`` (default: the card,
    every visible card for the lane split, ``spec.multi_device``; a
    sequence of devices names them).

    BiDOR plans are built per pattern from that pattern's own matrix;
    ``bidor_tables`` (pattern name → (N, N) choice table) overrides them,
    e.g. with :func:`repro_torch.core.qstar.build_plan`'s tables.  With
    ``spec.scenarios`` every (pattern, algo, scenario) cell runs the
    control plane's event-driven loop, and ``SimResult.link_load_max``
    reports the time-resolved peak (max over control epochs of the max
    bandwidth-normalized link load).  ``plan_cache`` serves and stores
    those plans by content key
    (:class:`repro_torch.core.plan_cache.PlanCache`); ``tracer`` records
    the cells, the plan builds and the control plane.

    This is the blocking, in-memory entry over the cell machinery;
    :mod:`repro_torch.noc.service` runs the same cells as a checkpointed
    job."""
    t_start = time.perf_counter()
    executor = CampaignExecutor(spec, bidor_tables=bidor_tables,
                                plan_cache=plan_cache, verbose=verbose,
                                tracer=tracer, device=device)
    out_points: list[CampaignPoint] = []
    wall: dict[tuple, float] = {}
    for key in campaign_cells(spec):
        outcome = executor.run_cell(key)
        wall[key.wall_key(spec)] = outcome.wall_s
        out_points.extend(executor.cell_points(outcome))
    return CampaignResult(spec=spec, points=out_points, wall_clock_s=wall,
                          total_wall_clock_s=time.perf_counter() - t_start,
                          plan_wall_clock_s=executor.plan_s,
                          plan_stage_ms=executor.plan_stage_ms)
