"""Render a campaign job's observability artifacts into a report.

A job directory (:class:`repro_torch.noc.service.CampaignJob`) holds
three kinds of evidence:

* ``cells/<slug>.telemetry.npz``: the in-sim probe rings of each cell
  (:class:`repro_torch.obs.probe.Telemetry`);
* ``trace.jsonl``: the Chrome-trace control-plane and planner events
  (:mod:`repro_torch.obs.trace`);
* ``metrics.jsonl``: the job's streaming progress records.

:func:`render_job` folds them into an output directory:

* ``trajectories.csv``: per (cell, lane, telemetry slot) the
  bandwidth-normalised peak link load, delivered and shed counts, p99
  latency and mean source-queue fill, the view over time that the
  scalar ``SimResult`` cannot give;
* ``replan_timeline.csv``: control-plane events (replans with their wall
  durations, hot swaps, drift detections, environment events, plan
  builds, cache hits, cells) in time order;
* ``report.md``: a summary of job progress, cell walls, peak-load
  trajectories, replan timings and the plan cache's effect.

Everything is stdlib + numpy; the renderer never imports the simulator,
so it runs on artifacts copied off the machine that made them.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .probe import Telemetry
from .trace import read_trace

__all__ = ["render_job", "load_metrics"]

TRAJ_HEADER = ["cell", "topo", "pattern", "algo", "scenario", "lane",
               "slot", "t_start", "cycles", "peak_link_load",
               "delivered", "shed", "p99_lat", "occ_mean"]

TIMELINE_HEADER = ["ts_us", "name", "ph", "dur_us", "cat", "args"]

# ctrl/planner/campaign event names worth a timeline row (host spans and
# instants; the per-epoch "epoch" spans are summarized, not listed)
_TIMELINE_NAMES = ("replan", "hot_swap", "drift_detected", "LinkFail",
                   "LinkRecover", "TrafficDrift", "build_plan_fast",
                   "build_plans_batched", "plan_cache_hit",
                   "plan_cache_miss", "cell")


def load_metrics(path: str) -> list[dict]:
    """Parse a ``metrics.jsonl`` stream (tolerates a torn last line)."""
    records = []
    if not os.path.exists(path):
        return records
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                break   # killed mid-write: the stream ends here
    return records


def _write_csv(path: str, header: list[str], rows: list[list]) -> None:
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for row in rows:
            f.write(",".join(str(v) for v in row) + "\n")


def _traj_rows(cell: dict, tel: Telemetry) -> list[list]:
    rows = []
    peak = tel.peak_link_load()             # (lanes, slots)
    active = tel.active_slots()
    starts = tel.slot_starts()
    occ = tel.occupancy_mean()              # (lanes, slots)
    p99 = tel.latency_percentile(0.99)      # (lanes, slots)
    delivered = tel.count("delivered")
    shed = tel.count("shed")
    for lane in range(tel.num_lanes):
        for s in active:                    # active slot indices
            rows.append([
                cell["slug"], cell["topo"], cell["pattern"],
                cell["algo"], cell["scenario"], lane, int(s),
                int(starts[s]), int(tel.cycles[lane, s]),
                f"{peak[lane, s]:.4f}", int(delivered[lane, s]),
                int(shed[lane, s]), f"{p99[lane, s]:.1f}",
                f"{occ[lane, s]:.4f}"])
    return rows


def _timeline_rows(events: list[dict]) -> list[list]:
    rows = []
    for ev in events:
        if ev.get("name") not in _TIMELINE_NAMES:
            continue
        rows.append([f"{ev['ts']:.0f}", ev["name"], ev.get("ph", ""),
                     f"{ev.get('dur', 0):.0f}", ev.get("cat", ""),
                     json.dumps(ev.get("args", {}), sort_keys=True)
                     .replace(",", ";")])
    rows.sort(key=lambda r: float(r[0]))
    return rows


def _md_table(header: list[str], rows: list[list]) -> list[str]:
    lines = ["| " + " | ".join(header) + " |",
             "|" + "|".join("---" for _ in header) + "|"]
    lines += ["| " + " | ".join(str(v) for v in row) + " |"
              for row in rows]
    return lines


def render_job(job_dir: str, out_dir: str) -> dict:
    """Render one job's observability artifacts; returns a summary dict.

    ``job_dir`` is a ``CampaignJob`` directory (must hold
    ``manifest.json``); ``out_dir`` receives ``trajectories.csv``,
    ``replan_timeline.csv`` and ``report.md``.  Missing planes (no
    telemetry files, no trace, no metrics) degrade to empty sections —
    the report renders from whatever evidence exists.
    """
    with open(os.path.join(job_dir, "manifest.json")) as f:
        manifest = json.load(f)
    os.makedirs(out_dir, exist_ok=True)

    # ---- plane 1: telemetry trajectories ---- #
    traj_rows: list[list] = []
    cells_with_tel = []
    for cell in manifest["cells"]:
        path = os.path.join(job_dir, "cells",
                            f"{cell['slug']}.telemetry.npz")
        if not os.path.exists(path):
            continue
        tel = Telemetry.load(path)
        cells_with_tel.append((cell, tel))
        traj_rows.extend(_traj_rows(cell, tel))
    _write_csv(os.path.join(out_dir, "trajectories.csv"),
               TRAJ_HEADER, traj_rows)

    # ---- plane 2: ctrl/planner timeline ---- #
    trace_path = os.path.join(job_dir, "trace.jsonl")
    events = read_trace(trace_path) if os.path.exists(trace_path) else []
    timeline = _timeline_rows(events)
    _write_csv(os.path.join(out_dir, "replan_timeline.csv"),
               TIMELINE_HEADER, timeline)

    # ---- plane 3: job metrics ---- #
    metrics = load_metrics(os.path.join(job_dir, "metrics.jsonl"))
    cell_recs = [m for m in metrics if m.get("event") == "cell"]
    fresh = [m for m in cell_recs if not m.get("cached")]
    cache_stats = (cell_recs[-1].get("plan_cache") if cell_recs else None)

    # ---- report.md ---- #
    lines = [f"# Flight-recorder report: {manifest['job_id']}", ""]
    done = max((m.get("done", 0) for m in metrics), default=0)
    lines += [f"- cells: {done}/{manifest['num_cells']} done "
              f"({len(fresh)} executed this run, "
              f"{len(cell_recs) - len(fresh)} from checkpoints)"]
    if fresh:
        walls = [m["wall_s"] for m in fresh]
        lines += [f"- executed-cell wall: total {sum(walls):.2f}s, "
                  f"mean {np.mean(walls):.2f}s, max {max(walls):.2f}s"]
        rates = [m["lanes_per_s"] for m in fresh if "lanes_per_s" in m]
        if rates:
            lines += [f"- throughput: {np.mean(rates):.2f} lanes/s mean"]
    if cache_stats:
        lines += [f"- plan cache: {cache_stats['hits']} hits, "
                  f"{cache_stats['misses']} misses, "
                  f"{cache_stats['device_builds']} device builds"]
    lines += [""]

    if cells_with_tel:
        lines += ["## Telemetry trajectories", "",
                  "Per-cell lane-0 peak bandwidth-normalized link load "
                  "over telemetry slots (`trajectories.csv` has every "
                  "lane and field).", ""]
        rows = []
        for cell, tel in cells_with_tel:
            peak = tel.peak_link_load()[0]
            act = tel.active_slots()
            traj = " ".join(f"{v:.2f}" for v in peak[act])
            rows.append([cell["slug"], cell["scenario"],
                         f"{peak[act].max():.3f}" if act.size else "-",
                         traj])
        lines += _md_table(["cell", "scenario", "peak", "trajectory"],
                           rows) + [""]

    replans = [ev for ev in events if ev.get("name") == "replan"]
    if replans:
        lines += ["## Replans", ""]
        rows = [[f"{ev['ts']:.0f}", ev["args"].get("cycle"),
                 ev["args"].get("trigger"),
                 ev["args"].get("iterations"),
                 ev["args"].get("unroutable"),
                 f"{ev.get('dur', 0) / 1e3:.1f}"]
                for ev in replans]
        lines += _md_table(["ts_us", "cycle", "trigger", "iters",
                            "unroutable", "wall_ms"], rows) + [""]
    epochs = [ev for ev in events if ev.get("name") == "epoch"]
    if epochs:
        durs = np.asarray([ev.get("dur", 0) for ev in epochs]) / 1e3
        lines += ["## Sim epochs", "",
                  f"{len(epochs)} epoch spans, wall "
                  f"mean {durs.mean():.1f} ms / max {durs.max():.1f} ms.",
                  ""]
    with open(os.path.join(out_dir, "report.md"), "w") as f:
        f.write("\n".join(lines) + "\n")

    return {"job_id": manifest["job_id"], "cells_done": done,
            "cells_total": manifest["num_cells"],
            "telemetry_cells": len(cells_with_tel),
            "trace_events": len(events), "replans": len(replans),
            "traj_rows": len(traj_rows), "out_dir": out_dir}
