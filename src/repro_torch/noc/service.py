"""Campaign as a service: resumable, cached, streaming sweeps.

``run_campaign`` is one blocking call: fine for a minute-long grid, of no
use for the hours-long sweeps behind the paper's numbers, which must
survive being stopped and stream partial results.  This module makes a
campaign a *job*, as the reference's service does:

* **A checkpoint a cell.**  A cell (one topology, pattern item, algorithm
  and scenario, all its lanes) is the unit of work.  As each completes,
  its per-lane ``SimResult``s and wall-clock land under
  ``<root>/<job_id>/cells/`` as one atomic npz with a sha256 sidecar,
  and its CSV rows are appended to the job's ``results.csv``.
* **Checkpoints inside a cell.**  A scenario cell also snapshots the
  control loop at every epoch boundary
  (``run_controlled(checkpoint=...)``), so a long dynamic cell resumes
  from its last boundary instead of cycle 0.
* **Resume is bit for bit.**  The job is keyed on a content hash of the
  ``CampaignSpec`` (:func:`spec_fingerprint`); re-running the same spec
  against the same directory skips the completed cells, re-emits their
  stored results and goes on.  Cells are deterministic given the spec,
  so the final ``results.csv`` is the same bytes however many times the
  job was interrupted.
* **Plan cache.**  Jobs share a persistent
  :class:`repro_torch.core.plan_cache.PlanCache` (default
  ``<root>/plan-cache``): a warm re-run builds no plan.
* **Streaming.**  ``results.csv`` grows as the job runs; a resume
  rewrites it from the completed cells (the npz cells are the truth)
  before appending fresh ones.
* **Hardening.**  A stored cell that fails its sidecar or its parse is
  quarantined and recomputed; a cell whose run raises is retried with
  backoff, and after the last attempt recorded as ``cell_error`` while
  the job goes on (``run()`` then returns False).  A retry runs on the
  job's device again: no cell moves to another device.

Cells run on ``device`` (default: the card).  The default root is
``artifacts/campaigns_torch``, not the reference's: the reference's plan
cache holds W summed in float32, which is not the port's build, and its
job ids are the same fingerprints.

The job is :class:`CampaignJob`: ``run()`` (budgeted by
``max_cells``, the interruption knob), ``start()``/``wait()`` on a daemon
thread, ``status()``/``result()``.  :func:`run_campaign_service` wraps a
run to completion.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time

import numpy as np

from ..core.plan_cache import PlanCache, topology_fingerprint
from ..obs.probe import Telemetry
from ..obs.trace import NULL_TRACER, TraceWriter
from .campaign import (CampaignExecutor, CampaignPoint, CampaignResult,
                       CampaignSpec, CellKey, CellOutcome, campaign_cells,
                       csv_rows)
from .simconfig import Algo, SimConfig, SimResult

__all__ = ["CampaignJob", "JobStatus", "CellCheckpoint",
           "run_campaign_service", "spec_fingerprint"]

DEFAULT_ROOT = os.path.join("artifacts", "campaigns_torch")


# --------------------------------------------------------------------- #
# spec fingerprinting (the manifest key)
# --------------------------------------------------------------------- #
def _traffic_hash(tm) -> str:
    import hashlib
    a = np.ascontiguousarray(np.asarray(tm, np.float64))
    return hashlib.sha256(a.tobytes()).hexdigest()


def _event_desc(ev) -> dict:
    d = {"kind": type(ev).__name__, "cycle": int(ev.cycle)}
    if hasattr(ev, "links"):
        d["links"] = [[int(u), int(n)] for u, n in ev.links]
    if hasattr(ev, "bw_scale"):
        d["bw_scale"] = float(ev.bw_scale)
    if hasattr(ev, "traffic"):
        d["traffic"] = _traffic_hash(ev.traffic)
    if hasattr(ev, "rate_scale"):
        d["rate_scale"] = float(ev.rate_scale)
    return d


# SimConfig fields that never change results: the probes change no bit
# of a result, so switching telemetry on must resume the SAME job, as
# multi_device below; sim_tile_nodes only picks the kernel's layout
# (every layout is bit for bit the same), so it is left out too.  The
# set is the reference's, so the two packages' fingerprints agree.
_OBS_FIELDS = frozenset({"telemetry", "tel_epoch", "tel_slots",
                         "tel_occ_bins", "sim_tile_nodes"})


def spec_fingerprint(spec: CampaignSpec) -> str:
    """Content hash of everything that determines a campaign's results.

    Topologies hash by full content (:func:`topology_fingerprint`),
    explicit traffic matrices by bytes, scenarios by their event
    schedules (drift matrices hashed) and replan knobs.  ``multi_device``
    and the telemetry knobs (``_OBS_FIELDS``) are deliberately EXCLUDED:
    lane sharding and probe collection are bit-identical by construction,
    so a job may resume on a different device count or with telemetry
    newly enabled.
    """
    import hashlib
    desc = {
        "topos": [topology_fingerprint(t) for t in spec.topo_axis],
        "algos": [a.name for a in spec.algos],
        "patterns": [p if isinstance(p, str)
                     else [str(p[0]), _traffic_hash(p[1])]
                     for p in spec.patterns],
        # ML workloads hash by name + derived rank-flow bytes (topology
        # independent; the per-topology embedding is deterministic)
        "workloads": [[str(w.name), _traffic_hash(w.campaign_flows())]
                      if hasattr(w, "matrix_for")
                      else [str(w[0]), _traffic_hash(w[1])]
                      for w in spec.workloads],
        "rates": [float(r) for r in spec.rates],
        "seeds": [int(s) for s in spec.seeds],
        "base": {f.name: (int(v) if isinstance(v, (bool, int, Algo))
                          else float(v))
                 for f in dataclasses.fields(SimConfig)
                 if f.name not in _OBS_FIELDS
                 for v in [getattr(spec.base, f.name)]},
        "chunk": int(spec.chunk),
        "sat_occupancy": float(spec.sat_occupancy),
        "scenarios": [{
            "name": s.name, "policy": s.policy,
            "events": [_event_desc(e) for e in s.events],
            "replan": (dataclasses.asdict(s.replan)
                       if s.replan is not None else None),
        } for s in spec.scenarios],
    }
    blob = json.dumps(desc, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


# --------------------------------------------------------------------- #
# atomic file helpers (write to a temp name, then rename)
# --------------------------------------------------------------------- #
def _sha256_file(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_sidecar(path: str) -> None:
    """Record ``path``'s content hash next to it (integrity sidecar)."""
    _atomic_write_text(path + ".sha256", _sha256_file(path) + "\n")


def _verify_sidecar(path: str) -> bool:
    """True iff ``path`` matches its sidecar.  A file without a sidecar
    (pre-hardening layout) passes — corruption there still surfaces as a
    load failure, which callers also treat as corrupt."""
    side = path + ".sha256"
    if not os.path.exists(side):
        return True
    with open(side) as f:
        return f.read().strip() == _sha256_file(path)


def _atomic_savez(path: str, payload: dict) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _atomic_write_text(path: str, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class CellCheckpoint:
    """Single-file atomic (arrays, meta) checkpoint — the duck-typed
    epoch-boundary checkpointer ``run_controlled`` consumes.  Meta rides
    inside the npz as a JSON bytes array, so save/replace is one atomic
    rename and a partial write can never be observed.

    Every save records a sha256 sidecar; ``load`` verifies it (and the
    npz parse itself) and treats any mismatch as *no checkpoint*: the
    corrupt file is set aside as ``<path>.corrupt`` and the cell restarts
    from cycle 0 — a slower resume, never a wrong one."""

    def __init__(self, path: str):
        self.path = str(path)

    def save(self, arrays: dict, meta: dict) -> None:
        payload = dict(arrays)
        payload["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), np.uint8)
        _atomic_savez(self.path, payload)
        _write_sidecar(self.path)

    def load(self):
        if not os.path.exists(self.path):
            return None
        try:
            if not _verify_sidecar(self.path):
                raise ValueError("checkpoint sha256 mismatch")
            with np.load(self.path, allow_pickle=False) as z:
                d = {k: z[k] for k in z.files}
            meta = json.loads(bytes(d.pop("__meta__")).decode())
            return d, meta
        except Exception:
            os.replace(self.path, self.path + ".corrupt")
            side = self.path + ".sha256"
            if os.path.exists(side):
                os.unlink(side)
            return None

    def clear(self) -> None:
        for p in (self.path, self.path + ".sha256"):
            if os.path.exists(p):
                os.unlink(p)


# --------------------------------------------------------------------- #
# cell outcome (de)serialization
# --------------------------------------------------------------------- #
_RESULT_FIELDS = [f.name for f in dataclasses.fields(SimResult)]


def _save_outcome(path: str, outcome: CellOutcome) -> None:
    payload = {"wall_s": np.float64(outcome.wall_s)}
    for name in _RESULT_FIELDS:
        vals = [getattr(r, name) for r in outcome.results]
        if name == "node_load":
            payload[name] = np.stack([np.asarray(v, np.float64)
                                      for v in vals])
        elif name == "algo":
            payload[name] = np.asarray([int(v) for v in vals], np.int64)
        else:
            payload[name] = np.asarray(vals)
    _atomic_savez(path, payload)
    _write_sidecar(path)


def _load_outcome(path: str, key: CellKey) -> CellOutcome:
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    n = d["algo"].shape[0]
    results = []
    for i in range(n):
        kw = {}
        for name in _RESULT_FIELDS:
            v = d[name][i]
            if name == "node_load":
                kw[name] = np.asarray(v, np.float64)
            elif name == "algo":
                kw[name] = Algo(int(v))
            elif v.dtype == np.bool_:
                kw[name] = bool(v)
            elif np.issubdtype(v.dtype, np.integer):
                kw[name] = int(v)
            else:
                kw[name] = float(v)
        results.append(SimResult(**kw))
    return CellOutcome(key=key, results=results,
                       wall_s=float(d["wall_s"]))


# --------------------------------------------------------------------- #
# the job
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class JobStatus:
    job_id: str
    total_cells: int
    done_cells: int
    running: bool
    complete: bool
    # live-progress fields (readable while the background thread runs)
    in_flight: str | None = None     # slug of the executing cell
    error: str | None = None         # repr of a failed run's exception
    eta_s: float | None = None       # remaining-cell estimate from
    #                                  this process's mean cell wall


class CampaignJob:
    """A campaign as a resumable on-disk job (see module docstring).

    ``root/<job_id>/`` layout::

        manifest.json    spec fingerprint + cell table (written once)
        cells/<slug>.npz completed-cell results (atomic, one per cell)
        ckpt/<slug>.npz  epoch-boundary snapshot of the in-flight
                         scenario cell (deleted when the cell completes)
        results.csv      streaming CSV, appended as cells complete

    ``job_id`` defaults to a prefix of the spec fingerprint, so the same
    spec always maps to the same directory and ``resume=True`` (the
    default) picks up exactly where a previous process stopped.  A
    directory whose manifest hashes a *different* spec is refused.

    ``plan_cache``: a :class:`PlanCache`, a directory path, ``"shared"``
    (default — ``<root>/plan-cache``, shared by every job under the
    root), or None to disable plan caching.

    ``device``: where the cells run (default: the card).  It holds for
    every attempt of every cell.

    **Chaos hardening.**  Every stored cell npz carries a sha256
    sidecar; a cached cell that fails verification (or fails to parse)
    is moved to ``cells/quarantine/`` and recomputed — corruption costs
    a re-run, never a wrong result.  Executing a cell retries up to
    ``max_retries`` times with exponential backoff; a cell that still
    fails is recorded as a ``cell_error`` event in ``metrics.jsonl`` and
    the job *continues* — one poisoned cell cannot take down an
    hours-long campaign (``run()`` then returns False so callers re-run
    or investigate).
    """

    def __init__(self, spec: CampaignSpec, *, root: str = DEFAULT_ROOT,
                 job_id: str | None = None,
                 bidor_tables: dict[str, np.ndarray] | None = None,
                 plan_cache="shared",
                 resume: bool = True,
                 verbose: bool = False,
                 trace: bool = False,
                 max_retries: int = 2,
                 retry_backoff_s: float = 0.5,
                 device=None):
        self.spec = spec
        self.fingerprint = spec_fingerprint(spec)
        self.job_id = job_id or f"job-{self.fingerprint[:12]}"
        self.dir = os.path.join(root, self.job_id)
        self.cells_dir = os.path.join(self.dir, "cells")
        self.quarantine_dir = os.path.join(self.cells_dir, "quarantine")
        self.ckpt_dir = os.path.join(self.dir, "ckpt")
        self.csv_path = os.path.join(self.dir, "results.csv")
        self.metrics_path = os.path.join(self.dir, "metrics.jsonl")
        self.trace_path = os.path.join(self.dir, "trace.jsonl")
        self.verbose = verbose
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        if plan_cache == "shared":
            plan_cache = PlanCache(os.path.join(root, "plan-cache"))
        elif isinstance(plan_cache, str):
            plan_cache = PlanCache(plan_cache)
        self.plan_cache = plan_cache
        self.cells = campaign_cells(spec)
        # progress shared with status(): guarded so a concurrent reader
        # never sees a torn (done, in_flight, walls) triple
        self._lock = threading.Lock()
        self._in_flight: str | None = None
        self._done: int | None = None    # None ⇔ no run() in this process
        self._walls: list[float] = []    # executed-cell walls (ETA basis)
        os.makedirs(self.cells_dir, exist_ok=True)
        os.makedirs(self.quarantine_dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._init_manifest(resume)
        # after _init_manifest: a resume=False wipe must not unlink the
        # trace file out from under an already-open writer
        self.tracer = (TraceWriter(self.trace_path) if trace
                       else NULL_TRACER)
        # an explicit device: tensors made on the background thread of
        # start() land there too
        self.executor = CampaignExecutor(
            spec, bidor_tables=bidor_tables, plan_cache=plan_cache,
            verbose=verbose, tracer=self.tracer, device=device)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------- #
    def _init_manifest(self, resume: bool) -> None:
        path = os.path.join(self.dir, "manifest.json")
        if os.path.exists(path):
            with open(path) as f:
                manifest = json.load(f)
            if manifest["spec_fingerprint"] != self.fingerprint:
                raise ValueError(
                    f"job dir {self.dir} holds a different campaign "
                    f"(manifest fingerprint "
                    f"{manifest['spec_fingerprint'][:12]}..., this spec "
                    f"{self.fingerprint[:12]}...); pick another job_id")
            if not resume:
                for k in self.cells:
                    cp = self._cell_path(k)
                    for p in (cp, cp + ".sha256", self._tel_path(k)):
                        if os.path.exists(p):
                            os.unlink(p)
                    CellCheckpoint(self._ckpt_path(k)).clear()
                for p in (self.csv_path, self.metrics_path,
                          self.trace_path):
                    if os.path.exists(p):
                        os.unlink(p)
                if os.path.isdir(self.quarantine_dir):
                    for name in os.listdir(self.quarantine_dir):
                        os.unlink(os.path.join(self.quarantine_dir, name))
            return
        manifest = {
            "job_id": self.job_id,
            "spec_fingerprint": self.fingerprint,
            "created_unix": time.time(),
            "num_points": self.spec.num_points,
            "num_cells": len(self.cells),
            "csv_header": CampaignResult.CSV_HEADER,
            "cells": [{
                "index": k.index, "slug": k.slug, "topo": k.topo,
                "pattern": k.pattern, "algo": k.algo.name,
                "scenario": k.scenario, "workload": k.workload,
            } for k in self.cells],
        }
        _atomic_write_text(path, json.dumps(manifest, indent=1))

    def _cell_path(self, key: CellKey) -> str:
        return os.path.join(self.cells_dir, f"{key.slug}.npz")

    def _quarantine_cell(self, key: CellKey) -> str:
        """Move a corrupt cell npz (and sidecar) out of the cache so the
        run loop recomputes it; returns the quarantine path."""
        path = self._cell_path(key)
        dest = os.path.join(self.quarantine_dir, os.path.basename(path))
        os.replace(path, dest)
        side = path + ".sha256"
        if os.path.exists(side):
            os.replace(side, dest + ".sha256")
        return dest

    def _load_cell(self, key: CellKey) -> "CellOutcome | None":
        """Verified load of a completed cell: sha256 sidecar first, then
        the npz parse itself.  Any failure quarantines the file and
        returns None — the caller recomputes the cell."""
        path = self._cell_path(key)
        try:
            if not _verify_sidecar(path):
                raise ValueError("cell sha256 mismatch")
            return _load_outcome(path, key)
        except Exception:
            self._quarantine_cell(key)
            return None

    def _tel_path(self, key: CellKey) -> str:
        return os.path.join(self.cells_dir, f"{key.slug}.telemetry.npz")

    def _ckpt_path(self, key: CellKey) -> str:
        return os.path.join(self.ckpt_dir, f"{key.slug}.npz")

    def cell_telemetry(self, key: CellKey) -> "Telemetry | None":
        """A completed cell's saved probe rings (None when the cell ran
        with telemetry off or has not completed)."""
        path = self._tel_path(key)
        return Telemetry.load(path) if os.path.exists(path) else None

    # ------------------------------------------------------------- #
    def completed_cells(self) -> list[CellKey]:
        return [k for k in self.cells
                if os.path.exists(self._cell_path(k))]

    def status(self) -> JobStatus:
        """Live job progress; safe to call concurrently with ``start()``.

        While a run is active in this process the counters come from the
        run loop's lock-guarded progress state — not a directory rescan,
        which could tear against a half-written cell and is stale for the
        in-flight cell anyway.  With no run in this process it falls back
        to counting cell checkpoints on disk.
        """
        with self._lock:
            done, in_flight = self._done, self._in_flight
            walls = list(self._walls)
            err = self._error
        if done is None:                  # no run() in this process yet
            done = len(self.completed_cells())
        eta = None
        if walls and done < len(self.cells):
            eta = (len(self.cells) - done) * (sum(walls) / len(walls))
        return JobStatus(
            job_id=self.job_id, total_cells=len(self.cells),
            done_cells=done,
            running=self._thread is not None and self._thread.is_alive(),
            complete=done == len(self.cells),
            in_flight=in_flight,
            error=repr(err) if err is not None else None,
            eta_s=eta)

    # ------------------------------------------------------------- #
    def _append_csv(self, f, outcome: CellOutcome) -> None:
        for row in csv_rows(self.executor.cell_points(outcome)):
            f.write(",".join(str(v) for v in row) + "\n")
        f.flush()

    def _emit_metric(self, f, record: dict) -> None:
        record = dict(record, t_unix=round(time.time(), 3))
        f.write(json.dumps(record, sort_keys=True) + "\n")
        f.flush()

    def _cell_metric(self, key: CellKey, *, done: int, cached: bool,
                     wall_s: float) -> dict:
        rec = {"event": "cell", "cell": key.slug, "index": key.index,
               "cached": cached, "done": done, "total": len(self.cells),
               "wall_s": round(wall_s, 4)}
        if key.workload:
            rec["workload"] = key.workload
        if not cached and wall_s > 0:
            rec["lanes_per_s"] = round(
                len(self.executor.points) / wall_s, 3)
        with self._lock:
            walls = list(self._walls)
        if walls and done < len(self.cells):
            rec["eta_s"] = round(
                (len(self.cells) - done) * sum(walls) / len(walls), 2)
        if self.plan_cache is not None:
            rec["plan_cache"] = self.plan_cache.stats.as_dict()
        return rec

    def _run_cell_with_retry(self, key: CellKey, ckpt, mf):
        """Bounded retry-with-backoff around one cell execution; returns
        the outcome, or None after ``max_retries + 1`` failed attempts
        (the terminal error is recorded as a ``cell_error`` metric)."""
        err = None
        for attempt in range(self.max_retries + 1):
            try:
                return self.executor.run_cell(
                    key, checkpoint=ckpt if key.scen_i >= 0 else None)
            except Exception as e:      # noqa: BLE001 — isolate the cell
                err = e
                self._emit_metric(mf, {
                    "event": "cell_retry", "cell": key.slug,
                    "attempt": attempt + 1,
                    "max_attempts": self.max_retries + 1,
                    "error": repr(e)})
                if attempt < self.max_retries:
                    time.sleep(self.retry_backoff_s * (2 ** attempt))
        self._emit_metric(mf, {
            "event": "cell_error", "cell": key.slug, "index": key.index,
            "attempts": self.max_retries + 1, "error": repr(err)})
        return None

    def run(self, max_cells: int | None = None) -> bool:
        """Execute remaining cells in order; True when the job is done.

        Completed cells are loaded (after sha256 verification — a
        corrupt npz is quarantined and recomputed), not re-run; the
        streaming CSV and ``metrics.jsonl`` are rewritten from their
        stored results (byte-identical CSV — the cell npz files are the
        source of truth) and then appended per fresh cell.  A cell whose
        execution keeps failing is skipped after the retry budget (see
        class docstring) — the job completes every other cell and
        returns False.  ``max_cells`` budgets the number of *executed*
        cells before returning: the knob that interrupts a job on
        purpose.
        """
        executed = 0
        failed = 0
        with self._lock:
            self._done, self._in_flight, self._walls = 0, None, []
        with open(self.csv_path, "w") as f, \
                open(self.metrics_path, "w") as mf:
            self._emit_metric(mf, {
                "event": "job_start", "job_id": self.job_id,
                "total": len(self.cells),
                "lanes_per_cell": len(self.executor.points)})
            f.write(",".join(CampaignResult.CSV_HEADER) + "\n")
            for key in self.cells:
                path = self._cell_path(key)
                if os.path.exists(path):
                    cached = self._load_cell(key)
                    if cached is not None:
                        self._append_csv(f, cached)
                        with self._lock:
                            self._done += 1
                            done = self._done
                        self._emit_metric(mf, self._cell_metric(
                            key, done=done, cached=True, wall_s=0.0))
                        continue
                    # corrupt: quarantined by _load_cell, recompute below
                    self._emit_metric(mf, {
                        "event": "cell_quarantined", "cell": key.slug,
                        "index": key.index,
                        "quarantine": os.path.join(
                            "cells", "quarantine", f"{key.slug}.npz")})
                if max_cells is not None and executed >= max_cells:
                    with self._lock:
                        done = self._done
                    self._emit_metric(mf, {
                        "event": "job_pause", "done": done,
                        "total": len(self.cells), "executed": executed})
                    return False
                with self._lock:
                    self._in_flight = key.slug
                ckpt = CellCheckpoint(self._ckpt_path(key))
                outcome = self._run_cell_with_retry(key, ckpt, mf)
                if outcome is None:     # poisoned: job completes the rest
                    failed += 1
                    with self._lock:
                        self._in_flight = None
                    continue
                _save_outcome(path, outcome)
                if outcome.telemetry is not None:
                    outcome.telemetry.save(self._tel_path(key))
                ckpt.clear()
                executed += 1
                with self._lock:
                    self._in_flight = None
                    self._done += 1
                    self._walls.append(outcome.wall_s)
                    done = self._done
                self._emit_metric(mf, self._cell_metric(
                    key, done=done, cached=False,
                    wall_s=outcome.wall_s))
                self._append_csv(f, outcome)
            self._emit_metric(mf, {
                "event": "job_done", "done": len(self.cells) - failed,
                "total": len(self.cells), "executed": executed,
                "failed": failed})
        self.tracer.flush()
        return failed == 0

    def close(self) -> None:
        """Close the job's trace stream (a job without one: nothing to
        do).  The stream stays a valid trace; a later job resumes it."""
        self.tracer.close()

    # ------------------------------------------------------------- #
    def start(self, max_cells: int | None = None) -> "CampaignJob":
        """Run the job on a daemon thread (async dispatch)."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(f"job {self.job_id} is already running")
        with self._lock:
            self._error = None

        def _target():
            try:
                self.run(max_cells)
            except BaseException as e:   # surfaced by wait()/status()
                with self._lock:
                    self._error = e

        self._thread = threading.Thread(
            target=_target, name=f"campaign-{self.job_id}", daemon=True)
        self._thread.start()
        return self

    def wait(self, timeout: float | None = None) -> JobStatus:
        """Join the background run; re-raises its error, if any."""
        if self._thread is not None:
            self._thread.join(timeout)
        if self._error is not None:
            raise self._error
        return self.status()

    # ------------------------------------------------------------- #
    def result(self) -> CampaignResult:
        """Assemble the CampaignResult from the per-cell checkpoints.

        Requires a complete job; points come back in canonical order, so
        the result is interchangeable with a ``run_campaign`` return.
        """
        points: list[CampaignPoint] = []
        wall: dict[tuple, float] = {}
        total = 0.0
        for key in self.cells:
            path = self._cell_path(key)
            if not os.path.exists(path):
                raise RuntimeError(
                    f"job {self.job_id} incomplete: cell {key.slug} has "
                    f"no checkpoint (run() or resume first)")
            outcome = _load_outcome(path, key)
            points.extend(self.executor.cell_points(outcome))
            wall[key.wall_key(self.spec)] = outcome.wall_s
            total += outcome.wall_s
        return CampaignResult(spec=self.spec, points=points,
                              wall_clock_s=wall, total_wall_clock_s=total)


def run_campaign_service(spec: CampaignSpec, *, root: str = DEFAULT_ROOT,
                         job_id: str | None = None,
                         bidor_tables=None, plan_cache="shared",
                         resume: bool = True,
                         max_cells: int | None = None,
                         verbose: bool = False,
                         trace: bool = False, device=None):
    """Run (or resume) a campaign job to completion and return its
    :class:`CampaignResult`; with ``max_cells`` set the job may stop
    early, returning ``(None, job)`` — callers re-invoke to continue.
    ``device`` defaults to the card; ``"cpu"`` runs the plain path.

    Returns ``(result | None, job)``.
    """
    job = CampaignJob(spec, root=root, job_id=job_id,
                      bidor_tables=bidor_tables, plan_cache=plan_cache,
                      resume=resume, verbose=verbose, trace=trace,
                      device=device)
    complete = job.run(max_cells)
    return (job.result() if complete else None), job
