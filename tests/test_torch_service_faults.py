"""The port's campaign jobs under faults and observation, after the
reference's ``tests/test_service.py``: live ``status()`` during
``start()`` (also under eight polling threads), a corrupt cell
quarantined and recomputed, a poisoned cell isolated, a corrupt
mid-cell snapshot set aside, telemetry saved per cell, the metrics
stream, and the job's trace (one writer shared by eight threads)."""

import os
import sys
import threading
import time

import numpy as np
import pytest

from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

import repro_torch.core as tcore  # noqa: E402
from repro_torch.noc import (Algo, CampaignJob, CampaignSpec,  # noqa: E402
                             CellCheckpoint, LinkFail, ReplanConfig,
                             Scenario, SimConfig, run_campaign,
                             run_campaign_service, spec_fingerprint)
from repro_torch.obs.report import load_metrics  # noqa: E402
from repro_torch.obs.trace import (TraceWriter, read_trace,  # noqa: E402
                                   validate_events)

TOPO = tcore.mesh2d(3, 3)
UNI = tcore.traffic.uniform(TOPO)
BASE = SimConfig(cycles=400, warmup=100, drain=50)
LINK01 = ((0, 1), (1, 0))


def _spec(**kw):
    d = dict(topo=TOPO, algos=(Algo.XY, Algo.BIDOR),
             patterns=(("uni", UNI),), rates=(0.1, 0.3), seeds=(0,),
             base=BASE,
             scenarios=(Scenario("calm"),
                        Scenario("fail", events=(LinkFail(200, LINK01),),
                                 policy="oracle",
                                 replan=ReplanConfig(epoch=100))))
    d.update(kw)
    return CampaignSpec(**d)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _run(spec, root, job_id, **kw):
    return run_campaign_service(spec, root=str(root), job_id=job_id,
                                device="cpu", **kw)


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """One uninterrupted job of ``_spec()``: (root, result, CSV bytes)."""
    root = tmp_path_factory.mktemp("clean")
    res, job = _run(_spec(), root, "ref")
    return root, res, _read(job.csv_path)


def test_status_is_live_during_start(tmp_path):
    job = CampaignJob(_spec(), root=str(tmp_path), job_id="bg", device="cpu")
    seen_done, seen_flight = [], set()
    job.start()
    with pytest.raises(RuntimeError, match="already running"):
        job.start()
    while True:
        st = job.status()
        assert 0 <= st.done_cells <= st.total_cells and st.error is None
        seen_done.append(st.done_cells)
        if st.in_flight is not None:
            seen_flight.add(st.in_flight)
        if not st.running:
            break
        time.sleep(0.01)
    final = job.wait(timeout=300)
    assert final.complete and final.done_cells == len(job.cells)
    assert seen_done == sorted(seen_done)
    assert seen_flight and seen_flight <= {k.slug for k in job.cells}
    job.start()                     # a second start after completion
    assert job.wait(timeout=300).complete

    # a cell that always fails: retries spent, cell_error, no re-raise
    boom = CampaignJob(_spec(rates=(0.2,)), root=str(tmp_path),
                       job_id="boom", max_retries=0, device="cpu")

    def explode(key, checkpoint=None):
        raise RuntimeError("cell exploded")

    boom.executor.run_cell = explode
    boom.start()
    st = boom.wait(timeout=300)
    assert not st.running and not st.complete and st.done_cells == 0
    errs = [m for m in load_metrics(boom.metrics_path)
            if m["event"] == "cell_error"]
    assert len(errs) == len(boom.cells)
    assert all("cell exploded" in m["error"] for m in errs)

    # a failure of run() itself re-raises from wait() and shows in status
    crash = CampaignJob(_spec(rates=(0.2,)), root=str(tmp_path),
                        job_id="crash", device="cpu")
    crash._run_cell_with_retry = None
    crash.start()
    with pytest.raises(TypeError):
        crash.wait(timeout=300)
    st = crash.status()
    assert st.error is not None and not st.running


def test_status_under_many_pollers(tmp_path):
    """Eight threads poll ``status()`` while the job runs on its own
    thread, the interpreter switching threads every microsecond: no
    poller sees the done count go back or an unknown in-flight cell, and
    the job completes."""
    job = CampaignJob(_spec(algos=(Algo.XY,), rates=(0.2,)),
                      root=str(tmp_path), job_id="stress", device="cpu")
    slugs = {k.slug for k in job.cells}
    seen = [[] for _ in range(8)]
    unknown = []
    stop = threading.Event()

    def poll(i):
        while not stop.is_set():
            st = job.status()
            seen[i].append(st.done_cells)
            if st.in_flight is not None and st.in_flight not in slugs:
                unknown.append(st.in_flight)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=poll, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        job.start()
        final = job.wait(timeout=300)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert final.complete and not final.running
    assert not unknown
    assert all(s == sorted(s) and s for s in seen)


def test_trace_writer_from_many_threads(tmp_path):
    """Eight threads write one stream at once: every event lands whole,
    once."""
    w = TraceWriter(str(tmp_path / "t.jsonl"))

    def emit(i):
        for j in range(200):
            w.instant("e", cat="stress", args={"t": i, "j": j})

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=emit, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
    finally:
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    w.close()
    events = read_trace(w.path)
    assert validate_events(events) == []
    assert sorted((e["args"]["t"], e["args"]["j"]) for e in events) == [
        (i, j) for i in range(8) for j in range(200)]


def test_corrupt_cell_is_quarantined_and_recomputed(tmp_path, clean):
    _, ref, want = clean
    res, job = _run(_spec(), tmp_path, "q")
    victim = job.cells[1]
    path = job._cell_path(victim)
    blob = _read(path)
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    res2, job2 = _run(_spec(), tmp_path, "q")
    quar = [m for m in load_metrics(job2.metrics_path)
            if m["event"] == "cell_quarantined"]
    assert [m["cell"] for m in quar] == [victim.slug]
    assert os.path.exists(os.path.join(job2.quarantine_dir,
                                       f"{victim.slug}.npz"))
    assert _read(job2.csv_path) == want
    _, job3 = _run(_spec(), tmp_path, "q")
    m3 = load_metrics(job3.metrics_path)
    assert not [m for m in m3 if m["event"] == "cell_quarantined"]
    assert all(m["cached"] for m in m3 if m["event"] == "cell")


def test_poisoned_cell_is_isolated(tmp_path, clean):
    want = clean[2]
    job = CampaignJob(_spec(), root=str(tmp_path), job_id="p",
                      max_retries=1, retry_backoff_s=0.0, device="cpu")
    victim = job.cells[0].slug
    real = job.executor.run_cell

    def flaky(key, checkpoint=None):
        if key.slug == victim:
            raise RuntimeError("poisoned cell")
        return real(key, checkpoint=checkpoint)

    job.executor.run_cell = flaky
    assert job.run() is False
    m = load_metrics(job.metrics_path)
    retries = [r for r in m if r["event"] == "cell_retry"]
    assert len(retries) == 2
    assert all(r["cell"] == victim and "poisoned" in r["error"]
               for r in retries)
    assert [r["cell"] for r in m if r["event"] == "cell_error"] == [victim]
    assert m[-1]["event"] == "job_done" and m[-1]["failed"] == 1
    assert {k.slug for k in job.completed_cells()} == {
        k.slug for k in job.cells} - {victim}
    res, job2 = _run(_spec(), tmp_path, "p")
    assert res is not None
    assert _read(job2.csv_path) == want


def test_corrupt_midcell_snapshot_is_set_aside(tmp_path, clean):
    """A snapshot that fails its sidecar or its parse is no snapshot: it
    moves to ``.corrupt`` and the cell starts from cycle 0 — the same
    results."""
    ck = CellCheckpoint(str(tmp_path / "c.npz"))
    ck.save({"a": np.arange(3)}, {"cycle": 7})
    assert os.path.exists(ck.path + ".sha256")
    arrays, meta = ck.load()
    assert meta == {"cycle": 7} and np.array_equal(arrays["a"], np.arange(3))
    with open(ck.path, "r+b") as f:
        f.write(b"xx")
    assert ck.load() is None
    assert os.path.exists(ck.path + ".corrupt")
    assert not os.path.exists(ck.path)
    assert not os.path.exists(ck.path + ".sha256")
    assert ck.load() is None
    ck.clear()

    # inside a job: garbage where the scenario cell's snapshot would be
    job = CampaignJob(_spec(), root=str(tmp_path), job_id="mid",
                      device="cpu")
    key = next(k for k in job.cells if k.scenario == "fail")
    with open(job._ckpt_path(key), "wb") as f:
        f.write(b"not an npz")
    assert job.run()
    assert os.path.exists(job._ckpt_path(key) + ".corrupt")
    assert not os.path.exists(job._ckpt_path(key))
    assert _read(job.csv_path) == clean[2]


def test_telemetry_saved_per_cell_and_metrics_stream(tmp_path, clean):
    """Telemetry rides the job as an npz a cell; a telemetry-on resume of
    a telemetry-off job keeps its cells (the fingerprint leaves the
    probes out); metrics record the pause and the resume."""
    base_on = BASE.replace(telemetry=True, tel_slots=6)
    spec_on = _spec(base=base_on)
    assert spec_fingerprint(spec_on) == spec_fingerprint(_spec())
    res, job = _run(_spec(), tmp_path, "t", max_cells=2)
    assert res is None
    m = load_metrics(job.metrics_path)
    assert m[0]["event"] == "job_start"
    assert m[-1]["event"] == "job_pause" and m[-1]["executed"] == 2
    cells = [r for r in m if r["event"] == "cell"]
    assert [r["done"] for r in cells] == [1, 2]
    assert all(r["wall_s"] > 0 and "lanes_per_s" in r for r in cells)

    res_on, job_on = _run(spec_on, tmp_path, "t")
    assert res_on is not None
    m = load_metrics(job_on.metrics_path)
    assert m[-1]["event"] == "job_done"
    cells = [r for r in m if r["event"] == "cell"]
    assert [r["cached"] for r in cells] == [True, True, False, False]
    assert all("plan_cache" in r for r in cells)
    for i, key in enumerate(job_on.cells):
        tel = job_on.cell_telemetry(key)
        if i < 2:
            assert tel is None              # ran with telemetry off
            continue
        assert tel.num_lanes == len(job_on.executor.points)
        assert tel.cycles.sum(axis=1).tolist() == [BASE.cycles] * 2
        assert tel.bw is not None
    assert _read(job_on.csv_path) == clean[2]
    # the blocking engine gives the same points
    ref = run_campaign(_spec(), device="cpu")
    assert [p.result.ejected_flits for p in ref.points] == [
        p.result.ejected_flits for p in res_on.points]
    # resume=False clears every artifact
    CampaignJob(spec_on, root=str(tmp_path), job_id="t", resume=False,
                device="cpu")
    assert all(job_on.cell_telemetry(k) is None for k in job_on.cells)
    assert not os.path.exists(job_on.metrics_path)


def test_job_trace_records_cells(tmp_path):
    spec = _spec(base=BASE.replace(telemetry=True, tel_slots=6))
    res, job = _run(spec, tmp_path, "tr", trace=True)
    job.close()
    assert res is not None
    events = read_trace(job.trace_path)
    assert validate_events(events) == []
    names = [e["name"] for e in events]
    assert names.count("cell") == len(job.cells)
    assert "LinkFail" in names and "replan" in names
    assert "build_plans_batched" in names and "epoch" in names
    assert {e["args"]["slug"] for e in events if e["name"] == "cell"} == {
        k.slug for k in job.cells}
    # a resumed traced job appends to the same stream
    _run(spec, tmp_path, "tr", trace=True)[1].close()
    again = read_trace(job.trace_path)
    assert len(again) == len(events) and validate_events(again) == []
