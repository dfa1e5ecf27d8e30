"""The port's trace and report planes (``repro_torch.obs.trace``,
``obs.log``, ``obs.report``) and the control plane's tracing, held
against the reference's where it has one.

* ``TraceWriter``: round trip, schema, an unterminated stream that still
  reads (kill safety), appending on resume;
* ``EventLog``: quiet, verbose, and forwarding every event to a tracer;
* ``run_controlled(tracer=...)`` on the reference's obs test run emits
  the reference's event names in the reference's order, and a traced run
  gives the same results as an untraced one;
* ``render_job`` on a small job's telemetry, trace and metrics.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
import repro.noc as jnoc  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.noc as tnoc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.noc import (Algo, CampaignSpec, LinkFail,  # noqa: E402
                             ReplanConfig, Scenario, SimConfig,
                             run_campaign_service, run_controlled)
from repro_torch.obs import (NULL_LOG, EventLog, TraceWriter,  # noqa: E402
                             read_trace, validate_events)
from repro_torch.obs.report import load_metrics, render_job  # noqa: E402

LINK01 = ((0, 1), (1, 0))
SCALARS = ("injected_flits", "ejected_flits", "in_flight_flits",
           "reorder_value", "meas_cycles", "saturated", "avg_latency",
           "max_latency", "throughput", "offered", "lcv", "p50_latency",
           "p90_latency", "p99_latency", "link_load_max")


def test_trace_writer_round_trip_schema_and_kill_safety(tmp_path):
    path = str(tmp_path / "t" / "trace.jsonl")
    w = TraceWriter(path)
    w.instant("drift_detected", cat="ctrl", args={"cycle": 100})
    w.counter("drift_tv", {"tv": 0.12}, cat="ctrl")
    t0 = w.now_us()
    w.complete("replan", t0, 1234.5, cat="ctrl", args={"trigger": "fault"})
    with w.span("build", cat="plan", args={"nodes": 9}):
        pass
    with pytest.raises(RuntimeError):
        with w.span("boom", cat="plan"):
            raise RuntimeError("x")
    # no close(): the stream parses as written
    events = read_trace(path)
    assert [e["name"] for e in events] == [
        "drift_detected", "drift_tv", "replan", "build", "boom"]
    assert validate_events(events) == []
    assert events[2]["dur"] == 1234.5
    assert events[4]["args"]["error"] is True
    with open(path) as f:
        raw = f.read()
    assert raw.startswith("[\n")
    assert json.loads(raw.rstrip().rstrip(",") + "]") == events
    # the reference's reader takes the port's stream, event for event
    assert jtrace.read_trace(path) == events
    w.close()
    # appending (a resumed job) keeps one valid array
    w2 = TraceWriter(path)
    w2.instant("resumed", cat="log")
    w2.close()
    assert [e["name"] for e in read_trace(path)][-1] == "resumed"
    assert validate_events([{"ph": "X", "ts": 1, "pid": "p"}])
    assert validate_events([{"name": "c", "ph": "C", "ts": 1, "pid": "p"}])
    assert validate_events([{"name": "q", "ph": "Q", "ts": "x", "pid": "p"}])


def test_event_log_quiet_verbose_and_forwarding(tmp_path, capsys):
    EventLog(verbose=False).event("replan", "should not print", cycle=1)
    NULL_LOG.event("replan", cycle=2)
    assert capsys.readouterr().out == ""

    path = str(tmp_path / "trace.jsonl")
    w = TraceWriter(path)
    loud = EventLog(verbose=True, tracer=w)
    loud.event("replan", "ctrl[x] replan @ 100", cycle=100)
    loud.event("cell_done", cell="c0", wall_s=1.5)   # default message
    w.close()
    out = capsys.readouterr().out
    assert "ctrl[x] replan @ 100" in out
    assert "cell_done" in out and "cell=c0" in out
    events = read_trace(path)
    assert [e["name"] for e in events] == ["replan", "cell_done"]
    assert events[0]["args"]["cycle"] == 100
    assert events[1]["cat"] == "log" and events[1]["ph"] == "i"

    # a quiet log still forwards; a stream of its own takes the lines
    path2 = str(tmp_path / "quiet.jsonl")
    w = TraceWriter(path2)
    EventLog(tracer=w).event("hot_swap", cat="ctrl")
    w.close()
    assert capsys.readouterr().out == ""
    assert [(e["name"], e["cat"]) for e in read_trace(path2)] == [
        ("hot_swap", "ctrl")]
    with open(tmp_path / "out.txt", "w") as f:
        EventLog(verbose=True, stream=f).event("x", y=1)
    assert (tmp_path / "out.txt").read_text() == "x y=1\n"


def _linkfail(noc, core, policy, tracer=None, **kw):
    """The reference obs test's run: 3x3, transpose, a link failure at
    400, telemetry on."""
    topo = core.mesh2d(3, 3)
    tm = core.traffic.transpose(topo)
    cfg = noc.SimConfig(algo=noc.Algo.BIDOR, cycles=1200, warmup=200,
                        drain=200, injection_rate=0.25, telemetry=True,
                        tel_slots=12)
    scen = noc.Scenario("fail", events=(noc.LinkFail(400, LINK01),),
                        policy=policy, replan=noc.ReplanConfig(epoch=200))
    return noc.run_controlled(topo, tm, cfg, scen, rates=[0.25], seeds=[0],
                              tracer=tracer, **kw)


@pytest.fixture(scope="module")
def ref_trace(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "trace.jsonl")
    w = jtrace.TraceWriter(path)
    with reference():
        topo = jcore.mesh2d(3, 3)
        plan = jcore.build_plan(topo, jcore.traffic.transpose(topo))
        _linkfail(jnoc, jcore, "online", tracer=w, bidor_table=plan.table,
                  nrank0=plan.nrank)
    w.close()
    return plan, jtrace.read_trace(path)


def _port_linkfail(plan, policy, tracer=None):
    table = convert.plan_from_numpy(plan.table.choice,
                                    plan.table.port_tables)
    return _linkfail(tnoc, tcore, policy, tracer=tracer, bidor_table=table,
                     nrank0=convert.nrank_result(plan.nrank), device="cpu")


def test_controlled_trace_matches_reference(tmp_path, ref_trace):
    plan, want = ref_trace
    path = str(tmp_path / "trace.jsonl")
    w = TraceWriter(path)
    res = _port_linkfail(plan, "online", tracer=w)
    w.close()
    events = read_trace(path)
    assert validate_events(events) == []
    assert [e["name"] for e in events] == [e["name"] for e in want]
    assert [e["ph"] for e in events] == [e["ph"] for e in want]
    assert [e.get("cat") for e in events] == [e.get("cat") for e in want]
    for got, ref in zip(events, want):
        if got["name"] in ("epoch", "LinkFail", "hot_swap", "replan"):
            keep = {"t0", "t1", "cycle", "scenario", "policy", "trigger",
                    "iterations", "unroutable", "bw_scale", "warm"}
            assert ({k: v for k, v in got.get("args", {}).items()
                     if k in keep}
                    == {k: v for k, v in ref.get("args", {}).items()
                        if k in keep}), got["name"]
    (rp,) = [e for e in events if e["name"] == "replan"]
    assert rp["ph"] == "X" and rp["dur"] > 0
    assert rp["args"]["trigger"] == "fault" and rp["args"]["iterations"] >= 1
    (lf,) = [e for e in events if e["name"] == "LinkFail"]
    assert lf["ts"] <= rp["ts"] + rp["dur"]
    # the fault-aware bandwidth behind the telemetry's loads
    tel = res.telemetry
    c01 = tcore.mesh2d(3, 3).channel_index(0, 1)
    starts = tel.slot_starts()
    assert (tel.bw[starts < 400, c01] > 0).all()
    assert (tel.bw[starts >= 400, c01] == 0).all()


def test_run_without_a_tracer_is_unchanged(tmp_path, ref_trace):
    plan = ref_trace[0]
    w = TraceWriter(str(tmp_path / "t.jsonl"))
    a = _port_linkfail(plan, "online", tracer=w)
    w.close()
    b = _port_linkfail(plan, "online")
    assert [dataclasses.astuple(x) for x in a.replans] == [
        dataclasses.astuple(x) for x in b.replans]
    assert np.array_equal(a.link_peak, b.link_peak)
    for ra, rb in zip(a.results, b.results):
        for f in SCALARS:
            assert getattr(ra, f) == getattr(rb, f), f
    for arr in ("chan", "counts", "cycles", "lat", "qocc", "bw"):
        assert np.array_equal(getattr(a.telemetry, arr),
                              getattr(b.telemetry, arr)), arr


def test_render_job(tmp_path):
    """A small traced job with telemetry on, a stale and an online
    scenario: the report's three planes."""
    topo = tcore.mesh2d(3, 3)
    spec = CampaignSpec(
        topo=topo, algos=(Algo.BIDOR,), patterns=("transpose",),
        rates=(0.25,), seeds=(0,),
        base=SimConfig(cycles=600, warmup=100, drain=100, telemetry=True,
                       tel_slots=6),
        scenarios=tuple(Scenario(p, events=(LinkFail(200, LINK01),),
                                 policy=p, replan=ReplanConfig(epoch=100))
                        for p in ("stale", "online")))
    res, job = run_campaign_service(spec, root=str(tmp_path), job_id="obs",
                                    trace=True, device="cpu")
    job.close()
    assert res is not None
    out = str(tmp_path / "report")
    summary = render_job(job.dir, out)
    assert summary["cells_done"] == summary["cells_total"] == 2
    assert summary["telemetry_cells"] == 2 and summary["replans"] >= 1
    assert summary["traj_rows"] == 2 * 6
    with open(os.path.join(out, "trajectories.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0].startswith("cell,topo,pattern,algo,scenario,lane,slot")
    assert len(rows) == 1 + summary["traj_rows"]
    with open(os.path.join(out, "replan_timeline.csv")) as f:
        timeline = f.read()
    assert "replan" in timeline and "cell" in timeline
    with open(os.path.join(out, "report.md")) as f:
        report = f.read()
    assert report.startswith(f"# Flight-recorder report: {job.job_id}")
    assert "- cells: 2/2 done" in report and "## Replans" in report
    assert "plan cache:" in report
    m = load_metrics(job.metrics_path)
    assert m[0]["event"] == "job_start" and m[-1]["event"] == "job_done"
    # a torn last line ends the stream there
    with open(job.metrics_path, "a") as f:
        f.write('{"event": "cell", "do')
    assert load_metrics(job.metrics_path) == m
