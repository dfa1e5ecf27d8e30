"""The port's campaign jobs against the reference service's: kill and
resume after every cell gives the same ``results.csv`` bytes as an
uninterrupted port job and as the reference's job of the same spec, and
a job on a warm plan cache builds no plan."""

import numpy as np
import pytest

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
import repro.noc as jnoc  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.noc as tnoc  # noqa: E402
from repro_torch.noc import run_campaign_service  # noqa: E402

LINK01 = ((0, 1), (1, 0))
SCALARS = ("injected_flits", "ejected_flits", "in_flight_flits",
           "reorder_value", "meas_cycles", "saturated", "avg_latency",
           "max_latency", "throughput", "offered", "lcv", "p50_latency",
           "p90_latency", "p99_latency", "link_load_max")


def service_spec(core, noc, **kw):
    """``tests/test_service.py``'s spec: 3x3, XY and BiDOR, a calm and a
    link-failure scenario, 1 200 cycles."""
    topo = core.mesh2d(3, 3)
    d = dict(
        topo=topo, algos=(noc.Algo.XY, noc.Algo.BIDOR),
        patterns=(("uni", core.traffic.uniform(topo)),), rates=(0.1, 0.3),
        seeds=(0,), base=noc.SimConfig(cycles=1200, warmup=300, drain=100),
        scenarios=(noc.Scenario("calm"),
                   noc.Scenario("fail", events=(noc.LinkFail(600, LINK01),),
                                policy="oracle",
                                replan=noc.ReplanConfig(epoch=400))))
    d.update(kw)
    return noc.CampaignSpec(**d)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _points_identical(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        assert (p.algo.name, p.pattern, p.rate, p.seed, p.scenario,
                p.topo) == (q.algo.name, q.pattern, q.rate, q.seed,
                            q.scenario, q.topo)
        for f in SCALARS:
            assert getattr(p.result, f) == getattr(q.result, f), f
        assert np.array_equal(p.result.node_load, q.result.node_load)


def test_kill_and_resume_matches_the_reference_service(tmp_path):
    spec = service_spec(tcore, tnoc)
    root = str(tmp_path / "port")
    runs = 0
    while True:
        res, job = run_campaign_service(spec, root=root, job_id="itr",
                                        max_cells=1, device="cpu")
        runs += 1
        assert runs <= 8, "the job does not converge"
        if res is not None:
            break
    assert runs == len(job.cells)          # one executed cell a run
    fres, fjob = run_campaign_service(spec, root=root, job_id="fresh",
                                      device="cpu")
    got = _read(job.csv_path)
    assert got == _read(fjob.csv_path)
    _points_identical(res.points, fres.points)
    _points_identical(res.points, job.result().points)
    # the fresh job planned nothing: the interrupted job's plans served it
    assert fjob.plan_cache.stats.device_builds == 0
    with reference():
        jres, jjob = jnoc.run_campaign_service(
            service_spec(jcore, jnoc), root=str(tmp_path / "ref"),
            job_id="ref")
    assert got == _read(jjob.csv_path)
    assert job.fingerprint == jjob.fingerprint
    for p, q in zip(res.points, jres.points):
        for f in ("injected_flits", "ejected_flits", "in_flight_flits",
                  "reorder_value", "meas_cycles", "saturated"):
            assert getattr(p.result, f) == getattr(q.result, f), f


def test_warm_plan_cache_skips_every_plan_build(tmp_path, monkeypatch):
    """A re-run against the warm shared cache plans nothing: the planner
    never reaches its possibility pass; its cells are the cold run's."""
    from repro_torch.core import plan_fast

    calls = []
    real = plan_fast.possibility_v

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(plan_fast, "possibility_v", counting)
    spec = service_spec(tcore, tnoc, algos=(tnoc.Algo.BIDOR,), scenarios=(),
                        base=tnoc.SimConfig(cycles=400, warmup=100))
    cold, cjob = run_campaign_service(spec, root=str(tmp_path),
                                      job_id="cold", device="cpu")
    assert calls and cjob.plan_cache.stats.stores > 0
    calls.clear()
    warm, wjob = run_campaign_service(spec, root=str(tmp_path),
                                      job_id="warm", device="cpu")
    assert calls == []
    assert wjob.plan_cache.stats.as_dict() == {
        "hits": 1, "misses": 0, "stores": 0, "device_builds": 0}
    _points_identical(cold.points, warm.points)
