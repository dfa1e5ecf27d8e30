"""The port's QUICK topology sweep (``python -m
repro_torch.bench.topo_sweep``) against the reference's committed
``artifacts/bench/topo_sweep.csv``, row for row at its printed precision,
on the express and fault-region meshes (the torus's rows are held in
``test_torch_zoo.py``, the concentrated mesh's in
``test_torch_zoo_multipod.py``); and the sweep's two claims on rows
carried in from the CSV."""

import os

import pytest

from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

pytest.importorskip("jax")

from test_torch_zoo import hold_sweep_rows  # noqa: E402

from repro_torch.bench import topo_sweep  # noqa: E402


@pytest.mark.parametrize("name", ["express_8x8i2",
                                  "fault_region_6x6_r2.2.3.3"])
def test_sweep_rows(name):
    hold_sweep_rows(name)


def test_committed_csv_is_read_by_column_name():
    """The committed file predates the ``workload`` column: 18 fields
    against the campaign's 19; the rows are read by name."""
    from repro_torch.noc.campaign import CampaignResult

    with open(topo_sweep.COMMITTED_CSV) as f:
        header = f.readline().strip().split(",")
    assert len(header) == 18 and "workload" not in header
    assert len(CampaignResult.CSV_HEADER) == 19
    rows = topo_sweep.read_rows()
    assert len(rows) == 32
    assert {k[0] for k in rows} == {t.name for t in topo_sweep.zoo()}
    assert set(topo_sweep.COMPARED) <= set(header)


def test_the_port_writes_nothing_under_artifacts(tmp_path, monkeypatch):
    """``main`` prints its rows or writes them to ``--out``; it reads the
    committed CSV and leaves it as it is."""
    path = os.path.abspath(topo_sweep.COMMITTED_CSV)
    before = os.stat(path).st_mtime_ns
    out = tmp_path / "rows.csv"
    monkeypatch.setattr(topo_sweep, "run_campaign", _from_csv)
    assert topo_sweep.main(["--device", "cpu", "--out", str(out)]) == 0
    assert out.read_text().splitlines()[0].split(",")[:3] == [
        "topo", "scenario", "pattern"]
    assert os.stat(path).st_mtime_ns == before


def _from_csv(spec, device=None):
    """A CampaignResult whose points carry the committed CSV's values, so
    ``main`` runs its checks with no simulation."""
    from repro_torch.noc import Algo
    from repro_torch.noc.campaign import CampaignPoint, CampaignResult
    from repro_torch.noc.simconfig import SimResult
    import numpy as np

    rows = topo_sweep.read_rows()
    points = []
    for (topo, scen, pat, algo, rate, seed), r in rows.items():
        res = SimResult(
            algo=Algo[algo], injection_rate=float(rate),
            throughput=float(r["throughput"]), offered=float(r["offered"]),
            avg_latency=float(r["avg_lat"]), max_latency=float(r["max_lat"]),
            node_load=np.zeros(1), lcv=float(r["lcv"]),
            reorder_value=int(r["reorder"]), ejected_flits=0,
            injected_flits=0, in_flight_flits=0, seed=int(seed),
            meas_cycles=int(r["meas_cycles"]),
            saturated=bool(int(r["saturated"])),
            p50_latency=float(r["p50_lat"]), p90_latency=float(r["p90_lat"]),
            p99_latency=float(r["p99_lat"]),
            link_load_max=float(r["link_load_max"]))
        points.append(CampaignPoint(algo=Algo[algo], pattern=pat,
                                    rate=float(rate), seed=int(seed),
                                    result=res, scenario=scen, topo=topo))
    return CampaignResult(spec=spec, points=points, wall_clock_s={},
                          total_wall_clock_s=0.0)
