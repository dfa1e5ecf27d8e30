"""The reference's three service stages at ``BENCH_QUICK`` lengths
through the port's ``run_campaign_service`` on the CPU, row for row
against ``tests/goldens/service_4x4.json`` (what ``chip_smoke.py`` holds
the card to), and the chaos stage's plan and schedules against the
reference's."""

import os
import sys

import numpy as np
import pytest

from test_torch_oracle import load_golden, reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.noc as tnoc  # noqa: E402
from repro_torch.noc import run_campaign_service  # noqa: E402
from repro_torch.noc.service import _event_desc  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

GOLDEN = load_golden("service_4x4.json")["specs"]


def test_chaos_plan_matches_reference():
    """The chaos stage's BiDOR table (``build_plan`` on the uniform
    matrix, as the card makes it) is the reference's."""
    topo = tcore.mesh2d(4, 4)
    want = np.asarray(GOLDEN["chaos"]["choice"], np.int8)
    plan = tcore.build_plan(topo, tcore.traffic.uniform(topo), device="cpu")
    assert np.array_equal(plan.table.choice, want)
    with reference():
        jt = jcore.mesh2d(4, 4)
        ref = jcore.build_plan(jt, jcore.traffic.uniform(jt))
    assert np.array_equal(ref.table.choice, want)


@pytest.mark.parametrize("name", ["campaign_service", "chaos",
                                  "obs_report"])
def test_quick_rows_match_golden(tmp_path, name):
    spec = chip_smoke.service_specs(tcore, tnoc, quick=True)[name]
    want = GOLDEN[name]
    assert tnoc.spec_fingerprint(spec) == want["fingerprint"]
    tables = None
    if name == "chaos":
        assert [[_event_desc(e) for e in s.events]
                for s in spec.scenarios] == want["schedules"]
        tables = {"uniform": np.asarray(want["choice"], np.int8)}
    res, job = run_campaign_service(spec, root=str(tmp_path), job_id=name,
                                    bidor_tables=tables, device="cpu")
    assert res is not None
    with open(job.csv_path) as f:
        assert f.read().splitlines() == want["rows"]
    assert job.plan_cache.stats.stores > 0      # a cold job: plans stored
