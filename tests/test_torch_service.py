"""The port's campaign service (``repro_torch.noc.service``): job keys
against the reference's, the refusal of a foreign spec, and the golden of
the reference's three service stages that the card is held to.

* ``spec_fingerprint`` equals the reference's string for the same spec
  (a scenario spec with a drift matrix, a topology axis, telemetry on),
  and the observability fields stay out of it;
* ``tests/goldens/service_4x4.json`` holds the reference's
  ``results.csv`` rows of ``bench_campaign_service``, ``bench_chaos``
  and ``bench_obs_report`` at ``BENCH_QUICK`` lengths, each spec's
  fingerprint, the chaos stage's plan and its seeded schedules.  It is
  regenerated here in memory and held against the committed file;
  ``PYTHONPATH=src python tests/test_torch_service.py`` rewrites it
  (byte-stable).  ``chip_smoke.py`` runs the same specs on the card
  against it, and ``tests/test_torch_service_rows.py`` on the CPU.
"""

import copy
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import pytest

from test_torch_oracle import GOLDEN_DIR, reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
import repro.noc as jnoc  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.noc as tnoc  # noqa: E402
from repro_torch.noc import CampaignJob, spec_fingerprint  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

GOLDEN_NAME = "service_4x4.json"
GOLDEN_PATH = os.path.join(GOLDEN_DIR, GOLDEN_NAME)
LINK01 = ((0, 1), (1, 0))


def fingerprint_specs(core, noc) -> dict:
    """Specs whose job keys the two packages must agree on."""
    t = core.mesh2d(3, 3)
    base = noc.SimConfig(cycles=1200, warmup=300, drain=100)
    drift = noc.Scenario(
        "dyn", events=(noc.LinkFail(600, LINK01, bw_scale=0.25),
                       noc.TrafficDrift(900, core.traffic.tornado(t),
                                        rate_scale=0.5),
                       noc.LinkRecover(1000, LINK01)),
        policy="online", replan=noc.ReplanConfig(epoch=300, max_shed=0.4))
    return {
        "scenario_drift": noc.CampaignSpec(
            topo=t, algos=(noc.Algo.XY, noc.Algo.BIDOR),
            patterns=("uniform", ("mine", core.traffic.transpose(t))),
            rates=(0.1, 0.3), seeds=(0, 1), base=base,
            scenarios=(noc.Scenario("calm"), drift)),
        "topos": noc.CampaignSpec(
            topo=None, topos=(t, core.torus(3, 3),
                              core.fault_region_mesh(4, 4, (1, 1, 1, 2))),
            algos=(noc.Algo.XY,), patterns=("uniform",), rates=(0.2,),
            base=base, chunk=300),
        "telemetry": noc.CampaignSpec(
            topo=t, algos=(noc.Algo.BIDOR,), patterns=("uniform",),
            rates=(0.2,), sat_occupancy=0.8,
            base=base.replace(telemetry=True, tel_slots=6, watchdog=True)),
    }


@pytest.mark.parametrize("name", ["scenario_drift", "topos", "telemetry"])
def test_spec_fingerprint_matches_reference(name):
    want = jnoc.spec_fingerprint(fingerprint_specs(jcore, jnoc)[name])
    spec = fingerprint_specs(tcore, tnoc)[name]
    assert spec_fingerprint(spec) == want
    assert spec_fingerprint(copy.deepcopy(spec)) == want


def test_fingerprint_leaves_out_the_observability_fields():
    """Telemetry, its knobs and the kernel layout change no result, so a
    job resumes with them switched; a result-bearing field changes the
    key."""
    spec = fingerprint_specs(tcore, tnoc)["scenario_drift"]
    key = spec_fingerprint(spec)
    for kw in (dict(telemetry=True), dict(tel_slots=99), dict(tel_epoch=7),
               dict(tel_occ_bins=3), dict(sim_tile_nodes=3)):
        other = dataclasses.replace(spec, base=spec.base.replace(**kw))
        assert spec_fingerprint(other) == key, kw
    other = dataclasses.replace(spec, base=spec.base.replace(watchdog=True))
    assert spec_fingerprint(other) != key


def test_job_refuses_a_foreign_spec(tmp_path):
    spec = fingerprint_specs(tcore, tnoc)["telemetry"]
    CampaignJob(spec, root=str(tmp_path), job_id="j", device="cpu")
    other = dataclasses.replace(spec, rates=(0.2, 0.4))
    assert spec_fingerprint(other) != spec_fingerprint(spec)
    with pytest.raises(ValueError, match="different campaign"):
        CampaignJob(other, root=str(tmp_path), job_id="j", device="cpu")


def test_default_root_is_the_ports_own():
    """The reference's root holds its own cells and plan entries (W
    summed in float32): the port's jobs never share it."""
    from repro.noc import service as jservice
    from repro_torch.noc import service as tservice

    assert tservice.DEFAULT_ROOT == os.path.join("artifacts",
                                                 "campaigns_torch")
    assert tservice.DEFAULT_ROOT != jservice.DEFAULT_ROOT


def golden_text() -> str:
    """The golden as the reference computes it, serialised byte-stably."""
    from repro.noc.service import _event_desc

    out = {}
    with reference(), tempfile.TemporaryDirectory() as root:
        specs = chip_smoke.service_specs(jcore, jnoc, quick=True)
        for name, spec in specs.items():
            rec = {"fingerprint": jnoc.spec_fingerprint(spec),
                   "cycles": spec.base.cycles}
            tables = None
            if name == "chaos":
                plan = jcore.build_plan(spec.topo,
                                        jcore.traffic.uniform(spec.topo))
                tables = {"uniform": plan.table.choice}
                rec["choice"] = np.asarray(plan.table.choice).tolist()
                rec["schedules"] = [[_event_desc(e) for e in s.events]
                                    for s in spec.scenarios]
            res, job = jnoc.run_campaign_service(
                spec, root=root, job_id=name, bidor_tables=tables)
            assert res is not None
            with open(job.csv_path) as f:
                rec["rows"] = f.read().splitlines()
            out[name] = rec
    return json.dumps({
        "description": (
            "The reference's results.csv rows of benchmarks/run.py's "
            "bench_campaign_service, bench_chaos and bench_obs_report at "
            "BENCH_QUICK lengths (1200, 2600 and 900 cycles) through "
            "run_campaign_service on the CPU, each spec's fingerprint, the "
            "chaos stage's build_plan choice table and its seeded "
            "schedules (service._event_desc). Written by the JAX "
            "reference: python tests/test_torch_service.py"),
        "specs": out}, indent=1, sort_keys=True) + "\n"


def test_golden_is_the_references():
    """The committed golden is what the reference writes today, byte for
    byte, and its specs are the port's (equal fingerprints)."""
    with open(GOLDEN_PATH) as f:
        committed = f.read()
    assert golden_text() == committed
    golden = json.loads(committed)["specs"]
    for name, spec in chip_smoke.service_specs(tcore, tnoc,
                                               quick=True).items():
        assert spec_fingerprint(spec) == golden[name]["fingerprint"]


if __name__ == "__main__":
    with open(GOLDEN_PATH, "w") as f:
        f.write(golden_text())
    print(f"wrote {GOLDEN_PATH}", file=sys.stderr)
