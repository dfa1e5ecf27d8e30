"""ML traffic on the port, on the CPU, against the JAX package.

The port derives its workloads from the reference's recorded post-SPMD
HLO (``tests/goldens/mltraffic/``); everything after the lowering is held
against the reference here: the flow matrices (real and randomized op
sets), the rank embedding, ``matrix_for`` (bit for bit), the npz files
both ways, the spec fingerprints, the stage's plans and refined tables,
and the workload campaign's rows at 200 cycles on the plain twin, also
through a ``CampaignJob`` interrupted mid-grid.  A fresh lowering of the
qwen2-moe decode phase in a subprocess gives the committed text, so the
recording cannot drift silently.  ``tests/goldens/mltraffic.json`` is the
reference's record for the card; ``tests/goldens/regen_torch.py``
rewrites it and the texts.
"""

import dataclasses
import gzip
import json
import os
import random
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from repro.analysis.hlo import CollectiveOp as RefOp  # noqa: E402
from repro.core import torus as ref_torus  # noqa: E402
from repro.noc import mltraffic as ref_ml  # noqa: E402
from repro_torch import noc  # noqa: E402
from repro_torch.analysis.hlo import CollectiveOp, collective_ops  # noqa: E402
from repro_torch.core import torus, traffic  # noqa: E402
from repro_torch.noc import mltraffic as ml  # noqa: E402
from test_torch_oracle import reference, torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
HLO_DIR = os.path.join(GOLDENS, "mltraffic")
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
NAMES = [s.name for s, _ in ml.STAGE_GRID]


def _regen():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "regen_torch", os.path.join(GOLDENS, "regen_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _golden() -> dict:
    with open(os.path.join(GOLDENS, "mltraffic.json")) as f:
        return json.load(f)


_CACHE = {}


def _workloads():
    """(port workloads, reference workloads), from the recorded texts."""
    if "wl" not in _CACHE:
        regen = _regen()
        port, ref = [], []
        for spec, _ in ml.STAGE_GRID:
            texts = ml.read_hlo(spec, HLO_DIR)
            port.append(ml.derive_from_hlo(spec, texts))
            rspec = ref_ml.WorkloadSpec(**dataclasses.asdict(spec))
            ref.append(regen.reference_workload(rspec, texts))
        _CACHE["wl"] = port, ref
    return _CACHE["wl"]


def _stage_plans():
    if "plans" not in _CACHE:
        _CACHE["plans"] = chip_smoke.mltraffic_plans(np, "cpu", HLO_DIR)
    return _CACHE["plans"]


# --------------------------------------------------------------------- #
# flows, embedding, matrices
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", NAMES)
def test_flows_match_reference_bit_for_bit(name):
    """Per phase and kind, the flow matrices equal the reference's, the
    totals too, and each matrix sums to its total (relative 1e-12)."""
    port, ref = _workloads()
    i = NAMES.index(name)
    a, b = port[i], ref[i]
    assert a.totals == b.totals and a.meta == b.meta
    assert list(a.flows) == list(b.flows) == list(a.spec.phases)
    for ph, kinds in b.flows.items():
        assert list(a.flows[ph]) == list(kinds)
        for kind, m in kinds.items():
            assert np.array_equal(a.flows[ph][kind], m), (ph, kind)
            tot = a.totals[ph][kind]
            assert abs(a.flows[ph][kind].sum() - tot) <= 1e-12 * tot
    assert np.array_equal(a.campaign_flows(), b.campaign_flows())


def _random_ops(rng, d, op_cls):
    """A randomized op set over ``d`` ranks (random kinds, sizes, counts
    and group partitions, permutes with random pairs), as ``op_cls``."""
    ops = []
    divisors = [g for g in range(1, d + 1) if d % g == 0]
    for i in range(rng.randint(1, 8)):
        kind = KINDS[rng.randrange(len(KINDS))]
        size = float(rng.randint(1, 1 << 20))
        count = float(rng.randint(1, 4))
        ranks = list(range(d))
        rng.shuffle(ranks)
        if kind == "collective-permute":
            ops.append(op_cls(name=f"op{i}", kind=kind, size_bytes=size,
                              wire_bytes=size, groups=(),
                              pairs=tuple(zip(ranks, ranks[1:])),
                              count=count))
            continue
        g = divisors[rng.randrange(len(divisors))]
        ops.append(op_cls(name=f"op{i}", kind=kind, size_bytes=size,
                          wire_bytes=size,
                          groups=tuple(tuple(ranks[j:j + g])
                                       for j in range(0, d, g)),
                          count=count))
    return ops


@pytest.mark.parametrize("seed", range(6))
def test_flows_of_random_op_sets_match_reference(seed):
    d = (2, 4, 6, 8)[seed % 4]
    ops = _random_ops(random.Random(seed), d, CollectiveOp)
    ref_ops = [RefOp(**dataclasses.asdict(o)) for o in ops]
    got = ml.collective_flows(ops, d)
    want = ref_ml.collective_flows(ref_ops, d)
    assert list(got) == list(want)
    for kind in want:
        assert np.array_equal(got[kind], want[kind]), kind


@pytest.mark.parametrize("topo_dims,mesh", [
    ((2, 4), (1, 8)), ((2, 4), (2, 4)), ((4, 2), (4, 2)), ((4, 4), (2, 4)),
    ((3, 3), (1, 9))])
def test_embed_ranks_matches_reference(topo_dims, mesh):
    """A (2, 4) mesh on torus(2, 4) goes axis for axis, and as
    ``node_id`` runs dim 0 fastest that is not the identity; a (1, 8)
    mesh on the same torus, and any mesh on a larger one, go flat."""
    got = ml.embed_ranks(torus(*topo_dims), mesh)
    want = ref_ml.embed_ranks(ref_torus(*topo_dims), mesh)
    assert np.array_equal(got, want) and got.dtype == want.dtype
    if tuple(topo_dims) == tuple(mesh) and mesh[0] > 1:
        assert not np.array_equal(got, np.arange(len(got)))
        assert sorted(got) == list(range(len(got)))


def test_embed_ranks_refuses_too_few_nodes():
    with pytest.raises(ValueError, match="cannot embed"):
        ml.embed_ranks(torus(2, 2), (1, 8))


@pytest.mark.parametrize("name", NAMES)
def test_matrix_for_matches_reference_bit_for_bit(name):
    port, ref = _workloads()
    i = NAMES.index(name)
    got = port[i].matrix_for(torus(2, 4))
    with reference():
        want = ref[i].matrix_for(ref_torus(2, 4))
    assert np.array_equal(got, np.asarray(want))
    assert abs(got.sum() - 1.0) < 1e-12 and not np.diag(got).any()
    assert np.array_equal(got, np.asarray(
        _golden()["workloads"][i]["matrix"]))


def test_matrix_of_a_2x4_mesh_embeds_axis_for_axis():
    """A (2, 4) workload on torus(2, 4): the reference's embedding."""
    port, ref = _workloads()
    flows = port[0].flows
    spec = dataclasses.replace(port[0].spec, data=2, model=4)
    rspec = ref_ml.WorkloadSpec(**dataclasses.asdict(spec))
    got = ml.MLWorkload(spec, flows, port[0].totals).matrix_for(torus(2, 4))
    with reference():
        want = ref_ml.MLWorkload(rspec, flows, port[0].totals).matrix_for(
            ref_torus(2, 4))
    assert np.array_equal(got, np.asarray(want))


def test_phase_flows_step_and_bwd_match_reference():
    """``step`` is ``train``; ``bwd`` is train − fwd, clipped at 0."""
    port, ref = _workloads()
    a, b = port[1], ref[1]
    assert np.array_equal(a.phase_flows("step"), b.phase_flows("train"))
    fwd = {"fwd": {"all-reduce": a.phase_flows("decode")}}
    flows = {**a.flows, **fwd}
    spec = dataclasses.replace(a.spec, phases=("fwd", "train", "decode"))
    rspec = ref_ml.WorkloadSpec(**dataclasses.asdict(spec))
    got = ml.MLWorkload(spec, flows, a.totals)
    want = ref_ml.MLWorkload(rspec, flows, a.totals)
    assert np.array_equal(got.phase_flows("bwd"), want.phase_flows("bwd"))
    assert np.array_equal(got.campaign_flows(), want.campaign_flows())
    with pytest.raises(KeyError, match="not derived"):
        a.phase_flows("fwd")


def test_zero_bytes_refused():
    port, _ = _workloads()
    flows = {"decode": {"all-reduce": np.zeros((8, 8))}}
    wl = ml.MLWorkload(dataclasses.replace(port[0].spec), flows, {})
    with pytest.raises(ValueError, match="zero collective bytes"):
        wl.matrix_for(torus(2, 4))


# --------------------------------------------------------------------- #
# specs, npz, the cache
# --------------------------------------------------------------------- #
def test_workload_spec_matches_reference():
    """Field for field: the fingerprints (the npz cache key) and names."""
    ref_fields = [f.name for f in dataclasses.fields(ref_ml.WorkloadSpec)]
    assert [f.name for f in dataclasses.fields(ml.WorkloadSpec)] == \
        ref_fields
    assert ml.DIRECT_PHASES == ref_ml.DIRECT_PHASES
    for spec, _ in ml.STAGE_GRID:
        rspec = ref_ml.WorkloadSpec(**dataclasses.asdict(spec))
        assert spec.fingerprint() == rspec.fingerprint()
        assert spec.name == rspec.name
    with pytest.raises(ValueError, match="unknown phases"):
        ml.WorkloadSpec("internlm2-1.8b", phases=("bwd",))


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_npz_loads_in_the_other_package(direction, tmp_path):
    port, ref = _workloads()
    src, dst = ((port[1], ref_ml.MLWorkload) if direction.startswith("port")
                else (ref[1], ml.MLWorkload))
    path = str(tmp_path / "w.npz")
    src.save(path)
    got = dst.load(path)
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(src.spec)
    assert got.totals == src.totals and got.meta == src.meta
    for ph, kinds in src.flows.items():
        for kind, m in kinds.items():
            assert np.array_equal(got.flows[ph][kind], m)
    with np.load(path) as z:          # no pickled object in the file
        assert z["__meta__"].dtype.kind == "U"


def test_derive_workload_serves_the_reference_named_cache(tmp_path):
    """A miss derives from the recorded HLO and stores the npz under the
    reference's name; a hit serves it with no HLO at hand; a phase never
    recorded names the regeneration command."""
    spec = ml.STAGE_GRID[0][0]
    cache = str(tmp_path / "cache")
    wl = ml.derive_workload(spec, hlo_dir=HLO_DIR, cache_dir=cache)
    stem = spec.name.replace("@", "_").replace("/", "-")
    path = os.path.join(cache, f"{stem}__{spec.fingerprint()[:10]}.npz")
    assert os.listdir(cache) == [os.path.basename(path)]
    again = ml.derive_workload(spec, hlo_dir=str(tmp_path / "none"),
                               cache_dir=cache)
    assert np.array_equal(again.campaign_flows(), wl.campaign_flows())
    with reference():
        ref = ref_ml.derive_workload(
            ref_ml.WorkloadSpec(**dataclasses.asdict(spec)), cache_dir=cache)
    assert np.array_equal(ref.campaign_flows(), wl.campaign_flows())
    other = dataclasses.replace(spec, phases=("train",))
    with pytest.raises(FileNotFoundError, match="regen_torch.py"):
        ml.derive_workload(other, hlo_dir=HLO_DIR)


def test_fresh_lowering_gives_the_committed_text(tmp_path):
    """The reference lowers the qwen2-moe decode phase again, in a fresh
    process on 8 host devices: the same stripped text, the same ops."""
    regen = _regen()
    spec = ml.STAGE_GRID[0][0]
    out = str(tmp_path / "fresh.hlo.gz")
    regen.lower_in_child(spec.name, "decode", out)
    with gzip.open(out, "rt") as f:
        fresh = f.read()
    committed = ml.read_hlo(spec, HLO_DIR)["decode"]
    assert [dataclasses.asdict(o) for o in collective_ops(fresh, 8)] == [
        dataclasses.asdict(o) for o in collective_ops(committed, 8)]
    assert fresh == committed


# --------------------------------------------------------------------- #
# the stage: plans, tables, campaign rows
# --------------------------------------------------------------------- #
def test_stage_plans_match_the_golden():
    """The port's stage body on the CPU (``build_plan(use_kernel=True)``
    on the plain path): ops, totals, matrices, max loads, the plan's and
    the refined choice tables, certificates — all the reference's."""
    recs, _, tables = _stage_plans()
    assert not chip_smoke.mltraffic_plan_mismatches(np, _golden(), recs)
    assert sorted(tables) == sorted(s.name for s, moe in ml.STAGE_GRID
                                    if moe)
    for rec in recs:
        m = rec["max_load"]
        assert rec["cert"] == "clean" and m["refined"] <= m["xy"] + 1e-12


def test_golden_plans_are_the_reference_today():
    """``mltraffic.json``'s per-workload records are what the reference
    gives on the recorded texts today."""
    recs, _, _ = _regen().reference_plans(HLO_DIR)
    assert json.loads(json.dumps(recs)) == _golden()["workloads"]


def test_moe_claim_on_the_recorded_hlo():
    """The stage's claim that the refined table beats XY on MoE traffic:
    it holds for qwen2-moe and, on this recording, not for dbrx, where
    the refined table is XY's (the reference's own result, not the
    port's)."""
    loads = {w["name"]: w["max_load"] for w in _golden()["workloads"]}
    q, d = loads["qwen2-moe@1x8:decode"], loads["dbrx@1x8:step"]
    assert q["refined"] < q["xy"] * (1 - 1e-6)
    assert d["refined"] == d["xy"]


def _ref_rows(cycles):
    regen = _regen()
    _, ref = _workloads()
    _, _, tables = _stage_plans()
    return regen.reference_rows(ref, tables, cycles)


def test_campaign_rows_match_reference_at_200_cycles():
    """XY and BiDOR × the four workloads × rates 0.1, 0.3 on the plain
    twin: the rows equal the reference's run now and the golden's."""
    _, wls, tables = _stage_plans()
    res = noc.run_campaign(chip_smoke.mltraffic_spec(noc, torus(2, 4), wls,
                                                     200),
                           bidor_tables=tables, device="cpu")
    rows = [chip_smoke.point_record(p) for p in res.points]
    assert [r["workload"] for r in rows] == [n for n in NAMES
                                            for _ in range(4)]
    assert not chip_smoke.mltraffic_row_mismatches(_ref_rows(200), rows)
    assert not chip_smoke.mltraffic_row_mismatches(
        _golden()["campaign"]["200"], rows)
    assert len(res.select(workload=NAMES[0], algo=noc.Algo.BIDOR)) == 2


def test_workload_campaign_through_a_resumed_job(tmp_path):
    """``CampaignSpec(workloads=...)`` through ``CampaignJob`` stopped
    after 3 of its 8 cells and resumed by a new job: the rows of a run in
    one go, the workload column filled, the reference's spec key."""
    from repro.noc import spec_fingerprint as ref_fingerprint
    from repro_torch.noc import CampaignJob, spec_fingerprint

    _, wls, tables = _stage_plans()
    spec = chip_smoke.mltraffic_spec(noc, torus(2, 4), wls, 200)
    _, ref = _workloads()
    import repro.noc as ref_noc

    with reference():
        want_key = ref_fingerprint(chip_smoke.mltraffic_spec(
            ref_noc, ref_torus(2, 4), ref, 200))
    assert spec_fingerprint(spec) == want_key
    kw = dict(root=str(tmp_path), job_id="ml", bidor_tables=tables,
              device="cpu")
    assert not CampaignJob(spec, **kw).run(3)
    job = CampaignJob(spec, **kw)
    assert job.status().done_cells == 3
    assert job.run()
    rows = [chip_smoke.point_record(p) for p in job.result().points]
    assert not chip_smoke.mltraffic_row_mismatches(
        _golden()["campaign"]["200"], rows)
    with open(job.csv_path) as f:
        lines = f.read().splitlines()
    col = lines[0].split(",").index("workload")
    assert [ln.split(",")[col] for ln in lines[1:]] == [
        n for n in NAMES for _ in range(4)]


def test_workloads_as_pair_counts_match_reference():
    """A ``(name, pair counts)`` workload resolves through
    ``from_pair_counts`` after the patterns, as the reference's."""
    import repro.noc as ref_noc

    counts = np.random.default_rng(3).random((8, 8))
    kw = dict(algos=(noc.Algo.XY,), patterns=("uniform",),
              workloads=(("counts", counts),), rates=(0.1,))
    got = noc.CampaignSpec(topo=torus(2, 4), **kw)
    with reference():
        want = ref_noc.CampaignSpec(topo=ref_torus(2, 4), **dict(
            kw, algos=(ref_noc.Algo.XY,))).pattern_items()
    items = got.pattern_items()
    assert [n for n, _ in items] == [n for n, _ in want] == ["uniform",
                                                             "counts"]
    for (_, a), (_, b) in zip(items, want):
        assert np.array_equal(a, np.asarray(b))
    assert np.array_equal(items[1][1],
                          traffic.from_pair_counts(torus(2, 4), counts))
    assert got.num_points == 2
    cells = noc.campaign_cells(got)
    assert [c.workload for c in cells] == ["", "counts"]
