"""The port's post-SPMD HLO parser against the JAX package's, on the CPU.

On each of the seven recorded phase programs of the ML-traffic stage
(``tests/goldens/mltraffic/``: real post-SPMD HLO of the reference's
sharded smoke models, lowered on 8 host devices): the computations and
their instructions, every ``CollectiveOp`` field for field, the per-kind
totals and ``HloStats``.  The replica-group and pair parsers also on
hand-written attribute strings of every printed form.
"""

import dataclasses
import gzip
import os

import pytest

pytest.importorskip("jax")

from repro.analysis import hlo as ref_hlo  # noqa: E402
from repro_torch.analysis import hlo  # noqa: E402
from repro_torch.noc.mltraffic import STAGE_GRID, hlo_path  # noqa: E402

HLO_DIR = os.path.join(os.path.dirname(__file__), "goldens", "mltraffic")
PHASES = [(spec, ph) for spec, _ in STAGE_GRID for ph in spec.phases]
IDS = [f"{spec.name}:{ph}" for spec, ph in PHASES]
_TEXTS = {}


def _text(spec, phase) -> str:
    key = (spec.name, phase)
    if key not in _TEXTS:
        with gzip.open(hlo_path(spec, phase, HLO_DIR), "rt") as f:
            _TEXTS[key] = f.read()
    return _TEXTS[key]


def _fields(obj) -> dict:
    return dataclasses.asdict(obj)


def test_seven_recorded_programs():
    assert len(PHASES) == 7
    for spec, phase in PHASES:
        assert os.path.exists(hlo_path(spec, phase, HLO_DIR))


@pytest.mark.parametrize("case", range(len(PHASES)), ids=IDS)
def test_parse_hlo_matches_reference(case):
    spec, phase = PHASES[case]
    text = _text(spec, phase)
    got, want = hlo.parse_hlo(text), ref_hlo.parse_hlo(text)
    assert list(got) == list(want)
    for name, comp in want.items():
        mine = got[name]
        assert mine.is_entry == comp.is_entry
        assert [_fields(i) for i in mine.instructions.values()] == [
            _fields(i) for i in comp.instructions.values()]
    assert sum(c.is_entry for c in got.values()) == 1


@pytest.mark.parametrize("case", range(len(PHASES)), ids=IDS)
def test_collective_ops_match_reference(case):
    """Every op, field for field, and the per-kind fabric totals; each op
    has groups or pairs, and a positive count."""
    spec, phase = PHASES[case]
    text = _text(spec, phase)
    d = spec.num_devices
    got, want = hlo.collective_ops(text, d), ref_hlo.collective_ops(text, d)
    assert [_fields(o) for o in got] == [_fields(o) for o in want]
    assert len(got) >= 20
    for op in got:
        assert op.count >= 1 and (op.groups or op.pairs)
        assert op.group_size == (len(op.groups[0]) if op.groups else 1)
    for a, b in zip(got, want):
        assert a.fabric_bytes == b.fabric_bytes
    assert hlo.collective_flow_totals(got) == ref_hlo.collective_flow_totals(
        want)


@pytest.mark.parametrize("case", range(len(PHASES)), ids=IDS)
def test_hlo_stats_match_reference(case):
    """FLOPs, HBM bytes, collective bytes and counts, while trip counts."""
    spec, phase = PHASES[case]
    text = _text(spec, phase)
    got = hlo.analyze_hlo_text(text, spec.num_devices)
    want = ref_hlo.analyze_hlo_text(text, spec.num_devices)
    assert _fields(got) == _fields(want)
    assert got.flops > 0 and got.hbm_bytes > 0
    assert got.while_trip_counts


@pytest.mark.parametrize("attrs", [
    "replica_groups=[1,8]<=[8], dimensions={3}",
    "replica_groups=[2,4]<=[4,2]T(1,0), dimensions={2}",
    "replica_groups=[4,2]<=[2,2,2]T(0,2,1), to_apply=%add",
    "replica_groups={{0,1},{2,3},{4,5},{6,7}}, to_apply=%add",
    "replica_groups={{0, 2, 4, 6}, {1, 3, 5, 7}}",
    "replica_groups={}, to_apply=%add",
    "to_apply=%add",
])
def test_replica_groups_match_reference(attrs):
    got = hlo.parse_replica_groups(attrs, 8)
    assert got == ref_hlo.parse_replica_groups(attrs, 8)
    assert sorted(i for g in got for i in g) == list(range(8))
    assert all(type(i) is int for g in got for i in g)
    assert hlo._group_size(attrs, 8) == ref_hlo._group_size(attrs, 8)


@pytest.mark.parametrize("attrs", [
    "source_target_pairs={{0,1},{1,2},{2,3}}, channel_id=4",
    "source_target_pairs={{3, 0}}",
    "channel_id=4",
])
def test_source_target_pairs_match_reference(attrs):
    assert (hlo.parse_source_target_pairs(attrs)
            == ref_hlo.parse_source_target_pairs(attrs))


def test_trip_count_matches_reference():
    """The while trip count read from a condition computation: the
    constant a ``compare(..., direction=LT)`` reads, else the largest
    constant, else 1."""
    texts = {
        "lt": "%c (p: (s32[])) -> pred[] {\n"
              "  %i = s32[] get-tuple-element((s32[]) %p), index=0\n"
              "  %k = s32[] constant(12)\n"
              "  ROOT %lt = pred[] compare(s32[] %i, s32[] %k), "
              "direction=LT\n}\n",
        "max": "%c (p: (s32[])) -> pred[] {\n"
               "  %k = s32[] constant(3)\n"
               "  %j = s32[] constant(7)\n"
               "  ROOT %x = pred[] compare(s32[] %k, s32[] %j), "
               "direction=NE\n}\n",
        "none": "%c (p: (s32[])) -> pred[] {\n"
                "  ROOT %x = pred[] parameter(0)\n}\n",
    }
    want = {"lt": 12, "max": 7, "none": 1}
    for key, text in texts.items():
        got = hlo._trip_count(hlo.parse_hlo(text)["c"])
        assert got == ref_hlo._trip_count(ref_hlo.parse_hlo(text)["c"])
        assert got == want[key], key
