"""The port's planner against the reference's ``build_plans_batched``
(fp64 on the CPU): identical choice tables, NR-weights and route costs
within rtol 1e-10 (summation order only)."""

import numpy as np
import pytest

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402

import repro_torch.core as tcore  # noqa: E402

RTOL = 1e-10

CASES = {
    "mesh4x4": (("mesh2d", (4, 4)), ("uniform", "tornado"), None),
    "edge5x5": (("mesh2d_edge_io", (5, 5)), ("uniform", "overturn"), None),
    # a failed link: masked planning, unroutable pairs, admission control
    "mesh4x4_down": (("mesh2d", (4, 4)), ("uniform", "tornado"),
                     ((5, 6), (6, 5))),
    # the evolution runs to its iteration cap here, as it does at the
    # scale cell's 32x32; both planners take about a second on the CPU
    "mesh16x16": (("mesh2d", (16, 16)), ("uniform", "tornado"), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plans_match_reference(case):
    (fn, args), patterns, down = CASES[case]
    jt, tt = getattr(jcore, fn)(*args), getattr(tcore, fn)(*args)
    dc = None
    if down is not None:
        dc = np.array([jt.channel_index(u, n) for u, n in down])
    tms = [jcore.traffic.PATTERNS[p](jt) for p in patterns]
    with reference():
        want = jcore.build_plans_batched(jt, tms, down_channels=dc)
    got = tcore.build_plans_batched(tt, tms, down_channels=dc, device="cpu")
    for w, g in zip(want, got):
        assert np.array_equal(w.table.choice, g.table.choice)
        assert w.table.choice.dtype == g.table.choice.dtype
        assert np.array_equal(w.table.port_tables, g.table.port_tables)
        np.testing.assert_allclose(g.nrank.w_nr, w.nrank.w_nr, rtol=RTOL)
        np.testing.assert_allclose(g.table.costs, w.table.costs, rtol=RTOL)
        assert g.nrank.iterations == w.nrank.iterations
        assert w.cert.verdict == g.cert.verdict
        if down is None:
            assert g.table.unroutable is None
        else:
            assert np.array_equal(w.table.unroutable, g.table.unroutable)


def test_plan_32x32_matches_reference():
    """The scale cell's plan (mesh2d(32,32), uniform): where BiDOR
    delivers less than XY on the card, the plan is the reference's own —
    identical choice table, both evolutions at the 100-iteration cap,
    both certificates clean."""
    jt, tt = jcore.mesh2d(32, 32), tcore.mesh2d(32, 32)
    tm = jcore.traffic.uniform(jt)
    with reference():
        (want,) = jcore.build_plans_batched(jt, [tm])
    (got,) = tcore.build_plans_batched(tt, [tm], device="cpu")
    assert int((got.table.choice != want.table.choice).sum()) == 0
    np.testing.assert_allclose(got.nrank.w_nr, want.nrank.w_nr, rtol=RTOL)
    assert got.nrank.iterations == want.nrank.iterations == 100
    assert got.cert.verdict == want.cert.verdict == "clean"


def test_single_plan_warm_start():
    """``build_plan_fast`` with a warm-start carry ``w0``."""
    jt, tt = jcore.mesh2d(4, 4), tcore.mesh2d(4, 4)
    tm = jcore.traffic.tornado(jt)
    w0 = np.linspace(0.5, 1.5, 16)
    with reference():
        want = jcore.build_plan_fast(jt, tm, w0=w0)
    got = tcore.build_plan_fast(tt, tm, w0=w0, device="cpu")
    assert np.array_equal(want.table.choice, got.table.choice)
    np.testing.assert_allclose(got.nrank.w_nr, want.nrank.w_nr, rtol=RTOL)


def test_stage_times_leave_the_plan_unchanged():
    """``stage_ms`` adds each stage's time and changes no plan bit."""
    topo = tcore.mesh2d(4, 4)
    tms = [tcore.traffic.uniform(topo), tcore.traffic.tornado(topo)]
    stages = {}
    timed = tcore.build_plans_batched(topo, tms, device="cpu",
                                      stage_ms=stages)
    plain = tcore.build_plans_batched(topo, tms, device="cpu")
    assert set(stages) == {"host_tables", "device", "possibility_v",
                           "certify"}
    assert all(ms >= 0 for ms in stages.values())
    for a, b in zip(timed, plain):
        assert np.array_equal(a.table.choice, b.table.choice)
        assert np.array_equal(a.nrank.w_nr, b.nrank.w_nr)


def test_planner_defaults_to_the_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.build_plans_batched(tcore.mesh2d(4, 4),
                                  [tcore.traffic.uniform(tcore.mesh2d(4, 4))])
