"""The plain twin on multipod (7-port routers, the pod axis at
half bandwidth), against the reference state by state with the
watchdog and the telemetry on, and against the golden with both off
(``test_torch_zoo.hold_cell``), under every routing algorithm the
topology admits.  And the concentrated mesh's rows of the QUICK
topology sweep against the committed CSV."""

import pytest

from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

pytest.importorskip("jax")

from test_torch_zoo import admitted, hold_cell, hold_sweep_rows, pair  # noqa: E402

NAME = "multipod_2x3x3"
CASES = admitted(pair(NAME)[1])


@pytest.mark.parametrize("algo", CASES, ids=[a.name for a in CASES])
def test_twin_on_the_zoo(algo):
    hold_cell(NAME, algo)


def test_sweep_rows_cmesh():
    hold_sweep_rows("cmesh_4x4c4")
