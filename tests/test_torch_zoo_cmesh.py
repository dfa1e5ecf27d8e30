"""The plain twin on the concentrated mesh (four cores a router), against the reference state by state with the
watchdog and the telemetry on, and against the golden with both off
(``test_torch_zoo.hold_cell``), under every routing algorithm the
topology admits."""

import pytest

from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

pytest.importorskip("jax")

from test_torch_zoo import admitted, hold_cell, pair  # noqa: E402

NAME = "cmesh_4x4c4"
CASES = admitted(pair(NAME)[1])


@pytest.mark.parametrize("algo", CASES, ids=[a.name for a in CASES])
def test_twin_on_the_zoo(algo):
    hold_cell(NAME, algo)
