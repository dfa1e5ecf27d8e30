"""Oracle harness for the port's tests: run the JAX reference as its
committed fixtures were made.

Two settings are needed under the installed JAX (0.9):

* ``jax.experimental.enable_x64`` was removed, but the reference's fp64
  planner still calls it — alias it to ``jax.enable_x64(True)``;
* ``jax_threefry_partitionable`` now defaults to True, while the
  fixtures were made with the non-partitionable threefry — switch it off.

:func:`reference` applies both for the duration of a ``with`` block and
restores the module afterwards, so the reference's own tests see JAX
exactly as they would without the port.  The port's test files import
it from here and call the JAX package only inside it, and run on one
torch thread through the :func:`torch_one_thread` fixture.
"""

import contextlib
import importlib.util
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
INT_FIELDS = ("injected", "ejected", "in_flight", "reorder", "meas_cycles")
FLOAT_FIELDS = ("throughput", "avg_latency", "p50_latency", "p99_latency",
                "link_load_max", "lcv")


@pytest.fixture(scope="module")
def torch_one_thread():
    """Run the port's plain path on one torch thread: its tensors are
    small, so more threads only contend with the other test workers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def reference():
    """Scope in which the JAX reference reproduces its fixtures."""
    import jax.experimental

    added = not hasattr(jax.experimental, "enable_x64")
    if added:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    try:
        with jax.threefry_partitionable(False):
            yield
    finally:
        if added:
            del jax.experimental.enable_x64


def regen_module():
    """``tests/goldens/regen.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "golden_regen_port", os.path.join(GOLDEN_DIR, "regen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_golden(name: str) -> dict:
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        return json.load(f)


def golden_mismatches(golden: dict, computed: dict) -> list[str]:
    """The comparison of ``tests/test_goldens.py``: integer fields exact,
    float fields within rtol 1e-5 (atol 1e-6)."""
    out = []
    if set(golden["points"]) != set(computed["points"]):
        out.append(f"point sets differ: {sorted(golden['points'])} vs "
                   f"{sorted(computed['points'])}")
    for key, want in golden["points"].items():
        got = computed["points"].get(key)
        if got is None:
            continue
        for f in INT_FIELDS:
            if got[f] != want[f]:
                out.append(f"{key}.{f}: {got[f]} != {want[f]}")
        for f in FLOAT_FIELDS:
            if not np.isclose(got[f], want[f], rtol=1e-5, atol=1e-6):
                out.append(f"{key}.{f}: {got[f]} != {want[f]}")
    return out


@pytest.mark.parametrize("fixture,fn", [
    ("campaign_4x4.json", "compute_goldens"),
    ("ctrl_4x4.json", "compute_ctrl_goldens"),
])
def test_reference_reproduces_golden(fixture, fn):
    """Inside :func:`reference` the JAX package reproduces its committed
    fixtures exactly — the premise of every oracle comparison."""
    with reference():
        computed = getattr(regen_module(), fn)()
    assert not golden_mismatches(load_golden(fixture), computed)


def test_reference_scope_is_restored():
    """Leaving the scope restores JAX's own settings."""
    import jax.experimental

    had = hasattr(jax.experimental, "enable_x64")
    before = jax.config.jax_threefry_partitionable
    with reference():
        assert hasattr(jax.experimental, "enable_x64")
        assert not jax.config.jax_threefry_partitionable
    assert hasattr(jax.experimental, "enable_x64") == had
    assert jax.config.jax_threefry_partitionable == before
