"""The port's host N-Rank oracle and ``build_plan`` against the
reference's, stage by stage, on the CPU.

The tolerances are the reference's own: the possibility op's
(``tests/test_kernels.py``), the joint's and the kernel path's
(``tests/test_plan_fast.py``).  The node-level evolution runs in float32
on both sides, the channel-level one in float64.  The
``possibility_weights`` CUDA kernel is held against the plain version
here on the card by ``tests/test_torch_gpu.py``.
"""

import importlib

import numpy as np
import pytest

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
from repro.kernels.possibility import ops as jops  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.kernels.possibility import possibility_weights  # noqa: E402

# the packages export a function of the same name as each module
jnrank = importlib.import_module("repro.core.nrank")
tnrank = importlib.import_module("repro_torch.core.nrank")

TOPOS = {
    "mesh4x4": ("mesh2d", (4, 4)),
    "edge5x5": ("mesh2d_edge_io", (5, 5)),
    "torus6x6": ("torus", (6, 6)),
}
# paper Fig. 1 (benchmarks/fig1_load.py)
FIG1 = {
    "mesh_uniform": (("mesh2d", (5, 5)), "uniform"),
    "edgeio_uniform": (("mesh2d_edge_io", (5, 5)), "uniform"),
    "edgeio_overturn": (("mesh2d_edge_io", (5, 5)), "overturn"),
}


def _topos(spec):
    fn, args = spec
    return getattr(jcore, fn)(*args), getattr(tcore, fn)(*args)


def _traffic(topo, kind, seed=0):
    if kind != "random":
        return jcore.traffic.PATTERNS[kind](topo)
    rng = np.random.default_rng(seed)
    t = rng.random((topo.num_nodes,) * 2)
    np.fill_diagonal(t, 0.0)
    return t / t.sum()


@pytest.mark.parametrize("kind", ["uniform", "random"])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_numpy_possibility_weights_bit_for_bit(topo, kind):
    jt, tt = _topos(TOPOS[topo])
    t = _traffic(jt, kind)
    want = jnrank.possibility_weights(jt.distances, t, jt.channels)
    got = tnrank.possibility_weights(tt.distances, t, tt.channels)
    for w, g in zip(want, got):
        assert g.dtype == np.float64 and np.array_equal(w, g)


def _offset2_channels(topo, t):
    """(u, n2) of every consecutive pair with joint weight, as the
    reference's kernel test takes them."""
    j = jnrank.joint_possibility(topo, t)
    pairs = np.argwhere(j > 0)
    chans = topo.channels
    return (np.stack([chans[pairs[:, 0], 0], chans[pairs[:, 1], 1]], 1),
            j[pairs[:, 0], pairs[:, 1]])


@pytest.mark.parametrize("path", ["dense", "pallas_interpret"])
@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("topo", ["mesh4x4", "torus6x6"])
def test_op_plain_vs_reference_op(topo, offset, path):
    jt, _ = _topos(TOPOS[topo])
    t = _traffic(jt, "random", seed=offset)
    chans = jt.channels if offset == 1 else _offset2_channels(jt, t)[0]
    use_pallas = path == "pallas_interpret"
    with reference():
        want = jops.possibility_weights(jt.distances, t, chans,
                                        use_pallas=use_pallas,
                                        interpret=use_pallas,
                                        offset=offset)
    before = dict(kernels.LAUNCHES)
    got = possibility_weights(jt.distances, t, chans, offset=offset,
                              device="cpu")
    assert kernels.LAUNCHES == before          # CPU: the plain twin
    for w, g in zip(want, got):
        assert g.dtype.is_floating_point and g.dtype.itemsize == 4
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


def test_op_offset2_is_the_joint():
    """offset 2 on (u, n2) pairs gives the joint possibility weights."""
    jt, _ = _topos(TOPOS["torus6x6"])
    t = _traffic(jt, "uniform")
    ab, jvals = _offset2_channels(jt, t)
    w2, _ = possibility_weights(jt.distances, t, ab, offset=2, device="cpu")
    np.testing.assert_allclose(w2.numpy(), jvals, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("topo", ["edge5x5", "torus6x6"])
def test_joint_possibility(topo, use_kernel):
    jt, tt = _topos(TOPOS[topo])
    t = _traffic(jt, "random", seed=11)
    with reference():
        want = jnrank.joint_possibility(jt, t, use_kernel=use_kernel)
    got = tnrank.joint_possibility(tt, t, use_kernel=use_kernel,
                                   device="cpu")
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("scenario", sorted(FIG1))
def test_nrank_node_mode_float32(scenario, use_kernel):
    (spec, pattern) = FIG1[scenario]
    jt, tt = _topos(spec)
    t = jcore.traffic.PATTERNS[pattern](jt)
    with reference():
        want = jnrank.nrank(jt, t, use_kernel=use_kernel)
    got = tnrank.nrank(tt, t, use_kernel=use_kernel, device="cpu")
    assert got.iterations == want.iterations
    for f in ("w_nr", "w_final", "w0", "p", "p_drn", "w_possibility"):
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    np.testing.assert_allclose(got.w_nr, want.w_nr, rtol=1e-5)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("scenario", sorted(FIG1))
def test_nrank_channel_host_path(scenario, warm):
    (spec, pattern) = FIG1[scenario]
    jt, tt = _topos(spec)
    t = jcore.traffic.PATTERNS[pattern](jt)
    w0 = None
    if warm:
        w0 = jnrank.initial_weights(t) + np.linspace(0.0, 0.2, jt.num_nodes)
    with reference():
        want = jnrank.nrank_channel(jt, t, w0=w0)
    got = tnrank.nrank_channel(tt, t, w0=w0, device="cpu")
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.w_nr, want.w_nr, rtol=1e-10)
    np.testing.assert_allclose(got.w_final, want.w_final, rtol=1e-10,
                               atol=1e-15)
    np.testing.assert_array_equal(got.w_possibility, want.w_possibility)


@pytest.mark.parametrize("scenario", sorted(FIG1))
def test_nrank_channel_kernel_path(scenario):
    """The reference's criterion for its own kernel path
    (``tests/test_plan_fast.py``), held against both of its paths."""
    (spec, pattern) = FIG1[scenario]
    jt, tt = _topos(spec)
    t = jcore.traffic.PATTERNS[pattern](jt)
    with reference():
        hosts = jnrank.nrank_channel(jt, t)
        kern = jnrank.nrank_channel(jt, t, use_kernel=True)
    got = tnrank.nrank_channel(tt, t, use_kernel=True, device="cpu")
    for want in (hosts, kern):
        assert got.iterations == want.iterations
        np.testing.assert_allclose(got.w_nr, want.w_nr, rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_array_equal(tcore.bidor(tt, got.w_nr).choice,
                                      jcore.bidor(jt, want.w_nr).choice)


@pytest.mark.parametrize("mode", ["channel", "node"])
@pytest.mark.parametrize("scenario", sorted(FIG1))
def test_reference_kernel_and_host_plans_agree(scenario, mode):
    """The known fact the card's check stands on: the reference's own
    ``build_plan`` gives the same choice table with and without its
    kernel path on every Fig. 1 scenario and mode."""
    (spec, pattern) = FIG1[scenario]
    jt, _ = _topos(spec)
    t = jcore.traffic.PATTERNS[pattern](jt)
    with reference():
        host = jcore.build_plan(jt, t, mode=mode)
        kern = jcore.build_plan(jt, t, mode=mode, use_kernel=True)
    assert np.array_equal(host.table.choice, kern.table.choice)


BUILD_CASES = [(s, m, k) for s in sorted(FIG1) for m in ("channel", "node")
               for k in (False, True)]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("scenario,mode,k_orders", BUILD_CASES)
def test_build_plan_matches_reference(scenario, mode, k_orders, use_kernel):
    (spec, pattern) = FIG1[scenario]
    jt, tt = _topos(spec)
    t = jcore.traffic.PATTERNS[pattern](jt)
    with reference():
        want = jcore.build_plan(jt, t, mode=mode, k_orders=k_orders,
                                use_kernel=use_kernel)
    got = tcore.build_plan(tt, t, mode=mode, k_orders=k_orders,
                           use_kernel=use_kernel, device="cpu")
    assert np.array_equal(got.table.choice, want.table.choice)
    assert got.table.orders == want.table.orders
    assert got.nrank.iterations == want.nrank.iterations
    assert got.cert is None          # build_plan does not certify


def test_build_plan_down_channels():
    jt, tt = _topos(("mesh2d", (4, 4)))
    t = jcore.traffic.tornado(jt)
    dc = np.array([jt.channel_index(5, 6), jt.channel_index(6, 5)])
    with reference():
        want = jcore.build_plan(jt, t, down_channels=dc)
    got = tcore.build_plan(tt, t, down_channels=dc, device="cpu")
    assert np.array_equal(got.table.choice, want.table.choice)
    assert np.array_equal(got.table.unroutable, want.table.unroutable)


def test_nrank_result_converts_with_its_dtypes():
    jt, _ = _topos(("mesh2d", (4, 4)))
    t = jcore.traffic.uniform(jt)
    with reference():
        node = jnrank.nrank(jt, t)
    got = convert.nrank_result(node)
    assert got.iterations == node.iterations
    assert got.w_nr.dtype == np.float32 == node.w_nr.dtype
    assert np.array_equal(got.w_final, node.w_final)


def test_oracle_defaults_to_the_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    tt = tcore.mesh2d(4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.build_plan(tt, tcore.traffic.uniform(tt))
