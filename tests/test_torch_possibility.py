"""The possibility pass: the port's plain version against the reference's
Pallas kernel (interpret mode) and its chunked jnp pass.  The CUDA
kernel is held against the plain version on the card by
``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

import repro.core as jcore  # noqa: E402
from repro.core import plan_fast as jplan  # noqa: E402
from repro.kernels.possibility.kernel import possibility_v_pallas  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.possibility import possibility_v  # noqa: E402

RTOL = 1e-12   # fp64 sums in another order; exact on integer-valued T


def _inputs(topo, integer: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = topo.num_nodes
    t = (rng.integers(0, 7, (n, n)).astype(np.float64) if integer
         else rng.random((n, n)))
    dist = topo.distances.astype(np.int32)
    us, ns = topo.channels[:, 0], topo.channels[:, 1]
    return t, dist, us, ns


def _port(t, dist, us, ns, offset):
    dist_t = torch.as_tensor(dist)
    return possibility_v(dist_t[:, us].contiguous(),
                         dist_t[ns, :].contiguous(), torch.as_tensor(t),
                         dist_t, offset=offset).numpy()


def _check(got, want, integer):
    if integer:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("integer", [True, False], ids=["intT", "realT"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("topo_fn", ["mesh4x4", "edge5x5"])
def test_plain_vs_pallas_interpret(topo_fn, offset, integer):
    topo = (jcore.mesh2d(4, 4) if topo_fn == "mesh4x4"
            else jcore.mesh2d_edge_io(5, 5))
    t, dist, us, ns = _inputs(topo, integer)
    with reference(), jax.experimental.enable_x64():
        want = np.asarray(possibility_v_pallas(
            dist[:, us], dist[ns, :], t, dist, offset=offset,
            interpret=True))
    assert want.dtype == np.float64
    _check(_port(t, dist, us, ns, offset), want, integer)


@pytest.mark.parametrize("integer", [True, False], ids=["intT", "realT"])
@pytest.mark.parametrize("offset", [0, 1])
def test_plain_vs_chunked_jnp(offset, integer):
    topo = jcore.mesh2d_edge_io(5, 5)
    t, dist, us, ns = _inputs(topo, integer, seed=1)
    with reference(), jax.experimental.enable_x64():
        want = np.asarray(jplan._possibility_v(
            jax.numpy.asarray(dist), jax.numpy.asarray(t),
            jax.numpy.asarray(us.astype(np.int32)),
            jax.numpy.asarray(ns.astype(np.int32)), offset, 8,
            use_pallas=False))
    _check(_port(t, dist, us, ns, offset), want, integer)


def test_wrapper_checks_inputs():
    d = torch.zeros((4, 4), dtype=torch.int32)
    t = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(TypeError):
        possibility_v(d.long(), d, t, d)
    with pytest.raises(ValueError):
        possibility_v(d, torch.zeros((3, 4), dtype=torch.int32), t, d)
    before = dict(kernels.LAUNCHES)
    possibility_v(d, d, t, d)               # CPU: plain, no launch
    assert kernels.LAUNCHES == before

