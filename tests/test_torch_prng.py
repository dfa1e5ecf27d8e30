"""The port's threefry2x32 against ``jax.random`` (non-partitionable):
bit for bit, key by key and draw by draw."""

import numpy as np
import pytest
import torch

from test_torch_oracle import reference
from test_torch_oracle import torch_one_thread  # noqa: F401  (a pytest fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

jax = pytest.importorskip("jax")

from repro_torch import prng  # noqa: E402
from repro_torch.noc import sim as port_sim  # noqa: E402
from repro_torch.kernels.simstep import ref as port_ref  # noqa: E402
from repro_torch.noc.simconfig import Algo  # noqa: E402


def _np(x):
    return np.asarray(jax.device_get(x))


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_key_and_fold_in(seed):
    with reference():
        k = jax.random.PRNGKey(seed)
        f = jax.random.fold_in(k, 0x3E19999A)
    assert np.array_equal(_np(k), prng.key(seed))
    assert np.array_equal(_np(f), prng.fold_in(prng.key(seed), 0x3E19999A))


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split(num):
    k = np.stack([prng.key(3), prng.fold_in(prng.key(4), 9)])
    with reference():
        want = np.stack([_np(jax.random.split(kk, num)) for kk in k])
    assert np.array_equal(want, prng.split(k, num))


@pytest.mark.parametrize("n", [1, 2, 16, 25, 1023, 1024])
def test_uniform(n):
    k = prng.fold_in(prng.key(11), 12345)
    with reference():
        want = _np(jax.random.uniform(k, (n,)))
    got = prng.uniform(k, n)
    assert got.dtype == np.float32
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))
    dev = prng.uniform_torch(torch.as_tensor(k.astype(np.int64)), n)
    assert np.array_equal(want.view(np.uint32),
                          dev.numpy().view(np.uint32))


@pytest.mark.parametrize("rate,seed", [(0.15, 0), (0.5, 1), (0.55, 0),
                                       (1.2, 65535)])
def test_point_key(rate, seed):
    from repro.noc import sim as ref_sim

    with reference():
        want = _np(ref_sim.point_key(seed, rate))
    assert np.array_equal(want, port_sim.point_key(seed, rate))


@pytest.mark.parametrize("algo", list(Algo))
def test_split_rand_50_cycles(algo):
    """The per-cycle key advance and draws over 50 cycles, two lanes."""
    from repro.kernels.simstep import ref as jref
    from repro.noc.simconfig import Algo as JAlgo

    keys = np.stack([port_sim.point_key(0, 0.15), port_sim.point_key(1, 0.5)])
    n = 25
    k_ref = [jax.numpy.asarray(k) for k in keys]
    k_port = keys
    for _ in range(50):
        with reference():
            outs = [jref.split_rand(k, JAlgo(int(algo)), n, 2)
                    for k in k_ref]
        k_ref = [o[0] for o in outs]
        k_port, rand = port_ref.split_rand(k_port, algo, n, 2)
        assert np.array_equal(np.stack([_np(k) for k in k_ref]), k_port)
        assert set(rand) == set(outs[0][1])
        for name in rand:
            want = np.stack([_np(o[1][name]) for o in outs])
            got = rand[name].numpy()
            assert want.dtype == got.dtype and np.array_equal(want, got), \
                name


def test_chunk_draws_match_split_rand():
    """``draw_chunk`` (host key chain + bulk device hash) yields the same
    keys and draws as ``split_rand`` applied cycle by cycle."""
    keys = np.stack([port_sim.point_key(s, r)
                     for r, s in [(0.2, 0), (0.4, 3), (0.7, 5)]])
    for algo in (Algo.XY, Algo.O1TURN, Algo.VALIANT, Algo.ROMM):
        new_keys, chunk = port_ref.draw_chunk(keys, 40, 25, "cpu", algo, 2)
        k = keys
        for c in range(40):
            k, rand = port_ref.split_rand(k, algo, 25, 2)
            assert set(rand) == set(chunk)
            assert all(torch.equal(rand[name], chunk[name][c])
                       for name in rand), (algo, c)
        assert np.array_equal(k, new_keys)
