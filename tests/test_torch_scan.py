"""The port's selective scan on the CPU against the JAX package.

The op's plain twin (what the CPU path runs, and what the CUDA kernel is
held against on the card) is compared with the reference's oracle
``ref.selective_scan`` — y and the last state, from a zero and from a
given initial state, at S 1 (a decode step) too — at rtol 1e-5 / atol
1e-6; and with the reference's Pallas op in interpret mode, which starts
from zero and returns y only, at the four cases of the reference's own
kernel test and its tolerance (rtol 1e-4, atol 1e-5).  Inputs are drawn
with numpy from a seed, at the reference test's scales.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba_scan import ops as ref_scan_ops  # noqa: E402
from repro.kernels.mamba_scan.ref import (  # noqa: E402
    selective_scan as ref_selective_scan)
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    selective_scan, selective_scan_ref)
from test_torch_oracle import torch_one_thread  # noqa: E402,F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _inputs(b, s, di, ds, seed, h0=False):
    """delta = 0.1·softplus(N), A = −exp(0.2·N), B, C, x ~ N (the
    reference test's draws), h0 ~ N; float32 numpy."""
    rng = np.random.default_rng(seed)
    out = {"delta": 0.1 * np.log1p(np.exp(rng.standard_normal((b, s, di)))),
           "a": -np.exp(0.2 * rng.standard_normal((di, ds))),
           "b": rng.standard_normal((b, s, ds)),
           "c": rng.standard_normal((b, s, ds)),
           "x": rng.standard_normal((b, s, di))}
    if h0:
        out["h0"] = rng.standard_normal((b, di, ds))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _port(inp):
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    return selective_scan(t["delta"], t["a"], t["b"], t["c"], t["x"],
                          h0=t.get("h0"))


# name: (B, S, Di, Ds, h0)
ORACLE_CASES = {
    "zero_state": (2, 40, 48, 16, False),
    "given_state": (2, 40, 48, 16, True),
    "decode_step": (3, 1, 64, 16, True),
    "decode_from_zero": (1, 1, 20, 8, False),
    "ragged_ds4": (1, 33, 100, 4, True),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_twin_matches_reference_oracle(case):
    b, s, di, ds, h0 = ORACLE_CASES[case]
    inp = _inputs(b, s, di, ds, seed=len(case), h0=h0)
    want_y, want_h = ref_selective_scan(
        *(jnp.asarray(inp[k]) for k in ("delta", "a", "b", "c", "x")),
        h0=jnp.asarray(inp["h0"]) if h0 else None)
    y, h = _port(inp)
    assert y.shape == (b, s, di) and h.shape == (b, di, ds)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("b,s,di,ds,chunk", [
    (2, 64, 128, 16, 16),
    (1, 96, 256, 8, 32),     # s not a multiple of the chunk
    (2, 64, 100, 16, 64),    # di not a multiple of the block
    (1, 33, 64, 4, 16),
])
def test_twin_matches_reference_pallas_op(b, s, di, ds, chunk):
    """The TPU kernel's wrapper in interpret mode, as
    ``tests/test_kernels.py::test_mamba_scan_kernel_matches_ref`` runs
    it (block 64, the test's chunks)."""
    inp = _inputs(b, s, di, ds, seed=s + di)
    want = ref_scan_ops.selective_scan(
        *(jnp.asarray(inp[k]) for k in ("delta", "a", "b", "c", "x")),
        block_d=64, chunk=chunk)
    y, _ = _port(inp)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_scan_resumes_from_its_last_state():
    """A scan over S equals a scan over the first S1 steps followed by one
    over the rest from its last state — what the prefill and the decode
    steps rely on; bit for bit, since the steps round the same way."""
    inp = _inputs(2, 24, 32, 8, seed=7, h0=True)
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    y, h = selective_scan(t["delta"], t["a"], t["b"], t["c"], t["x"],
                          h0=t["h0"])
    cut = {k: (v[:, :17].contiguous(), v[:, 17:].contiguous())
           for k, v in t.items() if k in ("delta", "b", "c", "x")}
    y1, h1 = selective_scan(*(cut[k][0] if k in cut else t[k]
                              for k in ("delta", "a", "b", "c", "x")),
                            h0=t["h0"])
    y2, h2 = selective_scan(*(cut[k][1] if k in cut else t[k]
                              for k in ("delta", "a", "b", "c", "x")),
                            h0=h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


def test_cpu_tensors_take_the_plain_path_and_keep_h0():
    inp = _inputs(1, 5, 16, 4, seed=3, h0=True)
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    h0 = t["h0"].clone()
    before = dict(kernels.LAUNCHES)
    y, h = selective_scan(t["delta"], t["a"], t["b"], t["c"], t["x"],
                          h0=t["h0"])
    assert kernels.LAUNCHES == before
    assert torch.equal(t["h0"], h0)
    want_y, want_h = selective_scan_ref(t["delta"], t["a"], t["b"], t["c"],
                                        t["x"], h0)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


def test_op_rejects_what_the_kernel_does_not_take():
    """The same checks on either device, so the CPU path holds callers to
    the kernel's contract."""
    inp = _inputs(2, 6, 16, 4, seed=5, h0=True)
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    args = [t[k] for k in ("delta", "a", "b", "c", "x")]
    with pytest.raises(TypeError):      # float32 only
        selective_scan(*args[:4], args[4].double())
    with pytest.raises(ValueError):     # B, C are (B, S, Ds)
        selective_scan(args[0], args[1], args[2][:, :5], args[3], args[4])
    with pytest.raises(ValueError):     # A is (Di, Ds)
        selective_scan(args[0], args[1].t().contiguous(), *args[2:])
    with pytest.raises(ValueError):     # h0 is (B, Di, Ds)
        selective_scan(*args, h0=t["h0"][:1])
    with pytest.raises(ValueError):     # contiguous inputs
        selective_scan(*args[:4], args[4].transpose(0, 1).contiguous()
                       .transpose(0, 1))
    with pytest.raises(ValueError):     # one device
        selective_scan(*args[:4], args[4].to("meta"))
