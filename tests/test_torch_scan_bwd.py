"""The selective scan's gradient on the CPU against the JAX package.

``selective_scan_bwd_ref`` (what the CPU path runs in the backward, and
what ``csrc/selective_scan_bwd.cu`` is held against on the card) and
autograd of the forward twin ``selective_scan_ref`` are compared with
``jax.vjp`` of the reference's oracle ``ref.selective_scan``, from a zero
and from a given initial state, with and without a cotangent on the last
state, within 1e-5 of each gradient's largest |value| (float32 sums in
another order).  ``SelectiveScan`` on the CPU gives the twins' bits and
launches nothing; the op rejects what it does not take, with a gradient
wanted too.  Inputs are drawn with numpy from a seed, at the reference
kernel test's scales.
"""

import numpy as np
import pytest
import torch

from test_torch_oracle import torch_one_thread  # noqa: F401  (a fixture)

from repro_torch import kernels
from repro_torch.kernels.mamba_scan import (SelectiveScan, selective_scan,
                                            selective_scan_bwd_ref,
                                            selective_scan_ref)
from repro_torch.kernels.mamba_scan.kernel import bwd_scratch_shapes

pytestmark = pytest.mark.usefixtures("torch_one_thread")

GRAD_TOL = 1e-5     # of a gradient's largest |value|
NAMES = ("delta", "a", "b", "c", "x", "h0")

# name: (B, S, Di, Ds, h0, dh_last)
CASES = {
    "zero_state": (2, 24, 16, 16, False, False),
    "given_state_and_dh_last": (2, 19, 12, 8, True, True),
    "dh_last_only": (1, 9, 10, 4, False, True),
    "one_step": (3, 1, 8, 5, True, True),
    "ragged_ds1": (2, 11, 7, 1, True, False),
}


def _inputs(b, s, di, ds, h0, dh_last, seed):
    """delta = 0.1·softplus(N), A = −exp(0.2·N), B, C, x ~ N; h0, dy,
    dh_last ~ N; float32 numpy."""
    rng = np.random.default_rng(seed)
    out = {"delta": 0.1 * np.log1p(np.exp(rng.standard_normal((b, s, di)))),
           "a": -np.exp(0.2 * rng.standard_normal((di, ds))),
           "b": rng.standard_normal((b, s, ds)),
           "c": rng.standard_normal((b, s, ds)),
           "x": rng.standard_normal((b, s, di)),
           "dy": rng.standard_normal((b, s, di))}
    if h0:
        out["h0"] = rng.standard_normal((b, di, ds))
    if dh_last:
        out["dh_last"] = rng.standard_normal((b, di, ds))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _reference_vjp(inp):
    """The oracle's gradients with respect to its inputs (h0 included
    where given), by ``jax.vjp``."""
    import jax
    import jax.numpy as jnp

    from repro.kernels.mamba_scan.ref import selective_scan as oracle

    names = [n for n in NAMES if n in inp]
    args = [jnp.asarray(inp[n]) for n in names]

    def f(*xs):
        kw = dict(zip(names, xs))
        return oracle(kw["delta"], kw["a"], kw["b"], kw["c"], kw["x"],
                      h0=kw.get("h0"))

    (y, h), vjp = jax.vjp(f, *args)
    dh = inp.get("dh_last", np.zeros(np.shape(h), np.float32))
    return dict(zip(names, (np.asarray(g) for g in vjp(
        (jnp.asarray(inp["dy"]), jnp.asarray(dh))))))


def _hold(got: dict, want: dict, label: str):
    assert set(got) == set(want), label
    for n, w in want.items():
        g = got[n].detach().numpy()
        assert g.shape == w.shape, (label, n)
        top = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * max(top, 1e-30), f"{label} {n}: {err}/{top}"


def _tensors(inp):
    return {k: torch.as_tensor(v) for k, v in inp.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_twin_and_autograd_match_jax_vjp(case):
    inp = _inputs(*CASES[case], seed=len(case))
    want = _reference_vjp(inp)
    t = _tensors(inp)
    fwd = [t[n] for n in NAMES[:5]] + [t.get("h0")]
    grads = selective_scan_bwd_ref(*fwd, t["dy"], t.get("dh_last"))
    twin = dict(zip(NAMES, grads))
    if "h0" not in t:
        twin.pop("h0")
    _hold(twin, want, "selective_scan_bwd_ref")

    leaves = {n: t[n].clone().requires_grad_(True) for n in want}
    y, h = selective_scan_ref(*(leaves[n] for n in NAMES[:5]),
                              leaves.get("h0"))
    loss = (y * t["dy"]).sum()
    if "dh_last" in t:
        loss = loss + (h * t["dh_last"]).sum()
    auto = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _hold(auto, want, "autograd of selective_scan_ref")


@pytest.mark.parametrize("case", ["given_state_and_dh_last", "zero_state"])
def test_selective_scan_on_the_cpu_runs_the_twins_and_launches_nothing(
        case):
    """Through the op with a gradient wanted: the forward twin's y and
    h_last and the backward twin's gradients, bit for bit, and no kernel
    launch counted."""
    inp = _inputs(*CASES[case], seed=7)
    t = _tensors(inp)
    h0 = t.get("h0")
    fwd = [t[n] for n in NAMES[:5]] + [h0]
    leaves = [x.clone().requires_grad_(True) for x in fwd if x is not None]
    before = dict(kernels.LAUNCHES)
    y, h = selective_scan(*leaves[:5], h0=leaves[5] if h0 is not None
                          else None)
    assert y.grad_fn is not None and h.grad_fn is not None
    dh = t.get("dh_last")
    grads = torch.autograd.grad((y, h), leaves, (t["dy"], dh if dh is not None
                                                 else torch.zeros_like(h)))
    assert kernels.LAUNCHES == before
    wy, wh = selective_scan_ref(*fwd)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    want = selective_scan_bwd_ref(*fwd, t["dy"], dh if dh is not None
                                  else torch.zeros_like(wh))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    # without a gradient the op runs the forward twin alone
    with torch.no_grad():
        y2, _ = selective_scan(*leaves[:5], h0=leaves[5] if h0 is not None
                               else None)
    assert y2.grad_fn is None and torch.equal(y2, wy)


def test_selective_scan_backward_flows_when_h_last_is_unused():
    """A layer that reads y alone leaves h_last without a cotangent: the
    backward takes it as zeros, and h0's gradient is None when no h0 was
    given."""
    inp = _inputs(2, 7, 6, 4, False, False, seed=3)
    t = _tensors(inp)
    leaves = [t[n].clone().requires_grad_(True) for n in NAMES[:5]]
    out = SelectiveScan.apply(*leaves, None, False)
    (out[0] * t["dy"]).sum().backward()
    want = selective_scan_bwd_ref(*(t[n] for n in NAMES[:5]), None, t["dy"])
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_selective_scan_rejects_what_it_does_not_take():
    inp = _tensors(_inputs(1, 4, 8, 4, True, False, seed=1))
    args = [inp[n].requires_grad_(True) for n in NAMES[:5]]
    with pytest.raises(TypeError):       # float32 only
        selective_scan(*args[:4], args[4].double())
    with pytest.raises(ValueError):      # shapes agree
        selective_scan(args[0][:, :3], *args[1:5])
    with pytest.raises(ValueError):      # contiguous inputs
        selective_scan(args[0], args[1].t().contiguous().t(), *args[2:5])
    with pytest.raises(ValueError):      # h0 of the state's shape
        selective_scan(*args, h0=inp["h0"][:, :, :2])
    with pytest.raises(ValueError):      # a device the op has no path for
        selective_scan(*(a.detach().to("meta") for a in args))


# (B, S, Di, Ds): the training call, ragged Di and S, Ds 5 and 1
SCRATCH = {"train": (2, 1024, 16384, 16), "ragged": (2, 37, 100, 16),
           "ds5": (1, 29, 130, 5), "ds1": (3, 9, 33, 1)}


@pytest.mark.parametrize("case", sorted(SCRATCH))
def test_backward_scratch_shapes(case):
    """The scratch the backward's binding allocates: a block of 64
    channels' 32 dB/dC terms a (row, step), one dA a (row, channel,
    state); with the forward's checkpoints (a state every 8 steps) under
    a few hundred MB at Jamba's call."""
    b, s, di, ds = SCRATCH[case]
    got = bwd_scratch_shapes(b, s, di, ds, block=64, terms=32)
    assert got == {"part_bc": (-(-di // 64), b, s, 32),
                   "part_a": (b, di, ds)}
    if case == "train":
        ckpt = b * -(-s // 8) * di * ds
        assert 4 * (sum(np.prod(v) for v in got.values()) + ckpt) < 400e6

