"""The port's training substrate on the CPU against the JAX package.

* Data: ``SyntheticLM`` batches bit-identical to the reference's for
  several (seed, step, shard, num_shards).
* Optimizer: from identical numpy parameters, gradients and state (a
  step-2 state with nonzero moments), ``adamw_update`` matches the
  reference's: fp32 moments — parameters, m and v within 1e-6 of each
  leaf's largest value; int8 moments — codes equal, scales within 1e-6;
  the schedule within 1e-6 relative (a few fp32 ulps: cos);
  ``quantize_i8``'s codes equal and its scales within 1e-6; the
  weight-decay mask equal leaf by leaf for every architecture's smoke
  config (and the port's parameters cover the reference's leaves one to
  one).
* Three steps of ``make_train_step`` with ``grad_accum`` 1 and 2, each
  side from the same initial state: each step's loss within 1e-6
  relative, and each step's gradients, read from both optimizers' m
  under ``b1 = 0`` and no clip (m = g exactly), within 5e-5 of the
  leaf's largest (the gradients, not the parameters: AdamW's first
  update is about lr·sign(g) and would amplify rounding in tiny
  gradients).
* ``cross_entropy`` with a mask and z-loss within 1e-6 relative.
* ``convert``'s train-state round trip, fp32 and int8 moments.

One step's loss and gradients for five families are held in
``tests/test_torch_train_grads.py``.

The JAX package is called only inside ``test_torch_oracle.reference()``.
"""

import numpy as np
import pytest
import torch

from test_torch_oracle import reference, torch_one_thread  # noqa: F401

from repro_torch import convert
from repro_torch.configs import get_arch, list_archs
from repro_torch.launch.train import make_batch
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pts
from repro_torch.train.data import DataConfig, SyntheticLM

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SEQ, BATCH = 16, 4
GRAD_TOL = 5e-5     # of a leaf's largest |gradient|
LOSS_RTOL = 1e-6


def _ref_batch(cfg, host, embeds=None):
    import jax.numpy as jnp

    b = {k: jnp.asarray(v) for k, v in host.items()}
    if cfg.family == "vlm":
        b["positions"] = jnp.asarray(np.ascontiguousarray(np.broadcast_to(
            np.arange(SEQ, dtype=np.int32)[None, None], (3, BATCH, SEQ))))
    if embeds is not None:
        b["embeds"] = jnp.asarray(embeds)
    return b


def _port_batch(cfg, host, embeds=None):
    b = make_batch(cfg, host, "cpu")
    if embeds is not None:
        b["embeds"] = torch.as_tensor(embeds)
    return b


def _hold_leaves(got: dict, want_tree: dict, tol: float, label: str):
    """Each port tensor against the reference leaf of its name, within
    ``tol`` of the leaf's largest |value|."""
    for name, g in got.items():
        w = convert._leaf(want_tree, name)
        top = float(np.abs(w).max())
        err = float(np.abs(g.detach().float().numpy() - w).max())
        assert err <= tol * max(top, 1e-30), f"{label} {name}: {err} / {top}"


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,step,num_shards", [
    (0, 0, 1), (3, 5, 4), (7, 123, 2), (11, 10_000, 8)])
def test_batches_are_bit_identical(seed, step, num_shards):
    cfg = DataConfig(vocab=50_000, seq_len=33, global_batch=8, seed=seed)
    port = SyntheticLM(cfg)
    with reference():
        from repro.train import data as rdata

        ref = rdata.SyntheticLM(rdata.DataConfig(
            vocab=50_000, seq_len=33, global_batch=8, seed=seed))
        for shard in range(num_shards):
            want = ref.get_batch(step, shard, num_shards)
            got = port.get_batch(step, shard, num_shards)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_adamw_update_matches_the_reference(moment_dtype):
    arch = "qwen2-moe-a2.7b"        # routers, experts, norms: every kind
    cfg = get_arch(arch).smoke
    kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10, clip_norm=0.5,
              moment_dtype=moment_dtype)
    rng = np.random.default_rng(0)
    with reference():
        import jax

        from repro.configs import get_arch as ref_arch
        from repro.models import registry as rreg
        from repro.train import optimizer as ropt

        ocfg = ropt.OptConfig(**kw)
        params = jax.tree.map(np.asarray, rreg.init(ref_arch(arch).smoke,
                                                    jax.random.PRNGKey(0)))
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.05)
                             .astype(np.float32), params)
        opt = ropt.init_opt_state(ocfg, params)
        update = jax.jit(lambda p, g, o: ropt.adamw_update(ocfg, p, g, o))
        for _ in range(2):          # moments and step not at their start
            _, opt, _ = update(params, grads, opt)
        start = jax.tree.map(np.asarray, {"params": params, "opt": opt})
        p3, o3, met = update(params, grads, opt)
        p3, o3 = jax.tree.map(np.asarray, (p3, o3))
        want_norm, want_lr = float(met["grad_norm"]), float(met["lr"])
    state = convert.train_state_from_numpy(start, cfg, "cpu")
    named = dict(state["params"].named_parameters())
    g = {n: torch.as_tensor(convert._leaf(grads, n)) for n in named}
    opt, met = popt.adamw_update(popt.OptConfig(**kw), state["params"], g,
                                 state["opt"])
    assert int(opt["step"]) == int(o3["step"]) == 3
    np.testing.assert_allclose(float(met["grad_norm"]), want_norm, rtol=1e-6)
    np.testing.assert_allclose(float(met["lr"]), want_lr, rtol=1e-7)
    _hold_leaves(named, p3, 1e-6, "params")
    for part in ("m", "v"):
        if moment_dtype == "float32":
            _hold_leaves(opt[part], o3[part], 1e-6, part)
            continue
        for n, mom in opt[part].items():
            want = convert._leaf(o3[part], n)
            np.testing.assert_array_equal(mom["q"].numpy(), want["q"])
            np.testing.assert_allclose(mom["s"].numpy(), want["s"],
                                       rtol=1e-6, atol=0)


def test_schedule_and_quantization_match_the_reference():
    cfg = dict(peak_lr=1e-3, min_lr=1e-4, warmup_steps=10, decay_steps=100)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal(s).astype(np.float32) * 10
          for s in ((7,), (3, 256), (4, 100), (2, 3, 512))]
    with reference():
        import jax.numpy as jnp

        from repro.train import optimizer as ropt

        want_lr = [float(ropt.schedule(ropt.OptConfig(**cfg), jnp.int32(s)))
                   for s in range(0, 120, 7)]
        want_q = [tuple(np.asarray(a) for a in ropt.quantize_i8(
            jnp.asarray(x))) for x in xs]
    got_lr = [float(popt.schedule(popt.OptConfig(**cfg),
                                  torch.tensor(s, dtype=torch.int32)))
              for s in range(0, 120, 7)]
    np.testing.assert_allclose(got_lr, want_lr, rtol=1e-6, atol=0)
    for x, (codes, scale) in zip(xs, want_q):
        q, s = popt.quantize_i8(torch.as_tensor(x))
        np.testing.assert_array_equal(q.numpy(), codes)
        np.testing.assert_allclose(s.numpy(), scale, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", list_archs())
def test_decay_mask_picks_the_reference_leaves(arch):
    """Leaf by leaf: the port's parameters are the reference's leaves
    (one to one, by tree path) and ``decay_mask`` of each equals the
    reference's ``_decay_mask`` of its path."""
    from repro_torch.models import registry

    model = registry.init(get_arch(arch).smoke, device="meta")
    port = {tuple(convert._split_name(n)[0]): popt.decay_mask(n)
            for n, _ in model.named_parameters()}
    with reference():
        import jax

        from repro.configs import get_arch as ref_arch
        from repro.models import registry as rreg
        from repro.train import optimizer as ropt

        flat = jax.tree_util.tree_flatten_with_path(
            rreg.abstract_params(ref_arch(arch).smoke))[0]
        want = {tuple(k.key for k in path): ropt._decay_mask(path)
                for path, _ in flat}
    assert port == want


# --------------------------------------------------------------------- #
# loss, state conversion
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,accum", [("internlm2-1.8b", 1),
                                        ("internlm2-1.8b", 2),
                                        ("qwen2-vl-2b", 2)])
def test_three_steps_match_the_reference(arch, accum):
    """qwen2-vl with accumulation 2 splits its (3, B, S) positions on
    axis 1, as the reference interleaves them."""
    cfg = get_arch(arch).smoke
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=2))
    kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=3, b1=0.0,
              clip_norm=1e30)
    with reference():
        import jax

        from repro.configs import get_arch as ref_arch
        from repro.train import optimizer as ropt
        from repro.train import train_step as rts

        rcfg = ref_arch(arch).smoke
        ocfg = ropt.OptConfig(**kw)
        state = rts.init_train_state(rcfg, ocfg, jax.random.PRNGKey(0))
        start = jax.tree.map(np.asarray, state)
        step_fn = jax.jit(rts.make_train_step(rcfg, ocfg, accum))
        want = []
        for s in range(3):
            state, met = step_fn(state, _ref_batch(cfg, data.get_batch(s)))
            want.append((float(met["loss"]),
                         jax.tree.map(np.asarray, state["opt"]["m"])))
    state = convert.train_state_from_numpy(start, cfg, "cpu")
    step_fn = pts.make_train_step(cfg, popt.OptConfig(**kw), accum)
    for s, (loss, grads) in enumerate(want):
        state, met = step_fn(state, _port_batch(cfg, data.get_batch(s)))
        np.testing.assert_allclose(float(met["loss"]), loss, rtol=LOSS_RTOL)
        _hold_leaves(state["opt"]["m"], grads, GRAD_TOL, f"step {s}")


def test_cross_entropy_with_mask_and_z_loss_matches():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    with reference():
        import jax.numpy as jnp

        from repro.train import train_step as rts

        want = [float(rts.cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels), m, z_loss=z))
                for m in (None, jnp.asarray(mask)) for z in (0.0, 1e-2)]
    got = [float(pts.cross_entropy(torch.as_tensor(logits),
                                   torch.as_tensor(labels), m, z_loss=z))
           for m in (None, torch.as_tensor(mask)) for z in (0.0, 1e-2)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_train_state_round_trips_through_convert(moment_dtype):
    """The reference's train state → the port's → the reference's
    layout: the same tree, the same arrays."""
    arch = "qwen2-moe-a2.7b"
    with reference():
        import jax

        from repro.configs import get_arch as ref_arch
        from repro.train import optimizer as ropt
        from repro.train import train_step as rts

        ocfg = ropt.OptConfig(moment_dtype=moment_dtype)
        state = rts.init_train_state(ref_arch(arch).smoke, ocfg,
                                     jax.random.PRNGKey(1))
        # moments with values in them
        grads = jax.tree.map(lambda p: p * 0.5 + 0.01, state["params"])
        params, opt, _ = jax.jit(
            lambda p, g, o: ropt.adamw_update(ocfg, p, g, o))(
                state["params"], grads, state["opt"])
        want = jax.tree.map(np.asarray, {"params": params, "opt": opt})
    port = convert.train_state_from_numpy(want, get_arch(arch).smoke, "cpu")
    assert all(p.requires_grad for p in port["params"].parameters())
    got = convert.train_state_to_numpy(port)
    flat_w, tree_w = _flatten(want)
    flat_g, tree_g = _flatten(got)
    assert tree_w == tree_g
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out, keys = [], []
        for k in sorted(tree):
            sub, sk = _flatten(tree[k], prefix + (k,))
            out += sub
            keys.append((k, sk))
        return out, keys
    return [(prefix, np.asarray(tree))], None
