"""The port's training substrate on its own (no JAX): the reference's
``tests/test_train_substrate.py`` ported to ``repro_torch.train``, plus
what the port adds — bf16 leaves stored as their bit pattern and
restored bit for bit, restore onto the like-state's dtype, and the
launcher preempted by SIGTERM and resumed, ending equal to an
uninterrupted run bit for bit.
"""

import os
import signal

import numpy as np
import pytest
import torch
from _propcheck import given, settings, st

from repro_torch.launch import train as launch
from repro_torch.train.checkpoint import CheckpointManager, flatten
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.fault_tolerance import (
    ElasticMesh, PreemptionHandler, StragglerMonitor, resume_or_init)
from repro_torch.train.optimizer import (
    OptConfig, adamw_update, dequantize_i8, init_opt_state, quantize_i8,
    schedule)


class _W(torch.nn.Module):
    """A one-parameter model: ``w``."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(w, dtype=torch.float32))


# --------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------- #
def test_schedule_warmup_and_decay():
    cfg = OptConfig(peak_lr=1e-3, min_lr=1e-4, warmup_steps=10,
                    decay_steps=100)

    def lr(s):
        return float(schedule(cfg, torch.tensor(s, dtype=torch.int32)))

    assert lr(0) == 0.0
    assert np.isclose(lr(10), 1e-3)
    assert np.isclose(lr(100), 1e-4, rtol=0.01)
    assert lr(5) < 1e-3


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1),
       st.sampled_from([(7,), (3, 256), (4, 100), (2, 3, 512)]))
def test_int8_quantization_roundtrip_error_bound(seed, shape):
    """Property: |dequant(quant(x)) − x| ≤ blockmax/127 per element."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32) * 10)
    q, s = quantize_i8(x)
    y = dequantize_i8(q, s, x.shape)
    assert q.shape == x.shape and q.dtype == torch.int8
    err = (y - x).abs()
    assert float(err.max()) <= float(x.abs().max()) / 127 + 1e-6


def test_adamw_minimizes_quadratic():
    cfg = OptConfig(peak_lr=0.1, warmup_steps=0, decay_steps=10_000,
                    weight_decay=0.0)
    params = _W([3.0, -2.0])
    opt = init_opt_state(cfg, params)
    for _ in range(200):
        opt, _ = adamw_update(cfg, params, {"w": 2 * params.w.detach()}, opt)
    assert float(params.w.detach().abs().max()) < 0.05


def test_adamw_int8_matches_fp32_roughly():
    g = torch.Generator().manual_seed(0)
    w0 = torch.randn((4, 256), generator=g)
    grads = {"w": torch.randn((4, 256), generator=g)}
    outs = {}
    for md in ("float32", "int8"):
        cfg = OptConfig(peak_lr=1e-2, warmup_steps=0, weight_decay=0.0,
                        moment_dtype=md)
        p = _W(w0.clone())
        o = init_opt_state(cfg, p)
        for _ in range(5):
            o, _ = adamw_update(cfg, p, grads, o)
        outs[md] = p.w.detach().numpy()
    # int8 moments track fp32 closely but not exactly: compare the update's
    # direction and magnitude, not elementwise equality
    diff = np.abs(outs["float32"] - outs["int8"])
    base = np.abs(outs["float32"] - w0.numpy()) + 1e-6
    assert np.median(diff / base) < 0.5


def test_grad_clipping_bounds_update():
    cfg = OptConfig(peak_lr=1.0, warmup_steps=0, clip_norm=1.0,
                    weight_decay=0.0)
    params = _W(torch.zeros(3))
    opt = init_opt_state(cfg, params)
    _, m = adamw_update(cfg, params, {"w": torch.full((3,), 1e6)}, opt)
    assert float(m["grad_norm"]) > 1e5  # reported raw


# --------------------------------------------------------------------- #
# data pipeline
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("num_shards", [2, 4, 8])
def test_data_deterministic_and_sharded_consistently(num_shards):
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=8, seed=3)
    d = SyntheticLM(cfg)
    b1, b2 = d.get_batch(5), d.get_batch(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    # sharded generation must tile the global batch exactly
    parts = [d.get_batch(5, shard=i, num_shards=num_shards)["tokens"]
             for i in range(num_shards)]
    np.testing.assert_array_equal(np.concatenate(parts), b1["tokens"])


def test_data_labels_are_shifted_tokens():
    d = SyntheticLM(DataConfig(vocab=50, seq_len=8, global_batch=2))
    b = d.get_batch(0)
    assert b["tokens"].shape == (2, 8) and b["labels"].shape == (2, 8)
    # labels[t] == tokens[t+1] within the same underlying stream
    np.testing.assert_array_equal(b["labels"], d._tokens(0, np.arange(2))[:, 1:])


def test_data_steps_differ():
    d = SyntheticLM(DataConfig(vocab=1000, seq_len=16, global_batch=4))
    assert not np.array_equal(d.get_batch(0)["tokens"],
                              d.get_batch(1)["tokens"])


# --------------------------------------------------------------------- #
# checkpointing + fault tolerance
# --------------------------------------------------------------------- #
def _tiny_state(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 8), generator=g).to(dtype),
                       "b": torch.zeros(8, dtype=dtype)},
            "opt": {"m": torch.ones((4, 8)),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _equal(a, b) -> bool:
    fa, fb = flatten(a), flatten(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(fa, fb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_roundtrip(tmp_path, dtype):
    """bf16 leaves go to disk as their uint16 bit pattern and come back
    bit for bit."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _tiny_state(dtype=dtype)
    mgr.save(100, state)
    restored, step = mgr.restore(_tiny_state(seed=1, dtype=dtype))
    assert step == 100 and _equal(state, restored)
    if dtype == torch.bfloat16:
        leaf = np.load(tmp_path / "step_00000100" / "leaf_00000.npy")
        assert leaf.dtype == np.uint16


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _tiny_state()
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.latest_step() == 4
    dirs = sorted(os.listdir(tmp_path))
    assert "step_00000001" not in dirs and "step_00000004" in dirs
    assert len([d for d in dirs if d.startswith("step_")]) == 2


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = _tiny_state()
    mgr.save(5, state, async_=True)
    mgr.wait()
    assert mgr.latest_step() == 5


def test_checkpoint_atomicity_no_partial_visible(tmp_path):
    """A manifest only appears after the atomic rename."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    assert mgr.latest_step() is None
    # a stray tmp dir must not be picked up
    os.makedirs(tmp_path / "step_00000009.tmp0")
    assert mgr.latest_step() is None


def test_resume_or_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    fresh = _tiny_state()
    state, step = resume_or_init(mgr, fresh)
    assert step == 0
    mgr.save(42, state)
    _, step2 = resume_or_init(mgr, _tiny_state(seed=1))
    assert step2 == 42


def test_elastic_mesh_shrinks_data_axis():
    em = ElasticMesh(model_degree=1)
    ndev = torch.cuda.device_count() or 1
    assert em.build() == {"data": ndev, "model": 1}
    mesh1 = em.build(["cpu"])                        # (1, 1)
    assert mesh1["data"] == 1
    assert em.grad_accum_for(global_batch=64, per_chip_batch=4,
                             mesh=mesh1) == 16
    mesh2 = em.build(["cpu", "cpu"])                 # (2, 1): accum halves
    assert mesh2["data"] == 2
    assert em.grad_accum_for(global_batch=64, per_chip_batch=4,
                             mesh=mesh2) == 8


def test_elastic_mesh_rejects_insufficient_devices():
    with pytest.raises(RuntimeError):
        ElasticMesh(model_degree=64).build()


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(alpha=0.5, threshold=2.0, warmup=2)
    flags = [mon.observe(0.1) for _ in range(8)]
    assert not any(flags)
    assert mon.observe(0.5) is True      # 5× the EWMA
    assert mon.observe(0.1) is False     # EWMA not poisoned
    assert len(mon.flagged) == 1


def test_preemption_handler():
    h = PreemptionHandler(signals=())
    assert h.should_stop is False
    h._handle(None, None)
    assert h.should_stop is True


def test_checkpoint_restore_onto_new_topology(tmp_path):
    """Elastic resume: the like-state decides each leaf's dtype and
    device; the values are the checkpoint's (fp32 → bf16 here, as a
    cast)."""
    mgr = CheckpointManager(str(tmp_path))
    state = _tiny_state()
    mgr.save(9, state)
    like = _tiny_state(seed=3)
    like["params"] = {k: v.to(torch.bfloat16)
                      for k, v in like["params"].items()}
    restored, step = mgr.restore(like)
    assert step == 9 and restored is like
    for k, v in state["params"].items():
        assert restored["params"][k].dtype == torch.bfloat16
        assert torch.equal(restored["params"][k], v.to(torch.bfloat16))
    assert torch.equal(restored["opt"]["m"], state["opt"]["m"])


# --------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------- #
def _params(state) -> dict:
    return {n: p.detach().clone() for n, p in
            state["params"].named_parameters()}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_launcher_preempted_and_resumed_equals_uninterrupted(tmp_path,
                                                             one_thread):
    """``main`` at the smoke config on the CPU: SIGTERM after step 3
    writes a final checkpoint of 4 steps; the rerun resumes at step 4
    and ends with the uninterrupted run's parameters and optimizer state,
    bit for bit; the SIGTERM handler is restored after each run."""
    argv = ["--arch", "internlm2-1.8b", "--smoke", "--steps", "7",
            "--seq", "16", "--device", "cpu", "--ckpt-every", "100"]
    whole = launch.main(argv + ["--ckpt-dir", str(tmp_path / "a")])

    def stop_after_3(step, metrics, seconds):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    cut = launch.main(argv + ["--ckpt-dir", str(tmp_path / "b")],
                      on_step=stop_after_3)
    assert signal.getsignal(signal.SIGTERM) == before
    assert int(cut["opt"]["step"]) == 4
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 4
    resumed = launch.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert int(resumed["opt"]["step"]) == int(whole["opt"]["step"]) == 7
    a, b = _params(whole), _params(resumed)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert _equal(whole["opt"], resumed["opt"])


def test_launcher_takes_only_the_one_device_mesh():
    with pytest.raises(NotImplementedError, match="11.7 and 5"):
        launch.main(["--smoke", "--device", "cpu", "--mesh", "2x1"])


def test_launcher_cuts_depth_and_experts_never_widths(tmp_path, one_thread):
    """``--layers``, ``--experts``, ``--moments`` and ``--peak-lr``, as
    ``chip_smoke.py`` trains Jamba on one card: the smoke at one
    super-block of 4 layers, its experts cut to 0 (every FFN dense, top-k
    0), int8 moments, no checkpoint (``--ckpt-every 0``); the widths are
    the smoke's, and the loss falls over 4 steps.  A depth that is not a
    whole number of super-blocks raises."""
    from repro_torch.configs import get_arch
    from repro_torch.models import registry

    losses = []
    argv = ["--arch", "jamba-1.5-large-398b", "--smoke", "--layers", "4",
            "--experts", "0", "--moments", "int8", "--peak-lr", "2e-3",
            "--steps", "4", "--seq", "16", "--global-batch", "2",
            "--device", "cpu", "--ckpt-every", "0", "--ckpt-dir",
            str(tmp_path / "ckpt")]
    state = launch.main(argv, on_step=lambda s, m, t: losses.append(
        float(m["loss"])))
    assert not (tmp_path / "ckpt").exists()
    smoke = get_arch("jamba-1.5-large-398b").smoke
    cut, opt_cfg, data = launch.setup(launch.parse_args(argv))
    assert cut == launch.cut_config(smoke, 4, 0)
    assert (opt_cfg.peak_lr, opt_cfg.moment_dtype) == (2e-3, "int8")
    assert (data.cfg.seq_len, data.cfg.global_batch) == (16, 2)
    assert (cut.n_layers, cut.moe_experts, cut.moe_topk) == (4, 0, 0)
    assert cut.replace(n_layers=smoke.n_layers, moe_experts=smoke.moe_experts,
                       moe_topk=smoke.moe_topk) == smoke
    assert sum(p.numel() for p in state["params"].parameters()) \
        == registry.count_params(cut) < registry.count_params(smoke)
    assert all(m["q"].dtype == torch.int8 for m in state["opt"]["m"].values())
    assert losses[-1] < losses[0]
    assert launch.cut_config(smoke) == smoke
    assert launch.cut_config(smoke, experts=1).moe_topk == 1
    with pytest.raises(ValueError, match="attn_period"):
        launch.main(argv[:3] + ["--layers", "6", "--steps", "1",
                                "--device", "cpu", "--ckpt-dir",
                                str(tmp_path / "odd")])
