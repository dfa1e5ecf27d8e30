"""The port's four example programs (``repro_torch.examples``) on the CPU,
at the sizes of ``tests/test_examples_smoke.py``, against the
reference's ``examples/`` where the two compute the same thing.

* ``quickstart`` and ``qstar_ici_demo`` are deterministic: their output
  (N-Rank iterations, the w_NR grid, the bitmap, both simulations'
  summaries, LCV, throughput, max link loads, the replan) equals the
  reference example's, line for line, run in ``reference()``;
  ``qstar_ici_demo --ml`` reads the recorded HLO.
* ``train_lm tiny``: the reference's lines; started from the reference's
  parameters (``convert.train_state_from_numpy``) its two losses equal
  the reference's within 1e-5; preempted by SIGTERM and resumed it ends
  equal to an uninterrupted run, bit for bit.
* ``serve_decode`` for a decoder, the encoder–decoder and the hybrid:
  the reference's lines.

The JAX package is called only inside ``test_torch_oracle.reference()``.
"""

import contextlib
import importlib.util
import io
import os
import signal

import numpy as np
import pytest
import torch

from test_torch_oracle import reference, torch_one_thread  # noqa: F401

from repro_torch import convert, kernels
from repro_torch.examples import (qstar_ici_demo, quickstart, serve_decode,
                                  train_lm)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, SyntheticLM

pytestmark = pytest.mark.usefixtures("torch_one_thread")

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args, **kw) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("name,kw", [
    ("quickstart", dict(cycles=1500)),
    ("qstar_ici_demo", dict(side=6, greedy_sweeps=1)),
])
def test_noc_example_prints_the_reference_numbers(name, kw):
    port = {"quickstart": quickstart, "qstar_ici_demo": qstar_ici_demo}[name]
    before = dict(kernels.LAUNCHES)
    got = _stdout(port.main, device="cpu", **kw)
    assert kernels.LAUNCHES == before       # the CPU runs the twins
    with reference():
        want = _stdout(_reference_example(name).main, **kw)
    assert got == want


def test_ici_demo_reads_the_recorded_hlo():
    """``--ml``: the qwen2-moe decode flows recorded under the ML-traffic
    stage's label, printed under the reference's own name; a phase never
    recorded names the command that records it."""
    lines = _stdout(qstar_ici_demo.main, side=4, greedy_sweeps=1,
                    ml_arch="qwen2-moe-a2.7b", device="cpu")
    head = lines[0].split()
    assert head[:4] == ["derived", "qwen2-moe-a2.7b@1x8:", "phases",
                        "decode,"] and int(head[4]) > 0
    assert any(line.startswith("Q-StaR BiDOR-G") for line in lines)
    with pytest.raises(FileNotFoundError, match="regen_torch.py"):
        qstar_ici_demo.main(side=4, ml_arch="qwen2-moe-a2.7b",
                            phases=("fwd",), device="cpu")


TINY = ["--preset", "tiny", "--batch", "2", "--seq", "16",
        "--ckpt-every", "100", "--device", "cpu"]


def test_train_lm_tiny_prints_the_reference_lines(tmp_path):
    lines = _stdout(train_lm.main, TINY + [
        "--steps", "2", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert lines[0] == "model: lmtiny (0.1M params)"
    assert lines[1].startswith("step    0 loss")
    assert lines[-1].startswith("done; final loss")
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 2


def test_train_lm_tiny_from_the_reference_parameters(tmp_path, monkeypatch):
    """The reference example's optimizer, data and ``grad_accum=2`` step,
    jitted, from ``registry.init(PRNGKey(0))``; the port's example from
    the same parameters: each step's loss within 1e-5."""
    ref = _reference_example("train_lm")
    cfg = train_lm.PRESETS["tiny"]
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=2))
    with reference():
        import jax

        oc = ref.OptConfig(peak_lr=3e-3, warmup_steps=20, decay_steps=2)
        state = ref.init_train_state(ref.PRESETS["tiny"], oc,
                                     jax.random.PRNGKey(0))
        start = jax.tree.map(np.asarray, state)
        step_fn = jax.jit(ref.make_train_step(ref.PRESETS["tiny"], oc,
                                              grad_accum=2))
        want = []
        for s in range(2):
            batch = {k: jax.numpy.asarray(v)
                     for k, v in data.get_batch(s).items()}
            state, met = step_fn(state, batch)
            want.append(float(met["loss"]))
    monkeypatch.setattr(train_lm, "init_train_state",
                        lambda cfg, oc, seed, device:
                        convert.train_state_from_numpy(start, cfg, device))
    got = []
    _stdout(train_lm.main, TINY + ["--steps", "2", "--ckpt-dir",
                                   str(tmp_path / "ckpt")],
            on_step=lambda step, m, s: got.append(float(m["loss"])))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_train_lm_preempted_and_resumed_equals_uninterrupted(tmp_path):
    """SIGTERM after step 3 writes a checkpoint of 4 steps; the rerun
    prints that it resumed and ends with the uninterrupted run's
    parameters and moments, bit for bit."""
    argv = TINY + ["--steps", "6"]
    whole = train_lm.main(argv + ["--ckpt-dir", str(tmp_path / "a")])

    def stop_after_3(step, metrics, seconds):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    cut_dir = str(tmp_path / "b")
    lines = _stdout(train_lm.main, argv + ["--ckpt-dir", cut_dir],
                    on_step=stop_after_3)
    assert lines[-1].startswith("preemption signal")
    assert CheckpointManager(cut_dir).latest_step() == 4
    lines = _stdout(train_lm.main, argv + ["--ckpt-dir", cut_dir])
    assert "resumed from step 4" in lines
    resumed = train_lm.main(argv + ["--ckpt-dir", cut_dir])   # already done
    a = dict(whole["params"].named_parameters())
    b = dict(resumed["params"].named_parameters())
    assert all(torch.equal(a[n], b[n]) for n in a)
    for part in ("m", "v"):
        assert all(torch.equal(x, y) for x, y in zip(
            whole["opt"][part].values(), resumed["opt"][part].values()))
    assert int(resumed["opt"]["step"]) == 6


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-base",
                                  "jamba-1.5-large-398b"])
def test_serve_decode_prints_the_reference_lines(arch):
    lines = _stdout(serve_decode.main, [
        "--arch", arch, "--batch", "2", "--prompt-len", "4", "--tokens",
        "3", "--device", "cpu"])
    assert lines[0].startswith(f"arch={arch.split('-')[0]}")
    assert "batch=2 generated 3 tokens/seq" in lines[0]
    assert lines[1].startswith("sample: [")
    assert lines[-1] == "determinism check passed"
