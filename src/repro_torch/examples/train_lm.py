"""End-to-end training script, the reference's ``examples/train_lm.py`` on
the port: a ~100M-param LM with the full substrate — synthetic data
pipeline, AdamW, checkpointing with auto-resume, preemption handling,
straggler monitoring.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m --steps 30
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset tiny \\
        --device cpu

Kill it mid-run and start it again: it resumes from the last checkpoint.
A checkpoint is labelled by the number of steps it holds, as
``repro_torch.launch.train`` labels them, so a resumed run takes the
step after the last one done and ends where an uninterrupted run ends
(the reference labels the checkpoint written after step s as s and
repeats step s on resume).  The steps run through the launcher's loop,
``launch.train.train_loop``; on the card attention runs its forward and
backward kernels.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..device import resolve_device
from ..launch.train import train_loop
from ..models import registry
from ..models.common import ModelConfig
from ..train.checkpoint import CheckpointManager
from ..train.data import DataConfig, SyntheticLM
from ..train.fault_tolerance import (PreemptionHandler, StragglerMonitor,
                                     resume_or_init)
from ..train.optimizer import OptConfig
from ..train.train_step import init_train_state, make_train_step

PRESETS = {
    # ~100K — CI smoke scale (tests/test_torch_examples.py)
    "tiny": ModelConfig(name="lmtiny", family="dense", n_layers=2,
                        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                        vocab=512, dtype="float32", remat=False,
                        attn_q_chunk=32, attn_kv_chunk=32),
    # ~10M — fast on CPU
    "10m": ModelConfig(name="lm10m", family="dense", n_layers=4,
                       d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                       vocab=8192, dtype="float32", remat=False,
                       attn_q_chunk=128, attn_kv_chunk=128),
    # ~100M — the assignment's end-to-end scale
    "100m": ModelConfig(name="lm100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
                        vocab=16384, dtype="float32", remat=False,
                        attn_q_chunk=256, attn_kv_chunk=256),
}
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "artifacts"
                       / "train_lm_torch" / "ckpt")


def main(argv=None, on_step=None):
    """The script's entry; returns the final train state.  ``on_step(step,
    metrics, seconds)`` is called after each step's line, as
    ``launch.train.train_loop`` calls it."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--preset", default="10m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain twins)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    print(f"model: {cfg.name} "
          f"({registry.count_params(cfg) / 1e6:.1f}M params)", flush=True)
    oc = OptConfig(peak_lr=3e-3, warmup_steps=20, decay_steps=args.steps)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)
    data = SyntheticLM(dc)

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    fresh = init_train_state(cfg, oc, seed=0, device=device)
    state, start = resume_or_init(mgr, fresh)
    if start:
        print(f"resumed from step {start}", flush=True)
    step_fn = make_train_step(cfg, oc, grad_accum=2)
    handler = PreemptionHandler()
    mon = StragglerMonitor()
    last = {"loss": float("nan")}

    def report(step, metrics, seconds):
        last["loss"] = float(metrics["loss"])
        straggler = bool(mon.flagged) and mon.flagged[-1][0] == mon.count
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {last['loss']:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"lr {float(metrics['lr']):.2e}"
                  + ("  [straggler]" if straggler else ""), flush=True)
        if on_step is not None:
            on_step(step, metrics, seconds)

    try:
        state, _, preempted = train_loop(
            cfg, state, step_fn, data, start, args.steps, device, mgr=mgr,
            ckpt_every=args.ckpt_every, handler=handler, monitor=mon,
            on_step=report, log=lambda line: None)
    finally:
        handler.restore_handlers()
    if preempted:
        print("preemption signal — checkpointed and exiting", flush=True)
    else:
        mgr.save(args.steps, state)
        print(f"done; final loss {last['loss']:.4f} "
              f"(checkpoints in {args.ckpt_dir})", flush=True)
    mgr.wait()
    return state


if __name__ == "__main__":
    main()
