"""Training launcher, the reference's ``launch/train.py`` on one device.

Runs any architecture with the full substrate: synthetic data, AdamW,
checkpoint auto-resume, preemption handling and straggler monitoring.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --smoke --steps 20 --device cpu

Without ``--smoke`` the published configuration is trained on the card.
A model that one card cannot hold is cut in depth and experts, never in
width: ``--layers N`` keeps the first N layers (a hybrid's a multiple of
its ``attn_period``), ``--experts E`` keeps E experts (0: every FFN the
dense SwiGLU of the same d_ff), and ``--moments int8`` stores AdamW's
moments as int8 codes with block scales.  ``chip_smoke.py``'s
``train_hybrid`` phase runs Jamba so on one H100 80GB, with no
checkpoint (``--ckpt-every 0``; its state, 9.0e9 bf16 weights and their
int8 moments, would write ~36 GB):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch jamba-1.5-large-398b --layers 8 --experts 0 --moments int8 \\
        --global-batch 2 --seq 1024 --peak-lr 1e-4 --steps 6 --ckpt-every 0

The reference's meshes (``--mesh DxM``, ``prod``, ``prod2``) have no
port: only ``1x1`` runs.  A checkpoint is labelled by the number of
steps it holds, so a resumed run takes the step after the last one
done and ends where an uninterrupted run ends (the reference labels the
checkpoint written after step s as s and repeats step s on resume).
:func:`train_loop` is the step loop alone (no checkpoint unless a
manager is given), for a caller that drives it at full width.
``--ckpt-every 0`` trains with no checkpoint: none read, none written.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..configs import get_arch
from ..device import resolve_device
from ..models import registry
from ..train.checkpoint import CheckpointManager
from ..train.data import DataConfig, SyntheticLM
from ..train.fault_tolerance import (ElasticMesh, PreemptionHandler,
                                     StragglerMonitor, resume_or_init)
from ..train.optimizer import OptConfig
from ..train.train_step import init_train_state, make_train_step

DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "artifacts"
                       / "train_torch" / "ckpt")


def make_batch(cfg, host: dict, device) -> dict:
    """The device batch of ``SyntheticLM.get_batch``'s arrays, with the
    reference's extras: text-only M-RoPE ids (equal t/h/w rows) for the
    vlm, zero frame embeddings for the encoder–decoder."""
    batch = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
    b, s = host["tokens"].shape
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None, None],
                              (3, b, s))
        batch["positions"] = torch.as_tensor(np.ascontiguousarray(pos),
                                             device=device)
    if cfg.family == "encdec":
        batch["embeds"] = torch.zeros((b, cfg.enc_seq, cfg.d_model),
                                      dtype=cfg.torch_dtype, device=device)
    return batch


def train_loop(cfg, state, step_fn, data: SyntheticLM, start: int,
               steps: int, device, *, mgr: CheckpointManager | None = None,
               ckpt_every: int = 25, handler: PreemptionHandler | None = None,
               monitor: StragglerMonitor | None = None, on_step=None,
               log=print):
    """Steps ``start`` … ``steps − 1`` on ``data``'s batches of those
    indices.  Each step's loss is read back (a synchronise), so the
    straggler monitor and ``on_step(step, metrics, seconds)`` see the
    step's wall time.  A checkpoint every ``ckpt_every`` steps done
    (async) when ``mgr`` is given; on preemption a final one, then
    returns.  Returns (state, steps done, preempted)."""
    for step in range(start, steps):
        t0 = time.perf_counter()
        if monitor is not None:
            monitor.start()
        batch = make_batch(cfg, data.get_batch(step), device)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        slow = monitor.stop() if monitor is not None else False
        if on_step is not None:
            on_step(step, metrics, dt)
        if step % 5 == 0 or step == steps - 1:
            log(f"step {step:4d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.2f}"
                + ("  [straggler]" if slow else ""))
        done = step + 1
        if mgr is not None and done % ckpt_every == 0:
            mgr.save(done, state, async_=True)
        if handler is not None and handler.should_stop:
            log("preempted — final checkpoint")
            if mgr is not None:
                mgr.save(done, state)
            return state, done, True
    return state, steps, False


def cut_config(cfg, layers: int | None = None, experts: int | None = None):
    """``cfg`` with ``layers`` layers and ``experts`` MoE experts (top-k
    kept, at most ``experts``; 0 makes every FFN dense); None leaves a
    field as it is.  Widths are never cut."""
    kw = {}
    if layers is not None:
        kw["n_layers"] = layers
    if experts is not None:
        kw["moe_experts"] = experts
        kw["moe_topk"] = min(cfg.moe_topk, experts)
    return cfg.replace(**kw) if kw else cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (widths unchanged)")
    ap.add_argument("--experts", type=int, default=None,
                    help="cut the MoE experts to E, 0 for dense FFNs "
                         "(widths unchanged)")
    ap.add_argument("--peak-lr", type=float, default=1e-3,
                    help="the schedule's peak (the reference's 1e-3; a "
                         "wide model wants less: Jamba's d 8 192 1e-4)")
    ap.add_argument("--moments", default="float32",
                    choices=("float32", "int8"),
                    help="AdamW's moment dtype (int8: block-quantized)")
    ap.add_argument("--mesh", default="1x1",
                    help="only 1x1: the port runs on one device")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=25,
                    help="steps between checkpoints; 0: no checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain twins)")
    return ap.parse_args(argv)


def setup(args):
    """The model's config, AdamW's and the data of parsed arguments:
    what :func:`main` trains."""
    spec = get_arch(args.arch)
    cfg = cut_config(spec.smoke if args.smoke else spec.full, args.layers,
                     args.experts)
    opt_cfg = OptConfig(peak_lr=args.peak_lr, warmup_steps=10,
                        decay_steps=args.steps, moment_dtype=args.moments)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.global_batch))
    return cfg, opt_cfg, data


def main(argv=None, on_step=None):
    """The launcher; returns the final train state.  ``on_step`` is
    :func:`train_loop`'s callback."""
    args = parse_args(argv)
    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port runs on one device; meshes and "
            f"sharding wait for ROADMAP queue 1, items 11.7 and 5")
    device = resolve_device(args.device)
    cfg, opt_cfg, data = setup(args)
    mesh = ElasticMesh(model_degree=1).build([device])
    print(f"mesh: {mesh}  arch: {cfg.name} "
          f"({registry.count_params(cfg) / 1e6:.1f}M params)  "
          f"device: {device}", flush=True)

    state = init_train_state(cfg, opt_cfg, seed=0, device=device)
    mgr, start = None, 0
    if args.ckpt_every:
        mgr = CheckpointManager(args.ckpt_dir, keep=2)
        state, start = resume_or_init(mgr, state)
    if start:
        print(f"resumed from step {start}")
    step_fn = make_train_step(cfg, opt_cfg, args.grad_accum)
    handler = PreemptionHandler()
    try:
        state, _, preempted = train_loop(
            cfg, state, step_fn, data, start, args.steps, device, mgr=mgr,
            ckpt_every=args.ckpt_every, handler=handler,
            monitor=StragglerMonitor(), on_step=on_step,
            log=lambda line: print(line, flush=True))
    finally:
        handler.restore_handlers()
    if not preempted:
        if mgr is not None:
            mgr.save(args.steps, state)
        print("done")
    if mgr is not None:
        mgr.wait()
    return state


if __name__ == "__main__":
    main()
