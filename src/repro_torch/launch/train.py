"""Training launcher, the reference's ``launch/train.py``.

Runs any architecture on an explicit (data, model) mesh with the full
substrate: parameters and optimizer moments sharded by
``sharding.specs``, synthetic data, AdamW, checkpoint auto-resume,
preemption handling, straggler monitoring, elastic re-meshing on
restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --smoke --steps 20 --device cpu

A mesh runs under ``torch.distributed.run`` with a world of D·M ranks
(``--mesh DxM``; ``PxDxM`` adds a pod axis, over which the batch splits
too; ``prod`` is 16x16, ``prod2`` 2x16x16): gloo for
``--device cpu``, NCCL with one rank a card (``cuda:LOCAL_RANK``).  A
caller that has brought up its own process group (``chip_smoke.py``
runs two gloo ranks on one card) keeps it.

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --smoke \\
        --device cpu --mesh 2x2 --steps 6

Each rank holds only its shards between steps; a step gathers a layer
at a time, just before it runs, and each gradient leaves the backward as
the rank's fp32 shard, reduce-scattered over the data ranks
(``sharding.state.LayerGather``), so a rank holds its shards, their
fp32 gradients, a layer and the head: codeqwen1.5-7b (8.19e9
parameters, which one card cannot train) trains on four H100s at
``4x1`` or ``2x2``.  Every model rank still runs the whole model on its
rows (no tensor parallelism over ``model``), and a checkpoint adds one
full leaf at a time.  A ``1xM`` mesh trains bit for bit as one device;
a mesh with D > 1 data ranks equals it to fp32 summation order.

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch codeqwen1.5-7b --mesh 4x1 --steps 4 --ckpt-every 0 \\
        --metrics codeqwen-4x1.jsonl

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

A checkpoint does not depend on the mesh, and is labelled by the number of
steps it holds, so a resumed run takes the step after the last one
done and ends where an uninterrupted run ends (the reference labels the
checkpoint written after step s as s and repeats step s on resume).
:func:`train_loop` is the step loop alone (no checkpoint unless a
manager is given), for a caller that drives it at full width.
``--ckpt-every 0`` trains with no checkpoint: none read, none written.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_arch
from ..device import resolve_device
from ..models import registry
from ..sharding.specs import axis_sizes
from ..sharding.state import ShardedTrain
from ..train.checkpoint import CheckpointManager
from ..train.data import DataConfig, SyntheticLM
from ..train.fault_tolerance import (PreemptionHandler, StragglerMonitor,
                                     resume_or_init)
from ..train.optimizer import OptConfig
from ..train.train_step import init_train_state, make_train_step
from .mesh import make_mesh

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
    returns (on a mesh every rank stops after the same step).  Returns
    (state, steps done, preempted)."""
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
        if handler is not None and handler.poll(device):
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
                    help="DxM, PxDxM (pods), 'prod' (16x16) or 'prod2' "
                         "(2x16x16); a world of that many ranks "
                         "(torch.distributed.run)")
    ap.add_argument("--metrics", default=None,
                    help="append each step's loss, ce, aux, grad norm, lr, "
                         "seconds (and on a card the peak device bytes) to "
                         "this file as a JSON line (rank 0; rank r > 0 to "
                         "<file>.rank<r>)")
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


def parse_mesh(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``--mesh``'s (shape, axis names): ``DxM`` (data, model), ``PxDxM``
    (pod, data, model), ``prod`` (16x16) or ``prod2`` (2x16x16)."""
    if spec == "prod":
        return (16, 16), ("data", "model")
    if spec == "prod2":
        return (2, 16, 16), ("pod", "data", "model")
    try:
        shape = tuple(int(x) for x in spec.split("x"))
    except ValueError:
        shape = ()
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"--mesh {spec}: not DxM, PxDxM, prod or prod2")
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                         "model")
    return shape, names


def _world(device_arg: str) -> tuple[torch.device, bool]:
    """(this rank's device, whether this call brought the process group
    up).  Under ``torch.distributed.run`` the group comes up here:
    gloo on the CPU, NCCL on ``cuda:LOCAL_RANK``; a group already up is
    kept, its rank's card ``cuda:LOCAL_RANK``."""
    device = resolve_device(device_arg)
    started = False
    if "WORLD_SIZE" in os.environ or dist.is_initialized():
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo")
            started = True
    return device, started


@dataclasses.dataclass
class Run:
    """What :func:`prepare` sets up and :func:`run` trains."""
    args: argparse.Namespace
    cfg: object
    opt_cfg: OptConfig
    data: SyntheticLM
    device: torch.device
    sharded: ShardedTrain | None
    state: dict
    start: int
    mgr: CheckpointManager | None
    step_fn: object
    started: bool
    log: object


def prepare(args, timed: bool = False) -> Run:
    """The run of parsed arguments, up to its first step: the process
    group and mesh, the train state (sharded on a mesh), a checkpoint
    resumed.  The world must have the mesh's rank count, else it
    raises naming both.  ``timed``: the mesh step's ``phase_s``
    (``train.train_step.sharded_train_step``)."""
    device, started = _world(args.device)
    shape, names = parse_mesh(args.mesh)
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"--mesh {args.mesh} needs a world of {need} "
                         f"ranks, this one has {world}")
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    def log(line):
        if rank0:
            print(line, flush=True)

    cfg, opt_cfg, data = setup(args)
    sharded = None
    if need == 1:
        mesh = dict(zip(names, shape))
        state = init_train_state(cfg, opt_cfg, seed=0, device=device)
    else:
        mesh = make_mesh(shape, names)
        sharded = ShardedTrain(cfg, opt_cfg, mesh)
        state = sharded.init_state(seed=0, device=device)
    log(f"mesh: {axis_sizes(mesh)}  arch: {cfg.name} "
        f"({registry.count_params(cfg) / 1e6:.1f}M params)  "
        f"device: {device}")
    mgr, start = None, 0
    if args.ckpt_every:
        mgr = CheckpointManager(args.ckpt_dir, keep=2, sharded=sharded)
        state, start = resume_or_init(mgr, state)
    if start:
        log(f"resumed from step {start}")
    step_fn = make_train_step(cfg, opt_cfg, args.grad_accum, mesh=sharded,
                              timed=timed)
    return Run(args, cfg, opt_cfg, data, device, sharded, state, start, mgr,
               step_fn, started, log)


def _metrics_writer(path: str | None, on_step, device: torch.device):
    if path is None:
        return on_step
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank:
        path = f"{path}.rank{rank}"

    def write(step, metrics, seconds):
        row = {"step": step, **{k: float(metrics[k]) for k in
                                ("loss", "ce", "aux", "grad_norm",
                                 "lr")}, "seconds": seconds}
        if device.type == "cuda":
            row["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if on_step is not None:
            on_step(step, metrics, seconds)
    return write


def run(r: Run, on_step=None) -> dict:
    """Trains a prepared run to ``--steps``; returns the final state (a
    rank's shards on a mesh).  On a card the peak device memory counts
    from here (``--metrics``' ``peak_bytes``: the steps', not the
    set-up's)."""
    args = r.args
    if r.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(r.device)
    handler = PreemptionHandler()
    try:
        state, _, preempted = train_loop(
            r.cfg, r.state, r.step_fn, r.data, r.start, args.steps, r.device,
            mgr=r.mgr, ckpt_every=args.ckpt_every, handler=handler,
            monitor=StragglerMonitor(),
            on_step=_metrics_writer(args.metrics, on_step, r.device),
            log=r.log)
    finally:
        handler.restore_handlers()
    if not preempted:
        if r.mgr is not None:
            r.mgr.save(args.steps, state)
        r.log("done")
    if r.mgr is not None:
        r.mgr.wait()
    if r.started:
        dist.destroy_process_group()
    return state


def main(argv=None, on_step=None):
    """The launcher; returns the final train state (a rank's shards on a
    mesh).  ``on_step`` is :func:`train_loop`'s callback."""
    return run(prepare(parse_args(argv)), on_step)


if __name__ == "__main__":
    main()
