"""The training launcher on meshes over every visible card, against one.

    PYTHONPATH=src python -m repro_torch.bench.mesh_cards [--arch ARCH]
        [--steps N] [--meshes 1x4 4x1 2x2] [--layers N] [--no-single]

Runs ``python -m repro_torch.launch.train`` on one card, then under
``torch.distributed.run`` (NCCL, one rank a card) on each mesh, with the
launcher's default batch and no checkpoint, each run's steps read from
its ``--metrics`` files (one a rank).  A mesh with one data rank must
give the one-card run's losses and grad norms bit for bit; the others
within ``LOSS_RTOL`` (loss) and ``GNORM_RTOL`` (grad norm) relative, set
from four H100s' distances (see below).  A control run on one card with
half the global batch, a batch split that lost a rank's rows, must fall
outside them: else the rule could not see that fault, and the bench
fails.  ``--layers`` cuts the depth of every run (widths unchanged);
``--no-single`` runs the meshes alone, for a model that one card cannot
train (codeqwen1.5-7b at its 32 layers).

On every mesh each rank must run every step with finite losses equal to
rank 0's, bit for bit, and its peak device memory over the steps must
sit under ``CARD_GIB`` with the dry run's estimate of it
(``launch.dryrun.train_counts`` at the rank's coordinates) within
``PEAK_BAND`` of it.  Prints each run's warm step median (rank 0's host
clock, the loss read back), the largest distances and each rank's peak
beside its estimate; exits non-zero where a check fails or fewer than
two cards are visible.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile

import torch

# on four H100s over NCCL `4x1` / `2x2` part from one card by at most
# 9.757e-6 of the loss and 9.632e-5 of the grad norm, and half the batch
# by 1.545e-2 / 1.494e-1: ten times the one, a hundredth of the other
# (``chip_smoke.py``'s ``MESH_LOSS_RTOL`` / ``MESH_GNORM_RTOL`` alike)
LOSS_RTOL, GNORM_RTOL = 1e-4, 1e-3
# the dry run's peak estimate over a rank's measured peak (the meta run
# keeps no allocator reuse and no in-place autograd buffers: 1.125-1.191
# on one H100)
PEAK_BAND = (0.9, 1.3)
CARD_GIB = 80.0


def _run(nproc: int, argv: list[str], metrics: str) -> list[list[dict]]:
    """Each rank's steps (rank 0 first)."""
    launcher = ["-m", "repro_torch.launch.train"]
    if nproc > 1:
        launcher = ["-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", str(nproc), *launcher]
    subprocess.run([sys.executable, *launcher, *argv, "--metrics", metrics],
                   check=True)
    out = []
    for r in range(nproc):
        with open(metrics if r == 0 else f"{metrics}.rank{r}") as f:
            out.append([json.loads(line) for line in f])
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _distances(rows, want) -> tuple[float, float]:
    """The largest relative distances of ``rows``' losses and grad norms
    from ``want``'s, step by step."""
    return (max(_rel(a["loss"], b["loss"]) for a, b in zip(rows, want)),
            max(_rel(a["grad_norm"], b["grad_norm"])
                for a, b in zip(rows, want)))


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def check_ranks(cfg, mesh: str, ranks: list[list[dict]], steps: int,
                global_batch: int, seq: int) -> list[str]:
    """A mesh run's per-rank checks (steps, finite losses equal on every
    rank, each peak under the card and against the dry run); prints a
    line a rank; returns what failed."""
    from ..launch import dryrun
    from ..sharding.state import coordinates
    from ..train.optimizer import OptConfig

    d, m = map(int, mesh.split("x"))
    sizes = {"data": d, "model": m}
    losses = [r["loss"] for r in ranks[0]]
    failed = []
    if not all(math.isfinite(x) for x in losses):
        failed.append(f"{mesh}: a loss not finite")
    for rank, (rows, coords) in enumerate(zip(ranks, coordinates(sizes))):
        counts = dryrun.train_counts(cfg, OptConfig(), sizes, global_batch,
                                     seq, 1, coords=coords)
        est = (counts["state_bytes"] + counts["batch_bytes"]
               + counts["temp_bytes"])
        peak = rows[-1]["peak_bytes"]
        ratio = est / peak
        print(f"mesh_cards: {mesh} rank {rank} {coords}: {len(rows)} steps, "
              f"losses equal to rank 0's: "
              f"{[r['loss'] for r in rows] == losses}; peak device memory "
              f"{peak / 2**30:.2f} GiB, the dry run's estimate "
              f"{est / 2**30:.2f} GiB (ratio {ratio:.3f}, band "
              f"{PEAK_BAND})", flush=True)
        if len(rows) != steps or [r["loss"] for r in rows] != losses:
            failed.append(f"{mesh} rank {rank}: steps or losses")
        if not (peak < CARD_GIB * 2**30
                and PEAK_BAND[0] <= ratio <= PEAK_BAND[1]):
            failed.append(f"{mesh} rank {rank}: peak")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.mesh_cards")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--meshes", nargs="*", default=None,
                    help="DxM meshes over the cards (default: 1xN, Nx1 "
                         "and, for 4 cards, 2x2)")
    ap.add_argument("--layers", type=int, default=None,
                    help="the launcher's --layers: cut every run's depth")
    ap.add_argument("--no-single", action="store_true",
                    help="no one-card run or control: the meshes alone")
    args = ap.parse_args(argv)
    n = torch.cuda.device_count()
    if n < 2:
        print(f"mesh_cards: {n} CUDA device(s) visible, needs 2 or more",
              file=sys.stderr)
        return 2
    from ..configs import get_arch
    from ..kernels import build
    from ..launch.train import cut_config, parse_args

    meshes = args.meshes or [f"1x{n}", f"{n}x1"] + (["2x2"] if n == 4
                                                     else [])
    base = ["--arch", args.arch, "--steps", str(args.steps), "--ckpt-every",
            "0"]
    if args.layers is not None:
        base += ["--layers", str(args.layers)]
    launch = parse_args(base)
    cfg = cut_config(get_arch(args.arch).full, args.layers)
    build.build()   # here, before any rank would build them at once
    print(f"mesh_cards: {n} x {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}; {cfg.name} at {cfg.n_layers} layers",
          flush=True)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        one = None
        if not args.no_single:
            one = _run(1, base, os.path.join(tmp, "1x1.jsonl"))[0]
            half = _run(1, base + ["--global-batch", "4"],
                        os.path.join(tmp, "half.jsonl"))[0]
            loss, gnorm = _distances(half, one)
            caught = not (loss <= LOSS_RTOL and gnorm <= GNORM_RTOL)
            print(f"mesh_cards: control, half the batch on one card: loss "
                  f"{loss:.3e}, grad norm {gnorm:.3e} relative from the "
                  f"whole batch's: {'outside' if caught else 'INSIDE'} the "
                  f"limits; one card's peak "
                  f"{one[-1]['peak_bytes'] / 2**30:.2f} GiB", flush=True)
            if not caught:
                failed.append("control")
        for mesh in ([] if one is None else ["1x1"]) + meshes:
            d, m = map(int, mesh.split("x"))
            ranks = [one] if mesh == "1x1" else _run(
                d * m, base + ["--mesh", mesh],
                os.path.join(tmp, f"{mesh}.jsonl"))
            rows = ranks[0]
            step_ms = _median([r["seconds"] for r in rows[1:]]) * 1e3
            how = "no one-card run"
            if one is not None:
                key = [(r["loss"], r["grad_norm"]) for r in rows]
                want = [(r["loss"], r["grad_norm"]) for r in one]
                if d == 1:
                    ok = key == want
                    how = "bit for bit" if ok else "NOT bit for bit"
                else:
                    loss, gnorm = _distances(rows, one)
                    ok = loss <= LOSS_RTOL and gnorm <= GNORM_RTOL
                    how = (f"loss within {loss:.3e}, grad norm within "
                           f"{gnorm:.3e} relative (limits {LOSS_RTOL}, "
                           f"{GNORM_RTOL})")
                if not ok:
                    failed.append(mesh)
            print(f"mesh_cards: {mesh}: {len(rows)} steps, warm step median "
                  f"{step_ms:.2f}ms; losses {[r['loss'] for r in rows]}; "
                  f"against one card: {how}", flush=True)
            if len(rows) != args.steps:
                failed.append(mesh)
            if mesh != "1x1":
                failed += check_ranks(cfg, mesh, ranks, args.steps,
                                      launch.global_batch, launch.seq)
    if failed:
        print(f"mesh_cards: failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
