"""The training launcher on meshes over every visible card, against one.

    PYTHONPATH=src python -m repro_torch.bench.mesh_cards [--arch ARCH]
        [--steps N] [--meshes 1x4 4x1 2x2]

Runs ``python -m repro_torch.launch.train`` on one card, then under
``torch.distributed.run`` (NCCL, one rank a card) on each mesh, with the
launcher's default batch and no checkpoint, each run's steps read from
its ``--metrics`` file.  A mesh with one data rank must give the
one-card run's losses and grad norms bit for bit; the others within
``LOSS_RTOL`` (loss) and ``GNORM_RTOL`` (grad norm) relative, set from
four H100s' distances (see below).  A control run on one card with half
the global batch, a batch split that lost a rank's rows, must fall
outside them: else the rule could not see that fault, and the bench
fails.  Prints each run's warm step median (rank 0's host clock, the
loss read back) and the largest distances; exits non-zero where a mesh
fails, the control passes, or fewer than two cards are visible.
"""

from __future__ import annotations

import argparse
import json
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


def _run(nproc: int, argv: list[str], metrics: str) -> list[dict]:
    launcher = ["-m", "repro_torch.launch.train"]
    if nproc > 1:
        launcher = ["-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", str(nproc), *launcher]
    subprocess.run([sys.executable, *launcher, *argv, "--metrics", metrics],
                   check=True)
    with open(metrics) as f:
        return [json.loads(line) for line in f]


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.mesh_cards")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--meshes", nargs="*", default=None,
                    help="DxM meshes over the cards (default: 1xN, Nx1 "
                         "and, for 4 cards, 2x2)")
    args = ap.parse_args(argv)
    n = torch.cuda.device_count()
    if n < 2:
        print(f"mesh_cards: {n} CUDA device(s) visible, needs 2 or more",
              file=sys.stderr)
        return 2
    meshes = args.meshes or [f"1x{n}", f"{n}x1"] + (["2x2"] if n == 4
                                                     else [])
    base = ["--arch", args.arch, "--steps", str(args.steps), "--ckpt-every",
            "0"]
    print(f"mesh_cards: {n} x {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}", flush=True)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        one = _run(1, base, os.path.join(tmp, "1x1.jsonl"))
        half = _run(1, base + ["--global-batch", "4"],
                    os.path.join(tmp, "half.jsonl"))
        loss, gnorm = _distances(half, one)
        caught = not (loss <= LOSS_RTOL and gnorm <= GNORM_RTOL)
        print(f"mesh_cards: control, half the batch on one card: loss "
              f"{loss:.3e}, grad norm {gnorm:.3e} relative from the whole "
              f"batch's: {'outside' if caught else 'INSIDE'} the limits",
              flush=True)
        if not caught:
            failed.append("control")
        for mesh in ["1x1", *meshes]:
            d, m = map(int, mesh.split("x"))
            rows = one if mesh == "1x1" else _run(
                d * m, base + ["--mesh", mesh],
                os.path.join(tmp, f"{mesh}.jsonl"))
            step_ms = _median([r["seconds"] for r in rows[1:]]) * 1e3
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
            print(f"mesh_cards: {mesh}: {len(rows)} steps, warm step median "
                  f"{step_ms:.2f}ms; losses {[r['loss'] for r in rows]}; "
                  f"against one card: {how}", flush=True)
            if not ok or len(rows) != args.steps:
                failed.append(mesh)
    if failed:
        print(f"mesh_cards: failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
