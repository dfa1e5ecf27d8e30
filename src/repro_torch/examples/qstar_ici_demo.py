"""Q-StaR scheduling collective traffic on an ICI torus, the reference's
``examples/qstar_ici_demo.py`` on the port.

    PYTHONPATH=src python -m repro_torch.examples.qstar_ici_demo [pod_side]
    PYTHONPATH=src python -m repro_torch.examples.qstar_ici_demo \\
        --ml qwen2-moe-a2.7b [--device cpu]

1. Models a pod's ICI torus (default 16×16) as a Q-StaR topology.
2. Builds a traffic matrix — either the synthetic expert-parallel
   all-to-all with hot experts (``core.traffic.alltoall``), or, with
   ``--ml ARCH``, the collective flows of the arch's smoke config sharded
   over a 1×8 mesh, read from the reference's recorded post-SPMD HLO
   (``noc.mltraffic``; the port lowers no model itself) and embedded onto
   the torus.
3. Runs N-Rank → BiDOR → BiDOR-G offline and reports the max-link-load
   (collective completion-time bound) improvements.  BiDOR-G is seeded
   from the better of the planned table and plain XY, so it never loses
   to DOR.
4. Shows the quasi-static control plane reacting to an ICI link that
   retrains at reduced width: the re-planner rebuilds the tables against
   the degraded fabric and cuts the new bottleneck.

The N-Rank evolution and its possibility pass run on the device
(kernels on the card, their plain twins on the CPU); BiDOR, the link
loads and the greedy refinement are host numpy, as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np

from ..core import (bidor, build_plan, link_load, link_load_stats, torus,
                    traffic)
from ..core.bidor import greedy_refine
from ..device import resolve_device
from ..noc.mltraffic import STAGE_GRID, WorkloadSpec, derive_workload

HLO_DIR = str(Path(__file__).resolve().parents[3] / "tests" / "goldens"
              / "mltraffic")


def _loads(topo, t, table):
    s = link_load_stats(topo, t, table)
    return s["max"], s["cv"]


def _recorded(spec: WorkloadSpec) -> WorkloadSpec:
    """``spec`` under the label its phases' HLO was recorded with
    (``STAGE_GRID``): a phase's program depends on the arch, the mesh and
    the shapes, not on the label or on the other phases read.  A spec
    with no recording comes back as it is, and ``derive_workload`` then
    names the command that records it."""
    for rec, _ in STAGE_GRID:
        if (set(spec.phases) <= set(rec.phases) and dataclasses.replace(
                rec, label="", phases=spec.phases) == spec):
            return dataclasses.replace(spec, label=rec.label)
    return spec


def _ml_matrix(topo, arch: str, phases: tuple[str, ...],
               hlo_dir: str = HLO_DIR):
    """HLO-derived collective flows of ``arch`` embedded onto ``topo``."""
    pad = 8 if "moe" in arch or arch.startswith("dbrx") else 0
    spec = WorkloadSpec(arch=arch, data=1, model=8, moe_pad_to=pad,
                        phases=phases)
    wl = derive_workload(_recorded(spec), hlo_dir=hlo_dir)
    print(f"derived {spec.name}: phases {'+'.join(phases)}, "
          f"{sum(wl.meta.get('collective_op_counts', {}).values())} "
          f"collective ops in HLO")
    return wl.matrix_for(topo)


def main(side: int = 16, greedy_sweeps: int = 3, ml_arch: str | None = None,
         phases: tuple[str, ...] = ("decode",), device="cuda",
         hlo_dir: str = HLO_DIR):
    dev = resolve_device(device)
    topo = torus(side, side)               # one pod's ICI fabric
    n = topo.num_nodes
    if ml_arch:
        t = _ml_matrix(topo, ml_arch, phases, hlo_dir)
    else:
        rng = np.random.default_rng(0)
        skew = np.ones(n)
        # hot experts
        skew[rng.choice(n, max(n // 10, 1), replace=False)] = 5.0
        t = traffic.alltoall(topo, skew=skew)

    xy = bidor(topo, np.zeros(n))              # baseline: all-XY routing
    plan = build_plan(topo, t, use_kernel=True,
                      device=dev)              # paper-faithful Q-StaR
    mx_plan, _ = _loads(topo, t, plan.table)
    mx_xy, _ = _loads(topo, t, xy)
    start = plan.table if mx_plan <= mx_xy else xy
    tab_g = greedy_refine(topo, t, start,
                          sweeps=greedy_sweeps)  # beyond-paper BiDOR-G

    rows = {}
    for name, table in [("XY (DOR)", xy), ("Q-StaR BiDOR", plan.table),
                        ("Q-StaR BiDOR-G", tab_g)]:
        mx, cv = _loads(topo, t, table)
        rows[name] = (mx, cv)
        bound_us = mx * 64e6 / 50e9 * 1e6  # 64MB collective @50GB/s
        print(f"{name:16s} max-link load {mx:.5f}  cv {cv:.3f}"
              f"  → completion bound ≈ {bound_us:7.1f} µs / 64 MiB")

    # ---- quasi-static replan after a link retrains at 25% width ---- #
    hot = int(np.argmax(link_load(topo, t, tab_g)))
    degraded = topo.degrade([hot], bw_scale=0.25)
    stale_mx, _ = _loads(degraded, t, tab_g)
    replanned = greedy_refine(
        degraded, t, build_plan(degraded, t, use_kernel=True,
                                device=dev).table, sweeps=greedy_sweeps)
    new_mx, _ = _loads(degraded, t, replanned)
    u, v = degraded.channels[hot]
    print(f"\nlink {u}->{v} retrained at 25% width: stale plan bottleneck "
          f"{stale_mx:.5f} → replanned {new_mx:.5f} "
          f"({(1 - new_mx / stale_mx) * 100:+.1f}%)")
    print("(the YX-vs-XY per-pair choices are hard-coded bitmaps — "
          "routing stays deterministic and in-order, paper §3.3)")
    return rows, stale_mx, new_mx


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.qstar_ici_demo")
    ap.add_argument("side", nargs="?", type=int, default=16,
                    help="pod side: the ICI fabric is a side x side torus")
    ap.add_argument("--sweeps", type=int, default=3,
                    help="BiDOR-G greedy refinement sweeps")
    ap.add_argument("--ml", default=None, metavar="ARCH",
                    help="derive the traffic from this arch's recorded "
                         "sharded HLO instead of the synthetic all-to-all "
                         "(e.g. qwen2-moe-a2.7b)")
    ap.add_argument("--phases", default="decode",
                    help="comma-separated phases for --ml (train,decode)")
    ap.add_argument("--hlo-dir", default=HLO_DIR,
                    help="where the recorded HLO lies")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain twins)")
    args = ap.parse_args()
    main(side=args.side, greedy_sweeps=args.sweeps, ml_arch=args.ml,
         phases=tuple(args.phases.split(",")), device=args.device,
         hlo_dir=args.hlo_dir)
