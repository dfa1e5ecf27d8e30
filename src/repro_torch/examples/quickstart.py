"""Quickstart, the reference's ``examples/quickstart.py`` on the port: the
full Q-StaR pipeline on the paper's 5×5 NoC.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [cycles] \\
        [--device cpu]

Builds N-Rank weights + BiDOR bitmaps offline (paper Fig. 3 workflow;
the possibility pass on its kernels), then simulates XY vs BiDOR on the
flit-step kernel and prints the load-balance improvement.  On the CPU
the same pipeline runs the kernels' plain twins.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core import build_plan, mesh2d_edge_io, traffic
from ..device import resolve_device
from ..noc import Algo, SimConfig, run_sim


def main(cycles: int = 8000, device="cuda"):
    dev = resolve_device(device)
    topo = mesh2d_edge_io(5, 5)           # paper §4.1 NoC
    t = traffic.uniform(topo)

    # ---- offline: N-Rank + BiDOR (quasi-static, paper §3) ---- #
    plan = build_plan(topo, t, use_kernel=True, device=dev)
    print("N-Rank iterations:", plan.nrank.iterations)
    print("w_NR grid:")
    print(np.round(plan.w_nr.reshape(5, 5), 3))
    print("BiDOR bitmap of node 0 (bit=1 ⇒ YX):")
    print(plan.table.bitmaps[0].astype(int))

    # ---- runtime: deterministic table-driven routing ---- #
    cfg = SimConfig(cycles=cycles, warmup=cycles // 3, injection_rate=0.5)
    r_xy = run_sim(topo, t, cfg.replace(algo=Algo.XY), device=dev)
    r_bd = run_sim(topo, t, cfg.replace(algo=Algo.BIDOR),
                   bidor_table=plan.table, device=dev)
    print(f"\nXY    : {r_xy.summary()}")
    print(f"BiDOR : {r_bd.summary()}")
    print(f"\nload-balance LCV {r_xy.lcv:.3f} → {r_bd.lcv:.3f} "
          f"(paper Table 1: 0.28 → 0.08)")
    print(f"throughput {r_xy.throughput:.3f} → {r_bd.throughput:.3f} "
          f"flits/cycle/port; reorder {r_xy.reorder_value} → "
          f"{r_bd.reorder_value}")
    return plan, r_xy, r_bd


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("cycles", nargs="?", type=int, default=8000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain twins)")
    args = ap.parse_args()
    main(args.cycles, args.device)
