"""The lane split (``multi_device``) over the visible cards, against one
card.

    PYTHONPATH=src python -m repro_torch.bench.lane_cards [--cycles N]

Two campaigns, each run on one card and then with its lanes split over
several (``CampaignSpec(multi_device=True)``, ``run_campaign(device=
(cuda:0, cuda:1, ...))``):

* Fig. 8 (``benchmarks/fig8_synthetic.py`` at full length: the 5x5
  edge-I/O mesh, four patterns, six algorithms, 24 cells of 9 lanes),
  over the most cards that 9 divides (3 of 4; none of 2);
* the scale cells, 32x32 uniform, XY and BiDOR (4 lanes: rates 0.1 and
  0.3, seeds 0 and 1, 3 000 cycles in chunks of 1 000), over every card
  where 4 divides by their count, else over 2.

Every statistic of every point must equal the one-card run's, bit for
bit, and so must the final state of the 32x32 XY cell (every key after
1 000 cycles in two chunks, through ``noc.sim.LaneGroups``).  Prints
each run's wall (host clock, plans included) and, from the profiler,
each card's busy time in the flit-step kernels (so a block that landed
on the wrong card shows as a card with none); exits non-zero where
anything differs or fewer than two cards are visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch


def fig8_spec(cycles: int):
    from ..core import mesh2d_edge_io
    from ..noc import Algo, CampaignSpec, SimConfig

    algos = ("XY", "YX", "O1TURN", "ROMM", "ODDEVEN", "BIDOR")
    return CampaignSpec(
        topo=mesh2d_edge_io(5, 5), algos=tuple(Algo[a] for a in algos),
        patterns=("uniform", "shuffle", "permutation", "overturn"),
        rates=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.85, 1.0),
        base=SimConfig(cycles=cycles, warmup=cycles // 3),
        chunk=cycles // 4)


def scale_spec():
    from ..core import mesh2d
    from ..noc import Algo, CampaignSpec, SimConfig

    return CampaignSpec(
        topo=mesh2d(32, 32), algos=(Algo.XY, Algo.BIDOR),
        patterns=("uniform",), rates=(0.1, 0.3), seeds=(0, 1),
        base=SimConfig(cycles=3000, warmup=1000), chunk=1000)


def point_fields(res) -> list:
    """Every point's coordinates and statistics (floats as they are)."""
    return [(p.algo, p.pattern, p.scenario, p.rate, p.seed,
             dataclasses.replace(p.result, node_load=0),
             tuple(np.asarray(p.result.node_load).tolist()))
            for p in res.points]


def card_busy_ms(prof, ncards: int) -> list[float]:
    """Device ms of the flit-step kernels on each card, from a profile
    (None where the profiler saw no device time)."""
    busy = [0.0] * ncards
    seen = False
    for e in prof.events():
        if "simstep" not in e.name or e.device_type != \
                torch.autograd.DeviceType.CUDA:
            continue
        seen = True
        if 0 <= e.device_index < ncards:
            busy[e.device_index] += e.time_range.elapsed_us() / 1e3
    return busy if seen else None


def _timed(fn):
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    out = fn()
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    return out, time.perf_counter() - t0


def compare(label: str, spec, cards: list, log=print) -> bool:
    """``spec`` on ``cards[0]`` alone and split over ``cards``: the
    points equal bit for bit; the walls and each card's busy ms."""
    from ..noc import run_campaign
    from torch.profiler import ProfilerActivity, profile

    one, wall1 = _timed(lambda: run_campaign(
        dataclasses.replace(spec, multi_device=False), device=cards[0]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        split, wall = _timed(lambda: run_campaign(
            dataclasses.replace(spec, multi_device=True), device=cards))
    busy = card_busy_ms(prof, torch.cuda.device_count())
    same = point_fields(split) == point_fields(one)
    lanes = len(spec.rates) * len(spec.seeds)
    log(f"lane_cards: {label}: {len(one.points)} points, {lanes} lanes a "
        f"cell over {len(cards)} cards: every statistic "
        f"{'equal, bit for bit' if same else 'DIFFERS'}; wall one card "
        f"{wall1:.3f}s, split {wall:.3f}s ({wall1 / wall:.2f}x); flit-step "
        f"busy ms by card (profiler): "
        + (", ".join(f"cuda:{i} {ms:.3f}" for i, ms in enumerate(busy))
           if busy is not None else "not measured"))
    ok = same
    if busy is not None:
        idle = [i for i in range(len(cards)) if busy[i] <= 0]
        stray = [i for i in range(len(cards), len(busy)) if busy[i] > 0]
        if idle or stray:
            log(f"lane_cards: {label}: cards without their lanes {idle}, "
                f"cards with lanes not theirs {stray}")
            ok = False
    return ok


def state_check(cards: list, log=print) -> bool:
    """The 32x32 XY cell's state after 1 000 cycles (two chunks) split
    over ``cards`` against one card, every key bit for bit."""
    from ..core import traffic
    from ..noc import sim

    spec = scale_spec()
    cfg = spec.base
    points = [(r, s) for r in spec.rates for s in spec.seeds]
    tables, meta = sim.build_tables(spec.topo, traffic.uniform(spec.topo),
                                    None, cfg.num_vcs, cards[0])
    hosts = []
    for devs in (cards[:1], cards):
        lanes = sim.LaneGroups.fresh(tables, meta, cfg, points, devs)
        lanes.run(600)
        lanes.run(400)
        hosts.append(lanes.to_host())
    bad = [k for k in hosts[0]
           if not np.array_equal(hosts[0][k], hosts[1][k])]
    log(f"lane_cards: 32x32 XY state after 1000 cycles, {len(points)} lanes "
        f"over {len(cards)} cards against one: "
        + ("every key equal, bit for bit" if not bad else f"DIFFER: {bad}"))
    return not bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.lane_cards")
    ap.add_argument("--cycles", type=int, default=14000,
                    help="Fig. 8's cycles (its full length by default)")
    args = ap.parse_args(argv)
    n = torch.cuda.device_count()
    if n < 2:
        print(f"lane_cards: {n} CUDA device(s) visible, needs 2 or more",
              file=sys.stderr)
        return 2
    from ..kernels import build

    build.build()
    cards = [torch.device("cuda", i) for i in range(n)]
    print(f"lane_cards: {n} x {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}", flush=True)
    ok = True
    fig8_cards = max((k for k in range(2, n + 1) if 9 % k == 0), default=0)
    if fig8_cards:
        ok &= compare("fig8", fig8_spec(args.cycles), cards[:fig8_cards])
    else:
        print(f"lane_cards: fig8: 9 lanes do not divide over 2..{n} cards")
    scale_cards = n if 4 % n == 0 else 2
    ok &= compare("scale 32x32", scale_spec(), cards[:scale_cards])
    ok &= state_check(cards[:scale_cards])
    if not ok:
        print("lane_cards: failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
