"""Topology-zoo sweep on the port: Q-StaR against DOR beyond the paper's
2-D mesh.

    python -m repro_torch.bench.topo_sweep [--device cpu] [--out PATH]

The reference's stage (``benchmarks/topo_sweep.py``) run through the
port's ``run_campaign`` (the campaign service is not ported): the whole
plan-table pipeline (N-Rank, BiDOR, ``build_plans_batched``, the
table-routed flit step) over the zoo, ``torus(4, 4, 4)``,
``cmesh(4, 4, 4)``, ``express_mesh(8, 8)`` and
``fault_region_mesh(6, 6, (2, 2, 3, 3))``, as one campaign with a
topology axis, under uniform and hotspot traffic, XY against BiDOR.
On the fault-region mesh the planner masks the dead channels and BiDOR
sheds the pairs no dimension order serves, while XY drives packets into
the dead region.

It checks the reference's two claims (:func:`check`): BiDOR beats XY on
max channel load on at least one (topology, pattern), and out-delivers
it by more than 1.5x on the fault-region mesh.  ``BENCH_QUICK=1`` (the
default, as in the reference) runs 1 500 cycles, ``BENCH_QUICK=0``
12 000.  A QUICK run is compared row for row with the reference's
committed ``artifacts/bench/topo_sweep.csv`` (:func:`compare_csv`).
Rows are printed, or written to ``--out``; nothing is written under
``artifacts/``.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

from ..core import cmesh, express_mesh, fault_region_mesh, torus
from ..noc import Algo, CampaignSpec, SimConfig, run_campaign
from ..noc.campaign import CampaignResult, csv_rows

QUICK = os.environ.get("BENCH_QUICK", "1") == "1"
COMMITTED_CSV = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                             "artifacts", "bench", "topo_sweep.csv")
# the committed CSV's columns held row for row, at its printed precision
COMPARED = ("throughput", "offered", "avg_lat", "p50_lat", "p90_lat",
            "p99_lat", "max_lat", "lcv", "link_load_max", "reorder",
            "saturated", "meas_cycles")
# the columns that name a row
KEY = ("topo", "scenario", "pattern", "algo", "rate", "seed")


def zoo():
    return (torus(4, 4, 4), cmesh(4, 4, concentration=4),
            express_mesh(8, 8, interval=2),
            fault_region_mesh(6, 6, (2, 2, 3, 3)))


def sweep_spec(quick: bool = QUICK, topos=None) -> CampaignSpec:
    """The reference's spec: the zoo (or ``topos``), uniform and hotspot,
    XY and BiDOR, rates 0.1 and 0.2, seed 0; 1 500 cycles QUICK, else
    12 000 (warmup a third, drain a fifteenth)."""
    cycles = 1500 if quick else 12_000
    return CampaignSpec(
        topo=None, topos=tuple(topos or zoo()),
        algos=(Algo.XY, Algo.BIDOR), patterns=("uniform", "hotspot"),
        rates=(0.1, 0.2), seeds=(0,),
        base=SimConfig(cycles=cycles, warmup=cycles // 3,
                       drain=cycles // 15))


def check(res: CampaignResult) -> list[str]:
    """The reference's two assertions on a sweep; returns the verdict
    lines, raises ``AssertionError`` where a claim fails."""
    spec = res.spec
    top_rate = max(spec.rates)
    lines, load_wins, thr = [], [], {}
    for topo in spec.topo_axis:
        for pat in spec.patterns:
            cell = {}
            for algo in spec.algos:
                (p,) = res.select(algo=algo, pattern=pat, rate=top_rate,
                                  topo=topo.name)
                cell[algo] = p.result
            xy, bd = cell[Algo.XY], cell[Algo.BIDOR]
            delta = (1.0 - bd.link_load_max / xy.link_load_max) * 100 \
                if xy.link_load_max > 0 else 0.0
            win = bd.link_load_max < xy.link_load_max - 1e-9
            if win:
                load_wins.append((topo.name, pat, delta))
            thr[topo.name, pat] = (xy.throughput, bd.throughput)
            lines.append(f"topo_sweep {topo.name:18s} {pat:8s} max-load "
                         f"XY={xy.link_load_max:.4f} "
                         f"BiDOR={bd.link_load_max:.4f} "
                         f"({delta:+.1f}% lower){' WIN' if win else ''}")
    if not load_wins:
        raise AssertionError("Q-StaR must beat DOR on max channel load on "
                             "at least one (topology, pattern) of the zoo")
    (fr_name,) = [t.name for t in spec.topo_axis
                  if t.name.startswith("fault_region")]
    fr_xy, fr_bd = thr[fr_name, "uniform"]
    if not fr_bd > fr_xy * 1.5:
        raise AssertionError(
            f"plan-table routing must out-deliver XY on the fault-region "
            f"mesh (XY {fr_xy:.4f} vs BiDOR {fr_bd:.4f} flits/cycle/port)")
    lines.append(f"topo_sweep: {len(load_wins)} max-channel-load wins; "
                 f"fault-region throughput XY {fr_xy:.4f} -> BiDOR "
                 f"{fr_bd:.4f}")
    return lines


def read_rows(path: str = COMMITTED_CSV) -> dict[tuple, dict]:
    """A sweep CSV's rows by :data:`KEY`, read by column name (the
    committed file predates the ``workload`` column)."""
    with open(path, newline="") as f:
        return {tuple(r[k] for k in KEY): r for r in csv.DictReader(f)}


def compare_csv(res: CampaignResult, path: str = COMMITTED_CSV,
                topos=None) -> list[str]:
    """The run's rows against a sweep CSV (by default the reference's
    committed QUICK run), each :data:`COMPARED` column at the CSV's
    printed precision; with ``topos`` (names), only those topologies'
    rows.  Returns the mismatches, empty when every row agrees."""
    want = read_rows(path)
    if topos is not None:
        want = {k: r for k, r in want.items() if k[0] in topos}
    header = CampaignResult.CSV_HEADER
    got = {}
    for row in csv_rows(res.points):
        r = {h: str(v) for h, v in zip(header, row)}
        got[tuple(r[k] for k in KEY)] = r
    bad = [f"missing row {k}" for k in want if k not in got]
    bad += [f"extra row {k}" for k in got if k not in want]
    for k in sorted(set(want) & set(got)):
        bad += [f"{k} {c}: {got[k][c]} != {want[k][c]}" for c in COMPARED
                if got[k][c] != want[k][c]]
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", help="write the rows as CSV here")
    args = ap.parse_args(argv)
    res = run_campaign(sweep_spec(QUICK), device=args.device)
    rows = [CampaignResult.CSV_HEADER] + res.to_rows()
    if args.out:
        with open(args.out, "w", newline="") as f:
            csv.writer(f).writerows(rows)
    else:
        for row in rows:
            print(",".join(map(str, row)))
    print(res.summary())
    for line in check(res):
        print(line)
    if QUICK:
        bad = compare_csv(res)
        print(f"topo_sweep: {len(res.points)} rows against the committed "
              f"CSV: {'ok' if not bad else 'MISMATCH'}")
        for line in bad:
            print(f"  {line}")
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
