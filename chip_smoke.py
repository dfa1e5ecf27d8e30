#!/usr/bin/env python3
"""Drive the port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from a checkout (it imports ``src/repro_torch`` beside this file).
Each phase prints one or more lines; any mismatch raises, so the script
exits non-zero, and there is no CPU path: without a CUDA device it stops
before printing any result.

1. card     — ``nvidia-smi`` name and power limit;
2. build    — every CUDA source under ``src/repro_torch/kernels/csrc``
              (one nvcc each, in parallel) into ``build/repro_torch/``;
3. kernels  — each kernel against its plain version on the card:
              ``possibility_v`` at N = 1024 (integer T bit for bit, real
              T to rtol 1e-12); the ``simstep_tile``/``simstep_finish``
              pair on the 5x5 edge-I/O, 16x16 and 32x32 meshes, XY and
              BiDOR, at the whole-network tile and a proper divisor, 1
              and 50 cycles from a plain mid-flight state, every state
              key bit for bit;
4. golden   — ``run_campaign`` on the 4x4 golden parameters against
              ``tests/goldens/campaign_4x4.json``;
5. paper    — the paper's 5x5 edge-I/O cells at fig8's full length;
6. scale    — 32x32 uniform, XY and BiDOR, on the auto (multi-tile) path;
7. summary  — launches of each kernel on the main path (phases 4–6),
              event-timed µs per launch, the plain version's time and the
              bound, as one JSON line; then the card line and the result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth; 67e12 float32
# FLOP/s outside the tensor cores is 132 SMs x 128 lanes x 2 (an FMA counts
# twice) x 1.98 GHz, and the Hopper SM has 64 int32 lanes, so int32
# instructions (adds, compares) issue at a quarter of that figure; 34e12
# fp64 FLOP/s counts an FMA twice, so fp64 adds issue at half of it.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
F64_ADDS_PER_S = 34e12 / 2


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------- #
def _hold_stream(torch):
    """Keep the card busy while the host enqueues a timed run, so event
    intervals measure device time and not host launch gaps."""
    torch.cuda._sleep(200_000_000)


def time_launches(torch, fns, reps: int) -> list[float]:
    """Mean device ms of each function in ``fns`` over ``reps`` rounds of
    calling them in turn; ``fns[i](r)`` is called in round ``r``."""
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(reps * len(fns) + 1)]
    torch.cuda.synchronize()
    _hold_stream(torch)
    evs[0].record()
    k = 1
    for r in range(reps):
        for fn in fns:
            fn(r)
            evs[k].record()
            k += 1
    torch.cuda.synchronize()
    out = [0.0] * len(fns)
    k = 1
    for _ in range(reps):
        for i in range(len(fns)):
            out[i] += evs[k - 1].elapsed_time(evs[k])
            k += 1
    return [x / reps for x in out]


def time_wall(torch, fn, reps: int) -> float:
    """Mean ms per call, host clock around synchronised calls (the plain
    versions are many small launches: their cost includes the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #
def check_possibility(torch, np, cuda):
    """possibility_v at N = C = 1024 (the planner's offset-0 pass)."""
    from repro_torch.core import mesh2d
    from repro_torch.kernels.possibility import (possibility_v,
                                                 possibility_v_plain)

    topo = mesh2d(32, 32)
    n = topo.num_nodes
    dist = torch.as_tensor(topo.distances, device=cuda)
    rng = np.random.default_rng(0)
    out = {}
    for kind in ("integer", "real"):
        t = (rng.integers(0, 8, (n, n)).astype(np.float64)
             if kind == "integer" else rng.random((n, n)))
        t = torch.as_tensor(t, device=cuda)
        want = possibility_v_plain(dist, dist, t, dist, offset=0)
        got = possibility_v(dist, dist, t, dist, offset=0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if kind == "integer":
            ok = torch.equal(got, want)
        else:
            ok = bool(torch.allclose(got, want, rtol=1e-12, atol=0.0))
        log(f"kernels: possibility_v N={n} {kind} T: max_abs_err={err!r} "
            f"{'bitwise' if kind == 'integer' else 'rtol 1e-12'} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"possibility_v disagrees with plain ({kind} T)")
        out[kind] = err
    ms = time_launches(
        torch, [lambda r: possibility_v(dist, dist, t, dist, offset=0)],
        100)[0]
    plain_ms = time_wall(
        torch, lambda: possibility_v_plain(dist, dist, t, dist, offset=0), 3)
    nbytes = n * n * (4 + 4 + 4 + 8 + 8)    # du, dn, dist, T in; V out
    # per (s, c, d) an int32 add and compare; an fp64 add only where the
    # predicate holds (c on a minimal s -> d path), counted on this data.
    # The two pipes issue side by side, so the slower one bounds.
    hits = sum(int(((dist[:, c:c + 16, None] + dist[None, c:c + 16, :])
                    == dist[:, None, :]).sum()) for c in range(0, n, 16))
    op_ms = max(2 * n ** 3 / INT32_OPS_PER_S, hits / F64_ADDS_PER_S) * 1e3
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": op_ms}
    bound_by = max(bound, key=bound.get)
    log(f"kernels: possibility_v bound: {2 * n ** 3} int32 ops, {hits} "
        f"fp64 adds, {nbytes} bytes -> {bound[bound_by] * 1e3:.2f}us "
        f"({bound_by})")
    return dict(name="possibility_v", route="cuda",
                source="src/repro_torch/kernels/csrc/possibility_v.cu",
                replaces="src/repro/kernels/possibility/kernel.py:112",
                max_abs_err=out["real"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound[bound_by], bound_by=bound_by,
                library_ms=None)


def _cell(torch, cuda, topo, algo, lanes):
    from repro_torch.core import build_plans_batched, traffic
    from repro_torch.noc import sim
    from repro_torch.noc.simconfig import Algo, SimConfig

    tm = traffic.uniform(topo)
    table = (build_plans_batched(topo, [tm], device=cuda)[0].table
             if algo == Algo.BIDOR else None)
    cfg = SimConfig(algo=algo, cycles=100_000, warmup=100)
    tables, meta = sim.build_tables(topo, tm, table, 2, device=cuda)
    points = [(0.9, 0), (0.6, 1), (0.3, 2), (1.2, 3)][:lanes]
    return tables, meta, cfg, points


def _clone(torch, state):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v.copy())
            for k, v in state.items()}


def check_simstep(torch, np, cuda):
    """The kernel pair against the plain version, from plain mid-flight
    states: three meshes × XY/BiDOR × two tiles × (1, 50) cycles."""
    from repro_torch.core import mesh2d, mesh2d_edge_io
    from repro_torch.kernels.simstep import draw_chunk, make_step, ref
    from repro_torch.kernels.simstep.ops import resolve_path
    from repro_torch.noc import sim
    from repro_torch.noc.simconfig import Algo

    worst = 0
    for topo in (mesh2d_edge_io(5, 5), mesh2d(16, 16), mesh2d(32, 32)):
        for algo in (Algo.XY, Algo.BIDOR):
            tables, meta, cfg, points = _cell(torch, cuda, topo, algo, 4)
            n = meta["N"]
            mid = sim.make_states(meta, cfg, points, device=cuda)
            cycle_fn = ref.make_cycle_fn(meta, cfg)
            keys, u, ud = draw_chunk(mid["key"], 250, n, cuda)
            for c in range(200):        # plain mid-flight warm-in
                cycle_fn(tables, mid, u[c], ud[c], c)
            divisor = resolve_path(meta, cfg, len(points), cuda)
            if divisor == n:        # auto chose one tile: take the largest
                divisor = max(d for d in range(1, n) if n % d == 0)
            for tile in (n, divisor):
                for cycles in (1, 50):
                    plain = _clone(torch, mid)
                    card = _clone(torch, mid)
                    step = make_step(meta, cfg.replace(sim_tile_nodes=tile),
                                     tables, card)
                    for c in range(cycles):
                        cycle_fn(tables, plain, u[200 + c], ud[200 + c],
                                 200 + c)
                        step.step(u[200 + c], ud[200 + c], 200 + c)
                    torch.cuda.synchronize()
                    bad = [k for k in plain if k != "key"
                           and not torch.equal(plain[k], card[k])]
                    diff = max(int((plain[k].double() - card[k].double())
                                   .abs().max()) for k in plain
                               if k != "key")
                    worst = max(worst, diff)
                    log(f"kernels: simstep {topo.name} {algo.name} "
                        f"tile={tile} cycles={cycles}: "
                        f"{'bitwise ok' if not bad else f'MISMATCH {bad}'}")
                    if bad:
                        raise SystemExit(
                            f"simstep kernels disagree with plain on {bad}")
    return worst


def check_golden(torch, np, cuda):
    from repro_torch.core import mesh2d
    from repro_torch.noc import Algo, CampaignSpec, SimConfig, run_campaign

    with open(os.path.join(HERE, "tests", "goldens",
                           "campaign_4x4.json")) as f:
        golden = json.load(f)["points"]
    spec = CampaignSpec(
        topo=mesh2d(4, 4), algos=(Algo.XY, Algo.BIDOR),
        patterns=("uniform", "tornado"), rates=(0.15, 0.5), seeds=(0, 1),
        base=SimConfig(cycles=1000, warmup=300, drain=100))
    res = run_campaign(spec, device=cuda)
    bad = []
    for p in res.points:
        r = p.result
        want = golden[f"{p.pattern}/{p.algo.name}/r{p.rate}/s{p.seed}"]
        ints = dict(injected=r.injected_flits, ejected=r.ejected_flits,
                    in_flight=r.in_flight_flits, reorder=r.reorder_value,
                    meas_cycles=r.meas_cycles)
        floats = dict(throughput=r.throughput, avg_latency=r.avg_latency,
                      p50_latency=r.p50_latency, p99_latency=r.p99_latency,
                      link_load_max=r.link_load_max, lcv=r.lcv)
        bad += [f"{k}: {v} != {want[k]}" for k, v in ints.items()
                if v != want[k]]
        bad += [f"{k}: {v} != {want[k]}" for k, v in floats.items()
                if not np.isclose(round(v, 6), want[k], rtol=1e-5,
                                  atol=1e-6)]
    log(f"golden: {len(res.points)} points vs campaign_4x4.json: "
        f"{'ok' if not bad else 'MISMATCH'} ({res.total_wall_clock_s:.2f}s)")
    if len(res.points) != len(golden) or bad:
        raise SystemExit("golden mismatch:\n  " + "\n  ".join(bad))


def _check_results(res, np):
    for p in res.points:
        r = p.result
        vals = [r.throughput, r.avg_latency, r.p99_latency, r.lcv,
                r.link_load_max]
        if not all(np.isfinite(v) for v in vals):
            raise SystemExit(f"non-finite result {r}")
        if r.injected_flits != r.ejected_flits + r.in_flight_flits:
            raise SystemExit(f"flits not conserved: {r}")
        if r.reorder_value != 0:        # XY and BiDOR deliver in order
            raise SystemExit(f"out-of-order delivery: {r}")


def run_paper(torch, np, cuda):
    from repro_torch.core import mesh2d_edge_io
    from repro_torch.noc import Algo, CampaignSpec, SimConfig, run_campaign

    spec = CampaignSpec(
        topo=mesh2d_edge_io(5, 5), algos=(Algo.XY, Algo.BIDOR),
        patterns=("uniform", "overturn"), rates=(0.2, 0.4, 0.55, 0.7),
        seeds=(0,), base=SimConfig(cycles=14000, warmup=4666), chunk=3500)
    res = run_campaign(spec, device=cuda)
    _check_results(res, np)
    for p in res.points:
        log(f"paper: {p.pattern:9s} {p.result.summary()}")
    for key, dt in res.wall_clock_s.items():
        log(f"paper: cell {'/'.join(key)} wall={dt:.3f}s "
            f"ms_per_cycle={dt * 1e3 / spec.base.cycles:.4f}")
    log(f"paper: plan_ms={res.plan_wall_clock_s * 1e3:.1f} "
        f"stages_ms={json.dumps(res.plan_stage_ms)} "
        f"total={res.total_wall_clock_s:.2f}s")


def run_scale(torch, np, cuda):
    from repro_torch.core import mesh2d
    from repro_torch.kernels.simstep.ops import resolve_path
    from repro_torch.noc import Algo, CampaignSpec, SimConfig, run_campaign

    spec = CampaignSpec(
        topo=mesh2d(32, 32), algos=(Algo.XY, Algo.BIDOR),
        patterns=("uniform",), rates=(0.1, 0.3), seeds=(0, 1),
        base=SimConfig(cycles=3000, warmup=1000), chunk=1000)
    torch.cuda.reset_peak_memory_stats()
    res = run_campaign(spec, device=cuda)
    _check_results(res, np)
    meta = dict(N=1024)
    tile = resolve_path(meta, spec.base, 4, cuda)
    for p in res.points:
        log(f"scale: {p.result.summary()} meas={p.result.meas_cycles}")
    for key, dt in res.wall_clock_s.items():
        log(f"scale: cell {'/'.join(key)} tile={tile} wall={dt:.3f}s "
            f"ms_per_cycle={dt * 1e3 / spec.base.cycles:.4f}")
    log(f"scale: plan_ms={res.plan_wall_clock_s * 1e3:.1f} "
        f"stages_ms={json.dumps(res.plan_stage_ms)} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")


def simstep_bytes(torch, meta, cfg, step, u, ud, cycle):
    """Bytes each kernel of one cycle must move, counted on the cycle run
    here: each array read once and written once, shared tables once per
    launch, per-port tables per port, gathers per entry the cycle's data
    needs (a head flit only where an input holds one, a pop's writes only
    where an input pops, generation's reads only where a packet is made).
    The snapshot copy of ``fifo_size`` is this design's cost and is left
    out.  Returns (tile bytes, finish bytes)."""
    from repro_torch.kernels.simstep.ref import MOV_W
    from repro_torch.noc.simconfig import F_TAIL, NF, NQ, Algo

    st = step.state
    n, p, v, c = meta["N"], meta["P"], meta["V"], meta["C"]
    lanes, pv = st["fifo_size"].shape[0], meta["P"] * meta["V"]
    full = st["fifo_size"] > 0                      # inputs with a head flit
    nonempty = int(full.sum())
    locked = int((full & (st["lock_op"] >= 0)).sum())
    queued = int((st["q_size"] > 0).sum())
    measuring = int(st["cycle0"][0]) + cycle >= cfg.warmup
    step.step(u, ud, cycle)
    torch.cuda.synchronize()
    gen, push, _, inj, _ = (int(x) for x in step.parts.sum((0, 1)))
    granted = step.mov[..., NF + 3] != 0
    local = step.mov[..., NF] == meta["P_LOCAL"]
    grants = int(granted.sum())
    net = int((granted & ~local).sum())
    tails = int((granted & local & (step.mov[..., F_TAIL] != 0)).sum())
    search = max(int(n).bit_length(), 1)
    bidor = cfg.algo == Algo.BIDOR
    tile_words = (
        3 * n * p + c + n                       # neighbor, recv_port, chan_of,
                                                # chan_bw, p_gen: once a launch
        + lanes * (3 + step.ntiles * 5)         # rate, cycle0, until; parts out
        + lanes * n * (1 + 3 + p + p * MOV_W)   # u, queue head/size/progress,
                                                # rr; mov out
        + lanes * n * pv                        # fifo_size, read once
        + gen * (1 + search + 2 + bidor)        # ud, CDF search, next_seq r/w,
                                                # choice
        + push * NQ                             # queue record out
        + queued * (NQ + 1)                     # head record, local FIFO start
        + inj * (NF + 1 + 3)                    # flit, FIFO size, queue state out
        + nonempty * (1 + NF + 1 + 1 + 1)       # start, head flit, lock, port
                                                # gather, out_held
        + locked                                # lock_ov
        + grants * (2 + 2 + 1)                  # start/size, locks, rr out
        + net)                                  # out_held out
    finish_words = (
        n * p + 2 * min(net, n * p)             # chan_of; neighbor, recv_port
        + lanes * (2 + step.ntiles * 5 + 10)    # cycle0, until, parts; sums
        + lanes * n * p * MOV_W                 # mov in
        + net * (2 + NF + 1 + 2 + 2 * measuring)  # receiving FIFO, flit, size;
                                                # channel counters
        + 2 * measuring * (grants + tails)      # node_fwd, eject_flits r/w
        + tails * (1 + 2 + 2)                   # exp_seq in; exp_seq, rbits,
                                                # lat_hist out
        + measuring * lanes * n * n)            # the reorder scan reads rbits
    return 4 * tile_words, 4 * finish_words


def time_simstep(torch, np, cuda, topo, label):
    """Event-timed kernel pair and plain twins at one cell's shapes."""
    from repro_torch import prng
    from repro_torch.kernels.simstep import draw_chunk, make_step, ref
    from repro_torch.noc import sim
    from repro_torch.noc.simconfig import Algo

    tables, meta, cfg, points = _cell(torch, cuda, topo, Algo.XY, 4)
    n = meta["N"]
    st = sim.make_states(meta, cfg, points, device=cuda)
    sim.run_cycles(tables, meta, cfg, st, 300)      # into measurement
    step = make_step(meta, cfg, tables, st)
    reps = 200
    _, u, ud = draw_chunk(st["key"], reps + 1, n, cuda)
    tile_ms, finish_ms = time_launches(torch, [
        lambda r: step.simstep_tile(u[r], ud[r], 300 + r),
        lambda r: step.simstep_finish(300 + r)], reps)
    # plain twins on the same state, one tile
    tile_fn, finish_fn = ref.make_cycle_parts(meta, cfg)
    fs_pre = st["fifo_size"].clone()
    box = {}

    def plain_tile():
        box["mov"], box["parts"] = tile_fn(tables, st, u[0], ud[0], fs_pre,
                                           300, 0, n)

    plain_tile_ms = time_wall(torch, plain_tile, 10)
    plain_finish_ms = time_wall(
        torch, lambda: finish_fn(tables, st, box["mov"], box["parts"], 300),
        10)
    # where a simulated cycle's wall time goes: a 1000-cycle chunk through
    # the entry point, the host key chain alone, and the kernels' share
    chunk = 1000
    t0 = time.perf_counter()
    prng.chain_keys(st["key"], chunk)
    chain_us = (time.perf_counter() - t0) * 1e6 / chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run_cycles(tables, meta, cfg, st, chunk)
    torch.cuda.synchronize()
    cycle_us = (time.perf_counter() - t0) * 1e6 / chunk
    busy = (tile_ms + finish_ms) * 1e3 / cycle_us
    log(f"timing {label}: cycle wall {cycle_us:.2f}us, of it host key "
        f"chain {chain_us:.2f}us; device busy share of the cycle "
        f"(kernel time / wall) {busy:.3f}")
    lanes = len(points)
    tile_bytes, finish_bytes = simstep_bytes(torch, meta, cfg, step, u[reps],
                                             ud[reps], 300 + reps)
    tile_bound = tile_bytes / HBM_BYTES_PER_S * 1e3
    finish_bound = finish_bytes / HBM_BYTES_PER_S * 1e3
    log(f"timing {label}: simstep_tile {tile_ms * 1e3:.2f}us "
        f"(bound {tile_bound * 1e3:.3f}us) simstep_finish "
        f"{finish_ms * 1e3:.2f}us (bound {finish_bound * 1e3:.3f}us) per "
        f"launch (tile={step.tile_nodes}, lanes={lanes}); plain tile "
        f"{plain_tile_ms:.3f}ms finish {plain_finish_ms:.3f}ms")
    return [
        dict(name="simstep_tile", route="cuda",
             source="src/repro_torch/kernels/csrc/simstep.cu",
             replaces="src/repro/kernels/simstep/kernel.py:50,121",
             ms=tile_ms, plain_ms=plain_tile_ms, bound_ms=tile_bound,
             bound_by="bytes", library_ms=None),
        dict(name="simstep_finish", route="cuda",
             source="src/repro_torch/kernels/csrc/simstep.cu",
             replaces="src/repro/kernels/simstep/kernel.py:50,121",
             ms=finish_ms, plain_ms=plain_finish_ms, bound_ms=finish_bound,
             bound_by="bytes", library_ms=None),
    ]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels import build
    from repro_torch.core import mesh2d, mesh2d_edge_io

    cuda = torch.device("cuda")
    t_all = time.perf_counter()
    card = card_line()
    log(f"card: {card}")

    secs = build.build()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} s "
        f"into {build.build_dir()}")
    for name in build.SOURCES:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    poss = check_possibility(torch, np, cuda)
    simstep_err = check_simstep(torch, np, cuda)

    kernels.reset_launches()                 # the main path: phases 4–6
    check_golden(torch, np, cuda)
    run_paper(torch, np, cuda)
    run_scale(torch, np, cuda)
    launches = dict(kernels.LAUNCHES)
    log(f"main path launches: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: "
                         f"{missing}")

    timed = time_simstep(torch, np, cuda, mesh2d(32, 32), "32x32")
    time_simstep(torch, np, cuda, mesh2d_edge_io(5, 5), "5x5")
    rows = [poss] + timed
    for row in rows:
        row["launches"] = launches[row["name"]]
        row.setdefault("max_abs_err", float(simstep_err))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(f"total: {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
