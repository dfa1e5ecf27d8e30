#!/usr/bin/env python3
"""Drive the port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--full]

Run from a checkout (it imports ``src/repro_torch`` beside this file).
Each phase prints one or more lines; any mismatch raises, so the script
exits non-zero, and there is no CPU path: without a CUDA device it stops
before printing any result.  The parts below marked (--full) hold
nothing against anything and only add numbers (``FULL_ONLY``: the
serving decoders' device profiles, the flit step's timings by algorithm,
zoo shape and instrumented instance); they run with ``--full``.  The
default run keeps every main path, every kernel against its plain
version and every golden.

1. card     — ``nvidia-smi`` name and power limit;
2. build    — every CUDA source under ``src/repro_torch/kernels/csrc``
              (one nvcc each, in parallel) into ``build/repro_torch/``;
3. kernels  — each kernel against its plain version on the card:
              ``possibility_v`` at every size the main paths launch it
              (N = 8, 16, 25, 256, 1024; integer T bit for bit, real T to
              rtol 1e-12); ``possibility_weights`` on the Fig. 1 5x5
              plans, torus(2,4) and torus(16,16) (offsets 1 and 2) and
              mesh2d(32,32),
              within one float32 ulp of the twin and of
              ``possibility_v``'s ``V.sum(1)`` and ``V[c, n_c]``; both
              timed beside a bound of 3 warp instructions a triple, their
              8 x 4 loops' count printed beside it (``cuobjdump -sass``);
              the ``simstep_chunk``
              kernel on the 5x5 edge-I/O, 16x16 and 32x32 meshes and the
              ``simstep_grid`` kernel on 17x17, 64x64 and 96x96
              (no cluster holds their lanes), every routing algorithm at 5x5,
              16x16 and 17x17, XY and BiDOR at 32x32, XY alone at 64x64
              and 96x96, at the auto tile and the largest other one the
              card lays out, chunks of 1 and 50 cycles from a plain
              mid-flight state, every state key bit for bit, the PRNG key
              included, and one launch a chunk;
Main path of slice 1 (launch counts from 0):
4. golden   — ``run_campaign`` on the 4x4 golden parameters against
              ``tests/goldens/campaign_4x4.json``;
5. paper    — the paper's 5x5 edge-I/O cells at fig8's full length;
6. scale    — 32x32 uniform, XY and BiDOR, on 16-block clusters, twice
              (the second round warm), then 64x64 uniform, XY, on the
              grid kernel;
Main path of slice 2 (launch counts from 0 again):
7. nrank    — ``build_plan(use_kernel=True)`` on the paper's Fig. 1
              scenarios, channel and node modes, equal to
              ``use_kernel=False``; on torus(16,16) and mesh2d(32,32)
              against ``build_plan_fast``;
8. fig1     — those plans through ``run_campaign(bidor_tables=...)`` at
              ``benchmarks/fig1_load.py``'s full length;
9. ctrl     — ``tests/goldens/ctrl_4x4.json`` through the control plane,
              then ``benchmarks/dynamics.py`` at full size (BiDOR and
              odd-even);
10. flash   — ``flash_attention`` against its plain twin at whisper-base's
              shapes (B 4, H = KV = 8, D 64: the encoder, cross-attention
              and cached self-attention at Sq 16 and 1) and at a GQA
              (internlm2) and a D = 80 (stablelm) shape, bf16 and fp32;
              and at Jamba's (B 4, GQA 64/8, D 128: the prefill's 2 048
              queries and a decode step against the 2 080-row cache); and
              at the dense family's served shapes (internlm2 GQA 16/8 at
              16- and 2 048-token prompts and their decode steps,
              stablelm D 80 and codeqwen D 128, MHA 32), and at slice
              14's (qwen2-moe MHA 16, dbrx GQA 48/8, minicpm3's MLA
              with Dk 96 and Dv 64 on the split path, its combine, the
              tensor-core and the CUDA-core kernels), at slice 15's
              (qwen2-vl GQA 12/2 at 16 prompt tokens, their decode step,
              the image-style prompt's 72 positions and its decode
              step), and at (Dk, Dv) pairs no kernel is built for,
              (24, 16), (40, 40) and (72, 72), which the op pads to the
              covering pair's kernels, on split, tc and simt; the
              path each shape takes (split-KV, tensor cores, CUDA cores)
              and its split count, µs per launch beside the twin,
              ``scaled_dot_product_attention`` and the bound;
11. scan    — ``selective_scan`` against its plain twin (h_last bit for
              bit, y within 1e-5 of the twin's largest value) at Jamba's
              prefill (B 4, S 2 048, Di 16 384, Ds 16; h0 zero and given)
              and decode (S 1) shapes and two ragged ones (S 33, Di 100,
              Ds 4; S 37, Di 70, Ds 13); µs per launch beside the twin
              and the bound's four terms (expf's instructions read from
              the library's machine code, and the step loop's a state),
              the decode step after a read and after a write flush of
              the L2;
Main path of slice 3 (launch counts from 0 again):
12. serve   — whisper-base at full width (bf16, random weights from numpy
              seed 0 at the serve golden's scales, so the greedy tokens
              vary): encode, then ``ServeEngine.generate`` for 4 requests of
              16 prompt and 24 new tokens; then, off the counted path, the
              same run on the plain twin (logits of every step), the run in
              fp32 (tokens identical), ``tests/goldens/serve_whisper_smoke.json``
              on the card, and a timed repeat with ``cross_kv``'s share;
Main path of slice 4 (launch counts from 0 again):
13. jamba   — jamba-1.5-large-398b at its published widths, cut to one
              super-block (1 attention + 7 Mamba layers) without experts,
              bf16, the registry's weights drawn on the card from seed 0:
              ``ServeEngine.generate`` for 4 requests of 2 048 prompt and
              24 new tokens (168 ``selective_scan`` and 24
              ``flash_attention`` launches); then, off the counted path,
              the same run on the plain twins (logits of every step), warm
              timings and the device profile, the run in fp32 (tokens
              identical), and ``tests/goldens/serve_jamba_smoke.json`` on
              the card;
Main path of slice 10 (launch counts from 0 again):
14. algos   — ``tests/goldens/algos_5x5.json`` (written by the JAX
              reference): every routing algorithm through ``run_campaign``
              and the Fig. 9 ones through ``run_trace_sweep``;
15. fig8    — ``benchmarks/fig8_synthetic.py`` at full length: each
              (pattern, algorithm)'s saturation throughput, BiDOR/XY;
16. table1  — ``benchmarks/table1_lcv.py`` at full length: the LCVs;
17. fig9    — ``benchmarks/fig9_realistic.py`` at full length: latency,
              LCV and reorder per algorithm, the paper's summary line;
Main path of slice 12 (launch counts from 0 again):
18. service — the campaign service on the card (``CampaignJob``,
              ``device=cuda``): the paper's cells killed and resumed after
              every cell, then a fresh job on the warm plan cache (both
              ``results.csv`` byte for byte equal to ``run_paper``'s rows;
              the warm job plans nothing and launches no possibility
              kernel); the reference's chaos stage at 8 000 cycles, killed
              after every cell and inside a scenario cell (resumed from
              its epoch-boundary snapshot), against a fresh job, then a
              truncated cell quarantined; the obs stage at 4 000 cycles,
              traced and rendered (the trace's control-plane chain,
              online's peak load under stale's); a 32x32 BiDOR cell cold
              and warm (plan ms); the three stages at ``BENCH_QUICK``
              lengths against ``tests/goldens/service_4x4.json``; any
              retried or failed cell fails the phase;
Main paths of slice 13 (launch counts from 0 before each):
19. mltraffic — the reference's ML-traffic stage: four workloads (qwen2-moe
              decode; dbrx, internlm2, stablelm train + decode) derived
              from the reference's recorded post-SPMD HLO
              (``tests/goldens/mltraffic/``), each matrix on torus(2,4)
              planned with ``build_plan(use_kernel=True)``, refined
              (``greedy_refine``) and certified; against
              ``tests/goldens/mltraffic.json``: ops, totals, matrices bit
              for bit, max link loads, choice tables, certificates; flows
              conserved per phase and kind; then one ``CampaignJob`` on
              the card (XY, BiDOR; rates 0.1, 0.3) at 2 000 and at 200
              cycles, rows against the golden's;
20. dense   — internlm2-1.8b at its published widths, nothing cut, bf16,
              the registry's weights drawn on the card:
              ``ServeEngine.generate`` for 4 requests of 16 prompt and 24
              new tokens (one ``flash_attention`` launch a layer and
              call); then, off the counted path, the plain twins (logits
              of every step), warm timings and the profile (--full), the
              same at 4 × 2 048-token prompts, the fp32 run
              (tokens identical), stablelm-3b and codeqwen1.5-7b one
              ``generate`` each, and
              ``tests/goldens/serve_dense_smoke.json`` on the card;
Main paths of slice 14 (launch counts from 0 before each; run after the
others' checks have freed their weights):
21. moe     — qwen2-moe-a2.7b at its published widths and depth, nothing
              cut (28.63 GB in bf16), the registry's weights drawn on the
              card: ``ServeEngine.generate`` for 4 requests of 16 prompt
              and 24 new tokens, 576 ``flash_attention`` launches, all
              split, the dropped (token, slot) pairs a step; then, off
              the counted path, warm timings and the profile (--full),
              the plain
              twins and the float32 model of the same weights
              (``fp32_weights``: each bf16 weight upcast as an op reads
              it), the routes that differ, fp32 through the kernels and
              the twins (tokens and routes identical); dbrx-132b at 8 of
              40 layers and Jamba with 8 of its 16 experts (one
              super-block) the same way, one at a time; and
              ``tests/goldens/serve_moe_smoke.json`` on the card (aux and
              drops of every call included);
22. mla     — minicpm3-4b whole (MLA: Dk 96, Dv 64): ``generate`` as
              above, 1 488 ``flash_attention`` launches, all split; off
              the count, warm timings and the profile (--full), the twins
              and fp32, 4 × 2 048-token prompts in bf16 (the tensor-core
              prefill, split steps) and fp32 (the CUDA-core prefill), and
              ``tests/goldens/serve_mla_smoke.json`` through the kernels
              (its smoke's (Dk, Dv) = (24, 16) padded to (32, 32));
Main paths of slice 15 (launch counts from 0 before each; each phase's
wall printed):
23. vlm     — qwen2-vl-2b whole (M-RoPE sections (16, 24, 24), GQA 12/2
              at head dim 128, 3.55 GB in bf16), the registry's weights
              drawn on the card: ``generate`` as above on text (equal
              t/h/w ids), 672 ``flash_attention`` launches (the prefill's
              96 packed rows on the tensor-core kernel, the steps split);
              off the count, warm timings and the profile (--full), an
              image-style
              prompt (4 text tokens, an 8 x 8 grid of stub-frontend patch
              embeddings at patch-grid ids, 4 text tokens) and 8 decode
              steps, it and the served run against the twins and the
              fp32 model of the same weights (the kernels' error against
              fp32 at most twice the twins'), fp32 through the kernels
              (the prefill on the CUDA-core kernel) against the twins,
              served and image-style, and
              ``tests/goldens/serve_vlm_smoke.json``;
24. ssm     — xlstm-1.3b whole (48 layers: 6 super-blocks of 1 sLSTM + 7
              mLSTM, 7.26 GB in bf16, a 2.82 GB float32 state at batch
              4): ``generate`` as above, which launches no kernel (the
              reference has none for xLSTM); off the count, warm timings
              and the profile (--full) against reading the weights and the state
              once a step, the float32 model of the same weights (its
              prefill and 24 decode steps against one ``forward`` over
              the same 40 tokens, within 2e-3 of a position's largest
              logit), the bf16 logits' error against it, and
              ``tests/goldens/serve_ssm_smoke.json``;
Main path of slice 16 (launch counts from 0; run after the others have
freed their weights):
25. train   — internlm2-1.8b at its published widths and depth, nothing
              cut, bf16, the registry's weights drawn on the card from
              seed 0: 12 steps through the launcher's loop
              (``launch.train.train_loop``) on its default batch (8 × 128
              tokens of ``SyntheticLM``), fp32 moments, remat on, no
              checkpoint I/O; each step's loss, grad norm, ms and
              tokens/s; the last loss below the first; 576
              ``flash_attention`` launches, all on the tensor-core kernel
              with the lse (each layer twice a step: the first run and
              the recomputation), 288 ``flash_attention_bwd``, all on the
              tensor-core route (``csrc/flash_attention_bwd_tc.cu``); off
              the count, a full-width step through the kernels against the
              twins of both (loss and grad norm), ``grad_accum`` 2
              against 1, the step in parts (forward, backward, optimizer)
              and profiled, 3 steps with int8 moments, whisper-base at full
              width for one step (the encoder's and cross-attention's
              non-causal backward, Skv 1 500) and against its twins, the
              backward kernels against their twins (bf16 by the ratio
              rule, fp32 within 1e-4 of the largest gradient) and the
              forward's lse at the training shape, Jamba's (B 2, S 1 024,
              GQA 64/8), (B 1, S 2 048), whisper's cross-attention, MLA's
              (96, 64) and D 192 and 256; in bf16 at the first three the
              tc route timed beside the CUDA-core one (route simt, held by
              the same rule), SDPA's backward and the bound (and the twin
              at the training shape), and ``launch.train.main`` at the
              smoke config
              preempted by SIGTERM after step 3 and resumed, equal to an
              uninterrupted run bit for bit;
Main paths of slice 17 (launch counts from 0 before each):
26. train_hybrid — jamba-1.5-large-398b at its published widths, one
              super-block (7 Mamba + 1 attention layer), no experts,
              bf16, remat on, int8 moments, the registry's weights drawn
              on the card from seed 0: 6 steps of 2 × 1 024 tokens of
              ``SyntheticLM`` through ``launch.train.main`` (``--layers 8
              --experts 0 --moments int8 --peak-lr 1e-4 --ckpt-every 0``:
              no checkpoint I/O); 84 ``selective_scan`` launches (each
              Mamba layer twice a step: the first run and the
              recomputation), 42 ``selective_scan_bwd`` and 42 of its
              reduction, 12 ``flash_attention`` on tc with
              the lse, 6 ``flash_attention_bwd`` on tc; the last loss below the
              first, the peak device memory; off the count, one step
              through the kernels against the twins of all four (loss
              within 2e-3, grad norm 2e-2), the step in parts and
              profiled, and ``selective_scan_bwd`` against its twin and
              autograd of the forward twin at the training shape (h0 and
              dh_last absent and given) and three ragged ones (every
              gradient within 1e-4 of its largest), a second run bit for
              bit, timed beside the twin and the bound;
27. examples — the reference's four example programs on the port
              (``repro_torch.examples``): ``train_lm --preset 100m
              --steps 20`` (fp32, attention on the CUDA-core kernel with
              its backward, route simt), ``serve_decode`` at its defaults,
              ``quickstart`` (8 000 cycles), ``qstar_ici_demo`` (torus
              16x16), their lines and walls;
28. summary — attention end to end (whisper's ``generate`` busy time
              and a Jamba decode step's, with the ``flash_fwd*`` kernels'
              share); the flit step at 4x4, 5x5, 16x16 and 32x32 (the
              chunk kernel) and 17x17 and 64x64 (the grid kernel): µs
              per simulated cycle of a 1 000-cycle chunk, its empty-body
              floor, its byte bound, the cycle wall through
              ``run_cycles``; a 100-cycle chunk beside the plain twin at
              32x32 and 64x64; each other routing algorithm's µs a cycle
              at 5x5 and 32x32, the zoo's shapes and the instrumented
              instance (--full);
              launches of each kernel on each main path (the
              possibility pair's also by (N, C)),
              event-timed time per launch, the plain version's time and
              the bound, as one JSON line; then the card line and the
              result.

    python3 chip_smoke.py --serve-wall [--src DIR] [--rounds N]

times whisper-base's serving alone (slice 3's main path: encode, the
prefill, ``generate``), warm, over N rounds, and the host time spent in
the attention op per call, in serving and alone at the decode step's
two shapes, with no profiler and no other phase.  With
``--src`` it imports the port from ``DIR`` instead of ``src/`` beside
this file, so two trees unpacked side by side (``git archive``) are
compared by one harness on one card.

    python3 chip_smoke.py --cycle-wall [--src DIR] [--rounds N]

times the flit step alone through ``run_cycles`` (µs per simulated cycle
of a 1 000-cycle chunk at each mesh above, 4 lanes), the paper cell's
wall and the scale cells' walls (32x32 XY and BiDOR, 64x64 XY; tables
included, plans not), N rounds, with no other phase; ``--src`` as
above.

    python3 chip_smoke.py --scan-wall [--src DIR] [--rounds N]

times the selective scan alone at Jamba's prefill and decode shapes
(event-timed; the decode after a read flush of the L2), Jamba's warm
prefill (host clock) and, from the profiler's device time of one
``generate`` less one prefill, its decode step and the scan's share of
it, N rounds, with no other phase; ``--src`` as above.

    python3 chip_smoke.py --poss-wall [--src DIR] [--rounds N]

times the possibility pair alone at every size the main paths launch it
(``possibility_v`` at N = 16, 25, 256, 1 024; ``possibility_weights`` on
the Fig. 1 5x5 channel sets, torus(16,16) and mesh2d(32,32)), event-timed,
N rounds, with no other phase; ``--src`` as above.

    python3 chip_smoke.py --flash-wall [--src DIR] [--rounds N]

times ``flash_attention`` alone, event-timed, at every shape above whose
V has Q's head dim, a multiple of 16 (bf16; fp32 where it splits and at
the encoder), N rounds, with no other phase; ``--src`` as above.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# --full: the timings off every counted path that hold nothing against
# anything (see ``FULL_ONLY``); the default run keeps every main path,
# every kernel against its plain version and every golden, so that it
# ends inside its time limit
FULL = False
FULL_ONLY = ("the serving decoders' device profiles (dense, moe, mla, vlm, "
             "ssm)", "the flit step's timings by algorithm, zoo shape and "
             "instrumented instance")

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
# dense tensor-core bf16 FLOP/s, and float32 FLOP/s outside the tensor
# cores (an fp32 attention has no tensor-core path at fp32 precision)
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


_T0 = time.perf_counter()


def log(*parts):
    """A line of output, prefixed with the script's elapsed seconds."""
    print(f"[{time.perf_counter() - _T0:7.1f}s]", *parts, flush=True)


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


def time_enqueue(torch, fn, reps: int, hold: bool = True) -> float:
    """Mean host ms to enqueue one call of ``fn`` (called as ``fn(r)``):
    with ``hold``, the card held busy so that no call waits for it;
    without, the card runs each call's kernels as they arrive, as in
    serving."""
    fn(0)
    torch.cuda.synchronize()
    if hold:
        _hold_stream(torch)
    t0 = time.perf_counter()
    for r in range(reps):
        fn(r)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


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
# the possibility pair: per SM and clock on an H100 (132 SMs, 1.98 GHz),
# 64 lanes each on the ALU pipe (integer compares), on the FMA pipe's
# integer side (IMAD) and on the fp64 pipe (34e12 fp64 FLOP/s counts an
# FMA twice)
PIPE_OPS_PER_S = 132 * 64 * 1.98e9
POSS_SOURCE = "src/repro_torch/kernels/csrc/possibility.cu"
# the arithmetic a triple needs, by the pipe it issues on, whatever ptxas
# emits for it: one int32 add (IMAD.IADD), one compare (ISETP) and one
# predicated fp64 add, which issues whether or not its predicate holds
POSS_TRIPLE = {"fma": 1, "alu": 1, "fp64": 1}
# the kinds of a triple's instructions ``_poss_sass`` counts in the
# built loops; a select (ptxas's form of the predicated add) is the
# compiler's cost and no part of the bound
POSS_KINDS = ("add", "compare", "select", "sum")


def _poss_op(op: str):
    if op == "IMAD.IADD" or op.startswith("IADD3"):
        return "add"
    if op.startswith("ISETP"):
        return "compare"
    if op in ("FSEL", "SEL"):
        return "select"
    if op in ("DFMA", "DADD"):
        return "sum"
    return None


def _sass(lib: str) -> dict:
    """The machine code of a built library (``cuobjdump -sass``): for each
    function, its (address, opcode, operands) in order."""
    import re

    from repro_torch.kernels import build

    build.build([lib])
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    code, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            code[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
                     r"([^;]*)", line)
        if m and name is not None:
            code[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return code


def _poss_sass():
    """From the machine code of the possibility library (``cuobjdump
    -sass``), for the 8 x 4 tile's V and W kernels (N = 1024): of the
    innermost loops, the one with the most fp64 sums (the rows of a full
    stage), its instructions a triple in all, and a triple's add,
    compare, select and sum (each opcode's count over the sums', whole:
    the loop's own compare is not a triple's).  A diagnostic printed
    beside the bound, which counts :data:`POSS_TRIPLE` instead."""
    import re

    code = _sass("possibility")
    out = {}
    for kind, tag in (("v", "possibility_kernelILi8ELi4EdLb0E"),
                      ("w", "possibility_kernelILi8ELi4EfLb1E")):
        fn = next(c for n, c in code.items() if tag in n)
        loops = []                        # (first, last) address
        for at, op, rest in fn:
            back = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if back and int(back.group(1), 16) < at:
                loops.append((int(back.group(1), 16), at))
        best = []
        for lo, hi in loops:
            if any(lo <= a and b < hi for a, b in loops if (a, b) != (lo, hi)):
                continue                  # holds another loop
            body = [o for a, o, _ in fn if lo <= a <= hi]
            if (sum(_poss_op(o) == "sum" for o in body)
                    > sum(_poss_op(o) == "sum" for o in best)):
                best = body
        sums = sum(_poss_op(o) == "sum" for o in best)
        per = {k: sum(_poss_op(o) == k for o in best) // sums
               for k in POSS_KINDS}
        out[kind] = dict(per, loop=len(best) / sums)
    return out


def _poss_bound(triples: int, nbytes: int):
    """Least time on this run's inputs, the largest of five terms: a
    triple's arithmetic (:data:`POSS_TRIPLE`, 3 warp instructions) at
    one warp instruction a scheduler a clock; each pipe's share at its 64
    lanes an SM a clock; the inputs read and the outputs written once
    over HBM's rate."""
    need = sum(POSS_TRIPLE.values())
    terms = {"issue": need * triples / 32 / WARP_ISSUE_PER_S * 1e3}
    for pipe, ops in POSS_TRIPLE.items():
        terms[pipe] = ops * triples / PIPE_OPS_PER_S * 1e3
    terms["bytes"] = nbytes / HBM_BYTES_PER_S * 1e3
    top = max(terms, key=terms.get)
    return terms[top], ("bytes" if top == "bytes" else "operations"), terms


def _terms(terms) -> str:
    return ", ".join(f"{k} {v * 1e3:.2f}" for k, v in terms.items())


def check_possibility(torch, np, cuda, sass):
    """possibility_v as the planner calls it (du = dn = dist, offset 0)
    at every size the main paths launch it, each with the thread tile its
    layout picks (torus2x4 (the ML-traffic stage, N = 8), 4x4, both 5x5
    meshes, torus16x16: 2 x 2; mesh32x32: 8 x 4): integer T bit for bit,
    real T to rtol 1e-12; µs per launch at N = 8 and at N = C = 1024
    beside the plain twin and the bound."""
    from repro_torch import core
    from repro_torch.kernels.possibility import (possibility_v,
                                                 possibility_v_plain)
    from repro_torch.kernels.possibility import kernel as K

    rng = np.random.default_rng(0)
    worst = 0.0
    small = None
    for topo in (core.torus(2, 4), core.mesh2d(4, 4), core.mesh2d(5, 5),
                 core.mesh2d_edge_io(5, 5), core.torus(16, 16),
                 core.mesh2d(32, 32)):
        n = topo.num_nodes
        lay = K.possibility_layout(
            n, n, False, torch.cuda.get_device_properties(
                cuda).multi_processor_count)
        tile = "x".join(map(str, K.THREAD_TILES[lay.cfg]))
        dist = torch.as_tensor(topo.distances, device=cuda)
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
                worst = max(worst, err)
            log(f"kernels: possibility_v {topo.name} N={n} tile {tile} "
                f"grid {lay.grid} {kind} T: max_abs_err={err!r} "
                f"{'bitwise' if kind == 'integer' else 'rtol 1e-12'} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"possibility_v disagrees with plain on "
                                 f"{topo.name} ({kind} T)")
        if small is None:
            small = (n, dist, t)
    n8, d8, t8 = small
    ms8 = time_launches(
        torch, [lambda r: possibility_v(d8, d8, t8, d8, offset=0)], 200)[0]
    plain8 = time_wall(
        torch, lambda: possibility_v_plain(d8, d8, t8, d8, offset=0), 3)
    bound8, by8, _ = _poss_bound(n8 ** 3, n8 * n8 * 28)
    log(f"kernels: possibility_v N={n8} (torus2x4): {ms8 * 1e3:.2f}us per "
        f"launch; bound {bound8 * 1e3:.4f}us ({by8}); plain "
        f"{plain8:.3f}ms")
    ms = time_launches(
        torch, [lambda r: possibility_v(dist, dist, t, dist, offset=0)],
        100)[0]
    plain_ms = time_wall(
        torch, lambda: possibility_v_plain(dist, dist, t, dist, offset=0), 3)
    nbytes = n * n * (4 + 4 + 4 + 8 + 8)    # du, dn, dist, T in; V out
    bound, by, terms = _poss_bound(n ** 3, nbytes)
    log(f"kernels: possibility_v N={n}: {ms * 1e3:.2f}us per launch; bound "
        f"{bound * 1e3:.2f}us ({by}; terms in us: {_terms(terms)}), "
        f"{bound / ms:.3f} of it; the loop issues {sass['v']['loop']:.3f} "
        f"instructions a triple against the bound's "
        f"{sum(POSS_TRIPLE.values())}; plain {plain_ms:.3f}ms")
    return dict(name="possibility_v", route="cuda", source=POSS_SOURCE,
                replaces="src/repro/kernels/possibility/kernel.py:112",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


def _ulps(np, got, want) -> int:
    """Largest distance in float32 ulps between two float32 arrays."""
    g, w = (np.asarray(a, np.float32) for a in (got, want))
    return int(np.max(np.abs(g.view(np.int32).astype(np.int64)
                             - w.view(np.int32).astype(np.int64)),
                      initial=0))


def check_possibility_weights(torch, np, cuda, sass):
    """possibility_weights against its plain twin and against
    possibility_v (W = V.sum(1), W_drn = V[c, n_c], since dn[c, n_c] = 0)
    within one float32 ulp, on the Fig. 1 5x5 plans (25 nodes fill no
    tile), torus(2,4) (the ML-traffic stage), torus(16,16) and
    mesh2d(32,32), offsets 1 and 2 (mesh2d(32,32): 1); event-timed on
    each topology the nrank phase and the ML-traffic stage plan.  Returns
    (kernel row, {label: ms})."""
    from repro_torch import core
    from repro_torch.core import mesh2d, torus
    from repro_torch.kernels.possibility import (
        possibility_v, possibility_weights_op, possibility_weights_plain,
        prepare_weights)

    rng = np.random.default_rng(1)
    worst_err, worst_ulp = 0.0, 0
    cases = [(f"{name} (5x5)", getattr(core, topo_fn)(5, 5), pattern, (1, 2))
             for name, topo_fn, pattern in FIG1]
    t16, m32 = torus(16, 16), mesh2d(32, 32)
    cases += [("torus2x4 random", torus(2, 4), "random", (1, 2)),
              ("torus16x16 uniform", t16, "uniform", (1, 2)),
              ("torus16x16 random", t16, "random", (1, 2)),
              ("mesh32x32 random", m32, "random", (1,))]
    for label, topo, kind, offsets in cases:
        n, c = topo.num_nodes, topo.num_channels
        t = (rng.random((n, n)) if kind == "random"
             else core.traffic.PATTERNS[kind](topo))
        args = prepare_weights(topo.distances, t, topo.channels, cuda)
        du, dn, _, _, t32, dist = args
        ns = torch.as_tensor(topo.channels[:, 1], device=cuda)
        for offset in offsets:
            got = possibility_weights_op(*args, offset=offset)
            want = possibility_weights_plain(*args, offset=offset)
            v = possibility_v(du, dn, t32.double(), dist, offset=offset)
            via_v = (v.sum(1).float(),
                     v[torch.arange(c, device=cuda), ns].float())
            torch.cuda.synchronize()
            ulp = max(_ulps(np, g.cpu().numpy(), w.cpu().numpy())
                      for g, w in zip(got, want))
            ulp_v = max(_ulps(np, g.cpu().numpy(), w.cpu().numpy())
                        for g, w in zip(got, via_v))
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            worst_err, worst_ulp = max(worst_err, err), max(worst_ulp, ulp)
            ok = ulp <= 1 and ulp_v <= 1
            log(f"kernels: possibility_weights {label} T offset={offset} "
                f"(N={n}, C={c}): max_abs_err={err!r} ulps={ulp}, against "
                f"V.sum(1) and V[c,n_c] ulps={ulp_v} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"possibility_weights disagrees on {label}, "
                                 f"offset {offset}")
    kernel_ms = {}
    for label, topo in (("torus2x4", torus(2, 4)), ("5x5 mesh", mesh2d(5, 5)),
                        ("5x5 edge-I/O", core.mesh2d_edge_io(5, 5)),
                        ("torus16x16", t16), ("mesh32x32", m32)):
        a = prepare_weights(topo.distances, rng.random((topo.num_nodes,) * 2),
                            topo.channels, cuda)
        kernel_ms[label] = time_launches(
            torch, [lambda r: possibility_weights_op(*a)],
            20 if topo.num_nodes > 256 else 200)[0]
    n, c = m32.num_nodes, m32.num_channels
    plain_ms = time_wall(torch, lambda: possibility_weights_plain(*args), 1)
    nbytes = 4 * (4 * n * c + 2 * n * n + 2 * c)
    bound, by, terms = _poss_bound(c * n * n, nbytes)
    log("kernels: possibility_weights us per launch: "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in kernel_ms.items())
        + f"; mesh32x32 (N={n}, C={c}) bound {bound * 1e3:.2f}us ({by}; "
        f"terms in us: {_terms(terms)}), {bound / kernel_ms['mesh32x32']:.3f}"
        f" of it; the loop issues {sass['w']['loop']:.3f} instructions a "
        f"triple against the bound's {sum(POSS_TRIPLE.values())}; plain "
        f"{plain_ms:.3f}ms")
    row = dict(name="possibility_weights", route="cuda", source=POSS_SOURCE,
               replaces="src/repro/kernels/possibility/kernel.py:61",
               max_abs_err=worst_err, ms=kernel_ms["mesh32x32"],
               plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               library_ms=None)
    return row, kernel_ms


FIG1 = (("mesh_uniform", "mesh2d", "uniform"),
        ("edgeio_uniform", "mesh2d_edge_io", "uniform"),
        ("edgeio_overturn", "mesh2d_edge_io", "overturn"))


def run_nrank(torch, np, cuda, kernel_ms):
    """build_plan's kernel path against its host path (Fig. 1) and
    against the device planner (torus16x16, mesh32x32).  Returns the
    channel-mode Fig. 1 plans for the fig1 phase."""
    from repro_torch import core

    plans = {}
    for name, topo_fn, pattern in FIG1:
        topo = getattr(core, topo_fn)(5, 5)
        t = core.traffic.PATTERNS[pattern](topo)
        for mode in ("channel", "node"):
            t0 = time.perf_counter()
            kern = core.build_plan(topo, t, mode=mode, use_kernel=True,
                                   device=cuda)
            kern_ms = (time.perf_counter() - t0) * 1e3
            host = core.build_plan(topo, t, mode=mode, device=cuda)
            diff = np.argwhere(kern.table.choice != host.table.choice)
            log(f"nrank: {name} {mode}: iterations kernel="
                f"{kern.nrank.iterations} host={host.nrank.iterations}, "
                f"choice entries differing={len(diff)} "
                f"{diff[:8].tolist()} plan_ms={kern_ms:.1f} "
                f"{'ok' if not len(diff) else 'MISMATCH'}")
            if len(diff):
                raise SystemExit(f"build_plan kernel path differs from the "
                                 f"host path on {name}/{mode}")
            if mode == "channel":
                plans[name] = (topo, t, kern)
    for label, topo in (("torus16x16", core.torus(16, 16)),
                        ("mesh32x32", core.mesh2d(32, 32))):
        t = core.traffic.uniform(topo)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = core.build_plan(topo, t, use_kernel=True, device=cuda)
        plan_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        core.bidor(topo, plan.w_nr)             # the host BiDOR stage alone
        bidor_ms = (time.perf_counter() - t0) * 1e3
        fast = core.build_plan_fast(topo, t, device=cuda)
        ndiff = int((plan.table.choice != fast.table.choice).sum())
        rel = float(np.max(np.abs(plan.w_nr - fast.w_nr)
                           / np.maximum(np.abs(fast.w_nr), 1e-300)))
        log(f"nrank: {label} uniform: build_plan(use_kernel=True) vs "
            f"build_plan_fast: choice entries differing={ndiff} of "
            f"{topo.num_nodes ** 2}, max rel diff w_nr={rel!r}, "
            f"iterations {plan.nrank.iterations}/{fast.nrank.iterations}, "
            f"plan_ms={plan_ms:.1f} (N-Rank {plan_ms - bidor_ms:.1f}, "
            f"BiDOR {bidor_ms:.1f}), possibility_weights kernel "
            f"{kernel_ms[label] * 1e3:.2f}us")
        if not np.all(np.isfinite(plan.w_nr)):
            raise SystemExit(f"non-finite w_nr on {label}")
    return plans


def run_fig1(torch, np, cuda, plans):
    """benchmarks/fig1_load.py at full length, on the kernel-path plans."""
    from repro_torch.noc import Algo, CampaignSpec, SimConfig, run_campaign

    cycles = 16000
    for name, (topo, t, plan) in plans.items():
        pattern = name.split("_")[1]
        spec = CampaignSpec(
            topo=topo, algos=(Algo.XY, Algo.BIDOR),
            patterns=((pattern, t),), rates=(0.35,),
            base=SimConfig(cycles=cycles, warmup=cycles // 3))
        res = run_campaign(spec, bidor_tables={pattern: plan.table.choice},
                           device=cuda)
        _check_results(res, np)
        r_xy = res.select(algo=Algo.XY)[0].result
        r_bd = res.select(algo=Algo.BIDOR)[0].result
        mask = r_xy.node_load > 1e-9
        corr = float(np.corrcoef(plan.w_nr[mask], r_xy.node_load[mask])[0, 1])

        def lcv(load):
            a = load[load > 1e-12]
            return float(a.std() / a.mean()) if a.size else 0.0

        conserved = all(p.result.injected_flits == p.result.ejected_flits
                        + p.result.in_flight_flits for p in res.points)
        log(f"fig1: {name}: corr(w_NR, XY load)={corr:.3f} LCV XY="
            f"{lcv(r_xy.node_load):.3f} BiDOR={lcv(r_bd.node_load):.3f} "
            f"thr XY={r_xy.throughput:.4f} BiDOR={r_bd.throughput:.4f} "
            f"conserved={conserved} wall={res.total_wall_clock_s:.2f}s")
        if not np.isfinite(corr):
            raise SystemExit(f"fig1 {name}: correlation is not finite")


def run_ctrl(torch, np, cuda):
    """ctrl_4x4.json on the card, then benchmarks/dynamics.py at full
    size (edge-I/O 5x5, BiDOR and odd-even; each (scenario, algorithm)
    one run_controlled call over seeds 0-2, as a campaign scenario cell
    makes it)."""
    from repro_torch.core import build_plan_fast, mesh2d, mesh2d_edge_io
    from repro_torch.core import traffic
    from repro_torch.noc import (Algo, CampaignSpec, LinkFail, ReplanConfig,
                                 Scenario, SimConfig, TrafficDrift,
                                 run_campaign, run_controlled)

    with open(os.path.join(HERE, "tests", "goldens", "ctrl_4x4.json")) as f:
        golden = json.load(f)["points"]
    fail = (LinkFail(cycle=1200, links=((5, 6), (6, 5)), bw_scale=0.25),)
    rc = ReplanConfig(epoch=400)
    spec = CampaignSpec(
        topo=mesh2d(4, 4), algos=(Algo.BIDOR,), patterns=("uniform",),
        rates=(0.35,), seeds=(0, 1), base=SimConfig(cycles=2400, warmup=400),
        scenarios=tuple(Scenario(f"linkfail_{p}", events=fail, policy=p,
                                 replan=rc) for p in ("stale", "online")))
    res = run_campaign(spec, device=cuda)
    bad = []
    for p in res.points:
        r = p.result
        want = golden[f"{p.scenario}/{p.algo.name}/r{p.rate}/s{p.seed}"]
        ints = dict(injected=r.injected_flits, ejected=r.ejected_flits,
                    in_flight=r.in_flight_flits, reorder=r.reorder_value,
                    meas_cycles=r.meas_cycles)
        floats = dict(throughput=r.throughput, avg_latency=r.avg_latency,
                      p50_latency=r.p50_latency, p99_latency=r.p99_latency,
                      link_load_max=r.link_load_max, lcv=r.lcv)
        bad += [f"{p.scenario}/s{p.seed} {k}: {v} != {want[k]}"
                for k, v in ints.items() if v != want[k]]
        bad += [f"{p.scenario}/s{p.seed} {k}: {v} != {want[k]}"
                for k, v in floats.items()
                if not np.isclose(round(v, 6), want[k], rtol=1e-5,
                                  atol=1e-6)]
    log(f"ctrl: {len(res.points)} points vs ctrl_4x4.json: "
        f"{'ok' if not bad else 'MISMATCH'} ({res.total_wall_clock_s:.2f}s)")
    if len(res.points) != len(golden) or bad:
        raise SystemExit("ctrl golden mismatch:\n  " + "\n  ".join(bad))
    for seed in (0, 1):
        st, on = (res.select(scenario=f"linkfail_{p}", seed=seed)[0].result
                  for p in ("stale", "online"))
        if not on.link_load_max < st.link_load_max:
            raise SystemExit(f"ctrl golden: online does not beat stale "
                             f"(seed {seed})")

    # benchmarks/dynamics.py, full size (BENCH_QUICK=0)
    topo = mesh2d_edge_io(5, 5)
    t = traffic.uniform(topo)
    cycles = 12000
    epoch = cycles // 8
    w = topo.dims[0]
    mid = topo.node_id((w // 2 - 1, topo.dims[1] // 2))
    links = ((int(mid), int(mid + 1)), (int(mid + 1), int(mid)))
    events = {
        "linkfail": (LinkFail(cycle=cycles // 2, links=links,
                              bw_scale=0.25),),
        "drift": (TrafficDrift(cycle=cycles // 2,
                               traffic=traffic.transpose(topo)),)}
    rc = ReplanConfig(epoch=epoch, drift_threshold=0.15)
    cfg = SimConfig(cycles=cycles, warmup=cycles // 8)
    plan = build_plan_fast(topo, t, device=cuda)
    peaks = {}
    for scen_name, evs in events.items():
        for policy in ("oracle", "stale", "online"):
            scen = Scenario(f"{scen_name}_{policy}", events=evs,
                            policy=policy, replan=rc)
            for algo in (Algo.BIDOR, Algo.ODDEVEN):
                bidor = algo == Algo.BIDOR
                t0 = time.perf_counter()
                out = run_controlled(
                    topo, t, cfg.replace(algo=algo), scen, rates=[0.35],
                    seeds=[0, 1, 2], bidor_table=plan.table if bidor else None,
                    nrank0=plan.nrank if bidor else None, device=cuda)
                wall = time.perf_counter() - t0
                rs = [out.result_with_peak(i)
                      for i in range(len(out.points))]
                for r in rs:     # a re-plan may reorder BiDOR's flows
                    _check_result(r, np, in_order=False)
                peak = float(np.mean([r.link_load_max for r in rs]))
                peaks[scen.name, algo] = peak
                log(f"ctrl: dynamics {scen.name:16s} {algo.name:8s} "
                    f"peak_maxlinkload={peak:.4f} "
                    f"thr={np.mean([r.throughput for r in rs]):.4f} "
                    f"lat={np.mean([r.avg_latency for r in rs]):.1f} "
                    f"replans={len(out.replans)} replan_ms="
                    f"{json.dumps([round(x, 1) for x in out.replan_ms])} "
                    f"wall={wall:.2f}s")
    st, on = (peaks[f"linkfail_{p}", Algo.BIDOR] for p in ("stale", "online"))
    log(f"ctrl: dynamics SUMMARY linkfail: BiDOR peak max link load "
        f"stale={st:.4f} -> online={on:.4f} ({(1 - on / st) * 100:+.1f}%), "
        f"oracle={peaks['linkfail_oracle', Algo.BIDOR]:.4f}; odd-even "
        f"{peaks['linkfail_online', Algo.ODDEVEN]:.4f}")
    if not on < st:
        raise SystemExit("dynamics: online replanning does not beat the "
                         "stale plan under the link failure")


def _deployed(cuda, topo, algo):
    """(traffic, table) of a uniform-traffic cell as the campaign deploys
    it: BiDOR on its plan with the topology's dead channels masked and
    the pairs it cannot route shed; no table for the others."""
    import numpy as np
    from repro_torch.core import build_plans_batched, traffic
    from repro_torch.noc.simconfig import Algo

    tm = traffic.uniform(topo)
    if algo != Algo.BIDOR:
        return tm, None
    down = topo.down_channels
    table = build_plans_batched(topo, [tm], device=cuda,
                                down_channels=down if down.size else None
                                )[0].table
    if table.unroutable is not None and table.unroutable.any():
        tm = np.where(table.unroutable, 0.0, tm)
    return tm, table


def _cell(torch, cuda, topo, algo, lanes, **cfg_kw):
    """(tables, meta, cfg, points) of a uniform-traffic cell on the card
    (:func:`_deployed`); ``cfg_kw`` (the watchdog, the telemetry) on top
    of the defaults."""
    from repro_torch.noc import sim
    from repro_torch.noc.simconfig import SimConfig

    tm, table = _deployed(cuda, topo, algo)
    cfg = SimConfig(algo=algo, cycles=100_000, warmup=100, **cfg_kw)
    tables, meta = sim.build_tables(topo, tm, table, 2, device=cuda)
    points = [(0.9, 0), (0.6, 1), (0.3, 2), (1.2, 3)][:lanes]
    return tables, meta, cfg, points


def _clone(torch, state):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v.copy())
            for k, v in state.items()}


def _card_tiles(torch, cuda, meta, cfg, lanes):
    """(auto tile, every tile the card can lay out) for a cell."""
    from repro_torch.kernels.simstep.ops import card_tile, resolve_path

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = meta["N"]
    fit = []
    for d in (d for d in range(1, n + 1) if n % d == 0):
        try:
            fit.append(card_tile(n, meta["P"], meta["V"], cfg.lat_bins,
                                 lanes, d, sms=sms))
        except ValueError:
            pass
    return resolve_path(meta, cfg, lanes, cuda), fit


def _plain_chunk(tables, meta, cfg, state, cycles, cuda):
    """``run_cycles`` as the plain twin computes it, on the card's
    tensors: the chunk's draws and key chain, then ``make_cycle_fn``
    cycle by cycle."""
    from repro_torch.kernels.simstep import draw_chunk, ref

    cycle_fn = ref.make_cycle_fn(meta, cfg)
    keys, rand = draw_chunk(state["key"], cycles, meta["N"], cuda, cfg.algo,
                            meta["NDIM"])
    for c in range(cycles):
        cycle_fn(tables, state, {k: x[c] for k, x in rand.items()}, c)
    state["key"] = keys
    state["cycle0"] += cycles


def _hold_cells(torch, np, cuda, cases, worst, tag="", keep=False,
                **cfg_kw):
    """The flit-step kernels against the plain twin on ``cases`` ((topology,
    algorithms, warm-in cycles)), from plain mid-flight states, every
    state key bit for bit, the PRNG key included: chunks of 1 and 50
    cycles at two tiles (the auto one and the largest other the card lays
    out), one launch a chunk.  ``cfg_kw`` goes to every cell's config;
    ``worst`` gathers the largest difference by kernel.  With ``keep``,
    returns per (topology name, algorithm, chunk cycles) the mid-flight
    state, the card's state at the auto tile, and the cell's tables, meta
    and config."""
    from repro_torch import kernels
    from repro_torch.kernels.simstep import card_kernel
    from repro_torch.noc import sim

    out = {}
    for topo, algos, warm in cases:
        for algo in algos:
            tables, meta, cfg, points = _cell(torch, cuda, topo, algo, 4,
                                              **cfg_kw)
            kernel = card_kernel(meta["N"], meta["P"], meta["V"],
                                 cfg.lat_bins)
            mid = sim.make_states(meta, cfg, points, device=cuda)
            _plain_chunk(tables, meta, cfg, mid, warm, cuda)   # warm-in
            auto, fit = _card_tiles(torch, cuda, meta, cfg, len(points))
            for cycles in (1, 50):
                plain = _clone(torch, mid)
                _plain_chunk(tables, meta, cfg, plain, cycles, cuda)
                for tile in (auto, max(d for d in fit if d != auto)):
                    card = _clone(torch, mid)
                    before = dict(kernels.LAUNCHES)
                    sim.run_cycles(tables, meta,
                                   cfg.replace(sim_tile_nodes=tile), card,
                                   cycles)
                    torch.cuda.synchronize()
                    grew = {k: kernels.LAUNCHES[k] - before[k]
                            for k in ("simstep_chunk", "simstep_grid")}
                    want = {"simstep_chunk": int(kernel == "chunk"),
                            "simstep_grid": int(kernel == "grid")}
                    bad = [k for k in plain if not (
                        np.array_equal(plain[k], card[k]) if k == "key"
                        else torch.equal(plain[k], card[k]))]
                    diff = max(int((plain[k].double() - card[k].double())
                                   .abs().max()) for k in plain
                               if k != "key")
                    worst[kernel] = max(worst[kernel], diff)
                    verdict = (f"MISMATCH {bad}" if bad
                               else "bitwise ok, key included")
                    unit = "blocks" if kernel == "chunk" else "units"
                    log(f"kernels: simstep {kernel}{tag} {topo.name} "
                        f"{algo.name} P={meta['P']} tile={tile} "
                        f"({meta['N'] // tile} {unit} a lane) "
                        f"cycles={cycles}: {verdict}; launches "
                        f"{json.dumps(grew)}")
                    if bad:
                        raise SystemExit(
                            f"simstep {kernel} disagrees with plain on {bad}")
                    if grew != want:
                        raise SystemExit(f"simstep {kernel}: launches {grew}, "
                                         f"expected {want}")
                    if keep and tile == auto:
                        out[topo.name, algo, cycles] = (mid, card, tables,
                                                        meta, cfg)
    return out


def check_simstep(torch, np, cuda):
    """The flit-step kernels against the plain twin (:func:`_hold_cells`).
    The chunk kernel on the 5x5 edge-I/O (one block a lane), 16x16 (a
    cluster) and 32x32 meshes; the grid kernel on 17x17, 64x64 and
    96x96, which no cluster of the chunk kernel holds.  Every routing
    algorithm at 5x5, 16x16 and 17x17; XY and BiDOR at 32x32; XY alone at
    64x64 and 96x96, whose BiDOR plans no path builds (96x96 after a
    shorter warm-in).  Returns the largest difference by kernel."""
    from repro_torch.core import mesh2d, mesh2d_edge_io
    from repro_torch.noc.simconfig import Algo

    every, both, xy = tuple(Algo), (Algo.XY, Algo.BIDOR), (Algo.XY,)
    worst = {"chunk": 0, "grid": 0}
    cases = ((mesh2d_edge_io(5, 5), every, 200), (mesh2d(16, 16), every, 200),
             (mesh2d(17, 17), every, 200), (mesh2d(32, 32), both, 200),
             (mesh2d(64, 64), xy, 200), (mesh2d(96, 96), xy, 60))
    _hold_cells(torch, np, cuda, cases, worst)
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
        _check_result(p.result, np)


def _check_result(r, np, in_order=True):
    """Finite statistics and conserved flits; with ``in_order``, XY, YX
    and BiDOR (one path a flow while the plan stands) deliver in
    order."""
    from repro_torch.noc import Algo

    vals = [r.throughput, r.avg_latency, r.p99_latency, r.lcv,
            r.link_load_max]
    if not all(np.isfinite(v) for v in vals):
        raise SystemExit(f"non-finite result {r}")
    if r.injected_flits != r.ejected_flits + r.in_flight_flits:
        raise SystemExit(f"flits not conserved: {r}")
    if (in_order and r.algo in (Algo.XY, Algo.YX, Algo.BIDOR)
            and r.reorder_value != 0):
        raise SystemExit(f"out-of-order delivery: {r}")


# --------------------------------------------------------------------- #
# slice 10: the paper's other routing algorithms, trace replay
# --------------------------------------------------------------------- #
def _golden_mismatches(np, want: dict, got: dict) -> list[str]:
    """``tests/test_torch_algos.py``'s comparison: integers exact, floats
    within rtol 1e-5 (atol 1e-6), per-segment LCVs within 1e-6."""
    bad = []
    for key, w in want.items():
        g = got.get(key)
        if g is None:
            bad.append(f"{key}: missing")
            continue
        for f in ("injected", "ejected", "in_flight", "reorder",
                  "meas_cycles", "max_latency"):
            if f in w and g[f] != w[f]:
                bad.append(f"{key}.{f}: {g[f]} != {w[f]}")
        for f in ("throughput", "avg_latency", "p50_latency", "p99_latency",
                  "link_load_max", "lcv"):
            if not np.isclose(round(g[f], 6), w[f], rtol=1e-5, atol=1e-6):
                bad.append(f"{key}.{f}: {g[f]} != {w[f]}")
        if "lcvs" in w and not (
                len(g["lcvs"]) == len(w["lcvs"])
                and np.allclose(g["lcvs"], w["lcvs"], rtol=0, atol=1e-6)):
            bad.append(f"{key}.lcvs: {g['lcvs']} != {w['lcvs']}")
    return bad


def _record(r) -> dict:
    return dict(injected=r.injected_flits, ejected=r.ejected_flits,
                in_flight=r.in_flight_flits, reorder=r.reorder_value,
                meas_cycles=r.meas_cycles, throughput=r.throughput,
                avg_latency=r.avg_latency, p50_latency=r.p50_latency,
                p99_latency=r.p99_latency, link_load_max=r.link_load_max,
                lcv=r.lcv, max_latency=float(r.max_latency))


FIG9_ALGOS = ("XY", "O1TURN", "VALIANT", "ROMM", "ODDEVEN", "BIDOR")


def check_algos_golden(torch, np, cuda):
    """``tests/goldens/algos_5x5.json`` (written by the JAX reference) on
    the card: every routing algorithm through ``run_campaign`` on the
    5x5 edge-I/O mesh (uniform and overturn, rates 0.2 and 0.55, 1 500
    cycles), and a 2-epoch x 800-cycle Clos leaf trace through
    ``run_trace_sweep`` per Fig. 9 algorithm, seeds 0 and 1."""
    from repro_torch.core import build_plan, mesh2d_edge_io
    from repro_torch.noc import (Algo, CampaignSpec, SimConfig,
                                 clos_leaf_trace, run_campaign,
                                 run_trace_sweep)

    with open(os.path.join(HERE, "tests", "goldens", "algos_5x5.json")) as f:
        golden = json.load(f)["points"]
    topo = mesh2d_edge_io(5, 5)
    t0 = time.perf_counter()
    res = run_campaign(CampaignSpec(
        topo=topo, algos=tuple(Algo), patterns=("uniform", "overturn"),
        rates=(0.2, 0.55), seeds=(0,),
        base=SimConfig(cycles=1500, warmup=500)), device=cuda)
    got = {f"{p.pattern}/{p.algo.name}/r{p.rate}/s{p.seed}": _record(p.result)
           for p in res.points}
    segments, agg = clos_leaf_trace(topo, num_epochs=2, base_rate=0.3)
    plan = build_plan(topo, agg, use_kernel=True, device=cuda)
    for name in FIG9_ALGOS:
        algo = Algo[name]
        runs = run_trace_sweep(
            topo, segments, SimConfig(algo=algo, cycles=800, warmup=200,
                                      lat_bins=128, lat_bin_width=32),
            bidor_table=plan.table, seeds=[0, 1], device=cuda)
        for seed, (r, lcvs) in zip((0, 1), runs):
            got[f"trace/{name}/s{seed}"] = dict(_record(r), lcvs=lcvs)
    bad = _golden_mismatches(np, golden, got)
    extra = sorted(set(got) - set(golden))
    log(f"algos: {len(got)} points vs algos_5x5.json: "
        f"{'ok' if not bad and not extra else 'MISMATCH'} "
        f"({time.perf_counter() - t0:.2f}s)")
    if bad or extra:
        raise SystemExit("algos golden mismatch:\n  "
                         + "\n  ".join(bad + extra))


def run_fig8(torch, np, cuda):
    """benchmarks/fig8_synthetic.py at full length (BENCH_QUICK=0): the
    5x5 edge-I/O mesh, four patterns, six algorithms, nine rates, 14 000
    cycles (warmup 4 666, chunks of 3 500); each cell's saturation
    throughput and the BiDOR/XY ratio."""
    from repro_torch.core import mesh2d_edge_io
    from repro_torch.noc import Algo, CampaignSpec, SimConfig, run_campaign

    patterns = ("uniform", "shuffle", "permutation", "overturn")
    algos = tuple(Algo[a] for a in FIG9_ALGOS)
    cycles = 14000
    spec = CampaignSpec(
        topo=mesh2d_edge_io(5, 5), algos=algos, patterns=patterns,
        rates=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.85, 1.0),
        base=SimConfig(cycles=cycles, warmup=cycles // 3),
        chunk=cycles // 4)
    res = run_campaign(spec, device=cuda)
    _check_results(res, np)
    out = {}
    for pattern in patterns:
        for algo in algos:
            sat = res.saturation_throughput(algo, pattern)
            reorder = max(p.result.reorder_value
                          for p in res.select(algo=algo, pattern=pattern))
            out[pattern, algo.name] = sat
            log(f"fig8: {pattern:12s} {algo.name:8s} sat={sat:.4f} "
                f"reorder@max={reorder} wall="
                f"{res.wall_clock_s[algo.name, pattern]:.3f}s")
    for pattern in patterns:
        xy, bd = out[pattern, "XY"], out[pattern, "BIDOR"]
        log(f"fig8: SUMMARY {pattern:12s}: BiDOR/XY saturation throughput "
            f"= {bd / xy:.3f} ({(bd / xy - 1) * 100:+.1f}%)")
    log(f"fig8: {spec.num_points} points, plan_ms="
        f"{res.plan_wall_clock_s * 1e3:.1f}, total="
        f"{res.total_wall_clock_s:.2f}s")
    return out


def run_table1(torch, np, cuda):
    """benchmarks/table1_lcv.py at full length (16 000 cycles): the LCV of
    each algorithm in the three scenarios, BiDOR on ``build_plan``'s
    table."""
    from repro_torch.core import build_plan, mesh2d, mesh2d_edge_io, traffic
    from repro_torch.noc import Algo, CampaignSpec, SimConfig, run_campaign

    cycles = 16000
    algos = tuple(Algo[a] for a in FIG9_ALGOS)
    for name, topo, pattern, rate in (
            ("2DMesh+UN", mesh2d(5, 5), "uniform", 0.45),
            ("EdgeIO+UN", mesh2d_edge_io(5, 5), "uniform", 0.4),
            ("EdgeIO+OV", mesh2d_edge_io(5, 5), "overturn", 0.3)):
        t = traffic.PATTERNS[pattern](topo)
        plan = build_plan(topo, t, use_kernel=True, device=cuda)
        res = run_campaign(CampaignSpec(
            topo=topo, algos=algos, patterns=((pattern, t),), rates=(rate,),
            base=SimConfig(cycles=cycles, warmup=cycles // 3)),
            bidor_tables={pattern: plan.table.choice}, device=cuda)
        _check_results(res, np)
        row = " ".join(f"{a.name}={res.select(algo=a)[0].result.lcv:.3f}"
                       for a in algos)
        log(f"table1: {name} {row} (wall {res.total_wall_clock_s:.2f}s)")


def run_fig9(torch, np, cuda):
    """benchmarks/fig9_realistic.py at full length: a 10-epoch Clos leaf
    trace on the 5x5 edge-I/O mesh, 10 000 cycles a segment, seeds 0-2
    as lanes, BiDOR's plan built from the aggregate; per algorithm the
    mean, max and p99 latency, the LCV over epochs and the reorder value,
    and the paper's summary line."""
    from repro_torch.core import build_plan, mesh2d_edge_io
    from repro_torch.noc import Algo, SimConfig, clos_leaf_trace, \
        run_trace_sweep

    topo = mesh2d_edge_io(5, 5)
    segments, agg = clos_leaf_trace(topo, num_epochs=10, base_rate=0.3)
    plan = build_plan(topo, agg, use_kernel=True, device=cuda)
    cycles = 10000
    base = {}
    for name in FIG9_ALGOS:
        cfg = SimConfig(algo=Algo[name], cycles=cycles, warmup=cycles // 4,
                        lat_bins=128, lat_bin_width=32)
        t0 = time.perf_counter()
        runs = run_trace_sweep(topo, segments, cfg, bidor_table=plan.table,
                               seeds=[0, 1, 2], device=cuda)
        wall = time.perf_counter() - t0
        for r, lcvs in runs:
            _check_result(r, np)
            if len(lcvs) != len(segments):
                raise SystemExit(f"fig9 {name}: {len(lcvs)} segment LCVs")
        lat = float(np.mean([r.avg_latency for r, _ in runs]))
        maxlat = float(np.max([r.max_latency for r, _ in runs]))
        p99 = float(np.mean([r.p99_latency for r, _ in runs]))
        lcvs = [v for _, ls in runs for v in ls]
        reorder = max(r.reorder_value for r, _ in runs)
        base[name] = (lat, maxlat)
        log(f"fig9: {name:8s} lat={lat:7.1f} max={maxlat:6.0f} "
            f"p99={p99:7.1f} lcv={np.mean(lcvs):.3f}+-{np.std(lcvs):.3f} "
            f"reorder={reorder} (seeds=3) wall={wall:.2f}s")
    (xy_lat, xy_max), (bd_lat, bd_max) = base["XY"], base["BIDOR"]
    log(f"fig9: SUMMARY: mean latency {xy_lat:.1f} -> {bd_lat:.1f} "
        f"({(1 - bd_lat / xy_lat) * 100:.1f}% lower), max {xy_max:.0f} -> "
        f"{bd_max:.0f} ({(1 - bd_max / max(xy_max, 1)) * 100:.1f}% lower)")
    return base


# --------------------------------------------------------------------- #
# slice 11: the topology zoo, the stall watchdog, the telemetry probes
# --------------------------------------------------------------------- #
def _zoo_cases(grid: bool):
    """The zoo's shapes for the kernel checks, each with every routing
    algorithm it admits (odd-even only on 2-D): 7-port routers (the 3-D
    torus, multipod with its pod axis at half bandwidth), 9-port ones
    (the express mesh), the fault-region mesh's dead routers, the
    concentrated mesh; ``grid``: a 5- and a 9-port 17x17, whose 17
    blocks a lane no cluster holds."""
    from repro_torch.core import (cmesh, express_mesh, fault_region_mesh,
                                  multipod, torus)
    from repro_torch.noc.simconfig import Algo

    if grid:
        topos = (torus(17, 17), express_mesh(17, 17))
    else:
        topos = (torus(4, 4, 4), cmesh(4, 4, concentration=4),
                 express_mesh(8, 8), fault_region_mesh(6, 6, (2, 2, 3, 3)),
                 multipod(2, 4, 4))
    return tuple((t, tuple(a for a in Algo
                           if a != Algo.ODDEVEN or t.ndim == 2), 100)
                 for t in topos)


def check_simstep_zoo(torch, np, cuda, worst):
    """Both flit-step kernels against the plain twin on the zoo
    (:func:`_zoo_cases`): the chunk kernel on the 64-node 3-D torus,
    concentrated, express and fault-region meshes and multipod(2,4,4),
    the grid kernel on torus(17,17) and express_mesh(17,17)."""
    _hold_cells(torch, np, cuda, _zoo_cases(False) + _zoo_cases(True),
                worst)


# the instrumented instance's feature sets: the telemetry alone (a ring
# that wraps in a 50-cycle chunk), the watchdog at its defaults, and both
# with a hair-trigger watchdog, so stalls escape and runaways throttle
INSTR_FEATURES = {
    "tel": dict(telemetry=True, tel_epoch=16, tel_slots=4),
    "wd": dict(watchdog=True),
    "both": dict(watchdog=True, wd_stall_cycles=8, wd_hop_limit=12,
                 wd_throttle_cycles=16, telemetry=True, tel_epoch=16,
                 tel_slots=4)}


def check_instrumented(torch, np, cuda, worst):
    """The instrumented instance (the watchdog and the telemetry) against
    the plain twin, as :func:`_hold_cells` holds the others, on the 5x5
    edge-I/O mesh (the chunk kernel) and 17x17 (the grid kernel): every
    ``tel_*`` and ``wd_*`` key bit for bit with the rest.  Then the
    chunk again on the card with both features off: the core keys must
    equal the instrumented run's wherever the watchdog never tripped
    (the telemetry alone changes nothing), and the hair-trigger watchdog
    must trip somewhere, so its escape and throttle ran on the card."""
    from repro_torch.core import mesh2d, mesh2d_edge_io
    from repro_torch.noc import sim
    from repro_torch.noc.simconfig import Algo

    some = (Algo.XY, Algo.VALIANT, Algo.ODDEVEN, Algo.BIDOR)
    plan = ((mesh2d_edge_io(5, 5), {"both": tuple(Algo),
                                    "tel": (Algo.XY, Algo.ODDEVEN),
                                    "wd": (Algo.XY, Algo.ODDEVEN)}),
            (mesh2d(17, 17), {"both": some, "tel": (Algo.XY,),
                              "wd": (Algo.XY,)}))
    tripped = 0
    for topo, sets in plan:
        for name, algos in sets.items():
            kept = _hold_cells(torch, np, cuda, ((topo, algos, 100),), worst,
                               tag=f" [{name}]", keep=True,
                               **INSTR_FEATURES[name])
            for (tname, algo, cycles), (mid, card, tables, meta,
                                        cfg) in kept.items():
                off = {k: (v.clone() if isinstance(v, torch.Tensor)
                           else v.copy()) for k, v in mid.items()
                       if not k.startswith(("tel_", "wd_"))}
                sim.run_cycles(tables, meta,
                               cfg.replace(watchdog=False, telemetry=False),
                               off, cycles)
                same = all(np.array_equal(off[k], card[k]) if k == "key"
                           else torch.equal(off[k], card[k]) for k in off)
                trips = (card["wd_trips"].sum(0).tolist()
                         if "wd_trips" in card else [0, 0])
                tripped += sum(trips)
                tel = (int(card["tel_cycles"].sum()) if "tel_cycles" in card
                       else 0)
                log(f"kernels: simstep instrumented [{name}] {tname} "
                    f"{algo.name} cycles={cycles}: core keys "
                    f"{'equal' if same else 'differ from'} the features-off "
                    f"run; watchdog trips (deadlock, livelock) {trips}; "
                    f"telemetry cycles {tel}")
                if sum(trips) == 0 and not same:
                    raise SystemExit(f"instrumented {tname} {algo.name}: "
                                     f"the core moved with a quiet watchdog")
    if not tripped:
        raise SystemExit("instrumented: the hair-trigger watchdog never "
                         "tripped on the card")


def _cyclic_ring_table(np, topo):
    """All traffic clockwise around the 2x2 ring 0 → 1 → 3 → 2 → 0: a true
    cyclic channel dependency that wedges every VC (the reference's
    ``tests/test_watchdog.py`` fixture)."""
    from repro_torch.core.bidor import BiDORTable

    n = topo.num_nodes
    ring = [0, 1, 3, 2]
    nxt = {ring[i]: ring[(i + 1) % 4] for i in range(4)}
    neigh = np.asarray(topo.neighbor_table)
    pt = np.zeros((1, n, n), np.int8)
    for cur in range(n):
        for dst in range(n):
            pt[0, cur, dst] = (topo.port_local if cur == dst else
                               [k for k in range(neigh.shape[1])
                                if neigh[cur, k] == nxt[cur]][0])
    return BiDORTable(choice=np.zeros((n, n), np.int8), orders=((0, 1),),
                      costs=np.zeros((1, n, n), np.float32), port_tables=pt)


def _zoo_topo(spec: dict):
    from repro_torch import core

    return getattr(core, spec["fn"])(*spec["args"])


def _zoo_run(torch, np, cuda, topo, algo, sim_kw, rates, seeds, **extra):
    """``run_sweep`` of one zoo cell as :func:`_deployed` makes it."""
    from repro_torch.noc import SimConfig, run_sweep

    tm, table = _deployed(cuda, topo, algo)
    return run_sweep(topo, tm, SimConfig(algo=algo, **sim_kw), list(rates),
                     table, list(seeds), device=cuda, **extra)


def check_zoo_golden(torch, np, cuda):
    """``tests/goldens/zoo.json`` (written by the JAX reference) on the
    card: every zoo topology under every algorithm it admits, the wedged
    ring's three runs (:func:`_cyclic_ring_table`; the watchdog must
    recover the ring), and a fault-region cell with both the watchdog
    and the telemetry on, its rings and trips exact."""
    from repro_torch.core import mesh2d, traffic
    from repro_torch.noc import Algo, SimConfig, run_sim

    with open(os.path.join(HERE, "tests", "goldens", "zoo.json")) as f:
        golden = json.load(f)
    t0 = time.perf_counter()
    got, bad = {}, []
    for name, spec in golden["topologies"].items():
        topo = _zoo_topo(spec)
        if topo.name != name:
            raise SystemExit(f"zoo golden: {spec} builds {topo.name}")
        for algo in Algo:
            if algo == Algo.ODDEVEN and topo.ndim != 2:
                continue
            res = _zoo_run(torch, np, cuda, topo, algo, golden["sim"],
                           golden["rates"], golden["seeds"])
            for (r, s), out in zip([(r, s) for r in golden["rates"]
                                    for s in golden["seeds"]], res):
                got[f"{name}/{algo.name}/r{r}/s{s}"] = _record(out)
    bad += _golden_mismatches(np, golden["points"], got)
    bad += [f"{k}: not in the golden" for k in set(got) - set(
        golden["points"])]
    wedged = golden["wedged"]
    topo = mesh2d(2, 2)
    runs = {}
    for label, run in wedged["runs"].items():
        cfg = SimConfig(algo=Algo[wedged["algo"]], **wedged["sim"],
                        **run["sim"])
        r, wd = run_sim(topo, traffic.uniform(topo), cfg,
                        _cyclic_ring_table(np, topo), return_watchdog=True,
                        device=cuda)
        runs[label] = (r, wd)
        log(f"wedged: {label:8s} ejected={r.ejected_flits} "
            f"injected={r.injected_flits} in_flight={r.in_flight_flits} "
            f"watchdog={wd and wd.trace_args()}")
        bad += _golden_mismatches(np, {label: run["record"]},
                                  {label: _record(r)})
        if (wd and wd.trace_args()) != run["report"]:
            bad.append(f"wedged {label}: report {wd} != {run['report']}")
    # the recovery itself: the watchdog trips, drains more than 4x the
    # wedged baseline's ejections, and the hop limit throttles runaways
    (r0, _), (r1, w1), (_, w2) = (runs["baseline"], runs["watchdog"],
                                  runs["livelock"])
    if not (w1.deadlock_trips > 0
            and r1.ejected_flits > 4 * max(r0.ejected_flits, 1)
            and w2.livelock_trips > 0):
        raise SystemExit("wedged ring: the watchdog did not recover it")
    log(f"wedged: the watchdog drains "
        f"{r1.ejected_flits / max(r0.ejected_flits, 1):.1f}x the wedged "
        f"baseline's ejections")
    cell = golden["telemetry"]
    topo = _zoo_topo(golden["topologies"][cell["topo"]])
    res, tel, wd = _zoo_run(torch, np, cuda, topo, Algo[cell["algo"]],
                            cell["sim"], cell["rates"], cell["seeds"],
                            return_telemetry=True, return_watchdog=True)
    bad += _golden_mismatches(np, cell["records"], {
        f"r{r}/s{s}": _record(out) for (r, s), out in zip(
            [(r, s) for r in cell["rates"] for s in cell["seeds"]], res)})
    for k, want in cell["rings"].items():
        if getattr(tel, k).tolist() != want:
            bad.append(f"telemetry ring {k} differs")
    if wd.trace_args() != cell["report"]:
        bad.append(f"telemetry cell: report {wd} != {cell['report']}")
    log(f"zoo: {len(got)} points, 3 wedged runs and a telemetry cell vs "
        f"zoo.json: {'ok' if not bad else 'MISMATCH'} "
        f"({time.perf_counter() - t0:.2f}s)")
    if bad:
        raise SystemExit("zoo golden mismatch:\n  " + "\n  ".join(bad))


def run_topo_sweep(torch, np, cuda):
    """``python -m repro_torch.bench.topo_sweep`` at full length
    (``BENCH_QUICK=0``: 12 000 cycles) through ``CampaignSpec.topos``,
    with the reference's two assertions; then the QUICK sweep against the
    committed ``artifacts/bench/topo_sweep.csv``, row for row."""
    from repro_torch.bench import topo_sweep
    from repro_torch.noc import run_campaign

    for quick in (False, True):
        res = run_campaign(topo_sweep.sweep_spec(quick), device=cuda)
        _check_results(res, np)
        tag = "quick" if quick else "full"
        for key, dt in res.wall_clock_s.items():
            log(f"topo_sweep[{tag}]: cell {'/'.join(key)} wall={dt:.3f}s")
        for p in res.points:
            log(f"topo_sweep[{tag}]: {p.topo:26s} {p.pattern:8s} "
                f"{p.result.summary()}")
        for line in topo_sweep.check(res):
            log(f"topo_sweep[{tag}]: {line}")
        log(f"topo_sweep[{tag}]: {res.spec.num_points} points, plan_ms="
            f"{res.plan_wall_clock_s * 1e3:.1f} stages_ms="
            f"{json.dumps(res.plan_stage_ms)} total="
            f"{res.total_wall_clock_s:.2f}s")
        if quick:
            bad = topo_sweep.compare_csv(res)
            log(f"topo_sweep[quick]: {len(res.points)} rows vs the committed "
                f"topo_sweep.csv: {'ok' if not bad else 'MISMATCH'}")
            if bad:
                raise SystemExit("topo sweep CSV mismatch:\n  "
                                 + "\n  ".join(bad))


def run_multipod(torch, np, cuda):
    """The production mesh of the reference's multipod topology, two pods
    of 16x16 with the pod axis at half bandwidth (512 routers of 7
    ports), XY against BiDOR under uniform traffic: results, cell walls,
    and the plan's milliseconds by stage."""
    from repro_torch.core import multipod
    from repro_torch.noc import Algo, CampaignSpec, SimConfig, run_campaign

    spec = CampaignSpec(
        topo=multipod(2, 16, 16), algos=(Algo.XY, Algo.BIDOR),
        patterns=("uniform",), rates=(0.1, 0.3), seeds=(0,),
        base=SimConfig(cycles=3000, warmup=1000), chunk=1000)
    res = run_campaign(spec, device=cuda)
    _check_results(res, np)
    for p in res.points:
        log(f"multipod: {p.result.summary()} link_max="
            f"{p.result.link_load_max:.4f}")
    for key, dt in res.wall_clock_s.items():
        log(f"multipod: cell {'/'.join(key)} wall={dt:.4f}s ms_per_cycle="
            f"{dt * 1e3 / spec.base.cycles:.4f}")
    log(f"multipod: plan_ms={res.plan_wall_clock_s * 1e3:.1f} stages_ms="
        f"{json.dumps(res.plan_stage_ms)}")


def run_instrumented_cell(torch, np, cuda):
    """A 17x17 torus cell with the watchdog and the telemetry on through
    ``run_sweep`` (the grid kernel's instrumented instance): every cycle
    in one slot, the delivered count of the rings equal to the tail
    ejections' histogram, the watchdog quiet on a certified DOR table."""
    from repro_torch.core import torus, traffic
    from repro_torch.noc import Algo, SimConfig, run_sweep

    topo = torus(17, 17)
    cfg = SimConfig(algo=Algo.XY, cycles=2000, warmup=500, telemetry=True,
                    tel_slots=8, watchdog=True)
    res, tel, wd = run_sweep(topo, traffic.uniform(topo), cfg, [0.1, 0.3],
                             return_telemetry=True, return_watchdog=True,
                             device=cuda)
    for r in res:
        _check_result(r, np)
    ok = (tel.cycles.sum(1) == cfg.cycles).all() and not wd.tripped
    log(f"instrumented cell: {topo.name} XY, telemetry {tel.num_slots} slots "
        f"of {tel.epoch_len} cycles, peak link load by slot "
        f"{np.round(tel.peak_link_load()[0], 4).tolist()}, watchdog "
        f"{wd.trace_args()}: {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit("instrumented cell: rings or watchdog off")


def paper_spec():
    """The paper's 5x5 edge-I/O cells at fig8's full length."""
    from repro_torch.core import mesh2d_edge_io
    from repro_torch.noc import Algo, CampaignSpec, SimConfig

    return CampaignSpec(
        topo=mesh2d_edge_io(5, 5), algos=(Algo.XY, Algo.BIDOR),
        patterns=("uniform", "overturn"), rates=(0.2, 0.4, 0.55, 0.7),
        seeds=(0,), base=SimConfig(cycles=14000, warmup=4666), chunk=3500)


def run_paper(torch, np, cuda):
    from repro_torch.noc import run_campaign

    spec = paper_spec()
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
    return res


def scale_specs():
    """The scale cells: 32x32 uniform, XY and BiDOR (4 lanes, 3 000
    cycles), and 64x64 uniform, XY (4 lanes, 600 cycles)."""
    from repro_torch.core import mesh2d
    from repro_torch.noc import Algo, CampaignSpec, SimConfig

    big = CampaignSpec(
        topo=mesh2d(32, 32), algos=(Algo.XY, Algo.BIDOR),
        patterns=("uniform",), rates=(0.1, 0.3), seeds=(0, 1),
        base=SimConfig(cycles=3000, warmup=1000), chunk=1000)
    huge = CampaignSpec(
        topo=mesh2d(64, 64), algos=(Algo.XY,), patterns=("uniform",),
        rates=(0.1, 0.3), seeds=(0, 1),
        base=SimConfig(cycles=600, warmup=200), chunk=200)
    return big, huge


def run_scale(torch, np, cuda):
    """32x32 uniform, XY and BiDOR, on the chunk kernel's 16-block
    clusters, in two rounds: a cell's wall holds its tables (for XY the
    DOR routes, built on the host and timed here alone), states and
    results besides the cycles, and the first round also the first use
    of each shape.  Then 64x64 uniform, XY, on the grid kernel."""
    from repro_torch.core import traffic
    from repro_torch.kernels.simstep import card_kernel
    from repro_torch.kernels.simstep.ops import resolve_path
    from repro_torch.noc import run_campaign
    from repro_torch.noc import sim

    def layout(spec):
        """The kernel and tile ``FlitStep`` resolves for the cell."""
        meta = dict(N=spec.topo.num_nodes, P=spec.topo.num_ports,
                    V=spec.base.num_vcs)
        lanes = len(spec.rates) * len(spec.seeds)
        kernel = card_kernel(meta["N"], meta["P"], meta["V"],
                             spec.base.lat_bins)
        return kernel, resolve_path(meta, spec.base, lanes, cuda)

    big, huge = scale_specs()
    torch.cuda.reset_peak_memory_stats()
    for spec, rounds in ((big, 2), (huge, 1)):
        kernel, tile = layout(spec)
        t0 = time.perf_counter()
        sim.build_tables(spec.topo, traffic.uniform(spec.topo), None,
                         spec.base.num_vcs, device=cuda,
                         escape=spec.base.watchdog)
        log(f"scale: {spec.topo.name} XY cell's tables (DOR routes built "
            f"on the host) {time.perf_counter() - t0:.4f}s, inside its wall")
        for i in range(rounds):
            res = run_campaign(spec, device=cuda)
            _check_results(res, np)
            for p in res.points:
                log(f"scale: {spec.topo.name} round {i}: "
                    f"{p.result.summary()} meas={p.result.meas_cycles}")
            for key, dt in res.wall_clock_s.items():
                log(f"scale: {spec.topo.name} round {i} cell "
                    f"{'/'.join(key)} kernel={kernel} tile={tile} "
                    f"wall={dt:.4f}s ms_per_cycle="
                    f"{dt * 1e3 / spec.base.cycles:.4f}")
            log(f"scale: {spec.topo.name} round {i} plan_ms="
                f"{res.plan_wall_clock_s * 1e3:.1f} "
                f"stages_ms={json.dumps(res.plan_stage_ms)}")
    log(f"scale: max_memory_allocated={torch.cuda.max_memory_allocated()}")


def simstep_bytes(np, meta, cfg, before, after, lanes):
    """Bytes a chunk must move, counted on the chunk run here from the
    state before and after it: the per-input, per-node and per-lane state
    the kernel keeps on chip read once and written once, the shared
    tables it reads once, and per event what the chunk's data needs: a
    flit written once where it enters a FIFO (injection or push) and read
    once where it leaves (pop), a packet's queue record written and read
    once and its flow's sequence number read and written, a tail
    ejection's reorder words read and written."""
    from repro_torch.noc.simconfig import NF, NQ

    n, p, v, c = meta["N"], meta["P"], meta["V"], meta["C"]
    nin = meta["NIN"]

    def delta(k):
        return int(after[k].astype(np.int64).sum()
                   - before[k].astype(np.int64).sum())

    injected, ejects = delta("injected"), delta("eject_total")
    pushes, packets = delta("chan_seen"), delta("next_seq")
    # one tail ejection either advances its flow's expected sequence
    # number or sets a bit of its reorder window
    def popc(x):
        return int(np.unpackbits(np.ascontiguousarray(x).view(np.uint8)).sum())

    delivered = delta("exp_seq") + popc(after["rbits"]) - popc(before["rbits"])
    hot = lanes * (5 * nin + n * p + 5 * n + 2 * c + cfg.lat_bins + 16)
    words = (2 * hot + 3 * n * p + c + n
             + NF * (injected + pushes) + NF * (pushes + ejects)
             + 2 * NQ * packets + 2 * packets + 4 * delivered)
    return 4 * words


def cycle_wall_us(torch, cuda, topo, chunk=1000, **cfg_kw):
    """µs per simulated cycle of one ``chunk``-cycle ``run_cycles`` call
    as the campaigns make it (XY, 4 lanes, after a 300-cycle warm-in;
    host clock around a synchronised call); ``cfg_kw`` as :func:`_cell`
    takes it."""
    from repro_torch.noc import sim
    from repro_torch.noc.simconfig import Algo

    tables, meta, cfg, points = _cell(torch, cuda, topo, Algo.XY, 4,
                                      **cfg_kw)
    st = sim.make_states(meta, cfg, points, device=cuda)
    sim.run_cycles(tables, meta, cfg, st, 300)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run_cycles(tables, meta, cfg, st, chunk)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / chunk


def time_simstep(torch, np, cuda, topo, label, row=False, algo=None,
                 **cfg_kw):
    """The card kernel a cell's shape takes (``simstep_chunk`` or
    ``simstep_grid``) at its shapes (``algo``, XY by default, 4 lanes, in
    its measurement window): event-timed µs per simulated cycle of a
    1 000-cycle chunk, the empty-body floor of the same launch, the byte
    bound, and (XY) the cycle wall through ``run_cycles``; ``cfg_kw``
    (the watchdog, the telemetry) as :func:`_cell` takes it.  With
    ``row``, also a 100-cycle chunk beside the plain twin: the
    kernel-summary row."""
    from repro_torch.kernels.simstep import make_step
    from repro_torch.noc import sim
    from repro_torch.noc.simconfig import Algo

    algo = Algo.XY if algo is None else algo
    tables, meta, cfg, points = _cell(torch, cuda, topo, algo, 4, **cfg_kw)
    lanes = len(points)
    st = sim.make_states(meta, cfg, points, device=cuda)
    sim.run_cycles(tables, meta, cfg, st, 300)      # into measurement
    step = make_step(meta, cfg, tables, st)
    name = f"simstep_{step.kernel}"
    layout = (f"tile={step.tile_nodes}, {step.ntiles} blocks a lane"
              if step.kernel == "chunk" else
              f"tile={step.tile_nodes}, {step.grid} blocks, {step.rounds} "
              f"rounds")
    chunk = 1000
    step.key.copy_(torch.from_numpy(st["key"].view(np.int32)))

    def launch(cycles):
        def fn(_):
            step.args.num_cycles = cycles
            step.launcher.launch(step.args)
            st["cycle0"] += cycles          # as run_cycles does
        return fn

    def floor(cycles):
        return lambda _: step.floor(cycles)

    before = sim.state_to_host(st)
    kern_ms, floor_ms = time_launches(torch, [launch(chunk), floor(chunk)],
                                      1)
    after = sim.state_to_host(st)
    nbytes = simstep_bytes(np, meta, cfg, before, after, lanes)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    reps = 3
    kern_ms = time_launches(torch, [launch(chunk)], reps)[0]
    floor_ms = time_launches(torch, [floor(chunk)], reps)[0]
    st["key"] = step.key.cpu().numpy().view(np.uint32).copy()
    wall_us = (cycle_wall_us(torch, cuda, topo, chunk, **cfg_kw)
               if algo == Algo.XY else float("nan"))
    us = lambda ms: ms * 1e3 / chunk            # noqa: E731
    events = {k: int(after[k].astype(np.int64).sum()
                     - before[k].astype(np.int64).sum())
              for k in ("injected", "chan_seen", "eject_total")}
    log(f"timing {label} {algo.name}: {name} {us(kern_ms):.3f}us per "
        f"simulated cycle (1000-cycle chunk, {layout}, lanes={lanes}); "
        f"empty-body floor {us(floor_ms):.3f}us; byte bound "
        f"{us(bound_ms):.4f}us ({nbytes} bytes a chunk); events a chunk "
        f"{json.dumps(events)}; cycle wall through run_cycles "
        f"{wall_us:.3f}us")
    out = dict(label=label, us=us(kern_ms), floor_us=us(floor_ms),
               bound_us=us(bound_ms), wall_us=wall_us,
               tile=step.tile_nodes)
    if not row:
        return out, None
    short = 100
    before = sim.state_to_host(st)
    step.key.copy_(torch.from_numpy(st["key"].view(np.int32)))
    ms = time_launches(torch, [launch(short)], 1)[0]
    after = sim.state_to_host(st)
    short_bound = (simstep_bytes(np, meta, cfg, before, after, lanes)
                   / HBM_BYTES_PER_S * 1e3)
    plain = _clone(torch, st)
    plain["key"] = after["key"]
    plain_ms = time_wall(torch, lambda: _plain_chunk(
        tables, meta, cfg, plain, short, cuda), 1)
    log(f"timing {label}: {name} {ms:.4f}ms a 100-cycle chunk "
        f"(bound {short_bound:.5f}ms, bytes); plain twin {plain_ms:.1f}ms")
    return out, dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/simstep.cu",
        replaces="src/repro/kernels/simstep/kernel.py:50,121",
        ms=ms, plain_ms=plain_ms, bound_ms=short_bound, bound_by="bytes",
        library_ms=None)


# --------------------------------------------------------------------- #
# slice 3: flash attention and whisper-base serving
# --------------------------------------------------------------------- #
WHISPER_B, SERVE_PROMPT, SERVE_NEW = 4, 16, 24
SERVE_MAX_LEN = SERVE_PROMPT + SERVE_NEW + 8
# (label, B, Sq, Skv, H, KV, D, causal, cache index or None[, Dv if not D])
FLASH_SHAPES = (
    ("encoder", 4, 1500, 1500, 8, 8, 64, False, None),
    ("cross prefill", 4, 16, 1500, 8, 8, 64, False, None),
    ("cross decode", 4, 1, 1500, 8, 8, 64, False, None),
    ("self prefill", 4, 16, SERVE_MAX_LEN, 8, 8, 64, False, 0),
    ("self decode", 4, 1, SERVE_MAX_LEN, 8, 8, 64, False,
     SERVE_PROMPT + SERVE_NEW - 2),
    ("gqa causal (internlm2)", 1, 2048, 2048, 16, 8, 128, True, None),
    ("d80 causal (stablelm)", 1, 1024, 1024, 32, 32, 80, True, None),
    # slice 4's attention layer against its 2 080-row cache (GQA 64/8)
    ("jamba prefill", 4, 2048, 2080, 64, 8, 128, False, 0),
    ("jamba decode", 4, 1, 2080, 64, 8, 128, False, 2070),
    # slice 13's served shapes: internlm2 (GQA 16/8, D 128) at the
    # example's batch and at 2 048-token prompts, stablelm (MHA 32, D 80)
    # and codeqwen (MHA 32, D 128), each against its whole cache
    ("internlm2 prefill", 4, 16, SERVE_MAX_LEN, 16, 8, 128, False, 0),
    ("internlm2 decode", 4, 1, SERVE_MAX_LEN, 16, 8, 128, False,
     SERVE_PROMPT + SERVE_NEW - 2),
    ("internlm2 long prefill", 4, 2048, 2080, 16, 8, 128, False, 0),
    ("internlm2 long decode", 4, 1, 2080, 16, 8, 128, False, 2070),
    ("stablelm prefill", 4, 16, SERVE_MAX_LEN, 32, 32, 80, False, 0),
    ("stablelm decode", 4, 1, SERVE_MAX_LEN, 32, 32, 80, False,
     SERVE_PROMPT + SERVE_NEW - 2),
    ("codeqwen prefill", 4, 16, SERVE_MAX_LEN, 32, 32, 128, False, 0),
    ("codeqwen decode", 4, 1, SERVE_MAX_LEN, 32, 32, 128, False,
     SERVE_PROMPT + SERVE_NEW - 2),
    # slice 14's: qwen2-moe (MHA 16, D 128) and dbrx (GQA 48/8: 96 packed
    # rows at a 16-token prompt, so the tensor-core kernel) at the
    # example's batch; minicpm3's MLA (MHA 40, Dk 96, Dv 64) at it and at
    # 2 048-token prompts, and one request's long decode step, whose
    # 40 blocks leave room for three key ranges and the combine
    ("qwen2-moe decode", 4, 1, SERVE_MAX_LEN, 16, 16, 128, False,
     SERVE_PROMPT + SERVE_NEW - 2),
    ("dbrx prefill", 4, 16, SERVE_MAX_LEN, 48, 8, 128, False, 0),
    ("dbrx decode", 4, 1, SERVE_MAX_LEN, 48, 8, 128, False,
     SERVE_PROMPT + SERVE_NEW - 2),
    ("minicpm3 prefill", 4, 16, SERVE_MAX_LEN, 40, 40, 96, False, 0, 64),
    ("minicpm3 decode", 4, 1, SERVE_MAX_LEN, 40, 40, 96, False,
     SERVE_PROMPT + SERVE_NEW - 2, 64),
    ("minicpm3 long prefill", 4, 2048, 2080, 40, 40, 96, False, 0, 64),
    ("minicpm3 long decode", 4, 1, 2080, 40, 40, 96, False, 2070, 64),
    ("minicpm3 long decode B=1", 1, 1, 2080, 40, 40, 96, False, 2070, 64),
    # slice 15's: qwen2-vl (GQA 12/2, D 128) at the example's batch (16
    # prompt tokens pack 96 rows: the tensor-core kernel) and the
    # image-style prompt's 72 positions against an 88-row cache; then
    # (Dk, Dv) pairs no kernel is built for, padded to the covering
    # pair's kernels: minicpm3's smoke (24, 16), (40, 40) and (72, 72),
    # each on the split path and on the prefill paths
    ("qwen2-vl prefill", 4, 16, SERVE_MAX_LEN, 12, 2, 128, False, 0),
    ("qwen2-vl decode", 4, 1, SERVE_MAX_LEN, 12, 2, 128, False,
     SERVE_PROMPT + SERVE_NEW - 2),
    ("qwen2-vl image prefill", 4, 72, 88, 12, 2, 128, False, 0),
    ("qwen2-vl image decode", 4, 1, 88, 12, 2, 128, False, 79),
    ("padded (24, 16) decode", 4, 1, SERVE_MAX_LEN, 8, 8, 24, False,
     SERVE_PROMPT + SERVE_NEW - 2, 16),
    ("padded (24, 16) causal", 2, 256, 256, 8, 8, 24, True,
     None, 16),
    ("padded (40, 40) decode", 4, 1, SERVE_MAX_LEN, 8, 8, 40, False,
     SERVE_PROMPT + SERVE_NEW - 2),
    ("padded (40, 40) causal", 2, 256, 256, 8, 8, 40, True,
     None),
    ("padded (72, 72) decode", 4, 1, SERVE_MAX_LEN, 8, 8, 72, False,
     SERVE_PROMPT + SERVE_NEW - 2),
    ("padded (72, 72) causal", 2, 256, 256, 8, 8, 72, True,
     None),
)


def _dv(shape) -> int:
    """V's head dim of a FLASH_SHAPES row."""
    return shape[9] if len(shape) > 9 else shape[6]
# fp32 at the reference's 2e-5; bf16 at one bf16 unit (2**-7), about four
# times the worst error measured at these shapes, tighter than the
# reference's 2e-2, which is half a typical output at Skv 1 500
FLASH_TOL = {"float32": 2e-5, "bfloat16": 8e-3}


def _flash_case(torch, cuda, shape, dtype, seed):
    _, b, sq, skv, h, kv, d, causal, index = shape[:9]
    dv = _dv(shape)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, dv)))
    ml = None
    if index is not None:       # a cached step: query t sees index + t + 1
        ml = (torch.arange(sq, dtype=torch.int32, device=cuda)
              + index + 1)[None].expand(b, sq)
    return q, k, v, ml


def _flash_bound(shape, itemsize, flops_per_s):
    """Least time for the function on this run's data: each needed input
    byte read once and the output written once (keys past every row's
    limit are not needed), and 2·(D + Dv) FLOP per (query, key) pair
    that counts (Q·K and P·V), at the card's peak for the type."""
    _, b, sq, skv, h, kv, d, causal, index = shape[:9]
    dv = _dv(shape)
    limits = [min(skv, (index + t + 1) if index is not None else skv,
                  (t + skv - sq + 1) if causal else skv) for t in range(sq)]
    pairs = b * h * sum(limits)
    keys = max(limits)
    nbytes = itemsize * (b * sq * h * (d + dv) + b * keys * kv * (d + dv))
    if index is not None:
        nbytes += 4 * b * sq
    flops = 2 * (d + dv) * pairs
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / flops_per_s * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by, flops, nbytes


def _sdpa(torch, q, k, v, ml, causal):
    """One library call for the same function, on (B, H, S, D) copies."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = None
    if ml is not None:
        keys = torch.arange(k.shape[1], device=q.device)
        mask = (keys[None, None] < ml[..., None])[:, None]
    gqa = q.shape[2] != k.shape[2]
    # q·k is scaled by Dk^-0.5 on both sides, whatever V's head dim
    return lambda r: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal, enable_gqa=gqa)


def check_flash(torch, np, cuda):
    """flash_attention against its plain twin at every listed shape, bf16
    and fp32, at the reference's tolerances; event-timed in bf16 (and the
    encoder in fp32) beside the twin, scaled_dot_product_attention and the
    bound.  Returns the kernel row (timings at the encoder shape, bf16)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import (
        HEAD_DIMS, Path, choose_path, pad_head_dims, padded_dims)

    worst = 0.0
    row = None
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for shape in FLASH_SHAPES:
        label, causal = shape[0], shape[7]
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            _, b, sq, skv, h, kv, d = shape[:7]
            path = choose_path(dt, b, sq, h, kv, skv, sms=sms)
            route = (f"{path.kind} x{path.splits}" if path.kind == "split"
                     else path.kind)
            q, k, v, ml = _flash_case(torch, cuda, shape, dt, seed=len(label))
            got = flash_attention(q, k, v, causal=causal, mask_len=ml)
            want = flash_attention_ref(q, k, v, causal=causal,
                                       bias_mask_len=ml)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = FLASH_TOL[dtype]
            ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                     atol=tol))
            worst = max(worst, err)
            pair = padded_dims(d, _dv(shape))
            dims = ((f"D={d}" if _dv(shape) == d
                     else f"Dk={d} Dv={_dv(shape)}")
                    + (f" padded to {pair}" if pair != (d, _dv(shape))
                       else ""))
            log(f"flash: {label} {dtype} B={shape[1]} Sq={shape[2]} "
                f"Skv={shape[3]} H={shape[4]} KV={shape[5]} {dims} "
                f"causal={causal} mask={'2d' if ml is not None else 'none'} "
                f"path {route}: max_abs_err={err!r} tol {tol} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"flash_attention disagrees with plain at "
                                 f"{label} {dtype}")
            # fp32 is timed at the encoder, at MLA's head dims and
            # wherever it takes the split path, beside the CUDA-core
            # kernel that would take it else
            if (dtype == "float32" and label != "encoder"
                    and path.kind != "split" and (d, _dv(shape)) in HEAD_DIMS
                    and _dv(shape) == d):
                continue
            # 40 rounds of three calls stay inside the card's launch queue,
            # so the host is ahead of the device and the events time the
            # device (at 200 rounds the small shapes timed the host's
            # enqueue); the profiler's device time of the op's kernels
            # stands beside it
            reps = 20 if shape[2] * shape[3] > 1e6 else 40
            # the CUDA-core kernel that took every shape before the split
            # and tensor-core paths, timed beside them in the same call
            simt = Path("simt", 1, 0)
            qp, kp, vp = pad_head_dims(q, k, v, pair)
            fns = [lambda r: flash_attention(q, k, v, causal=causal,
                                             mask_len=ml),
                   _sdpa(torch, q, k, v, ml, causal),
                   lambda r: flash_attention_cuda(qp, kp, vp, causal, ml,
                                                  shape[6] ** -0.5, simt)]
            for fn in fns:      # first calls: the library picks and plans
                fn(0)           # its backend on the host
            ms, lib_ms, simt_ms = time_launches(torch, fns, reps)
            enq_ms = time_enqueue(torch, fns[0], reps)
            prof = _profile(torch, lambda: [fns[0](0) for _ in range(10)])
            dev = "not measured" if prof is None else ", ".join(
                f"{name.split('<')[0].split('::')[-1]} "
                f"{kernel_ms * 100:.2f}us x{count // 10}"
                for name, (count, kernel_ms) in sorted(prof.items())
                if "flash_fwd" in name)
            plain_ms = time_wall(torch, lambda: flash_attention_ref(
                q, k, v, causal=causal, bias_mask_len=ml), 3)
            peak = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
            bound, by, flops, nbytes = _flash_bound(shape, q.element_size(),
                                                    peak)
            log(f"flash: {label} {dtype} path {route}: {ms * 1e3:.2f}us per "
                f"launch (device time by kernel, profiler: {dev}; host "
                f"{enq_ms * 1e3:.2f}us to enqueue a call), "
                f"bound {bound * 1e3:.2f}us ({by}: {flops:.3e} FLOP, "
                f"{nbytes} bytes), {bound / ms:.3f} of it; plain "
                f"{plain_ms:.3f}ms; scaled_dot_product_attention "
                f"{lib_ms * 1e3:.2f}us; the CUDA-core kernel "
                f"{simt_ms * 1e3:.2f}us")
            if label == "encoder" and dtype == "bfloat16":
                row = dict(name="flash_attention", route="cuda",
                           source="src/repro_torch/kernels/csrc/"
                                  "flash_attention_tc.cu",
                           replaces="src/repro/kernels/flash_attention/"
                                    "kernel.py:77",
                           ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by, library_ms=lib_ms)
    row["max_abs_err"] = worst
    return row


def _whisper_tree(np):
    """whisper-base's parameter tree at full width, float32, drawn from
    numpy seed 0 at the serve golden's scales: with the registry's init
    the tied embedding dominates and greedy decoding repeats one token,
    so neither token agreement nor the logits would test attention."""
    from repro_torch.configs import get_arch
    from repro_torch.serve import golden

    return golden.numpy_params(get_arch("whisper-base").full,
                               np.random.default_rng(0))


def _whisper(torch, np, cuda, dtype, tree):
    """whisper-base at full width in ``dtype``: the weights of ``tree``,
    stub-frontend frames (seed 1), prompts (numpy seed 0)."""
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.serve import ServeEngine

    cfg = get_arch("whisper-base").full.replace(dtype=dtype)
    model = convert.encdec_params_from_numpy(tree, cfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    frames = torch.randn((WHISPER_B, cfg.enc_seq, cfg.d_model),
                         generator=gen, device=cuda).to(cfg.torch_dtype)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (WHISPER_B, SERVE_PROMPT)).astype(np.int32)
    return cfg, ServeEngine(cfg, model, SERVE_MAX_LEN), frames, prompts


def _serve(torch, engine, frames, prompts):
    """encode + generate, host-timed around synchronised work."""
    from repro_torch.models import encdec

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encdec.encode(engine.cfg, engine.params, frames)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, logits = engine.generate(prompts, SERVE_NEW, enc_out=enc,
                                       return_logits=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return enc, toks, logits, (t1 - t0) * 1e3, (t2 - t1) * 1e3


@contextlib.contextmanager
def plain_twins():
    """Within this scope the model's attention and selective-scan calls
    run their plain twins, on the card too: the whole-model reference for
    the kernels."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.mamba_scan import selective_scan_ref
    from repro_torch.models.layers import attention, recurrent

    def twin(q, k, v, *, causal, mask_len=None, **chunks):
        return flash_attention_ref(q, k, v, causal=causal,
                                   bias_mask_len=mask_len, **chunks)

    real = attention.flash_ops, recurrent.scan_ops
    attention.flash_ops = SimpleNamespace(flash_attention=twin)
    recurrent.scan_ops = SimpleNamespace(selective_scan=selective_scan_ref)
    try:
        yield
    finally:
        attention.flash_ops, recurrent.scan_ops = real


def _check_logits(np, label, got, want, rtol, atol, scaled):
    """Every step's logits; ``scaled`` holds each step to ``atol`` times
    that step's largest logit."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        if not np.all(np.isfinite(g)):
            raise SystemExit(f"serve {label}: non-finite logits at step {i}")
        d = np.abs(g - w)
        worst = max(worst, float(d.max()))
        lim = (atol * np.abs(w).max() if scaled
               else atol + rtol * np.abs(w))
        if (d > lim).any():
            raise SystemExit(f"serve {label}: step {i} logits differ by "
                             f"{d.max()!r} (limit {np.max(lim)!r})")
    return worst


def run_serve_main(torch, np, cuda, out):
    """Slice 3's main path: whisper-base bf16, encode then generate; one
    kernel launch per attention call (the encoder's layers, then each
    decoder layer's self- and cross-attention per generated token)."""
    from repro_torch import kernels

    tree = _whisper_tree(np)
    cfg, engine, frames, prompts = _whisper(torch, np, cuda, "bfloat16",
                                            tree)
    before = kernels.LAUNCHES["flash_attention"]
    enc, toks, logits, enc_ms, gen_ms = _serve(torch, engine, frames,
                                              prompts)
    calls = cfg.enc_layers + 2 * cfg.n_layers * SERVE_NEW
    if kernels.LAUNCHES["flash_attention"] - before != calls:
        raise SystemExit(f"serve: {kernels.LAUNCHES['flash_attention']} "
                         f"flash_attention launches, expected {calls}")
    if toks.shape != (WHISPER_B, SERVE_NEW) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise SystemExit(f"serve: bad tokens {toks}")
    distinct = min(len(set(row)) for row in toks.tolist())
    if distinct < 2:
        raise SystemExit(f"serve: a request repeats one token, so the "
                         f"checks below would prove little: {toks}")
    log(f"serve: whisper-base bf16 B={WHISPER_B} prompt={SERVE_PROMPT} "
        f"new={SERVE_NEW} (first run) encode {enc_ms:.1f}ms generate "
        f"{gen_ms:.1f}ms; fewest distinct tokens in a request {distinct}; "
        f"tokens[0]={toks[0].tolist()}")
    out.update(cfg=cfg, engine=engine, frames=frames, prompts=prompts,
               enc=enc, toks=toks, logits=logits, tree=tree)


def run_serve_checks(torch, np, cuda, main):
    """Off the counted path: the plain twin on the same card inputs, the
    fp32 run, the smoke golden, and the warm timings."""
    from repro_torch import convert
    from repro_torch.models import encdec
    from repro_torch.models.layers.attention import cross_kv
    from repro_torch.serve import ServeEngine, golden, make_prefill

    engine, frames, prompts = main["engine"], main["frames"], main["prompts"]
    toks = main["toks"]
    with plain_twins():
        p_enc, p_toks, _, _, _ = _serve(torch, engine, frames, prompts)
        p_logits = engine.teacher_forced_logits(prompts, toks,
                                                enc_out=p_enc)
    enc_err = float((main["enc"].float() - p_enc.float()).abs().max())
    err = _check_logits(np, "bf16 kernel vs plain", main["logits"],
                        p_logits, 0.0, 2e-2, scaled=True)
    agree = float((toks == p_toks).mean())
    log(f"serve: bf16 kernel vs plain twin on the card: encoder max_abs_err="
        f"{enc_err!r}, logits of every step max_abs_err={err!r} (limit 2e-2 "
        f"x the step's largest logit), greedy token agreement {agree:.3f}")

    _, e32, f32, p32 = _whisper(torch, np, cuda, "float32", main["tree"])
    _, t32, l32, _, _ = _serve(torch, e32, f32, p32)
    with plain_twins():
        _, pt32, pl32, _, _ = _serve(torch, e32, f32, p32)
    err32 = _check_logits(np, "fp32 kernel vs plain", l32, pl32, 1e-4,
                          1e-4, scaled=False)
    log(f"serve: fp32 kernel vs plain twin: tokens identical="
        f"{bool((t32 == pt32).all())}, logits of every step max_abs_err="
        f"{err32!r} (rtol/atol 1e-4)")
    if not (t32 == pt32).all():
        raise SystemExit("serve fp32: kernel tokens differ from the plain "
                         "twin's")
    del e32, f32

    with open(os.path.join(HERE, "tests", "goldens",
                           golden.GOLDEN_NAME)) as f:
        want = json.load(f)
    gcfg = golden.config()
    tree, gframes, gprompts = golden.numpy_case(gcfg)
    gmodel = convert.encdec_params_from_numpy(tree, gcfg, cuda)
    with torch.inference_mode():
        genc = encdec.encode(gcfg, gmodel, torch.as_tensor(gframes,
                                                           device=cuda))
    gtoks, glogits = ServeEngine(
        gcfg, gmodel, golden.PROMPT_LEN + golden.NEW_TOKENS
        + golden.CACHE_SLACK).generate(gprompts, golden.NEW_TOKENS,
                                       enc_out=genc, return_logits=True)
    bad = golden.mismatches(want, glogits[0].cpu(),
                            [x.cpu() for x in glogits[1:]], gtoks, 1e-5)
    log(f"serve: {golden.GOLDEN_NAME} on the card (fp32, kernel path): "
        f"{'ok' if not bad else 'MISMATCH'}")
    if bad:
        raise SystemExit("serve golden mismatch:\n  " + "\n  ".join(bad))

    # warm timings: encode, generate, the prefill alone, cross_kv alone
    reps = 3
    runs = [_serve(torch, engine, frames, prompts) for _ in range(reps)]
    enc_ms = min(r[3] for r in runs)
    gen_ms = min(r[4] for r in runs)
    prefill = make_prefill(engine.cfg)
    cfg = engine.cfg

    def prefill_once():
        cache = encdec.init_cache(cfg, WHISPER_B, SERVE_MAX_LEN, device=cuda)
        prefill(engine.params, torch.as_tensor(prompts, device=cuda), cache,
                enc_out=main["enc"])

    with torch.inference_mode():
        pre_ms = time_wall(torch, prefill_once, reps)
        xkv_ms = time_launches(torch, [lambda r: [
            cross_kv(cfg, p.xattn, main["enc"])
            for p in engine.params.dec_blocks]], 20)[0]
    step_ms = (gen_ms - pre_ms) / (SERVE_NEW - 1)
    # where a generate call's time goes on the device (torch.profiler)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            engine.generate(prompts, SERVE_NEW, enc_out=main["enc"])
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    e2e = {}
    if dev_ms > 0:
        e2e = {"busy": dev_ms, "flash": sum(
            e.self_device_time_total for e in kern
            if "flash_fwd" in e.key) / 1e3}
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
        log(f"serve: profiled generate: {sum(e.count for e in kern)} kernels"
            f", device busy {dev_ms:.2f}ms = {dev_ms / gen_ms:.3f} of the "
            f"unprofiled {gen_ms:.2f}ms wall; top: " + "; ".join(
                f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.2f}"
                f"ms" for e in top))
    else:
        log("serve: profiled generate: no device time in the trace (device "
            "busy share not measured)")
    log(f"serve: warm (best of {reps}): encode {enc_ms:.2f}ms, generate "
        f"{gen_ms:.2f}ms = prefill {pre_ms:.2f}ms + {SERVE_NEW - 1} decode "
        f"steps at {step_ms:.3f}ms; {WHISPER_B * SERVE_NEW / gen_ms * 1e3:.1f}"
        f" new tokens/s ({WHISPER_B * SERVE_NEW / (enc_ms + gen_ms) * 1e3:.1f}"
        f" with the encoder); cross_kv of the {cfg.n_layers} layers "
        f"{xkv_ms:.3f}ms device time, {xkv_ms / step_ms:.3f} of a decode step")
    return e2e


# --------------------------------------------------------------------- #
# slice 4: the selective scan and Jamba hybrid serving
# --------------------------------------------------------------------- #
# Jamba-1.5-Large at its published widths, cut to one of its nine
# super-blocks (1 attention + 7 Mamba layers) and without experts: the 4
# MoE FFNs of a super-block alone are 77 GB in bf16
JAMBA = "jamba-1.5-large-398b"
JAMBA_CUT = {"n_layers": 8, "moe_experts": 0, "moe_topk": 0}
JAMBA_B, JAMBA_PROMPT, JAMBA_NEW = 4, 2048, 24
JAMBA_MAX_LEN = JAMBA_PROMPT + JAMBA_NEW + 8
# H100 SXM rates per second at 1.98 GHz, 132 SMs: special-function-unit
# results (expf's MUFU.EX2, 16 a clock an SM); float32 instructions
# outside the tensor cores, one a lane (128 lanes a clock an SM: the scan
# is built with --fmad=false, so a product and a sum are two); and warp
# instructions of any kind, one a scheduler a clock (4 an SM)
SFU_OPS_PER_S = 132 * 16 * 1.98e9
F32_OPS_PER_S = 132 * 128 * 1.98e9
WARP_ISSUE_PER_S = 132 * 4 * 1.98e9
# (label, B, S, Di, Ds, with h0): the prefill and decode shapes of the
# served model, and ragged ones (Di not a block multiple, S not a chunk
# multiple, states that do not fill their lanes)
SCAN_SHAPES = (
    ("prefill", 4, 2048, 16384, 16, False),
    ("prefill, h0", 4, 2048, 16384, 16, True),
    ("decode", 4, 1, 16384, 16, True),
    ("ragged", 2, 33, 100, 4, True),
    ("ragged, Ds 13", 2, 37, 70, 13, True),
)
# kernel and twin round every state's update alike (--fmad=false), so
# h_last is bit for bit; y's sum over the state runs in another order:
# |err| <= 1e-5 x max |twin|
SCAN_TOL = 1e-5


def _scan_case(torch, cuda, shape, seed):
    """delta = 0.1·softplus(N), A = −exp(0.2·N), B, C, x, h0 ~ N (the
    reference kernel test's draws), on the card."""
    import torch.nn.functional as F

    _, b, s, di, ds, with_h0 = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def n(*size):
        return torch.randn(size, generator=gen, device=cuda)

    delta = 0.1 * F.softplus(n(b, s, di))
    a = -torch.exp(0.2 * n(di, ds))
    bm, cm, x = n(b, s, ds), n(b, s, ds), n(b, s, di)
    return delta, a, bm, cm, x, (n(b, di, ds) if with_h0 else None)


def _scan_sass():
    """From the machine code of the scan's library (``cuobjdump -sass``):
    the instructions of one precise expf by opcode, its probe kernel that
    computes ``expf`` less the one that copies, without the moves that put
    its constants in registers (``MOV``, ``HFMA2.MMA``), which a loop
    makes once; and the instructions a state of the kernel's step loop
    at Ds 16 (the backward branch around its ``MUFU.EX2``s, one a
    state)."""
    import re
    from collections import Counter

    code = _sass("selective_scan")
    ops = {name: Counter(op for _, op, _ in fn
                         if op not in ("NOP", "MOV", "HFMA2.MMA"))
           for name, fn in code.items()}
    expf = ops["scan_probe_expf"] - ops["scan_probe_copy"]
    loop = next(c for n, c in code.items()
                if "selective_scan_stagedILi16E" in n)
    per_state = None
    for at, op, rest in loop:
        back = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if back and int(back.group(1), 16) < at:
            body = [o for a, o, _ in loop if int(back.group(1), 16) <= a <= at]
            if "MUFU.EX2" in body:
                per_state = len(body) / body.count("MUFU.EX2")
                break
    return expf, per_state


def _scan_bound(shape, expf):
    """Least time on this run's inputs, the largest of four terms:
    delta, x, A, B, C and h0 read once, y and h_last written once, over
    HBM's rate; one exp a state (b, t, channel, n) on the special-function
    units; float32 instructions, one a lane a clock: 5 a state (Δ·A, the
    update's two products and their sum, unfused as the twin rounds them;
    y's term, one fused multiply-add) and expf's own (``expf`` from
    ``_scan_sass``), and Δ·x once a channel and step; and all of these,
    expf's integer ones and its MUFU included, as warp instructions at one
    a scheduler a clock."""
    _, b, s, di, ds, with_h0 = shape
    nbytes = 4 * (3 * b * s * di + di * ds + 2 * b * s * ds
                  + (2 if with_h0 else 1) * b * di * ds)
    exps = b * s * di * ds
    dx = b * s * di
    f32_per_exp = sum(n for op, n in expf.items()
                      if op.split(".")[0] in ("FFMA", "FADD", "FMUL",
                                              "FSETP", "FSEL", "FMNMX"))
    all_per_exp = sum(expf.values())
    f32 = (5 + f32_per_exp) * exps + dx
    warp = ((5 + all_per_exp) * exps + dx) / 32
    terms = {"sfu": exps / SFU_OPS_PER_S * 1e3,
             "f32": f32 / F32_OPS_PER_S * 1e3,
             "issue": warp / WARP_ISSUE_PER_S * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    top = max(terms, key=terms.get)
    return terms[top], ("bytes" if top == "bytes" else "operations"), terms


def check_scan(torch, np, cuda):
    """selective_scan against its plain twin at every listed shape, h_last
    bit for bit and y; event-timed beside the twin and the bound, a decode
    step after an L2 flush by a read and by a write.  Returns the kernel
    row: timings at the prefill shape with h0, as the served model calls
    it, and the decode step's time (read flush) and bound besides."""
    from repro_torch.kernels.mamba_scan import (selective_scan,
                                                selective_scan_ref)

    expf, per_state = _scan_sass()
    log(f"scan: one precise expf in the built library (cuobjdump -sass): "
        f"{json.dumps(dict(expf))}; the step loop at Ds 16: {per_state!r} "
        f"instructions a state")
    worst, row, decode = 0.0, None, None
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    rflush = torch.ones(32 << 20, dtype=torch.float32, device=cuda)
    for shape in SCAN_SHAPES:
        label = shape[0]
        delta, a, bm, cm, x, h0 = _scan_case(torch, cuda, shape, len(label))
        y, h = selective_scan(delta, a, bm, cm, x, h0=h0)
        wy, wh = selective_scan_ref(delta, a, bm, cm, x, h0)
        torch.cuda.synchronize()
        err = float((y - wy).abs().max())
        lim = SCAN_TOL * float(wy.abs().max())
        worst = max(worst, err, float((h - wh).abs().max()))
        log(f"scan: {label} B={shape[1]} S={shape[2]} Di={shape[3]} "
            f"Ds={shape[4]} h0={'given' if shape[5] else 'zero'}: y "
            f"max_abs_err={err!r} (limit {lim:.3e}, {int((y != wy).sum())} "
            f"of {wy.numel()} differ), h_last "
            f"{int((h != wh).sum())} of {wh.numel()} differ")
        if not err <= lim:
            raise SystemExit(f"selective_scan disagrees with plain at "
                             f"{label}: y {err!r} > {lim!r}")
        if not torch.equal(h, wh):
            raise SystemExit(f"selective_scan disagrees with plain at "
                             f"{label}: h_last not bit for bit")
        if label.startswith("ragged"):
            continue
        bound, by, terms = _scan_bound(shape, expf)
        run = [lambda r: selective_scan(delta, a, bm, cm, x, h0=h0)]
        if shape[2] > 1:
            ms = time_launches(torch, run, 20)[0]
            extra = ""
        else:   # a decode step finds h0 cold: flush the L2 first
            read = [lambda r: rflush.sum()]
            ms = time_launches(torch, read + run, 100)[-1]
            wms = time_launches(torch, [lambda r: flush.zero_()] + run,
                                100)[-1]
            extra = (f" after a 128 MB read flush (after a 64 MB write "
                     f"flush {wms * 1e3:.2f}us)")
            decode = (ms, bound)
        plain_ms = time_wall(torch, lambda: selective_scan_ref(
            delta, a, bm, cm, x, h0), 2 if shape[2] > 1 else 20)
        log(f"scan: {label}: {ms * 1e3:.2f}us per launch{extra}; bound "
            f"{bound * 1e3:.2f}us ({by}; terms in us: "
            + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in terms.items())
            + f"), {bound / ms:.3f} of it; plain {plain_ms:.3f}ms")
        if label == "prefill, h0":
            row = dict(name="selective_scan", route="cuda",
                       source="src/repro_torch/kernels/csrc/"
                              "selective_scan.cu",
                       replaces="src/repro/kernels/mamba_scan/kernel.py:52",
                       ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       library_ms=None)
        del delta, x, y, wy
    row["max_abs_err"] = worst
    row["decode_ms"], row["decode_bound_ms"] = decode
    return row


def _jamba(torch, np, cuda, dtype):
    """The served configuration in ``dtype``: the registry's weights
    (seed 0, the reference's init scales, drawn on the card), prompts
    from numpy seed 1."""
    from repro_torch.configs import get_arch
    from repro_torch.models import registry
    from repro_torch.serve import ServeEngine

    cfg = get_arch(JAMBA).full.replace(dtype=dtype, **JAMBA_CUT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = registry.init(cfg, seed=0, device=cuda)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (JAMBA_B, JAMBA_PROMPT)).astype(np.int32)
    return cfg, ServeEngine(cfg, model, JAMBA_MAX_LEN), prompts, init_s


def _generate(torch, engine, prompts, new=None):
    """generate (``new`` tokens, default Jamba's) with every call's
    logits, host-timed around synchronised work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, logits = engine.generate(prompts, new or JAMBA_NEW,
                                   return_logits=True)
    torch.cuda.synchronize()
    return toks, logits, (time.perf_counter() - t0) * 1e3


def run_jamba_main(torch, np, cuda, out):
    """Slice 4's main path: Jamba bf16 through ``ServeEngine.generate``;
    one ``selective_scan`` launch per Mamba layer and call (the prefill and
    each decode step), one ``flash_attention`` launch per attention layer
    and call."""
    from repro_torch import kernels
    from repro_torch.models.common import param_count_tree

    cfg, engine, prompts, init_s = _jamba(torch, np, cuda, "bfloat16")
    torch.cuda.reset_peak_memory_stats()
    before = {k: kernels.LAUNCHES[k]
              for k in ("selective_scan", "flash_attention")}
    toks, logits, gen_ms = _generate(torch, engine, prompts)
    n_attn = cfg.n_layers // cfg.attn_period
    want = {"selective_scan": (cfg.n_layers - n_attn) * JAMBA_NEW,
            "flash_attention": n_attn * JAMBA_NEW}
    got = {k: kernels.LAUNCHES[k] - before[k] for k in want}
    if got != want:
        raise SystemExit(f"jamba: launches {got}, expected {want}")
    if toks.shape != (JAMBA_B, JAMBA_NEW) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise SystemExit(f"jamba: bad tokens {toks}")
    if not all(bool(torch.isfinite(x).all()) for x in logits):
        raise SystemExit("jamba: non-finite logits")
    distinct = min(len(set(row)) for row in toks.tolist())
    if distinct < 2:
        raise SystemExit(f"jamba: a request repeats one token, so the "
                         f"checks below would prove little: {toks}")
    log(f"jamba: {cfg.name} cut to {JAMBA_CUT} "
        f"({param_count_tree(engine.params)} parameters, bf16, init "
        f"{init_s:.2f}s) B={JAMBA_B} prompt={JAMBA_PROMPT} new={JAMBA_NEW} "
        f"(first run) generate {gen_ms:.1f}ms, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; fewest "
        f"distinct tokens in a request {distinct}; tokens[0]="
        f"{toks[0].tolist()}")
    out.update(cfg=cfg, engine=engine, prompts=prompts, toks=toks,
               logits=logits)


def _profile(torch, fn):
    """Device ms in total and by kernel name of one call of ``fn``
    (torch.profiler), or None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    if not kern:
        return None
    return {e.key: (e.count, e.self_device_time_total / 1e3) for e in kern}


def _share(prof, part):
    return sum(ms for k, (_, ms) in prof.items() if part in k)


def _count(prof, part):
    return sum(n for k, (n, _) in prof.items() if part in k)


def _ms(d, key) -> str:
    """``d[key]`` in ms, or "not measured" where the profile held no
    device time."""
    return "not measured" if d.get(key) is None else f"{d[key]:.3f}ms"


def run_jamba_checks(torch, np, cuda, main):
    """Off the counted path: the plain twins on the same card inputs, warm
    timings and the device profile, the fp32 run, the smoke golden."""
    from repro_torch import convert
    from repro_torch.models import hybrid
    from repro_torch.serve import ServeEngine, golden, make_prefill

    cfg, engine, prompts = main["cfg"], main["engine"], main["prompts"]
    toks = main["toks"]
    with torch.inference_mode(), plain_twins():
        p_toks, _, p_ms = _generate(torch, engine, prompts)
        p_logits = engine.teacher_forced_logits(prompts, toks)
    err = _check_logits(np, "jamba bf16 kernel vs plain", main.pop("logits"),
                        p_logits, 0.0, 2e-2, scaled=True)
    del p_logits
    agree = float((toks == p_toks).mean())
    log(f"jamba: bf16 kernels vs plain twins on the card: logits of every "
        f"step max_abs_err={err!r} (limit 2e-2 x the step's largest logit), "
        f"greedy token agreement {agree:.3f}; the twins' generate "
        f"{p_ms:.1f}ms")

    # warm timings: generate, the prefill alone; the device profile
    runs = [_generate(torch, engine, prompts)[2] for _ in range(2)]
    gen_ms = min(runs)
    prefill = make_prefill(cfg)
    toks_dev = torch.as_tensor(prompts, device=cuda)

    def prefill_once():
        cache = hybrid.init_cache(cfg, JAMBA_B, JAMBA_MAX_LEN, device=cuda)
        prefill(engine.params, toks_dev, cache)

    with torch.inference_mode():
        pre_ms = time_wall(torch, prefill_once, 2)
        prof_pre = _profile(torch, prefill_once)
        prof_gen = _profile(torch, lambda: engine.generate(prompts,
                                                           JAMBA_NEW))
    step_ms = (gen_ms - pre_ms) / (JAMBA_NEW - 1)
    log(f"jamba: warm (best of 2): generate {gen_ms:.2f}ms = prefill "
        f"{pre_ms:.2f}ms + {JAMBA_NEW - 1} decode steps at {step_ms:.3f}ms; "
        f"{JAMBA_B * JAMBA_NEW / gen_ms * 1e3:.1f} new tokens/s "
        f"({JAMBA_B * (JAMBA_NEW - 1) / (gen_ms - pre_ms) * 1e3:.1f} in the "
        f"decode steps); weights {cfg.param_count() * 2 / 1e9:.2f} GB, read "
        f"once a step at 3.35e12 B/s: {cfg.param_count() * 2 / 3.35e9:.2f}ms")
    e2e = {}
    if prof_pre is None or prof_gen is None:
        log("jamba: profile: no device time in the trace (busy share and "
            "kernel shares not measured)")
    else:
        dev_pre = sum(ms for _, ms in prof_pre.values())
        dev_gen = sum(ms for _, ms in prof_gen.values())
        dev_dec = dev_gen - dev_pre
        dec = {k: (c - prof_pre.get(k, (0, 0.0))[0],
                   ms - prof_pre.get(k, (0, 0.0))[1])
               for k, (c, ms) in prof_gen.items()}
        n_dec = sum(c for c, _ in dec.values()) / (JAMBA_NEW - 1)
        e2e = {"busy": dev_dec / (JAMBA_NEW - 1),
               "flash": (_share(prof_gen, "flash_fwd")
                         - _share(prof_pre, "flash_fwd")) / (JAMBA_NEW - 1),
               "prefill_flash": _share(prof_pre, "flash_fwd")}
        for label, part in (("selective_scan", "selective_scan"),
                            ("flash_attention", "flash_fwd")):
            pre, gen = _share(prof_pre, part), _share(prof_gen, part)
            k_pre = _count(prof_pre, part)
            k_dec = _count(prof_gen, part) - k_pre
            log(f"jamba: {label}: prefill {k_pre} kernels {pre:.3f}ms = "
                f"{pre / dev_pre:.4f} of its device time; decode steps "
                f"{k_dec} kernels {gen - pre:.3f}ms "
                f"({(gen - pre) / max(k_dec, 1) * 1e3:.2f}us a kernel) = "
                f"{(gen - pre) / dev_dec:.4f} of theirs")
        log(f"jamba: profiled: prefill device busy {dev_pre:.2f}ms "
            f"({dev_pre / pre_ms:.3f} of its wall); decode steps "
            f"{dev_dec / (JAMBA_NEW - 1):.3f}ms busy a step "
            f"({dev_dec / (gen_ms - pre_ms):.3f} of the wall), "
            f"{n_dec:.0f} kernels a step")
        for label, prof in (("prefill", prof_pre), ("decode steps", dec)):
            top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:8]
            log(f"jamba: top kernels of the {label}: " + "; ".join(
                f"{k[:56]} x{c} {ms:.2f}ms" for k, (c, ms) in top))

    # fp32: the kernels' tokens are the twins' exactly; bf16 freed first
    main.clear()
    del engine, prefill
    torch.cuda.empty_cache()
    _, e32, p32, init32 = _jamba(torch, np, cuda, "float32")
    t32, l32, ms32 = _generate(torch, e32, p32)
    with torch.inference_mode(), plain_twins():
        pt32, pl32, pms32 = _generate(torch, e32, p32)
    err32 = _check_logits(np, "jamba fp32 kernel vs plain", l32, pl32, 1e-4,
                          1e-4, scaled=False)
    log(f"jamba: fp32 (init {init32:.2f}s, generate {ms32:.1f}ms, twins "
        f"{pms32:.1f}ms) kernels vs plain twins: tokens identical="
        f"{bool((t32 == pt32).all())}, logits of every step max_abs_err="
        f"{err32!r} (rtol/atol 1e-4)")
    if not (t32 == pt32).all():
        raise SystemExit("jamba fp32: kernel tokens differ from the plain "
                         "twins'")
    del e32, l32, pl32
    torch.cuda.empty_cache()

    with open(os.path.join(HERE, "tests", "goldens",
                           golden.JAMBA_GOLDEN_NAME)) as f:
        want = json.load(f)
    gcfg = golden.jamba_config()
    tree, gprompts = golden.jamba_numpy_case(gcfg)
    gmodel = convert.hybrid_params_from_numpy(tree, gcfg, cuda)
    gtoks, glogits = ServeEngine(
        gcfg, gmodel, golden.JAMBA_PROMPT_LEN + golden.NEW_TOKENS
        + golden.CACHE_SLACK).generate(gprompts, golden.NEW_TOKENS,
                                       return_logits=True)
    bad = golden.mismatches(want, glogits[0].cpu(),
                            [x.cpu() for x in glogits[1:]], gtoks, 1e-5)
    log(f"jamba: {golden.JAMBA_GOLDEN_NAME} on the card (fp32, kernel "
        f"path): {'ok' if not bad else 'MISMATCH'}")
    if bad:
        raise SystemExit("jamba golden mismatch:\n  " + "\n  ".join(bad))
    return e2e


# --------------------------------------------------------------------- #
# slice 12: the campaign service, the plan cache, chaos, trace and report
# --------------------------------------------------------------------- #
SERVICE_GOLDEN = os.path.join(HERE, "tests", "goldens", "service_4x4.json")


def service_specs(core, noc, quick: bool) -> dict:
    """The reference's three service stages (``benchmarks/run.py``:
    ``bench_campaign_service``, ``bench_chaos``, ``bench_obs_report``) as
    ``CampaignSpec``s of the package ``core``/``noc`` (the port's, or the
    reference's where the golden is written), at ``BENCH_QUICK`` lengths
    (1 200, 2 600, 900 cycles) or at full length (6 000, 8 000, 4 000)."""
    topo = core.mesh2d(4, 4)
    link = ((5, 6), (6, 5))
    c = 1200 if quick else 6000
    service = noc.CampaignSpec(
        topo=topo, algos=(noc.Algo.XY, noc.Algo.BIDOR),
        patterns=("uniform", "transpose"), rates=(0.1, 0.3), seeds=(0,),
        base=noc.SimConfig(cycles=c, warmup=c // 3, drain=c // 10),
        scenarios=(noc.Scenario("calm"),
                   noc.Scenario("linkfail",
                                events=(noc.LinkFail(cycle=c // 2,
                                                     links=link),),
                                policy="oracle",
                                replan=noc.ReplanConfig(epoch=c // 4))))
    c = 2600 if quick else 8000
    cc = noc.ChaosConfig(start=c // 4, horizon=c, flap_storms=1,
                         flap_links=2, flap_bursts=2, flap_period=c // 12,
                         region_failures=1, drift_events=1)
    rc = noc.ReplanConfig(epoch=c // 6, max_shed=0.5)
    chaos = noc.CampaignSpec(
        topo=topo, algos=(noc.Algo.BIDOR,), patterns=("uniform",),
        rates=(0.3,), seeds=(0,),
        base=noc.SimConfig(cycles=c, warmup=c // 4, drain=c // 10,
                           watchdog=True),
        scenarios=(noc.Scenario("calm"),
                   *noc.chaos_scenarios(topo, [0, 1], replan=rc, base=cc)))
    c = 900 if quick else 4000
    epoch = c // 6
    fail = noc.LinkFail(cycle=2 * epoch, links=link)
    obs = noc.CampaignSpec(
        topo=topo, algos=(noc.Algo.BIDOR,), patterns=("transpose",),
        rates=(0.3,), seeds=(0,),
        base=noc.SimConfig(cycles=c, warmup=epoch, drain=epoch,
                           injection_rate=0.3, telemetry=True,
                           tel_slots=18),
        scenarios=tuple(noc.Scenario(p, events=(fail,), policy=p,
                                     replan=noc.ReplanConfig(epoch=epoch))
                        for p in ("stale", "online")))
    return {"campaign_service": service, "chaos": chaos, "obs_report": obs}


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _service_run(job, max_cells=None) -> bool:
    """``job.run(max_cells)``, failing on any retried or failed cell: the
    service's retries must never hide a fault on the card."""
    from repro_torch.obs.report import load_metrics

    done = job.run(max_cells)
    metrics = load_metrics(job.metrics_path)
    bad = [m for m in metrics if m["event"] in ("cell_retry", "cell_error")]
    if bad:
        raise SystemExit(f"service: job {job.job_id}: {bad[:3]}")
    if not done and metrics[-1]["event"] != "job_pause":
        raise SystemExit(f"service: job {job.job_id} ended incomplete: "
                         f"{metrics[-1]}")
    return done


def _service_job(cuda, spec, root, job_id, max_cells=None, **kw):
    """A job run to completion, a new ``CampaignJob`` (a new process's
    view of the directory) every ``max_cells`` executed cells; returns
    (job, runs)."""
    from repro_torch.noc import CampaignJob

    runs = 0
    while True:
        job = CampaignJob(spec, root=root, job_id=job_id, device=cuda, **kw)
        runs += 1
        if _service_run(job, max_cells):
            return job, runs
        if runs > 32:
            raise SystemExit(f"service: job {job_id} does not converge")


def _same_csv(label, *jobs) -> bytes:
    want = _read(jobs[0].csv_path)
    for job in jobs[1:]:
        if _read(job.csv_path) != want:
            raise SystemExit(f"service: {label}: {job.job_id}'s results.csv "
                             f"differs from {jobs[0].job_id}'s")
    return want


def _quarantine(spec, cuda, root, job, kw):
    """Truncate the second cell's npz and rerun the job: exactly one
    ``cell_quarantined``, the same CSV bytes."""
    from repro_torch.obs.report import load_metrics

    want = _read(job.csv_path)
    victim = job.cells[1]
    path = job._cell_path(victim)
    blob = _read(path)
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    again, _ = _service_job(cuda, spec, root, job.job_id, **kw)
    quar = [m["cell"] for m in load_metrics(again.metrics_path)
            if m["event"] == "cell_quarantined"]
    if quar != [victim.slug] or _read(again.csv_path) != want:
        raise SystemExit(f"service: quarantine of {victim.slug}: {quar}")
    return victim.slug


class _Stop(Exception):
    """The deliberate interruption of a cell by :class:`_StopAfter`."""


def _stop_after(ckpt_cls, path, k):
    """A cell checkpointer whose ``save`` raises :class:`_Stop` after its
    k-th snapshot is on disk: a process killed inside a scenario cell."""

    class StopAfter(ckpt_cls):
        def __init__(self):
            super().__init__(path)
            self.left = k

        def save(self, arrays, meta):
            super().save(arrays, meta)
            self.left -= 1
            if self.left == 0:
                raise _Stop

    return StopAfter()


def run_service(torch, np, cuda, paper):
    """Slice 12's main path on the card, through the campaign service
    (``run_campaign_service`` / ``CampaignJob``, ``device=cuda``):

    1. the paper's cells (``paper_spec``) interrupted after every cell
       until done, then a fresh job on the warm plan cache: both CSVs
       equal, byte for byte, and equal to ``run_paper``'s own rows; the
       warm job builds no plan and launches no possibility kernel;
    2. the reference's chaos stage at full length (8 000 cycles, the
       watchdog on): interrupted after every cell, and inside a scenario
       cell and resumed from its snapshot, against a fresh job; then one
       cell's npz truncated: one quarantine, the same CSV;
    3. the reference's obs stage at full length (4 000 cycles, telemetry
       on, traced): the trace's schema and its control-plane chain, the
       report rendered, online's peak link load under stale's after the
       replan;
    4. one 32x32 BiDOR uniform cell, cold, then warm: the plan ms;
    5. the three stages at ``BENCH_QUICK`` lengths against
       ``tests/goldens/service_4x4.json`` (the reference's rows and chaos
       schedules), row for row.
    """
    import dataclasses
    import shutil

    from repro_torch import core, kernels, noc
    from repro_torch.core import build_plan, traffic
    from repro_torch.noc import CellCheckpoint
    from repro_torch.noc.campaign import CampaignResult, csv_rows
    from repro_torch.noc.service import _event_desc
    from repro_torch.obs.report import render_job
    from repro_torch.obs.trace import read_trace, validate_events

    t_phase = time.perf_counter()
    root = os.path.join(HERE, "artifacts", "campaigns_torch", "smoke")
    shutil.rmtree(root, ignore_errors=True)

    # ---- 1. the paper's cells: kill and resume, then a warm job ---- #
    spec = paper_spec()
    job, runs = _service_job(cuda, spec, root, "paper", max_cells=1)
    before = dict(kernels.LAUNCHES)
    warm, _ = _service_job(cuda, spec, root, "paper-warm")
    poss = {k: kernels.LAUNCHES[k] - before[k]
            for k in ("possibility_v", "possibility_weights")}
    got = _same_csv("paper", job, warm)
    want = "".join(",".join(str(v) for v in row) + "\n"
                   for row in [CampaignResult.CSV_HEADER]
                   + csv_rows(paper["res"].points)).encode()
    stats = warm.plan_cache.stats.as_dict()
    log(f"service: paper {len(job.cells)} cells in {runs} runs, "
        f"results.csv {len(got)} bytes, equal to run_paper's rows: "
        f"{got == want}; warm job plan cache {json.dumps(stats)}, "
        f"possibility launches {json.dumps(poss)}")
    if got != want:
        raise SystemExit("service: the paper job's CSV differs from "
                         "run_paper's rows")
    if stats["device_builds"] or not stats["hits"] or any(poss.values()):
        raise SystemExit("service: the warm paper job planned again")

    # ---- 2. chaos at full length ---- #
    specs = service_specs(core, noc, quick=False)
    spec = specs["chaos"]
    plan = build_plan(spec.topo, traffic.uniform(spec.topo),
                      use_kernel=True, device=cuda)
    kw = dict(bidor_tables={"uniform": plan.table.choice})
    t0 = time.perf_counter()
    job, runs = _service_job(cuda, spec, root, "chaos", max_cells=1, **kw)
    mid = noc.CampaignJob(spec, root=root, job_id="chaos-mid", device=cuda,
                          **kw)
    key = mid.cells[1]                       # chaos-s0, a scenario cell
    ck = _stop_after(CellCheckpoint, mid._ckpt_path(key), 3)
    try:
        mid.executor.run_cell(key, checkpoint=ck)
    except _Stop:
        pass
    else:
        raise SystemExit("service: the chaos cell was not interrupted")
    snap = CellCheckpoint(mid._ckpt_path(key)).load()
    if snap is None or snap[1]["bound_i"] != 3:
        raise SystemExit("service: no snapshot to resume the chaos cell")
    _service_run(mid)
    fresh, _ = _service_job(cuda, spec, root, "chaos-fresh", **kw)
    got = _same_csv("chaos", fresh, job, mid)
    victim = _quarantine(spec, cuda, root, job, kw)
    res = job.result()
    for p in res.points:
        _check_result(p.result, np, in_order=False)
        log(f"service: chaos {p.scenario:9s} {p.result.summary()}")
    log(f"service: chaos {len(job.cells)} cells in {runs} runs, resumed "
        f"inside {key.slug} at boundary 3, the fresh job's {len(got)} "
        f"bytes of CSV equal; {victim} quarantined and recomputed; "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- 3. obs at full length, traced ---- #
    spec = specs["obs_report"]
    job, _ = _service_job(cuda, spec, root, "obs", trace=True)
    job.close()
    events = read_trace(job.trace_path)
    problems = validate_events(events)
    names = {e["name"] for e in events}
    replans = [e for e in events if e["name"] == "replan"]
    summary = render_job(job.dir, os.path.join(root, "obs-report"))
    tels = {k.scenario: job.cell_telemetry(k) for k in job.cells}
    epoch = spec.scenarios[0].replan.epoch
    starts = tels["stale"].slot_starts()
    post = [s for s in tels["stale"].active_slots()
            if starts[s] >= 3 * epoch]
    peak = {s: float(t.peak_link_load()[0][post].mean())
            for s, t in tels.items()}
    log(f"service: obs {len(events)} trace events, problems {problems[:3]}, "
        f"replans {len(replans)} (dur_us "
        f"{[round(e['dur'], 1) for e in replans]}), report "
        f"{json.dumps({k: summary[k] for k in ('trace_events', 'replans', 'traj_rows')})}"
        f"; post-replan peak link load (probes alone) stale "
        f"{peak['stale']:.4f} online {peak['online']:.4f} over "
        f"{len(post)} slots")
    if problems or not {"epoch", "LinkFail", "replan", "hot_swap"} <= names:
        raise SystemExit(f"service: obs trace: {problems[:3]} "
                         f"{sorted(names)}")
    if not replans or not all(e["dur"] > 0 for e in replans):
        raise SystemExit("service: obs replan spans without a duration")
    if not post or not peak["online"] < peak["stale"]:
        raise SystemExit(f"service: online's peak is not under stale's: "
                         f"{peak}")

    # ---- 4. a 32x32 BiDOR cell, cold, then warm ---- #
    spec = dataclasses.replace(scale_specs()[0], algos=(noc.Algo.BIDOR,))
    for tag in ("cold", "warm"):
        job, _ = _service_job(cuda, spec, os.path.join(root, "big"),
                              f"big-{tag}")
        ex, res = job.executor, job.result()
        _check_results(res, np)
        log(f"service: 32x32 BIDOR {tag}: plan_ms={ex.plan_s * 1e3:.1f} "
            f"stages_ms={json.dumps(ex.plan_stage_ms)} plan cache "
            f"{json.dumps(job.plan_cache.stats.as_dict())} cell wall "
            f"{sum(res.wall_clock_s.values()):.3f}s ({card_line()})")

    # ---- 5. the QUICK stages against the reference's golden ---- #
    with open(SERVICE_GOLDEN) as f:
        golden = json.load(f)["specs"]
    for name, spec in service_specs(core, noc, quick=True).items():
        want = golden[name]
        kw = {}
        if name == "chaos":
            plan = build_plan(spec.topo, traffic.uniform(spec.topo),
                              use_kernel=True, device=cuda)
            if plan.table.choice.tolist() != want["choice"]:
                raise SystemExit("service: chaos plan differs from the "
                                 "reference's")
            kw["bidor_tables"] = {"uniform": plan.table.choice}
            sched = [[_event_desc(e) for e in s.events]
                     for s in spec.scenarios]
            if sched != want["schedules"]:
                raise SystemExit("service: chaos schedules differ from "
                                 "the reference's")
        if noc.spec_fingerprint(spec) != want["fingerprint"]:
            raise SystemExit(f"service: {name}'s spec is not the golden's")
        job, _ = _service_job(cuda, spec, os.path.join(root, "quick"), name,
                              **kw)
        rows = _read(job.csv_path).decode().splitlines()
        ok = rows == want["rows"]
        log(f"service: {name} QUICK {len(rows) - 1} rows against "
            f"service_4x4.json: {'ok' if ok else 'MISMATCH'}")
        if not ok:
            bad = [f"{a} != {b}" for a, b in zip(rows, want["rows"])
                   if a != b]
            raise SystemExit(f"service: {name} rows differ:\n  "
                             + "\n  ".join(bad[:8]))
    log(f"service: phase {time.perf_counter() - t_phase:.1f}s")


# --------------------------------------------------------------------- #
# slice 13: ML traffic from the reference's recorded HLO
# --------------------------------------------------------------------- #
MLTRAFFIC_GOLDEN = os.path.join(HERE, "tests", "goldens", "mltraffic.json")
MLTRAFFIC_HLO = os.path.join(HERE, "tests", "goldens", "mltraffic")
# the stage's campaign at full length (BENCH_QUICK=0), then at QUICK's
MLTRAFFIC_CYCLES = (2000, 200)
MLTRAFFIC_TOPO = (2, 4)
MLTRAFFIC_INTS = ("injected", "ejected", "in_flight", "reorder",
                  "meas_cycles", "max_latency", "saturated")
MLTRAFFIC_FLOATS = ("throughput", "offered", "avg_latency", "p50_latency",
                    "p90_latency", "p99_latency", "link_load_max", "lcv")


def op_record(op) -> list:
    """A collective op as JSON: [name, kind, size_bytes, wire_bytes,
    groups, pairs, count]."""
    return [op.name, op.kind, op.size_bytes, op.wire_bytes,
            [list(g) for g in op.groups], [list(p) for p in op.pairs],
            op.count]


def point_record(p) -> dict:
    """A campaign point as JSON: its coordinates and statistics."""
    r = p.result
    return {"workload": p.workload, "algo": p.algo.name, "rate": p.rate,
            "seed": p.seed, "injected": int(r.injected_flits),
            "ejected": int(r.ejected_flits),
            "in_flight": int(r.in_flight_flits),
            "reorder": int(r.reorder_value),
            "meas_cycles": int(r.meas_cycles),
            "max_latency": float(r.max_latency),
            "saturated": bool(r.saturated),
            "throughput": float(r.throughput),
            "offered": float(r.offered),
            "avg_latency": float(r.avg_latency),
            "p50_latency": float(r.p50_latency),
            "p90_latency": float(r.p90_latency),
            "p99_latency": float(r.p99_latency),
            "link_load_max": float(r.link_load_max), "lcv": float(r.lcv)}


def mltraffic_plans(np, device, hlo_dir=MLTRAFFIC_HLO):
    """The stage's body for each workload on the port: derived from the
    recorded HLO, its matrix on torus(2,4), ``build_plan(use_kernel=True)``
    (the possibility pair at N = 8), ``greedy_refine(sweeps=3)`` from the
    better of the plan and XY, ``certify_table(traffic=)``.  Returns
    (records in ``mltraffic.json``'s layout, workloads, the MoE
    workloads' refined choice tables)."""
    from repro_torch.analysis.hlo import collective_ops
    from repro_torch.core import (bidor, build_plan, certify_table,
                                  link_load_stats, torus)
    from repro_torch.core.bidor import greedy_refine
    from repro_torch.noc.mltraffic import (STAGE_GRID, derive_from_hlo,
                                           read_hlo)

    topo = torus(*MLTRAFFIC_TOPO)
    xy = bidor(topo, np.zeros(topo.num_nodes))

    def mx(tm, table):
        return float(link_load_stats(topo, tm, table)["max"])

    recs, wls, tables = [], [], {}
    for spec, moe in STAGE_GRID:
        texts = read_hlo(spec, hlo_dir)
        wl = derive_from_hlo(spec, texts)
        tm = wl.matrix_for(topo)
        plan = build_plan(topo, tm, use_kernel=True, device=device)
        use_plan = mx(tm, plan.table) <= mx(tm, xy)
        ref = greedy_refine(topo, tm, plan.table if use_plan else xy,
                            sweeps=3)
        cert = certify_table(topo, ref, traffic=tm)
        if moe:
            tables[wl.name] = ref.choice
        wls.append(wl)
        recs.append({
            "name": wl.name, "spec": dataclasses.asdict(spec),
            "fingerprint": spec.fingerprint(), "moe": moe,
            "op_counts": wl.meta["collective_op_counts"],
            "ops": {ph: [op_record(op) for op in collective_ops(
                texts[ph], spec.num_devices)] for ph in spec.phases},
            "totals": wl.totals,
            "matrix": np.asarray(tm).tolist(),
            "max_load": {"xy": mx(tm, xy), "bidor": mx(tm, plan.table),
                         "refined": mx(tm, ref)},
            "start": "plan" if use_plan else "xy",
            "plan_choice": np.asarray(plan.table.choice).tolist(),
            "refined_choice": np.asarray(ref.choice).tolist(),
            "cert": cert.verdict})
    return recs, wls, tables


def mltraffic_spec(noc, topo, workloads, cycles: int):
    """The stage's campaign grid: XY and BiDOR, rates 0.1 and 0.3, seed
    0, ``cycles`` long (warmup a quarter, drain a tenth)."""
    return noc.CampaignSpec(
        topo=topo, algos=(noc.Algo.XY, noc.Algo.BIDOR), patterns=(),
        workloads=tuple(workloads), rates=(0.1, 0.3), seeds=(0,),
        base=noc.SimConfig(cycles=cycles, warmup=cycles // 4,
                           drain=cycles // 10))


def mltraffic_plan_mismatches(np, want: dict, recs: list) -> list[str]:
    """The port's records against ``mltraffic.json``: everything parsed
    and derived exactly (the matrices bit for bit), the max link loads
    within 1e-12, the choice tables equal."""
    got = json.loads(json.dumps(recs))          # the golden's JSON types
    bad = []
    if [g["name"] for g in got] != [w["name"] for w in want["workloads"]]:
        return [f"workloads {[g['name'] for g in got]}"]
    for w, g, rec in zip(want["workloads"], got, recs):
        for k in ("spec", "fingerprint", "moe", "op_counts", "ops",
                  "totals", "start", "cert", "plan_choice",
                  "refined_choice"):
            if g[k] != w[k]:
                bad.append(f"{w['name']}: {k} differs")
        if not np.array_equal(np.asarray(rec["matrix"]),
                              np.asarray(w["matrix"])):
            bad.append(f"{w['name']}: matrix not bit for bit")
        for k, v in w["max_load"].items():
            if abs(g["max_load"][k] - v) > 1e-12:
                bad.append(f"{w['name']}: max load {k} {g['max_load'][k]!r}"
                           f" != {v!r}")
    return bad


def mltraffic_row_mismatches(want_rows: list, got_rows: list) -> list[str]:
    """Campaign rows: the coordinates and integer counts exact, the float
    statistics to 6 significant digits (relative 1e-6)."""
    if len(got_rows) != len(want_rows):
        return [f"{len(got_rows)} rows != {len(want_rows)}"]
    bad = []
    for w, g in zip(want_rows, got_rows):
        key = f"{w['workload']}/{w['algo']}/{w['rate']}/{w['seed']}"
        for k in ("workload", "algo", "rate", "seed") + MLTRAFFIC_INTS:
            if g[k] != w[k]:
                bad.append(f"{key}: {k} {g[k]!r} != {w[k]!r}")
        for k in MLTRAFFIC_FLOATS:
            if abs(g[k] - w[k]) > 1e-6 * max(abs(g[k]), abs(w[k])):
                bad.append(f"{key}: {k} {g[k]!r} != {w[k]!r}")
    return bad


def check_conservation(np, wl) -> float:
    """Per phase and per kind, the flow matrix sums to the HLO's fabric
    bytes (relative 1e-12, the reference's own test); returns the worst
    relative gap."""
    worst = 0.0
    for ph, kinds in wl.totals.items():
        if set(kinds) != set(wl.flows[ph]):
            raise SystemExit(f"mltraffic: {wl.name} {ph}: kinds "
                             f"{sorted(wl.flows[ph])} != {sorted(kinds)}")
        for kind, tot in kinds.items():
            gap = abs(float(wl.flows[ph][kind].sum()) - tot) / max(tot, 1.0)
            worst = max(worst, gap)
            if gap > 1e-12:
                raise SystemExit(f"mltraffic: {wl.name} {ph} {kind}: flows "
                                 f"sum off the HLO total by {gap!r}")
    return worst


def run_mltraffic(torch, np, cuda):
    """Slice 13's first main path: the reference's ML-traffic stage on the
    card.  The four workloads derived from the recorded HLO against
    ``tests/goldens/mltraffic.json`` (ops, totals, matrices, max loads,
    choice tables, certificates), conservation per phase and kind, every
    refined table ``clean`` and never above XY (strictly below where the
    reference's is), then one ``CampaignJob`` on the card at 2 000 and at
    200 cycles (MoE cells on the refined tables), rows against the
    golden's; a retried or failed cell fails the phase."""
    import shutil

    from repro_torch import noc
    from repro_torch.core import torus

    t0 = time.perf_counter()
    with open(MLTRAFFIC_GOLDEN) as f:
        want = json.load(f)
    recs, wls, tables = mltraffic_plans(np, cuda)
    plan_s = time.perf_counter() - t0
    bad = mltraffic_plan_mismatches(np, want, recs)
    for rec, wl, w in zip(recs, wls, want["workloads"]):
        gap = check_conservation(np, wl)
        m = rec["max_load"]
        log(f"mltraffic: {wl.name} ops={sum(rec['op_counts'].values())} "
            f"xy={m['xy']!r} bidor={m['bidor']!r} refined={m['refined']!r} "
            f"win={(m['xy'] - m['refined']) / m['xy']:+.4f} from "
            f"{rec['start']}, cert={rec['cert']}, conservation gap {gap!r}")
        if rec["cert"] != "clean" or m["refined"] > m["xy"] + 1e-12:
            raise SystemExit(f"mltraffic: {wl.name}: refined table "
                             f"{rec['cert']}, {m['refined']!r} against XY "
                             f"{m['xy']!r}")
        strict = w["max_load"]["refined"] < w["max_load"]["xy"] * (1 - 1e-6)
        if rec["moe"] and strict and not (
                m["refined"] < m["xy"] * (1 - 1e-6)):
            raise SystemExit(f"mltraffic: {wl.name}: refined not under XY")
    if bad:
        raise SystemExit("mltraffic: against mltraffic.json:\n  "
                         + "\n  ".join(bad[:12]))
    log(f"mltraffic: 4 workloads parsed, derived and planned "
        f"({plan_s:.2f}s): ops, totals, matrices, max loads, choice "
        f"tables and certificates equal mltraffic.json")

    root = os.path.join(HERE, "artifacts", "campaigns_torch", "mltraffic")
    shutil.rmtree(root, ignore_errors=True)
    topo = torus(*MLTRAFFIC_TOPO)
    for cycles in MLTRAFFIC_CYCLES:
        t1 = time.perf_counter()
        spec = mltraffic_spec(noc, topo, wls, cycles)
        job, _ = _service_job(cuda, spec, root, f"ml_traffic-{cycles}",
                              bidor_tables=tables)
        res = job.result()
        rows = [point_record(p) for p in res.points]
        bad = mltraffic_row_mismatches(want["campaign"][str(cycles)], rows)
        for p in res.points:
            _check_result(p.result, np)
        lat = {f"{wl.name}/{a.name}": [
            round(float(np.mean([p.result.p50_latency for p in pts])), 1),
            round(float(np.mean([p.result.p99_latency for p in pts])), 1)]
            for wl in wls for a in spec.algos
            for pts in [res.select(workload=wl.name, algo=a)]}
        log(f"mltraffic: campaign {cycles} cycles, {len(job.cells)} cells "
            f"of 2 lanes in {time.perf_counter() - t1:.2f}s (cells "
            f"{sum(res.wall_clock_s.values()):.3f}s, plans "
            f"{job.executor.plan_s * 1e3:.1f}ms); {len(rows)} rows against "
            f"mltraffic.json: {'ok' if not bad else 'MISMATCH'}; mean "
            f"[p50, p99] {json.dumps(lat)}")
        if bad:
            raise SystemExit(f"mltraffic: {cycles}-cycle rows:\n  "
                             + "\n  ".join(bad[:12]))
    log(f"mltraffic: phase {time.perf_counter() - t0:.1f}s")


# --------------------------------------------------------------------- #
# slice 13: the dense LM family served at full width
# --------------------------------------------------------------------- #
# internlm2-1.8b at its published widths, nothing cut; the batch of the
# reference's examples/serve_decode.py (4 requests, 16-token prompts, 24
# new tokens, a cache of prompt + new + 8 rows)
DENSE = "internlm2-1.8b"
DENSE_OTHERS = ("stablelm-3b", "codeqwen1.5-7b")
DENSE_B, DENSE_PROMPT, DENSE_NEW = 4, 16, 24
DENSE_LONG = 2048


def _dense(torch, np, cuda, arch, dtype, prompt_len=DENSE_PROMPT,
           cut=None):
    """``arch``'s published configuration in ``dtype`` (with the fields
    of ``cut`` replaced): the registry's weights (seed 0, the reference's
    init scales, drawn on the card), prompts from numpy seed 1, an engine
    with a cache of prompt + new + 8 rows."""
    from repro_torch.configs import get_arch
    from repro_torch.models import registry
    from repro_torch.serve import ServeEngine

    cfg = get_arch(arch).full.replace(dtype=dtype, **(cut or {}))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = registry.init(cfg, seed=0, device=cuda)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (DENSE_B, prompt_len)).astype(np.int32)
    engine = ServeEngine(cfg, model, prompt_len + DENSE_NEW + 8)
    return cfg, engine, prompts, init_s


def _check_tokens(label, toks, vocab, want_shape):
    if toks.shape != want_shape or not ((toks >= 0) & (toks < vocab)).all():
        raise SystemExit(f"{label}: bad tokens {toks}")
    distinct = min(len(set(row)) for row in toks.tolist())
    if distinct < 2:
        raise SystemExit(f"{label}: a request repeats one token, so the "
                         f"checks against the twin would prove little: "
                         f"{toks}")
    return distinct


def run_dense_main(torch, np, cuda, out):
    """Slice 13's second main path: internlm2-1.8b bf16 at full width
    through ``ServeEngine.generate``, one ``flash_attention`` launch per
    layer and call (the prefill and each decode step)."""
    from repro_torch import kernels
    from repro_torch.models.common import param_count_tree

    cfg, engine, prompts, init_s = _dense(torch, np, cuda, DENSE, "bfloat16")
    n_params = param_count_tree(engine.params)
    if n_params != cfg.param_count():
        raise SystemExit(f"dense: {n_params} parameters, count_params "
                         f"{cfg.param_count()}")
    torch.cuda.reset_peak_memory_stats()
    before = kernels.LAUNCHES["flash_attention"]
    toks, logits, gen_ms = _generate(torch, engine, prompts, DENSE_NEW)
    calls = cfg.n_layers * DENSE_NEW
    got = kernels.LAUNCHES["flash_attention"] - before
    if got != calls:
        raise SystemExit(f"dense: {got} flash_attention launches, expected "
                         f"{calls}")
    if not all(bool(torch.isfinite(x).all()) for x in logits):
        raise SystemExit("dense: non-finite logits")
    distinct = _check_tokens("dense", toks, cfg.vocab, (DENSE_B, DENSE_NEW))
    log(f"dense: {cfg.name} at published widths ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params} "
        f"parameters, bf16, init {init_s:.2f}s) B={DENSE_B} "
        f"prompt={DENSE_PROMPT} new={DENSE_NEW} (first run) generate "
        f"{gen_ms:.1f}ms, {got} flash_attention launches, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"fewest distinct tokens in a request {distinct}; tokens[0]="
        f"{toks[0].tolist()}")
    out.update(cfg=cfg, engine=engine, prompts=prompts, toks=toks,
               logits=logits)


def _step_errs(np, got, want):
    """Each step's largest |got - want| (lists of logits tensors)."""
    return np.array([float((g.float() - w.float()).abs().max())
                     for g, w in zip(got, want)])


def _dense_vs_twins(torch, np, label, engine, prompts, toks, logits, rule):
    """The kernels' bf16 logits of every step (``logits``, greedy
    ``toks``) against the plain twins' fed the same tokens, and both
    against the fp32 logits of the same weights, which are upcast in
    place: ``engine`` holds them after the call, and the fp32 engine is
    returned.  At each step the kernels' error against fp32 may be at
    most twice the twins' own: a wrong key range or softmax errs by the
    logits' own size, while bf16 rounding through 24–32 layers already
    puts the twins 1–2 % of the step's largest logit from fp32.  With
    ``rule``, the kernels' logits must also lie within 2e-2 of each
    step's largest logit from the twins'."""
    from repro_torch.serve import ServeEngine

    with torch.inference_mode(), plain_twins():
        p_toks, _, p_ms = _generate(torch, engine, prompts, DENSE_NEW)
        twin = engine.teacher_forced_logits(prompts, toks)
    if not all(bool(torch.isfinite(x).all()) for x in logits):
        raise SystemExit(f"dense {label}: non-finite logits")
    vs_twin = _step_errs(np, logits, twin)
    share = vs_twin / np.array([float(w.float().abs().max()) for w in twin])
    e32 = ServeEngine(engine.cfg.replace(dtype="float32"),
                      engine.params.float(), engine.max_len)
    torch.cuda.empty_cache()
    truth = e32.teacher_forced_logits(prompts, toks)
    err_k, err_t = _step_errs(np, logits, truth), _step_errs(np, twin, truth)
    ratio = err_k / np.maximum(err_t, 1e-30)
    log(f"dense: {label} bf16 kernels vs plain twins on the card: logits "
        f"of every step max_abs_err={float(vs_twin.max())!r} = {share.max():.4f} "
        f"of the step's largest logit ({'held to 0.02' if rule else 'shown'}"
        f"), greedy token agreement {float((toks == p_toks).mean()):.3f}, "
        f"the twins' generate {p_ms:.1f}ms; against the fp32 logits of the "
        f"same weights, worst step: kernels {float(err_k.max())!r}, twins "
        f"{float(err_t.max())!r}, kernels/twins {ratio.max():.3f} (limit 2)")
    if rule and (share > 2e-2).any():
        raise SystemExit(f"dense {label}: bf16 logits {share.max():.4f} of "
                         f"the step's largest logit from the twins'")
    if (ratio > 2).any():
        raise SystemExit(f"dense {label}: the kernels' bf16 error {err_k} "
                         f"over twice the twins' {err_t}")
    return e32


def _fp32_vs_twins(torch, np, label, engine, prompts):
    """fp32 ``generate`` through the kernels and through the plain twins:
    the same tokens, every step's logits within rtol/atol 1e-4."""
    t32, l32, ms32 = _generate(torch, engine, prompts, DENSE_NEW)
    with torch.inference_mode(), plain_twins():
        pt32, pl32, pms32 = _generate(torch, engine, prompts, DENSE_NEW)
    if not (t32 == pt32).all():
        raise SystemExit(f"dense {label} fp32: kernel tokens differ from "
                         f"the plain twins'")
    err32 = _check_logits(np, f"dense {label} fp32 kernel vs plain", l32,
                          pl32, 1e-4, 1e-4, scaled=False)
    log(f"dense: {label} fp32 (generate {ms32:.1f}ms, twins {pms32:.1f}ms) "
        f"kernels vs plain twins: tokens identical, logits of every step "
        f"max_abs_err={err32!r} (rtol/atol 1e-4)")


def run_dense_long(torch, np, cuda, cfg):
    """internlm2 at 4 x 2 048-token prompts, off the counted path: bf16
    ``generate`` (the tensor-core prefill, split decode steps with their
    combine), timed and held against the twins and fp32; then on the
    same weights in fp32 the kernels (the CUDA-core prefill, fp32 split
    steps) give the twins' tokens and logits within rtol/atol 1e-4."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models import lm
    from repro_torch.serve import make_prefill

    _, eng, prompts, _ = _dense(torch, np, cuda, DENSE, "bfloat16",
                                DENSE_LONG)
    flash_kernel.reset_path_launches()
    before = kernels.LAUNCHES["flash_attention"]
    toks, logits, first_ms = _generate(torch, eng, prompts, DENSE_NEW)
    paths = dict(flash_kernel.PATH_LAUNCHES)
    n = kernels.LAUNCHES["flash_attention"] - before
    _check_tokens("dense long", toks, cfg.vocab, (DENSE_B, DENSE_NEW))
    if n != cfg.n_layers * DENSE_NEW or not (
            paths["tc"] and paths["split"] and paths["combine"]):
        raise SystemExit(f"dense long: {n} launches, paths {paths}")
    toks_dev = torch.as_tensor(prompts, device=cuda)
    with torch.inference_mode():
        pre_ms = time_wall(torch, lambda: make_prefill(cfg)(
            eng.params, toks_dev,
            lm.init_cache(cfg, DENSE_B, eng.max_len, device=cuda)), 2)
    gen_ms = min(_generate(torch, eng, prompts, DENSE_NEW)[2]
                 for _ in range(2))
    log(f"dense: {cfg.name} bf16 B={DENSE_B} prompt={DENSE_LONG} "
        f"new={DENSE_NEW}: first generate {first_ms:.1f}ms, warm "
        f"{gen_ms:.2f}ms = prefill {pre_ms:.2f}ms + {DENSE_NEW - 1} steps "
        f"at {(gen_ms - pre_ms) / (DENSE_NEW - 1):.3f}ms; flash kernels by "
        f"path {json.dumps(paths)}")
    e32 = _dense_vs_twins(torch, np, f"{cfg.name} prompt {DENSE_LONG}", eng,
                          prompts, toks, logits, rule=False)
    del eng, logits
    _fp32_vs_twins(torch, np, f"{cfg.name} prompt {DENSE_LONG}", e32,
                   prompts)
    del e32
    torch.cuda.empty_cache()


def _warm(torch, cuda, label, cfg, engine, prompts, state_bytes=0,
          prof_new=DENSE_NEW):
    """Warm timings (best of 3), the prefill alone, and the device
    profile of one prefill and one ``generate`` of ``prof_new`` tokens:
    the step against reading every weight once (and a recurrent state of
    ``state_bytes``, read and written once)."""
    from repro_torch.models import registry
    from repro_torch.serve import make_prefill

    gen_ms = min(_generate(torch, engine, prompts, DENSE_NEW)[2]
                 for _ in range(3))
    prefill = make_prefill(cfg)
    toks_dev = torch.as_tensor(prompts, device=cuda)

    def prefill_once():
        cache = registry.init_cache(cfg, DENSE_B, engine.max_len,
                                    device=cuda)
        prefill(engine.params, toks_dev, cache)

    with torch.inference_mode():
        pre_ms = time_wall(torch, prefill_once, 3)
        if FULL:
            prof_pre = _profile(torch, prefill_once)
            prof_gen = _profile(torch, lambda: engine.generate(prompts,
                                                               prof_new))
    step_ms = (gen_ms - pre_ms) / (DENSE_NEW - 1)
    wbytes = cfg.param_count() * 2
    state = (f" + the state {state_bytes / 1e9:.3f} GB read and written"
             if state_bytes else "")
    log(f"{label}: warm (best of 3): generate {gen_ms:.2f}ms = prefill "
        f"{pre_ms:.2f}ms + {DENSE_NEW - 1} decode steps at {step_ms:.3f}ms; "
        f"{DENSE_B * DENSE_NEW / gen_ms * 1e3:.1f} new tokens/s; weights "
        f"{wbytes / 1e9:.3f} GB{state}, once a step at 3.35e12 B/s: "
        f"{(wbytes + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3:.3f}ms")
    if not FULL:
        log(f"{label}: profile: not taken (--full)")
        return
    if prof_pre is None or prof_gen is None:
        log(f"{label}: profile: no device time in the trace (busy share "
            f"and kernel shares not measured)")
        return
    steps = prof_new - 1
    dev_pre = sum(ms for _, ms in prof_pre.values())
    dec = {k: (c - prof_pre.get(k, (0, 0.0))[0],
               ms - prof_pre.get(k, (0, 0.0))[1])
           for k, (c, ms) in prof_gen.items()}
    busy = sum(ms for _, ms in dec.values()) / steps
    n_dec = sum(c for c, _ in dec.values()) / steps
    fl_dec = sum(ms for k, (_, ms) in dec.items() if "flash_fwd" in k)
    log(f"{label}: profiled ({steps} decode steps): prefill device busy "
        f"{dev_pre:.3f}ms ({dev_pre / pre_ms:.3f} of its wall), flash_fwd* "
        f"{_share(prof_pre, 'flash_fwd'):.3f}ms; decode steps "
        f"{busy:.3f}ms busy a step ({busy / step_ms:.3f} of the wall), "
        f"flash_fwd* {fl_dec / steps * 1e3:.2f}us a step, {n_dec:.0f} "
        f"kernels a step")
    top = sorted(dec.items(), key=lambda kv: -kv[1][1])[:6]
    log(f"{label}: top kernels of the decode steps: " + "; ".join(
        f"{k[:56]} x{c} {ms:.2f}ms" for k, (c, ms) in top))


def run_dense_checks(torch, np, cuda, main):
    """Off the counted path: warm timings and the device profile, the
    plain twins and fp32 on the same weights, 4 x 2 048-token prompts,
    the fp32 run, stablelm-3b and codeqwen1.5-7b, the smoke golden."""
    from repro_torch import convert, kernels
    from repro_torch.configs import get_arch
    from repro_torch.serve import ServeEngine, golden

    cfg, engine, prompts = main["cfg"], main["engine"], main["prompts"]
    _warm(torch, cuda, "dense", cfg, engine, prompts)

    # the served run against the twins and fp32 (the weights upcast)
    _dense_vs_twins(torch, np, cfg.name, engine, prompts, main["toks"],
                    main.pop("logits"), rule=True)
    main.clear()
    del engine
    torch.cuda.empty_cache()

    # 4 x 2 048-token prompts: the tensor-core prefill at GQA 16/8, then
    # split decode steps with their combine over 2 080 rows
    run_dense_long(torch, np, cuda, cfg)

    # fp32 drawn as such: the kernels' tokens are the twins' exactly
    _, e32, p32, _ = _dense(torch, np, cuda, DENSE, "float32")
    _fp32_vs_twins(torch, np, cfg.name, e32, p32)
    del e32
    torch.cuda.empty_cache()

    # the family's other two configurations, one generate each
    for arch in DENSE_OTHERS:
        ocfg, eng, pr, init_s = _dense(torch, np, cuda, arch, "bfloat16")
        torch.cuda.reset_peak_memory_stats()
        before = kernels.LAUNCHES["flash_attention"]
        toks, logits, ms = _generate(torch, eng, pr, DENSE_NEW)
        n = kernels.LAUNCHES["flash_attention"] - before
        distinct = _check_tokens(arch, toks, ocfg.vocab,
                                 (DENSE_B, DENSE_NEW))
        if n != ocfg.n_layers * DENSE_NEW:
            raise SystemExit(f"{arch}: {n} flash_attention launches")
        log(f"dense: {ocfg.name} at published widths "
            f"({ocfg.param_count()} parameters, bf16, init {init_s:.2f}s, "
            f"{ocfg.n_heads}/{ocfg.n_kv_heads} heads of {ocfg.head_dim}) "
            f"B={DENSE_B} prompt={DENSE_PROMPT} new={DENSE_NEW}: generate "
            f"{ms:.1f}ms (first run), {n} flash_attention launches, peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB; fewest distinct tokens {distinct}")
        e32 = _dense_vs_twins(torch, np, ocfg.name, eng, pr, toks, logits,
                              rule=False)
        del eng, e32, logits
        torch.cuda.empty_cache()

    # the smoke golden on the card (fp32, kernel path)
    with open(os.path.join(HERE, "tests", "goldens",
                           golden.DENSE_GOLDEN_NAME)) as f:
        want = json.load(f)
    for arch in golden.DENSE_ARCHS:
        gcfg = get_arch(arch).smoke
        tree, gprompts = golden.dense_numpy_case(gcfg)
        gmodel = convert.dense_params_from_numpy(tree, gcfg, cuda)
        gtoks, glogits = ServeEngine(
            gcfg, gmodel, golden.DENSE_PROMPT_LEN + golden.DENSE_NEW_TOKENS
            + golden.CACHE_SLACK).generate(gprompts,
                                           golden.DENSE_NEW_TOKENS,
                                           return_logits=True)
        bad = golden.mismatches(want[gcfg.name], glogits[0].cpu(),
                                [x.cpu() for x in glogits[1:]], gtoks, 1e-5)
        log(f"dense: {golden.DENSE_GOLDEN_NAME} {gcfg.name} on the card "
            f"(fp32, kernel path): {'ok' if not bad else 'MISMATCH'}")
        if bad:
            raise SystemExit(f"dense golden mismatch ({gcfg.name}):\n  "
                             + "\n  ".join(bad))


# --------------------------------------------------------------------- #
# slice 14: the MoE decoders and MLA
# --------------------------------------------------------------------- #
# qwen2-moe-a2.7b at its published widths, nothing cut (28.63 GB in
# bf16); dbrx-132b and Jamba with experts cut to what one card holds in
# bf16; minicpm3-4b (MLA) whole.  The batch of examples/serve_decode.py.
MOE = "qwen2-moe-a2.7b"
MOE_OTHERS = {"dbrx-132b": {"n_layers": 8},
              "jamba-1.5-large-398b": {"n_layers": 8, "moe_experts": 8}}
MLA = "minicpm3-4b"


@contextlib.contextmanager
def fp32_weights(torch):
    """Within this scope every bf16 parameter a torch function reads is
    handed to it as a float32 copy, made for that call and freed after:
    the float32 model of the bf16 weights' own values without a float32
    copy of the whole model (dbrx's 8 layers take 54.6 GB in bf16).  The
    model's configuration must say float32, so its activations and
    caches are float32 too."""
    from torch.overrides import TorchFunctionMode

    def up(a):
        if isinstance(a, (list, tuple)) and not isinstance(a, torch.Size):
            return type(a)(up(x) for x in a)
        if isinstance(a, torch.nn.Parameter) and a.dtype == torch.bfloat16:
            return a.float()
        return a

    class Upcast(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            return func(*up(args),
                        **{k: up(v) for k, v in (kwargs or {}).items()})

    with Upcast():
        yield


def _routes(stats):
    """The (token, slot) routes of each MoE call, on the host."""
    return [x["experts"].cpu() for x in stats]


def _route_flips(a, b) -> int:
    """(token, slot) routes that differ between two runs' stats."""
    if len(a) != len(b):
        raise SystemExit(f"moe: {len(a)} MoE calls against {len(b)}")
    return sum(int((x != y).sum()) for x, y in zip(a, b))


def _widths(cfg) -> str:
    moe = (f", {cfg.moe_experts} experts top-{cfg.moe_topk}"
           + (f" + {cfg.moe_shared} shared" if cfg.moe_shared else "")
           + f" of d_ff {cfg.d_ff}, capacity factor {cfg.capacity_factor}"
           if cfg.is_moe else "")
    mla = (f", MLA q rank {cfg.q_lora_rank}, kv rank {cfg.kv_lora_rank}, "
           f"Dk {cfg.qk_nope_dim}+{cfg.qk_rope_dim}, Dv {cfg.v_head_dim}"
           if cfg.mla else "")
    if cfg.family == "ssm":
        dp = int(cfg.xlstm_proj_factor * cfg.d_model)
        return (f"{cfg.n_layers} layers in super-blocks of 1 sLSTM + "
                f"{cfg.slstm_period - 1} mLSTM, d {cfg.d_model}, "
                f"{cfg.n_heads} heads, mLSTM width {dp} (head dim "
                f"{dp // cfg.n_heads}), vocab {cfg.vocab}")
    rope = (f", M-RoPE sections {cfg.mrope_sections}"
            if cfg.mrope_sections else "")
    return (f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads of {cfg.head_dim}{moe}{mla}{rope}, "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab}")


def _serve_counted(torch, np, label, cfg, engine, prompts, init_s, cut):
    """One bf16 ``generate`` through the kernels with the MoE stats: one
    ``flash_attention`` launch a layer and call (Jamba: an attention
    layer, and one ``selective_scan`` a Mamba layer and call).  Returns
    (tokens, logits, stats, ms, the flash kernels by path)."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.models.common import param_count_tree
    from repro_torch.models.layers.ffn import moe_stats

    n_params = param_count_tree(engine.params)
    if n_params != cfg.param_count():
        raise SystemExit(f"{label}: {n_params} parameters, count_params "
                         f"{cfg.param_count()}")
    hyb = cfg.family == "hybrid"
    n_attn = cfg.n_layers // cfg.attn_period if hyb else cfg.n_layers
    want = {"flash_attention": n_attn * DENSE_NEW,
            "selective_scan": (cfg.n_layers - n_attn) * DENSE_NEW}
    torch.cuda.reset_peak_memory_stats()
    before = dict(kernels.LAUNCHES)
    paths = dict(flash_kernel.PATH_LAUNCHES)
    with moe_stats() as stats:
        toks, logits, ms = _generate(torch, engine, prompts, DENSE_NEW)
    got = {k: kernels.LAUNCHES[k] - before[k] for k in want}
    by_path = {k: flash_kernel.PATH_LAUNCHES[k] - paths[k] for k in paths}
    if got != want:
        raise SystemExit(f"{label}: launches {got}, expected {want}")
    if not all(bool(torch.isfinite(x).all()) for x in logits):
        raise SystemExit(f"{label}: non-finite logits")
    distinct = _check_tokens(label, toks, cfg.vocab, (DENSE_B, DENSE_NEW))
    drops = ""
    if cfg.is_moe:
        from repro_torch.serve import golden

        aux, dropped = golden.call_stats(cfg, stats)
        drops = (f"; dropped (token, slot) pairs of {DENSE_B * cfg.moe_topk}"
                 f" a layer and step: prefill {dropped[0]} (of "
                 f"{DENSE_B * prompts.shape[1] * cfg.moe_topk} a layer), "
                 f"steps {dropped[1:]}, aux prefill {aux[0]:.5f}")
    log(f"{label}: {cfg.name} ({_widths(cfg)}; cut {cut or 'nothing'}; "
        f"{n_params} parameters, {n_params * 2 / 1e9:.2f} GB bf16, init "
        f"{init_s:.2f}s) B={DENSE_B} prompt={prompts.shape[1]} "
        f"new={DENSE_NEW} (first run) generate {ms:.1f}ms, launches "
        f"{json.dumps(got)}, flash kernels by path {json.dumps(by_path)}, "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; fewest "
        f"distinct tokens {distinct}{drops}; tokens[0]={toks[0].tolist()}")
    return toks, logits, stats, ms, by_path


def _vs_twins(torch, np, label, engine, prompts, toks, logits, stats):
    """The kernels' bf16 logits of every step (``logits``, greedy
    ``toks``, MoE ``stats``) against the plain twins' fed the same
    tokens, and both against the float32 model of the same weights
    (:func:`fp32_weights`): at each step the kernels' error may be at
    most twice the twins' (the dense family's rule).  A router near-tie
    that the bf16 runs break apart sends a token through other experts
    and moves that step's logits by far more than attention's rounding,
    so the twins and the fp32 model replay the kernels' routes
    (``moe_stats(replay=)``) for the rule, and the routes the twins take
    on their own are counted and printed.  Then float32 through the
    kernels and through the twins, each routing itself: the same tokens,
    the same routes, every step's logits within rtol/atol 1e-4."""
    from repro_torch.models.layers.ffn import moe_stats
    from repro_torch.serve import ServeEngine

    routes = [x["experts"] for x in stats]
    flips = None
    if engine.cfg.is_moe:
        with torch.inference_mode(), plain_twins(), moe_stats() as t_stats:
            own = engine.teacher_forced_logits(prompts, toks)
        flips = _route_flips(_routes(stats), _routes(t_stats))
        own_share = max(float((g.float() - w.float()).abs().max())
                        / float(w.float().abs().max())
                        for g, w in zip(logits, own))
        del own
    with torch.inference_mode(), plain_twins(), moe_stats(routes):
        twin = engine.teacher_forced_logits(prompts, toks)
    vs_twin = _step_errs(np, logits, twin)
    share = vs_twin / np.array([float(w.float().abs().max()) for w in twin])
    e32 = ServeEngine(engine.cfg.replace(dtype="float32"), engine.params,
                      engine.max_len)
    with fp32_weights(torch), moe_stats(routes):
        truth = e32.teacher_forced_logits(prompts, toks)
    err_k, err_t = _step_errs(np, logits, truth), _step_errs(np, twin, truth)
    ratio = err_k / np.maximum(err_t, 1e-30)
    own = ("" if flips is None else
           f"; routing on their own the twins take {flips} of "
           f"{sum(x.numel() for x in routes)} (token, slot) routes "
           f"otherwise, and their logits sit {own_share:.4f} of a step's "
           f"largest from the kernels'")
    tag = "" if flips is None else " (the kernels' routes replayed)"
    log(f"{label}: bf16 kernels vs plain twins on the card{tag}: "
        f"logits of every step max_abs_err={float(vs_twin.max())!r} = "
        f"{share.max():.4f} of the step's largest logit; against the fp32 "
        f"logits of the same weights, worst step: kernels "
        f"{float(err_k.max())!r}, twins {float(err_t.max())!r}, "
        f"kernels/twins {ratio.max():.3f} (limit 2){own}")
    del twin, truth
    if (ratio > 2).any():
        raise SystemExit(f"{label}: the kernels' bf16 error {err_k} over "
                         f"twice the twins' {err_t}")
    with fp32_weights(torch), moe_stats() as k32:
        t32, l32, ms32 = _generate(torch, e32, prompts, DENSE_NEW)
    with fp32_weights(torch), torch.inference_mode(), plain_twins(), \
            moe_stats() as p32:
        pt32, pl32, pms32 = _generate(torch, e32, prompts, DENSE_NEW)
    flips32 = _route_flips(_routes(k32), _routes(p32))
    same = bool((t32 == pt32).all())
    err32 = (_check_logits(np, f"{label} fp32 kernel vs plain", l32, pl32,
                           1e-4, 1e-4, scaled=False) if same else None)
    log(f"{label}: fp32 on the bf16 weights' values (generate {ms32:.1f}ms,"
        f" twins {pms32:.1f}ms) kernels vs plain twins: tokens identical="
        f"{same}, routes that differ {flips32}, logits of every step "
        f"max_abs_err={err32!r} (rtol/atol 1e-4)")
    if not same or flips32:
        raise SystemExit(f"{label} fp32: the kernels' tokens or routes "
                         f"differ from the plain twins'")


def run_moe_main(torch, np, cuda, out):
    """Slice 14's first main path: qwen2-moe-a2.7b bf16 at its published
    widths and depth through ``ServeEngine.generate``: 576
    ``flash_attention`` launches (24 layers × 24 calls), every one on
    the split path."""
    cfg, engine, prompts, init_s = _dense(torch, np, cuda, MOE, "bfloat16")
    toks, logits, stats, _, by_path = _serve_counted(
        torch, np, "moe", cfg, engine, prompts, init_s, {})
    if by_path["tc"] or by_path["simt"] or by_path["split"] != \
            cfg.n_layers * DENSE_NEW:
        raise SystemExit(f"moe: flash kernels by path {by_path}, all "
                         f"{cfg.n_layers * DENSE_NEW} split expected")
    out.update(cfg=cfg, engine=engine, prompts=prompts, toks=toks,
               logits=logits, stats=stats)


def _attention_dims(cfg) -> tuple[int, int]:
    """The (Dk, Dv) a configuration's attention calls take."""
    if cfg.mla:
        return cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    return cfg.head_dim, cfg.head_dim


def _golden_on_card(torch, np, cuda, name, archs):
    """``name`` (the reference's fp32 records) through the port's serving
    path on the card: logits, tokens, with experts each call's aux and
    drops, and one ``flash_attention`` launch an attention layer and call
    (none for xLSTM).  A smoke configuration whose attention head dims
    are no built pair (minicpm3's smoke: Dk 16 + 8 = 24, Dv 16) runs its
    padded pair's kernels; a record under ``image`` (qwen2-vl) is the
    image-style prefill and its decode steps."""
    from repro_torch import convert, kernels
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.ops import padded_dims
    from repro_torch.models.layers.ffn import moe_stats
    from repro_torch.serve import ServeEngine, golden

    conv = {"hybrid": convert.hybrid_params_from_numpy,
            "ssm": convert.xlstm_params_from_numpy}
    with open(os.path.join(HERE, "tests", "goldens", name)) as f:
        want = json.load(f)
    for arch in archs:
        gcfg = get_arch(arch).smoke
        tree, gprompts = golden.lm_numpy_case(gcfg)
        model = conv.get(gcfg.family, convert.dense_params_from_numpy)(
            tree, gcfg, cuda)
        n_attn = {"hybrid": gcfg.n_layers // max(gcfg.attn_period, 1),
                  "ssm": 0}.get(gcfg.family, gcfg.n_layers)
        runs = [(gcfg.name, lambda: ServeEngine(
            gcfg, model, golden.DENSE_PROMPT_LEN + golden.DENSE_NEW_TOKENS
            + golden.CACHE_SLACK).generate(gprompts, golden.DENSE_NEW_TOKENS,
                                           return_logits=True),
                 n_attn * golden.DENSE_NEW_TOKENS)]
        if "image" in want:
            runs.append(("image", lambda: golden.image_generate(
                gcfg, model, *golden.vlm_image_case(gcfg)),
                n_attn * (1 + golden.IMAGE_STEPS)))
        for key, run, calls in runs:
            before = kernels.LAUNCHES["flash_attention"]
            with moe_stats() as stats:
                gtoks, glogits = run()
            got = kernels.LAUNCHES["flash_attention"] - before
            rec = want[key]
            bad = golden.mismatches(rec, glogits[0].cpu(),
                                    [x.cpu() for x in glogits[1:]], gtoks,
                                    1e-5)
            if gcfg.is_moe:
                bad += golden.moe_mismatches(
                    rec, *golden.call_stats(gcfg, stats))
            if got != calls:
                bad.append(f"{got} flash_attention launches, expected "
                           f"{calls}")
            dims = _attention_dims(gcfg)
            where = (f"kernel path, {got} flash_attention launches"
                     + (f" at (Dk, Dv) {dims} padded to "
                        f"{padded_dims(*dims)}"
                        if calls and padded_dims(*dims) != dims else "")
                     if calls else "no kernel launched")
            log(f"{name}: {key} on the card (fp32, {where}): "
                f"{'ok' if not bad else 'MISMATCH'}")
            if bad:
                raise SystemExit(f"golden mismatch ({key}):\n  "
                                 + "\n  ".join(bad))


def run_moe_checks(torch, np, cuda, main):
    """Off the counted path: qwen2-moe's warm timings and profile, its
    bf16 run against the twins and the fp32 model of its weights, fp32
    kernels against fp32 twins; then dbrx (8 of 40 layers) and Jamba (one
    super-block, 8 of 16 experts), one at a time, each the same way; the
    smoke golden."""
    from repro_torch.serve import golden

    cfg, engine, prompts = main["cfg"], main["engine"], main["prompts"]
    _warm(torch, cuda, "moe", cfg, engine, prompts)
    _vs_twins(torch, np, "moe", engine, prompts, main["toks"],
              main.pop("logits"), main.pop("stats"))
    main.clear()
    del engine
    torch.cuda.empty_cache()
    for arch, cut in MOE_OTHERS.items():
        ocfg, eng, pr, init_s = _dense(torch, np, cuda, arch, "bfloat16",
                                       cut=cut)
        toks, logits, stats, _, _ = _serve_counted(
            torch, np, f"moe {arch}", ocfg, eng, pr, init_s, cut)
        _vs_twins(torch, np, f"moe {arch}", eng, pr, toks, logits, stats)
        del eng, logits, stats
        torch.cuda.empty_cache()
    _golden_on_card(torch, np, cuda, golden.MOE_GOLDEN_NAME,
                    golden.MOE_ARCHS)


def run_mla_main(torch, np, cuda, out):
    """Slice 14's second main path: minicpm3-4b bf16 at its published
    widths and depth through ``ServeEngine.generate``: 1 488
    ``flash_attention`` launches (62 layers × 24 calls) with Dk 96 and
    Dv 64, every one on the split path."""
    cfg, engine, prompts, init_s = _dense(torch, np, cuda, MLA, "bfloat16")
    toks, logits, stats, _, by_path = _serve_counted(
        torch, np, "mla", cfg, engine, prompts, init_s, {})
    if by_path["tc"] or by_path["simt"] or by_path["split"] != \
            cfg.n_layers * DENSE_NEW:
        raise SystemExit(f"mla: flash kernels by path {by_path}, all "
                         f"{cfg.n_layers * DENSE_NEW} split expected")
    out.update(cfg=cfg, engine=engine, prompts=prompts, toks=toks,
               logits=logits, stats=stats)


def run_mla_checks(torch, np, cuda, main):
    """Off the counted path: minicpm3's warm timings and profile, the
    twins and the fp32 model; 4 × 2 048-token prompts in bf16 (the
    tensor-core prefill, then split decode steps) and, on the same
    weights, fp32 (the CUDA-core prefill and fp32 split steps), each
    held against the twins, every path at Dk 96 / Dv 64; the smoke
    golden (the profile with ``--full``)."""
    from repro_torch.serve import golden

    cfg, engine, prompts = main["cfg"], main["engine"], main["prompts"]
    _warm(torch, cuda, "mla", cfg, engine, prompts)
    _vs_twins(torch, np, "mla", engine, prompts, main["toks"],
              main.pop("logits"), main.pop("stats"))
    main.clear()
    del engine
    torch.cuda.empty_cache()
    _mla_long(torch, np, cuda)
    _golden_on_card(torch, np, cuda, golden.MLA_GOLDEN_NAME,
                    golden.MLA_ARCHS)


def _mla_long(torch, np, cuda):
    """minicpm3 at 4 × 2 048-token prompts in bf16 (the tensor-core
    prefill, then split decode steps) and fp32 on the same weights (the
    CUDA-core prefill and fp32 split steps), against the twins."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    lcfg, eng, pr, _ = _dense(torch, np, cuda, MLA, "bfloat16", DENSE_LONG)
    flash_kernel.reset_path_launches()
    toks, logits, first_ms = _generate(torch, eng, pr, DENSE_NEW)
    paths = dict(flash_kernel.PATH_LAUNCHES)
    _check_tokens("mla long", toks, lcfg.vocab, (DENSE_B, DENSE_NEW))
    if paths["tc"] != lcfg.n_layers or paths["split"] != \
            lcfg.n_layers * (DENSE_NEW - 1):
        raise SystemExit(f"mla long: flash kernels by path {paths}")
    gen_ms = _generate(torch, eng, pr, DENSE_NEW)[2]
    log(f"mla: {lcfg.name} bf16 B={DENSE_B} prompt={DENSE_LONG} "
        f"new={DENSE_NEW}: first generate {first_ms:.1f}ms, warm "
        f"{gen_ms:.2f}ms; flash kernels by path {json.dumps(paths)}")
    flash_kernel.reset_path_launches()
    _vs_twins(torch, np, f"mla prompt {DENSE_LONG}", eng, pr, toks, logits,
              [])
    if flash_kernel.PATH_LAUNCHES["simt"] < 2 * lcfg.n_layers:
        raise SystemExit(f"mla long fp32: flash kernels by path "
                         f"{flash_kernel.PATH_LAUNCHES}")
    del eng, logits
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# slice 15: qwen2-vl-2b (M-RoPE) and xlstm-1.3b
# --------------------------------------------------------------------- #
# both whole at their published widths and depth, bf16, the registry's
# weights drawn on the card; the batch of examples/serve_decode.py
VLM = "qwen2-vl-2b"
SSM = "xlstm-1.3b"


def run_vlm_main(torch, np, cuda, out):
    """Slice 15's first main path: qwen2-vl-2b bf16 at its published
    widths and depth through ``ServeEngine.generate`` on text (equal
    t/h/w ids, as the reference's engine passes none): 672
    ``flash_attention`` launches (28 layers × 24 calls), the prefill's
    16 × 6 packed rows on the tensor-core kernel, the steps split."""
    t0 = time.perf_counter()
    cfg, engine, prompts, init_s = _dense(torch, np, cuda, VLM, "bfloat16")
    toks, logits, _, _, by_path = _serve_counted(
        torch, np, "vlm", cfg, engine, prompts, init_s, {})
    want = {"split": cfg.n_layers * (DENSE_NEW - 1), "combine": 0,
            "tc": cfg.n_layers, "simt": 0}
    if by_path != want:
        raise SystemExit(f"vlm: flash kernels by path {by_path}, expected "
                         f"{want}")
    out.update(cfg=cfg, engine=engine, prompts=prompts, toks=toks,
               logits=logits, t0=t0)


def _image_run(torch, cfg, model, case, twins=False, forced=None):
    """The image-style prompt (72 positions) and its decode steps through
    ``golden.image_generate`` (fed ``forced``, if given): (tokens,
    logits, ms, flash kernels by path)."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.serve import golden

    paths = dict(flash_kernel.PATH_LAUNCHES)
    scope = plain_twins() if twins else contextlib.nullcontext()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with scope:
        toks, logits = golden.image_generate(cfg, model, *case,
                                             forced=forced)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return toks, logits, ms, {k: flash_kernel.PATH_LAUNCHES[k] - paths[k]
                              for k in paths}


def run_vlm_checks(torch, np, cuda, main):
    """Off the counted path: qwen2-vl's warm timings and profile; the
    image-style prefill (stub-frontend patches at patch-grid M-RoPE ids,
    on the tensor-core kernel) and 8 decode steps, and the served run,
    each against the plain twins and the float32 model of the same
    weights fed the kernels' tokens: at every call the kernels' error
    against fp32 at most twice the twins' (the dense family's rule),
    their distance from the twins printed as a share of the call's
    largest logit; fp32 through the kernels (the prefill on the
    CUDA-core kernel) against the twins, served and image-style, tokens
    identical; ``serve_vlm_smoke.json``."""
    from repro_torch import kernels
    from repro_torch.serve import golden

    cfg, engine, prompts = main["cfg"], main["engine"], main["prompts"]
    _warm(torch, cuda, "vlm", cfg, engine, prompts, prof_new=4)
    case = golden.vlm_image_case(cfg, seed=1, batch=DENSE_B)
    before = kernels.LAUNCHES["flash_attention"]
    itoks, ilogits, ims, paths = _image_run(torch, cfg, engine.params, case)
    n = kernels.LAUNCHES["flash_attention"] - before
    steps = golden.IMAGE_STEPS
    if n != cfg.n_layers * (1 + steps) or paths["tc"] != cfg.n_layers or \
            paths["split"] != cfg.n_layers * steps or paths["simt"]:
        raise SystemExit(f"vlm image: {n} launches, kernels {paths}")
    if not all(bool(torch.isfinite(x).all()) for x in ilogits):
        raise SystemExit("vlm image: non-finite logits")
    distinct = _check_tokens("vlm image", itoks, cfg.vocab,
                             (DENSE_B, steps + 1))
    warm_ms = _image_run(torch, cfg, engine.params, case)[2]
    forced = itoks[:, :steps]
    with torch.inference_mode():
        _, twin, pms, _ = _image_run(torch, cfg, engine.params, case,
                                     twins=True, forced=forced)
        with fp32_weights(torch):
            truth = _image_run(torch, cfg.replace(dtype="float32"),
                               engine.params, case, forced=forced)[1]
    share = _step_errs(np, ilogits, twin) / np.array(
        [float(w.float().abs().max()) for w in twin])
    err_k, err_t = _step_errs(np, ilogits, truth), _step_errs(np, twin, truth)
    ratio = err_k / np.maximum(err_t, 1e-30)
    log(f"vlm: image-style prompt (B={DENSE_B}: {golden.IMAGE_BEFORE} text "
        f"tokens, a {golden.IMAGE_GRID[0]}x{golden.IMAGE_GRID[1]} patch grid"
        f" at t={golden.IMAGE_BEFORE}, h/w from {golden.IMAGE_BEFORE}, "
        f"{golden.IMAGE_AFTER} text tokens: {golden.IMAGE_LEN} positions) "
        f"then {steps} decode steps: {ims:.1f}ms first run, {warm_ms:.1f}ms "
        f"warm, {n} flash_attention launches {json.dumps(paths)}; fewest "
        f"distinct tokens {distinct}; fed the kernels' tokens, the plain "
        f"twins ({pms:.1f}ms) sit {share.max():.4f} of a call's largest "
        f"logit from the kernels (shown); against the fp32 logits of the "
        f"same weights, worst call: kernels {float(err_k.max())!r}, twins "
        f"{float(err_t.max())!r}, kernels/twins {ratio.max():.3f} (limit 2)")
    if (ratio > 2).any():
        raise SystemExit(f"vlm image: the kernels' bf16 error {err_k} over "
                         f"twice the twins' {err_t}")
    del ilogits, twin, truth
    e32 = _dense_vs_twins(torch, np, cfg.name, engine, prompts, main["toks"],
                          main.pop("logits"), rule=False)
    main.clear()
    del engine
    torch.cuda.empty_cache()
    _fp32_vs_twins(torch, np, cfg.name, e32, prompts)
    t32, l32, ms32, p32 = _image_run(torch, e32.cfg, e32.params, case)
    with torch.inference_mode():
        pt32, pl32, pms32, _ = _image_run(torch, e32.cfg, e32.params, case,
                                          twins=True)
    if not (t32 == pt32).all() or p32["simt"] != cfg.n_layers:
        raise SystemExit(f"vlm image fp32: kernel tokens differ from the "
                         f"twins' or the prefill missed simt ({p32})")
    err32 = _check_logits(np, "vlm image fp32 kernel vs plain", l32, pl32,
                          1e-4, 1e-4, scaled=False)
    log(f"vlm: image-style fp32 (kernels {ms32:.1f}ms, prefill on simt, "
        f"twins {pms32:.1f}ms): tokens identical, logits of every call "
        f"max_abs_err={err32!r} (rtol/atol 1e-4)")
    del e32, l32, pl32
    torch.cuda.empty_cache()
    _golden_on_card(torch, np, cuda, golden.VLM_GOLDEN_NAME,
                    golden.VLM_ARCHS)


def _state_bytes(cache) -> int:
    return sum(a.numel() * a.element_size()
               for part in cache.values() for a in part.values())


def run_ssm_main(torch, np, cuda, out):
    """Slice 15's second main path: xlstm-1.3b bf16 at its published
    widths and depth through ``ServeEngine.generate``.  xLSTM has no
    kernel of the reference's (its products are ``torch.matmul`` and
    ``einsum``, as the reference's are jnp einsums), so the path launches
    none: checked."""
    from repro_torch import kernels
    from repro_torch.models import registry
    from repro_torch.models.common import param_count_tree

    t0 = time.perf_counter()
    cfg, engine, prompts, init_s = _dense(torch, np, cuda, SSM, "bfloat16")
    n_params = param_count_tree(engine.params)
    if n_params != cfg.param_count():
        raise SystemExit(f"ssm: {n_params} parameters, count_params "
                         f"{cfg.param_count()}")
    state = _state_bytes(registry.init_cache(cfg, DENSE_B, 0, device=cuda))
    torch.cuda.reset_peak_memory_stats()
    before = dict(kernels.LAUNCHES)
    toks, logits, ms = _generate(torch, engine, prompts, DENSE_NEW)
    got = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    if any(got.values()):
        raise SystemExit(f"ssm: kernel launches {got}, none expected")
    if not all(bool(torch.isfinite(x).all()) for x in logits):
        raise SystemExit("ssm: non-finite logits")
    distinct = _check_tokens("ssm", toks, cfg.vocab, (DENSE_B, DENSE_NEW))
    log(f"ssm: {cfg.name} ({_widths(cfg)}; cut nothing; {n_params} "
        f"parameters, {n_params * 2 / 1e9:.2f} GB bf16, init {init_s:.2f}s) "
        f"B={DENSE_B} prompt={DENSE_PROMPT} new={DENSE_NEW} (first run) "
        f"generate {ms:.1f}ms; no kernel launch (the reference has no "
        f"kernel for xLSTM): launches {json.dumps(got)}; recurrent state "
        f"{state} bytes ({state / 1e9:.3f} GB, float32), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; fewest "
        f"distinct tokens {distinct}; tokens[0]={toks[0].tolist()}")
    out.update(cfg=cfg, engine=engine, prompts=prompts, toks=toks,
               logits=logits, state=state, t0=t0)


def run_ssm_checks(torch, np, cuda, main):
    """Off the counted path: xLSTM's warm timings and profile against
    reading the weights and the state once a step; the float32 model of
    the same weights (``fp32_weights``): its prefill over the 16-token
    prompt and 24 decode steps against one ``forward`` over the same 40
    tokens, within 2e-3 of each position's largest logit (the
    reference's own tolerance, ``tests/test_models.py``), and the bf16
    run's error against it; ``serve_ssm_smoke.json``."""
    from repro_torch.models import xlstm_model
    from repro_torch.serve import golden

    cfg, engine, prompts = main["cfg"], main["engine"], main["prompts"]
    _warm(torch, cuda, "ssm", cfg, engine, prompts, main["state"],
          prof_new=4)
    cfg32 = cfg.replace(dtype="float32")
    seq = torch.as_tensor(np.concatenate([prompts, main["toks"]], 1),
                          device=cuda)
    p = DENSE_PROMPT
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode(), fp32_weights(torch):
        full, _ = xlstm_model.forward(cfg32, engine.params, seq)
        cache = xlstm_model.init_cache(cfg32, DENSE_B, 0, device=cuda)
        pre, cache = xlstm_model.prefill(cfg32, engine.params, seq[:, :p],
                                         cache)
        stepped = [pre]
        for t in range(p, seq.shape[1]):
            step, cache = xlstm_model.decode_step(
                cfg32, engine.params, seq[:, t:t + 1], cache, t)
            stepped.append(step)
    torch.cuda.synchronize()
    ms32 = (time.perf_counter() - t0) * 1e3
    stepped = torch.cat(stepped, dim=1)
    del cache
    largest = full.abs().amax(dim=(0, 2))               # a position's
    err = (stepped - full).abs().amax(dim=(0, 2))
    share = float((err / largest).max())
    bf16 = torch.cat([x.float() for x in main.pop("logits")], dim=1)
    vs32 = (bf16 - stepped[:, :bf16.shape[1]]).abs().amax(dim=(0, 2))
    b_share = float((vs32 / largest[:bf16.shape[1]]).max())
    log(f"ssm: fp32 model of the bf16 weights ({ms32:.1f}ms): prefill "
        f"({p}) + {seq.shape[1] - p} decode steps vs one forward over the "
        f"same {seq.shape[1]} tokens: max_abs_err={float(err.max())!r} = "
        f"{share:.3e} of a position's largest logit (limit 2e-3); the bf16 "
        f"served logits against it: max_abs_err={float(vs32.max())!r} = "
        f"{b_share:.4f} of a position's largest logit (shown); greedy "
        f"agreement with fp32 over the 24 tokens "
        f"{float((stepped[:, p - 1:-1].argmax(-1).cpu().numpy() == main['toks']).mean()):.3f}")
    if not share <= 2e-3:
        raise SystemExit(f"ssm fp32: prefill + decode {share} of the largest "
                         f"logit from forward")
    del full, stepped, bf16
    main.clear()
    del engine
    torch.cuda.empty_cache()
    _golden_on_card(torch, np, cuda, golden.SSM_GOLDEN_NAME,
                    golden.SSM_ARCHS)



# --------------------------------------------------------------------- #
# slice 16: training
# --------------------------------------------------------------------- #
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_STEPS = 12
TRAIN_B, TRAIN_S = 8, 128     # the launcher's default batch
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu"
BWD_REPLACES = "src/repro/models/layers/attention.py:151-236"
# (label, B, Sq, Skv, H, KV, Dk, Dv, causal): the training step's shape,
# Jamba's training call, a 2 048-token sequence, whisper's
# cross-attention, MLA's pair, and the wide head dims, which run on the
# CUDA-core kernels alone; bf16 at the first three is timed on both
# routes
BWD_SHAPES = (("train", 8, 128, 128, 16, 8, 128, 128, True),
              ("jamba", 2, 1024, 1024, 64, 8, 128, 128, True),
              ("long", 1, 2048, 2048, 16, 8, 128, 128, True),
              ("whisper cross", 8, 128, 1500, 8, 8, 64, 64, False),
              ("mla", 2, 200, 200, 8, 8, 96, 64, True),
              ("d192", 2, 90, 90, 4, 2, 192, 192, True),
              ("d256", 2, 90, 90, 4, 2, 256, 256, True))
# a full-width step through the kernels against the same step through the
# twins, both bf16: the kernels round P to bf16 for P·V and the twins do
# not; on an H100 at internlm2-1.8b's width the two part by 4.2e-6 of the
# loss and 2.1e-4 of the gradient norm (whisper-base 4.1e-5, 7.0e-4), and
# the limits leave room for other seeds and widths
TRAIN_LOSS_RTOL = 2e-3
# the shapes at which the backward's routes are timed
BWD_TIMED = ("train", "jamba", "long")
TRAIN_GNORM_RTOL = 2e-2


@contextlib.contextmanager
def train_twins():
    """Within this scope the model's attention and selective scan run the
    twins of their kernels, on the card too: attention's forward twin
    with its lse and its backward twin (``FlashAttention`` without a
    kernel path), the scan's forward and backward twins
    (``SelectiveScan`` without the kernels), or the forward twins alone
    where no gradient is wanted."""
    import torch

    from repro_torch.kernels.flash_attention import (FlashAttention,
                                                     flash_attention_ref)
    from repro_torch.kernels.mamba_scan import SelectiveScan
    from repro_torch.models.layers import attention, recurrent

    def twin(q, k, v, *, causal, mask_len=None, q_chunk=512, kv_chunk=512):
        if (mask_len is None and torch.is_grad_enabled()
                and (q.requires_grad or k.requires_grad or v.requires_grad)):
            return FlashAttention.apply(q, k, v, causal, q.shape[3] ** -0.5,
                                        q_chunk, kv_chunk, None)
        return flash_attention_ref(q, k, v, causal=causal, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk, bias_mask_len=mask_len)

    def scan_twin(delta, a, b, c, x, h0=None):
        return SelectiveScan.apply(delta, a, b, c, x, h0, False)

    real = attention.flash_ops, recurrent.scan_ops
    attention.flash_ops = SimpleNamespace(flash_attention=twin)
    recurrent.scan_ops = SimpleNamespace(selective_scan=scan_twin)
    try:
        yield
    finally:
        attention.flash_ops, recurrent.scan_ops = real


def _bwd_inputs(torch, cuda, shape, dtype, seed):
    _, b, sq, skv, h, kv, dk, dv, _ = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device=cuda).to(dtype)
                 for s in ((b, sq, h, dk), (b, skv, kv, dk), (b, skv, kv, dv),
                           (b, sq, h, dv)))


def _op_grads(q, k, v, dout, causal):
    """(out, dq, dk, dv) of ``flash_attention`` differentiated on the card:
    the forward kernel with its lse, then the backward kernel."""
    from repro_torch.kernels.flash_attention import flash_attention

    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    out.backward(dout)
    return (out.detach(), *(x.grad for x in leaves))


def _lse_twin(q, k, v, causal):
    """The forward twin's (out, lse)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref

    return flash_attention_ref(q, k, v, causal=causal, return_lse=True)


def _twin_grads(q, k, v, dout, causal):
    """(out, dq, dk, dv) of the two twins."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref

    o, lse = _lse_twin(q, k, v, causal)
    return (o, *flash_attention_bwd_ref(q, k, v, o, lse, dout,
                                        causal=causal))


def _wide_forward(torch, cuda, shape, dt):
    """A head dim above 128 through the op with no gradient, at a decode
    step (Sq 1 against 80 cached keys, 2-D lengths) and a prefill, at the
    width itself and 8 below it (padded up): one simt launch each, the
    twin's result (2e-5 fp32, 8e-3 bf16)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.kernel import PATH_LAUNCHES

    _, b, _, _, h, kv, d, _, _ = shape
    tol = FLASH_TOL[str(dt).removeprefix("torch.")]
    for dk in (d, d - 8):
        for sq, index in ((1, 79), (40, None)):
            q, k, v, _ = _bwd_inputs(torch, cuda, ("wide", b, sq, 80, h, kv,
                                                   dk, dk, False), dt, sq)
            ml = None if index is None else torch.full(
                (b, sq), index + 1, dtype=torch.int32, device=cuda)
            before = PATH_LAUNCHES["simt"]
            got = flash_attention(q, k, v, causal=index is None, mask_len=ml)
            want = flash_attention_ref(q, k, v, causal=index is None,
                                       bias_mask_len=ml)
            err = float((got.float() - want.float()).abs().max())
            log(f"flash: D={dk} {dt} Sq={sq} Skv=80 (no gradient): path "
                f"simt x{PATH_LAUNCHES['simt'] - before}, max_abs_err "
                f"{err!r} (tol {tol})")
            if PATH_LAUNCHES["simt"] != before + 1 or not err <= tol:
                raise SystemExit(f"flash D={dk} {dt} Sq={sq}: {err}")


def _bwd_bound(shape, itemsize, flops_per_s):
    """Least time for the backward on this run's data: 2·(3 Dk + 2 Dv)
    FLOP a counted (query, key) pair (S, dP, dV, dQ, dK) at the card's
    peak for the type, or each input (q, k, v, o, dO, the fp32 lse) read
    once and dq, dk, dv written once at the HBM rate; the larger."""
    _, b, sq, skv, h, kv, dk, dv, causal = shape
    pairs = b * h * sum(min(skv, t + skv - sq + 1) if causal else skv
                        for t in range(sq))
    flops = 2 * (3 * dk + 2 * dv) * pairs
    nbytes = (itemsize * (2 * b * sq * h * dk + 2 * b * skv * kv * dk
                          + 2 * b * skv * kv * dv + 2 * b * sq * h * dv)
              + 4 * b * sq * h)
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / flops_per_s * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by, flops, nbytes


def check_flash_bwd(torch, np, cuda):
    """The backward kernels (through the op's autograd: the forward
    kernel with its lse, then ``flash_attention_bwd`` on its route, tc in
    bf16 up to 128, simt in fp32 and at 192/256) against the twins at
    ``BWD_SHAPES``: bf16 by the ratio rule (each gradient's error against
    the fp32 twins at most twice the bf16 twins'), fp32 within 1e-4 of
    the gradient's largest |value|; the forward kernels' lse against the
    twin's (tc in bf16, simt in fp32 and at 192/256: 1e-4 and 2e-5).  In
    bf16 at ``BWD_TIMED`` µs a launch (events) of the tc route beside the
    CUDA-core kernel (``route="simt"``, held by the same rule),
    ``scaled_dot_product_attention``'s backward (its forward and
    backward less its forward) and the bound; at the training shape also
    the twin and fp32.  Returns the JSON row (the training shape,
    bf16)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention.kernel import (
        BWD_PATH_LAUNCHES, bwd_route, flash_attention_bwd_cuda,
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import (choose_path,
                                                         padded_dims)

    worst, row = 0.0, None
    for shape in BWD_SHAPES:
        label, causal = shape[0], shape[8]
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v, dout = _bwd_inputs(torch, cuda, shape, dt, len(label))
            dims = padded_dims(shape[6], shape[7])
            route = bwd_route(dt, *dims)
            before = BWD_PATH_LAUNCHES[route]
            got = _op_grads(q, k, v, dout, causal)
            twin = _twin_grads(q, k, v, dout, causal)
            exact = _twin_grads(*(x.float() for x in (q, k, v, dout)),
                                causal)
            torch.cuda.synchronize()
            if BWD_PATH_LAUNCHES[route] != before + 1:
                raise SystemExit(f"flash_attention_bwd {label} {dtype}: "
                                 f"not on its route {route}")

            def hold(got, what):
                errs = []
                for name, g, t, e in zip(("out", "dq", "dk", "dv"), got,
                                         twin, exact):
                    top = float(e.abs().max())
                    err = float((g.float() - e).abs().max())
                    if dtype == "float32":
                        ok = err <= 1e-4 * top
                        errs.append(f"{name} {err:.3e} of {top:.3e}")
                    else:
                        ref = float((t.float() - e).abs().max())
                        ok = err <= 2 * ref + 1e-6 * top
                        errs.append(f"{name} {err:.3e} (twins {ref:.3e}, "
                                    f"{err / max(ref, 1e-30):.3f}x)")
                    if not ok:
                        raise SystemExit(f"flash_attention_bwd {label} "
                                         f"{dtype} {what} {name}: {err} "
                                         f"from fp32 ({errs[-1]})")
                return errs

            errs = hold(got, route)
            worst = max([worst] + [float((g.float() - t.float()).abs().max())
                                   for g, t in zip(got[1:], twin[1:])])
            path = choose_path(dt, *shape[1:3], *shape[4:6], shape[3],
                               dims=dims, grad=True)
            _, lse = flash_attention_cuda(q, k, v, causal, None,
                                          shape[6] ** -0.5, path,
                                          return_lse=True)
            _, lse_twin = _lse_twin(q, k, v, causal)
            lse_err = float((lse - lse_twin).abs().max())
            lse_tol = 2e-5 if dtype == "float32" else 1e-4
            log(f"flash_bwd: {label} {dtype} B={shape[1]} Sq={shape[2]} "
                f"Skv={shape[3]} H={shape[4]} KV={shape[5]} Dk={shape[6]} "
                f"Dv={shape[7]} causal={causal} forward path {path.kind}, "
                f"backward route {route}: against fp32 {'; '.join(errs)}; "
                f"lse max_abs_err {lse_err!r} (tol {lse_tol})")
            if not lse_err <= lse_tol:
                raise SystemExit(f"flash lse {label} {dtype}: {lse_err}")
            if label in ("d192", "d256"):
                _wide_forward(torch, cuda, shape, dt)
            timed = label in BWD_TIMED and (dtype == "bfloat16"
                                             or label == "train")
            if not timed:
                continue
            o, lse = flash_attention_cuda(q, k, v, causal, None,
                                          shape[6] ** -0.5, path,
                                          return_lse=True)
            scale = shape[6] ** -0.5
            routes = [route] + (["simt"] if route == "tc" else [])
            fns = [lambda r, rt=rt: flash_attention_bwd_cuda(
                q, k, v, o, lse, dout, causal, scale, route=rt)
                for rt in routes]
            if route == "tc":   # the CUDA-core kernel on this call, held too
                errs = hold((got[0], *fns[1](0)), "simt")
                log(f"flash_bwd: {label} {dtype}: the simt route on the "
                    f"same call: against fp32 {'; '.join(errs)}")
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                          for x in (q, k, v))
            dot = dout.transpose(1, 2).contiguous()
            gqa = shape[4] != shape[5]

            def sdpa(r):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=gqa)

            fns += [lambda r: torch.autograd.grad(sdpa(r), (qt, kt, vt), dot),
                    sdpa]
            for fn in fns:
                fn(0)
            *route_ms, fb_ms, f_ms = time_launches(
                torch, fns, 40 if label == "train" else 10)
            ms = route_ms[0]
            prof = _profile(torch, lambda: [fns[0](0) for _ in range(10)])
            dev = "not measured" if prof is None else ", ".join(
                f"{name.split('<')[0].split('::')[-1]} "
                f"{kernel_ms / count * 1e3:.2f}us a launch of {count} seen"
                for name, (count, kernel_ms) in sorted(prof.items())
                if "flash_bwd" in name)
            plain = ""
            if label == "train":
                o_t, lse_t = _lse_twin(q, k, v, causal)
                plain_ms = time_wall(torch, lambda: flash_attention_bwd_ref(
                    q, k, v, o_t, lse_t, dout, causal=causal), 3)
                plain = f"; plain {plain_ms:.3f}ms"
            peak = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
            bound, by, flops, nbytes = _bwd_bound(shape, q.element_size(),
                                                  peak)
            lib_ms = fb_ms - f_ms
            simt = (f"; the CUDA-core kernel (route simt) "
                    f"{route_ms[1] * 1e3:.2f}"
                    f"us, {route_ms[1] / ms:.2f}x" if route == "tc" else "")
            log(f"flash_bwd: {label} {dtype}: route {route} "
                f"{ms * 1e3:.2f}us a launch (device time by kernel, "
                f"profiler: {dev}), bound {bound * 1e3:.2f}us ({by}: "
                f"{flops:.3e} FLOP, {nbytes} bytes), {bound / ms:.4f} of it"
                f"{simt}{plain}; scaled_dot_product_attention backward "
                f"{lib_ms * 1e3:.2f}us (forward + backward "
                f"{fb_ms * 1e3:.2f}, forward {f_ms * 1e3:.2f}), "
                f"{ms / lib_ms:.2f}x of it")
            if dtype == "bfloat16" and label == "train":
                row = dict(name="flash_attention_bwd", route="cuda",
                           source=BWD_SOURCE, replaces=BWD_REPLACES, ms=ms,
                           plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                           library_ms=lib_ms, simt_ms=route_ms[1])
    row["max_abs_err"] = worst
    return row


def _train_setup(torch, cuda, arch=TRAIN_ARCH, **opt_kw):
    """``arch``'s published configuration (bf16, remat on), its train
    state from ``registry.init(cfg, seed=0)`` on the card, the launcher's
    optimizer and data (``SyntheticLM``, 8 × 128 tokens) and its step."""
    from repro_torch.configs import get_arch
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    cfg = get_arch(arch).full
    opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=10,
                        decay_steps=TRAIN_STEPS, **opt_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_train_state(cfg, opt_cfg, seed=0, device=cuda)
    torch.cuda.synchronize()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                  global_batch=TRAIN_B))
    return (cfg, state, data, make_train_step(cfg, opt_cfg), opt_cfg,
            time.perf_counter() - t0)


def _train_steps(torch, cuda, label, cfg, state, step_fn, data, steps,
                 tokens=TRAIN_B * TRAIN_S):
    """``steps`` steps through the launcher's loop (no checkpoint): each
    step's loss, grad norm, ms and tokens/s (``tokens`` a step) printed;
    returns the state and the per-step (loss, grad norm, seconds)."""
    from repro_torch.launch.train import train_loop

    rows = []
    state, _, _ = train_loop(cfg, state, step_fn, data, 0, steps, cuda,
                             on_step=_step_logger(label, tokens, rows),
                             log=lambda line: None)
    return state, rows


def _step_logger(label, tokens, rows):
    """The launcher's ``on_step``: appends each step's (loss, grad norm,
    seconds) to ``rows`` and prints them with ms and tokens/s (``tokens``
    a step); a loss or grad norm that is not finite raises."""
    def on_step(step, metrics, seconds):
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        rows.append((loss, gnorm, seconds))
        log(f"{label}: step {step} loss {loss!r} grad_norm {gnorm!r} "
            f"{seconds * 1e3:.2f}ms {tokens / seconds:.1f} tokens/s")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise SystemExit(f"{label}: step {step} loss {loss} grad_norm "
                             f"{gnorm}")
    return on_step


def run_train_main(torch, np, cuda, out):
    """Slice 16's main path: internlm2-1.8b at its published widths and
    depth, bf16, trained for ``TRAIN_STEPS`` steps through the
    launcher's loop on the launcher's default batch, fp32 moments, remat
    on, no checkpoint I/O.  Every attention layer's forward runs on the
    tensor-core kernel with its lse (twice a step: the first run and the
    recomputation), its gradient on ``flash_attention_bwd``; the last
    loss must be below the first."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.kernel import PATH_LAUNCHES
    from repro_torch.models.common import param_count_tree

    t_phase = time.perf_counter()
    cfg, state, data, step_fn, opt_cfg, init_s = _train_setup(torch, cuda)
    n = param_count_tree(state["params"])
    torch.cuda.reset_peak_memory_stats()
    state, rows = _train_steps(torch, cuda, "train", cfg, state, step_fn,
                               data, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    fwd, bwd = kernels.LAUNCHES["flash_attention"], \
        kernels.LAUNCHES["flash_attention_bwd"]
    want_fwd = 2 * cfg.n_layers * TRAIN_STEPS
    if (fwd, bwd, PATH_LAUNCHES["tc"]) != (want_fwd, want_fwd // 2,
                                           want_fwd):
        raise SystemExit(f"train: {fwd} forward launches ({PATH_LAUNCHES}) "
                         f"and {bwd} backward, expected {want_fwd} on tc "
                         f"and {want_fwd // 2}")
    losses = [r[0] for r in rows]
    if not losses[-1] < losses[0]:
        raise SystemExit(f"train: the loss did not fall: {losses}")
    warm = sorted(r[2] for r in rows[1:])
    med = warm[len(warm) // 2]
    log(f"train: {cfg.name} at published widths ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n} "
        f"parameters, bf16, fp32 moments, remat {cfg.remat}; init "
        f"{init_s:.2f}s) B={TRAIN_B} S={TRAIN_S}, {TRAIN_STEPS} steps: "
        f"loss {losses[0]!r} -> {losses[-1]!r}; warm step median "
        f"{med * 1e3:.2f}ms = {TRAIN_B * TRAIN_S / med:.1f} tokens/s "
        f"(steps 1-{TRAIN_STEPS - 1}: {min(warm) * 1e3:.2f}-"
        f"{max(warm) * 1e3:.2f}ms); flash forward launches {fwd} (all tc, "
        f"{PATH_LAUNCHES['tc']}), backward launches {bwd}; peak device "
        f"memory {peak:.2f} GiB")
    out.update(cfg=cfg, state=state, data=data, step_fn=step_fn,
               opt_cfg=opt_cfg, rows=rows, t0=t_phase)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _grads_vs_twins(torch, label, cfg, params, batch):
    """One step's loss and gradient norm through the kernels and through
    the twins (``train_twins``) on the same parameters and batch."""
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import value_and_grads

    res = []
    for twins in (False, True):
        with train_twins() if twins else contextlib.nullcontext():
            loss, _, grads = value_and_grads(cfg, params, batch)
            res.append((float(loss), float(global_norm(grads.values()))))
            del grads
    (lk, gk), (lt, gt) = res
    log(f"{label}: one step through the kernels vs the twins: loss "
        f"{lk!r} / {lt!r} ({_rel(lk, lt):.3e} relative, limit "
        f"{TRAIN_LOSS_RTOL}), grad norm {gk!r} / {gt!r} ({_rel(gk, gt):.3e}, "
        f"limit {TRAIN_GNORM_RTOL})")
    if not (_rel(lk, lt) <= TRAIN_LOSS_RTOL
            and _rel(gk, gt) <= TRAIN_GNORM_RTOL):
        raise SystemExit(f"{label}: kernels and twins part")


def _preempt_and_resume(torch):
    """``launch.train.main`` on the card at the smoke config, whole and
    with a SIGTERM after step 3 then resumed: the two end with the same
    parameters and optimizer state, bit for bit.  Checkpoints under
    ``build/train_smoke/`` (removed after)."""
    import shutil
    import signal

    from repro_torch.launch import train as launch

    root = os.path.join(HERE, "build", "train_smoke")
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "7", "--seq", "32",
            "--ckpt-every", "100"]

    def stop_after_3(step, metrics, seconds):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    with contextlib.redirect_stdout(sys.stderr):
        whole = launch.main(argv + ["--ckpt-dir", f"{root}/whole"])
        cut = launch.main(argv + ["--ckpt-dir", f"{root}/cut"],
                          on_step=stop_after_3)
        cut_step = int(cut["opt"]["step"])
        resumed = launch.main(argv + ["--ckpt-dir", f"{root}/cut"])
    shutil.rmtree(root, ignore_errors=True)
    a = dict(whole["params"].named_parameters())
    b = dict(resumed["params"].named_parameters())
    same = all(torch.equal(a[n], b[n]) for n in a) and all(
        torch.equal(x, y) for part in ("m", "v")
        for x, y in zip(whole["opt"][part].values(),
                        resumed["opt"][part].values()))
    log(f"train: launch.train.main at {TRAIN_ARCH}'s smoke on the card: "
        f"SIGTERM after step 3 (checkpoint of {cut_step} steps), resumed to "
        f"{int(resumed['opt']['step'])}: parameters and moments "
        f"{'equal' if same else 'DIFFER from'} the uninterrupted run's, bit "
        f"for bit")
    if not (same and cut_step == 4):
        raise SystemExit("train: the resumed run parts from the whole one")


# the step's kernels by kind, matched on their names in this order
STEP_KINDS = (("flash_fwd", ("flash_fwd",)), ("flash_bwd", ("flash_bwd",)),
              ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "cublas")),
              ("elementwise", ("elementwise",)), ("reduce", ("reduce",)))


def _kinds(prof) -> str:
    """A profile's device ms and kernels by ``STEP_KINDS`` (the rest as
    "other")."""
    out: dict = {}
    for name, (n, ms) in prof.items():
        kind = next((k for k, subs in STEP_KINDS
                     if any(t in name for t in subs)), "other")
        c, t = out.get(kind, (0, 0.0))
        out[kind] = (c + n, t + ms)
    return ", ".join(f"{k} {t:.3f}ms x{c}" for k, (c, t) in out.items())


def _step_breakdown(torch, label, cfg, state, opt_cfg, batch):
    """The step's three parts, the forward (``loss_fn``), the backward
    (``autograd.grad``, recomputing each block) and the optimizer
    (``adamw_update``): host ms with a synchronise after each, then, on
    the next step, each part's device ms and kernels by kind under the
    profiler."""
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.train_step import loss_fn

    params = state["params"]
    names, leaves = zip(*params.named_parameters())
    box = {}
    parts = {
        "forward": lambda: box.update(loss=loss_fn(cfg, params, batch)[0]),
        "backward": lambda: box.update(grads=dict(zip(
            names, torch.autograd.grad(box.pop("loss"), leaves)))),
        "optimizer": lambda: state.update(opt=adamw_update(
            opt_cfg, params, box.pop("grads"), state["opt"])[0])}
    wall = {}
    for part, fn in parts.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall[part] = (time.perf_counter() - t0) * 1e3
    profs = {part: _profile(torch, fn) for part, fn in parts.items()}
    total = sum(wall.values())
    if any(p is None for p in profs.values()):
        log(f"{label}: step in parts (host ms): {json.dumps(wall)}; device "
            f"profile: not measured")
        return
    busy = {k: sum(ms for _, ms in p.values()) for k, p in profs.items()}
    log(f"{label}: step in parts, host ms (a synchronise after each): "
        + ", ".join(f"{k} {v:.2f}" for k, v in wall.items())
        + f" ({total:.2f} in all); device busy "
        + ", ".join(f"{k} {v:.3f}ms" for k, v in busy.items())
        + f" ({sum(busy.values()):.3f}ms = {sum(busy.values()) / total:.3f} "
        f"of the parts' host time), kernels "
        + ", ".join(f"{k} {sum(n for n, _ in p.values())}"
                    for k, p in profs.items()))
    for part, prof in profs.items():
        log(f"{label}: {part} by kind: {_kinds(prof)}; top: "
            + "; ".join(f"{k[:110]} {ms:.2f}ms x{n}" for k, (n, ms) in
                        sorted(prof.items(), key=lambda kv: -kv[1][1])[:3]))


def run_train_checks(torch, np, cuda, main):
    """Off the counted path: the backward kernel against its twin at
    ``BWD_SHAPES`` and its timings (``check_flash_bwd``); one full-width
    step through the kernels against the twins (loss, grad norm);
    the step in parts and its device profile; ``grad_accum`` 2 against 1;
    3 steps with int8 moments (steps 0 and 1's losses equal to the
    fp32-moment run's, step 2's finite and its distance shown);
    whisper-base
    at full width, one step (the encoder's and cross-attention's
    non-causal backward, Skv 1 500) and against its twins; ``main()``
    preempted and resumed.  Returns the backward's JSON row."""
    from repro_torch.launch.train import make_batch
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import value_and_grads

    cfg, state, data = main["cfg"], main["state"], main["data"]
    batch = make_batch(cfg, data.get_batch(TRAIN_STEPS), cuda)
    _grads_vs_twins(torch, "train", cfg, state["params"], batch)
    _step_breakdown(torch, "train", cfg, state, main["opt_cfg"], batch)
    res = {}
    for accum in (1, 2):
        loss, _, grads = value_and_grads(cfg, state["params"], batch, accum)
        res[accum] = (float(loss), float(global_norm(grads.values())))
        del grads
    (l1, g1), (l2, g2) = res[1], res[2]
    log(f"train: grad_accum 2 against 1 on one batch: loss {l2!r} / {l1!r} "
        f"({_rel(l2, l1):.3e} relative, limit {TRAIN_LOSS_RTOL}), grad norm "
        f"{g2!r} / {g1!r} ({_rel(g2, g1):.3e}, limit {TRAIN_GNORM_RTOL})")
    if not (_rel(l2, l1) <= TRAIN_LOSS_RTOL
            and _rel(g2, g1) <= TRAIN_GNORM_RTOL):
        raise SystemExit("train: grad_accum 2 parts from 1")
    rows = main["rows"]
    del state, batch
    main.pop("state")
    torch.cuda.empty_cache()

    # the first update reads the fp32 moments it has just made and
    # quantizes them after, so the first two losses equal the fp32-moment
    # run's and the third is the first the int8 codes move; a v code
    # rounds to 0 where g² is under 1/254 of its block's largest (|g|
    # under 1/16 of it), so that element's v keeps no history (the
    # reference's linear absmax codes)
    cfg, state, data, step_fn, _, _ = _train_setup(torch, cuda,
                                                   moment_dtype="int8")
    state, rows8 = _train_steps(torch, cuda, "train int8", cfg, state,
                                step_fn, data, 3)
    m, v = state["opt"]["m"], state["opt"]["v"]
    bare = sum(int(((v[n]["q"] == 0) & (m[n]["q"] != 0)).sum()) for n in m)
    total = sum(v[n]["q"].numel() for n in v)
    log(f"train: int8 moments, 3 steps: losses {[r[0] for r in rows8]} "
        f"against fp32 moments' {[r[0] for r in rows[:3]]} (the first two "
        f"equal; the third {_rel(rows8[2][0], rows[2][0]):.3e} relative "
        f"from it, shown); elements whose v code is 0 and m code is not: "
        f"{bare} of {total} ({bare / total:.4f})")
    if not (rows8[0][0] == rows[0][0] and rows8[1][0] == rows[1][0]
            and math.isfinite(rows8[2][0])):
        raise SystemExit("train: int8 moments part from fp32 moments")
    del state
    torch.cuda.empty_cache()

    wcfg, wstate, wdata, wstep, _, _ = _train_setup(torch, cuda,
                                                     "whisper-base")
    from repro_torch import kernels

    before = dict(kernels.LAUNCHES)
    wstate, wrows = _train_steps(torch, cuda, "train whisper", wcfg, wstate,
                                 wstep, wdata, 1)
    grew = {k: kernels.LAUNCHES[k] - before[k]
            for k in ("flash_attention", "flash_attention_bwd")}
    layers = wcfg.enc_layers + 2 * wcfg.n_layers
    log(f"train: whisper-base at published widths, one step: flash launches "
        f"{grew} (expected {2 * layers} forward with remat, {layers} "
        f"backward)")
    if grew != {"flash_attention": 2 * layers, "flash_attention_bwd": layers}:
        raise SystemExit("train whisper: launches")
    _grads_vs_twins(torch, "train whisper", wcfg, wstate["params"],
                    make_batch(wcfg, wdata.get_batch(1), cuda))
    del wstate
    torch.cuda.empty_cache()

    row = check_flash_bwd(torch, np, cuda)
    _preempt_and_resume(torch)
    log(f"train: phase {time.perf_counter() - main['t0']:.1f}s")
    return row


# --------------------------------------------------------------------- #
# slice 17: Jamba trained on the card, the scan's backward; the examples
# --------------------------------------------------------------------- #
HYBRID_STEPS = 6
HYBRID_B, HYBRID_S = 2, 1024
# the launcher's command: Jamba cut as for serving (one super-block, no
# experts), int8 moments (18.0 GB of bf16 weights, 18.0 of gradients,
# ~18 of moments), no checkpoint; the peak lr a tenth of the launcher's
# default: at d 8 192 an Adam step of 1e-4 .. 6e-4 in the 10-step warmup
# moved the loss up from step 2 on and the gradient norm from 4.6 to
# 5 241
HYBRID_ARGV = ["--arch", JAMBA, "--layers", "8", "--experts", "0",
               "--moments", "int8", "--peak-lr", "1e-4", "--global-batch",
               str(HYBRID_B), "--seq", str(HYBRID_S), "--steps",
               str(HYBRID_STEPS), "--ckpt-every", "0", "--device", "cuda"]
SCAN_BWD_SOURCE = "src/repro_torch/kernels/csrc/selective_scan_bwd.cu"
SCAN_BWD_REPLACES = "src/repro/models/layers/recurrent.py:110-123"
# (label, B, S, Di, Ds, with h0, with dh_last): the training call (h0 and
# dh_last absent, as the layer calls it; given), ragged ones (Di not a
# block multiple, S not a chunk multiple, Ds 5 and 1)
SCAN_BWD_SHAPES = (
    ("train", HYBRID_B, HYBRID_S, 16384, 16, False, False),
    ("train, h0, dh_last", HYBRID_B, HYBRID_S, 16384, 16, True, True),
    ("ragged", 2, 37, 100, 16, True, False),
    ("ragged, Ds 5", 1, 29, 130, 5, False, True),
    ("ragged, Ds 1", 3, 9, 33, 1, True, True),
)
# each gradient within 1e-4 of its largest |value|: dB, dC and dA sum
# over Di, S and B in another order than the twin's
SCAN_BWD_TOL = 1e-4
# the walk's float instructions a state (csrc/selective_scan_bwd.cu's
# header), beside the recomputed forward's (5 and expf's own)
SCAN_BWD_WALK = 15


def _scan_bwd_bound(shape, expf):
    """Least time for the gradient on this run's inputs, the largest of
    four terms: delta, x, dy, A, B, C, h0 and dh_last read once, ddelta,
    dx, dA, dB, dC and dh0 written once, over HBM's rate; one exp a state
    (b, t, channel, n) on the special-function units (the states
    recomputed: the gradient needs h_{t-1} and exp(Δ_t A) at every
    state); float32 instructions, the forward's 5 a state and expf's own
    plus the walk's ``SCAN_BWD_WALK``; and all of these as warp
    instructions at one a scheduler a clock."""
    _, b, s, di, ds, h0, dh = shape
    nbytes = 4 * (5 * b * s * di + 2 * di * ds + 4 * b * s * ds
                  + (1 + int(h0) + int(dh)) * b * di * ds)
    states = b * s * di * ds
    f32_per_exp = sum(n for op, n in expf.items()
                      if op.split(".")[0] in ("FFMA", "FADD", "FMUL",
                                              "FSETP", "FSEL", "FMNMX"))
    all_per_exp = sum(expf.values())
    f32 = (5 + f32_per_exp + SCAN_BWD_WALK) * states
    warp = (5 + all_per_exp + SCAN_BWD_WALK) * states / 32
    terms = {"sfu": states / SFU_OPS_PER_S * 1e3,
             "f32": f32 / F32_OPS_PER_S * 1e3,
             "issue": warp / WARP_ISSUE_PER_S * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    top = max(terms, key=terms.get)
    return terms[top], ("bytes" if top == "bytes" else "operations"), terms


def check_scan_bwd(torch, np, cuda):
    """``selective_scan_bwd``, walked back from the checkpoints the forward
    kernel writes as the training path asks it to, at ``SCAN_BWD_SHAPES``
    against its twin (``selective_scan_bwd_ref``) and against autograd of
    the forward twin, both on the card: every gradient within
    ``SCAN_BWD_TOL`` of its largest |value|; a second run bit for bit; the
    forward's y and h_last with and without checkpoints bit for bit; at
    the training shape µs a launch (events) beside the twin and the bound,
    and the forward with and without checkpoints.  Returns the JSON
    row."""
    from repro_torch.kernels.mamba_scan import (selective_scan_bwd_ref,
                                                selective_scan_ref)
    from repro_torch.kernels.mamba_scan.kernel import (
        selective_scan_bwd_cuda, selective_scan_cuda)

    expf, _ = _scan_sass()
    names = ("ddelta", "da", "db", "dc", "dx", "dh0")
    worst, row = 0.0, None
    for shape in SCAN_BWD_SHAPES:
        label, b, s, di, ds, with_h0, with_dh = shape
        delta, a, bm, cm, x, h0 = _scan_case(
            torch, cuda, (label, b, s, di, ds, with_h0), len(label))
        gen = torch.Generator(device=cuda).manual_seed(len(label) + 1)
        dy = torch.randn((b, s, di), generator=gen, device=cuda)
        dh = (torch.randn((b, di, ds), generator=gen, device=cuda)
              if with_dh else None)
        y, h, ckpt = selective_scan_cuda(delta, a, bm, cm, x, h0, ckpt=True)
        y_plain, h_plain = selective_scan_cuda(delta, a, bm, cm, x, h0)
        if not (torch.equal(y, y_plain) and torch.equal(h, h_plain)):
            raise SystemExit(f"selective_scan {label}: writing checkpoints "
                             f"moved y or h_last")
        del y, h, y_plain, h_plain
        args = (delta, a, bm, cm, x, ckpt, dy, dh)
        got = selective_scan_bwd_cuda(*args)
        again = selective_scan_bwd_cuda(*args)
        same = all(torch.equal(p, q) for p, q in zip(got, again))
        del again
        twin = selective_scan_bwd_ref(delta, a, bm, cm, x, h0, dy, dh)
        leaves = [t.clone().requires_grad_(True)
                  for t in (delta, a, bm, cm, x, h0) if t is not None]
        y, h = selective_scan_ref(*leaves[:5], leaves[5] if with_h0 else None)
        auto = torch.autograd.grad((y, h), leaves, (
            dy, torch.zeros_like(h) if dh is None else dh))
        del y, h, leaves
        torch.cuda.synchronize()
        errs = []
        for i, name in enumerate(names):
            if name == "dh0" and not with_h0:
                continue
            top = float(twin[i].abs().max())
            e_twin = float((got[i] - twin[i]).abs().max())
            e_auto = float((got[i] - auto[i]).abs().max())
            worst = max(worst, e_twin)
            errs.append(f"{name} {e_twin:.3e} / {e_auto:.3e} of {top:.3e}")
            if not max(e_twin, e_auto) <= SCAN_BWD_TOL * max(top, 1e-30):
                raise SystemExit(f"selective_scan_bwd {label} {name}: "
                                 f"{e_twin!r} (twin), {e_auto!r} (autograd) "
                                 f"of {top!r}")
        log(f"scan_bwd: {label} B={b} S={s} Di={di} Ds={ds} h0="
            f"{'given' if with_h0 else 'zero'} dh_last="
            f"{'given' if with_dh else 'absent'}: against the twin / "
            f"autograd of the forward twin: {'; '.join(errs)} (limit "
            f"{SCAN_BWD_TOL} of the largest); a second run "
            f"{'bit for bit' if same else 'DIFFERS'}")
        if not same:
            raise SystemExit(f"selective_scan_bwd {label}: two runs differ")
        del auto
        if label != "train":
            del got, twin, ckpt
            continue
        ms, fwd_ms, fwd_ckpt_ms = time_launches(torch, [
            lambda r: selective_scan_bwd_cuda(*args),
            lambda r: selective_scan_cuda(delta, a, bm, cm, x, h0),
            lambda r: selective_scan_cuda(delta, a, bm, cm, x, h0,
                                          ckpt=True)], 10)
        log(f"scan_bwd: {label}: the forward {fwd_ms * 1e3:.2f}us, writing "
            f"the checkpoints {fwd_ckpt_ms * 1e3:.2f}us (events)")
        prof = _profile(torch, lambda: [selective_scan_bwd_cuda(*args)
                                        for _ in range(3)])
        dev = "not measured" if prof is None else ", ".join(
            f"{re.search(r'selective_scan_bwd_[a-z]+', k).group(0)} "
            f"{t / n * 1e3:.2f}us x{n}"
            for k, (n, t) in sorted(prof.items()) if "selective_scan" in k)
        plain_ms = time_wall(torch, lambda: selective_scan_bwd_ref(
            delta, a, bm, cm, x, h0, dy, dh), 1)
        bound, by, terms = _scan_bwd_bound(shape, expf)
        log(f"scan_bwd: {label}: {ms * 1e3:.2f}us a launch (device time by "
            f"kernel, profiler: {dev}); bound {bound * 1e3:.2f}us ({by}; "
            "terms in us: " + ", ".join(f"{k} {v * 1e3:.2f}"
                                        for k, v in terms.items())
            + f"), {bound / ms:.4f} of it; plain {plain_ms:.3f}ms")
        row = dict(name="selective_scan_bwd", route="cuda",
                   source=SCAN_BWD_SOURCE, replaces=SCAN_BWD_REPLACES, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   library_ms=None, forward_ckpt_ms=fwd_ckpt_ms - fwd_ms)
        del got, twin, args, delta, x, dy, ckpt
        torch.cuda.empty_cache()
    row["max_abs_err"] = worst
    return row


def run_train_hybrid_main(torch, np, cuda, out):
    """Slice 17's main path: Jamba at its published widths, one
    super-block (7 Mamba + 1 attention layer), no experts, bf16, remat on,
    int8 moments, trained for ``HYBRID_STEPS`` steps of B 2 × S 1 024 by
    the launcher, ``launch.train.main(HYBRID_ARGV)``, no checkpoint I/O.
    Each Mamba layer's scan runs its kernel twice a step (the first run
    and the recomputation) and its gradient ``selective_scan_bwd`` (two
    kernels) once; the attention layer the tc forward with its lse and
    ``flash_attention_bwd``; the last loss must be below the first."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.kernel import PATH_LAUNCHES
    from repro_torch.launch import train as launch
    from repro_torch.models.common import param_count_tree

    t_phase = time.perf_counter()
    cfg, opt_cfg, data = launch.setup(launch.parse_args(HYBRID_ARGV))
    rows, first = [], []
    on_step = _step_logger("train_hybrid", HYBRID_B * HYBRID_S, rows)

    def timed(step, metrics, seconds):
        if not first:       # the first step's start
            first.append(time.perf_counter() - seconds)
        on_step(step, metrics, seconds)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = launch.main(HYBRID_ARGV, on_step=timed)     # prints its lines
    peak = torch.cuda.max_memory_allocated() / 2**30
    init_s = first[0] - t0
    n = param_count_tree(state["params"])
    mamba = cfg.n_layers - cfg.n_layers // cfg.attn_period
    attn = cfg.n_layers // cfg.attn_period
    want = {"selective_scan": 2 * mamba * HYBRID_STEPS,
            "selective_scan_bwd": mamba * HYBRID_STEPS,
            "selective_scan_bwd_reduce": mamba * HYBRID_STEPS,
            "flash_attention": 2 * attn * HYBRID_STEPS,
            "flash_attention_bwd": attn * HYBRID_STEPS}
    got = {k: kernels.LAUNCHES[k] for k in want}
    if got != want or PATH_LAUNCHES["tc"] != want["flash_attention"]:
        raise SystemExit(f"train_hybrid: launches {got} ({PATH_LAUNCHES}), "
                         f"expected {want}, all flash forwards on tc")
    losses = [r[0] for r in rows]
    if len(rows) != HYBRID_STEPS or not losses[-1] < losses[0]:
        raise SystemExit(f"train_hybrid: the loss did not fall: {losses}")
    warm = sorted(r[2] for r in rows[1:])
    med = warm[len(warm) // 2]
    log(f"train_hybrid: {cfg.name} at published widths, "
        f"{' '.join(HYBRID_ARGV[2:8])} ({cfg.n_layers} layers: {mamba} "
        f"Mamba + {attn} attention; d {cfg.d_model}, Di "
        f"{cfg.mamba_expand * cfg.d_model}, Ds {cfg.mamba_d_state}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}; {n} parameters, bf16, int8 "
        f"moments, peak lr {opt_cfg.peak_lr}, remat {cfg.remat}; set-up to "
        f"the first step {init_s:.2f}s) B={HYBRID_B} S={HYBRID_S}, "
        f"{HYBRID_STEPS} steps: loss {losses[0]!r} -> {losses[-1]!r}; warm "
        f"step median {med * 1e3:.2f}ms = {HYBRID_B * HYBRID_S / med:.1f} "
        f"tokens/s (steps 1-{HYBRID_STEPS - 1}: {min(warm) * 1e3:.2f}-"
        f"{max(warm) * 1e3:.2f}ms); launches {json.dumps(got)}; peak device "
        f"memory (set-up and steps) {peak:.2f} GiB")
    out.update(cfg=cfg, state=state, data=data, opt_cfg=opt_cfg, t0=t_phase)


def run_train_hybrid_checks(torch, np, cuda, main):
    """Off the counted path: one step's loss and gradient norm through
    the kernels against the twins of all four (``train_twins``) on the
    trained weights, the step in parts and its device profile, then the
    backward kernel against its twins (``check_scan_bwd``).  Returns its
    JSON row."""
    from repro_torch.launch.train import make_batch

    cfg, state = main["cfg"], main["state"]
    batch = make_batch(cfg, main["data"].get_batch(HYBRID_STEPS), cuda)
    _grads_vs_twins(torch, "train_hybrid", cfg, state["params"], batch)
    _step_breakdown(torch, "train_hybrid", cfg, state, main["opt_cfg"],
                    batch)
    del state, batch
    main.pop("state")
    torch.cuda.empty_cache()
    row = check_scan_bwd(torch, np, cuda)
    log(f"train_hybrid: phase {time.perf_counter() - main['t0']:.1f}s")
    return row


EXAMPLES_TRAIN = ["--preset", "100m", "--steps", "20"]
EXAMPLES_ICI_SIDE = 16


def run_examples(torch, np, cuda):
    """The reference's four example programs on the port, on the card, at
    their defaults unless named: ``train_lm --preset 100m --steps 20``
    (fp32: attention's CUDA-core forward with its lse and its backward),
    ``serve_decode`` (internlm2-1.8b's smoke config), ``quickstart``
    (8 000 cycles), ``qstar_ici_demo`` (torus 16x16).  Each one's lines go
    to the log, with its wall; the train loss must fall and every output
    be finite."""
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.examples import (qstar_ici_demo, quickstart,
                                      serve_decode, train_lm)

    root = os.path.join(HERE, "build", "examples_smoke")
    shutil.rmtree(root, ignore_errors=True)

    def run(label, fn, *args, **kw):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = fn(*args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            if line.strip():
                log(f"examples: {label}: {line}")
        log(f"examples: {label}: wall {wall:.2f}s")
        return res

    rows = []
    run("train_lm", train_lm.main, EXAMPLES_TRAIN + [
        "--ckpt-dir", os.path.join(root, "ckpt")],
        on_step=lambda step, m, s: rows.append((float(m["loss"]), s)))
    shutil.rmtree(root, ignore_errors=True)
    warm = sorted(s for _, s in rows[1:])
    log(f"examples: train_lm 100m: loss {rows[0][0]!r} -> {rows[-1][0]!r}, "
        f"warm step median {warm[len(warm) // 2] * 1e3:.2f}ms")
    if not (math.isfinite(rows[-1][0]) and rows[-1][0] < rows[0][0]):
        raise SystemExit(f"examples: train_lm's loss {rows}")
    toks = run("serve_decode", serve_decode.main, [])
    vocab = get_arch("internlm2-1.8b").smoke.vocab
    if toks.shape != (4, 24) or not ((toks >= 0) & (toks < vocab)).all():
        raise SystemExit(f"examples: serve_decode tokens {toks}")
    _, r_xy, r_bd = run("quickstart", quickstart.main)
    if not all(math.isfinite(v) for v in (r_xy.lcv, r_bd.lcv,
                                          r_xy.throughput, r_bd.throughput)):
        raise SystemExit("examples: quickstart's statistics")
    loads, stale, new = run("qstar_ici_demo", qstar_ici_demo.main,
                            side=EXAMPLES_ICI_SIDE)
    if not (loads["Q-StaR BiDOR-G"][0] <= loads["XY (DOR)"][0]
            and new <= stale):
        raise SystemExit(f"examples: qstar_ici_demo {loads} {stale} {new}")


def _time_simstep_variants(torch, np, cuda):
    """What each routing algorithm costs the chunk kernel a cycle at 5x5
    and 32x32, the zoo's router shapes, and the instrumented instance."""
    from repro_torch.core import (express_mesh, mesh2d, mesh2d_edge_io,
                                  multipod, torus)
    from repro_torch.noc import Algo

    for topo, label in ((mesh2d_edge_io(5, 5), "5x5"),
                        (mesh2d(32, 32), "32x32")):
        for algo in ("YX", "O1TURN", "VALIANT", "ROMM", "ODDEVEN", "BIDOR"):
            time_simstep(torch, np, cuda, topo, label,
                         algo=Algo[algo])
    for topo, label in ((torus(4, 4, 4), "torus4x4x4"),
                        (express_mesh(8, 8), "express8x8"),
                        (multipod(2, 16, 16), "multipod2x16x16"),
                        (torus(17, 17), "torus17x17"),
                        (express_mesh(17, 17), "express17x17")):
        time_simstep(torch, np, cuda, topo, label)
    for topo, label in ((mesh2d_edge_io(5, 5), "5x5"),
                        (mesh2d(32, 32), "32x32")):
        time_simstep(torch, np, cuda, topo, f"{label} instrumented",
                     watchdog=True, telemetry=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.core import mesh2d, mesh2d_edge_io

    cuda = torch.device("cuda")
    t_all = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log("mode: " + ("--full, every check" if FULL else
                    "default; with --full also " + "; ".join(FULL_ONLY)))

    secs = build.build()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} s "
        f"into {build.build_dir()}")
    for name in build.SOURCES:
        for line in build.ptxas_report(name).splitlines():
            spills = "spill" in line and " 0 bytes spill stores" not in line
            if "registers" in line or spills:
                log(f"build: {name}: {line.strip()}")

    sass = _poss_sass()
    log(f"kernels: possibility's 8 x 4 loops (cuobjdump -sass), a triple's "
        f"instructions by kind and in all: {json.dumps(sass)}")
    poss = check_possibility(torch, np, cuda, sass)
    weights, weights_ms = check_possibility_weights(torch, np, cuda, sass)
    simstep_err = check_simstep(torch, np, cuda)
    check_simstep_zoo(torch, np, cuda, simstep_err)
    check_instrumented(torch, np, cuda, simstep_err)
    flash = check_flash(torch, np, cuda)
    scan = check_scan(torch, np, cuda)

    # each main path runs with the counts from 0 and must launch every
    # kernel it goes through
    serve, jamba, paper, dense = {}, {}, {}, {}
    paths = {
        "slice 1 (plan, flit step, campaign)": (
            ("possibility_v", "simstep_chunk", "simstep_grid"),
            lambda: (check_golden(torch, np, cuda),
                     paper.update(res=run_paper(torch, np, cuda)),
                     run_scale(torch, np, cuda))),
        "slice 2 (N-Rank oracle, fig1, control plane)": (
            ("possibility_weights", "possibility_v", "simstep_chunk"),
            lambda: (run_fig1(torch, np, cuda,
                              run_nrank(torch, np, cuda, weights_ms)),
                     run_ctrl(torch, np, cuda))),
        "slice 3 (whisper-base serving)": (
            ("flash_attention",),
            lambda: run_serve_main(torch, np, cuda, serve)),
        "slice 4 (jamba hybrid serving)": (
            ("selective_scan", "flash_attention"),
            lambda: run_jamba_main(torch, np, cuda, jamba)),
        "slice 10 (routing algorithms, traces)": (
            ("possibility_v", "simstep_chunk"),
            lambda: (check_algos_golden(torch, np, cuda),
                     run_fig8(torch, np, cuda),
                     run_table1(torch, np, cuda),
                     run_fig9(torch, np, cuda))),
        "slice 11 (topology zoo, watchdog, telemetry)": (
            ("possibility_v", "simstep_chunk", "simstep_grid"),
            lambda: (check_zoo_golden(torch, np, cuda),
                     run_topo_sweep(torch, np, cuda),
                     run_multipod(torch, np, cuda),
                     run_instrumented_cell(torch, np, cuda))),
        "slice 12 (campaign service)": (
            ("possibility_v", "possibility_weights", "simstep_chunk"),
            lambda: run_service(torch, np, cuda, paper)),
        "slice 13a (ML traffic from recorded HLO)": (
            ("possibility_v", "possibility_weights", "simstep_chunk"),
            lambda: run_mltraffic(torch, np, cuda)),
        "slice 13b (internlm2-1.8b serving)": (
            ("flash_attention",),
            lambda: run_dense_main(torch, np, cuda, dense))}
    # whisper and Jamba run attention's split kernel and its combine
    # (decode, cross-attention) and the tensor-core kernel (encoder,
    # prefill); internlm2's 16-token prompts and its decode steps over a
    # 48-row cache take the split kernel in one key range (no combine);
    # flash_attention counts one launch per call whatever its path, the
    # path counts each kernel
    flash_paths = {"slice 13b (internlm2-1.8b serving)": ("split",)}
    # a path's flash backward calls all take one route: tc in bf16, simt
    # in fp32 (the examples' train_lm)
    bwd_routes = {}
    bwd_launches = {k: 0 for k in flash_kernel.BWD_PATH_LAUNCHES}
    launches = {k: 0 for k in kernels.LAUNCHES}
    sizes = {"possibility_v": {}, "possibility_weights": {}}

    def drive_path(label, needed, drive):
        kernels.reset_launches()
        flash_kernel.reset_path_launches()
        drive()
        counts = dict(kernels.LAUNCHES)
        log(f"main path {label} launches: {json.dumps(counts)}")
        by_size = {}
        for (name, n, c), k in sorted(kernels.LAUNCH_SIZES.items()):
            by_size[f"{name} N={n} C={c}"] = k
            at = sizes[name].setdefault(f"N={n} C={c}", [])
            at.append(f"{k} ({label.split(' (')[0]})")
        if by_size:
            log(f"main path {label} possibility launches by size: "
                f"{json.dumps(by_size)}")
        missing = [k for k in needed if counts[k] <= 0]
        if "flash_attention" in needed:
            per_path = dict(flash_kernel.PATH_LAUNCHES)
            log(f"main path {label} flash_attention kernels by path: "
                f"{json.dumps(per_path)}")
            missing += [f"flash_attention {p}" for p in flash_paths.get(
                label, ("split", "combine", "tc")) if per_path[p] <= 0]
        if "flash_attention_bwd" in needed:
            by_route = dict(flash_kernel.BWD_PATH_LAUNCHES)
            log(f"main path {label} flash_attention_bwd calls by route: "
                f"{json.dumps(by_route)}")
            if by_route[bwd_routes[label]] != counts["flash_attention_bwd"]:
                missing.append(f"flash_attention_bwd {bwd_routes[label]}")
            for k, v in by_route.items():
                bwd_launches[k] += v
        if missing:
            raise SystemExit(f"kernels never launched on the main path "
                             f"{label}: {missing}")
        for k, v in counts.items():
            launches[k] += v

    for label, (needed, drive) in paths.items():
        drive_path(label, needed, drive)

    whisper_e2e = run_serve_checks(torch, np, cuda, serve)
    serve.clear()
    jamba_e2e = run_jamba_checks(torch, np, cuda, jamba)
    jamba.clear()
    torch.cuda.empty_cache()
    run_dense_checks(torch, np, cuda, dense)
    # slice 14's paths come after the others have freed their weights:
    # qwen2-moe's 28.6 GB, then dbrx's 54.6 and Jamba's 51.8 in its checks
    # (every one of its flash launches on the split path, in one range)
    for label, drive, checks in (
            ("slice 14a (qwen2-moe-a2.7b serving)", run_moe_main,
             run_moe_checks),
            ("slice 14b (minicpm3-4b serving, MLA)", run_mla_main,
             run_mla_checks)):
        flash_paths[label] = ("split",)
        out = {}
        drive_path(label, ("flash_attention",),
                   lambda: drive(torch, np, cuda, out))
        checks(torch, np, cuda, out)
        del out
        torch.cuda.empty_cache()
    # slice 15's: qwen2-vl-2b (3.55 GB), its prefill's 96 packed rows on
    # the tensor-core kernel and its steps split; xlstm-1.3b (7.26 GB and
    # a 2.82 GB state), which launches no kernel
    flash_paths["slice 15a (qwen2-vl-2b serving, M-RoPE)"] = ("split", "tc")
    for label, needed, drive, checks in (
            ("slice 15a (qwen2-vl-2b serving, M-RoPE)", ("flash_attention",),
             run_vlm_main, run_vlm_checks),
            ("slice 15b (xlstm-1.3b serving)", (), run_ssm_main,
             run_ssm_checks)):
        out = {}
        drive_path(label, needed, lambda: drive(torch, np, cuda, out))
        t0 = out["t0"]
        checks(torch, np, cuda, out)
        log(f"{label.split(' (')[0]}: phase {time.perf_counter() - t0:.1f}s")
        del out
        torch.cuda.empty_cache()
    # slice 16's: internlm2-1.8b trained whole (23 GB of state), then its
    # checks (the backward against its twins, whisper-base's step, the
    # launcher preempted and resumed)
    label = "slice 16 (internlm2-1.8b training)"
    flash_paths[label] = ("tc",)
    bwd_routes[label] = "tc"
    out = {}
    drive_path(label, ("flash_attention", "flash_attention_bwd"),
               lambda: run_train_main(torch, np, cuda, out))
    flash_bwd = run_train_checks(torch, np, cuda, out)
    del out
    torch.cuda.empty_cache()
    # slice 17's: Jamba trained at published widths (one super-block, no
    # experts, int8 moments: ~54 GB of state), then its checks (the step
    # against the twins, the scan's backward against its twins); then the
    # four example programs
    label = "slice 17a (jamba-1.5-large training)"
    flash_paths[label] = ("tc",)
    bwd_routes[label] = "tc"
    out = {}
    drive_path(label, ("selective_scan", "selective_scan_bwd",
                       "selective_scan_bwd_reduce", "flash_attention",
                       "flash_attention_bwd"),
               lambda: run_train_hybrid_main(torch, np, cuda, out))
    scan_bwd = run_train_hybrid_checks(torch, np, cuda, out)
    del out
    torch.cuda.empty_cache()
    label = "slice 17b (the example programs)"
    flash_paths[label] = ("simt", "split")
    bwd_routes[label] = "simt"
    t0 = time.perf_counter()
    drive_path(label, ("flash_attention", "flash_attention_bwd",
                       "possibility_v", "possibility_weights",
                       "simstep_chunk"),
               lambda: run_examples(torch, np, cuda))
    log(f"examples: phase {time.perf_counter() - t0:.1f}s")
    log(f"flash: end to end: whisper generate device busy "
        f"{_ms(whisper_e2e, 'busy')}, flash_fwd* {_ms(whisper_e2e, 'flash')}"
        f"; jamba decode step device busy {_ms(jamba_e2e, 'busy')}, "
        f"flash_fwd* {_ms(jamba_e2e, 'flash')}; jamba prefill flash_fwd* "
        f"{_ms(jamba_e2e, 'prefill_flash')}")
    simstep_rows = []
    for topo, label in ((mesh2d(4, 4), "4x4"), (mesh2d_edge_io(5, 5), "5x5"),
                        (mesh2d(16, 16), "16x16"), (mesh2d(17, 17), "17x17"),
                        (mesh2d(32, 32), "32x32"), (mesh2d(64, 64), "64x64")):
        _, row = time_simstep(torch, np, cuda, topo, label,
                              row=label in ("32x32", "64x64"))
        if row:
            kernel = row["name"].removeprefix("simstep_")
            row["max_abs_err"] = float(simstep_err[kernel])
            simstep_rows.append(row)
    if FULL:
        _time_simstep_variants(torch, np, cuda)
    rows = [poss, weights, *simstep_rows, flash, scan, flash_bwd, scan_bwd]
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["name"] == "selective_scan_bwd":     # its second kernel
            row["reduce_launches"] = launches["selective_scan_bwd_reduce"]
        if row["name"] == "flash_attention_bwd":
            row["launches_by_route"] = bwd_launches
        if row["name"] in sizes:
            row["launches_by_size"] = {k: " + ".join(v) for k, v in
                                       sizes[row["name"]].items()}
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(f"total: {time.perf_counter() - t_all:.1f}s")
    # and the possibility pair's launches by size, the scan's decode step
    # (161 of its 168 launches on slice 4), the scan backward's reductions
    # and the checkpoints' cost to the forward, the flash backward's
    # CUDA-core kernel (simt) and its launches by route
    extra = ("launches_by_size", "decode_ms", "decode_bound_ms",
             "reduce_launches", "forward_ckpt_ms",
             "simt_ms", "launches_by_route")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + extra if k in r} for r in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def serve_wall(rounds: int) -> int:
    """``--serve-wall``: whisper-base's serving alone, warm, as slice 3's
    main path drives it (see the module note)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.models import encdec
    from repro_torch.models.layers import attention
    from repro_torch.serve import make_prefill

    cuda = torch.device("cuda")
    log(f"card: {card_line()}")
    log(f"serve-wall: the port from {os.path.dirname(repro_torch.__file__)}")
    cfg, engine, frames, prompts = _whisper(torch, np, cuda, "bfloat16",
                                            _whisper_tree(np))
    prefill = make_prefill(cfg)
    real = attention.flash_ops
    host = {"s": 0.0, "calls": 0}

    def timed(*args, **kw):     # host time in the attention op
        t0 = time.perf_counter()
        out = real.flash_attention(*args, **kw)
        host["s"] += time.perf_counter() - t0
        host["calls"] += 1
        return out

    enc = _serve(torch, engine, frames, prompts)[0]   # first run: builds

    def prefill_once():
        cache = encdec.init_cache(cfg, WHISPER_B, SERVE_MAX_LEN, device=cuda)
        prefill(engine.params, torch.as_tensor(prompts, device=cuda), cache,
                enc_out=enc)

    cols = {"encode": [], "generate": [], "prefill": [], "op_host_us": []}
    for i in range(rounds):
        _, _, _, enc_ms, gen_ms = _serve(torch, engine, frames, prompts)
        with torch.inference_mode():
            pre_ms = time_wall(torch, prefill_once, 1)
        host.update(s=0.0, calls=0)
        attention.flash_ops = SimpleNamespace(flash_attention=timed)
        try:
            _serve(torch, engine, frames, prompts)
        finally:
            attention.flash_ops = real
        op_us = host["s"] / host["calls"] * 1e6
        for key, x in zip(cols, (enc_ms, gen_ms, pre_ms, op_us)):
            cols[key].append(x)
        log(f"serve-wall: round {i}: encode {enc_ms!r}ms, generate "
            f"{gen_ms!r}ms, prefill {pre_ms!r}ms; attention op "
            f"{op_us!r}us of host time a call over {host['calls']} calls")
    med = {k: float(np.median(v)) for k, v in cols.items()}
    log(f"serve-wall: median of {rounds}: {json.dumps(med)}; least: "
        f"{json.dumps({k: min(v) for k, v in cols.items()})}")
    # the op alone at the two shapes a decode step calls: host time to
    # enqueue a call, 20 batches of 50 calls, with the card held busy and
    # with the card running each call as it arrives
    from repro_torch.kernels.flash_attention import flash_attention

    for shape in FLASH_SHAPES:
        if shape[0] not in ("cross decode", "self decode"):
            continue
        q, k, v, ml = _flash_case(torch, cuda, shape, torch.bfloat16,
                                  seed=len(shape[0]))
        for hold, how in ((True, "card held"), (False, "card free")):
            per = sorted(time_enqueue(torch, lambda r: flash_attention(
                q, k, v, causal=shape[7], mask_len=ml), 50, hold)
                for _ in range(20))
            log(f"serve-wall: the op alone at {shape[0]}, {how}: median "
                f"{per[10] * 1e3!r}us of host time a call over 20 batches "
                f"of 50 calls, least {per[0] * 1e3!r}us")
    return 0


def cycle_wall(rounds: int) -> int:
    """``--cycle-wall``: the flit step alone through its entry point, as
    the campaigns drive it: µs per simulated cycle of a 1 000-cycle
    ``run_cycles`` chunk (XY, 4 lanes, after a 300-cycle warm-in) at
    every mesh the script runs, the paper cell's wall per (pattern,
    algorithm) and the scale cells' (:func:`scale_specs`), with no other
    phase."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.core import mesh2d, mesh2d_edge_io
    from repro_torch.noc import run_campaign

    cuda = torch.device("cuda")
    log(f"card: {card_line()}")
    log(f"cycle-wall: the port from {os.path.dirname(repro_torch.__file__)}")
    shapes = (("4x4", mesh2d(4, 4)), ("5x5", mesh2d_edge_io(5, 5)),
              ("16x16", mesh2d(16, 16)), ("17x17", mesh2d(17, 17)),
              ("32x32", mesh2d(32, 32)), ("64x64", mesh2d(64, 64)))
    cols = {label: [] for label, _ in shapes}
    paper = paper_spec()
    scale = {}
    for i in range(rounds):
        for label, topo in shapes:
            cols[label].append(cycle_wall_us(torch, cuda, topo))
        res = run_campaign(paper, device=cuda)
        walls = {"/".join(k): round(v, 4)
                 for k, v in res.wall_clock_s.items()}
        log(f"cycle-wall: round {i}: us per cycle "
            f"{json.dumps({k: round(v[-1], 3) for k, v in cols.items()})}; "
            f"paper cell walls (s) {json.dumps(walls)}")
        # the scale cells' walls: tables, states and results besides the
        # cycles (the plan is outside them)
        for spec in scale_specs():
            res = run_campaign(spec, device=cuda)
            for k, v in res.wall_clock_s.items():
                scale.setdefault(f"{spec.topo.name}/{'/'.join(k)}",
                                 []).append(v)
        log(f"cycle-wall: round {i}: scale cell walls (s) "
            f"{json.dumps({k: v[-1] for k, v in scale.items()})}")
    med = {k: float(np.median(v)) for k, v in cols.items()}
    log(f"cycle-wall: median of {rounds} (us per simulated cycle): "
        f"{json.dumps(med)}")
    log(f"cycle-wall: median of {rounds} (scale cell walls, s): "
        f"{json.dumps({k: float(np.median(v)) for k, v in scale.items()})}")
    return 0


def scan_wall(rounds: int) -> int:
    """``--scan-wall``: the selective scan alone at the served prefill and
    decode shapes (event-timed µs per launch; the decode after a 128 MB
    read of the L2), Jamba's warm prefill and ``generate`` (slice 4's main
    path, host clock), and from the profiler's device time of one
    ``generate`` less one prefill its decode step and the scan's µs a
    launch in it, N rounds, with no other phase."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels.mamba_scan import selective_scan
    from repro_torch.models import hybrid
    from repro_torch.serve import make_prefill

    cuda = torch.device("cuda")
    log(f"card: {card_line()}")
    log(f"scan-wall: the port from {os.path.dirname(repro_torch.__file__)}")
    rflush = torch.ones(32 << 20, dtype=torch.float32, device=cuda)
    cases = {}
    for shape in SCAN_SHAPES:
        if shape[0] in ("prefill, h0", "decode"):
            args = _scan_case(torch, cuda, shape, len(shape[0]))
            cases[shape[0]] = (lambda r, g=args: selective_scan(*g[:5],
                                                                h0=g[5]))
    cfg, engine, prompts, _ = _jamba(torch, np, cuda, "bfloat16")
    _generate(torch, engine, prompts)     # first run: builds, warms
    prefill = make_prefill(cfg)
    toks = torch.as_tensor(prompts, device=cuda)

    def prefill_once():
        cache = hybrid.init_cache(cfg, JAMBA_B, JAMBA_MAX_LEN, device=cuda)
        prefill(engine.params, toks, cache)

    cols = {k: [] for k in ("prefill_us", "decode_us", "jamba_prefill_ms",
                            "jamba_generate_ms", "jamba_step_device_ms",
                            "jamba_step_scan_us")}
    for i in range(rounds):
        got = {"prefill_us": time_launches(
                   torch, [cases["prefill, h0"]], 20)[0] * 1e3,
               "decode_us": time_launches(
                   torch, [lambda r: rflush.sum(), cases["decode"]],
                   100)[-1] * 1e3,
               "jamba_generate_ms": _generate(torch, engine, prompts)[2]}
        with torch.inference_mode():
            got["jamba_prefill_ms"] = time_wall(torch, prefill_once, 1)
            pre = _profile(torch, prefill_once)
            gen = _profile(torch, lambda: engine.generate(prompts,
                                                          JAMBA_NEW))
        if pre is None or gen is None:   # no device time in the trace
            got["jamba_step_device_ms"] = got["jamba_step_scan_us"] = \
                float("nan")
        else:
            busy = (sum(ms for _, ms in gen.values())
                    - sum(ms for _, ms in pre.values()))
            scan_ms = (_share(gen, "selective_scan")
                       - _share(pre, "selective_scan"))
            scans = (_count(gen, "selective_scan")
                     - _count(pre, "selective_scan"))
            got["jamba_step_device_ms"] = busy / (JAMBA_NEW - 1)
            got["jamba_step_scan_us"] = scan_ms / scans * 1e3
        for k in cols:
            cols[k].append(got[k])
        log(f"scan-wall: round {i}: {json.dumps(got)}")
    med = {k: float(np.median(v)) for k, v in cols.items()}
    log(f"scan-wall: median of {rounds}: {json.dumps(med)}; least: "
        f"{json.dumps({k: min(v) for k, v in cols.items()})}")
    return 0


def poss_wall(rounds: int) -> int:
    """``--poss-wall``: the possibility pair alone, event-timed µs per
    launch through the public ops at every size the main paths launch
    them: ``possibility_v`` as the planner calls it (du = dn = dist,
    offset 0) at N = 16, 25, 256 and 1 024, ``possibility_weights_op`` on
    the channel sets of the Fig. 1 5x5 meshes, torus(16,16) and
    mesh2d(32,32) (offset 1), N rounds, with no other phase."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.core import mesh2d, mesh2d_edge_io, torus
    from repro_torch.kernels.possibility import (possibility_v,
                                                 possibility_weights_op,
                                                 prepare_weights)

    cuda = torch.device("cuda")
    log(f"card: {card_line()}")
    log(f"poss-wall: the port from {os.path.dirname(repro_torch.__file__)}")
    rng = np.random.default_rng(0)
    cases = {}
    for topo in (mesh2d(4, 4), mesh2d_edge_io(5, 5), torus(16, 16),
                 mesh2d(32, 32)):
        n = topo.num_nodes
        dist = torch.as_tensor(topo.distances, device=cuda)
        t = torch.as_tensor(rng.random((n, n)), device=cuda)
        cases[f"v N={n}"] = (
            lambda r, d=dist, t=t: possibility_v(d, d, t, d, offset=0), n)
    for label, topo in (("5x5 mesh", mesh2d(5, 5)),
                        ("5x5 edge-I/O", mesh2d_edge_io(5, 5)),
                        ("torus16x16", torus(16, 16)),
                        ("mesh32x32", mesh2d(32, 32))):
        n = topo.num_nodes
        a = prepare_weights(topo.distances, rng.random((n, n)),
                            topo.channels, cuda)
        cases[f"weights {label} N={n} C={topo.num_channels}"] = (
            lambda r, a=a: possibility_weights_op(*a), n)
    for fn, _ in cases.values():          # first calls: build, warm
        fn(0)
    torch.cuda.synchronize()
    cols = {k: [] for k in cases}
    for i in range(rounds):
        for k, (fn, n) in cases.items():
            reps = 20 if n > 256 else 100 if n > 25 else 200
            cols[k].append(time_launches(torch, [fn], reps)[0] * 1e3)
        log(f"poss-wall: round {i}: us per launch "
            f"{json.dumps({k: v[-1] for k, v in cols.items()})}")
    med = {k: float(np.median(v)) for k, v in cols.items()}
    log(f"poss-wall: median of {rounds}: {json.dumps(med)}; least: "
        f"{json.dumps({k: min(v) for k, v in cols.items()})}")
    return 0


def flash_wall(rounds: int) -> int:
    """``--flash-wall``: ``flash_attention`` alone, event-timed µs per
    call at every shape of ``FLASH_SHAPES`` whose V has Q's head dim, a
    multiple of 16 (the shapes any tree's kernels take unpadded), bf16,
    and fp32 where it takes
    the split path and at the encoder, N rounds, with no other phase."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import choose_path

    cuda = torch.device("cuda")
    log(f"card: {card_line()}")
    log(f"flash-wall: the port from {os.path.dirname(repro_torch.__file__)}")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cases = {}
    for shape in FLASH_SHAPES:
        if _dv(shape) != shape[6] or shape[6] % 16:
            continue
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            _, b, sq, skv, h, kv = shape[:6]
            kind = choose_path(dt, b, sq, h, kv, skv, sms=sms).kind
            if dtype == "float32" and kind != "split" and \
                    shape[0] != "encoder":
                continue
            q, k, v, ml = _flash_case(torch, cuda, shape, dt,
                                      seed=len(shape[0]))
            cases[f"{shape[0]} {dtype}"] = (
                lambda r, q=q, k=k, v=v, ml=ml, c=shape[7]: flash_attention(
                    q, k, v, causal=c, mask_len=ml), sq * skv)
    for fn, _ in cases.values():          # first calls: build, warm
        fn(0)
    torch.cuda.synchronize()
    cols = {k: [] for k in cases}
    for i in range(rounds):
        for k, (fn, n) in cases.items():
            reps = 20 if n > 1e6 else 40
            cols[k].append(time_launches(torch, [fn], reps)[0] * 1e3)
        log(f"flash-wall: round {i}: us per call "
            f"{json.dumps({k: round(v[-1], 3) for k, v in cols.items()})}")
    med = {k: round(float(np.median(v)), 3) for k, v in cols.items()}
    log(f"flash-wall: median of {rounds}: {json.dumps(med)}")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve-wall", action="store_true",
                    help="time whisper-base's serving alone")
    ap.add_argument("--cycle-wall", action="store_true",
                    help="time the flit step's chunks and the paper cell "
                    "alone")
    ap.add_argument("--scan-wall", action="store_true",
                    help="time the selective scan and Jamba's prefill and "
                    "decode step alone")
    ap.add_argument("--poss-wall", action="store_true",
                    help="time the possibility pair alone at the main "
                    "paths' sizes")
    ap.add_argument("--flash-wall", action="store_true",
                    help="time flash_attention alone at the shapes whose V "
                    "has Q's head dim")
    ap.add_argument("--src", help="with a --*-wall option: import the port "
                    "from this directory")
    ap.add_argument("--rounds", type=int, default=5,
                    help="with a --*-wall option: timed rounds")
    ap.add_argument("--full", action="store_true",
                    help="also run the older checks off the counted paths "
                    "(FULL_ONLY)")
    args = ap.parse_args()
    FULL = args.full
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    if args.serve_wall:
        sys.exit(serve_wall(args.rounds))
    if args.cycle_wall:
        sys.exit(cycle_wall(args.rounds))
    if args.scan_wall:
        sys.exit(scan_wall(args.rounds))
    if args.poss_wall:
        sys.exit(poss_wall(args.rounds))
    if args.flash_wall:
        sys.exit(flash_wall(args.rounds))
    sys.exit(main())
