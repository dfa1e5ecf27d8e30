"""Dry run: every (architecture × shape × mesh) cell's per-device
memory, FLOPs, HBM bytes and collectives, and the three roofline terms
at the H100's peaks, with no card and no process group.  The port's
counterpart of the reference's ``launch/dryrun.py``, with its CLI and
its record's keys.

The reference lowers and compiles each cell's step for 256 or 512
placeholder devices and reads XLA's ``memory_analysis()`` and the
post-SPMD HLO.  Torch has no SPMD compiler, so this module counts the
port's own step as it runs on a mesh (``sharding.state``: each layer
gathered whole just before it runs and again in the backward, the
rank's rows, each gradient reduced into the rank's fp32 shard; every
model rank runs the whole model), on the rank whose shards hold the
most bytes; on one device, the one-device step:

* **The state.**  ``argument`` is that rank's shards by the specs
  (``sharding.state.train_placements`` / ``shard_bytes``: params,
  moments and the step for a train cell; params and the cache's shard
  by ``specs.cache_specs``, sequence-parallel at ``long_500k``, for a
  serving cell), plus its rows of the batch.  ``state_bytes`` is the
  train state alone, the bytes a rank of the launcher holds.
* **The step, run on the meta device** (no allocation): the step's own
  code (``train_step.value_and_grads`` in the layer-wise scope, then
  ``train_step.sharded_update``) under a counting grid
  (``Grid.counting``), whose collectives are recorded, not run
  (``CountingComm``).  Every dot's FLOPs are
  counted where it dispatches (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``: 2 · prod(result) · prod(contracted), the reference's
  accounting; elementwise work ignored).  The two kernel ops, which take
  no meta tensor, stand in by counting ops: attention adds its products
  over its causal pairs (a query sees the keys up to its diagonal, the
  diagonal aligned at the end), 2 in the forward (QKᵀ, PV) and 5 in the
  backward (S again, dP, dV, dQ, dK, as the port's backward kernels
  and the reference's custom VJP compute them); the selective scan adds
  its one contraction with C a step (and 2 in the backward).  Remat's
  recomputation runs as the port runs it.  The microbatches of a step
  are alike, so one is run and its counts taken ``grad_accum`` times.
* ``temp`` is the peak of the meta tensors alive during the step (the
  layer gathered, the activations remat keeps and the recomputation's,
  the gradients' fp32 shards, the update's temporaries), plus, where
  there are several microbatches, the fp32 shards the other
  microbatches' gradients add into (one device: the whole fp32
  accumulator).  The step updates the state and the
  cache in place, so ``output`` and ``alias`` are 0 and ``peak`` is
  ``argument + temp``; ``fits`` holds it against the card's 79.6 GiB.
* ``hbm_bytes`` is a floor: a microbatch reads the weights once a
  pass (forward, remat's second forward, backward), writes each
  gathered one twice (the forward's gather and the backward's), writes
  its gradients whole and their fp32 shards (with several microbatches
  the shards' accumulator read and written too); then the norm reads
  the whole gradients (a ``1xM`` mesh at one microbatch) or the shards,
  and the update reads and writes the shards of the parameters and
  moments and reads the gradient's shard.  One device: the weights read
  a pass, the gradients written (the fp32 accumulator read and written
  with several microbatches), read by the norm, the update.  Serving:
  the weights read once, the cache's shard written (prefill) or read
  (decode).  Activations are left out.
* Collectives: each recorded call's bytes by the reference's rule
  (``collective_bytes`` the larger of what goes in and out: an
  ``all_gather``'s output, a ``reduce_scatter``'s input, an
  ``all_reduce``'s or a ``broadcast``'s tensor), its ring wire bytes
  (all-reduce 2(g−1)/g · size, gather and reduce-scatter (g−1)/g ·
  size, a broadcast the whole tensor on every link of its chain) and
  their count by kind; ``collective_s`` prices each call at its
  group's link (``analysis.hlo.group_bandwidth``).

Serving cells: the port has no sharded serving step (ROADMAP queue 1),
so a serving cell is counted as such a step would run: the weights
gathered whole, the
cache's shard gathered whole over the axes that split it other than
the batch's, the rank's rows through ``prefill`` or one ``decode_step``
at the last position of a full cache.

No counterpart: ``lower_s`` and ``compile_s`` (nothing is lowered or
compiled) and ``xla_cost_analysis`` (no XLA program): written as null.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --mesh single,multi
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..analysis.hlo import HloStats, group_bandwidth, roofline_terms
from ..configs import SHAPES, get_arch, list_archs
from ..configs.base import optimized_config
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.mamba_scan import ops as scan_ops
from ..models import registry
from ..sharding import specs as sh
from ..sharding.state import (DATA, Grid, Placement, ShardedTrain,
                              _set_param, coordinates, local_shape,
                              param_placements, shard_bytes,
                              train_placements)
from ..train.optimizer import OptConfig, adamw_update
from ..train.train_step import (init_train_state, microbatches,
                                sharded_update, value_and_grads)

ARTIFACT_DIR = str(Path(__file__).resolve().parents[3] / "artifacts"
                   / "dryrun_torch")
# the card's memory in GiB: an H100 80GB HBM3's 81 559 MiB, as
# ``nvidia-smi`` reports it
CARD_GIB = 81559 / 1024
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
_DOTS = {torch.ops.aten.mm.default: (0, 1),
         torch.ops.aten.bmm.default: (0, 1),
         torch.ops.aten.addmm.default: (1, 2),
         torch.ops.aten.baddbmm.default: (1, 2)}


@dataclasses.dataclass
class Tally:
    """What the counting ops and the dispatch mode add up."""
    flops: float = 0.0
    attention_flops: float = 0.0
    live: int = 0
    peak: int = 0
    base: int = 0


class _Counting(TorchDispatchMode):
    """Counts every dot's FLOPs and tracks the bytes of the tensors
    alive (their storages, freed when the last view goes)."""

    def __init__(self, tally: Tally):
        super().__init__()
        self.tally = tally
        self.seen: set = set()

    def _free(self, key, nbytes):
        self.tally.live -= nbytes
        self.seen.discard(key)

    def track(self, tensors) -> None:
        """Count ``tensors`` alive until their storages go."""
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.seen:
                continue
            n = st.nbytes()
            self.seen.add(key)
            self.tally.live += n
            self.tally.peak = max(self.tally.peak, self.tally.live)
            weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ops = _DOTS.get(func)
        if ops is not None:
            a, b = args[ops[0]], args[ops[1]]
            self.tally.flops += 2.0 * a.numel() * b.shape[-1]
        self.track(tree_flatten(out)[0])
        return out


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs a causal attention computes, the diagonal
    aligned at the end: query i sees keys ≤ i + skv − sq (the first
    sq − skv queries none, where sq > skv)."""
    if sq <= skv:
        return sq * (skv - sq) + sq * (sq + 1) // 2
    return skv * (skv + 1) // 2


def attention_flops(b: int, h: int, dk: int, dv: int, pairs: int,
                    backward: bool) -> float:
    """The products of one attention call over ``pairs`` (query, key)
    pairs a head: forward QKᵀ and PV; backward S again, dP, dV, dQ,
    dK."""
    per = (3 * dk + 2 * dv) if backward else (dk + dv)
    return 2.0 * b * h * pairs * per


class _CountedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, tally):
        b, sq, h, dk = q.shape
        skv, dv = k.shape[1], v.shape[3]
        pairs = causal_pairs(sq, skv) if causal else sq * skv
        ctx.meta = (b, h, dk, dv, pairs, tally, q.shape, k.shape, v.shape)
        f = attention_flops(b, h, dk, dv, pairs, False)
        tally.flops += f
        tally.attention_flops += f
        return q.new_empty((b, sq, h, dv))

    @staticmethod
    def backward(ctx, g):
        b, h, dk, dv, pairs, tally, qs, ks, vs = ctx.meta
        f = attention_flops(b, h, dk, dv, pairs, True)
        tally.flops += f
        tally.attention_flops += f
        return (g.new_empty(qs), g.new_empty(ks), g.new_empty(vs), None,
                None)


class _CountedScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delta, a, b, c, x, h0, tally):
        bs, s, di = x.shape
        ds = a.shape[1]
        ctx.meta = (tally, 2.0 * bs * s * di * ds,
                    [t.shape for t in (delta, a, b, c, x)], h0 is not None)
        tally.flops += 2.0 * bs * s * di * ds
        return x.new_empty(x.shape), x.new_empty((bs, di, ds))

    @staticmethod
    def backward(ctx, dy, dh):
        tally, f, shapes, has_h0 = ctx.meta
        tally.flops += 2 * f
        grads = [dy.new_empty(s) for s in shapes]
        return (*grads, dy.new_empty((shapes[4][0], *shapes[1]))
                if has_h0 else None, None)


@contextlib.contextmanager
def counting(alive=()):
    """Scope in which the step's dots and live bytes are counted and the
    attention and scan ops count their work on meta tensors; yields the
    :class:`Tally`.  ``alive``: the tensors there before the scope (the
    state, the batch), counted until they are freed, so that one the
    step replaces (a moment, a cache leaf) is not counted twice; the
    step's own bytes are then ``tally.peak - tally.base``."""
    tally = Tally()
    attn, scan = flash_ops.flash_attention, scan_ops.selective_scan

    def attention(q, k, v, *, causal, mask_len=None, q_chunk=0,
                  kv_chunk=0):
        return _CountedAttention.apply(q, k, v, causal, tally)

    def selective_scan(delta, a, b, c, x, h0=None):
        return _CountedScan.apply(delta, a, b, c, x, h0, tally)

    flash_ops.flash_attention, scan_ops.selective_scan = attention, \
        selective_scan
    try:
        with _Counting(tally) as mode:
            mode.track(alive)
            alive = None    # the caller's references alone keep them
            tally.base = tally.live
            yield tally
    finally:
        flash_ops.flash_attention, scan_ops.selective_scan = attn, scan


# ---------------------------------------------------------------------- #
# collectives
# ---------------------------------------------------------------------- #
_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter": "reduce-scatter", "broadcast": "broadcast"}


def _group_ranks(sizes: dict, coords: dict, axes) -> list[int]:
    """Global ranks (row-major) of the group over ``axes`` that holds the
    rank at ``coords``."""
    names = list(sizes)
    out = []
    for c in coordinates({a: sizes[a] for a in axes}):
        full = {**coords, **c}
        r = 0
        for a in names:
            r = r * sizes[a] + full[a]
        out.append(r)
    return out


def collective_totals(calls, sizes: dict, coords: dict) -> dict:
    """A step's recorded calls (``sharding.state.Collective``) by the
    reference's rule (a call's bytes its larger side: an all-gather's
    output, a reduce-scatter's input): ``collective_bytes``,
    ``collective_wire_bytes``, ``collective_counts`` by kind, and
    ``collective_s``, each call's wire bytes over its group's link."""
    total = wire = secs = 0.0
    counts: dict[str, int] = {}
    bw: dict = {}
    for c in calls:
        g = c.size
        if c.kind == "all_gather":
            size = g * c.nbytes
            w = (g - 1) / g * size
        elif c.kind == "all_reduce":
            size = c.nbytes
            w = 2 * (g - 1) / g * size
        elif c.kind == "reduce_scatter":
            size = c.nbytes
            w = (g - 1) / g * size
        else:
            size = w = c.nbytes
        if c.axes not in bw:
            bw[c.axes] = group_bandwidth(_group_ranks(sizes, coords, c.axes))
        total += size
        wire += w
        secs += w / bw[c.axes]
        key = _KINDS[c.kind]
        counts[key] = counts.get(key, 0) + 1
    return {"collective_bytes": total, "collective_wire_bytes": wire,
            "collective_counts": counts, "collective_s": secs}


# ---------------------------------------------------------------------- #
# the cells
# ---------------------------------------------------------------------- #
def train_settings(cfg) -> tuple[OptConfig, int]:
    """The reference's dry-run optimizer and accumulation: int8 moments
    and 16 microbatches above 5e10 parameters, else fp32 and 4."""
    big = registry.count_params(cfg) > 5e10
    return (OptConfig(moment_dtype="int8" if big else "float32"),
            16 if big else 4)


def fullest(sizes: dict, placed: dict) -> tuple[dict, int]:
    """The coordinates whose shards of ``placed`` hold the most bytes
    (the first in rank order among equals), and those bytes."""
    best, most = None, -1
    for c in coordinates(sizes):
        n = shard_bytes(sizes, c, placed)
        if n > most:
            best, most = c, n
    return best, most


def _batch(cfg, rows: int, seq: int, device="meta") -> dict:
    i32 = torch.int32
    batch = {"tokens": torch.zeros((rows, seq), dtype=i32, device=device),
             "labels": torch.zeros((rows, seq), dtype=i32, device=device),
             "mask": torch.zeros((rows, seq), dtype=torch.float32,
                                 device=device)}
    if cfg.family == "vlm":
        batch["positions"] = torch.zeros((3, rows, seq), dtype=i32,
                                         device=device)
    if cfg.family == "encdec":
        batch["embeds"] = torch.zeros((rows, cfg.enc_seq, cfg.d_model),
                                      dtype=cfg.torch_dtype, device=device)
    return batch


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def along_sequence(cfg, seq: int) -> int:
    """The sequence length at which ``cfg``'s counts are taken and
    extended along the sequence (0: taken at ``seq`` itself).  xLSTM's
    recurrences run op by op along the sequence (the sLSTM's steps, the
    mLSTM's chunks), which the meta device takes minutes for at 4 096
    positions; from two chunks on its counts are affine in the sequence
    (each step and each chunk repeats the same ops), so they are taken
    at two and three chunks and extended (``tests/test_torch_dryrun.py``
    holds the extension to a direct count)."""
    c = cfg.xlstm_chunk
    if cfg.family == "ssm" and seq > 3 * c and seq % c == 0:
        return c
    return 0


def _extended(two: dict, three: dict, times: int) -> dict:
    """Counts at two chunks (``two``) and three (``three``) extended to
    ``times`` chunks: FLOPs affine in the chunk count; the live-byte
    peak so extended, an estimate (a maximum over the step of tensor
    sets that grow at their own rates: within 2 % at the smoke config);
    the calls the same at any length."""
    if [(c.kind, c.nbytes) for c in two["calls"]] != \
            [(c.kind, c.nbytes) for c in three["calls"]]:
        raise AssertionError("collectives that depend on the sequence")
    out = dict(two)
    for k in ("flops", "attention_flops", "temp_bytes"):
        out[k] = two[k] + (three[k] - two[k]) * (times - 2)
    return out


def train_counts(cfg, opt_cfg: OptConfig, mesh, global_batch: int,
                 seq: int, grad_accum: int = 1, coords=None) -> dict:
    """One train step of ``cfg`` on a mesh of ``mesh``'s axis sizes, at
    ``coords`` (default: the fullest rank), as the launcher runs it
    (``train_step.sharded_train_step``; the one-device step where every
    axis is 1): the state's bytes, the step's FLOPs, live-byte peak, HBM
    floor and recorded collectives (``calls``).  Microbatches that the rank's
    rows do not split into are cut to the largest count that does
    (``microbatches``); xLSTM's counts are extended along the sequence
    (:func:`along_sequence`)."""
    c = along_sequence(cfg, seq)
    if c:
        two, three = (train_counts(cfg, opt_cfg, mesh, global_batch, n,
                                   grad_accum, coords)
                      for n in (2 * c, 3 * c))
        out = _extended(two, three, seq // c)
        out["batch_bytes"] = two["batch_bytes"] * seq // (2 * c)
        return out
    sizes = sh.axis_sizes(mesh)
    work = registry.init(cfg, device="meta")
    placed = train_placements(cfg, opt_cfg, sizes, work)
    if coords is None:
        coords, _ = fullest(sizes, placed)
    grid = Grid.counting(sizes, coords)
    one = math.prod(sizes.values()) == 1
    if one:
        state = init_train_state(cfg, opt_cfg, device="meta")
    else:
        sharded = ShardedTrain(cfg, opt_cfg, sizes, grid=grid)
        state = sharded.init_state(device="meta")
    from ..train.checkpoint import flatten

    state_bytes = _nbytes(t for _, t in flatten(state))
    rows = global_batch // grid.data_size
    acc = grad_accum
    while rows % acc:
        acc -= 1
    batch = grid.rows(_batch(cfg, global_batch, seq))
    mb = microbatches(batch, acc)[0] if acc > 1 else batch
    params = {p: pl for p, (pl, _) in placed.items()
              if p.startswith("params/")}
    full_params = sum(math.prod(pl.shape) * placed[p][1].itemsize
                      for p, pl in params.items())
    gathered = sum(math.prod(pl.shape) * placed[p][1].itemsize
                   for p, pl in params.items() if grid.moves(pl))
    n_params = sum(math.prod(pl.shape) for pl in params.values())
    calls = grid.comm.calls
    alive = [t for _, t in flatten(state)] + list(batch.values())
    # one microbatch of the step, then its update (the step's own code;
    # the microbatches are alike, so their counts are that one's times
    # ``acc``)
    with counting(alive) as tally:
        del alive
        if one:
            loss, _, grads = value_and_grads(cfg, state["params"], mb, 1)
            mb_flops, mb_attn = tally.flops, tally.attention_flops
            n_mb = len(calls)
            if acc > 1:     # the accumulator's dtype
                grads = {n: g.to(torch.float32) for n, g in grads.items()}
            adamw_update(opt_cfg, state["params"], grads, state["opt"])
            del grads
        else:
            with sharded.layerwise(state["params"], acc) as layers:
                loss, _, _ = value_and_grads(cfg, state["params"], mb, 1,
                                             sharded.dp, layerwise=True)
                mb_flops, mb_attn = tally.flops, tally.attention_flops
                n_mb = len(calls)
                sharded_update(opt_cfg, sharded, state, layers)
            whole_norm = layers.whole_norm
            del layers
        del loss
    step_calls = calls[:n_mb] * acc + calls[n_mb:]
    local = {p: math.prod(local_shape(sizes, coords, pl)) * dt.itemsize
             for p, (pl, dt) in placed.items()}
    local_params = sum(v for p, v in local.items()
                       if p.startswith("params/"))
    local_moments = sum(v for p, v in local.items() if p.startswith("opt/"))
    local_n = sum(math.prod(local_shape(sizes, coords, pl))
                  for pl in params.values())
    passes = 3 if cfg.remat else 2
    update = 2 * local_params + 2 * local_moments + 4 * local_n
    if one:
        # the weights read each pass, each microbatch's gradients written
        # (and, with several, the fp32 accumulator read and written), the
        # norm's read, the update
        temp = tally.peak - tally.base + (4 * n_params if acc > 1 else 0)
        hbm = acc * (passes * full_params + full_params
                     + (8 * n_params if acc > 1 else 0))
        hbm += 4 * n_params + update
    else:
        # the fp32 shards of the other microbatches' gradients
        temp = tally.peak - tally.base + (4 * local_n if acc > 1 else 0)
        # a microbatch: the weights read each pass and written by their
        # two gathers (the forward's; remat's recomputation or the saved
        # weights unpacked), the gradients written whole, their fp32
        # shards written (with several microbatches the accumulator read
        # and written too); then the norm's read (the whole gradients on
        # a 1xM mesh at one microbatch, else the shards) and the update
        hbm = acc * (passes * full_params + 2 * gathered + full_params
                     + 4 * local_n + (8 * local_n if acc > 1 else 0))
        hbm += (full_params if whole_norm else 4 * local_n) + update
    return {"sizes": sizes, "coords": coords, "state_bytes": state_bytes,
            "batch_bytes": _nbytes(batch.values()),
            "flops": mb_flops * acc, "attention_flops": mb_attn * acc,
            "temp_bytes": temp, "hbm_bytes": float(hbm),
            "calls": step_calls, "microbatches": acc, "rows": rows}


def _cache_leaves(node, prefix=""):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def serve_counts(cfg, kind: str, mesh, global_batch: int, seq: int,
                 seq_parallel: bool = False, coords=None) -> dict:
    """A serving step (``prefill`` of ``seq`` tokens, or one
    ``decode_step`` at the last position of a ``seq``-long cache) on a
    mesh of ``mesh``'s axis sizes, as the mesh step would run it: the
    weights gathered whole, the cache's shard gathered over its
    non-batch axes, the rank's rows.  An xLSTM prefill is extended along
    the sequence (:func:`along_sequence`); its cache is a state, the
    same at any length."""
    c = along_sequence(cfg, seq) if kind == "prefill" else 0
    if c:
        two, three = (serve_counts(cfg, kind, mesh, global_batch, n,
                                   seq_parallel, coords)
                      for n in (2 * c, 3 * c))
        out = _extended(two, three, seq // c)
        out["argument_bytes"] = (two["argument_bytes"]
                                 + 4 * two["rows"] * (seq - 2 * c))
        return out
    sizes = sh.axis_sizes(mesh)
    work = registry.init(cfg, device="meta")
    placed = param_placements(cfg, sizes, work)
    cache = registry.init_cache(cfg, global_batch, seq, device="meta")
    cspecs = sh.cache_specs(cfg, sizes, cache, seq_parallel)
    leaves = dict(_cache_leaves(cache))
    specs = dict(_cache_leaves(cspecs))
    for path, t in leaves.items():
        placed[f"cache/{path}"] = (Placement(tuple(t.shape), specs[path]),
                                   t.dtype)
    if coords is None:
        coords, _ = fullest(sizes, placed)
    grid = Grid.counting(sizes, coords)
    # the batch's split over the data ranks (none where it does not
    # divide, as the specs' ``fit_spec`` drops it)
    bspec = sh.fit_spec(sizes, (global_batch,), (DATA,))
    rows = global_batch // sh.axis_size(sizes, bspec[0])
    local = {path: torch.empty(local_shape(sizes, coords, pl), dtype=dt,
                               device="meta")
             for path, (pl, dt) in placed.items()}
    tokens = torch.zeros((rows, seq if kind == "prefill" else 1),
                         dtype=torch.int32, device="meta")
    extra = {}
    if cfg.family == "encdec":
        extra["enc_out"] = torch.zeros((rows, cfg.enc_seq, cfg.d_model),
                                       dtype=cfg.torch_dtype, device="meta")
    alive = [*local.values(), tokens, *extra.values()]
    arg = _nbytes(alive)
    del cache
    with counting(alive) as tally, torch.no_grad():
        del alive
        for path, (pl, _) in placed.items():
            part, _, name = path.partition("/")
            if part == "params":
                _set_param(work, name, torch.nn.Parameter(
                    grid.gather(pl, local[path]), requires_grad=False))
                continue
            # a cache shard gathered over the axes that split it other
            # than the batch's (recorded: the step reads its rows' cache,
            # ``init_cache`` of ``rows`` below)
            keep = []
            for entry in pl.spec:
                axes = tuple(a for a in sh.axes_of(entry)
                             if seq_parallel or a not in DATA)
                keep.append(None if not axes else
                            axes if len(axes) > 1 else axes[0])
            shape = tuple(
                d // sh.axis_size(sizes, e) if e is not None and not keep[i]
                else d for i, (d, e) in enumerate(zip(pl.shape, pl.spec)))
            grid.gather(Placement(shape, tuple(keep)), local[path])
        full_cache = registry.init_cache(cfg, rows, seq, device="meta")
        mod = registry.model_module(cfg)
        if kind == "prefill":
            mod.prefill(cfg, work, tokens, full_cache, **extra)
        else:
            mod.decode_step(cfg, work, tokens, full_cache, seq - 1, **extra)
    full_params = sum(math.prod(pl.shape) * dt.itemsize
                      for p, (pl, dt) in placed.items()
                      if p.startswith("params/"))
    cache_local = sum(_nbytes([t]) for p, t in local.items()
                      if p.startswith("cache/"))
    return {"sizes": sizes, "coords": coords, "argument_bytes": arg,
            "flops": tally.flops, "attention_flops": tally.attention_flops,
            "temp_bytes": tally.peak - tally.base,
            "hbm_bytes": float(full_params + cache_local),
            "calls": list(grid.comm.calls), "rows": rows}


def input_specs(arch_id: str, shape_name: str, mesh, variant: str = "base"):
    """A cell's step: (step kind, counts, meta) where counts is
    :func:`train_counts` or :func:`serve_counts` on ``mesh`` (axis
    sizes) and meta holds ``model_flops`` and ``grad_accum``."""
    spec = get_arch(arch_id)
    cfg = optimized_config(arch_id) if variant == "opt" else spec.full
    shp = SHAPES[shape_name]
    b, s = shp.global_batch, shp.seq_len
    n_active = registry.count_params(cfg, active_only=True)
    if shp.kind == "train":
        opt_cfg, grad_accum = train_settings(cfg)
        counts = train_counts(cfg, opt_cfg, mesh, b, s, grad_accum)
        return "train", counts, dict(model_flops=6.0 * n_active * b * s,
                                     grad_accum=grad_accum)
    counts = serve_counts(cfg, shp.kind, mesh, b, s,
                          seq_parallel=shape_name == "long_500k")
    mf = 2.0 * n_active * b * (s if shp.kind == "prefill" else 1)
    return shp.kind, counts, dict(model_flops=mf, grad_accum=None)


def record_of(counts: dict, meta: dict, num_chips: int) -> dict:
    """A cell's ``memory``, ``per_device`` and ``roofline`` from its
    counts (the reference's keys and units: GiB, FLOPs, bytes, s)."""
    coll = collective_totals(counts["calls"], counts["sizes"],
                             counts["coords"])
    if "argument_bytes" in counts:
        arg = counts["argument_bytes"]
    else:
        arg = counts["state_bytes"] + counts["batch_bytes"]
    temp = counts["temp_bytes"]
    peak = (arg + temp) / 2**30
    stats = HloStats(flops=counts["flops"], hbm_bytes=counts["hbm_bytes"],
                     collective_bytes=coll["collective_bytes"],
                     collective_wire_bytes=coll["collective_wire_bytes"],
                     collective_counts=coll["collective_counts"])
    rl = roofline_terms(stats, num_chips, meta["model_flops"],
                        collective_s=coll["collective_s"])
    return {
        "memory": {"argument_gb": arg / 2**30, "output_gb": 0.0,
                   "temp_gb": temp / 2**30, "alias_gb": 0.0,
                   "peak_gb": peak, "fits": peak <= CARD_GIB},
        "per_device": {
            "flops": stats.flops, "hbm_bytes": stats.hbm_bytes,
            "collective_bytes": stats.collective_bytes,
            "collective_wire_bytes": stats.collective_wire_bytes,
            "collective_counts": stats.collective_counts,
            "attention_flops": counts["attention_flops"],
            "state_bytes": counts.get("state_bytes"),
            "coords": counts["coords"], "rows": counts["rows"],
            "microbatches": counts.get("microbatches")},
        "roofline": {
            "compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "collective_s": rl.collective_s, "dominant": rl.dominant,
            "bound_s": rl.bound_s, "model_flops": rl.model_flops,
            "useful_flops_ratio": rl.useful_flops_ratio,
            "mfu_bound": rl.mfu_bound}}


def run_cell(arch_id: str, shape_name: str, mesh_name: str,
             out_dir: str | None = None, verbose: bool = True,
             variant: str = "base") -> dict:
    """One cell's record (written to ``out_dir`` as the reference names
    it); ``mesh_name`` is ``single`` (16 x 16) or ``multi`` (2 x 16 x 16),
    or an axis-size mapping."""
    sizes = (dict(MESHES[mesh_name]) if isinstance(mesh_name, str)
             else sh.axis_sizes(mesh_name))
    name = mesh_name if isinstance(mesh_name, str) else "x".join(
        str(v) for v in sizes.values())
    n_chips = math.prod(sizes.values())
    t0 = time.perf_counter()
    kind, counts, meta = input_specs(arch_id, shape_name, sizes, variant)
    body = record_of(counts, meta, n_chips)
    record = {"arch": arch_id, "shape": shape_name, "mesh": name,
              "variant": variant, "kind": kind, "num_chips": n_chips,
              "lower_s": None, "compile_s": None,
              "count_s": time.perf_counter() - t0,
              "memory": body["memory"], "xla_cost_analysis": None,
              "per_device": body["per_device"],
              "roofline": body["roofline"], "grad_accum": meta["grad_accum"]}
    if verbose:
        rl, mem = record["roofline"], record["memory"]
        print(f"[{arch_id} × {shape_name} × {name} × {variant}] {kind}: "
              f"counted in {record['count_s']:.1f}s  peak/device "
              f"{mem['peak_gb']:.2f} GiB (fits {mem['fits']})")
        print(f"  roofline: compute {rl['compute_s'] * 1e3:.2f} ms | memory "
              f"{rl['memory_s'] * 1e3:.2f} ms | collective "
              f"{rl['collective_s'] * 1e3:.2f} ms → {rl['dominant']}-bound, "
              f"MFU bound {rl['mfu_bound']:.2%}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "" if variant == "base" else f"__{variant}"
        path = os.path.join(out_dir,
                            f"{arch_id}__{shape_name}__{name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    help="comma list: single,multi")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--variant", default="base", choices=["base", "opt"])
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    failures = []
    for arch in archs:
        spec = get_arch(arch)
        shapes = (spec.shapes if args.shape == "all"
                  else [s for s in args.shape.split(",")
                        if s in spec.shapes])
        for shape in shapes:
            for mesh_name in args.mesh.split(","):
                suffix = "" if args.variant == "base" else \
                    f"__{args.variant}"
                path = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_name}{suffix}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"skip {arch} × {shape} × {mesh_name}")
                    continue
                try:
                    run_cell(arch, shape, mesh_name, out_dir=args.out,
                             variant=args.variant)
                except Exception as e:  # noqa: BLE001 - report and go on
                    traceback.print_exc()
                    failures.append((arch, shape, mesh_name, str(e)[:200]))
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall requested dry-run cells counted")


if __name__ == "__main__":
    main()
