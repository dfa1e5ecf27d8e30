"""Training on a (data, model) mesh against one device, on the CPU.

The launcher runs as its users run it, in subprocesses: ``python -m
repro_torch.launch.train`` for one device and ``python -m
torch.distributed.run --standalone --nproc-per-node N -m
repro_torch.launch.train`` for a mesh of N gloo ranks, one torch thread
a process.  Each run writes its steps' metrics (``--metrics``) and its
final checkpoint, which is the whole state whatever the mesh.

* internlm2's smoke, 6 steps: ``1x2`` equals ``1x1`` bit for bit (every
  loss, grad norm and leaf of the final state read through
  ``convert.train_state_to_numpy``), with fp32 and with int8 moments;
  ``1x4`` with int8 moments too (blocks of the smoke's narrow last axes
  span shards, so their scales are maxima over ranks).
  qwen2-moe's smoke on ``1x2`` too (its shared expert's layer axis is
  split: a layer's shared expert lives on one rank), and one smoke of
  each family no other case launches: Jamba's (hybrid: Mamba, experts
  split over ``model``, its dense FFNs' layer axis owned), whisper's
  (encdec: the tied table gathered once for both ends, the cross
  attention's K/V projections outside the block) and xLSTM's (ssm).
  Each step gathers a layer at a time: these hold the layer hook, the
  saved weights gathered again in the backward, and the whole-gradient
  norm to one device's arithmetic.
* ``2x1`` with ``--grad-accum 2``, qwen2-moe's smoke on ``2x1`` (the
  capacity factor cut to 1.0, so pairs drop at every step, and remat
  on, so the backward recomputes each block's dispatch; the aux term is
  in the loss) and qwen2-vl's with ``--grad-accum 2`` (M-RoPE
  positions), and internlm2's on a ``2x2x1`` (pod, data, model) mesh,
  equal ``1x1`` within ``RTOL`` on the losses and grad norms
  and ``PARAM_TOL`` of each leaf's largest value on the final state:
  the data ranks' gradients are summed in another order.
* The elastic restart, the reference's test at this sandbox's scale: 4
  steps on ``2x2`` with a checkpoint, resumed on ``2x1`` to 6 ("resumed
  from step 4"), within those tolerances of an uninterrupted ``1x1``.
* The JAX package itself: its initial internlm2 smoke state carried over
  by ``convert.train_state_from_numpy`` as the step-0 checkpoint, 3
  steps on ``2x2``, against the reference's ``make_train_step`` over the
  same batches (losses within 1e-6 relative, the final parameters and m
  within 5e-5 of a leaf's largest: ``tests/test_torch_train.py``'s
  tolerances).
* ``--mesh 3x1`` on a world of 2 raises and names both numbers.
* The dry run (``launch.dryrun.train_counts``) against the ranks of
  ``1x2``, ``1x4 int8``, ``2x1 accum``, both MoE meshes, the hybrid's
  ``1x2`` and the oracle's ``2x2``: each rank's state bytes and every
  tensor its first step hands to ``torch.distributed`` (the gathers, the
  gradients' reduce-scatters and all-reduces, the norm's sum), recorded
  in the launch (``RANK``), exactly.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_oracle import reference

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch.train import make_batch
from repro_torch.models import registry
from repro_torch.models.layers import ffn
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5          # losses and grad norms, D > 1 against 1x1
PARAM_TOL = 1e-5     # of a leaf's largest |value|, the final state
SEQ, STEPS = 16, 6
TIMEOUT = 240
BASE = ["--smoke", "--seq", str(SEQ), "--device", "cpu", "--ckpt-every",
        "100"]
# qwen2-moe's smoke with the capacity factor cut to 1.0, so pairs drop
# at every step, and remat on, so the backward recomputes each block's
# dispatch: the launcher's own ``main`` on that configuration
MOE_OVERRIDES = dict(capacity_factor=1.0, remat=True)
# a rank of the launcher's own ``main`` that also records, in its first
# step, every tensor it hands to ``torch.distributed`` (the call's kind,
# the bytes, a reduce-scatter's input, the group's size) and its state's
# bytes, to
# ``<--metrics>.comm-<rank>.json``; with overrides of the config
RANK = """
import json
import sys

import torch.distributed as dist
from repro_torch.launch import train

OVERRIDES = {overrides!r}
setup, prepare = train.setup, train.prepare
calls, active = [], [False]


def rank_setup(args):
    cfg, opt_cfg, data = setup(args)
    return cfg.replace(**OVERRIDES) if OVERRIDES else cfg, opt_cfg, data


def recording(kind, fn, pos):
    def call(*a, **kw):
        if active[0]:
            t = a[pos]
            calls.append([kind, t.numel() * t.element_size(),
                          dist.get_world_size(kw.get("group"))])
        return fn(*a, **kw)
    return call


def rank_prepare(args, timed=False):
    r = prepare(args, timed)
    if r.sharded is None:
        return r
    rec = {{"coords": r.sharded.grid.coords,
           "state_bytes": r.sharded.state_bytes(r.state),
           "predicted": r.sharded.predicted_bytes()}}
    step_fn = r.step_fn

    def step(state, batch):
        if "calls" in rec:
            return step_fn(state, batch)
        active[0] = True
        out = step_fn(state, batch)
        active[0] = False
        rec["calls"] = list(calls)
        with open(f"{{args.metrics}}.comm-{{dist.get_rank()}}.json",
                  "w") as f:
            json.dump(rec, f)
        return out

    r.step_fn = step
    return r


dist.all_gather = recording("all_gather", dist.all_gather, 1)
dist.all_reduce = recording("all_reduce", dist.all_reduce, 0)
dist.reduce_scatter_tensor = recording("reduce_scatter",
                                       dist.reduce_scatter_tensor, 1)
dist.broadcast = recording("broadcast", dist.broadcast, 0)
train.setup, train.prepare = rank_setup, rank_prepare
train.main(sys.argv[1:])
"""
MOE = ["--arch", "qwen2-moe-a2.7b"]
VLM = ["--arch", "qwen2-vl-2b", "--grad-accum", "2"]
HYBRID = ["--arch", "jamba-1.5-large-398b"]
ENCDEC = ["--arch", "whisper-base"]
SSM = ["--arch", "xlstm-1.3b"]
RUNS = {
    "1x1": (1, []),
    "1x2": (2, ["--mesh", "1x2"]),
    "1x1 int8": (1, ["--moments", "int8"]),
    "1x2 int8": (2, ["--mesh", "1x2", "--moments", "int8"]),
    "1x4 int8": (4, ["--mesh", "1x4", "--moments", "int8"]),
    "1x1 accum": (1, ["--grad-accum", "2"]),
    "2x1 accum": (2, ["--mesh", "2x1", "--grad-accum", "2"]),
    "1x1 moe": (1, MOE),
    "1x2 moe": (2, MOE + ["--mesh", "1x2"]),
    "2x1 moe": (2, MOE + ["--mesh", "2x1"]),
    "1x1 vlm": (1, VLM),
    "2x1 vlm": (2, VLM + ["--mesh", "2x1"]),
    "2x2x1": (4, ["--mesh", "2x2x1"]),
    "1x1 hybrid": (1, HYBRID),
    "1x2 hybrid": (2, HYBRID + ["--mesh", "1x2"]),
    "1x1 encdec": (1, ENCDEC),
    "1x2 encdec": (2, ENCDEC + ["--mesh", "1x2"]),
    "1x1 ssm": (1, SSM),
    "1x2 ssm": (2, SSM + ["--mesh", "1x2"]),
}


# the launches whose ranks record their first step's collectives (with
# "oracle 2x2" and the MoE ranks)
COUNTED = ("1x2", "1x4 int8", "2x1 accum", "1x2 hybrid")


def _command(nproc: int, argv: list[str], script=None) -> list[str]:
    """The launcher module, or ``script`` (a file) in its place."""
    target = ["-m", "repro_torch.launch.train"] if script is None else [
        str(script)]
    if nproc == 1:
        return [sys.executable, *target, *argv]
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(nproc), *target, *argv]


def _start(nproc: int, argv: list[str], script=None) -> subprocess.Popen:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(_command(nproc, argv, script), cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc: subprocess.Popen) -> tuple[int, str, str]:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


def _argv(d, name: str, extra: list[str], steps: int = STEPS) -> list[str]:
    return ["--arch", "internlm2-1.8b", *BASE, "--steps", str(steps),
            "--ckpt-dir", str(d / name), "--metrics", str(d / f"{name}.jsonl"),
            *extra]


def _ok(name, res):
    rc, out, err = res
    assert rc == 0, f"{name}: exit {rc}\n{out[-3000:]}\n{err[-3000:]}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch of the module, started together (the elastic pair's
    second after its first); {name: (rc, stdout, stderr)} and the
    directory they wrote to."""
    d = tmp_path_factory.mktemp("mesh")
    moe_rank, comm_rank = d / "moe_rank.py", d / "comm_rank.py"
    moe_rank.write_text(RANK.format(overrides=MOE_OVERRIDES))
    comm_rank.write_text(RANK.format(overrides={}))
    procs = {name: _start(n, _argv(d, name.replace(" ", "_"), extra),
                          moe_rank if extra[:len(MOE)] == MOE else
                          comm_rank if name in COUNTED else None)
             for name, (n, extra) in RUNS.items()}
    procs["2x2 then"] = _start(4, _argv(d, "elastic", ["--mesh", "2x2"], 4))
    procs["3x1 on 2"] = _start(2, _argv(d, "bad", ["--mesh", "3x1"]))
    oracle_start = _oracle_start(d / "oracle")
    procs["oracle 2x2"] = _start(4, _argv(d, "oracle", ["--mesh", "2x2"], 3),
                                 comm_rank)
    res = {}
    for name in list(procs):
        res[name] = _finish(procs[name])
        if name == "2x2 then" and res[name][0] == 0:
            res["2x1 resumed"] = _finish(_start(2, _argv(d, "elastic", [
                "--mesh", "2x1"])))
    return {"res": res, "dir": d, "oracle": oracle_start}


def _metrics(d, name: str) -> list[dict]:
    """A run's steps from ``--metrics``, less their wall seconds."""
    with open(d / f"{name.replace(' ', '_')}.jsonl") as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        assert r.pop("seconds") > 0
    return rows


def _state(d, name: str, arch="internlm2-1.8b", moments="float32") -> dict:
    """A run's final checkpoint in the reference's layout, through
    ``convert.train_state_to_numpy``."""
    cfg = get_arch(arch).smoke
    like = init_train_state(cfg, OptConfig(moment_dtype=moments), seed=1,
                            device="cpu")
    mgr = CheckpointManager(str(d / name.replace(" ", "_")))
    state, _ = mgr.restore(like)
    return convert.train_state_to_numpy(state)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_equal(a: dict, b: dict):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def _assert_close(a: dict, b: dict, tol: float, keys=None):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in keys or la:
        w = la[k].astype(np.float64)
        top = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(lb[k].astype(np.float64) - w).max())
        assert err <= tol * top, f"{k}: {err} of {top}"


def _assert_metrics_close(want: list[dict], got: list[dict]):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for w, g in zip(want, got):
        for k in ("loss", "grad_norm", "ce", "aux"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=0,
                                       err_msg=f"step {w['step']} {k}")


# --------------------------------------------------------------------- #
# 1xM: bit for bit
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh,base,moments,arch", [
    ("1x2", "1x1", "float32", "internlm2-1.8b"),
    ("1x2 int8", "1x1 int8", "int8", "internlm2-1.8b"),
    ("1x4 int8", "1x1 int8", "int8", "internlm2-1.8b"),
    ("1x2 moe", "1x1 moe", "float32", "qwen2-moe-a2.7b"),
    ("1x2 hybrid", "1x1 hybrid", "float32", "jamba-1.5-large-398b"),
    ("1x2 encdec", "1x1 encdec", "float32", "whisper-base"),
    ("1x2 ssm", "1x1 ssm", "float32", "xlstm-1.3b")])
def test_model_split_mesh_equals_one_device_bit_for_bit(runs, mesh, base,
                                                        moments, arch):
    """qwen2-moe's 6 experts divide the model axis, so the reference's
    rule splits its shared expert's stacked layer axis: each layer's
    shared expert lives whole on one model rank and is sent out when
    gathered."""
    d, res = runs["dir"], runs["res"]
    out = _ok(mesh, res[mesh])
    _ok(base, res[base])
    assert "mesh: {'data': 1, 'model': " in out and "done" in out
    want, got = _metrics(d, base), _metrics(d, mesh)
    assert len(want) == STEPS and got == want
    _assert_equal(_state(d, base, arch, moments),
                  _state(d, mesh, arch, moments))


# --------------------------------------------------------------------- #
# D > 1: the global batch's math to fp32 summation order
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh,base,arch", [
    ("2x1 accum", "1x1 accum", "internlm2-1.8b"),
    ("2x1 moe", "1x1 moe", "qwen2-moe-a2.7b"),
    ("2x1 vlm", "1x1 vlm", "qwen2-vl-2b"),
    ("2x2x1", "1x1", "internlm2-1.8b")])
def test_data_split_mesh_equals_one_device(runs, mesh, base, arch):
    """qwen2-vl with accumulation 2: each rank takes its rows of the
    (3, B, S) M-RoPE positions on axis 1, then interleaves them.  On
    ``2x2x1`` (pod, data, model) the batch splits over pod and data
    together, four ranks of 2 rows, their gradients summed over both."""
    d, res = runs["dir"], runs["res"]
    _ok(mesh, res[mesh])
    _ok(base, res[base])
    want, got = _metrics(d, base), _metrics(d, mesh)
    _assert_metrics_close(want, got)
    if arch == "qwen2-moe-a2.7b":
        assert all(r["aux"] > 0 for r in want)
    _assert_close(_state(d, base, arch), _state(d, mesh, arch), PARAM_TOL)


def test_moe_case_drops_pairs():
    """The MoE case above drops pairs at every step of its batches: the
    dispatch's queue places across ranks decide which."""
    cfg = get_arch("qwen2-moe-a2.7b").smoke.replace(**MOE_OVERRIDES)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=8))
    model = registry.init(cfg, 0, "cpu")
    with torch.no_grad(), ffn.moe_stats() as stats:
        for s in range(STEPS):
            registry.forward(cfg, model, make_batch(cfg, data.get_batch(s),
                                                    "cpu")["tokens"])
    drops = [int(st["dropped"]) for st in stats]
    assert len(drops) == STEPS * cfg.n_layers and min(drops) > 0


class _SecondOfTwo:
    """The batch split of rank 1 of 2 data ranks whose rank 0 holds the
    same rows, in this one process: sums double, the ranks below hold
    this rank's counts."""
    data_size, data_index = 2, 1

    def sum(self, x):
        return 2 * x.detach()

    def sum_with_grad(self, x):
        return x + x.detach()

    def exclusive_prefix(self, x):
        return x.clone()


def test_remat_recomputes_the_global_dispatch():
    """With remat on, the backward recomputes each block's MoE dispatch
    outside ``loss_fn``'s data-parallel scope; it must take the global
    capacity and queue places again (``ffn.recompute_contexts``), so the
    gradients equal those of the same step without remat, bit for bit."""
    from repro_torch.train.train_step import trainable, value_and_grads

    cfg = get_arch("qwen2-moe-a2.7b").smoke.replace(**MOE_OVERRIDES)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=8))
    batch = make_batch(cfg, data.get_batch(0), "cpu")
    params = trainable(registry.init(cfg, 0, "cpu"))
    out = {}
    for remat in (False, True):
        with ffn.moe_stats() as stats:
            loss, _, grads = value_and_grads(cfg.replace(remat=remat), params,
                                             batch, dp=_SecondOfTwo())
        assert len(stats) == cfg.n_layers
        assert min(int(st["dropped"]) for st in stats) > 0
        out[remat] = loss, grads
    assert torch.equal(out[True][0], out[False][0])
    for n, g in out[False][1].items():
        assert torch.equal(out[True][1][n], g), n


@pytest.mark.parametrize("name,mesh,arch,moments,accum", [
    ("1x2", {"data": 1, "model": 2}, "internlm2-1.8b", "float32", 1),
    ("1x4 int8", {"data": 1, "model": 4}, "internlm2-1.8b", "int8", 1),
    ("2x1 accum", {"data": 2, "model": 1}, "internlm2-1.8b", "float32", 2),
    ("1x2 moe", {"data": 1, "model": 2}, "qwen2-moe-a2.7b", "float32", 1),
    ("2x1 moe", {"data": 2, "model": 1}, "qwen2-moe-a2.7b", "float32", 1),
    ("oracle", {"data": 2, "model": 2}, "internlm2-1.8b", "float32", 1),
    ("1x2 hybrid", {"data": 1, "model": 2}, "jamba-1.5-large-398b",
     "float32", 1)])
def test_dry_run_counts_what_a_rank_hands_to_torch_distributed(
        runs, name, mesh, arch, moments, accum):
    """Each rank's state bytes and the tensors it hands to
    ``torch.distributed`` in its first step (kind, bytes, group size),
    recorded in the launch itself, equal ``launch.dryrun``'s counts of
    the same config, mesh, batch and coordinates exactly: the gathers
    (and ``1x2 moe``'s and the hybrid's owner broadcasts), the
    gradients' reduce-scatters and all-reduces, the norm's sum, the
    loss's sums, the int8 blocks' maxima, the MoE dispatch's sums and
    exclusive prefix."""
    from repro_torch.launch import dryrun

    d = runs["dir"]
    cfg = get_arch(arch).smoke
    if arch == "qwen2-moe-a2.7b":
        cfg = cfg.replace(**MOE_OVERRIDES)
    opt_cfg = OptConfig(moment_dtype=moments)
    stem = name.replace(" ", "_")
    for rank in range(mesh["data"] * mesh["model"]):
        with open(d / f"{stem}.jsonl.comm-{rank}.json") as f:
            rec = json.load(f)
        counts = dryrun.train_counts(cfg, opt_cfg, mesh, 8, SEQ, accum,
                                     coords=rec["coords"])
        assert counts["state_bytes"] == rec["state_bytes"] == \
            rec["predicted"], (rank, rec["coords"])
        want = sorted((c.kind, c.nbytes, c.size) for c in counts["calls"])
        assert sorted(tuple(c) for c in rec["calls"]) == want, rank
        assert want


def test_elastic_restart_on_a_smaller_mesh(runs):
    d, res = runs["dir"], runs["res"]
    _ok("2x2 then", res["2x2 then"])
    out = _ok("2x1 resumed", res["2x1 resumed"])
    assert "resumed from step 4" in out and "done" in out
    want, got = _metrics(d, "1x1"), _metrics(d, "elastic")
    _assert_metrics_close(want, got)
    _assert_close(_state(d, "1x1"), _state(d, "elastic"), PARAM_TOL)


def test_mesh_needs_its_rank_count(runs):
    rc, out, err = runs["res"]["3x1 on 2"]
    assert rc != 0
    assert "--mesh 3x1 needs a world of 3 ranks, this one has 2" in err


# --------------------------------------------------------------------- #
# the JAX package
# --------------------------------------------------------------------- #
OPT_KW = dict(peak_lr=1e-3, warmup_steps=10, decay_steps=3)


def _oracle_start(ckpt_dir):
    """The reference's initial internlm2 smoke state, written as the
    port's step-0 checkpoint; returns it (numpy)."""
    import jax

    cfg = get_arch("internlm2-1.8b").smoke
    with reference():
        from repro.configs import get_arch as ref_arch
        from repro.train import optimizer as ropt
        from repro.train import train_step as rts

        state = rts.init_train_state(ref_arch("internlm2-1.8b").smoke,
                                     ropt.OptConfig(**OPT_KW),
                                     jax.random.PRNGKey(0))
        start = jax.tree.map(np.asarray, state)
    CheckpointManager(str(ckpt_dir)).save(
        0, convert.train_state_from_numpy(start, cfg, "cpu"))
    return start


def test_mesh_matches_the_reference(runs):
    """3 steps on 2x2 from the reference's own initial state, against
    the reference's ``make_train_step`` on the same batches."""
    import jax
    import jax.numpy as jnp

    d, res = runs["dir"], runs["res"]
    _ok("oracle 2x2", res["oracle 2x2"])
    cfg = get_arch("internlm2-1.8b").smoke
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=8))
    with reference():
        from repro.configs import get_arch as ref_arch
        from repro.train import optimizer as ropt
        from repro.train import train_step as rts

        step_fn = jax.jit(rts.make_train_step(
            ref_arch("internlm2-1.8b").smoke, ropt.OptConfig(**OPT_KW)))
        state = jax.tree.map(jnp.asarray, runs["oracle"])
        losses = []
        for s in range(3):
            batch = {k: jnp.asarray(v) for k, v in data.get_batch(s).items()}
            state, met = step_fn(state, batch)
            losses.append(float(met["loss"]))
        want = jax.tree.map(np.asarray, state)
    got_losses = [r["loss"] for r in _metrics(d, "oracle")]
    np.testing.assert_allclose(got_losses, losses, rtol=1e-6, atol=0)
    got = _state(d, "oracle")
    for part, tree in (("params", got["params"]), ("m", got["opt"]["m"])):
        ref = want["params"] if part == "params" else want["opt"]["m"]
        la, lb = dict(_leaves(ref)), dict(_leaves(tree))
        assert la.keys() == lb.keys()
        for k in la:
            w = la[k].astype(np.float64)
            top = max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(lb[k].astype(np.float64) - w).max())
            assert err <= 5e-5 * top, f"{part}{k}: {err} of {top}"
    assert int(got["opt"]["step"]) == 3
