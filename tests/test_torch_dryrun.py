"""The dry run (``repro_torch.launch.dryrun``) and the H100 roofline
(``repro_torch.analysis.hlo``) on the CPU.

* The roofline terms and their dominance, the reference's test at the
  H100's peaks; each group's link (NVLink inside a node of 8, the NIC
  across nodes).
* The dot FLOPs of one train step at the internlm2 and qwen2-moe smoke
  configs on one device, against the reference's
  ``analyze_hlo_text(compiled.as_text(), 1).flops`` of its compiled
  step, within 2 %.  One term is counted differently by design:
  attention.  The port counts each head's causal (query, key) pairs;
  the reference's chunked op computes whole (q_chunk × kv_chunk) blocks
  on and below the diagonal.  Both count 2 products in the forward and
  5 in the backward; the test sets each program's attention term by its
  own rule beside the rest.
* A one-device state's bytes against ``init_train_state``'s tensors;
  a ``1xM`` step's FLOPs a device equal to one device's (every rank
  runs the whole model on its rows: no tensor parallelism yet).
* codeqwen1.5-7b at its published widths and depth on four ranks
  (``4x1``) at the launcher's batch: the step gathers a layer at a
  time and reduce-scatters the gradients, so a rank fits a card.
* The CLI in a subprocess on one cell, the reference's
  ``tests/test_launch_distributed.py::test_dryrun_entrypoint_small_cell``
  with the reference's record keys.
The counts against real ranks under ``torch.distributed.run`` are in
``tests/test_torch_mesh_train.py``.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_oracle import reference

from repro_torch.analysis.hlo import (BF16_FLOPS, HBM_BW, NIC_BW,
                                      NVLINK_BW, HloStats, group_bandwidth,
                                      roofline_terms)
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.models.common import param_bytes
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, SEQ = 2, 64


def test_roofline_terms_and_dominance():
    st = HloStats(flops=989e12, hbm_bytes=3.35e12 / 2,
                  collective_wire_bytes=450e9 / 4)
    rl = roofline_terms(st, num_chips=4, model_flops=4 * 989e12 * 0.5)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(0.5)
    assert rl.collective_s == pytest.approx(0.25)
    assert rl.dominant == "compute"
    assert rl.bound_s == pytest.approx(1.0)
    assert rl.mfu_bound == pytest.approx(0.5)
    assert rl.useful_flops_ratio == pytest.approx(0.5)
    assert (BF16_FLOPS, HBM_BW, NVLINK_BW, NIC_BW) == (989e12, 3.35e12,
                                                       450e9, 50e9)
    rl = roofline_terms(st, num_chips=4, model_flops=0, collective_s=3.0)
    assert rl.dominant == "collective" and rl.bound_s == 3.0


def test_group_bandwidth_by_node():
    assert group_bandwidth(range(8)) == NVLINK_BW
    assert group_bandwidth([8, 9, 15]) == NVLINK_BW
    assert group_bandwidth([7, 8]) == NIC_BW
    # the 16 x 16 mesh, row-major: a model group is 16 consecutive
    # ranks (two nodes), a data group ranks 16 apart
    sizes = {"data": 16, "model": 16}
    for axes in (("model",), ("data",)):
        ranks = dryrun._group_ranks(sizes, {"data": 3, "model": 5}, axes)
        assert len(ranks) == 16 and group_bandwidth(ranks) == NIC_BW
    ranks = dryrun._group_ranks({"data": 2, "model": 2},
                                {"data": 1, "model": 0}, ("model",))
    assert ranks == [2, 3] and group_bandwidth(ranks) == NVLINK_BW


@pytest.mark.parametrize("sq,skv", [(1, 1), (5, 5), (3, 7), (7, 3),
                                    (64, 64), (1, 33)])
def test_causal_pairs(sq, skv):
    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    assert dryrun.causal_pairs(sq, skv) == int((j <= i + skv - sq).sum())


def _block_pairs(s: int, cq: int, ck: int) -> int:
    """(query, key) pairs of the reference's chunked causal op: each
    query chunk against every key chunk holding a key on or below its
    last query's diagonal, whole."""
    out = 0
    for q0 in range(0, s, cq):
        last = min(q0 + cq, s) - 1
        for k0 in range(0, s, ck):
            if k0 <= last:
                out += (min(q0 + cq, s) - q0) * (min(k0 + ck, s) - k0)
    return out


def _reference_flops(arch: str) -> float:
    import jax
    import jax.numpy as jnp

    with reference():
        from repro.analysis.hlo import analyze_hlo_text
        from repro.configs import get_arch as ref_arch
        from repro.train.optimizer import OptConfig as RefOpt
        from repro.train.train_step import init_train_state as ref_init
        from repro.train.train_step import make_train_step

        cfg = ref_arch(arch).smoke
        opt = RefOpt()
        state = jax.eval_shape(
            lambda: ref_init(cfg, opt, jax.random.PRNGKey(0)))
        sds = jax.ShapeDtypeStruct
        batch = {"tokens": sds((ROWS, SEQ), jnp.int32),
                 "labels": sds((ROWS, SEQ), jnp.int32),
                 "mask": sds((ROWS, SEQ), jnp.float32)}
        compiled = jax.jit(make_train_step(cfg, opt)).lower(
            state, batch).compile()
        return analyze_hlo_text(compiled.as_text(), 1).flops


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-moe-a2.7b"])
def test_dot_flops_match_the_reference_hlo(arch):
    cfg = get_arch(arch).smoke
    counts = dryrun.train_counts(cfg, OptConfig(), {"data": 1, "model": 1},
                                 ROWS, SEQ)
    assert counts["calls"] == [] and counts["microbatches"] == 1
    attn_layers = cfg.n_layers
    per_pair = (dryrun.attention_flops(ROWS, cfg.n_heads, cfg.head_dim,
                                       cfg.head_dim, 1, False)
                + dryrun.attention_flops(ROWS, cfg.n_heads, cfg.head_dim,
                                         cfg.head_dim, 1, True))
    port_attn = attn_layers * per_pair * dryrun.causal_pairs(SEQ, SEQ)
    assert counts["attention_flops"] == port_attn
    ref = _reference_flops(arch)
    ref_attn = attn_layers * per_pair * _block_pairs(
        SEQ, cfg.attn_q_chunk, cfg.attn_kv_chunk)
    rest, ref_rest = counts["flops"] - port_attn, ref - ref_attn
    assert abs(rest - ref_rest) <= 0.02 * ref_rest, (rest, ref_rest)
    assert abs(counts["flops"] - port_attn + ref_attn - ref) <= 0.02 * ref


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_one_device_state_bytes_equal_the_state(moments):
    from repro_torch.train.checkpoint import flatten

    cfg = get_arch("internlm2-1.8b").smoke
    opt_cfg = OptConfig(moment_dtype=moments)
    counts = dryrun.train_counts(cfg, opt_cfg, {"data": 1, "model": 1}, 4,
                                 16)
    state = init_train_state(cfg, opt_cfg, device="cpu")
    assert counts["state_bytes"] == sum(
        t.numel() * t.element_size() for _, t in flatten(state))
    assert counts["temp_bytes"] >= param_bytes(state["params"])


def test_model_axis_runs_the_whole_model_on_every_rank():
    """The port's step gathers every weight whole: a ``1x2`` rank does
    one device's FLOPs on the same rows, and all-reduces nothing."""
    cfg = get_arch("internlm2-1.8b").smoke
    one = dryrun.train_counts(cfg, OptConfig(), {"data": 1, "model": 1},
                              4, 16)
    two = dryrun.train_counts(cfg, OptConfig(), {"data": 1, "model": 2},
                              4, 16)
    half = dryrun.train_counts(cfg, OptConfig(), {"data": 2, "model": 1},
                               4, 16)
    assert two["flops"] == one["flops"] == 2 * half["flops"]
    assert {c.kind for c in two["calls"]} == {"all_gather"}
    assert two["state_bytes"] < one["state_bytes"]


def test_codeqwen_fits_a_card_on_four_data_ranks():
    """A rank of ``4x1`` holds its shards (about 19 GiB), their fp32
    gradients, one layer gathered and the head: the dry run's peak is
    under 40 GiB, where the model gathered whole beside its bf16 and
    fp32 gradients would need about 86 GB; the temp holds less than the
    bf16 model (16.4 GB), so no step gathers it whole, and the
    gradients leave the backward by reduce-scatters."""
    from repro_torch.models import registry

    cfg = get_arch("codeqwen1.5-7b").full
    counts = dryrun.train_counts(cfg, OptConfig(), {"data": 4, "model": 1},
                                 8, 128)
    mem = dryrun.record_of(counts, {"model_flops": 0.0}, 4)["memory"]
    assert mem["fits"] and mem["peak_gb"] < 40.0, mem
    assert counts["temp_bytes"] < 2 * registry.count_params(cfg)
    assert counts["rows"] == 2
    assert {c.kind for c in counts["calls"]} == {"all_gather",
                                                 "reduce_scatter",
                                                 "all_reduce"}


REF_KEYS = {"arch", "shape", "mesh", "variant", "kind", "num_chips",
            "lower_s", "compile_s", "memory", "xla_cost_analysis",
            "per_device", "roofline", "grad_accum"}
REF_MEMORY = {"argument_gb", "output_gb", "temp_gb", "alias_gb", "peak_gb"}
REF_DEVICE = {"flops", "hbm_bytes", "collective_bytes",
              "collective_wire_bytes", "collective_counts"}
REF_ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant",
                "model_flops", "useful_flops_ratio", "mfu_bound"}


def test_dryrun_entrypoint_small_cell(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-base", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "all requested dry-run cells counted" in res.stdout
    (art,) = glob.glob(str(tmp_path / "*.json"))
    assert os.path.basename(art) == "whisper-base__decode_32k__single.json"
    with open(art) as f:
        rec = json.load(f)
    assert REF_KEYS <= set(rec)
    assert REF_MEMORY <= set(rec["memory"])
    assert REF_DEVICE <= set(rec["per_device"])
    assert REF_ROOFLINE <= set(rec["roofline"])
    assert rec["lower_s"] is None and rec["xla_cost_analysis"] is None
    assert rec["num_chips"] == 256 and rec["kind"] == "decode"
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert 0 < rec["memory"]["peak_gb"] < 16.0
    assert rec["per_device"]["collective_counts"]["all-gather"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_xlstm_counts_extended_along_the_sequence(kind, monkeypatch):
    """xLSTM's counts, taken at two and three chunks and extended, equal
    a direct count at eight: FLOPs, the calls and the argument bytes
    exactly; the live-byte peak, a maximum over the step of sets that
    grow at their own rates, within 5 %."""
    cfg = get_arch("xlstm-1.3b").smoke
    seq, mesh = 8 * cfg.xlstm_chunk, {"data": 1, "model": 2}
    assert dryrun.along_sequence(cfg, seq) == cfg.xlstm_chunk

    def count():
        if kind == "train":
            return dryrun.train_counts(cfg, OptConfig(), mesh, 4, seq)
        return dryrun.serve_counts(cfg, "prefill", mesh, 4, seq)

    got = count()
    monkeypatch.setattr(dryrun, "along_sequence", lambda cfg, seq: 0)
    want = count()
    for k in ("flops", "argument_bytes", "batch_bytes", "state_bytes"):
        assert got.get(k) == want.get(k), k
    assert abs(got["temp_bytes"] - want["temp_bytes"]) <= \
        0.05 * want["temp_bytes"]
    assert [(c.kind, c.nbytes) for c in got["calls"]] == \
        [(c.kind, c.nbytes) for c in want["calls"]]


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "internlm2-1.8b",
                                  "jamba-1.5-large-398b"])
def test_serve_counts_on_a_data_and_model_mesh(arch):
    """A serving rank on ``2x2`` runs its 2 of the 4 rows with the
    weights gathered whole: its FLOPs are half one device's, and its
    only collectives are the gathers (the cache's over ``model``; the
    sLSTM state, which the specs leave unsplit on the batch, whole)."""
    cfg = get_arch(arch).smoke
    for kind in ("prefill", "decode"):
        one = dryrun.serve_counts(cfg, kind, {"data": 1, "model": 1}, 4, 16)
        got = dryrun.serve_counts(cfg, kind, {"data": 2, "model": 2}, 4, 16)
        assert (one["rows"], got["rows"]) == (4, 2)
        assert one["calls"] == [] and got["calls"]
        assert {c.kind for c in got["calls"]} <= {"all_gather", "broadcast"}
        assert got["flops"] == pytest.approx(one["flops"] / 2, rel=0.02)
        assert 0 < got["argument_bytes"] < one["argument_bytes"]
