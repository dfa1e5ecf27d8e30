#!/usr/bin/env python3
"""Regenerate the port's goldens for ML traffic and the decoder LMs
(dense, MoE, MLA) from the JAX reference, on the CPU.

    PYTHONPATH=src python tests/goldens/regen_torch.py            # all
    PYTHONPATH=src python tests/goldens/regen_torch.py mltraffic
    PYTHONPATH=src python tests/goldens/regen_torch.py dense moe mla
    PYTHONPATH=src python tests/goldens/regen_torch.py vlm ssm

Self-contained (it inserts ``src`` itself) and deterministic: a second
run writes the same bytes.

* ``mltraffic/<stem>__<phase>.hlo.gz``: the post-SPMD HLO of each phase
  program of the ML-traffic stage's four workloads (qwen2-moe decode;
  dbrx, internlm2 and stablelm train and decode), lowered by the
  reference's ``noc/mltraffic.py::_lower_phase`` on 8 forced host
  devices, one phase a process.  The source-location metadata (the
  ``FileNames`` … ``StackFrames`` tables and each instruction's
  ``metadata={...}``) is dropped: it names the lowering's own files.
  The reference's parser reads the same ops and statistics from the
  stripped text as from the full one; the script checks that.
* ``mltraffic.json``: the reference's results on those texts — every
  collective op, the totals, the campaign matrix on torus(2,4), the
  XY / BiDOR / refined max link loads, the plan's and the refined choice
  tables, the refined table's certificate, and the stage's campaign rows
  (XY and BiDOR, rates 0.1 and 0.3, seed 0) at 200 and 2 000 cycles.
* ``serve_dense_smoke.json``: the three dense smoke configurations'
  float32 logits (prefill and every decode step) and greedy tokens for
  ``repro_torch.serve.golden.dense_numpy_case``, at the batch of
  ``examples/serve_decode.py`` (4 requests, 16-token prompts, 24 new
  tokens).
* ``serve_moe_smoke.json``: the same for qwen2-moe, dbrx and Jamba (with
  its 4 experts) at their smoke configurations, with each call's
  auxiliary loss and dropped (token, slot) pairs summed over the layers
  (read from the reference's routes by :func:`reference_moe_stats`);
  ``serve_mla_smoke.json``: minicpm3's smoke configuration.
* ``serve_vlm_smoke.json``: qwen2-vl's smoke configuration served as
  the dense ones (equal t/h/w ids, as the reference's engine passes no
  positions), and under ``IMAGE_KEY`` an image-style prefill
  (``golden.vlm_image_case``: 4 text tokens, an 8 x 8 patch grid of
  stub-frontend embeddings at patch-grid M-RoPE ids, 4 text tokens) at
  the golden's batch of 2, then ``golden.IMAGE_STEPS`` greedy decode
  steps at the reference's default positions.
* ``serve_ssm_smoke.json``: xLSTM's smoke configuration
  (``golden.xlstm_numpy_case``) at the example's batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SRC = os.path.join(ROOT, "src")
TESTS = os.path.dirname(HERE)
for _p in (SRC, TESTS, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import chip_smoke  # noqa: E402  (the records the card's check reads)

HLO_DIR = os.path.join(HERE, "mltraffic")
MLTRAFFIC_JSON = os.path.join(HERE, "mltraffic.json")
DENSE_JSON = os.path.join(HERE, "serve_dense_smoke.json")
MOE_JSON = os.path.join(HERE, "serve_moe_smoke.json")
MLA_JSON = os.path.join(HERE, "serve_mla_smoke.json")
VLM_JSON = os.path.join(HERE, "serve_vlm_smoke.json")
SSM_JSON = os.path.join(HERE, "serve_ssm_smoke.json")
IMAGE_KEY = "image"
# parameters the reference keeps in float32 whatever the model's dtype
FP32_KEEP = ("ln1", "ln2", "ln_f", "q_norm", "kv_norm", "router", "attn_ln",
             "mamba_ln", "ffn_ln", "dt_bias", "a_log", "d_skip", "slstm_ln",
             "slstm_ffn_ln", "mlstm_ln", "norm", "wi", "bi", "wf", "bf", "r",
             "b")
TOPO = chip_smoke.MLTRAFFIC_TOPO   # torus(2, 4): 8 nodes, 8 mesh ranks
CYCLES = (200, 2000)               # BENCH_QUICK=1, and =0
_META_TABLES = ("FileNames", "FunctionNames", "FileLocations",
                "StackFrames")
_META_ATTR = re.compile(r", metadata=\{[^{}]*\}")


def stage_grid():
    """The stage's (spec, is MoE) pairs as the reference's specs."""
    from repro.noc.mltraffic import WorkloadSpec
    from repro_torch.noc.mltraffic import STAGE_GRID

    return [(WorkloadSpec(**dataclasses.asdict(s)), moe)
            for s, moe in STAGE_GRID]


# --------------------------------------------------------------------- #
# the HLO texts
# --------------------------------------------------------------------- #
def strip_hlo(text: str) -> str:
    """The text without its source-location metadata."""
    out, skip = [], False
    for line in text.splitlines():
        if line in _META_TABLES:
            skip = True
            continue
        if skip:
            skip = line != ""
            continue
        out.append(_META_ATTR.sub("", line))
    return "\n".join(out) + "\n"


def lower_one(name: str, phase: str) -> str:
    """One phase program's stripped post-SPMD HLO; run in a process with
    ``--xla_force_host_platform_device_count=8``.  Raises if stripping
    changed what the parser reads."""
    from repro.analysis.hlo import analyze_hlo_text, collective_ops
    from repro.noc.mltraffic import _lower_phase
    from test_torch_oracle import reference

    spec = {s.name: s for s, _ in stage_grid()}[name]
    with reference():
        raw = _lower_phase(spec, phase)
    text = strip_hlo(raw)
    d = spec.num_devices
    if "metadata=" in text or (
            collective_ops(text, d) != collective_ops(raw, d)
            or analyze_hlo_text(text, d) != analyze_hlo_text(raw, d)):
        raise SystemExit(f"{name} {phase}: stripping changed the parse")
    return text


def write_gz(path: str, text: str) -> None:
    """gzip with no name and no time in its header: stable bytes."""
    with open(path, "wb") as f:
        f.write(gzip.compress(text.encode(), compresslevel=9, mtime=0))


def lower_in_child(name: str, phase: str, out: str) -> None:
    """Lower one phase in a fresh interpreter with 8 host devices (the
    flag only takes effect before JAX's first initialisation)."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--lower", name, phase,
         out], env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise SystemExit(f"lowering {name} {phase} failed:\n"
                         f"{proc.stderr[-3000:]}")


def record_hlo(hlo_dir: str = HLO_DIR) -> None:
    from repro_torch.noc.mltraffic import hlo_path

    os.makedirs(hlo_dir, exist_ok=True)
    for spec, _ in stage_grid():
        for phase in spec.phases:
            lower_in_child(spec.name, phase, hlo_path(spec, phase, hlo_dir))


def read_texts(spec, hlo_dir: str = HLO_DIR) -> dict[str, str]:
    from repro_torch.noc.mltraffic import hlo_path

    out = {}
    for phase in spec.phases:
        with gzip.open(hlo_path(spec, phase, hlo_dir), "rt") as f:
            out[phase] = f.read()
    return out


# --------------------------------------------------------------------- #
# the reference's results on the recorded texts
# --------------------------------------------------------------------- #
def reference_workload(spec, texts):
    """The reference's ``derive`` with the recorded texts in place of
    its lowering."""
    from repro.analysis.hlo import collective_flow_totals, collective_ops
    from repro.noc.mltraffic import MLWorkload, collective_flows

    flows, totals, counts = {}, {}, {}
    for phase in spec.phases:
        ops = collective_ops(texts[phase], spec.num_devices)
        flows[phase] = collective_flows(ops, spec.num_devices)
        totals[phase] = collective_flow_totals(ops)
        counts[phase] = len(ops)
    return MLWorkload(spec=spec, flows=flows, totals=totals,
                      meta={"collective_op_counts": counts})


def reference_rows(workloads, tables, cycles: int) -> list[dict]:
    """The stage's campaign on the reference, as ``chip_smoke.py`` records
    the card's (``mltraffic_spec``, ``point_record``)."""
    import repro.noc as noc
    from repro.core import torus
    from test_torch_oracle import reference

    spec = chip_smoke.mltraffic_spec(noc, torus(*TOPO), workloads, cycles)
    with reference():
        res = noc.run_campaign(spec, bidor_tables=tables or None)
    return [chip_smoke.point_record(p) for p in res.points]


def reference_plans(hlo_dir: str = HLO_DIR):
    """(workload records, workloads, MoE refined tables): the stage's
    per-workload body on the reference."""
    import numpy as np
    from repro.analysis.hlo import collective_ops
    from repro.core import (bidor, build_plan, certify_table,
                            link_load_stats, torus)
    from repro.core.bidor import greedy_refine
    from test_torch_oracle import reference

    topo = torus(*TOPO)
    xy = bidor(topo, np.zeros(topo.num_nodes))

    def mx(tm, table):
        return float(link_load_stats(topo, tm, table)["max"])

    recs, wls, tables = [], [], {}
    with reference():
        for spec, moe in stage_grid():
            texts = read_texts(spec, hlo_dir)
            wl = reference_workload(spec, texts)
            tm = wl.matrix_for(topo)
            plan = build_plan(topo, tm)
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
                "ops": {ph: [chip_smoke.op_record(op) for op in collective_ops(
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


def mltraffic_golden(hlo_dir: str = HLO_DIR,
                     cycles: tuple[int, ...] = CYCLES) -> dict:
    recs, wls, tables = reference_plans(hlo_dir)
    return {
        "description": (
            "The JAX reference's results on the recorded post-SPMD HLO of "
            "the ML-traffic stage (benchmarks/run.py, bench_ml_traffic): "
            "ops, totals, the campaign matrix on torus(2,4), max link "
            "loads, plan and refined choice tables, the refined table's "
            "certificate, and the campaign rows (XY, BiDOR; MoE cells on "
            "the refined tables). Written by tests/goldens/regen_torch.py"),
        "topo": list(TOPO), "rates": [0.1, 0.3], "seeds": [0],
        "workloads": recs,
        "campaign": {str(c): reference_rows(wls, tables, c)
                     for c in cycles}}


# --------------------------------------------------------------------- #
# the dense smoke serve golden
# --------------------------------------------------------------------- #
def reference_routes(cfg, p, x):
    """(experts (T, k), keep (T, k)): the routes the reference's
    ``moe_apply`` takes for ``x`` and which of them fit their expert's
    capacity, from its router, ``lax.top_k``, capacity and queue
    positions, recomputed as it computes them (it returns neither)."""
    import jax
    import jax.numpy as jnp

    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    e_buf = max(cfg.moe_pad_to, e) if cfg.moe_pad_to else e
    t = b * s
    logits = jnp.einsum("td,de->te", x.reshape(t, d).astype(jnp.float32),
                        p["router"])
    _, experts = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    capacity = int(max(1, -(-t * k // e)) * cfg.capacity_factor)
    flat = experts.reshape(-1)
    pos = jnp.cumsum(jax.nn.one_hot(flat, e_buf, dtype=jnp.int32), 0) - 1
    pos = jnp.take_along_axis(pos, flat[:, None], 1)[:, 0]
    return experts, (pos < capacity).reshape(t, k)


@contextlib.contextmanager
def reference_moe_stats():
    """Within this scope every reference MoE layer (``models/lm.py`` and
    ``models/hybrid.py``) reports its (dropped pairs, aux) to the yielded
    list through a host callback, under ``jit`` and ``lax.scan`` too."""
    import jax
    import jax.numpy as jnp
    from repro.models import hybrid, lm
    from repro.models.layers import ffn

    calls = []
    orig = ffn.moe_apply

    def traced(cfg, p, x):
        y, aux = orig(cfg, p, x)
        jax.debug.callback(
            lambda n, a: calls.append((int(n), float(a))),
            jnp.sum(~reference_routes(cfg, p, x)[1]), aux)
        return y, aux

    lm.moe_apply = hybrid.moe_apply = traced
    try:
        yield calls
    finally:
        lm.moe_apply = hybrid.moe_apply = orig


def _call_stats(calls: list) -> tuple[float, int]:
    """One call's (aux, dropped) summed over its layers, in a fixed order
    (the callbacks may come in any)."""
    import jax

    jax.effects_barrier()
    aux = sum(sorted(a for _, a in calls))
    dropped = sum(n for n, _ in calls)
    calls.clear()
    return aux, dropped


def serve_reference_case(arch: str, dtype: str = "float32"):
    """Serve ``arch``'s smoke numpy case (``golden.lm_numpy_case``) on the
    reference: (config, tree, prompts, logits of the prefill and every
    decode step, tokens, each call's aux, each call's dropped pairs).
    Tokens come from its jitted ``ServeEngine``, logits from its
    ``prefill``/``decode_step``, jitted as the engine's, fed those
    tokens; aux and drops are 0 without experts."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_arch as ref_get_arch
    from repro.models import registry as ref_registry
    from repro.serve import ServeEngine as RefEngine
    from repro_torch.configs import get_arch
    from repro_torch.serve import golden
    from test_torch_oracle import reference

    cfg = get_arch(arch).smoke.replace(dtype=dtype)
    ref_cfg = ref_get_arch(arch).smoke.replace(dtype=dtype)
    mod = ref_registry.model_module(ref_cfg)
    tree, prompts = golden.lm_numpy_case(cfg)
    params = reference_params(tree, dtype)
    n, p = golden.DENSE_NEW_TOKENS, golden.DENSE_PROMPT_LEN
    max_len = p + n + golden.CACHE_SLACK
    with reference(), reference_moe_stats() as calls:
        prefill = jax.jit(lambda *a: mod.prefill(ref_cfg, *a))
        step = jax.jit(lambda *a: mod.decode_step(ref_cfg, *a))
        tokens = np.asarray(RefEngine(cfg=ref_cfg, params=params,
                                      max_len=max_len).generate(prompts, n))
        _call_stats(calls)
        cache = mod.init_cache(ref_cfg, golden.DENSE_BATCH, max_len)
        logits, cache = prefill(params, jnp.asarray(prompts), cache)
        out = [np.asarray(logits, np.float32)]
        stats = [_call_stats(calls)]
        for i in range(n - 1):
            logits, cache = step(params, jnp.asarray(tokens[:, i:i + 1]),
                                 cache, jnp.int32(p + i))
            out.append(np.asarray(logits, np.float32))
            stats.append(_call_stats(calls))
    aux, dropped = (list(x) for x in zip(*stats))
    return cfg, tree, prompts, out, tokens, aux, dropped


def serve_golden_text(archs) -> str:
    """The records of ``archs`` (a MoE one with its aux and drops), keyed
    by configuration name: the text of a serve golden."""
    from repro_torch.serve import golden

    recs = {}
    for arch in archs:
        cfg, _, _, logits, tokens, aux, dropped = serve_reference_case(arch)
        if cfg.is_moe:
            recs[cfg.name] = golden.moe_record(cfg, logits[0], logits[1:],
                                               tokens, aux, dropped)
        else:
            recs[cfg.name] = golden.record(cfg, logits[0], logits[1:],
                                           tokens)
    return json.dumps(recs, separators=(",", ":")) + "\n"


def reference_params(tree, dtype: str):
    """The numpy tree as the reference holds it in ``dtype`` (the
    parameters of ``FP32_KEEP`` float32)."""
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a, jnp.float32 if any(
            getattr(k, "key", None) in FP32_KEEP for k in path)
            else jnp.dtype(dtype)), tree)


def vlm_image_reference_case(dtype: str = "float32"):
    """qwen2-vl's smoke numpy tree with the image-style prompt on the
    reference: (config, tree, text, patches, positions, logits of the
    prefill and each decode step, greedy tokens).  The prefill takes the
    merged embeddings and the (3, B, 72) ids; each step the last greedy
    token at the reference's default positions."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_arch as ref_get_arch
    from repro.models import lm as ref_lm
    from repro_torch.configs import get_arch
    from repro_torch.serve import golden
    from test_torch_oracle import reference

    cfg = get_arch("qwen2-vl-2b").smoke.replace(dtype=dtype)
    ref_cfg = ref_get_arch("qwen2-vl-2b").smoke.replace(dtype=dtype)
    tree, _ = golden.dense_numpy_case(cfg)
    text, patches, pos = golden.vlm_image_case(cfg)
    params = reference_params(tree, dtype)
    n, p = golden.IMAGE_STEPS, golden.IMAGE_LEN
    with reference():
        emb = golden.image_embeds(np.asarray(params["embed"]["table"][
            jnp.asarray(text)]), patches.astype(jnp.dtype(dtype)))
        prefill = jax.jit(lambda *a, **k: ref_lm.prefill(ref_cfg, *a, **k))
        step = jax.jit(lambda *a: ref_lm.decode_step(ref_cfg, *a))
        cache = ref_lm.init_cache(ref_cfg, golden.BATCH,
                                  p + n + golden.CACHE_SLACK)
        logits, cache = prefill(params, None, cache,
                                positions=jnp.asarray(pos),
                                embeds=jnp.asarray(emb))
        out = [np.asarray(logits, np.float32)]
        toks = [np.argmax(out[0][:, -1:], -1).astype(np.int32)]
        for i in range(n):
            logits, cache = step(params, jnp.asarray(toks[-1]), cache,
                                 jnp.int32(p + i))
            out.append(np.asarray(logits, np.float32))
            toks.append(np.argmax(out[-1][:, -1:], -1).astype(np.int32))
    return cfg, tree, text, patches, pos, out, np.concatenate(toks, 1)


def vlm_golden_text() -> str:
    """``serve_vlm_smoke.json``: the served record and, under
    ``IMAGE_KEY``, the image-style prefill's."""
    from repro_torch.serve import golden

    recs = json.loads(serve_golden_text(golden.VLM_ARCHS))
    cfg, _, _, _, _, logits, tokens = vlm_image_reference_case()
    rec = golden.record(cfg, logits[0], logits[1:], tokens)
    rec["image"] = {"text_before": golden.IMAGE_BEFORE,
                    "grid": list(golden.IMAGE_GRID),
                    "text_after": golden.IMAGE_AFTER}
    recs[IMAGE_KEY] = rec
    return json.dumps(recs, separators=(",", ":")) + "\n"


def main(argv: list[str]) -> int:
    if argv[:1] == ["--lower"]:
        name, phase, out = argv[1:4]
        write_gz(out, lower_one(name, phase))
        return 0
    every = ["mltraffic", "dense", "moe", "mla", "vlm", "ssm"]
    what = argv or every
    if what == ["all"]:
        what = every
    if "mltraffic" in what:
        record_hlo()
        with open(MLTRAFFIC_JSON, "w") as f:
            json.dump(mltraffic_golden(), f, separators=(",", ":"))
            f.write("\n")
        print(f"wrote {HLO_DIR}/ and {MLTRAFFIC_JSON}", file=sys.stderr)
    from repro_torch.serve import golden

    for name, path, archs in (("dense", DENSE_JSON, golden.DENSE_ARCHS),
                              ("moe", MOE_JSON, golden.MOE_ARCHS),
                              ("mla", MLA_JSON, golden.MLA_ARCHS),
                              ("ssm", SSM_JSON, golden.SSM_ARCHS)):
        if name in what:
            with open(path, "w") as f:
                f.write(serve_golden_text(archs))
            print(f"wrote {path}", file=sys.stderr)
    if "vlm" in what:
        with open(VLM_JSON, "w") as f:
            f.write(vlm_golden_text())
        print(f"wrote {VLM_JSON}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
