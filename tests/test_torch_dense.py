"""The dense LM family (codeqwen1.5-7b, internlm2-1.8b, stablelm-3b) on the
port, on the CPU, against the JAX package.

At each smoke configuration (2 layers, d 64; GQA 4/2 for internlm2, MHA
4/4 for the others, stablelm's head dim 16) with the reference's
parameters carried across by ``convert.dense_params_from_numpy``:
``forward``, the prefill's and every decode step's logits, and
``ServeEngine.generate``'s greedy tokens, at the batch of the
reference's ``examples/serve_decode.py`` (4 requests, 16-token prompts,
24 new tokens).  Tolerances: 1e-5 (rtol and atol) in float32; 2e-2 in
bfloat16.  The published configurations' parameter counts against the
reference's analytic count, with nothing allocated.

Parameters and prompts come from numpy
(:func:`repro_torch.serve.golden.dense_numpy_case`).
``tests/goldens/serve_dense_smoke.json`` is the reference's record of the
float32 cases; ``tests/goldens/regen_torch.py dense`` rewrites it.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.serve import ServeEngine, golden  # noqa: E402
from test_torch_oracle import reference, torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
GOLDEN_PATH = os.path.join(GOLDENS, golden.DENSE_GOLDEN_NAME)
ARCHS = golden.DENSE_ARCHS
MAX_LEN = golden.DENSE_PROMPT_LEN + golden.DENSE_NEW_TOKENS + \
    golden.CACHE_SLACK
F32 = 1e-5
BF16 = 2e-2


def _regen():
    spec = importlib.util.spec_from_file_location(
        "regen_torch", os.path.join(GOLDENS, "regen_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CASES = {}


def _case(arch, dtype="float32"):
    """(config, tree, prompts, reference logits, reference tokens)."""
    if (arch, dtype) not in _CASES:
        _CASES[arch, dtype] = _regen().serve_reference_case(arch,
                                                            dtype)[:5]
    return _CASES[arch, dtype]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """FULL and SMOKE field for field; the port registers all three."""
    got, want = get_arch(arch), ref_get_arch(arch)
    for a, b in ((got.full, want.full), (got.smoke, want.smoke)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert got.shapes == want.shapes
    assert got.skipped_shapes == want.skipped_shapes
    assert registry.model_module(got.full) is lm


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_of_full_config_matches_reference(arch):
    """The published configurations on the meta device: the reference's
    analytic count, nothing allocated."""
    cfg = get_arch(arch).full
    model = registry.init(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert cfg.param_count() == ref_registry.count_params(
        ref_get_arch(arch).full)
    want = {"codeqwen1.5-7b": 8_189_644_800, "internlm2-1.8b": 1_889_110_016,
            "stablelm-3b": 2_795_276_800}
    assert cfg.param_count() == want[arch]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    cfg = get_arch(arch).smoke.replace(dtype=dtype)
    ref_cfg = ref_get_arch(arch).smoke.replace(dtype=dtype)
    tree, prompts = golden.dense_numpy_case(cfg)
    ref_tree = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a, jnp.float32 if any(
            getattr(k, "key", None) in ("ln1", "ln2", "ln_f") for k in path)
            else jnp.dtype(dtype)), tree)
    with reference():
        want, aux = ref_lm.forward(ref_cfg, ref_tree, jnp.asarray(prompts))
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    got, got_aux = lm.forward(cfg, model, torch.as_tensor(prompts))
    assert got.dtype == torch.float32 and float(got_aux) == float(aux) == 0
    assert got.shape == (golden.DENSE_BATCH, golden.DENSE_PROMPT_LEN,
                         cfg.vocab)
    _close(got, want, F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_every_decode_step_match_reference(arch):
    """Logits of the prefill and of each decode step, each step fed the
    reference's greedy token; the cache keeps the reference's layout; no
    kernel is launched on the CPU."""
    cfg, tree, prompts, logits, tokens = _case(arch)
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    before = dict(kernels.LAUNCHES)
    cache = lm.init_cache(cfg, golden.DENSE_BATCH, MAX_LEN, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, golden.DENSE_BATCH, MAX_LEN,
                                cfg.n_kv_heads, cfg.head_dim)
    got, cache = lm.prefill(cfg, model, torch.as_tensor(prompts), cache)
    _close(got, logits[0], F32)
    for i in range(golden.DENSE_NEW_TOKENS - 1):
        got, cache = lm.decode_step(
            cfg, model, torch.as_tensor(tokens[:, i:i + 1]), cache,
            golden.DENSE_PROMPT_LEN + i)
        assert got.shape == (golden.DENSE_BATCH, 1, cfg.vocab)
        _close(got, logits[i + 1], F32)
    assert kernels.LAUNCHES == before
    filled = golden.DENSE_PROMPT_LEN + golden.DENSE_NEW_TOKENS - 1
    assert not cache["k"][:, :, filled:].any()
    assert cache["k"][:, :, :filled].abs().amax(dim=(0, 1, 3, 4)).gt(0).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_reference(arch):
    """Greedy tokens equal, logits at every step within 1e-5, and the
    tokens vary (the case is not one repeated token)."""
    cfg, tree, prompts, logits, tokens = _case(arch)
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    toks, got = ServeEngine(cfg, model, MAX_LEN).generate(
        prompts, golden.DENSE_NEW_TOKENS, return_logits=True)
    assert toks.dtype == np.int32 and toks.shape == tokens.shape
    np.testing.assert_array_equal(toks, tokens)
    assert min(len(set(row)) for row in toks.tolist()) >= 4
    for g, w in zip(got, logits):
        _close(g, w, F32)


def test_bf16_serving_matches_reference():
    """internlm2's smoke case in bfloat16 on both sides: the served
    logits (fp32) of the prefill and every step, fed the reference's
    tokens, at 2e-2."""
    cfg, tree, prompts, logits, tokens = _case("internlm2-1.8b", "bfloat16")
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    assert model.blocks[0].attn.wq.dtype == torch.bfloat16
    assert model.blocks[0].ln1.scale.dtype == torch.float32
    got = ServeEngine(cfg, model, MAX_LEN).teacher_forced_logits(prompts,
                                                                 tokens)
    assert all(x.dtype == torch.float32 for x in got)
    for g, w in zip(got, logits):
        _close(g, w, BF16)


@pytest.mark.parametrize("arch", sorted(
    ["codeqwen1.5-7b", "dbrx-132b", "internlm2-1.8b", "jamba-1.5-large-398b",
     "minicpm3-4b", "qwen2-moe-a2.7b", "qwen2-vl-2b", "stablelm-3b",
     "whisper-base", "xlstm-1.3b"]))
def test_every_reference_arch_builds_through_the_registry(arch):
    """Each of the reference's ten architectures builds through the
    port's registry on the meta device (nothing allocated), with the
    reference's parameter count; its family's module serves it."""
    from repro.configs import list_archs as ref_list_archs
    from repro_torch.configs import list_archs

    assert ref_list_archs() == list_archs()
    assert arch in list_archs()
    cfg = get_arch(arch).full
    model = registry.init(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert registry.count_params(cfg) == ref_registry.count_params(
        ref_get_arch(arch).full)
    mod = registry.model_module(cfg)
    for name in ("init", "forward", "init_cache", "prefill", "decode_step"):
        assert callable(getattr(mod, name))


def test_registry_init_draws_on_the_device_from_the_seed():
    """Equal seeds give equal weights; the norm scales start at 1 in
    float32 and the head is untied."""
    cfg = get_arch("stablelm-3b").smoke
    a, b = (registry.init(cfg, seed=3, device="cpu") for _ in range(2))
    c = registry.init(cfg, seed=4, device="cpu")
    assert torch.equal(a.blocks[1].ffn.w_up, b.blocks[1].ffn.w_up)
    assert not torch.equal(a.blocks[1].ffn.w_up, c.blocks[1].ffn.w_up)
    assert a.head is not None and a.head.w.shape == (cfg.vocab, cfg.d_model)
    assert a.ln_f.scale.dtype == torch.float32
    assert bool((a.blocks[0].ln2.scale == 1).all())


def test_dense_golden_is_the_reference_record():
    """``serve_dense_smoke.json`` is, byte for byte, what the reference
    gives for the three numpy cases today."""
    recs = {}
    for arch in ARCHS:
        cfg, _, _, logits, tokens = _case(arch)
        recs[cfg.name] = golden.record(cfg, logits[0], logits[1:], tokens)
    with open(GOLDEN_PATH) as f:
        assert json.dumps(recs, separators=(",", ":")) + "\n" == f.read()


@pytest.mark.parametrize("arch", ARCHS)
def test_port_matches_dense_golden_on_cpu(arch):
    """The check the card runs without JAX (``chip_smoke.py``), here on
    the CPU's plain path."""
    with open(GOLDEN_PATH) as f:
        want = json.load(f)
    cfg = get_arch(arch).smoke
    rec = want[cfg.name]
    assert (rec["batch"], rec["prompt_len"], rec["new_tokens"]) == (
        golden.DENSE_BATCH, golden.DENSE_PROMPT_LEN, golden.DENSE_NEW_TOKENS)
    tree, prompts = golden.dense_numpy_case(cfg)
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    toks, logits = ServeEngine(cfg, model, MAX_LEN).generate(
        prompts, rec["new_tokens"], return_logits=True)
    assert not golden.mismatches(rec, logits[0], logits[1:], toks, F32)
