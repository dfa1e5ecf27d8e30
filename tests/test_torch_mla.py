"""MLA (multi-head latent attention) and minicpm3 on the port, on the CPU,
against the JAX package.

``mla_apply`` at minicpm3's smoke width (d 64, 4 heads, q rank 32, kv
rank 16, nope 16 + rope 8 dims a head, V 16) against the reference's:
without a cache (causal), and with the compressed cache (c_kv, k_rope)
at a prefill and at a decode step, the cache rows written in place
equal to the reference's; the attention op gets Dk = nope + rope dims
and V's own head dim.  Then the minicpm3 smoke decoder with the
reference's parameters carried across by ``convert``: ``forward``, the
prefill's and every decode step's logits, ``ServeEngine``'s greedy
tokens at the batch of ``examples/serve_decode.py``, and
``tests/goldens/serve_mla_smoke.json`` (``regen_torch.py mla``).
Tolerances: 1e-5 in float32, 2e-2 in bfloat16.
"""

import dataclasses
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
from repro.models.layers import attention as ref_attention  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.models.layers import attention  # noqa: E402
from repro_torch.serve import ServeEngine, golden  # noqa: E402
from test_torch_moe import REGEN  # noqa: E402
from test_torch_oracle import reference, torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ARCH = "minicpm3-4b"
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           golden.MLA_GOLDEN_NAME)
MAX_LEN = golden.DENSE_PROMPT_LEN + golden.DENSE_NEW_TOKENS + \
    golden.CACHE_SLACK
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_CASES = {}


def _case(dtype="float32"):
    """(config, tree, prompts, logits, tokens) on the reference."""
    if dtype not in _CASES:
        _CASES[dtype] = REGEN.serve_reference_case(ARCH, dtype)[:5]
    return _CASES[dtype]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _ref_tree(tree, dtype):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a, jnp.float32 if any(
            getattr(k, "key", None) in REGEN.FP32_KEEP for k in path)
            else jnp.dtype(dtype)), tree)


def test_config_matches_reference():
    got, want = get_arch(ARCH), ref_get_arch(ARCH)
    for a, b in ((got.full, want.full), (got.smoke, want.smoke)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert got.full.mla and got.full.family == "dense"
    assert registry.model_module(got.full) is lm


def test_param_count_of_full_config_matches_reference():
    """4 261 902 848 parameters (8.52 GB in bf16) on both sides, nothing
    allocated; no experts, so every parameter is active."""
    cfg, ref_cfg = get_arch(ARCH).full, ref_get_arch(ARCH).full
    assert registry.count_params(cfg) == ref_registry.count_params(
        ref_cfg) == 4_261_902_848
    assert registry.count_params(cfg, active_only=True) == \
        ref_registry.count_params(ref_cfg, active_only=True)


# --------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------- #
def _layer_case(dtype):
    """(config, reference config, the layer's tree, x (2, 16, d))."""
    cfg = get_arch(ARCH).smoke.replace(dtype=dtype)
    ref_cfg = ref_get_arch(ARCH).smoke.replace(dtype=dtype)
    rng = np.random.default_rng(21)
    tree = golden.dense_numpy_params(cfg.replace(n_layers=1), rng)
    attn = jax.tree.map(lambda a: a[0], tree["blocks"]["attn"])
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    return cfg, ref_cfg, attn, x


def _port_layer(cfg, attn):
    layer = attention.MLA(cfg, None, "meta").to_empty(device="cpu")
    convert._params_from_numpy(layer, attn)
    return layer


# (cached, index, new tokens): no cache (causal over 16 tokens); a prefill
# of 16 into a 24-row cache; one decode token at row 20 of a cache whose
# rows 0–19 hold earlier latents
LAYER_CASES = {"no_cache": (False, 0, 16), "prefill": (True, 0, 16),
               "decode": (True, 20, 1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_mla_apply_matches_reference(case, dtype):
    cached, index, s = LAYER_CASES[case]
    cfg, ref_cfg, attn, x = _layer_case(dtype)
    x = x[:, :s]
    b = x.shape[0]
    pos = (index + np.arange(s, dtype=np.int32))[None].repeat(b, 0)
    rng = np.random.default_rng(22)
    c0 = rng.standard_normal((b, 24, cfg.kv_lora_rank)).astype(np.float32)
    r0 = rng.standard_normal((b, 24, cfg.qk_rope_dim)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    with reference():
        ref_cache = ({"c_kv": jnp.asarray(c0, jdt),
                      "k_rope": jnp.asarray(r0, jdt)} if cached else None)
        want, want_cache = ref_attention.mla_apply(
            ref_cfg, _ref_tree(attn, dtype), jnp.asarray(x, jdt),
            positions=jnp.asarray(pos), cache=ref_cache,
            cache_index=jnp.int32(index) if cached else None)
    tdt = getattr(torch, dtype)
    cache = ({"c_kv": torch.as_tensor(c0).to(tdt),
              "k_rope": torch.as_tensor(r0).to(tdt)} if cached else None)
    got, got_cache = attention.mla_apply(
        cfg, _port_layer(cfg, attn), torch.as_tensor(x).to(tdt),
        positions=torch.as_tensor(pos), cache=cache,
        cache_index=index if cached else None)
    assert got.dtype == tdt and got.shape == x.shape
    _close(got.float(), np.asarray(want, np.float32), TOL[dtype])
    if cached:
        assert got_cache is cache        # written in place
        for key in ("c_kv", "k_rope"):
            _close(cache[key].float(),
                   np.asarray(want_cache[key], np.float32), TOL[dtype])
            # rows outside [index, index + s) keep their earlier values
            untouched = torch.ones(24, dtype=torch.bool)
            untouched[index:index + s] = False
            want_rows = torch.as_tensor(c0 if key == "c_kv" else r0).to(tdt)
            assert torch.equal(cache[key][:, untouched],
                               want_rows[:, untouched])


def test_attention_gets_dk_nope_plus_rope_and_v_its_own_dim(monkeypatch):
    """The op sees q and k of 16 + 8 dims and V of 16, V a view into the
    expanded latents (MLA's slice), at a decode step over the cache."""
    cfg, _, attn, x = _layer_case("float32")
    seen = []
    real = attention.attention_op

    def spy(cfg_, q, k, v, **kw):
        seen.append((q.shape, k.shape, v.shape, v.is_contiguous(),
                     kw["causal"], None if kw["mask_len"] is None
                     else kw["mask_len"].tolist()))
        return real(cfg_, q, k, v, **kw)

    monkeypatch.setattr(attention, "attention_op", spy)
    cache = {"c_kv": torch.zeros((2, 24, cfg.kv_lora_rank)),
             "k_rope": torch.zeros((2, 24, cfg.qk_rope_dim))}
    attention.mla_apply(cfg, _port_layer(cfg, attn),
                        torch.as_tensor(x[:, :1]),
                        positions=torch.full((2, 1), 7, dtype=torch.int32),
                        cache=cache, cache_index=7)
    ((qs, ks, vs, contiguous, causal, mask),) = seen
    dk = cfg.qk_nope_dim + cfg.qk_rope_dim
    assert qs == (2, 1, 4, dk) and ks == (2, 24, 4, dk)
    assert vs == (2, 24, 4, cfg.v_head_dim) and not contiguous
    assert causal is False and mask == [[8], [8]]


# --------------------------------------------------------------------- #
# the decoder
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    cfg = get_arch(ARCH).smoke.replace(dtype=dtype)
    ref_cfg = ref_get_arch(ARCH).smoke.replace(dtype=dtype)
    tree, prompts = golden.dense_numpy_case(cfg)
    with reference():
        want, aux = ref_lm.forward(ref_cfg, _ref_tree(tree, dtype),
                                   jnp.asarray(prompts))
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    assert model.blocks[0].attn.q_norm.scale.dtype == torch.float32
    got, got_aux = lm.forward(cfg, model, torch.as_tensor(prompts))
    assert got.dtype == torch.float32 and float(got_aux) == float(aux) == 0
    _close(got, want, TOL[dtype])


def test_prefill_and_every_decode_step_match_reference():
    """Each call's logits fed the reference's tokens; the compressed
    cache's layout and the rows it fills; no kernel on the CPU."""
    cfg, tree, prompts, logits, tokens = _case()
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    before = dict(kernels.LAUNCHES)
    cache = lm.init_cache(cfg, golden.DENSE_BATCH, MAX_LEN, device="cpu")
    assert set(cache) == {"c_kv", "k_rope"}
    lead = (cfg.n_layers, golden.DENSE_BATCH, MAX_LEN)
    assert cache["c_kv"].shape == (*lead, cfg.kv_lora_rank)
    assert cache["k_rope"].shape == (*lead, cfg.qk_rope_dim)
    got, cache = lm.prefill(cfg, model, torch.as_tensor(prompts), cache)
    _close(got, logits[0], TOL["float32"])
    for i in range(golden.DENSE_NEW_TOKENS - 1):
        got, cache = lm.decode_step(
            cfg, model, torch.as_tensor(tokens[:, i:i + 1]), cache,
            golden.DENSE_PROMPT_LEN + i)
        _close(got, logits[i + 1], TOL["float32"])
    assert kernels.LAUNCHES == before
    filled = golden.DENSE_PROMPT_LEN + golden.DENSE_NEW_TOKENS - 1
    for c in cache.values():
        assert not c[:, :, filled:].any()
        assert c[:, :, :filled].abs().amax(dim=(0, 1, 3)).gt(0).all()


def test_serve_engine_matches_reference():
    cfg, tree, prompts, logits, tokens = _case()
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    toks, got = ServeEngine(cfg, model, MAX_LEN).generate(
        prompts, golden.DENSE_NEW_TOKENS, return_logits=True)
    np.testing.assert_array_equal(toks, tokens)
    assert min(len(set(row)) for row in toks.tolist()) >= 4
    for g, w in zip(got, logits):
        _close(g, w, TOL["float32"])


def test_bf16_serving_matches_reference():
    cfg, tree, prompts, logits, tokens = _case("bfloat16")
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    got = ServeEngine(cfg, model, MAX_LEN).teacher_forced_logits(prompts,
                                                                 tokens)
    for g, w in zip(got, logits):
        _close(g, w, TOL["bfloat16"])


def test_mla_golden_is_the_reference_record():
    with open(GOLDEN_PATH) as f:
        assert REGEN.serve_golden_text(golden.MLA_ARCHS) == f.read()


def test_port_matches_mla_golden_on_cpu():
    """The check the card runs without JAX (``chip_smoke.py``)."""
    with open(GOLDEN_PATH) as f:
        want = json.load(f)
    cfg = get_arch(ARCH).smoke
    rec = want[cfg.name]
    tree, prompts = golden.dense_numpy_case(cfg)
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    toks, logits = ServeEngine(cfg, model, MAX_LEN).generate(
        prompts, rec["new_tokens"], return_logits=True)
    assert not golden.mismatches(rec, logits[0], logits[1:], toks,
                                 TOL["float32"])
