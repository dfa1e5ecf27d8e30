"""whisper serving on the port, on the CPU, against the JAX package.

At smoke width (2 + 2 layers, d 64) with the reference's parameters
carried across by ``convert.encdec_params_from_numpy``: the layers
(``layer_norm``, ``gelu_mlp``, ``unembed``), ``encode``, the prefill's
and every decode step's logits, and ``ServeEngine.generate``'s greedy
tokens, at rtol/atol 1e-5 in float32 and 2e-2 in bfloat16.  The
reference runs its plain attention at ``enc_seq`` 32 (not a multiple of
its Pallas kernel's 128-key block) and its Pallas kernel, in interpret
mode, at ``enc_seq`` 128, where that kernel is sound.

Parameters, frames and prompts come from numpy
(:mod:`repro_torch.serve.golden`), drawn so that the greedy argmax moves
from step to step.  ``tests/goldens/serve_whisper_smoke.json`` is the
reference's record of the ``enc_seq`` 32 case; running this file as a
script rewrites it::

    PYTHONPATH=src python tests/test_torch_serve.py
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models.layers import basic as ref_basic  # noqa: E402
from repro.models.layers import ffn as ref_ffn  # noqa: E402
from repro.serve import ServeEngine as RefEngine  # noqa: E402
from repro.serve import make_serve_step as ref_make_serve_step  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import encdec, registry  # noqa: E402
from repro_torch.models.layers import basic, ffn  # noqa: E402
from repro_torch.serve import ServeEngine, golden, make_serve_step  # noqa: E402
from test_torch_oracle import torch_one_thread  # noqa: E402,F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           golden.GOLDEN_NAME)
MAX_LEN = golden.PROMPT_LEN + golden.NEW_TOKENS + golden.CACHE_SLACK
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@dataclasses.dataclass
class Case:
    cfg: object          # the port's config
    ref_cfg: object      # the reference's config
    tree: dict           # float32 numpy parameters (reference layout)
    frames: np.ndarray
    prompts: np.ndarray
    enc: np.ndarray      # reference encoder output (float32)
    logits: list         # reference prefill + decode-step logits (float32)
    tokens: np.ndarray   # reference greedy tokens


def _ref_tree(tree, dtype):
    """The reference's tree in its own dtypes: norms stay float32."""
    def cast(path, a):
        keep = any(getattr(p, "key", None) in ("ln1", "ln2", "ln_x",
                                               "enc_ln", "dec_ln")
                   for p in path)
        return jnp.asarray(a, jnp.float32 if keep else jnp.dtype(dtype))
    return jax.tree_util.tree_map_with_path(cast, tree)


def reference_case(enc_seq: int, use_pallas: bool,
                   dtype: str = "float32") -> Case:
    """Serve the numpy case on the reference: tokens from its jitted
    ``ServeEngine``, logits from its ``prefill``/``decode_step`` fed those
    tokens."""
    cfg = get_arch("whisper-base").smoke.replace(enc_seq=enc_seq,
                                                 dtype=dtype)
    ref_cfg = ref_get_arch("whisper-base").smoke.replace(
        enc_seq=enc_seq, dtype=dtype, use_pallas=use_pallas)
    tree, frames, prompts = golden.numpy_case(cfg)
    params = _ref_tree(tree, dtype)
    enc = ref_encdec.encode(ref_cfg, params,
                            jnp.asarray(frames, jnp.dtype(dtype)))
    tokens = RefEngine(cfg=ref_cfg, params=params, max_len=MAX_LEN).generate(
        prompts, golden.NEW_TOKENS, enc_out=enc)
    cache = ref_encdec.init_cache(ref_cfg, golden.BATCH, MAX_LEN)
    logits, cache = ref_encdec.prefill(ref_cfg, params, jnp.asarray(prompts),
                                       cache, enc_out=enc)
    out = [np.asarray(logits, np.float32)]
    for i in range(golden.NEW_TOKENS - 1):
        logits, cache = ref_encdec.decode_step(
            ref_cfg, params, jnp.asarray(tokens[:, i:i + 1]), cache,
            golden.PROMPT_LEN + i, enc_out=enc)
        out.append(np.asarray(logits, np.float32))
    return Case(cfg, ref_cfg, tree, frames, prompts,
                np.asarray(enc, np.float32), out, np.asarray(tokens))


def golden_text() -> str:
    case = reference_case(golden.config().enc_seq, use_pallas=False)
    return golden.dumps(golden.record(case.cfg, case.logits[0],
                                      case.logits[1:], case.tokens))


_CASES = {}


def _case(key) -> Case:
    if key not in _CASES:
        _CASES[key] = reference_case(*key)
    return _CASES[key]


def _port_model(case: Case):
    model = convert.encdec_params_from_numpy(case.tree, case.cfg, "cpu")
    frames = torch.as_tensor(case.frames).to(case.cfg.torch_dtype)
    return model, frames


KEYS = {"enc32_plain": (32, False), "enc128_pallas": (128, True)}


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 5, 64)) + 1).astype(np.float32)
    scale, bias = (rng.standard_normal((2, 64)).astype(np.float32))
    want = ref_basic.layer_norm({"scale": jnp.asarray(scale),
                                 "bias": jnp.asarray(bias)}, jnp.asarray(x))
    p = basic.LayerNorm(64, "cpu")
    p.scale.copy_(torch.as_tensor(scale))
    p.bias.copy_(torch.as_tensor(bias))
    _close(basic.layer_norm(p, torch.as_tensor(x)), want, "float32")


def test_gelu_mlp_matches_reference():
    """Includes the tanh form of GELU (``jax.nn.gelu``'s default)."""
    cfg = get_arch("whisper-base").smoke
    rng = np.random.default_rng(1)
    p = {"w_in": rng.standard_normal((64, 128)) * 0.3,
         "b_in": rng.standard_normal(128), "w_out":
         rng.standard_normal((128, 64)) * 0.1,
         "b_out": rng.standard_normal(64)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    want = ref_ffn.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x))
    mod = ffn.GeluMLP(cfg, torch.Generator().manual_seed(0), device="cpu")
    for k, v in p.items():
        getattr(mod, k).copy_(torch.as_tensor(v))
    _close(ffn.gelu_mlp(mod, torch.as_tensor(x)), want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unembed_matches_reference_in_fp32(dtype):
    """fp32 logits accumulated in fp32, also from bf16 operands."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    table = rng.standard_normal((256, 64)).astype(np.float32)
    want = ref_basic.unembed({"table": jnp.asarray(table, dtype)}, None,
                             jnp.asarray(x, dtype), tie=True)
    emb = basic.Embedding(None, 256, 64, torch.float32, device="meta")
    emb.table = torch.nn.Parameter(torch.as_tensor(table).to(
        getattr(torch, dtype)), requires_grad=False)
    got = basic.unembed(emb, None, torch.as_tensor(x).to(
        getattr(torch, dtype)), tie=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("key", sorted(KEYS))
def test_encode_matches_reference(key):
    case = _case(KEYS[key])
    model, frames = _port_model(case)
    _close(encdec.encode(case.cfg, model, frames), case.enc, "float32")


@pytest.mark.parametrize("key", sorted(KEYS))
def test_prefill_and_every_decode_step_match_reference(key):
    """Logits of the prefill and of each decode step, each step fed the
    reference's greedy token; no kernel is launched on the CPU."""
    case = _case(KEYS[key])
    model, frames = _port_model(case)
    before = dict(kernels.LAUNCHES)
    enc = encdec.encode(case.cfg, model, frames)
    cache = encdec.init_cache(case.cfg, golden.BATCH, MAX_LEN, device="cpu")
    toks = torch.as_tensor(case.prompts)
    logits, cache = encdec.prefill(case.cfg, model, toks, cache, enc_out=enc)
    _close(logits, case.logits[0], "float32")
    for i in range(golden.NEW_TOKENS - 1):
        logits, cache = encdec.decode_step(
            case.cfg, model, torch.as_tensor(case.tokens[:, i:i + 1]), cache,
            golden.PROMPT_LEN + i, enc_out=enc)
        assert logits.shape == (golden.BATCH, 1, case.cfg.vocab)
        _close(logits, case.logits[i + 1], "float32")
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("key", sorted(KEYS))
def test_serve_engine_matches_reference(key):
    """Greedy tokens equal, logits at every step within 1e-5, and the
    tokens vary (the case is not one repeated token)."""
    case = _case(KEYS[key])
    model, frames = _port_model(case)
    enc = encdec.encode(case.cfg, model, frames)
    toks, logits = ServeEngine(case.cfg, model, MAX_LEN).generate(
        case.prompts, golden.NEW_TOKENS, enc_out=enc, return_logits=True)
    assert toks.dtype == np.int32 and toks.shape == case.tokens.shape
    np.testing.assert_array_equal(toks, case.tokens)
    assert min(len(set(row)) for row in toks.tolist()) >= 4
    for got, want in zip(logits, case.logits):
        _close(got, want, "float32")


def test_serve_step_matches_reference():
    """``make_serve_step`` against the reference's (jitted) one, after the
    same prefill: the next tokens agree."""
    case = _case(KEYS["enc32_plain"])
    model, frames = _port_model(case)
    enc = encdec.encode(case.cfg, model, frames)
    cache = registry.init_cache(case.cfg, golden.BATCH, MAX_LEN,
                                device="cpu")
    _, cache = encdec.prefill(case.cfg, model, torch.as_tensor(case.prompts),
                              cache, enc_out=enc)
    tok = torch.as_tensor(case.tokens[:, :1])
    nxt, _ = make_serve_step(case.cfg)(model, tok, cache, golden.PROMPT_LEN,
                                       enc_out=enc)
    params = _ref_tree(case.tree, "float32")
    ref_enc = jnp.asarray(case.enc)
    ref_cache = ref_encdec.init_cache(case.ref_cfg, golden.BATCH, MAX_LEN)
    _, ref_cache = ref_encdec.prefill(case.ref_cfg, params,
                                      jnp.asarray(case.prompts), ref_cache,
                                      enc_out=ref_enc)
    want, _ = ref_make_serve_step(case.ref_cfg)(
        params, jnp.asarray(case.tokens[:, :1]), ref_cache,
        jnp.int32(golden.PROMPT_LEN), enc_out=ref_enc)
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(want))
    np.testing.assert_array_equal(nxt.numpy(), case.tokens[:, 1:2])


def test_bf16_serving_matches_reference():
    """The same case in bfloat16 on both sides: the served logits (fp32)
    of the prefill and every step at 2e-2, the port's own encoder output
    feeding its decoder.  The encoder output itself is a bf16 tensor whose
    rounding points differ between XLA and torch; it is held to its
    reference within two bf16 units in the last place of its largest
    element (2 of its 4096 elements sit 1-2 such units apart)."""
    case = _case((32, False, "bfloat16"))
    model, frames = _port_model(case)
    enc = encdec.encode(case.cfg, model, frames)
    assert enc.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(case.enc).max())) - 7)
    assert np.abs(enc.float().numpy() - case.enc).max() <= 2 * ulp
    logits = ServeEngine(case.cfg, model, MAX_LEN).teacher_forced_logits(
        case.prompts, case.tokens, enc_out=enc)
    assert all(x.dtype == torch.float32 for x in logits)
    for got, want in zip(logits, case.logits):
        _close(got, want, "bfloat16")


def test_param_count_matches_reference():
    """whisper-base at full width: the same parameter count, with nothing
    allocated (the port counts a model built on the meta device)."""
    cfg = get_arch("whisper-base").full
    assert cfg.param_count() == ref_registry.count_params(
        ref_get_arch("whisper-base").full)


def test_serve_golden_is_the_reference_record():
    """``serve_whisper_smoke.json`` is, byte for byte, what the reference
    gives for the numpy case today."""
    with open(GOLDEN_PATH) as f:
        assert golden_text() == f.read()


def test_port_matches_serve_golden_on_cpu():
    """The check the card runs without JAX (``chip_smoke.py``), here on the
    CPU's plain path."""
    import json

    with open(GOLDEN_PATH) as f:
        want = json.load(f)
    cfg = golden.config()
    assert cfg.enc_seq == want["enc_seq"]
    tree, frames, prompts = golden.numpy_case(cfg)
    model = convert.encdec_params_from_numpy(tree, cfg, "cpu")
    enc = encdec.encode(cfg, model, torch.as_tensor(frames))
    toks, logits = ServeEngine(cfg, model, MAX_LEN).generate(
        prompts, want["new_tokens"], enc_out=enc, return_logits=True)
    assert not golden.mismatches(want, logits[0], logits[1:], toks, 1e-5)


if __name__ == "__main__":
    with open(GOLDEN_PATH, "w") as f:
        f.write(golden_text())
    print(f"wrote {GOLDEN_PATH}", file=sys.stderr)
