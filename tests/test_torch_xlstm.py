"""The ssm family (xlstm-1.3b: mLSTM and sLSTM) on the port, on the CPU,
against the JAX package.

``mlstm_apply`` and ``slstm_apply`` alone at the smoke width (d 64, 4
heads; the mLSTM's projected width 128, head dim 32, chunk 8) from a zero
and from a carried state, a ragged prompt (13 tokens: the padded chunk
runs), the chunk size's invariance (4 against 24, as the reference's
own test), the state written in place; then the smoke model (one
super-block of 1 sLSTM + 3 mLSTM, and two super-blocks at ``n_layers``
8, so the unstacking of ``convert.xlstm_params_from_numpy`` is held):
``forward``, the prefill and every decode step against the reference
step by step, prefill + decode against ``forward``, ``ServeEngine``'s
greedy tokens at the batch of ``examples/serve_decode.py``, and
``tests/goldens/serve_ssm_smoke.json`` (``regen_torch.py ssm``).
Tolerances: a layer 1e-5 (rtol and atol) in float32 and 2e-2 in
bfloat16.  The model's float32 logits within atol 2e-5 and rtol 1e-5:
its exp-gated matrix memories carry values up to e^8 through the layers,
and the port and the reference sum their products in different orders
(1.5e-5 at worst on logits of ±2).  In bfloat16 the same rounding, fed
through those gates, puts the reference's own logits up to 0.059 of a
row's largest logit from its float32 ones: the port's bfloat16 logits
must lie within twice the reference's distance from the reference's
float32 logits, and within 5e-2 of a row's largest logit from the
reference's bfloat16 ones.  Prefill + decode against ``forward``: the
reference's own test holds it at 2e-3 (``tests/test_models.py``); here
the model's float32 tolerance.
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
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import xlstm_model as ref_xlstm  # noqa: E402
from repro.models.layers import recurrent as ref_rec  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import registry, xlstm_model  # noqa: E402
from repro_torch.models.layers import recurrent  # noqa: E402
from repro_torch.serve import ServeEngine, golden  # noqa: E402
from test_torch_moe import REGEN  # noqa: E402
from test_torch_oracle import reference, torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ARCH = "xlstm-1.3b"
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           golden.SSM_GOLDEN_NAME)
MAX_LEN = golden.DENSE_PROMPT_LEN + golden.DENSE_NEW_TOKENS + \
    golden.CACHE_SLACK
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODEL_ATOL, MODEL_RTOL = 2e-5, 1e-5
_CASES = {}


def _served():
    """(config, tree, prompts, logits, tokens) on the reference."""
    if "served" not in _CASES:
        _CASES["served"] = REGEN.serve_reference_case(ARCH)[:5]
    return _CASES["served"]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _model_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_config_matches_reference():
    got, want = get_arch(ARCH), ref_get_arch(ARCH)
    for a, b in ((got.full, want.full), (got.smoke, want.smoke)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert got.shapes == want.shapes
    assert got.skipped_shapes == want.skipped_shapes
    assert registry.model_module(got.full) is xlstm_model


def test_param_count_of_full_config_matches_reference():
    """3 630 283 088 parameters (7.26 GB in bf16) on both sides, nothing
    allocated: the reference's full dp × dp q/k/v, more than the
    published 1.3 B."""
    cfg = get_arch(ARCH).full
    model = registry.init(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert cfg.param_count() == ref_registry.count_params(
        ref_get_arch(ARCH).full) == 3_630_283_088


# --------------------------------------------------------------------- #
# the layers
# --------------------------------------------------------------------- #
def _layer_case(kind, dtype="float32", chunk=None, s=13):
    """(config, reference config, the layer's tree, the port's layer,
    x (2, s, d))."""
    cfg = get_arch(ARCH).smoke.replace(dtype=dtype)
    ref_cfg = ref_get_arch(ARCH).smoke.replace(dtype=dtype)
    if chunk is not None:
        cfg, ref_cfg = (c.replace(xlstm_chunk=chunk) for c in (cfg, ref_cfg))
    rng = np.random.default_rng(31)
    tree = golden.xlstm_numpy_params(cfg, rng)["blocks"]
    sub = (jax.tree.map(lambda a: a[0, 1], tree["mlstm"]) if kind == "m"
           else jax.tree.map(lambda a: a[0], tree["slstm"]))
    layer = (recurrent.MLSTM if kind == "m" else recurrent.SLSTM)(
        cfg, None, "meta").to_empty(device="cpu")
    convert._params_from_numpy(layer, sub)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    return cfg, ref_cfg, sub, layer, x


def _states(kind, cfg, carried):
    """(reference state, port state): zero, or drawn from numpy (the
    sLSTM's n and the mLSTM's memory positive-ish, as after a prompt)."""
    if kind == "m":
        st = {k: np.asarray(a) for k, a in recurrent.mlstm_init_state(
            cfg, 2).items()}
    else:
        st = {k: np.asarray(a) for k, a in recurrent.slstm_init_state(
            cfg, 2).items()}
    if carried:
        rng = np.random.default_rng(32)
        st = {k: (a + rng.standard_normal(a.shape) * (3.0 if k == "c"
                                                      else 0.5)
                  + (2.0 if k == "n" else 0.0)).astype(np.float32)
              for k, a in st.items()}
    return ({k: jnp.asarray(a) for k, a in st.items()},
            {k: torch.as_tensor(a.copy()) for k, a in st.items()})


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("kind", ["m", "s"], ids=["mlstm", "slstm"])
def test_layer_apply_matches_reference(kind, carried):
    """13 tokens (the mLSTM's last chunk of 8 ragged, its pad rows'
    input gate −1e30) from a zero or a carried state: the output and the
    new state within 1e-5, the state written in place."""
    cfg, ref_cfg, sub, layer, x = _layer_case(kind)
    ref_st, st = _states(kind, cfg, carried)
    ref_apply = ref_rec.mlstm_apply if kind == "m" else ref_rec.slstm_apply
    port_apply = (recurrent.mlstm_apply if kind == "m"
                  else recurrent.slstm_apply)
    with reference():
        want, want_st = ref_apply(ref_cfg, jax.tree.map(jnp.asarray, sub),
                                  jnp.asarray(x), state=ref_st,
                                  return_state=True)
    kept = {k: a for k, a in st.items()}
    got, got_st = port_apply(cfg, layer, torch.as_tensor(x), state=st,
                             return_state=True)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want, TOL["float32"])
    assert set(got_st) == set(want_st)
    for k in want_st:
        assert got_st[k] is kept[k]         # the caller's tensor, in place
        w = np.asarray(want_st[k])
        np.testing.assert_allclose(got_st[k].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("kind", ["m", "s"], ids=["mlstm", "slstm"])
def test_layer_apply_matches_reference_in_bf16(kind):
    """bf16 x and weights, the gates' fp32 parameters kept fp32."""
    cfg, ref_cfg, sub, _, x = _layer_case(kind, "bfloat16")
    layer = (recurrent.MLSTM if kind == "m" else recurrent.SLSTM)(
        cfg, None, "meta").to_empty(device="cpu")
    convert._params_from_numpy(layer, sub)
    fp32 = {"wi", "bi", "wf", "bf", "r", "b"}
    for name, prm in layer.named_parameters():
        assert prm.dtype == (torch.float32 if name.split(".")[0] in fp32
                             or name.startswith("norm") else torch.bfloat16)
    ref_apply = ref_rec.mlstm_apply if kind == "m" else ref_rec.slstm_apply
    with reference():
        want = ref_apply(ref_cfg, REGEN.reference_params(sub, "bfloat16"),
                         jnp.asarray(x, jnp.bfloat16))
    port_apply = (recurrent.mlstm_apply if kind == "m"
                  else recurrent.slstm_apply)
    got = port_apply(cfg, layer, torch.as_tensor(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), TOL["bfloat16"])


def test_mlstm_chunked_form_is_invariant_to_chunk_size():
    """Chunks of 4 and of 24 over 20 tokens, as the reference's
    ``test_mlstm_chunked_scan_invariant_to_chunk_size`` (rtol 1e-4,
    atol 1e-5), and each equal to the reference at its chunk."""
    outs = []
    for chunk in (4, 24):
        cfg, ref_cfg, sub, layer, x = _layer_case("m", chunk=chunk, s=20)
        x = x * 0.1
        got = recurrent.mlstm_apply(cfg, layer, torch.as_tensor(x))
        with reference():
            want = ref_rec.mlstm_apply(ref_cfg, jax.tree.map(jnp.asarray,
                                                             sub),
                                       jnp.asarray(x))
        _close(got, want, TOL["float32"])
        outs.append(got.numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_layers", [4, 8])
def test_forward_matches_reference(n_layers):
    """One super-block, and two (``n_layers`` 8): each super-block's and
    each mLSTM layer's parameters land where the reference stacks
    them."""
    cfg = get_arch(ARCH).smoke.replace(n_layers=n_layers)
    ref_cfg = ref_get_arch(ARCH).smoke.replace(n_layers=n_layers)
    tree, prompts = golden.xlstm_numpy_case(cfg)
    with reference():
        want, aux = ref_xlstm.forward(ref_cfg, jax.tree.map(jnp.asarray,
                                                            tree),
                                      jnp.asarray(prompts))
    model = convert.xlstm_params_from_numpy(tree, cfg, "cpu")
    assert len(model.blocks) == n_layers // 4
    assert len(model.blocks[0].mlstm) == 3
    got, got_aux = xlstm_model.forward(cfg, model, torch.as_tensor(prompts))
    assert got.dtype == torch.float32 and float(got_aux) == float(aux) == 0
    _model_close(got, want)


def test_forward_matches_reference_in_bf16():
    """The bf16 model against the reference's bf16 and fp32 logits (the
    rule of the module docstring)."""
    cfg = get_arch(ARCH).smoke
    ref_cfg = ref_get_arch(ARCH).smoke
    tree, prompts = golden.xlstm_numpy_case(cfg)
    want = {}
    with reference():
        for dt in ("float32", "bfloat16"):
            want[dt] = np.asarray(ref_xlstm.forward(
                ref_cfg.replace(dtype=dt), REGEN.reference_params(tree, dt),
                jnp.asarray(prompts))[0], np.float32)
    cfg = cfg.replace(dtype="bfloat16")
    model = convert.xlstm_params_from_numpy(tree, cfg, "cpu")
    assert model.blocks[0].mlstm[0].wq.dtype == torch.bfloat16
    assert model.blocks[0].mlstm[0].wf.dtype == torch.float32
    got = xlstm_model.forward(cfg, model, torch.as_tensor(prompts))[0].numpy()
    truth = want["float32"]
    assert np.abs(got - truth).max() <= 2 * np.abs(want["bfloat16"]
                                                   - truth).max()
    row_max = np.abs(want["bfloat16"]).max(-1, keepdims=True)
    assert (np.abs(got - want["bfloat16"]) <= 5e-2 * row_max).all()


def test_prefill_and_every_decode_step_match_reference():
    """Each call's logits fed the reference's tokens; the state keeps the
    reference's stacked layout and is written in place; no kernel."""
    cfg, tree, prompts, logits, tokens = _served()
    model = convert.xlstm_params_from_numpy(tree, cfg, "cpu")
    before = dict(kernels.LAUNCHES)
    cache = xlstm_model.init_cache(cfg, golden.DENSE_BATCH, MAX_LEN,
                                   device="cpu")
    dh = 2 * cfg.d_model // cfg.n_heads
    assert cache["mlstm"]["c"].shape == (1, 3, golden.DENSE_BATCH,
                                         cfg.n_heads, dh, dh)
    assert cache["slstm"]["h"].shape == (1, golden.DENSE_BATCH, cfg.n_heads,
                                         cfg.d_model // cfg.n_heads)
    assert bool((cache["slstm"]["n"] == 1e-6).all())
    held = cache["mlstm"]["c"]
    got, cache = xlstm_model.prefill(cfg, model, torch.as_tensor(prompts),
                                     cache)
    _model_close(got, logits[0])
    for i in range(golden.DENSE_NEW_TOKENS - 1):
        got, cache = xlstm_model.decode_step(
            cfg, model, torch.as_tensor(tokens[:, i:i + 1]), cache,
            golden.DENSE_PROMPT_LEN + i)
        assert got.shape == (golden.DENSE_BATCH, 1, cfg.vocab)
        _model_close(got, logits[i + 1])
    assert cache["mlstm"]["c"] is held and held.abs().gt(0).all()
    assert kernels.LAUNCHES == before


def test_prefill_and_decode_equal_forward():
    """The port alone: a 20-token prefill, then 20 single-token steps,
    stitched, against ``forward`` over the 40 tokens (the reference's
    test holds its own at 2e-3)."""
    cfg = get_arch(ARCH).smoke
    tree, _ = golden.xlstm_numpy_case(cfg)
    tokens = np.random.default_rng(33).integers(0, cfg.vocab, (2, 40))
    model = convert.xlstm_params_from_numpy(tree, cfg, "cpu")
    full, _ = xlstm_model.forward(cfg, model, torch.as_tensor(tokens))
    cache = registry.init_cache(cfg, 2, 40, device="cpu")
    outs, cache = xlstm_model.prefill(cfg, model,
                                      torch.as_tensor(tokens[:, :20]), cache)
    outs = [outs]
    for t in range(20, 40):
        step, cache = xlstm_model.decode_step(
            cfg, model, torch.as_tensor(tokens[:, t:t + 1]), cache, t)
        outs.append(step)
    _model_close(torch.cat(outs, dim=1), full)


def test_serve_engine_matches_reference():
    cfg, tree, prompts, logits, tokens = _served()
    model = convert.xlstm_params_from_numpy(tree, cfg, "cpu")
    toks, got = ServeEngine(cfg, model, MAX_LEN).generate(
        prompts, golden.DENSE_NEW_TOKENS, return_logits=True)
    np.testing.assert_array_equal(toks, tokens)
    assert min(len(set(row)) for row in toks.tolist()) >= 4
    for g, w in zip(got, logits):
        _model_close(g, w)


def test_ssm_golden_is_the_reference_record():
    with open(GOLDEN_PATH) as f:
        assert REGEN.serve_golden_text(golden.SSM_ARCHS) == f.read()


def test_port_matches_ssm_golden_on_cpu():
    """The check the card runs without JAX (``chip_smoke.py``)."""
    with open(GOLDEN_PATH) as f:
        want = json.load(f)
    cfg = get_arch(ARCH).smoke
    rec = want[cfg.name]
    tree, prompts = golden.lm_numpy_case(cfg)
    model = convert.xlstm_params_from_numpy(tree, cfg, "cpu")
    toks, logits = ServeEngine(cfg, model, MAX_LEN).generate(
        prompts, rec["new_tokens"], return_logits=True)
    assert not golden.mismatches(rec, logits[0], logits[1:], toks,
                                 TOL["float32"])
