"""The vlm family (qwen2-vl-2b, M-RoPE) on the port, on the CPU, against
the JAX package.

``mrope_angles`` against the reference's on t/h/w ids that differ; the
smoke decoder (2 layers, d 64, GQA 4/2 at head dim 16, M-RoPE sections
(2, 3, 3)) with the reference's parameters carried across by
``convert.dense_params_from_numpy``: ``forward`` on stub-frontend
embeddings at patch-grid ids, the image-style prefill
(:func:`repro_torch.serve.golden.vlm_image_case`: 4 text tokens, an
8 x 8 patch grid, 4 text tokens) and every decode step after it, and
``ServeEngine``'s greedy tokens on text at the batch of the reference's
``examples/serve_decode.py`` (equal t/h/w ids, as its engine passes
none).  Tolerances: 1e-6 relative for the angles, 1e-5 (rtol and atol)
for float32 logits, 2e-2 in bfloat16.  ``tests/goldens/serve_vlm_smoke.json``
is the reference's record of the served and the image-style case
(``regen_torch.py vlm``).
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
from repro.models.layers import rope as ref_rope  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.models.layers import rope  # noqa: E402
from repro_torch.serve import ServeEngine, golden  # noqa: E402
from test_torch_moe import REGEN  # noqa: E402
from test_torch_oracle import reference, torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ARCH = "qwen2-vl-2b"
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           golden.VLM_GOLDEN_NAME)
MAX_LEN = golden.DENSE_PROMPT_LEN + golden.DENSE_NEW_TOKENS + \
    golden.CACHE_SLACK
IMAGE_MAX_LEN = golden.IMAGE_LEN + golden.IMAGE_STEPS + golden.CACHE_SLACK
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_CASES = {}


def _served():
    """(config, tree, prompts, logits, tokens) of the text case."""
    if "served" not in _CASES:
        _CASES["served"] = REGEN.serve_reference_case(ARCH)[:5]
    return _CASES["served"]


def _image():
    """(config, tree, text, patches, positions, logits, tokens) of the
    image-style case on the reference."""
    if "image" not in _CASES:
        _CASES["image"] = REGEN.vlm_image_reference_case()
    return _CASES["image"]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _embeds(model, text, patches):
    """The port's merged prompt embeddings from its own table."""
    return golden.image_embeds(model.embed.table[torch.as_tensor(text)],
                               torch.as_tensor(patches).to(
                                   model.embed.table.dtype))


def test_config_matches_reference():
    got, want = get_arch(ARCH), ref_get_arch(ARCH)
    for a, b in ((got.full, want.full), (got.smoke, want.smoke)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert got.shapes == want.shapes
    assert got.skipped_shapes == want.skipped_shapes
    assert got.full.family == "vlm" and registry.model_module(got.full) is lm


def test_param_count_of_full_config_matches_reference():
    """1 777 030 656 parameters (3.55 GB in bf16) on both sides, nothing
    allocated."""
    cfg = get_arch(ARCH).full
    model = registry.init(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert cfg.param_count() == ref_registry.count_params(
        ref_get_arch(ARCH).full) == 1_777_030_656


@pytest.mark.parametrize("sections,head_dim", [((2, 3, 3), 16),
                                               ((16, 24, 24), 128)])
def test_mrope_angles_match_reference(sections, head_dim):
    """Random t/h/w ids (rows that differ) at the smoke's and the
    published sections: within 1e-6 relative."""
    rng = np.random.default_rng(7)
    pos = rng.integers(0, 4096, (3, 2, 11)).astype(np.int32)
    with reference():
        want = np.asarray(ref_rope.mrope_angles(jnp.asarray(pos), head_dim,
                                                1e6, sections))
    got = rope.mrope_angles(torch.as_tensor(pos), head_dim, 1e6, sections)
    assert got.dtype == torch.float32 and got.shape == (2, 11, head_dim // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="sum"):
        rope.mrope_angles(torch.as_tensor(pos), head_dim + 2, 1e6, sections)


def test_mrope_on_equal_ids_is_rope():
    """Text tokens carry equal t/h/w ids: M-RoPE is then plain RoPE."""
    pos = torch.arange(40, dtype=torch.int32)[None].expand(2, 40)
    got = rope.mrope_angles(pos[None].expand(3, 2, 40), 16, 1e6, (2, 3, 3))
    assert torch.equal(got, rope.rope_angles(pos, 16, 1e6))


def test_image_positions_layout():
    """Text ids 0–3, the grid at t = 4, h = 4 + row, w = 4 + column, the
    trailing text from 12, one past the grid's largest id."""
    pos = golden.image_positions(2)
    assert pos.shape == (3, 2, golden.IMAGE_LEN) and pos.dtype == np.int32
    t, h, w = pos[:, 0]
    assert (t[:4] == h[:4]).all() and (h[:4] == w[:4]).all()
    assert t[:4].tolist() == [0, 1, 2, 3] and t[-4:].tolist() == [12, 13,
                                                                   14, 15]
    assert (t[4:68] == 4).all()
    assert h[4:68].tolist() == [4 + r for r in range(8) for _ in range(8)]
    assert w[4:68].tolist() == [4 + c for _ in range(8) for c in range(8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_embeds_at_patch_grid_ids_matches_reference(dtype):
    cfg = get_arch(ARCH).smoke.replace(dtype=dtype)
    ref_cfg = ref_get_arch(ARCH).smoke.replace(dtype=dtype)
    tree, _ = golden.dense_numpy_case(cfg)
    text, patches, pos = golden.vlm_image_case(cfg)
    params = REGEN.reference_params(tree, dtype)
    with reference():
        emb = golden.image_embeds(np.asarray(
            params["embed"]["table"][jnp.asarray(text)], np.float32),
            patches)
        want, _ = ref_lm.forward(ref_cfg, params, None,
                                 positions=jnp.asarray(pos),
                                 embeds=jnp.asarray(emb, jnp.dtype(dtype)))
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    got, aux = lm.forward(cfg, model, None, positions=torch.as_tensor(pos),
                          embeds=_embeds(model, text, patches))
    assert got.dtype == torch.float32 and float(aux) == 0
    assert got.shape == (golden.BATCH, golden.IMAGE_LEN, cfg.vocab)
    _close(got, want, TOL[dtype])


def test_m_rope_needs_three_rows_of_ids():
    cfg = get_arch(ARCH).smoke
    model = registry.init(cfg, 0, "cpu")
    with pytest.raises(ValueError, match=r"\(3, B, S\)"):
        lm.forward(cfg, model, torch.zeros((1, 4), dtype=torch.int64),
                   positions=torch.zeros((1, 4), dtype=torch.int32))


def test_image_prefill_and_every_decode_step_match_reference():
    """The prefill of merged embeddings at the grid's ids, then each
    decode step fed the reference's greedy token at the default
    (cache-index) positions: every call's logits within 1e-5, the cache
    rows the prompt and the steps fill, no kernel on the CPU."""
    cfg, tree, text, patches, pos, logits, tokens = _image()
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    before = dict(kernels.LAUNCHES)
    cache = lm.init_cache(cfg, golden.BATCH, IMAGE_MAX_LEN, device="cpu")
    got, cache = lm.prefill(cfg, model, None, cache,
                            positions=torch.as_tensor(pos),
                            embeds=_embeds(model, text, patches))
    _close(got, logits[0], TOL["float32"])
    for i in range(golden.IMAGE_STEPS):
        got, cache = lm.decode_step(cfg, model,
                                    torch.as_tensor(tokens[:, i:i + 1]),
                                    cache, golden.IMAGE_LEN + i)
        _close(got, logits[i + 1], TOL["float32"])
    assert kernels.LAUNCHES == before
    filled = golden.IMAGE_LEN + golden.IMAGE_STEPS
    assert not cache["k"][:, :, filled:].any()
    assert cache["k"][:, :, :filled].abs().amax(dim=(0, 1, 3, 4)).gt(0).all()
    assert min(len(set(row)) for row in tokens.tolist()) >= 4


def test_serve_engine_matches_reference():
    """Text through ``ServeEngine``: greedy tokens equal, every step's
    logits within 1e-5, the tokens varied."""
    cfg, tree, prompts, logits, tokens = _served()
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    toks, got = ServeEngine(cfg, model, MAX_LEN).generate(
        prompts, golden.DENSE_NEW_TOKENS, return_logits=True)
    np.testing.assert_array_equal(toks, tokens)
    assert min(len(set(row)) for row in toks.tolist()) >= 4
    for g, w in zip(got, logits):
        _close(g, w, TOL["float32"])


def test_vlm_golden_is_the_reference_record():
    with open(GOLDEN_PATH) as f:
        assert REGEN.vlm_golden_text() == f.read()


@pytest.mark.parametrize("part", ["served", "image"])
def test_port_matches_vlm_golden_on_cpu(part):
    """The check the card runs without JAX (``chip_smoke.py``)."""
    with open(GOLDEN_PATH) as f:
        want = json.load(f)
    cfg = get_arch(ARCH).smoke
    tree, prompts = golden.dense_numpy_case(cfg)
    model = convert.dense_params_from_numpy(tree, cfg, "cpu")
    if part == "served":
        rec = want[cfg.name]
        toks, logits = ServeEngine(cfg, model, MAX_LEN).generate(
            prompts, rec["new_tokens"], return_logits=True)
    else:
        rec = want[REGEN.IMAGE_KEY]
        toks, logits = golden.image_generate(cfg, model,
                                             *golden.vlm_image_case(cfg))
    assert not golden.mismatches(rec, logits[0], logits[1:], toks,
                                 TOL["float32"])
