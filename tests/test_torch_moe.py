"""The MoE FFN and the MoE decoders on the port, on the CPU, against the
JAX package.

``moe_apply`` at qwen2-moe's smoke width (d 64, 6 experts top-2, 2 shared)
against the reference's: y within 1e-5, the auxiliary loss within 1e-6,
the same expert choices and the same dropped (token, slot) pairs, in a
case whose capacity drops, with dummy experts (``moe_pad_to``), with and
without shared experts, top-1, and a zero router (every token ties, so
``lax.top_k``'s lower-index order decides and the capacity drops most
pairs).  Then qwen2-moe, dbrx and Jamba with its experts at their smoke
configurations, with the reference's parameters carried across by
``convert``: ``forward`` (logits and aux), the prefill's and every decode
step's logits with each call's aux and drops, ``ServeEngine``'s greedy
tokens, at the batch of the reference's ``examples/serve_decode.py``
(4 requests, 16-token prompts, 24 new tokens); and
``tests/goldens/serve_moe_smoke.json`` (``regen_torch.py moe``).
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
from repro.models import hybrid as ref_hybrid  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models.layers import ffn as ref_ffn  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import hybrid, lm, registry  # noqa: E402
from repro_torch.models.layers import ffn  # noqa: E402
from repro_torch.serve import ServeEngine, golden  # noqa: E402
from test_torch_oracle import reference, torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
GOLDEN_PATH = os.path.join(GOLDENS, golden.MOE_GOLDEN_NAME)
ARCHS = golden.MOE_ARCHS
MAX_LEN = golden.DENSE_PROMPT_LEN + golden.DENSE_NEW_TOKENS + \
    golden.CACHE_SLACK
F32, AUX = 1e-5, 1e-6


def _regen():
    spec = importlib.util.spec_from_file_location(
        "regen_torch", os.path.join(GOLDENS, "regen_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REGEN = _regen()
_CASES = {}


def _case(arch):
    """(config, tree, prompts, logits, tokens, aux, dropped) on the
    reference."""
    if arch not in _CASES:
        _CASES[arch] = REGEN.serve_reference_case(arch)
    return _CASES[arch]


def _port(cfg, tree):
    conv = (convert.hybrid_params_from_numpy if cfg.family == "hybrid"
            else convert.dense_params_from_numpy)
    return conv(tree, cfg, "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# --------------------------------------------------------------------- #
# configurations and parameter counts
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b"])
def test_configs_match_reference(arch):
    """FULL and SMOKE field for field; the moe family is the decoder LM."""
    got, want = get_arch(arch), ref_get_arch(arch)
    for a, b in ((got.full, want.full), (got.smoke, want.smoke)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert got.shapes == want.shapes
    assert got.skipped_shapes == want.skipped_shapes
    assert registry.model_module(got.full) is lm


# (architecture, cut) → (parameters, active parameters): the published
# configurations and the cuts one H100 serves
COUNTS = {
    ("qwen2-moe-a2.7b", ()): (14_315_587_584, 2_688_976_896),
    ("dbrx-132b", ()): (131_596_523_520, 36_469_708_800),
    ("dbrx-132b", (("n_layers", 8),)): (27_305_809_920, 8_280_446_976),
    ("jamba-1.5-large-398b", ()): (398_555_111_424, 94_149_304_320),
    ("jamba-1.5-large-398b", (("n_layers", 8), ("moe_experts", 8))): (
        25_910_730_752, 11_415_216_128),
    ("minicpm3-4b", ()): (4_261_902_848, 4_261_902_848),
}


@pytest.mark.parametrize("arch,cut", sorted(COUNTS))
def test_param_counts_match_reference(arch, cut):
    """Total and active (top-k routed + shared) counts, nothing
    allocated, equal to the reference's ``count_params``."""
    cfg = get_arch(arch).full.replace(**dict(cut))
    ref_cfg = ref_get_arch(arch).full.replace(**dict(cut))
    got = (registry.count_params(cfg),
           registry.count_params(cfg, active_only=True))
    assert got == (ref_registry.count_params(ref_cfg),
                   ref_registry.count_params(ref_cfg, active_only=True))
    assert got == COUNTS[arch, cut]
    assert all(p.device.type == "meta"
               for p in registry.init(cfg, device="meta").parameters())


# --------------------------------------------------------------------- #
# the MoE layer
# --------------------------------------------------------------------- #
SMOKE = get_arch("qwen2-moe-a2.7b").smoke
MOE_CASES = {
    "capacity_drops": dict(capacity_factor=1.0, moe_shared=0),
    "pad_to": dict(moe_pad_to=8, moe_shared=0),
    "shared": dict(),
    "topk1": dict(moe_topk=1, moe_shared=0),
    "zero_router": dict(capacity_factor=1.0, moe_shared=0),
}


def _moe_case(name, dtype="float32"):
    """(port config, reference config, tree, x (4, 16, d))."""
    kw = MOE_CASES[name]
    cfg = SMOKE.replace(dtype=dtype, **kw)
    ref_cfg = ref_get_arch("qwen2-moe-a2.7b").smoke.replace(dtype=dtype,
                                                            **kw)
    rng = np.random.default_rng(11)
    tree = golden._moe_numpy_params(cfg, rng, ())
    if name == "zero_router":
        tree["router"] = np.zeros_like(tree["router"])
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    return cfg, ref_cfg, tree, x


def _ref_moe(ref_cfg, tree, x):
    """The reference's (y, aux) and its routes (experts, keep)."""
    p = jax.tree.map(jnp.asarray, tree)
    with reference():
        y, aux = ref_ffn.moe_apply(ref_cfg, p, jnp.asarray(x))
        experts, keep = REGEN.reference_routes(ref_cfg, p, jnp.asarray(x))
    return (np.asarray(y), float(aux), np.asarray(experts),
            np.asarray(keep))


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_apply_matches_reference(name):
    cfg, ref_cfg, tree, x = _moe_case(name)
    want_y, want_aux, want_e, want_keep = _ref_moe(ref_cfg, tree, x)
    layer = ffn.MoE(cfg, None, "meta").to_empty(device="cpu")
    convert._params_from_numpy(layer, tree)
    assert (layer.shared is None) == (cfg.moe_shared == 0)
    assert layer.w_gate.shape[0] == ffn.expert_buffers(cfg)
    with ffn.moe_stats() as stats:
        y, aux = ffn.moe_apply(cfg, layer, torch.as_tensor(x))
    (st,) = stats
    np.testing.assert_array_equal(st["experts"].numpy(), want_e)
    np.testing.assert_array_equal(st["keep"].numpy(), want_keep)
    assert int(st["dropped"]) == int((~want_keep).sum())
    assert y.dtype == torch.float32 and y.shape == x.shape
    _close(y, want_y, F32)
    assert abs(float(aux) - want_aux) <= AUX
    assert float(st["aux"]) == float(aux)
    t, k = want_e.shape
    if name in ("capacity_drops", "zero_router"):
        assert (~want_keep).sum() > 0
    else:
        assert want_keep.all()
    if name == "zero_router":
        # every token ties: the lower indexes win, and each of the two
        # experts keeps only its capacity's first tokens
        assert (want_e == np.arange(k)).all()
        cap = ffn.capacity(cfg, t)
        assert int((~want_keep).sum()) == k * (t - cap) > t * k // 2
    if name == "pad_to":
        assert want_e.max() < cfg.moe_experts < ffn.expert_buffers(cfg)


def test_replayed_routes_route_alike():
    """``moe_stats(replay=)``: a run replaying its own routes gives the
    same bits; replaying other routes takes exactly those, gated by its
    own probabilities, and drops by them."""
    cfg, _, tree, x = _moe_case("capacity_drops")
    layer = ffn.MoE(cfg, None, "meta").to_empty(device="cpu")
    convert._params_from_numpy(layer, tree)
    xt = torch.as_tensor(x)
    with ffn.moe_stats() as first:
        y, aux = ffn.moe_apply(cfg, layer, xt)
    with ffn.moe_stats([first[0]["experts"]]) as again:
        y2, aux2 = ffn.moe_apply(cfg, layer, xt)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    assert torch.equal(again[0]["keep"], first[0]["keep"])
    other = (first[0]["experts"] + 1) % cfg.moe_experts
    with ffn.moe_stats([other]) as forced:
        y3, _ = ffn.moe_apply(cfg, layer, xt)
    assert torch.equal(forced[0]["experts"], other)
    assert not torch.allclose(y3, y)
    probs = torch.softmax(xt.reshape(-1, cfg.d_model) @ layer.router, -1)
    gates = probs.gather(-1, other)
    gates = gates / gates.sum(-1, keepdim=True)
    flat = other.reshape(-1)
    pos = torch.cumsum(torch.nn.functional.one_hot(flat, cfg.moe_experts),
                       0).gather(1, flat[:, None])[:, 0] - 1
    keep = (pos < ffn.capacity(cfg, flat.numel() // cfg.moe_topk))
    assert torch.equal(forced[0]["keep"].reshape(-1), keep)
    assert gates.shape == other.shape


def test_moe_apply_in_bfloat16_matches_reference():
    """bf16 buffers and expert products, the fp32 router: the same routes
    and y within 2e-2."""
    cfg, ref_cfg, tree, x = _moe_case("shared", "bfloat16")
    ref_tree = {k: (v if k == "router" else jax.tree.map(
        lambda a: np.asarray(a).astype(jnp.bfloat16), v))
        for k, v in tree.items()}
    want_y, want_aux, want_e, _ = _ref_moe(ref_cfg, ref_tree, x.astype(
        jnp.bfloat16))
    layer = ffn.MoE(cfg, None, "meta").to_empty(device="cpu")
    convert._params_from_numpy(layer, tree)
    with ffn.moe_stats() as stats:
        y, aux = ffn.moe_apply(cfg, layer,
                               torch.as_tensor(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and layer.router.dtype == torch.float32
    np.testing.assert_array_equal(stats[0]["experts"].numpy(), want_e)
    _close(y.float(), want_y.astype(np.float32), 2e-2)
    assert abs(float(aux) - want_aux) <= 1e-4


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4],
                          [0.5, 0.2, 0.2, 0.1]])
    vals, idx = ffn._top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 3], [0, 1]]
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(want[1]).tolist()
    assert vals.tolist() == np.asarray(want[0]).tolist()


# --------------------------------------------------------------------- #
# the decoders
# --------------------------------------------------------------------- #
def test_jamba_with_experts_builds_the_reference_layout():
    """One super-block of 4 layers, MoE every other: FFNs 1 and 3 are
    MoE (``ffn_moe``), 0 and 2 dense (``ffn_dense``), each stacked as the
    reference's tree."""
    cfg = get_arch("jamba-1.5-large-398b").smoke
    assert hybrid._superblock_layout(cfg) == (4, [1, 3], [0, 2])
    assert hybrid._superblock_layout(cfg.replace(moe_experts=0)) == (
        4, [], [0, 1, 2, 3])
    with pytest.raises(ValueError, match="moe_period"):
        hybrid._superblock_layout(cfg.replace(moe_period=3))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """Logits within 1e-5 and the auxiliary loss summed over the layers
    within 1e-6."""
    cfg = get_arch(arch).smoke
    ref_cfg = ref_get_arch(arch).smoke
    tree, prompts = golden.lm_numpy_case(cfg)
    ref_mod = ref_hybrid if cfg.family == "hybrid" else ref_lm
    with reference():
        want, want_aux = ref_mod.forward(ref_cfg, jax.tree.map(
            jnp.asarray, tree), jnp.asarray(prompts))
    mod = hybrid if cfg.family == "hybrid" else lm
    got, aux = mod.forward(cfg, _port(cfg, tree), torch.as_tensor(prompts))
    assert got.shape == (golden.DENSE_BATCH, golden.DENSE_PROMPT_LEN,
                         cfg.vocab)
    _close(got, want, F32)
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert abs(float(aux) - float(want_aux)) <= AUX


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_every_decode_step_match_reference(arch):
    """Each call's logits (fed the reference's greedy tokens), its aux and
    its dropped pairs; no kernel is launched on the CPU."""
    cfg, tree, prompts, logits, tokens, aux, dropped = _case(arch)
    model = _port(cfg, tree)
    mod = registry.model_module(cfg)
    before = dict(kernels.LAUNCHES)
    cache = mod.init_cache(cfg, golden.DENSE_BATCH, MAX_LEN, device="cpu")
    with torch.inference_mode(), ffn.moe_stats() as stats:
        got, cache = mod.prefill(cfg, model, torch.as_tensor(prompts),
                                 cache)
        _close(got, logits[0], F32)
        for i in range(golden.DENSE_NEW_TOKENS - 1):
            got, cache = mod.decode_step(
                cfg, model, torch.as_tensor(tokens[:, i:i + 1]), cache,
                golden.DENSE_PROMPT_LEN + i)
            _close(got, logits[i + 1], F32)
    assert kernels.LAUNCHES == before
    got_aux, got_dropped = golden.call_stats(cfg, stats)
    assert got_dropped == dropped
    _close(got_aux, aux, AUX)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_reference(arch):
    """Greedy tokens equal, logits at every step within 1e-5, and the
    tokens vary."""
    cfg, tree, prompts, logits, tokens, _, _ = _case(arch)
    toks, got = ServeEngine(cfg, _port(cfg, tree), MAX_LEN).generate(
        prompts, golden.DENSE_NEW_TOKENS, return_logits=True)
    np.testing.assert_array_equal(toks, tokens)
    assert min(len(set(row)) for row in toks.tolist()) >= 4
    for g, w in zip(got, logits):
        _close(g, w, F32)


def test_moe_golden_is_the_reference_record():
    """``serve_moe_smoke.json`` is, byte for byte, what the reference
    gives for the three numpy cases today."""
    with open(GOLDEN_PATH) as f:
        assert REGEN.serve_golden_text(ARCHS) == f.read()


@pytest.mark.parametrize("arch", ARCHS)
def test_port_matches_moe_golden_on_cpu(arch):
    """The check the card runs without JAX (``chip_smoke.py``), here on
    the CPU's plain path: logits, tokens, each call's aux and drops."""
    with open(GOLDEN_PATH) as f:
        want = json.load(f)
    cfg = get_arch(arch).smoke
    rec = want[cfg.name]
    tree, prompts = golden.lm_numpy_case(cfg)
    with ffn.moe_stats() as stats:
        toks, logits = ServeEngine(cfg, _port(cfg, tree), MAX_LEN).generate(
            prompts, rec["new_tokens"], return_logits=True)
    assert not golden.mismatches(rec, logits[0], logits[1:], toks, F32)
    assert not golden.moe_mismatches(rec, *golden.call_stats(cfg, stats))
