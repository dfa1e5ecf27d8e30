"""Jamba (the hybrid family) serving on the port, on the CPU, against the
JAX package.

At ``jamba-smoke`` width without experts (one super-block: 1 attention +
3 Mamba layers, d 64, d_state 4) with the reference's parameters carried
across by ``convert.hybrid_params_from_numpy``: RoPE, cached attention
with RoPE, the Mamba layer (the port's scan op against the reference's
associative-scan ``_mamba_inner``), ``forward``, the prefill's and every
decode step's logits, and ``ServeEngine.generate``'s greedy tokens.
Tolerances: 1e-5 (rtol and atol) in float32, though the Mamba scan's
sums run in another order (sequential against the reference's
associative scan; the logits differ by at most 1.3e-6); 2e-2 in
bfloat16.

Parameters and prompts come from numpy (:mod:`repro_torch.serve.golden`).
``tests/goldens/serve_jamba_smoke.json`` is the reference's record of the
float32 case; running this file as a script rewrites it::

    PYTHONPATH=src python tests/test_torch_hybrid.py
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import hybrid as ref_hybrid  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models.layers import attention as ref_attention  # noqa: E402
from repro.models.layers import recurrent as ref_recurrent  # noqa: E402
from repro.models.layers import rope as ref_rope  # noqa: E402
from repro.serve import ServeEngine as RefEngine  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import hybrid, registry  # noqa: E402
from repro_torch.models.layers import attention, recurrent, rope  # noqa: E402
from repro_torch.serve import ServeEngine, golden  # noqa: E402
from test_torch_oracle import torch_one_thread  # noqa: E402,F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ARCH = "jamba-1.5-large-398b"
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           golden.JAMBA_GOLDEN_NAME)
MAX_LEN = golden.JAMBA_PROMPT_LEN + golden.NEW_TOKENS + golden.CACHE_SLACK
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
F32 = TOL["float32"]
FP32_KEEP = ("attn_ln", "mamba_ln", "ffn_ln", "ln_f", "dt_bias", "a_log",
             "d_skip")


def _ref_tree(tree, dtype):
    """The reference's tree in its own dtypes: norm scales and the SSM's
    dt_bias, a_log and d_skip stay float32."""
    def cast(path, a):
        keep = any(getattr(p, "key", None) in FP32_KEEP for p in path)
        return jnp.asarray(a, jnp.float32 if keep else jnp.dtype(dtype))
    return jax.tree_util.tree_map_with_path(cast, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@dataclasses.dataclass
class Case:
    cfg: object          # the port's config
    ref_cfg: object      # the reference's config
    tree: dict           # float32 numpy parameters (reference layout)
    prompts: np.ndarray
    logits: list         # reference prefill + decode-step logits (float32)
    tokens: np.ndarray   # reference greedy tokens


def reference_case(dtype: str = "float32") -> Case:
    """Serve the numpy case on the reference: tokens from its jitted
    ``ServeEngine``, logits from its ``prefill``/``decode_step`` fed those
    tokens."""
    cfg = golden.jamba_config().replace(dtype=dtype)
    ref_cfg = ref_get_arch(ARCH).smoke.replace(moe_experts=0, moe_topk=0,
                                               dtype=dtype)
    tree, prompts = golden.jamba_numpy_case(cfg)
    params = _ref_tree(tree, dtype)
    tokens = RefEngine(cfg=ref_cfg, params=params, max_len=MAX_LEN).generate(
        prompts, golden.NEW_TOKENS)
    cache = ref_hybrid.init_cache(ref_cfg, golden.BATCH, MAX_LEN)
    logits, cache = ref_hybrid.prefill(ref_cfg, params, jnp.asarray(prompts),
                                       cache)
    out = [np.asarray(logits, np.float32)]
    for i in range(golden.NEW_TOKENS - 1):
        logits, cache = ref_hybrid.decode_step(
            ref_cfg, params, jnp.asarray(tokens[:, i:i + 1]), cache,
            golden.JAMBA_PROMPT_LEN + i)
        out.append(np.asarray(logits, np.float32))
    return Case(cfg, ref_cfg, tree, prompts, out, np.asarray(tokens))


def golden_text() -> str:
    case = reference_case()
    return golden.dumps(golden.record(case.cfg, case.logits[0],
                                      case.logits[1:], case.tokens))


_CASES = {}


def _case(dtype="float32") -> Case:
    if dtype not in _CASES:
        _CASES[dtype] = reference_case(dtype)
    return _CASES[dtype]


def _port_model(case: Case):
    return convert.hybrid_params_from_numpy(case.tree, case.cfg, "cpu")


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("angles_ndim", [2, 3])
def test_rope_matches_reference(angles_ndim):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32) + 5
    if angles_ndim == 3:
        pos = np.stack([pos, pos + 100])
    want_ang = ref_rope.rope_angles(jnp.asarray(pos), 16, 10_000.0)
    ang = rope.rope_angles(torch.as_tensor(pos), 16, 10_000.0)
    _close(ang, want_ang, 1e-6)
    want = ref_rope.apply_rope(jnp.asarray(x), want_ang)
    _close(rope.apply_rope(torch.as_tensor(x), ang), want, 1e-5)


def _attn_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim
    p = {"wq": rng.standard_normal((d, cfg.n_heads * hd)) * d ** -0.5,
         "wk": rng.standard_normal((d, cfg.n_kv_heads * hd)) * d ** -0.5,
         "wv": rng.standard_normal((d, cfg.n_kv_heads * hd)) * d ** -0.5,
         "wo": rng.standard_normal((cfg.n_heads * hd, d)) * d ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 6, d)).astype(np.float32)
    mod = attention.GQA(cfg, None, "meta").to_empty(device="cpu")
    for k, v in p.items():
        getattr(mod, k).data.copy_(torch.as_tensor(v))
    return p, x, mod


@pytest.mark.parametrize("cached", [False, True], ids=["causal", "cached"])
def test_gqa_with_rope_matches_reference(cached):
    """RoPE on q and k before the cache write; a cached call at index 3
    over a cache whose first rows hold earlier keys."""
    cfg = golden.jamba_config()
    p, x, mod = _attn_inputs(cfg, seed=1)
    index = 3 if cached else 0
    pos = np.arange(6, dtype=np.int32)[None].repeat(2, 0) + index
    ang = ref_rope.rope_angles(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta)
    ref_cfg = ref_get_arch(ARCH).smoke.replace(moe_experts=0)
    shape = (2, 16, cfg.n_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(2)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    want, want_cache = ref_attention.gqa_apply(
        ref_cfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        angles=ang,
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)} if cached else None,
        cache_index=index if cached else None)
    cache = ({"k": torch.as_tensor(ck), "v": torch.as_tensor(cv)}
             if cached else None)
    got, got_cache = attention.gqa_apply(
        cfg, mod, torch.as_tensor(x),
        angles=rope.rope_angles(torch.as_tensor(pos), cfg.head_dim,
                                cfg.rope_theta),
        cache=cache, cache_index=index if cached else None)
    _close(got, want, 1e-5)
    if cached:
        _close(got_cache["k"], want_cache["k"], 1e-5)
        _close(got_cache["v"], want_cache["v"], 1e-5)


def _mamba(case, j):
    cfg = case.cfg
    tree = {k: v[0, j] for k, v in case.tree["blocks"]["mamba"].items()}
    mod = recurrent.Mamba(cfg, None, "meta").to_empty(device="cpu")
    for k, v in tree.items():
        getattr(mod, k).data.copy_(torch.as_tensor(v))
    return tree, mod


@pytest.mark.parametrize("j", [0, 2])
def test_mamba_apply_matches_reference(j):
    """The port's scan op against the reference's associative scan in
    chunks of 8 (S 20: two full chunks and a padded one)."""
    case = _case()
    tree, mod = _mamba(case, j)
    x = np.random.default_rng(j).standard_normal(
        (2, 20, case.cfg.d_model)).astype(np.float32)
    want = ref_recurrent.mamba_apply(
        case.ref_cfg, {k: jnp.asarray(v) for k, v in tree.items()},
        jnp.asarray(x))
    before = dict(kernels.LAUNCHES)
    _close(recurrent.mamba_apply(case.cfg, mod, torch.as_tensor(x)), want,
           F32)
    assert kernels.LAUNCHES == before


def test_mamba_step_matches_reference():
    """A prompt, then two single tokens, each resuming from the state the
    last call left (conv window and SSM state)."""
    case = _case()
    tree, mod = _mamba(case, 1)
    ref_p = {k: jnp.asarray(v) for k, v in tree.items()}
    rng = np.random.default_rng(4)
    ref_st = ref_recurrent.mamba_init_state(case.ref_cfg, 2)
    st = recurrent.mamba_init_state(case.cfg, 2)
    for s in (13, 1, 1):
        x = rng.standard_normal((2, s, case.cfg.d_model)).astype(np.float32)
        want, ref_st = ref_recurrent.mamba_step(case.ref_cfg, ref_p,
                                                jnp.asarray(x), ref_st)
        got, st = recurrent.mamba_step(case.cfg, mod, torch.as_tensor(x), st)
        _close(got, want, F32)
        _close(st["conv"], ref_st["conv"], 1e-6)
        _close(st["ssm"], ref_st["ssm"], F32)


def test_mamba_init_matches_reference_constants():
    """The parameters the reference initialises to constants: a_log,
    dt_bias, d_skip, conv_b; and every shape and dtype."""
    cfg = golden.jamba_config()
    ref_cfg = ref_get_arch(ARCH).smoke.replace(moe_experts=0)
    want = ref_recurrent.mamba_init(ref_cfg, jax.random.PRNGKey(0))
    got = dict(recurrent.Mamba(cfg, torch.Generator().manual_seed(0),
                               "cpu").named_parameters())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
    for k in ("a_log", "dt_bias", "d_skip", "conv_b"):
        _close(got[k], want[k], 1e-7)


# --------------------------------------------------------------------- #
# the model and serving
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    cfg = golden.jamba_config().replace(dtype=dtype)
    ref_cfg = ref_get_arch(ARCH).smoke.replace(moe_experts=0, moe_topk=0,
                                               dtype=dtype)
    tree, prompts = golden.jamba_numpy_case(cfg)
    want, aux = ref_hybrid.forward(ref_cfg, _ref_tree(tree, dtype),
                                   jnp.asarray(prompts))
    model = convert.hybrid_params_from_numpy(tree, cfg, "cpu")
    got, got_aux = hybrid.forward(cfg, model, torch.as_tensor(prompts))
    assert got.dtype == torch.float32 and float(got_aux) == float(aux) == 0
    _close(got, want, TOL[dtype])


def test_prefill_and_every_decode_step_match_reference():
    """Logits of the prefill and of each decode step, each step fed the
    reference's greedy token; the caches hold the reference's states; no
    kernel is launched on the CPU."""
    case = _case()
    model = _port_model(case)
    before = dict(kernels.LAUNCHES)
    cache = hybrid.init_cache(case.cfg, golden.BATCH, MAX_LEN, device="cpu")
    logits, cache = hybrid.prefill(case.cfg, model,
                                   torch.as_tensor(case.prompts), cache)
    _close(logits, case.logits[0], F32)
    for i in range(golden.NEW_TOKENS - 1):
        logits, cache = hybrid.decode_step(
            case.cfg, model, torch.as_tensor(case.tokens[:, i:i + 1]), cache,
            golden.JAMBA_PROMPT_LEN + i)
        assert logits.shape == (golden.BATCH, 1, case.cfg.vocab)
        _close(logits, case.logits[i + 1], F32)
    assert kernels.LAUNCHES == before
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == cache["kv"]["k"].dtype == torch.float32


def test_serve_engine_matches_reference():
    """Greedy tokens equal, logits at every step within 1e-5, and the
    tokens vary (the case is not one repeated token)."""
    case = _case()
    model = _port_model(case)
    toks, logits = ServeEngine(case.cfg, model, MAX_LEN).generate(
        case.prompts, golden.NEW_TOKENS, return_logits=True)
    assert toks.dtype == np.int32 and toks.shape == case.tokens.shape
    np.testing.assert_array_equal(toks, case.tokens)
    assert min(len(set(row)) for row in toks.tolist()) >= 4
    for got, want in zip(logits, case.logits):
        _close(got, want, F32)


def test_bf16_serving_matches_reference():
    """The same case in bfloat16 on both sides: the served logits (fp32)
    of the prefill and every step, fed the reference's tokens, at 2e-2."""
    case = _case("bfloat16")
    model = _port_model(case)
    assert model.blocks[0].mamba[0].in_proj.dtype == torch.bfloat16
    logits = ServeEngine(case.cfg, model, MAX_LEN).teacher_forced_logits(
        case.prompts, case.tokens)
    assert all(x.dtype == torch.float32 for x in logits)
    for got, want in zip(logits, case.logits):
        _close(got, want, TOL["bfloat16"])


def test_moe_config_is_refused():
    """Jamba with its experts builds the reference's tree, name for name
    and shape for shape (MoE FFNs under ``ffn_moe``, the dense ones under
    ``ffn_dense``); only a layout the super-block cannot hold (an
    attn_period that is not a multiple of moe_period) is refused."""
    cfg = get_arch(ARCH).smoke
    assert cfg.is_moe
    ref_cfg = ref_get_arch(ARCH).smoke
    want = jax.eval_shape(lambda: ref_hybrid.init(
        ref_cfg, jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(path): leaf.shape for path, leaf in
            jax.tree_util.tree_leaves_with_path(want)}
    model = registry.init(cfg, 0, "cpu")
    nsb = cfg.n_layers // cfg.attn_period
    got = {}
    for name, p in model.named_parameters():
        keys = [k for k in name.split(".") if not k.isdigit()]
        got.setdefault("".join(f"['{k}']" for k in keys), []).append(p.shape)
    assert set(got) == set(want)
    for key, shapes in got.items():
        lead = want[key][:-len(shapes[0])]    # stacked axes of the tree
        assert len(shapes) == int(np.prod(lead)) and len(lead) <= 2, key
        assert all(s == want[key][len(lead):] for s in shapes), key
        assert lead[:1] == ((nsb,) if key.startswith("['blocks']")
                            else ()), key
    assert len(model.blocks[0].ffn_moe) == 2
    assert len(model.blocks[0].ffn_dense) == 2
    with pytest.raises(ValueError, match="moe_period"):
        registry.init(cfg.replace(moe_period=3), 0, "cpu")


def test_param_count_of_served_config_matches_reference():
    """The configuration served on the card (published widths, one
    super-block, no experts): 8 999 034 880 parameters on both sides,
    nothing allocated."""
    cut = {"n_layers": 8, "moe_experts": 0, "moe_topk": 0}
    cfg = get_arch(ARCH).full.replace(**cut)
    want = ref_registry.count_params(ref_get_arch(ARCH).full.replace(**cut))
    assert cfg.param_count() == want == 8_999_034_880


def test_jamba_golden_is_the_reference_record():
    """``serve_jamba_smoke.json`` is, byte for byte, what the reference
    gives for the numpy case today."""
    with open(GOLDEN_PATH) as f:
        assert golden_text() == f.read()


def test_port_matches_jamba_golden_on_cpu():
    """The check the card runs without JAX (``chip_smoke.py``), here on the
    CPU's plain path."""
    with open(GOLDEN_PATH) as f:
        want = json.load(f)
    cfg = golden.jamba_config()
    assert (want["config"], want["prompt_len"]) == (
        cfg.name, golden.JAMBA_PROMPT_LEN)
    tree, prompts = golden.jamba_numpy_case(cfg)
    model = convert.hybrid_params_from_numpy(tree, cfg, "cpu")
    toks, logits = ServeEngine(cfg, model, MAX_LEN).generate(
        prompts, want["new_tokens"], return_logits=True)
    assert not golden.mismatches(want, logits[0], logits[1:], toks,
                                 F32)


if __name__ == "__main__":
    with open(GOLDEN_PATH, "w") as f:
        f.write(golden_text())
    print(f"wrote {GOLDEN_PATH}", file=sys.stderr)
