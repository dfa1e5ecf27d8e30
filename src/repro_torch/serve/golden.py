"""The serve goldens: smoke cases drawn from numpy, and the record of
what serving them gives.

The reference and the port draw parameters from different generators,
so a case they can both run must come from neither: :func:`numpy_case`
draws the reference's whisper parameter tree, the encoder frames and the
prompts from one numpy seed, :func:`jamba_numpy_case` the Jamba tree
(with or without experts) and the prompts, :func:`dense_numpy_case` a
decoder LM's tree (dense, MoE or MLA) and the prompts.
``tests/goldens/serve_whisper_smoke.json``, ``serve_jamba_smoke.json``
(no experts), ``serve_dense_smoke.json`` (one record for each of the
three dense smoke configurations, at the batch of the reference's
``examples/serve_decode.py``), ``serve_moe_smoke.json`` (qwen2-moe,
dbrx and Jamba with its experts, at that batch, with each call's summed
auxiliary loss and dropped (token, slot) pairs) and
``serve_mla_smoke.json`` (minicpm3), ``serve_vlm_smoke.json`` (qwen2-vl:
the served record, and an image-style prefill of stub-frontend
embeddings at patch-grid M-RoPE ids, :func:`vlm_image_case`, with its
decode steps) and ``serve_ssm_smoke.json`` (xLSTM,
:func:`xlstm_numpy_case`) hold the reference's float32 logits
(prefill and every decode step) and its greedy tokens for those cases;
the port is held against them on the CPU and, where there is no JAX, on
the card.

The whisper weights are drawn with a small embedding scale and a gain on
the attention weights: with the reference's own init the tied embedding
dominates the residual stream, so the model greedily repeats its input
token and token equality would prove little.  Jamba's head is untied;
its weights keep the reference's fan-in scales, with the parameters the
reference initialises to constants (norm scales, biases, the SSM's A,
skip and step size) drawn around those constants, so that a transposed
or misplaced one shows.  The dense LMs' trees are drawn the same way,
and so is xLSTM's: its gate biases (the forget gates' 3.0) and norm
scales drawn around the reference's constants.
"""

from __future__ import annotations

import json
import math

import numpy as np

from ..configs import get_arch
from ..models.common import ModelConfig
from ..models.encdec import MAX_DEC_POS

GOLDEN_NAME = "serve_whisper_smoke.json"
SEED = 0
BATCH = 2
PROMPT_LEN = 8
NEW_TOKENS = 8
CACHE_SLACK = 8        # max_len = prompt + new tokens + slack, as the
                       # reference's serving example sizes its cache
DECIMALS = 4
EMBED_SCALE = 0.03
ATTN_GAIN = 1.8
JAMBA_GOLDEN_NAME = "serve_jamba_smoke.json"
JAMBA_PROMPT_LEN = 20  # two of the attention twin's 16-row chunks, three
                       # of the reference's 8-step Mamba chunks; ragged
DENSE_GOLDEN_NAME = "serve_dense_smoke.json"
DENSE_ARCHS = ("codeqwen1.5-7b", "internlm2-1.8b", "stablelm-3b")
# the reference's examples/serve_decode.py defaults: 4 requests, 16-token
# prompts, 24 new tokens, a cache of prompt + new + 8 rows
DENSE_BATCH, DENSE_PROMPT_LEN, DENSE_NEW_TOKENS = 4, 16, 24
MOE_GOLDEN_NAME = "serve_moe_smoke.json"
MOE_ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b", "jamba-1.5-large-398b")
MLA_GOLDEN_NAME = "serve_mla_smoke.json"
MLA_ARCHS = ("minicpm3-4b",)
VLM_GOLDEN_NAME = "serve_vlm_smoke.json"
VLM_ARCHS = ("qwen2-vl-2b",)
SSM_GOLDEN_NAME = "serve_ssm_smoke.json"
SSM_ARCHS = ("xlstm-1.3b",)
# the image-style prompt: 4 text tokens, an 8 x 8 patch grid, 4 text
# tokens (72 positions), then IMAGE_STEPS decode steps
IMAGE_BEFORE, IMAGE_GRID, IMAGE_AFTER = 4, (8, 8), 4
IMAGE_STEPS = 8
IMAGE_LEN = IMAGE_BEFORE + IMAGE_GRID[0] * IMAGE_GRID[1] + IMAGE_AFTER
AUX_DECIMALS = 10


def config() -> ModelConfig:
    """The golden's configuration: whisper's smoke config (float32,
    ``enc_seq`` 32)."""
    return get_arch("whisper-base").smoke


def _normal(rng, shape, std):
    """Truncated at ±2 standard units, as the reference's init."""
    return (np.clip(rng.standard_normal(shape), -2.0, 2.0)
            * std).astype(np.float32)


def numpy_params(cfg: ModelConfig, rng: np.random.Generator) -> dict:
    """The reference's whisper parameter tree (layers stacked on a
    leading axis), float32, drawn from ``rng`` in a fixed order."""
    d, f, h, kv, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    g = ATTN_GAIN

    def attn(n):
        return {"wq": _normal(rng, (n, d, h * hd), g * d ** -0.5),
                "wk": _normal(rng, (n, d, kv * hd), g * d ** -0.5),
                "wv": _normal(rng, (n, d, kv * hd), g * d ** -0.5),
                "wo": _normal(rng, (n, h * hd, d), g * (h * hd) ** -0.5)}

    def norm(*lead):
        shape = (*lead, d)
        return {"scale": (1 + 0.1 * rng.standard_normal(shape)
                          ).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(shape)).astype(np.float32)}

    def mlp(n):
        return {"w_in": _normal(rng, (n, d, f), d ** -0.5),
                "b_in": (0.1 * rng.standard_normal((n, f))).astype(np.float32),
                "w_out": _normal(rng, (n, f, d), f ** -0.5),
                "b_out": (0.1 * rng.standard_normal((n, d))
                          ).astype(np.float32)}

    le, ld = cfg.enc_layers, cfg.n_layers
    return {
        "enc_blocks": {"ln1": norm(le), "attn": attn(le), "ln2": norm(le),
                       "mlp": mlp(le)},
        "enc_ln": norm(),
        "embed": {"table": _normal(rng, (cfg.vocab, d), EMBED_SCALE)},
        "pos": _normal(rng, (MAX_DEC_POS, d), 0.02),
        "dec_blocks": {"ln1": norm(ld), "attn": attn(ld), "ln_x": norm(ld),
                       "xattn": attn(ld), "ln2": norm(ld), "mlp": mlp(ld)},
        "dec_ln": norm(),
    }


def jamba_config() -> ModelConfig:
    """The Jamba golden's configuration: the smoke config without
    experts (float32, one super-block of 1 attention + 3 Mamba layers)."""
    return get_arch("jamba-1.5-large-398b").smoke.replace(moe_experts=0,
                                                          moe_topk=0)


def _moe_numpy_params(cfg: ModelConfig, rng: np.random.Generator,
                      lead: tuple) -> dict:
    """A MoE FFN's tree, stacked on ``lead`` (layers), experts next: the
    router at fan-in scale, so routes vary from token to token."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    ep = max(cfg.moe_pad_to, e) if cfg.moe_pad_to else e
    tree = {"router": _normal(rng, (*lead, d, e), d ** -0.5),
            "w_gate": _normal(rng, (*lead, ep, d, f), d ** -0.5),
            "w_up": _normal(rng, (*lead, ep, d, f), d ** -0.5),
            "w_down": _normal(rng, (*lead, ep, f, d), f ** -0.5)}
    if cfg.moe_shared > 0:
        fs = cfg.moe_shared * f
        tree["shared"] = {"w_gate": _normal(rng, (*lead, d, fs), d ** -0.5),
                          "w_up": _normal(rng, (*lead, d, fs), d ** -0.5),
                          "w_down": _normal(rng, (*lead, fs, d), fs ** -0.5)}
    return tree


def jamba_numpy_params(cfg: ModelConfig, rng: np.random.Generator) -> dict:
    """The reference's hybrid parameter tree (super-blocks stacked on
    axis 0, a super-block's layers on axis 1), float32, drawn from
    ``rng`` in a fixed order; with experts, the MoE FFNs (``ffn_moe``)
    are drawn last of the super-blocks' parameters."""
    d, f, h, kv, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    ap = cfg.attn_period
    nsb, nm = cfg.n_layers // ap, ap - 1
    n_moe = sum(cfg.is_moe and j % cfg.moe_period == cfg.moe_period - 1
                for j in range(ap))
    di = cfg.mamba_expand * d
    dtr = max(1, -(-d // 16))
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv

    def normal(shape, fan_in):
        return _normal(rng, shape, fan_in ** -0.5)

    def near(shape, centre, spread=0.1):
        return (centre + spread * rng.standard_normal(shape)
                ).astype(np.float32)

    # step sizes log-uniform in [1e-3, 1e-1] (the Mamba paper's dt init)
    dt = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1), (nsb, nm, di)))
    mamba = {
        "in_proj": normal((nsb, nm, d, 2 * di), d),
        "conv_w": _normal(rng, (nsb, nm, dc, di), dc ** -0.5),
        "conv_b": near((nsb, nm, di), 0.0),
        "x_proj": normal((nsb, nm, di, dtr + 2 * ds), di),
        "dt_proj": normal((nsb, nm, dtr, di), dtr),
        "dt_bias": np.log(np.expm1(dt)).astype(np.float32),
        "a_log": near((nsb, nm, di, ds), np.log(np.arange(1, ds + 1))),
        "d_skip": near((nsb, nm, di), 1.0),
        "out_proj": normal((nsb, nm, di, d), di),
    }
    blocks = {
        "attn": {"wq": normal((nsb, d, h * hd), d),
                 "wk": normal((nsb, d, kv * hd), d),
                 "wv": normal((nsb, d, kv * hd), d),
                 "wo": normal((nsb, h * hd, d), h * hd)},
        "attn_ln": {"scale": near((nsb, d), 1.0)},
        "mamba": mamba,
        "mamba_ln": {"scale": near((nsb, nm, d), 1.0)},
        "ffn_ln": {"scale": near((nsb, ap, d), 1.0)},
        "ffn_dense": {"w_gate": normal((nsb, ap - n_moe, d, f), d),
                      "w_up": normal((nsb, ap - n_moe, d, f), d),
                      "w_down": normal((nsb, ap - n_moe, f, d), f)},
    }
    if n_moe:
        blocks["ffn_moe"] = _moe_numpy_params(cfg, rng, (nsb, n_moe))
    return {"embed": {"table": _normal(rng, (cfg.vocab, d), 1.0)},
            "blocks": blocks,
            "ln_f": {"scale": near((d,), 1.0)},
            "head": {"w": normal((cfg.vocab, d), cfg.vocab)}}


def jamba_numpy_case(cfg: ModelConfig, seed: int = SEED, batch: int = BATCH,
                     prompt_len: int = JAMBA_PROMPT_LEN):
    """(parameter tree, prompts (B, P) int32), both from ``seed``."""
    rng = np.random.default_rng(seed)
    tree = jamba_numpy_params(cfg, rng)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    return tree, prompts


def dense_numpy_params(cfg: ModelConfig, rng: np.random.Generator) -> dict:
    """The reference's decoder-LM parameter tree (layers stacked on axis
    0; the dense, MoE and MLA configurations), float32, drawn from
    ``rng`` in a fixed order: norms, attention (GQA or MLA), FFN (SwiGLU
    or MoE), embedding, final norm, head."""
    d, f, h, kv, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    n = cfg.n_layers

    def normal(shape, fan_in):
        return _normal(rng, shape, fan_in ** -0.5)

    def near_one(shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    blocks = {"ln1": {"scale": near_one((n, d))},
              "ln2": {"scale": near_one((n, d))}}
    if cfg.mla:
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dvh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        blocks["attn"] = {
            "q_down": normal((n, d, qr), d),
            "q_norm": {"scale": near_one((n, qr))},
            "q_up": normal((n, qr, h * (dn + dr)), qr),
            "kv_down": normal((n, d, kvr + dr), d),
            "kv_norm": {"scale": near_one((n, kvr))},
            "kv_up": normal((n, kvr, h * (dn + dvh)), kvr),
            "wo": normal((n, h * dvh, d), h * dvh)}
    else:
        blocks["attn"] = {"wq": normal((n, d, h * hd), d),
                          "wk": normal((n, d, kv * hd), d),
                          "wv": normal((n, d, kv * hd), d),
                          "wo": normal((n, h * hd, d), h * hd)}
    if cfg.is_moe and cfg.moe_period == 1:
        blocks["ffn"] = _moe_numpy_params(cfg, rng, (n,))
    else:
        blocks["ffn"] = {"w_gate": normal((n, d, f), d),
                         "w_up": normal((n, d, f), d),
                         "w_down": normal((n, f, d), f)}
    tree = {"embed": {"table": _normal(rng, (cfg.vocab, d), 1.0)},
            "blocks": blocks,
            "ln_f": {"scale": near_one((d,))}}
    if not cfg.tie_embeddings:
        tree["head"] = {"w": normal((cfg.vocab, d), cfg.vocab)}
    return tree


def lm_numpy_case(cfg: ModelConfig, seed: int = SEED):
    """The numpy case of a golden at the example's batch: Jamba's tree
    for the hybrid family, xLSTM's for the ssm family, else a decoder
    LM's (the vlm's too)."""
    if cfg.family == "hybrid":
        return jamba_numpy_case(cfg, seed, DENSE_BATCH, DENSE_PROMPT_LEN)
    if cfg.family == "ssm":
        return xlstm_numpy_case(cfg, seed)
    return dense_numpy_case(cfg, seed)


def image_positions(batch: int) -> np.ndarray:
    """(3, B, IMAGE_LEN) int32 t/h/w ids of the image-style prompt: the
    leading text at equal ids 0, 1, ...; the patch grid at t fixed at the
    offset after the text, h = offset + row, w = offset + column; the
    trailing text from one past the grid's largest id, equal again."""
    gh, gw = IMAGE_GRID
    off = IMAGE_BEFORE
    text0 = np.arange(off)
    rows, cols = np.divmod(np.arange(gh * gw), gw)
    start = off + max(gh, gw)
    text1 = start + np.arange(IMAGE_AFTER)
    thw = np.stack([
        np.concatenate([text0, np.full(gh * gw, off), text1]),
        np.concatenate([text0, off + rows, text1]),
        np.concatenate([text0, off + cols, text1])]).astype(np.int32)
    return np.ascontiguousarray(
        np.broadcast_to(thw[:, None], (3, batch, IMAGE_LEN)))


def vlm_image_case(cfg: ModelConfig, seed: int = SEED, batch: int = BATCH):
    """(text tokens (B, IMAGE_BEFORE + IMAGE_AFTER) int32, patch
    embeddings (B, grid cells, d) float32 at the embedding table's scale,
    positions (3, B, IMAGE_LEN) int32): the stub frontend's inputs, from
    ``seed``.  :func:`image_embeds` merges them with the text's rows."""
    rng = np.random.default_rng(seed + 1)
    text = rng.integers(0, cfg.vocab, (batch, IMAGE_BEFORE + IMAGE_AFTER)
                        ).astype(np.int32)
    cells = IMAGE_GRID[0] * IMAGE_GRID[1]
    patches = _normal(rng, (batch, cells, cfg.d_model), 1.0)
    return text, patches, image_positions(batch)


def image_embeds(text_emb, patches):
    """The prompt's (B, IMAGE_LEN, d) embeddings: the text rows' before
    and after the patches (numpy arrays or torch tensors alike)."""
    parts = (text_emb[:, :IMAGE_BEFORE], patches, text_emb[:, IMAGE_BEFORE:])
    if isinstance(text_emb, np.ndarray):
        return np.concatenate(parts, axis=1)
    import torch

    return torch.cat(parts, dim=1)


def image_generate(cfg: ModelConfig, model, text, patches, positions,
                   steps: int = IMAGE_STEPS, forced=None):
    """The image-style case on the port, on the model's device: the
    prefill of :func:`image_embeds` (the model's own text rows) at
    ``positions``, then ``steps`` greedy decode steps at the default
    positions, into a cache of IMAGE_LEN + steps + CACHE_SLACK rows; with
    ``forced`` (B, ≥ steps) each step is fed ``forced[:, i]`` instead of
    the last greedy token, so two runs can be compared call by call.
    Returns (tokens (B, steps + 1) int32 numpy, the fp32 logits of every
    call)."""
    import torch

    from ..models import lm

    table = model.embed.table
    dev = table.device
    with torch.inference_mode():
        emb = image_embeds(table[torch.as_tensor(text, device=dev)],
                           torch.as_tensor(patches, device=dev).to(
                               table.dtype))
        cache = lm.init_cache(cfg, emb.shape[0],
                              IMAGE_LEN + steps + CACHE_SLACK, device=dev)
        logits, cache = lm.prefill(cfg, model, None, cache,
                                   positions=torch.as_tensor(positions,
                                                             device=dev),
                                   embeds=emb)
        out = [logits]
        toks = [torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)]
        if forced is not None:
            forced = torch.as_tensor(np.asarray(forced, np.int32),
                                     device=dev)
        for i in range(steps):
            fed = toks[-1] if forced is None else forced[:, i:i + 1]
            logits, cache = lm.decode_step(cfg, model, fed, cache,
                                           IMAGE_LEN + i)
            out.append(logits)
            toks.append(torch.argmax(logits[:, -1:], dim=-1).to(
                torch.int32))
    return torch.cat(toks, dim=1).cpu().numpy(), out


def xlstm_numpy_params(cfg: ModelConfig, rng: np.random.Generator) -> dict:
    """The reference's xLSTM parameter tree (super-blocks stacked on axis
    0, a super-block's mLSTM layers on axis 1), float32, drawn from
    ``rng`` in a fixed order."""
    d, h = cfg.d_model, cfg.n_heads
    sp = cfg.slstm_period if cfg.slstm_period > 0 else cfg.n_layers
    nsb, nm = cfg.n_layers // sp, sp - 1
    dp = int(cfg.xlstm_proj_factor * d)
    dh, f = d // h, int(d * 4 / 3)

    def normal(shape, fan_in):
        return _normal(rng, shape, fan_in ** -0.5)

    def near(shape, centre, spread=0.1):
        return (centre + spread * rng.standard_normal(shape)
                ).astype(np.float32)

    gates = np.concatenate([np.zeros(2 * d), np.full(d, 3.0), np.zeros(d)])
    blocks = {
        "slstm": {"w": normal((nsb, d, 4 * d), d),
                  "r": normal((nsb, h, dh, 4 * dh), dh),
                  "b": near((nsb, 4 * d), gates),
                  "out": normal((nsb, d, d), d)},
        "slstm_ln": {"scale": near((nsb, d), 1.0)},
        "slstm_ffn": {"w_gate": normal((nsb, d, f), d),
                      "w_up": normal((nsb, d, f), d),
                      "w_down": normal((nsb, f, d), f)},
        "slstm_ffn_ln": {"scale": near((nsb, d), 1.0)},
        "mlstm": {"up": normal((nsb, nm, d, 2 * dp), d),
                  "wq": normal((nsb, nm, dp, dp), dp),
                  "wk": normal((nsb, nm, dp, dp), dp),
                  "wv": normal((nsb, nm, dp, dp), dp),
                  "wi": normal((nsb, nm, dp, h), dp),
                  "bi": near((nsb, nm, h), 0.0),
                  "wf": normal((nsb, nm, dp, h), dp),
                  "bf": near((nsb, nm, h), 3.0),
                  "norm": {"scale": near((nsb, nm, dp), 1.0)},
                  "down": normal((nsb, nm, dp, d), dp)},
        "mlstm_ln": {"scale": near((nsb, nm, d), 1.0)},
    }
    return {"embed": {"table": _normal(rng, (cfg.vocab, d), 1.0)},
            "blocks": blocks,
            "ln_f": {"scale": near((d,), 1.0)},
            "head": {"w": normal((cfg.vocab, d), cfg.vocab)}}


def xlstm_numpy_case(cfg: ModelConfig, seed: int = SEED,
                     batch: int = DENSE_BATCH,
                     prompt_len: int = DENSE_PROMPT_LEN):
    """(parameter tree, prompts (B, P) int32), both from ``seed``."""
    rng = np.random.default_rng(seed)
    tree = xlstm_numpy_params(cfg, rng)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    return tree, prompts


def dense_numpy_case(cfg: ModelConfig, seed: int = SEED,
                     batch: int = DENSE_BATCH,
                     prompt_len: int = DENSE_PROMPT_LEN):
    """(parameter tree, prompts (B, P) int32), both from ``seed``."""
    rng = np.random.default_rng(seed)
    tree = dense_numpy_params(cfg, rng)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    return tree, prompts


def numpy_case(cfg: ModelConfig, seed: int = SEED, batch: int = BATCH,
               prompt_len: int = PROMPT_LEN):
    """(parameter tree, frames (B, enc_seq, d) float32, prompts (B, P)
    int32), all from ``seed``."""
    rng = np.random.default_rng(seed)
    tree = numpy_params(cfg, rng)
    frames = rng.standard_normal(
        (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    return tree, frames, prompts


def _rounded(a) -> list:
    return np.round(np.asarray(a, np.float64), DECIMALS).tolist()


def record(cfg: ModelConfig, prefill_logits, step_logits, tokens) -> dict:
    """The golden's content: prefill logits (B, P, V), the decode steps'
    last-position logits (T-1, B, V), rounded to ``DECIMALS``, and the
    greedy tokens (B, T)."""
    steps = np.stack([np.asarray(s, np.float32)[:, -1] for s in step_logits])
    b, p = np.shape(prefill_logits)[:2]
    enc = {"enc_seq": cfg.enc_seq} if cfg.family == "encdec" else {}
    return {"config": cfg.name, **enc, "seed": SEED, "batch": b,
            "prompt_len": p, "new_tokens": np.shape(tokens)[1],
            "decimals": DECIMALS,
            "tokens": np.asarray(tokens, np.int64).tolist(),
            "prefill_logits": _rounded(prefill_logits),
            "step_logits": _rounded(steps)}


def moe_record(cfg: ModelConfig, prefill_logits, step_logits, tokens,
               aux, dropped) -> dict:
    """:func:`record` with each call's auxiliary loss summed over the
    layers (the prefill's first, rounded to ``AUX_DECIMALS``) and its
    dropped (token, slot) pairs summed over the layers."""
    rec = record(cfg, prefill_logits, step_logits, tokens)
    rec["aux_decimals"] = AUX_DECIMALS
    rec["aux"] = np.round(np.asarray(aux, np.float64), AUX_DECIMALS).tolist()
    rec["dropped"] = [int(x) for x in dropped]
    return rec


def call_stats(cfg: ModelConfig, stats: list) -> tuple[list, list]:
    """Each call's (aux, dropped pairs) summed over its MoE layers, from
    the entries :func:`repro_torch.models.layers.ffn.moe_stats` gathered
    over whole calls (prefill, decode steps)."""
    n = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    if not n or len(stats) % n:
        raise ValueError(f"{len(stats)} MoE entries do not make whole calls "
                         f"of {n} layers")
    calls = [stats[i:i + n] for i in range(0, len(stats), n)]
    return ([sum(float(x["aux"]) for x in c) for c in calls],
            [sum(int(x["dropped"]) for x in c) for c in calls])


def moe_mismatches(golden: dict, aux, dropped, tol: float = 1e-6
                   ) -> list[str]:
    """Where a run's auxiliary losses (within ``tol``) and drops (exact)
    depart from a :func:`moe_record`."""
    out = []
    got = [int(x) for x in dropped]
    if got != golden["dropped"]:
        out.append(f"dropped {got} != {golden['dropped']}")
    aux = np.asarray(aux, np.float64)
    want = np.asarray(golden["aux"])
    if aux.shape != want.shape or (np.abs(aux - want) > tol).any():
        out.append(f"aux {aux.tolist()} != {want.tolist()} (tol {tol})")
    return out


def dumps(rec: dict) -> str:
    return json.dumps(rec, separators=(",", ":")) + "\n"


def mismatches(golden: dict, prefill_logits, step_logits, tokens,
               tol: float) -> list[str]:
    """Where a run departs from the golden: tokens exactly, logits within
    ``tol`` (absolute and relative) plus half a unit of the rounding."""
    out = []
    got_t = np.asarray(tokens).tolist()
    if got_t != golden["tokens"]:
        out.append(f"tokens {got_t} != {golden['tokens']}")
    steps = np.stack([np.asarray(s, np.float32)[:, -1] for s in step_logits])
    half = 0.5 * 10.0 ** -golden["decimals"]
    for name, got in (("prefill_logits", prefill_logits),
                      ("step_logits", steps)):
        want = np.asarray(golden[name])
        got = np.asarray(got, np.float64)
        if got.shape != want.shape:
            out.append(f"{name}: shape {got.shape} != {want.shape}")
            continue
        err = np.abs(got - want) - (tol + tol * np.abs(want) + half)
        if (err > 0).any():
            out.append(f"{name}: max abs err {np.abs(got - want).max()!r} "
                       f"over tol {tol} at {np.argwhere(err > 0)[:4].tolist()}")
    return out
