"""The serve golden: one whisper smoke case drawn from numpy, and the
record of what serving it gives.

The reference and the port draw parameters from different generators,
so a case they can both run must come from neither: :func:`numpy_case`
draws the reference's parameter tree, the encoder frames and the prompts
from one numpy seed.  ``tests/goldens/serve_whisper_smoke.json`` holds
the reference's float32 logits (prefill and every decode step) and its
greedy tokens for that case; the port is held against it on the CPU and,
where there is no JAX, on the card.

The weights are drawn with a small embedding scale and a gain on the
attention weights: with the reference's own init the tied embedding
dominates the residual stream, so the model greedily repeats its input
token and token equality would prove little.
"""

from __future__ import annotations

import json

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
    return {"config": cfg.name, "enc_seq": cfg.enc_seq, "seed": SEED,
            "batch": BATCH, "prompt_len": PROMPT_LEN,
            "new_tokens": NEW_TOKENS, "decimals": DECIMALS,
            "tokens": np.asarray(tokens, np.int64).tolist(),
            "prefill_logits": _rounded(prefill_logits),
            "step_logits": _rounded(steps)}


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
