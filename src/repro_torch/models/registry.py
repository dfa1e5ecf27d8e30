"""Model registry: family dispatch and parameter counting.

Every family of the reference: ``dense`` (codeqwen1.5-7b,
internlm2-1.8b, stablelm-3b; minicpm3-4b with MLA), ``moe``
(qwen2-moe-a2.7b, dbrx-132b) and ``vlm`` (qwen2-vl-2b, M-RoPE) on the
decoder LM, ``encdec`` (whisper), ``hybrid`` (Jamba, its MoE FFNs
included) and ``ssm`` (xLSTM).
"""

from __future__ import annotations

from types import ModuleType

from . import encdec, hybrid, lm, xlstm_model
from .common import ModelConfig, param_count_tree

_FAMILY_MODULE: dict[str, ModuleType] = {
    "dense": lm, "moe": lm, "vlm": lm, "encdec": encdec, "hybrid": hybrid,
    "ssm": xlstm_model}


def model_module(cfg: ModelConfig) -> ModuleType:
    mod = _FAMILY_MODULE.get(cfg.family)
    if mod is None:
        raise ValueError(f"unknown model family {cfg.family!r} (have "
                         f"{sorted(_FAMILY_MODULE)})")
    return mod


def init(cfg: ModelConfig, seed: int = 0, device=None):
    return model_module(cfg).init(cfg, seed, device)


def forward(cfg: ModelConfig, params, tokens, positions=None, embeds=None):
    return model_module(cfg).forward(cfg, params, tokens,
                                     positions=positions, embeds=embeds)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    return model_module(cfg).init_cache(cfg, batch, max_len, dtype=dtype,
                                        device=device)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count of a model built on the meta device;
    ``active_only`` counts the top-k routed and the shared experts only
    (the reference's MoE MODEL_FLOPS count: the padded dummy experts
    stay counted, as there)."""
    total = param_count_tree(init(cfg, device="meta"))
    if not active_only or not cfg.is_moe:
        return total
    d, f, e, k = cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.moe_topk
    n_moe_layers = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    return total - n_moe_layers * (e - k) * 3 * d * f
