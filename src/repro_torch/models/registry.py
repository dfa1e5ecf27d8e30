"""Model registry: family dispatch and parameter counting.

The ``dense`` (codeqwen1.5-7b, internlm2-1.8b, stablelm-3b), ``encdec``
(whisper) and ``hybrid`` (Jamba, without its MoE FFN) families are
ported; the moe, vlm and ssm families raise until ROADMAP item 11 brings
them.
"""

from __future__ import annotations

from types import ModuleType

from . import encdec, hybrid, lm
from .common import ModelConfig, param_count_tree

_FAMILY_MODULE: dict[str, ModuleType] = {"dense": lm, "encdec": encdec,
                                          "hybrid": hybrid}


def model_module(cfg: ModelConfig) -> ModuleType:
    mod = _FAMILY_MODULE.get(cfg.family)
    if mod is None:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP item 11)")
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


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count of a model built on the meta device."""
    return param_count_tree(init(cfg, device="meta"))
