"""Architecture × input-shape registry.

Every architecture exposes:
  * ``full``  — the exact published configuration;
  * ``smoke`` — a reduced same-family configuration for CPU tests
    (small widths, tiny vocab).

All ten of the reference's architectures are ported: whisper-base,
jamba-1.5-large-398b, the dense family (codeqwen1.5-7b, internlm2-1.8b,
stablelm-3b), minicpm3-4b (MLA), the MoE family (qwen2-moe-a2.7b,
dbrx-132b), qwen2-vl-2b (vlm, M-RoPE) and xlstm-1.3b (ssm).

Shapes:
  train_4k     seq 4096,   global_batch 256   → train_step
  prefill_32k  seq 32768,  global_batch 32    → prefill (serve)
  decode_32k   KV 32768,   global_batch 128   → serve_step (1 new token)
  long_500k    KV 524288,  global_batch 1     → serve_step; SSM/hybrid only
"""

from __future__ import annotations

import dataclasses
import importlib

from ..models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    full: ModelConfig
    smoke: ModelConfig
    shapes: tuple[str, ...]          # applicable shape names
    skipped_shapes: tuple[str, ...]
    notes: str = ""


_REGISTRY: dict[str, ArchSpec] = {}
ARCH_MODULES = ["codeqwen1_5_7b", "dbrx_132b", "internlm2_1_8b",
                "jamba_1_5_large", "minicpm3_4b", "qwen2_moe_a2_7b",
                "qwen2_vl_2b", "stablelm_3b", "whisper_base", "xlstm_1_3b"]

FULL_ATTN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
SUBQUADRATIC_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def _load_all():
    for m in ARCH_MODULES:
        importlib.import_module(f"{__package__}.{m}")


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown architecture {arch_id!r} (have "
                       f"{list_archs()})")
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)
