"""Architecture configurations of the port: whisper-base (encdec),
jamba-1.5-large-398b (hybrid), the dense family (codeqwen1.5-7b,
internlm2-1.8b, stablelm-3b), minicpm3-4b (MLA), the MoE family
(qwen2-moe-a2.7b, dbrx-132b), qwen2-vl-2b (vlm) and xlstm-1.3b (ssm)."""

from .base import (ARCH_MODULES, OPTIMIZED_OVERRIDES, SHAPES, ArchSpec,
                   ShapeSpec, get_arch, list_archs, optimized_config)

__all__ = ["ARCH_MODULES", "OPTIMIZED_OVERRIDES", "SHAPES", "ArchSpec",
           "ShapeSpec", "get_arch", "list_archs", "optimized_config"]
