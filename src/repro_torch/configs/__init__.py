"""Architecture configurations of the port: whisper-base,
jamba-1.5-large-398b, the dense family (codeqwen1.5-7b, internlm2-1.8b,
stablelm-3b), minicpm3-4b and the MoE family (qwen2-moe-a2.7b,
dbrx-132b)."""

from .base import (ARCH_MODULES, SHAPES, ArchSpec, ShapeSpec, get_arch,
                   list_archs)

__all__ = ["ARCH_MODULES", "SHAPES", "ArchSpec", "ShapeSpec", "get_arch",
           "list_archs"]
