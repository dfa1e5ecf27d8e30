"""Architecture configurations of the port (whisper-base and jamba-1.5-large-398b so far)."""

from .base import (ARCH_MODULES, SHAPES, ArchSpec, ShapeSpec, get_arch,
                   list_archs)

__all__ = ["ARCH_MODULES", "SHAPES", "ArchSpec", "ShapeSpec", "get_arch",
           "list_archs"]
