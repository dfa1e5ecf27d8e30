"""Flash attention: the CUDA kernels (forward and backward) and their
plain twins."""

from .ops import FlashAttention, flash_attention
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["FlashAttention", "flash_attention", "flash_attention_bwd_ref",
           "flash_attention_ref"]
