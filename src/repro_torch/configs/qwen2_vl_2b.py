"""Qwen2-VL-2B [arXiv:2409.12191] — VLM backbone with M-RoPE.

The vision frontend is a stub: a caller supplies merged patch and token
embeddings (``prefill(embeds=...)``) and (3, B, S) t/h/w position ids,
which M-RoPE consumes.
"""

from ..models.common import ModelConfig
from .base import ArchSpec, FULL_ATTN_SHAPES, register

FULL = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, head_dim=128,
    mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, mrope_sections=(2, 3, 3),
    dtype="float32", attn_q_chunk=16, attn_kv_chunk=16, remat=False,
)

register(ArchSpec(
    arch_id="qwen2-vl-2b", full=FULL, smoke=SMOKE,
    shapes=FULL_ATTN_SHAPES, skipped_shapes=("long_500k",),
    notes="M-RoPE backbone, stub patch frontend; long_500k skipped",
))
