"""InternLM2-1.8B [arXiv:2403.17297] — dense GQA."""

from ..models.common import ModelConfig
from .base import ArchSpec, FULL_ATTN_SHAPES, register

FULL = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92544, head_dim=128, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="internlm2-1.8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, dtype="float32",
    attn_q_chunk=16, attn_kv_chunk=16, remat=False,
)

register(ArchSpec(
    arch_id="internlm2-1.8b", full=FULL, smoke=SMOKE,
    shapes=FULL_ATTN_SHAPES, skipped_shapes=("long_500k",),
    notes="pure full-attention arch: long_500k skipped",
))
