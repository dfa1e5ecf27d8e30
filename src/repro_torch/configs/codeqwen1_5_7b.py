"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B] — dense, full MHA KV."""

from ..models.common import ModelConfig
from .base import ArchSpec, FULL_ATTN_SHAPES, register

FULL = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416, head_dim=128, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="codeqwen1.5-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab=256, dtype="float32",
    attn_q_chunk=16, attn_kv_chunk=16, remat=False,
)

register(ArchSpec(
    arch_id="codeqwen1.5-7b", full=FULL, smoke=SMOKE,
    shapes=FULL_ATTN_SHAPES, skipped_shapes=("long_500k",),
    notes="pure full-attention arch: long_500k skipped",
))
