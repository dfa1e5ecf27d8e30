"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] — MLA (multi-head latent attention).

MLA ranks follow the HF config: q_lora_rank 768, kv_lora_rank 256,
qk_nope 64 + qk_rope 32 per head, v_head_dim 64; the decode cache stores
only (c_kv, k_rope) = 288 values/token (vs 2·40·96 for vanilla GQA).
"""

from ..models.common import ModelConfig
from .base import ArchSpec, FULL_ATTN_SHAPES, register

FULL = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448, head_dim=64,
    mla=True, q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="minicpm3-4b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    head_dim=16, mla=True, q_lora_rank=32, kv_lora_rank=16,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    dtype="float32", attn_q_chunk=16, attn_kv_chunk=16, remat=False,
)

register(ArchSpec(
    arch_id="minicpm3-4b", full=FULL, smoke=SMOKE,
    shapes=FULL_ATTN_SHAPES, skipped_shapes=("long_500k",),
    notes="MLA compressed KV cache; long_500k skipped (full attention)",
))
