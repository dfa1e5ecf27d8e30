"""Qwen2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed top-4 + 4 shared."""

from ..models.common import ModelConfig
from .base import ArchSpec, FULL_ATTN_SHAPES, register

FULL = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, head_dim=128,
    moe_experts=60, moe_topk=4, moe_shared=4, moe_period=1,
    rope_theta=1_000_000.0, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=48, vocab=256,
    moe_experts=6, moe_topk=2, moe_shared=2, moe_period=1,
    capacity_factor=2.0,
    dtype="float32", attn_q_chunk=16, attn_kv_chunk=16, remat=False,
)

register(ArchSpec(
    arch_id="qwen2-moe-a2.7b", full=FULL, smoke=SMOKE,
    shapes=FULL_ATTN_SHAPES, skipped_shapes=("long_500k",),
    notes="fine-grained 60-expert all-to-all — Q-StaR collective target; "
          "full attention ⇒ long_500k skipped",
))
