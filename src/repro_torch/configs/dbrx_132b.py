"""DBRX-132B [hf:databricks/dbrx-base] — fine-grained MoE, 16 experts top-4."""

from ..models.common import ModelConfig
from .base import ArchSpec, FULL_ATTN_SHAPES, register

FULL = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, head_dim=128,
    moe_experts=16, moe_topk=4, moe_period=1,
    rope_theta=500_000.0, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="dbrx-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=256,
    moe_experts=4, moe_topk=2, moe_period=1, capacity_factor=2.0,
    dtype="float32", attn_q_chunk=16, attn_kv_chunk=16, remat=False,
)

register(ArchSpec(
    arch_id="dbrx-132b", full=FULL, smoke=SMOKE,
    shapes=FULL_ATTN_SHAPES, skipped_shapes=("long_500k",),
    notes="expert-parallel all-to-all — primary Q-StaR collective target; "
          "full attention ⇒ long_500k skipped",
))
