"""Jamba-1.5-Large 398B [arXiv:2403.19887] — hybrid Mamba+attention MoE.

1 attention layer per 8 (attn_period=8), MoE every other layer (16 experts,
top-2).  72 layers = 9 super-blocks.  Sub-quadratic (mamba-dominant)
⇒ runs the long_500k shape.  The port serves it with its experts
(``models.hybrid``: the 4 MoE FFNs of a super-block); one H100 holds one
super-block with 8 of the 16 experts in bf16 (51.8 GB), and with
``moe_experts=0`` every FFN is the dense SwiGLU.
"""

from ..models.common import ModelConfig
from .base import ArchSpec, SUBQUADRATIC_SHAPES, register

FULL = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, head_dim=128,
    moe_experts=16, moe_topk=2, moe_period=2,
    attn_period=8, mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    rope_theta=10_000.0, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    moe_experts=4, moe_topk=2, moe_period=2, attn_period=4,
    mamba_d_state=4, mamba_d_conv=4, mamba_expand=2, mamba_chunk=8,
    dtype="float32", attn_q_chunk=16, attn_kv_chunk=16, remat=False,
    capacity_factor=2.0,
)

register(ArchSpec(
    arch_id="jamba-1.5-large-398b", full=FULL, smoke=SMOKE,
    shapes=SUBQUADRATIC_SHAPES, skipped_shapes=(),
    notes="hybrid: attention KV only every 8th layer; long_500k runs",
))
