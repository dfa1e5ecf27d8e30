"""xLSTM-1.3B [arXiv:2405.04517] — sLSTM + mLSTM blocks (xLSTM[7:1]).

d_ff = 0: mLSTM blocks carry their own 2× up/down projection.  The
recurrent state is O(1) in sequence length, so long_500k runs.
"""

from ..models.common import ModelConfig
from .base import ArchSpec, SUBQUADRATIC_SHAPES, register

FULL = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=512,
    slstm_period=8, xlstm_proj_factor=2.0,
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab=256,
    head_dim=16, slstm_period=4, xlstm_chunk=8,
    dtype="float32", remat=False,
)

register(ArchSpec(
    arch_id="xlstm-1.3b", full=FULL, smoke=SMOKE,
    shapes=SUBQUADRATIC_SHAPES, skipped_shapes=(),
    notes="recurrent-state decode (no KV cache); long_500k runs",
))
