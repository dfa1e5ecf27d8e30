"""Whisper-base [arXiv:2212.04356] — encoder-decoder audio backbone.

The conv frontend is a stub: the encoder takes precomputed frame
embeddings (B, 1500, d).  Decode shapes exercise the text decoder with
self-KV caches + encoder output.
"""

from ..models.common import ModelConfig
from .base import ArchSpec, FULL_ATTN_SHAPES, register

FULL = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, enc_layers=6, enc_seq=1500,
    d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, enc_layers=2, enc_seq=32,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    tie_embeddings=True, dtype="float32",
    attn_q_chunk=16, attn_kv_chunk=16, remat=False,
)

register(ArchSpec(
    arch_id="whisper-base", full=FULL, smoke=SMOKE,
    shapes=FULL_ATTN_SHAPES, skipped_shapes=("long_500k",),
    notes="enc-dec (not encoder-only) ⇒ decode shapes run on the decoder; "
          "full attention ⇒ long_500k skipped; frontend stubbed",
))
