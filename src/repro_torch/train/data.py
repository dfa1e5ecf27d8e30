"""Deterministic synthetic LM data pipeline, the reference's
``train/data.py`` in numpy: batches are bit-identical to the
reference's for every (seed, step, shard).

Stateless and hash-addressed: batch contents are a pure function of
(seed, step, position), so every host generates exactly its own shard
with no coordination, and restoring from a checkpoint resumes the stream
from the step counter alone — no separate data state to checkpoint.

Tokens follow a Zipf-like marginal with a learnable-structure component:
token t+1 correlates with token t through a hash mixer, so a model
reduces its loss on it.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.1


def _mix(x: np.ndarray) -> np.ndarray:
    """64-bit splitmix-style hash (vectorized, modular arithmetic)."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


class SyntheticLM:
    """get_batch(step[, shard, num_shards]) → dict(tokens, labels, mask),
    numpy arrays (int32, int32, float32)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf CDF over the vocab for marginal realism
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        w = ranks ** -cfg.zipf_a
        self.cdf = np.cumsum(w) / w.sum()

    def _tokens(self, step: int, rows: np.ndarray) -> np.ndarray:
        c = self.cfg
        s = np.arange(c.seq_len + 1, dtype=np.uint64)[None, :]
        r = rows.astype(np.uint64)[:, None]
        with np.errstate(over="ignore"):  # modular uint64 hashing
            base = _mix(np.uint64(c.seed) * np.uint64(0x9E3779B97F4A7C15)
                        + np.uint64(step + 1) * np.uint64(0xD1B54A32D192ED03)
                        + r * np.uint64(0x8CB92BA72F3D8DD7) + s)
            # structure: token depends on its predecessor's hash too
            prev = _mix(base >> np.uint64(17))
            u = ((base ^ np.roll(prev, 1, axis=1))
                 >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        toks = np.searchsorted(self.cdf, u).astype(np.int32)
        return np.clip(toks, 0, c.vocab - 1)

    def get_batch(self, step: int, shard: int = 0, num_shards: int = 1):
        c = self.cfg
        if c.global_batch % num_shards:
            raise ValueError(f"global batch {c.global_batch} does not split "
                             f"into {num_shards} shards")
        per = c.global_batch // num_shards
        rows = np.arange(shard * per, (shard + 1) * per)
        toks = self._tokens(step, rows)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((per, c.seq_len), np.float32),
        }
