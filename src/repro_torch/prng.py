"""Counter-based random bits: JAX's threefry2x32, reproduced bit for bit.

The simulator's random stream is part of its results (the golden
fixtures pin flit counts that are functions of it), so the port
reproduces ``jax.random``'s raw-key threefry2x32 with the
**non-partitionable** semantics (``jax_threefry_partitionable=False``,
under which the reference fixtures were made):

* ``key(seed)``      — ``PRNGKey``: ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``fold_in``        — ``threefry_2x32(key, threefry_seed(data))``;
* ``split``          — ``threefry_2x32(key, iota(2·num))`` reshaped to
  ``(num, 2)`` (``_threefry_split_original``);
* ``random_bits``    — ``threefry_2x32(key, iota(n))``, with the odd-length
  count padded by one zero (``_threefry_random_bits_original``);
* ``uniform``        — float32 ``(bits >> 9 | 0x3F800000) − 1``.

``threefry_2x32(key, count)`` hashes the count array in two halves: block
``j`` takes ``(count[j], count[h + j])`` with ``h = ceil(len / 2)`` and its
two output words land at positions ``j`` and ``h + j``.

:func:`threefry2x32` is written once over any integer type that holds
values in ``[0, 2**32)``: Python ints (the sequential key chain, fastest
for a handful of lanes), numpy arrays, and torch int64 tensors on either
device (the bulk draws — torch has no uint32 add or shift on the CPU, so
the words ride in int64 and every step is masked to 32 bits).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry2x32", "key", "fold_in", "split", "random_bits",
           "uniform", "uniform_torch", "chain_keys"]

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as JAX lowers
    it.  Arguments broadcast; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _u64(a) -> np.ndarray:
    return np.asarray(a, np.uint32).astype(np.int64)


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a (2,) uint32 array."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return np.array([(seed >> 32) & MASK, seed & MASK], np.uint32)


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)`` for a (..., 2) key array."""
    k = _u64(k)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], 0, int(data) & MASK)
    return np.stack([y0, y1], -1).astype(np.uint32)


def split(k, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: (..., 2) keys → (..., num, 2)."""
    k = _u64(k)
    j = np.arange(num, dtype=np.int64)
    y0, y1 = threefry2x32(k[..., 0:1], k[..., 1:2], j, j + num)
    out = np.concatenate([y0, y1], -1)              # (..., 2·num)
    return out.reshape(out.shape[:-1] + (num, 2)).astype(np.uint32)


def _count_halves(n: int, like):
    """The two count halves of ``iota(n)`` (zero-padded to even)."""
    h = (n + 1) // 2
    if isinstance(like, torch.Tensor):
        x0 = torch.arange(h, dtype=torch.int64, device=like.device)
    else:
        x0 = np.arange(h, dtype=np.int64)
    x1 = x0 + h
    if n % 2:
        x1[-1] = 0
    return x0, x1


def random_bits(k, n: int) -> np.ndarray:
    """``jax.random.bits(k, (n,))`` (uint32) for (..., 2) keys."""
    k = _u64(k)
    x0, x1 = _count_halves(n, k)
    y0, y1 = threefry2x32(k[..., 0:1], k[..., 1:2], x0, x1)
    return np.concatenate([y0, y1], -1)[..., :n].astype(np.uint32)


def _bits_to_unit(bits):
    """float32 in [0, 1) from 32 random bits: mantissa | 1.0, minus 1."""
    if isinstance(bits, torch.Tensor):
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        return f - 1.0
    f = ((bits.astype(np.uint32) >> 9) | 0x3F800000).view(np.float32)
    return f - np.float32(1.0)


def uniform(k, n: int) -> np.ndarray:
    """``jax.random.uniform(k, (n,))`` (float32) for (..., 2) keys."""
    return _bits_to_unit(random_bits(k, n))


def uniform_torch(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Bulk :func:`uniform` on a device: ``keys`` is a (..., 2) int64
    tensor of uint32 words; returns (..., n) float32 on its device."""
    x0, x1 = _count_halves(n, keys)
    y0, y1 = threefry2x32(keys[..., 0:1], keys[..., 1:2], x0, x1)
    return _bits_to_unit(torch.cat([y0, y1], -1)[..., :n])


def chain_keys(keys: np.ndarray, cycles: int):
    """Advance per-lane keys through ``cycles`` simulator cycles.

    Each cycle consumes ``key, kg, kd, km, kv = split(key, 5)``: the
    5-way split hashes blocks ``j = 0..4`` with counts ``(j, 5 + j)``,
    giving words ``(a_j, b_j)``, and its rows are ``key' = (a0, a1)``,
    ``kg = (a2, a3)``, ``kd = (a4, b0)``, ``km = (b1, b2)``,
    ``kv = (b3, b4)``.  Only blocks 0 and 1 carry the chain, so they run
    sequentially on Python ints; blocks 2–4 (the generation and
    destination keys) then run vectorised over every (cycle, lane).

    Returns ``(new_keys (L, 2), kg (cycles, L, 2), kd (cycles, L, 2))``,
    all uint32.
    """
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    lanes = keys.shape[0]
    chain, b0 = [], []
    cur = [(int(k0), int(k1)) for k0, k1 in keys]
    for _ in range(cycles):
        chain.append(cur)
        nxt = []
        for k0, k1 in cur:
            a0, w = threefry2x32(k0, k1, 0, 5)
            a1, _ = threefry2x32(k0, k1, 1, 6)
            b0.append(w)
            nxt.append((a0, a1))
        cur = nxt
    chain = np.array(chain, np.int64).reshape(cycles, lanes, 2)
    b0 = np.array(b0, np.int64).reshape(cycles, lanes)
    j = np.array([2, 3, 4], np.int64)
    a, _ = threefry2x32(chain[..., 0:1], chain[..., 1:2], j, j + 5)
    kg = np.stack([a[..., 0], a[..., 1]], -1).astype(np.uint32)
    kd = np.stack([a[..., 2], b0], -1).astype(np.uint32)
    return np.array(cur, np.uint32).reshape(lanes, 2), kg, kd
