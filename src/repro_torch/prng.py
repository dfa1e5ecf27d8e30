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
* ``uniform``        — float32 ``(bits >> 9 | 0x3F800000) − 1``, over the
  flat count of its shape;
* ``bernoulli``      — ``uniform(key, shape) < p`` in float32;
* ``randint``        — 32-bit ``_randint``: two ``random_bits`` draws from
  ``split(key)``, combined as ``(hi mod span) · (2^32 mod span) + lo mod
  span``, all mod ``span`` in uint32.

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
           "bits_at", "uniform", "random_bits_torch", "uniform_torch",
           "bernoulli", "randint", "randint_from_bits", "chain_keys"]

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


def _bits(k, n: int):
    """``random_bits`` over (..., 2) int64 key words, numpy or torch:
    the (..., n) int64 words."""
    x0, x1 = _count_halves(n, k)
    y0, y1 = threefry2x32(k[..., 0:1], k[..., 1:2], x0, x1)
    cat = torch.cat if isinstance(k, torch.Tensor) else np.concatenate
    return cat([y0, y1], -1)[..., :n]


def random_bits(k, n: int) -> np.ndarray:
    """``jax.random.bits(k, (n,))`` (uint32) for (..., 2) keys."""
    return _bits(_u64(k), n).astype(np.uint32)


def bits_at(k, e, m: int):
    """``random_bits(k, m)[e]`` computed for entries ``e`` alone, one
    threefry2x32 block each, as the card's kernels hash them: with
    ``h = ceil(m / 2)``, block ``b`` hashes counts ``(b, b + h)``, except
    ``(h − 1, 0)`` at odd ``m`` (the iota padded with one zero); entry
    ``e < h`` is word 0 of block ``e``, entry ``e ≥ h`` word 1 of block
    ``e − h``.  ``k`` is a (..., 2) uint32 key and ``e`` an int array
    that broadcasts against its leading axes; returns int64 words."""
    k = _u64(k)
    e = np.asarray(e, np.int64)
    h = (m + 1) // 2
    b = np.where(e < h, e, e - h)
    x1 = np.where((m % 2 == 1) & (b == h - 1), 0, b + h)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], b, x1)
    return np.where(e < h, y0, y1)


def _bits_to_unit(bits):
    """float32 in [0, 1) from 32 random bits: mantissa | 1.0, minus 1."""
    if isinstance(bits, torch.Tensor):
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        return f - 1.0
    f = ((bits.astype(np.uint32) >> 9) | 0x3F800000).view(np.float32)
    return f - np.float32(1.0)


def _flat(shape) -> tuple[tuple, int]:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return shape, int(np.prod(shape, dtype=np.int64))


def uniform(k, shape) -> np.ndarray:
    """``jax.random.uniform(k, shape)`` (float32) for (..., 2) keys: the
    flat count of ``shape`` hashed as one vector, then reshaped."""
    shape, m = _flat(shape)
    u = _bits_to_unit(random_bits(k, m))
    return u.reshape(u.shape[:-1] + shape)


def random_bits_torch(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Bulk :func:`random_bits` on a device: ``keys`` is a (..., 2) int64
    tensor of uint32 words; returns the (..., n) int64 words there."""
    return _bits(keys, n)


def uniform_torch(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Bulk :func:`uniform` on a device: ``keys`` is a (..., 2) int64
    tensor of uint32 words; returns (..., n) float32 on its device."""
    return _bits_to_unit(_bits(keys, n))


def bernoulli(k, shape, p: float = 0.5) -> np.ndarray:
    """``jax.random.bernoulli(k, p, shape)`` for a Python float ``p``:
    ``uniform(k, shape) < p`` in float32."""
    return uniform(k, shape) < np.float32(p)


def randint_from_bits(hi, lo, minval: int, maxval: int):
    """The 32-bit ``_randint`` arithmetic on its two words (int64 arrays
    or tensors holding uint32): ``span = maxval − minval`` (1 where
    ``maxval ≤ minval``), ``mult = (2^16 mod span)^2 mod span``, and
    ``minval + ((hi mod span) · mult + lo mod span) mod span``, every
    step wrapped to 32 bits; returns int64."""
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (65536 % span) ** 2 % span
    off = (((hi % span) * mult) & MASK) + lo % span
    return minval + (off & MASK) % span


def randint(k, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32) for
    (..., 2) keys: ``split(k)`` gives the keys of the high and the low
    word of each entry."""
    shape, m = _flat(shape)
    ks = split(k, 2)
    hi = _bits(_u64(ks[..., 0, :]), m)
    lo = _bits(_u64(ks[..., 1, :]), m)
    out = randint_from_bits(hi, lo, int(minval), int(maxval))
    out = ((out + (1 << 31)) & MASK) - (1 << 31)         # int32 wrap
    return out.astype(np.int32).reshape(out.shape[:-1] + shape)


def chain_keys(keys: np.ndarray, cycles: int):
    """Advance per-lane keys through ``cycles`` simulator cycles.

    Each cycle consumes ``key, kg, kd, km, kv = split(key, 5)``: the
    5-way split hashes blocks ``j = 0..4`` with counts ``(j, 5 + j)``,
    giving words ``(a_j, b_j)``, and its rows are ``key' = (a0, a1)``,
    ``kg = (a2, a3)``, ``kd = (a4, b0)``, ``km = (b1, b2)``,
    ``kv = (b3, b4)``.  Only blocks 0 and 1 carry the chain, so they run
    sequentially on Python ints; blocks 2–4 (the generation, destination
    and metadata keys) then run vectorised over every (cycle, lane).

    Returns ``(new_keys (L, 2), kg, kd, km)``, the last three
    (cycles, L, 2), all uint32.
    """
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    lanes = keys.shape[0]
    chain, b01 = [], []
    cur = [(int(k0), int(k1)) for k0, k1 in keys]
    for _ in range(cycles):
        chain.append(cur)
        nxt = []
        for k0, k1 in cur:
            a0, w0 = threefry2x32(k0, k1, 0, 5)
            a1, w1 = threefry2x32(k0, k1, 1, 6)
            b01.append((w0, w1))
            nxt.append((a0, a1))
        cur = nxt
    chain = np.array(chain, np.int64).reshape(cycles, lanes, 2)
    b01 = np.array(b01, np.int64).reshape(cycles, lanes, 2)
    j = np.array([2, 3, 4], np.int64)
    a, b = threefry2x32(chain[..., 0:1], chain[..., 1:2], j, j + 5)
    kg = np.stack([a[..., 0], a[..., 1]], -1).astype(np.uint32)
    kd = np.stack([a[..., 2], b01[..., 0]], -1).astype(np.uint32)
    km = np.stack([b01[..., 1], b[..., 0]], -1).astype(np.uint32)
    return np.array(cur, np.uint32).reshape(lanes, 2), kg, kd, km
