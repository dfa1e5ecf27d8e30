"""The port's flash attention on the CPU against the JAX package.

The op's plain twin (what the CPU path runs, and what the CUDA kernel is
held against on the card) is compared with the reference's oracle
``flash_attention_ref`` over causal and full attention, GQA, ragged key
lengths, single-row decode queries, causal Sq ≠ Skv and 1-D and 2-D
valid-key lengths; and with the reference's Pallas op (interpret mode)
wherever that op agrees with its oracle.  One test pins down the
reference fault the port does not carry over: the Pallas op's wrapper
pads K/V to a block multiple and the kernel then counts the zero keys.
Tolerances are the reference's own (``tests/test_kernels.py``): 2e-5 in
float32, 2e-2 in bfloat16.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as ref_ops  # noqa: E402
from repro.models.layers.attention import (  # noqa: E402
    flash_attention_ref as ref_attention)
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# name: (B, Sq, Skv, H, KV, D, causal, mask)
CASES = {
    "causal_square": (2, 64, 64, 4, 4, 32, True, None),
    "full_square": (2, 48, 48, 4, 4, 32, False, None),
    "gqa_causal": (2, 40, 40, 8, 2, 16, True, None),
    "ragged_skv_full": (2, 8, 200, 4, 2, 32, False, None),
    "decode_sq1": (3, 1, 77, 4, 4, 16, False, None),
    "causal_sq_lt_skv": (2, 24, 56, 4, 2, 16, True, None),
    "mask_1d": (2, 12, 40, 4, 4, 16, False, "1d"),
    "mask_2d_cache": (2, 6, 32, 4, 2, 16, False, "2d"),
    "causal_mask_2d": (2, 16, 48, 4, 4, 16, True, "2d"),
}


def _inputs(b, sq, skv, h, kv, d, mask, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    if mask == "1d":
        ml = rng.integers(1, skv + 1, (b,)).astype(np.int32)
    elif mask == "2d":
        # a cache filled to `index`, then Sq new rows: query t sees
        # index + t + 1 keys
        index = rng.integers(0, skv - sq + 1, (b,))
        ml = (index[:, None] + np.arange(sq)[None] + 1).astype(np.int32)
    else:
        ml = None
    return q, k, v, ml


def _port(x, dtype):
    return None if x is None else torch.as_tensor(x).to(
        getattr(torch, dtype) if x.dtype == np.float32 else torch.int32)


def _ref(x, dtype):
    return None if x is None else jnp.asarray(x).astype(
        jnp.dtype(dtype) if x.dtype == np.float32 else jnp.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_reference_oracle(case, dtype):
    b, sq, skv, h, kv, d, causal, mask = CASES[case]
    arrays = _inputs(b, sq, skv, h, kv, d, mask)
    want = ref_attention(*[_ref(a, dtype) for a in arrays[:3]],
                         causal=causal, q_chunk=16, kv_chunk=16,
                         bias_mask_len=_ref(arrays[3], dtype))
    got = flash_attention_ref(*[_port(a, dtype) for a in arrays[:3]],
                              causal=causal, q_chunk=16, kv_chunk=16,
                              bias_mask_len=_port(arrays[3], dtype))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("case", ["causal_square", "ragged_skv_full",
                                  "decode_sq1", "mask_2d_cache",
                                  "causal_sq_lt_skv"])
def test_op_on_cpu_is_the_twin_at_default_chunks(case):
    """The public op on CPU tensors runs the plain twin (no launch is
    counted) and matches the oracle at its default 512 chunks."""
    b, sq, skv, h, kv, d, causal, mask = CASES[case]
    arrays = _inputs(b, sq, skv, h, kv, d, mask, seed=1)
    want = ref_attention(*[_ref(a, "float32") for a in arrays[:3]],
                         causal=causal,
                         bias_mask_len=_ref(arrays[3], "float32"))
    before = dict(kernels.LAUNCHES)
    got = flash_attention(*[_port(a, "float32") for a in arrays[:3]],
                          causal=causal,
                          mask_len=_port(arrays[3], "float32"))
    assert kernels.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# (B, Sq, Skv, H, KV, D, causal, dtype): causal with Sq == Skv, or Skv a
# multiple of the 64-key block — where the Pallas op agrees with its oracle
PALLAS_CASES = {
    "causal_square": (2, 64, 64, 4, 4, 32, True, "float32"),
    "causal_ragged_square": (1, 100, 100, 4, 2, 32, True, "float32"),
    "full_block_multiple": (2, 40, 128, 4, 2, 32, False, "float32"),
    "gqa_causal_bf16": (1, 128, 128, 8, 2, 64, True, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_twin_matches_reference_pallas_op_where_it_is_sound(case):
    b, sq, skv, h, kv, d, causal, dtype = PALLAS_CASES[case]
    arrays = _inputs(b, sq, skv, h, kv, d, None, seed=2)
    want = ref_ops.flash_attention(*[_ref(a, dtype) for a in arrays[:3]],
                                   causal=causal, block_q=64, block_kv=64,
                                   interpret=True)
    got = flash_attention(*[_port(a, dtype) for a in arrays[:3]],
                          causal=causal)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_reference_pallas_op_counts_padded_keys_and_the_port_does_not():
    """Fault 1 of the reference (ROADMAP queue 3): at Skv = 200, full
    attention, the Pallas op's wrapper pads K/V to 256 keys and the kernel
    takes the padded length as its ``kv_len``, so 56 zero keys enter every
    softmax denominator.  The port computes the oracle's function."""
    arrays = _inputs(2, 4, 200, 4, 4, 32, None, seed=3)
    qkv = [_ref(a, "float32") for a in arrays[:3]]
    oracle = np.asarray(ref_attention(*qkv, causal=False))
    pallas = np.asarray(ref_ops.flash_attention(*qkv, causal=False,
                                                interpret=True))
    port = flash_attention(*[_port(a, "float32") for a in arrays[:3]],
                           causal=False).numpy()
    assert np.abs(pallas - oracle).max() > 1e-2
    np.testing.assert_allclose(port, oracle, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["kv_heads", "mask_shape", "devices",
                                 "dtypes"])
def test_op_rejects_inconsistent_inputs(bad):
    q, k, v, ml = (_port(a, "float32")
                   for a in _inputs(2, 4, 16, 4, 2, 16, "2d"))
    kw = dict(causal=False, mask_len=ml)
    if bad == "kv_heads":
        k, v = k[:, :, :1].expand(2, 16, 3, 16), v[:, :, :1].expand(
            2, 16, 3, 16)
    elif bad == "mask_shape":
        kw["mask_len"] = ml[:, :2]
    elif bad == "devices":
        kw["mask_len"] = ml.to("meta")
    else:
        v = v.double()
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v, **kw)
