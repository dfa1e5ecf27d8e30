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

The card's split-KV path is held here through its plain version (the
per-range partials and their combine), and the op's choice of path is
pinned at every shape ``chip_smoke.py`` times and the two served models
run, so that a change of path shows in review.
"""

import math

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
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    Path, choose_path)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    combine_partials, split_partials)

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


def test_twin_takes_dv_other_than_dk():
    """MLA's shapes: the twin returns V's head dim, as the oracle does
    (the kernels on the card take the pairs of ``ops.HEAD_DIMS``)."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 4, 2, 96)).astype(np.float32)
    k = rng.standard_normal((1, 8, 2, 96)).astype(np.float32)
    v = rng.standard_normal((1, 8, 2, 64)).astype(np.float32)
    want = ref_attention(*[_ref(a, "float32") for a in (q, k, v)],
                         causal=True)
    got = flash_attention(*[_port(a, "float32") for a in (q, k, v)],
                          causal=True)
    assert got.shape == (1, 4, 2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# (Dk, Dv) → the built pair the card launches: itself where built, else
# the built pair of least Dk′ + Dv′ covering it
PADDED = {(24, 16): (32, 32), (40, 40): (48, 48), (72, 72): (80, 80),
          (8, 8): (16, 16), (96, 32): (96, 64), (64, 96): (96, 96),
          (128, 120): (128, 128), (96, 64): (96, 64), (80, 80): (80, 80)}


@pytest.mark.parametrize("dims", sorted(PADDED))
def test_padded_head_dims_compute_the_unpadded_function(dims):
    """The card's padding in plain torch: q and k zero-padded to Dk′, v
    to Dv′, through the twin at the true Dk^-0.5 and cut back to Dv,
    equal the unpadded twin (2e-5 in float32; rows masked and causal);
    the pair chosen is ``PADDED``'s."""
    from repro_torch.kernels.flash_attention.ops import (HEAD_DIMS,
                                                         pad_head_dims,
                                                         padded_dims)

    dk, dv = dims
    assert padded_dims(dk, dv) == PADDED[dims] and PADDED[dims] in HEAD_DIMS
    rng = np.random.default_rng(dk * 1000 + dv)
    q = torch.as_tensor(rng.standard_normal((2, 5, 4, dk)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((2, 9, 2, dk)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((2, 9, 2, dv)), dtype=torch.float32)
    ml = torch.tensor([[5, 6, 7, 8, 9], [3, 4, 5, 6, 7]], dtype=torch.int32)
    for causal, mask in ((True, None), (False, ml)):
        want = flash_attention_ref(q, k, v, causal=causal, bias_mask_len=mask)
        qp, kp, vp = pad_head_dims(q, k, v, PADDED[dims])
        assert (qp.shape[3], kp.shape[3], vp.shape[3]) == (
            PADDED[dims][0], PADDED[dims][0], PADDED[dims][1])
        assert torch.equal(qp[..., :dk], q) and not qp[..., dk:].any()
        got = flash_attention_ref(qp, kp, vp, causal=causal,
                                  bias_mask_len=mask, scale=dk ** -0.5)
        assert not got[..., dv:].any()
        np.testing.assert_allclose(got[..., :dv].numpy(), want.numpy(),
                                   rtol=2e-5, atol=2e-5)


def test_head_dims_past_the_widest_tile_raise():
    from repro_torch.kernels.flash_attention.ops import padded_dims

    for dims in ((264, 264), (128, 272), (512, 64)):
        with pytest.raises(ValueError, match="up to 256"):
            padded_dims(*dims)


@pytest.mark.parametrize("splits", [1, 3, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_partials_compose_to_the_twin_and_oracle(case, splits):
    """The card's split path in plain torch: ranges of ceil(Skv / splits)
    keys, partials per range, one combine; float32 at 2e-5."""
    b, sq, skv, h, kv, d, causal, mask = CASES[case]
    arrays = _inputs(b, sq, skv, h, kv, d, mask, seed=5)
    q, k, v, ml = [_port(a, "float32") for a in arrays]
    want = ref_attention(*[_ref(a, "float32") for a in arrays[:3]],
                         causal=causal,
                         bias_mask_len=_ref(arrays[3], "float32"))
    twin = flash_attention_ref(q, k, v, causal=causal, bias_mask_len=ml)
    m, l, acc = split_partials(q, k, v, causal=causal, mask_len=ml,
                               splits=splits, chunk=math.ceil(skv / splits))
    assert m.shape == l.shape == (splits, b, kv, sq * (h // kv))
    got = combine_partials(m, l, acc, h)
    assert got.shape == (b, sq, h, d)
    for other in (twin.numpy(), np.asarray(want)):
        np.testing.assert_allclose(got.numpy(), other, rtol=2e-5,
                                   atol=2e-5)


def test_split_partials_with_an_empty_range_and_an_empty_row():
    """Range 2 of 3 counts no key of batch row 0 (limits 0 and 9 < 10),
    and query 0 of batch row 0 counts none at all: its range partials are
    (−inf, 0, 0) and it comes out as zeros, as from the kernels; every
    other row is the twin's and the oracle's."""
    b, sq, skv, h, kv, d = 2, 2, 30, 4, 2, 16
    arrays = list(_inputs(b, sq, skv, h, kv, d, None, seed=6))
    arrays[3] = np.array([[0, 9], [25, 30]], np.int32)
    q, k, v, ml = [_port(a, "float32") for a in arrays]
    m, l, acc = split_partials(q, k, v, causal=False, mask_len=ml, splits=3,
                               chunk=10)
    g = h // kv
    assert bool(torch.isinf(m[1:, 0]).all())          # ranges 1, 2: nothing
    assert bool(torch.isinf(m[:, 0, :, :g]).all())    # query 0: nothing
    assert not bool(torch.isinf(m[0, 0, :, g:]).any())
    assert float(l[:, 0, :, :g].abs().max()) == 0.0
    got = combine_partials(m, l, acc, h)
    assert float(got[0, 0].abs().max()) == 0.0
    want = np.asarray(ref_attention(*[_ref(a, "float32") for a in arrays[:3]],
                                    causal=False,
                                    bias_mask_len=_ref(arrays[3], "float32")))
    twin = flash_attention_ref(q, k, v, causal=False, bias_mask_len=ml)
    for other in (twin.numpy(), want):
        np.testing.assert_allclose(got.numpy()[0, 1:], other[0, 1:],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got.numpy()[1], other[1], rtol=2e-5,
                                   atol=2e-5)


# (B, Sq, Skv, H, KV, D) → (path in bf16, path in fp32): every shape of
# chip_smoke.FLASH_SHAPES (whisper-base's encoder, cross- and cached
# self-attention; internlm2 and stablelm; Jamba's prefill and decode; the
# dense family's served prefill and decode, internlm2 also at 2 048-token
# prompts), which are the calls the served models make, and the edges of
# the split path (64 and 65 packed rows)
SPLIT = {"cross": Path("split", 4, 384), "self": Path("split", 1, 64),
         "jamba": Path("split", 4, 576)}
PATH_CASES = {
    "whisper encoder": ((4, 1500, 1500, 8, 8, 64), "tc", "simt"),
    "whisper cross prefill": ((4, 16, 1500, 8, 8, 64), SPLIT["cross"], None),
    "whisper cross decode": ((4, 1, 1500, 8, 8, 64), SPLIT["cross"], None),
    "whisper self prefill": ((4, 16, 48, 8, 8, 64), SPLIT["self"], None),
    "whisper self decode": ((4, 1, 48, 8, 8, 64), SPLIT["self"], None),
    "internlm2 gqa causal": ((1, 2048, 2048, 16, 8, 128), "tc", "simt"),
    "stablelm d80 causal": ((1, 1024, 1024, 32, 32, 80), "tc", "simt"),
    "jamba prefill": ((4, 2048, 2080, 64, 8, 128), "tc", "simt"),
    "jamba decode": ((4, 1, 2080, 64, 8, 128), SPLIT["jamba"], None),
    "internlm2 served prefill": ((4, 16, 48, 16, 8, 128), SPLIT["self"],
                                 None),
    "internlm2 served decode": ((4, 1, 48, 16, 8, 128), SPLIT["self"], None),
    "internlm2 long prefill": ((4, 2048, 2080, 16, 8, 128), "tc", "simt"),
    "internlm2 long decode": ((4, 1, 2080, 16, 8, 128), SPLIT["jamba"],
                              None),
    "stablelm served prefill": ((4, 16, 48, 32, 32, 80), SPLIT["self"], None),
    "stablelm served decode": ((4, 1, 48, 32, 32, 80), SPLIT["self"], None),
    "codeqwen served prefill": ((4, 16, 48, 32, 32, 128), SPLIT["self"],
                                None),
    "codeqwen served decode": ((4, 1, 48, 32, 32, 128), SPLIT["self"], None),
    # slice 14's: qwen2-moe (MHA 16, D 128), dbrx (GQA 48/8: 96 packed
    # rows at a 16-token prompt), minicpm3 (MHA 40, Dk 96, Dv 64: B·KV
    # 160 blocks fill the card, so its decode steps take one range)
    "qwen2-moe served prefill": ((4, 16, 48, 16, 16, 128), SPLIT["self"],
                                 None),
    "qwen2-moe served decode": ((4, 1, 48, 16, 16, 128), SPLIT["self"],
                                None),
    "dbrx served prefill": ((4, 16, 48, 48, 8, 128), "tc", "simt"),
    "dbrx served decode": ((4, 1, 48, 48, 8, 128), SPLIT["self"], None),
    "minicpm3 served prefill": ((4, 16, 48, 40, 40, 96), SPLIT["self"],
                                None),
    "minicpm3 served decode": ((4, 1, 48, 40, 40, 96), SPLIT["self"], None),
    "minicpm3 long prefill": ((4, 2048, 2080, 40, 40, 96), "tc", "simt"),
    "minicpm3 long decode": ((4, 1, 2080, 40, 40, 96),
                             Path("split", 1, 2112), None),
    # slice 15's: qwen2-vl (GQA 12/2, D 128: a 16-token prompt packs 96
    # rows, so the tensor-core kernel; the image-style prompt's 72
    # positions too) and its decode steps; the padded pairs chip_smoke
    # times launch at their built pair's path, which the shape decides
    "qwen2-vl served prefill": ((4, 16, 48, 12, 2, 128), "tc", "simt"),
    "qwen2-vl served decode": ((4, 1, 48, 12, 2, 128), SPLIT["self"], None),
    "qwen2-vl image prefill": ((4, 72, 88, 12, 2, 128), "tc", "simt"),
    "qwen2-vl image decode": ((4, 1, 88, 12, 2, 128), Path("split", 2, 64),
                              None),
    "padded decode": ((4, 1, 48, 8, 8, 40), SPLIT["self"], None),
    "padded causal": ((2, 256, 256, 8, 8, 40), "tc", "simt"),
    "64 packed rows": ((1, 8, 200, 64, 8, 128), Path("split", 4, 64), None),
    "65 packed rows": ((1, 13, 100, 5, 1, 64), "tc", "simt"),
}


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_path_choice_at_the_served_shapes(case):
    (b, sq, skv, h, kv, _), bf16, fp32 = PATH_CASES[case]
    fp32 = bf16 if fp32 is None else fp32
    for dtype, want in ((torch.bfloat16, bf16), (torch.float32, fp32)):
        got = choose_path(dtype, b, sq, h, kv, skv)
        if isinstance(want, str):
            want = Path(want, 1, 0)
        assert got == want, (dtype, got)
        if got.kind == "split":     # whole tiles, no range past the keys
            assert got.chunk % 64 == 0
            assert (got.splits - 1) * got.chunk < skv <= got.splits * got.chunk
