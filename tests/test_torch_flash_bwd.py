"""The flash backward on the CPU against the JAX package.

The port's plain twin of the backward kernel,
``flash_attention_bwd_ref``, is held against ``jax.vjp`` of the
reference's custom-VJP flash attention (``_flash_attention`` of
``repro/models/layers/attention.py``), which is what the reference's
training takes: dq, dk and dv within atol/rtol 1e-5 in float32 (both
sides sum the same fp32 chunk products; the order of a few sums
differs).  The twin's lse is held against the reference oracle's
``return_lse`` at the same tolerance.  The public op, differentiated on
the CPU, must give the twins' numbers exactly (it runs them), and the
choice of kernel when a gradient is wanted is pinned.  The JAX package
is called only inside ``test_torch_oracle.reference()``.
"""

import numpy as np
import pytest
import torch

from test_torch_oracle import reference, torch_one_thread  # noqa: F401

from repro_torch import kernels
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.kernel import (
    BWD_PATH_LAUNCHES, bwd_route, bwd_tc_splits, flash_attention_bwd_cuda)
from repro_torch.kernels.flash_attention.ops import (
    HEAD_DIMS, MAX_HEAD_DIM, Path, choose_path, padded_dims)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

TOL = 1e-5
# name: (B, Sq, Skv, H, KV, Dk, Dv, causal, chunk)
CASES = {
    "causal_square": (2, 32, 32, 4, 4, 16, 16, True, 16),
    "full_square": (2, 24, 24, 4, 4, 16, 16, False, 8),
    "gqa_causal": (1, 32, 32, 8, 2, 16, 16, True, 16),
    "causal_sq_lt_skv": (2, 16, 40, 4, 2, 16, 16, True, 16),
    "cross_sq_ne_skv": (2, 8, 50, 4, 4, 32, 32, False, 16),
    "dk96_dv64": (1, 20, 20, 4, 2, 96, 64, True, 8),
    "ragged_chunk": (2, 21, 21, 4, 2, 16, 16, True, 8),
}


def _arrays(b, sq, skv, h, kv, dk, dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, dk)).astype(np.float32),
            rng.standard_normal((b, skv, kv, dk)).astype(np.float32),
            rng.standard_normal((b, skv, kv, dv)).astype(np.float32),
            rng.standard_normal((b, sq, h, dv)).astype(np.float32))


def _reference_vjp(q, k, v, dout, causal, chunk):
    """(out, lse, dq, dk, dv) of the reference, as numpy."""
    with reference():
        import jax
        import jax.numpy as jnp
        from repro.models.layers.attention import (_flash_attention,
                                                   flash_attention_ref
                                                   as ref_attention)

        qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
        out, vjp = jax.vjp(
            lambda a, b_, c: _flash_attention(a, b_, c, causal, chunk,
                                              chunk), qj, kj, vj)
        grads = vjp(jnp.asarray(dout))
        _, lse = ref_attention(qj, kj, vj, causal=causal, q_chunk=chunk,
                               kv_chunk=chunk, return_lse=True)
        return (np.asarray(out), np.asarray(lse),
                *(np.asarray(g) for g in grads))


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_twin_matches_the_reference_vjp(case):
    b, sq, skv, h, kv, dk, dv, causal, chunk = CASES[case]
    q, k, v, dout = _arrays(b, sq, skv, h, kv, dk, dv, seed=len(case))
    want_o, want_lse, *want = _reference_vjp(q, k, v, dout, causal, chunk)
    qt, kt, vt, dt = (torch.as_tensor(x) for x in (q, k, v, dout))
    out, lse = flash_attention_ref(qt, kt, vt, causal=causal, q_chunk=chunk,
                                   kv_chunk=chunk, return_lse=True)
    assert lse.shape == (b, sq, kv, h // kv) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want_o, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=TOL, atol=TOL)
    got = flash_attention_bwd_ref(qt, kt, vt, out, lse, dt, causal=causal,
                                  q_chunk=chunk, kv_chunk=chunk)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == x.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=f"{case} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["gqa_causal", "cross_sq_ne_skv",
                                  "dk96_dv64", "ragged_chunk"])
def test_op_autograd_on_cpu_is_the_twins(case, dtype):
    """``flash_attention`` differentiated on CPU tensors: the forward is
    the twin's output and the gradients are ``flash_attention_bwd_ref``'s
    on the twin's lse, bit for bit; no kernel launch is counted."""
    b, sq, skv, h, kv, dk, dv, causal, chunk = CASES[case]
    tdt = getattr(torch, dtype)
    arrays = _arrays(b, sq, skv, h, kv, dk, dv, seed=3)
    q, k, v, dout = (torch.as_tensor(x).to(tdt) for x in arrays)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(kernels.LAUNCHES)
    out = flash_attention(*leaves, causal=causal, q_chunk=chunk,
                          kv_chunk=chunk)
    out.backward(dout)
    assert kernels.LAUNCHES == before
    want_o, lse = flash_attention_ref(q, k, v, causal=causal, q_chunk=chunk,
                                      kv_chunk=chunk, return_lse=True)
    assert torch.equal(out.detach(), want_o)
    want = flash_attention_bwd_ref(q, k, v, want_o, lse, dout, causal=causal,
                                   q_chunk=chunk, kv_chunk=chunk)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == tdt
        assert torch.equal(leaf.grad, w)


def test_op_takes_the_plain_path_when_no_gradient_is_wanted():
    """No grad mode, or no input that requires grad: the twin's forward,
    with no graph; a masked call with grad differentiates through the
    twin's own ops (as the reference's masked path does)."""
    q, k, v, _ = (torch.as_tensor(x) for x in _arrays(1, 8, 8, 2, 2, 16, 16,
                                                      seed=5))
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert flash_attention(qg, k, v, causal=True).grad_fn is None
    with torch.inference_mode():
        assert flash_attention(q, k, v, causal=True).grad_fn is None
    assert flash_attention(q, k, v, causal=True).grad_fn is None
    fn = flash_attention(qg, k, v, causal=True).grad_fn
    assert type(fn).__name__ == FlashAttention.__name__ + "Backward"
    ml = torch.full((1,), 5, dtype=torch.int32)
    masked = flash_attention(qg, k, v, causal=False, mask_len=ml)
    masked.sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()


def test_path_with_a_gradient_and_above_128():
    """With a gradient the forward must write the lse: tc for bf16, simt
    for fp32, whatever the row count (a decode-sized call too); a head
    dim above 128 takes simt in either dtype and either mode."""
    bf16, f32 = torch.bfloat16, torch.float32
    train = (8, 128, 16, 8, 128)          # internlm2's training shape
    assert choose_path(bf16, *train[:4], 128, dims=(128, 128),
                       grad=True) == Path("tc", 1, 0)
    assert choose_path(f32, *train[:4], 128, dims=(128, 128),
                       grad=True) == Path("simt", 1, 0)
    assert choose_path(bf16, 4, 1, 16, 8, 48, dims=(128, 128),
                       grad=True) == Path("tc", 1, 0)
    assert choose_path(bf16, 4, 1, 16, 8, 48,
                       dims=(128, 128)).kind == "split"
    for dims in ((192, 192), (256, 256)):
        for grad in (False, True):
            for dt, sq in ((bf16, 1), (bf16, 512), (f32, 64)):
                assert choose_path(dt, 2, sq, 4, 2, 512, dims=dims,
                                   grad=grad) == Path("simt", 1, 0)


@pytest.mark.parametrize("dims,want", [
    ((136, 136), (192, 192)), ((129, 100), (192, 192)),
    ((192, 192), (192, 192)), ((200, 64), (256, 256)),
    ((255, 255), (256, 256)), ((256, 256), (256, 256))])
def test_wide_head_dims_pad_to_192_or_256(dims, want):
    assert MAX_HEAD_DIM == 256
    assert padded_dims(*dims) == want and want in HEAD_DIMS


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dims", HEAD_DIMS, ids=lambda p: f"{p[0]}_{p[1]}")
def test_backward_route_at_every_built_pair(dims, dtype):
    """bf16 up to 128 takes the tensor-core backward, fp32 and the wide
    pairs the CUDA-core one."""
    dt = getattr(torch, dtype)
    want = "tc" if dt == torch.bfloat16 and max(dims) <= 128 else "simt"
    assert bwd_route(dt, *dims) == want


# name: (dtype, (Dk, Dv), route, the error it raises); every call on CPU
# tensors, which the last case's route would otherwise take
REFUSED = {
    "float16": ("float16", (64, 64), None, TypeError),
    "unbuilt_pair": ("bfloat16", (100, 100), None, ValueError),
    "dv_above_a_built_pair": ("bfloat16", (128, 64), None, ValueError),
    "tc_in_fp32": ("float32", (64, 64), "tc", ValueError),
    "tc_above_128": ("bfloat16", (192, 192), "tc", ValueError),
    "no_such_route": ("bfloat16", (64, 64), "wgmma", ValueError),
    "cpu_tensors": ("bfloat16", (64, 64), "tc", ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_backward_wrapper_refuses_what_no_route_takes(case):
    """The backward's binding raises, before any launch, on a dtype, a
    head-dim pair or a route that no kernel takes, and on tensors off the
    card; no launch is counted."""
    dtype, (dk, dv), route, err = REFUSED[case]
    dt = getattr(torch, dtype)
    q, k, v, dout = (torch.as_tensor(x).to(dt) for x in _arrays(
        1, 8, 8, 2, 2, dk, dv, seed=9))
    o = torch.zeros_like(dout)
    lse = torch.zeros((1, 8, 2, 1), dtype=torch.float32)
    before = dict(BWD_PATH_LAUNCHES), dict(kernels.LAUNCHES)
    with pytest.raises(err):
        flash_attention_bwd_cuda(q, k, v, o, lse, dout, True,
                                 dk ** -0.5, route=route)
    assert (dict(BWD_PATH_LAUNCHES), dict(kernels.LAUNCHES)) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_autograd_takes_no_backward_route(dtype):
    """Differentiated on CPU tensors, the op runs the twins: neither
    backward route counts a call."""
    b, sq, skv, h, kv, dk, dv, causal, chunk = CASES["gqa_causal"]
    q, k, v, dout = (torch.as_tensor(x).to(getattr(torch, dtype))
                     for x in _arrays(b, sq, skv, h, kv, dk, dv, seed=4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(BWD_PATH_LAUNCHES)
    flash_attention(*leaves, causal=causal, q_chunk=chunk,
                    kv_chunk=chunk).backward(dout)
    assert BWD_PATH_LAUNCHES == before
    assert all(x.grad is not None for x in leaves)


@pytest.mark.parametrize("shape,want", [
    ((128, 16, 8), 1),      # internlm2's training call: a short walk
    ((1024, 64, 8), 2),     # Jamba's: 16 query tiles x 8 heads
    ((2048, 16, 8), 2),     # a 2 048-token sequence, GQA 16/8
    ((128, 8, 8), 1),       # whisper's MHA: G 1
    ((77, 16, 2), 2),       # 2 tiles x 8 heads
    ((2048, 12, 4), 1)])    # G 3: odd
def test_tc_backward_splits_the_heads_of_long_walks(shape, want):
    assert bwd_tc_splits(*shape) == want
