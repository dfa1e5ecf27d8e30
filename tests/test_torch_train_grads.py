"""The port's loss and gradients on the CPU against the JAX package.

* One step's loss and gradients against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` at the smoke configs of internlm2 (dense),
  qwen2-moe (aux loss), qwen2-vl (M-RoPE), whisper-base (encoder–
  decoder, random frame embeddings), xlstm-1.3b (ssm) and
  jamba-1.5-large-398b (hybrid: the scan's backward twin against the
  reference's associative scan, its experts' aux loss): loss within
  1e-6 relative, the aux loss within 1e-5, each gradient within 5e-5 of
  its leaf's largest |value| (fp32 sums in another order; xLSTM's
  recurrences the widest, 1.3e-5).
* The port alone: remat (each block recomputed in the backward) gives
  the gradients bit for bit and counts each MoE call's stats once; two
  microbatches give the one-batch gradients within fp32 rounding.

The JAX package is called only inside ``test_torch_oracle.reference()``.
"""

import numpy as np
import pytest
import torch

from test_torch_oracle import reference, torch_one_thread  # noqa: F401
from test_torch_train import BATCH, SEQ, _hold_leaves, _port_batch, _ref_batch

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models.layers.ffn import moe_stats
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pts
from repro_torch.train.data import DataConfig, SyntheticLM

pytestmark = pytest.mark.usefixtures("torch_one_thread")

GRAD_TOL = 5e-5     # of a leaf's largest |gradient|
LOSS_RTOL = 1e-6


GRAD_ARCHS = ["internlm2-1.8b", "qwen2-moe-a2.7b", "qwen2-vl-2b",
              "whisper-base", "xlstm-1.3b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_match_value_and_grad(arch):
    cfg = get_arch(arch).smoke
    host = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=1)).get_batch(0)
    embeds = (np.random.default_rng(0).standard_normal(
        (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec" else None)
    with reference():
        import jax

        from repro.configs import get_arch as ref_arch
        from repro.models import registry as rreg
        from repro.train import train_step as rts

        rcfg = ref_arch(arch).smoke
        params = rreg.init(rcfg, jax.random.PRNGKey(0))
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p, b: rts.loss_fn(rcfg, p, b), has_aux=True))(
                params, _ref_batch(cfg, host, embeds))
        tree, gtree = jax.tree.map(np.asarray, (params, grads))
        want_loss, want_aux = float(loss), float(aux["aux"])
    model = pts.trainable(convert.params_from_numpy(tree, cfg, "cpu"))
    got, metrics = pts.loss_fn(cfg, model, _port_batch(cfg, host, embeds))
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(got, leaves)))
    np.testing.assert_allclose(float(got), want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["aux"]), want_aux, rtol=1e-5,
                               atol=1e-7)
    if cfg.is_moe:
        assert want_aux > 0
    _hold_leaves(grads, gtree, GRAD_TOL, arch)


def _grads(cfg, model, batch):
    loss, _ = pts.loss_fn(cfg, model, batch)
    names, leaves = zip(*model.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "whisper-base",
                                  "xlstm-1.3b", "jamba-1.5-large-398b"])
def test_remat_gives_the_same_gradients_and_stats(arch, monkeypatch):
    """``cfg.remat`` (each block checkpointed, recomputed in the
    backward) changes no bit of the loss or the gradients, and the MoE
    stats hold one entry a call, not two; a checkpoint is taken for each
    block with a gradient, and none without one (serving)."""
    import torch.utils.checkpoint as tuc

    real, calls = tuc.checkpoint, []
    monkeypatch.setattr(tuc, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = get_arch(arch).smoke
    host = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH)).get_batch(0)
    embeds = (np.random.default_rng(0).standard_normal(
        (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec" else None)
    out = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        model = pts.trainable(pts.registry.init(c, seed=0, device="cpu"))
        with moe_stats() as stats:
            out[remat] = (*_grads(c, model, _port_batch(c, host, embeds)),
                          len(stats))
        with torch.no_grad():
            pts.loss_fn(c, model, _port_batch(c, host, embeds))
    blocks = {"encdec": cfg.enc_layers + cfg.n_layers,
              "hybrid": cfg.n_layers // max(cfg.attn_period, 1),
              "ssm": cfg.n_layers // max(cfg.slstm_period, 1)}.get(
                  cfg.family, cfg.n_layers)
    assert len(calls) == blocks
    (l0, g0, n0), (l1, g1, n1) = out[False], out[True]
    assert torch.equal(l0, l1) and n0 == n1
    assert n0 == sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_two_microbatches_give_the_batch_gradients():
    """The loss is a mean over equal-sized microbatches, so their mean
    gradient is the batch's (within fp32 rounding: 1e-5 of a leaf's
    largest); read from m under b1 = 0, no clip."""
    cfg = get_arch("internlm2-1.8b").smoke
    kw = dict(b1=0.0, clip_norm=1e30)
    batch = _port_batch(cfg, SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)).get_batch(3))
    ms = []
    for accum in (1, 2):
        state = pts.init_train_state(cfg, popt.OptConfig(**kw), seed=0,
                                     device="cpu")
        state, _ = pts.make_train_step(cfg, popt.OptConfig(**kw),
                                       accum)(state, batch)
        ms.append(state["opt"]["m"])
    ref = {n: m.numpy() for n, m in ms[0].items()}
    for n, m in ms[1].items():
        top = np.abs(ref[n]).max()
        assert np.abs(m.numpy() - ref[n]).max() <= 1e-5 * top, n
