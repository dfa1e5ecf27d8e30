"""Loss and train step with gradient-accumulation microbatching, the
reference's ``train/train_step.py`` in torch.

The step is a plain function on ``(state, batch)``; the state is
``{"params": nn.Module, "opt": dict}`` (:func:`init_train_state`).  The
gradients come from ``torch.autograd.grad`` of :func:`loss_fn`, in each
parameter's dtype; with ``grad_accum > 1`` they are summed in fp32 over
the microbatches and divided by their count, as the reference's scan.
"""

from __future__ import annotations

import torch

from ..models import registry
from ..models.common import ModelConfig
from .optimizer import OptConfig, adamw_update, init_opt_state


def cross_entropy(logits, labels, mask=None, z_loss: float = 0.0):
    """logits (B, S, V), taken in fp32; labels (B, S) int; mask (B, S)
    {0, 1}.  The log-sum-exp is fp32; ``z_loss`` adds z·lse² a token."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].to(torch.int64))[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: ModelConfig, params, batch):
    """batch: dict(tokens, labels[, mask, positions, embeds]) →
    (ce + aux, {"ce", "aux"}); z_loss is 1e-4, as the reference fixes it
    (``OptConfig.z_loss`` is unread there too)."""
    logits, aux = registry.forward(
        cfg, params, batch["tokens"], positions=batch.get("positions"),
        embeds=batch.get("embeds"))
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"),
                       z_loss=1e-4)
    return ce + aux, {"ce": ce, "aux": aux}


def microbatches(batch: dict, grad_accum: int) -> list[dict]:
    """The reference's interleaved split: each leaf (B, ...) reshaped to
    (B/A, A, ...) and A moved first, so microbatch i takes rows i, i + A,
    …; (3, B, S) M-RoPE positions split on axis 1."""
    a = grad_accum
    split = {}
    for key, x in batch.items():
        ax = 1 if (key == "positions" and x.ndim == 3
                   and x.shape[0] == 3) else 0
        if x.shape[ax] % a:
            raise ValueError(f"{key}: batch {x.shape[ax]} does not split "
                             f"into {a} microbatches")
        y = x.reshape(*x.shape[:ax], x.shape[ax] // a, a, *x.shape[ax + 1:])
        split[key] = y.movedim(ax + 1, 0)
    return [{k: y[i] for k, y in split.items()} for i in range(a)]


def value_and_grads(cfg: ModelConfig, params, batch: dict,
                    grad_accum: int = 1):
    """(loss, metrics {"ce", "aux"}, grads by parameter name) of one
    batch: ``torch.autograd.grad`` of :func:`loss_fn`, each gradient in
    its parameter's dtype; with ``grad_accum > 1`` the microbatches'
    gradients summed in fp32 and divided by their count, the loss their
    mean (the reference's scan; its metrics then carry ce = the loss and
    aux = 0)."""
    names, leaves = zip(*params.named_parameters())

    def one(b):
        loss, metrics = loss_fn(cfg, params, b)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(names, grads)))

    if grad_accum == 1:
        return one(batch)
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in zip(names, leaves)}
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for mb in microbatches(batch, grad_accum):
        loss, _, grads = one(mb)
        for n, g in grads.items():
            acc[n] = acc[n] + g.to(torch.float32)
        loss_sum = loss_sum + loss
        del grads
    grads = {n: g / grad_accum for n, g in acc.items()}
    loss = loss_sum / grad_accum
    return loss, {"ce": loss, "aux": torch.zeros_like(loss)}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    grad_accum: int = 1):
    """``train_step(state, batch) -> (state, metrics)``: the parameters
    are updated in place, ``state["opt"]`` replaced; the metrics (loss,
    ce, aux, grad_norm, lr) are 0-d fp32 tensors on the device, left
    unread so that a step does not wait on the card."""

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        loss, metrics, grads = value_and_grads(cfg, params, batch,
                                               grad_accum)
        opt2, opt_metrics = adamw_update(opt_cfg, params, grads, opt)
        del grads
        out = {"loss": loss, **metrics, **opt_metrics}
        return {"params": params, "opt": opt2}, out

    return train_step


def trainable(params: torch.nn.Module) -> torch.nn.Module:
    """Turn every parameter's ``requires_grad`` on (the models are built
    frozen, for serving)."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


def init_train_state(cfg: ModelConfig, opt_cfg: OptConfig, seed: int = 0,
                     device=None) -> dict:
    params = trainable(registry.init(cfg, seed, device))
    return {"params": params, "opt": init_opt_state(opt_cfg, params)}
