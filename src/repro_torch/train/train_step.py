"""Loss and train step with gradient-accumulation microbatching, the
reference's ``train/train_step.py`` in torch.

The step is a plain function on ``(state, batch)``; the state is
``{"params": nn.Module, "opt": dict}`` (:func:`init_train_state`).  The
gradients come from ``torch.autograd.grad`` of :func:`loss_fn`, in each
parameter's dtype; with ``grad_accum > 1`` they are summed in fp32 over
the microbatches and divided by their count, as the reference's scan.

With ``mesh=`` the state is sharded over a (data, model) mesh
(``sharding.state.ShardedTrain``) and a step is the global batch's
math with explicit collectives: the forward and backward on the rank's
rows in a layer-wise scope (``ShardedTrain.layerwise``: each layer
gathered just before it runs, each leaf's gradient left as this rank's
fp32 shard summed over the data ranks and the microbatches), the
global norm, the shards updated.  The masked mean's denominator is the
global microbatch's and each rank's loss holds its own tokens' share of
the numerator, so the summed gradients are the global loss's.
"""

from __future__ import annotations

import time

import torch

from ..models import registry
from ..models.common import ModelConfig
from ..models.layers import ffn
from .optimizer import OptConfig, adamw_update, init_opt_state


def cross_entropy(logits, labels, mask=None, z_loss: float = 0.0, dp=None):
    """logits (B, S, V), taken in fp32; labels (B, S) int; mask (B, S)
    {0, 1}.  The log-sum-exp is fp32; ``z_loss`` adds z·lse² a token.
    With ``dp`` (a ``sharding.state.Grid``) the rows are one rank's
    of a batch split over data ranks: the denominator is the global
    one, so the ranks' results sum to the global masked mean."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].to(torch.int64))[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    if dp is not None:
        mask = (torch.ones_like(nll) if mask is None
                else mask.to(torch.float32))
        return (nll * mask).sum() / torch.clamp(dp.sum(mask.sum()), min=1.0)
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: ModelConfig, params, batch, dp=None):
    """batch: dict(tokens, labels[, mask, positions, embeds]) →
    (ce + aux, {"ce", "aux"}); z_loss is 1e-4, as the reference fixes it
    (``OptConfig.z_loss`` is unread there too).  With ``dp`` ce is this
    rank's share (:func:`cross_entropy`) and aux the global one."""
    with ffn.data_parallel(dp):
        logits, aux = registry.forward(
            cfg, params, batch["tokens"], positions=batch.get("positions"),
            embeds=batch.get("embeds"))
        ce = cross_entropy(logits, batch["labels"], batch.get("mask"),
                           z_loss=1e-4, dp=dp)
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
                    grad_accum: int = 1, dp=None, layerwise: bool = False):
    """(loss, metrics {"ce", "aux"}, grads by parameter name) of one
    batch: ``torch.autograd.grad`` of :func:`loss_fn`, each gradient in
    its parameter's dtype; with ``grad_accum > 1`` the microbatches'
    gradients summed in fp32 and divided by their count, the loss their
    mean (the reference's scan; its metrics then carry ce = the loss and
    aux = 0).  With ``dp`` the batch is this rank's rows: the loss and
    ce returned are the global ones, the gradients this rank's share
    (their sum over the ranks is the global loss's).  ``layerwise``: in
    a mesh step's scope (``ShardedTrain.layerwise``) ``params`` are
    shards, the gradients go to the scope's fp32 shards as the backward
    makes them, and grads is None."""
    names, leaves = zip(*params.named_parameters())

    def one(b):
        loss, metrics = loss_fn(cfg, params, b, dp)
        grads = torch.autograd.grad(loss, leaves, allow_unused=layerwise)
        if layerwise:
            if any(g is not None for g in grads):
                raise AssertionError("a shard took a gradient outside "
                                     "models.common.gather_layer")
            grads = None
        else:
            grads = dict(zip(names, grads))
        metrics = {k: v.detach() for k, v in metrics.items()}
        if dp is not None:
            metrics["ce"] = dp.sum(metrics["ce"])
            loss = metrics["ce"] + metrics["aux"]
        return loss.detach(), metrics, grads

    if grad_accum == 1:
        return one(batch)
    acc = None if layerwise else {
        n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for n, p in zip(names, leaves)}
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for mb in microbatches(batch, grad_accum):
        loss, _, grads = one(mb)
        for n, g in (grads or {}).items():
            acc[n] = acc[n] + g.to(torch.float32)
        loss_sum = loss_sum + loss
        del grads
    grads = None if acc is None else {n: g / grad_accum
                                      for n, g in acc.items()}
    loss = loss_sum / grad_accum
    return loss, {"ce": loss, "aux": torch.zeros_like(loss)}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    grad_accum: int = 1, mesh=None, timed: bool = False):
    """``train_step(state, batch) -> (state, metrics)``: the parameters
    are updated in place, ``state["opt"]`` replaced; the metrics (loss,
    ce, aux, grad_norm, lr) are 0-d fp32 tensors on the device, left
    unread so that a step does not wait on the card.

    ``mesh``: a ``sharding.state.ShardedTrain`` whose state the step
    takes (:func:`sharded_train_step`); ``batch`` is then the global
    batch, of which the step takes the rank's rows."""
    if mesh is not None:
        return sharded_train_step(cfg, opt_cfg, mesh, grad_accum, timed)

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        loss, metrics, grads = value_and_grads(cfg, params, batch,
                                               grad_accum)
        opt2, opt_metrics = adamw_update(opt_cfg, params, grads, opt)
        del grads
        out = {"loss": loss, **metrics, **opt_metrics}
        return {"params": params, "opt": opt2}, out

    return train_step


def sharded_train_step(cfg: ModelConfig, opt_cfg: OptConfig, sharded,
                       grad_accum: int = 1, timed: bool = False):
    """The step on a mesh (see the module's docstring); ``timed`` adds
    ``phase_s``: the seconds of the forward and backward (their gathers
    and gradient reduces inside) and of the update (the norm and AdamW),
    each ended by a device synchronise, and ``collectives``, the seconds
    inside the grid's collectives over the whole step, each call between
    two synchronises."""
    comm = sharded.grid.comm

    def train_step(state, batch):
        params = state["params"]
        marks = [time.perf_counter()]

        def mark():
            if timed:
                dev = batch["tokens"].device
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                marks.append(time.perf_counter())

        if timed:
            comm.seconds = 0.0
        with sharded.layerwise(params, grad_accum) as layers:
            loss, metrics, _ = value_and_grads(
                cfg, params, sharded.grid.rows(batch), grad_accum,
                sharded.dp, layerwise=True)
            mark()
            opt2, opt_metrics = sharded_update(opt_cfg, sharded, state,
                                               layers)
        mark()
        out = {"loss": loss, **metrics, **opt_metrics}
        if timed:
            out["phase_s"] = {"forward_backward": marks[1] - marks[0],
                              "update": marks[2] - marks[1],
                              "collectives": comm.seconds}
            comm.seconds = None
        return {"params": params, "opt": opt2}, out

    return train_step


def sharded_update(opt_cfg: OptConfig, sharded, state: dict, layers):
    """The mesh step's update from a layer-wise scope's gradient shards
    (``LayerGather.finish``): AdamW on this rank's shards, in place,
    each shard freed once applied; returns (the optimizer state, its
    metrics)."""
    grads, gnorm = layers.finish()
    return adamw_update(opt_cfg, state["params"], grads, state["opt"],
                        gnorm=gnorm, blocks=sharded.blocks)


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
