"""The train step: gradient accumulation, mixed precision, remat knobs
(port of ``repro.train.step``).

``make_train_step(model, optimizer, microbatches=m)`` returns
``train_step(params, opt_state, step, batch) -> (params, opt_state,
step + 1, metrics)``, the JAX package's signature.  ``params`` is
``dict(model.named_parameters())``: the model computes with those very
tensors, and the step updates them in place (``apply_updates``) instead of
returning new ones, so one copy of the weights stays resident.

Microbatch accumulation: the batch is split on dim 0 into ``m`` equal
microbatches; their gradients are summed in fp32 and divided by ``m``.
Every microbatch carries the same token count (the packed pipeline pads
nothing), so the mean of means is the full-batch mean.  Metrics are the
mean over microbatches, except ``tokens`` (summed) and ``ppl`` (exp of the
mean ce).

A parameter that the model names in ``gradient_free()`` (the routing
baseline's k-means centroids, which the loss sees only through top-k
indices) gets a zero gradient, as in JAX: the clip and AdamW see zeros and
leave it where it is.  Any other parameter that the loss does not reach
makes the step raise.

Mixed precision: ``mixed_precision(cfg)`` keeps fp32 parameters (the
master weights) and sets bf16 compute; gradients and the AdamW moments stay
fp32.  Remat lives on ``ModelConfig.remat`` (``with_remat``).

On a mesh (``shards``: a ``dist.parallel.TrainShards`` of the sharded
model) the step takes the same global batch and the at-rest shards as
``params``: it keeps this rank's rows (``MeshContext.dp_rows``: its part
of every microbatch), all-gathers the working weights, divides each
microbatch's loss by that microbatch's mask count summed over the
data-parallel ranks (one all-reduce for the whole step), sums the
gradients over dp into this rank's shards, takes the AdamW step on the
shards with the norm of the full gradients, and sums ``ce``, ``aux`` and
``loss`` over dp: the metrics are one device's.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.optimizer import apply_updates


def mixed_precision(model_cfg, compute: str = "bfloat16"):
    """bf16-compute / fp32-master variant of ``model_cfg``."""
    return dataclasses.replace(model_cfg, compute_dtype=compute,
                               param_dtype="float32")


def with_remat(model_cfg, policy: str):
    """Set the remat policy knob: ``none`` | ``full`` | ``dots_saveable`` |
    ``mosa`` (``repro_torch.nn.remat``)."""
    return dataclasses.replace(model_cfg, remat=policy)


def microbatch_split(batch: dict, microbatches: int) -> list:
    """(B, ...) tensors -> ``microbatches`` dicts of (B / m, ...) views."""
    for k, x in batch.items():
        if x.shape[0] % microbatches:
            raise ValueError(f"global batch {x.shape[0]} of {k!r} is not "
                             f"divisible by microbatches {microbatches}")
    return [{k: x.chunk(microbatches)[i] for k, x in batch.items()}
            for i in range(microbatches)]


def make_train_step(model, optimizer, *, microbatches: int = 1,
                    health: bool = False, shards=None):
    """Build the step (see the module docstring).  ``health=True`` runs the
    loss ``with_health``: the router-health stats ride the step's metrics,
    with no second forward.  ``shards``: the train state on a mesh."""

    free = model.gradient_free()

    def denominators(mbs):
        """Each microbatch's mask count over the data-parallel ranks."""
        counts = torch.stack([(mb["labels"] >= 0).float().sum()
                              for mb in mbs])
        return shards.ctx.all_reduce(counts, shards.ctx.dp_axes) \
            .clamp_min(1.0)

    def grads_of(params, batch):
        keys = list(params)
        g_acc, l_acc, m_acc = None, 0.0, {}
        mbs = microbatch_split(batch, microbatches)
        denoms = None if shards is None else denominators(mbs)
        for i, mb in enumerate(mbs):
            if denoms is None:
                loss, metrics = model.loss(mb, with_health=health)
            else:
                loss, metrics = model.loss(mb, with_health=health,
                                           denom=denoms[i])
            grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                        allow_unused=True)
            unreached = [k for k, g in zip(keys, grads)
                         if g is None and k not in free]
            if unreached:
                raise RuntimeError(f"the loss does not reach {unreached}")
            grads = [torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(keys, grads)]
            if microbatches == 1:
                return (dict(zip(keys, grads)), loss.detach(),
                        {k: v.detach() for k, v in metrics.items()})
            grads = [g.float() for g in grads]
            g_acc = grads if g_acc is None else [
                a.add_(g) for a, g in zip(g_acc, grads)]
            l_acc = l_acc + loss.detach()
            for k, v in metrics.items():
                m_acc[k] = m_acc.get(k, 0.0) + v.detach()
        inv = 1.0 / microbatches
        grads = {k: (g * inv).to(params[k].dtype) for k, g in zip(keys, g_acc)}
        metrics = {k: (v if k == "tokens" else v * inv)
                   for k, v in m_acc.items()}
        metrics["ppl"] = torch.exp(metrics["ce"])
        return grads, l_acc * inv, metrics

    def train_step(params, opt_state, step, batch):
        grads, loss, metrics = grads_of(params, batch)
        updates, opt_state, opt_m = optimizer.update(grads, opt_state,
                                                     params, step)
        apply_updates(params, updates)
        return params, opt_state, step + 1, {**metrics, **opt_m,
                                             "loss": loss}

    def mesh_step(params, opt_state, step, batch):
        ctx = shards.ctx
        shards.gather_weights(params)
        grads, loss, metrics = grads_of(
            shards.working, ctx.dp_rows(batch, microbatches))
        grads = shards.reduce_grads(grads)
        # the ranks' shares of the loss sum to one device's
        summed = ctx.all_reduce(torch.stack(
            [loss, metrics["ce"], metrics["aux"]]), ctx.dp_axes)
        loss = summed[0]
        metrics = {**metrics, "ce": summed[1], "aux": summed[2],
                   "ppl": torch.exp(summed[1])}
        updates, opt_state, opt_m = optimizer.update(grads, opt_state,
                                                     params, step)
        apply_updates(params, updates)
        return params, opt_state, step + 1, {**metrics, **opt_m,
                                             "loss": loss}

    return train_step if shards is None else mesh_step
