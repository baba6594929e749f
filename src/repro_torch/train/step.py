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

Mixed precision: ``mixed_precision(cfg)`` keeps fp32 parameters (the
master weights) and sets bf16 compute; gradients and the AdamW moments stay
fp32.  Remat lives on ``ModelConfig.remat`` (``with_remat``).
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
    """Set the remat policy knob (``none`` | ``full`` are ported)."""
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
                    health: bool = False):
    """Build the step (see the module docstring).  ``health=True`` runs the
    loss ``with_health``: the router-health stats ride the step's metrics,
    with no second forward."""

    def grads_of(params, batch):
        keys = list(params)
        g_acc, l_acc, m_acc = None, 0.0, {}
        for mb in microbatch_split(batch, microbatches):
            loss, metrics = model.loss(mb, with_health=health)
            grads = torch.autograd.grad(loss, [params[k] for k in keys])
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

    return train_step
