"""Optimizers over a dict of tensors (port of ``repro.optim.optimizer``).

``adamw(...)`` returns an ``Optimizer`` of two functions:
``init(params) -> state`` and ``update(grads, state, params, step) ->
(updates, state, metrics)``; ``apply_updates(params, updates)`` then adds
the updates.  ``params``, ``grads`` and ``updates`` are dicts name ->
tensor (``dict(model.named_parameters())``), and the state holds fp32
first and second moments whatever the parameters' dtype.

Unlike the JAX package's pure functions, ``apply_updates`` adds in place
(under ``torch.no_grad``), so the model keeps one copy of its weights.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


def clip_by_global_norm(tree: dict, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-9), max=1.0)
    return {k: (x.float() * scale).to(x.dtype) for k, x in tree.items()}, norm


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32) + 1.0


def adamw(lr: Callable | float, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = None) -> Optimizer:
    """AdamW: bias-corrected moments, ``eps`` outside the sqrt, decoupled
    weight decay added to the update, learning rate ``lr(step + 1)``."""
    lr_fn = lr if callable(lr) else (lambda step: torch.tensor(
        lr, dtype=torch.float32))

    def init(params):
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        return {"mu": zeros,
                "nu": {k: z.clone() for k, z in zeros.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = global_norm(grads)
        stepf = _step_f32(step)
        lr_t = lr_fn(stepf).to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), stepf)
        dev = gnorm.device                  # one copy of the step's scalars
        neg_lr, bc1, bc2 = (-lr_t).to(dev), bc1.to(dev), bc2.to(dev)
        updates, mu_new, nu_new = {}, {}, {}
        for k, g in grads.items():
            p = params[k]
            g32 = g.float()
            mu = b1 * state["mu"][k] + (1 - b1) * g32
            nu = b2 * state["nu"][k] + (1 - b2) * g32.square()
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            updates[k] = (neg_lr * upd).to(p.dtype)
            mu_new[k], nu_new[k] = mu, nu
        return (updates, {"mu": mu_new, "nu": nu_new},
                {"grad_norm": gnorm, "lr": lr_t})

    return Optimizer(init, update)


def sgd(lr: Callable | float, *, momentum: float = 0.0,
        clip_norm: Optional[float] = None) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: torch.tensor(
        lr, dtype=torch.float32))

    def init(params):
        if momentum:
            return {"mom": {k: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)
                            for k, p in params.items()}}
        return {}

    @torch.no_grad()
    def update(grads, state, params, step):
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = global_norm(grads)
        lr_t = lr_fn(_step_f32(step)).to(torch.float32)
        neg_lr = (-lr_t).to(gnorm.device)
        if momentum:
            mom = {k: momentum * state["mom"][k] + g.float()
                   for k, g in grads.items()}
            upd = {k: (neg_lr * m).to(params[k].dtype) for k, m in mom.items()}
            return upd, {"mom": mom}, {"grad_norm": gnorm, "lr": lr_t}
        upd = {k: (neg_lr * g.float()).to(params[k].dtype)
               for k, g in grads.items()}
        return upd, state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """params[k] += updates[k], in place; returns ``params``."""
    for k, u in updates.items():
        params[k].add_(u.to(params[k].dtype))
    return params
