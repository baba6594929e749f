"""Learning-rate schedules (port of ``repro.optim.schedules``): functions of
the step as a 0-d fp32 tensor, returning a 0-d fp32 tensor."""

from __future__ import annotations

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def linear_warmup(lr: float, warmup_steps: int):
    """The paper's schedule: linear warmup then constant (App. C)."""

    def fn(step):
        warm = torch.clamp(_f32(step) / max(warmup_steps, 1), max=1.0)
        return (lr * warm).to(torch.float32)

    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return (lr * warm * cos).to(torch.float32)

    return fn


def warmup_rsqrt(lr: float, warmup_steps: int):
    def fn(step):
        s = torch.clamp(_f32(step), min=1.0)
        decay = (warmup_steps / s) ** 0.5 if warmup_steps else _f32(1.0)
        return (lr * torch.minimum(s / max(warmup_steps, 1), decay)).to(
            torch.float32)

    return fn
