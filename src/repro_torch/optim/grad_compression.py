"""Gradient compression for data-parallel all-reduces (port of
``repro.optim.grad_compression``).

At 2+ pods the links between pods are the scarcest, so the ``pod``-axis
all-reduce is the one worth compressing.  Two schemes, both with error
feedback (the residual is added back at the next call, so the compression
is unbiased over time):

  * ``topk_compress`` — keep the largest-|g| fraction of each tensor and
    all-reduce the dense tensor with the rest zeroed (deterministic, shapes
    static);
  * ``int8_compress`` — symmetric per-tensor int8 quantization.  The JAX
    module's docstring says the int8 all-reduce runs in int32; its code
    all-reduces the dequantized floats, and so does this port (ROADMAP C).

``compressed_all_reduce(tensors, group, scheme)`` is the counterpart of
``compressed_psum``.  The Trainer does not call it, as the JAX Trainer
does not.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Boolean mask keeping the entries with |x| at least the
    ``max(1, int(n * frac))``-th largest |x| (ties keep more)."""
    kth = max(1, int(x.numel() * frac))
    flat = x.reshape(-1).abs()
    thresh = torch.topk(flat, kth, sorted=True).values[-1]
    return x.abs() >= thresh


def topk_compress(g: torch.Tensor, frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kept, residual) with kept + residual == g."""
    kept = torch.where(topk_mask(g, frac), g, torch.zeros_like(g))
    return kept, g - kept


def int8_quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dequantized, residual) with dequantized + residual == g."""
    q, scale = int8_quantize(g.float())
    deq = int8_dequantize(q, scale).to(g.dtype)
    return deq, g - deq


def _group(group):
    """A process group, or ``(mesh, dim name)`` of a ``DeviceMesh``."""
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    return group


def compressed_all_reduce(tensors: dict, group=None, scheme: str = "none",
                          topk_frac: float = 0.01, residual=None):
    """Sum ``tensors`` (name -> tensor) over ``group`` (a process group,
    ``(mesh, dim)``, or None for the world) with optional compression and
    error feedback.  Returns (reduced, new residual); the residual is None
    for ``"none"``."""
    pg = _group(group)
    if scheme == "none":
        out = {}
        for k, g in tensors.items():
            out[k] = g.clone()
            dist.all_reduce(out[k], group=pg)
        return out, residual
    if scheme not in ("topk", "int8"):
        raise ValueError(scheme)
    if residual is None:
        residual = {k: torch.zeros_like(g) for k, g in tensors.items()}
    reduced, new_res = {}, {}
    for k, g in tensors.items():
        g = g + residual[k].to(g.dtype)
        if scheme == "topk":
            kept, new_res[k] = topk_compress(g, topk_frac)
        else:
            kept, new_res[k] = int8_compress(g)
        dist.all_reduce(kept, group=pg)
        reduced[k] = kept
    return reduced, new_res
