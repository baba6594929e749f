"""Rotary position embeddings at explicit positions (port of
``repro.core.rope``).

MoSA gathers an arbitrary subset of tokens per head, so RoPE is applied at
the tokens' original positions, never at ``arange(k)``.  Rotate-half
convention and partial rotary (``rotary_frac``: the paper rotates half of
each head's dims).  cos/sin are cast to the input dtype before the
multiply, as the reference does.  M-RoPE is not ported yet.
"""

from __future__ import annotations

import torch


def inv_freqs(d_rot: int, theta: float, device=None) -> torch.Tensor:
    """(d_rot // 2,) inverse frequencies in fp32."""
    ar = torch.arange(0, d_rot, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / d_rot))


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x, positions, theta: float = 10000.0, rotary_frac: float = 1.0):
    """x: (..., L, d); positions: (..., L) integers broadcastable to x's
    leading dims."""
    d = x.shape[-1]
    d_rot = int(d * rotary_frac)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    x_rot, x_pass = x[..., :d_rot], x[..., d_rot:]
    freqs = inv_freqs(d_rot, theta, x.device)
    angles = positions.float()[..., None] * freqs
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    cos = torch.cat([cos, cos], dim=-1).to(x.dtype)
    sin = torch.cat([sin, sin], dim=-1).to(x.dtype)
    x_rot = x_rot * cos + _rotate_half(x_rot) * sin
    if x_pass.shape[-1] == 0:
        return x_rot
    return torch.cat([x_rot, x_pass], dim=-1)
