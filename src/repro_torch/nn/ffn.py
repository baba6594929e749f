"""Dense feed-forward block (SwiGLU / GELU), ported from ``repro.nn.ffn.MLP``.

GELU is the tanh approximation, as ``jax.nn.gelu``'s default.  The
token-choice MoE (``repro.nn.ffn.MoEFFN``) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.layers import param, trunc_normal_


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str = "swiglu",
                 param_dtype=torch.float32, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        if act not in ("swiglu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.d_model, self.d_ff, self.act = d_model, d_ff, act
        self.compute_dtype = compute_dtype
        if act == "swiglu":
            self.w_gate = param((d_model, d_ff), param_dtype, device)
            self.w_up = param((d_model, d_ff), param_dtype, device)
            self.w_down = param((d_ff, d_model), param_dtype, device)
        else:
            self.w_in = param((d_model, d_ff), param_dtype, device)
            self.w_out = param((d_ff, d_model), param_dtype, device)

    def init(self, generator: torch.Generator):
        std_in, std_out = self.d_model ** -0.5, self.d_ff ** -0.5
        if self.act == "swiglu":
            trunc_normal_(self.w_gate, std_in, generator)
            trunc_normal_(self.w_up, std_in, generator)
            trunc_normal_(self.w_down, std_out, generator)
        else:
            trunc_normal_(self.w_in, std_in, generator)
            trunc_normal_(self.w_out, std_out, generator)

    def forward(self, x):
        cd = self.compute_dtype
        x = x.to(cd)
        if self.act == "swiglu":
            g = (x @ self.w_gate.to(cd)).float()
            u = (x @ self.w_up.to(cd)).float()
            h = (F.silu(g) * u).to(cd)
            return h @ self.w_down.to(cd)
        h = F.gelu((x @ self.w_in.to(cd)).float(), approximate="tanh").to(cd)
        return h @ self.w_out.to(cd)
