"""Core layers: Linear, Embedding, RMSNorm, LayerNorm.

Ports of ``repro.nn.layers``.  Parameters keep the JAX package's names and
layouts (``Linear.w`` is ``(d_in, d_out)``), so a converted parameter tree
loads with ``load_state_dict``.  Parameters live in ``param_dtype``; matmuls
run in ``compute_dtype``.  Modules are built with empty parameters on an
explicit ``device``; ``init(generator)`` fills them from a
``torch.Generator``.  ``specs()`` names the logical axes of each parameter,
as the JAX modules' (``repro_torch.dist.sharding`` resolves them on a
mesh); a module's ``specs()`` is keyed like its ``state_dict``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.dist.parallel import reduce_from
from repro_torch.dist.sharding import logical


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    """In-place truncated normal at +-2 std (the JAX package's init)."""
    with torch.no_grad():
        f = torch.empty(t.shape, dtype=torch.float32, device=t.device)
        nn.init.trunc_normal_(f, std=1.0, a=-2.0, b=2.0, generator=generator)
        t.copy_(f * std)
    return t


def param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 param_dtype=torch.float32, compute_dtype=torch.float32,
                 std: float | None = None, in_axis: str | None = None,
                 out_axis: str | None = None, device=None):
        super().__init__()
        self.d_in, self.d_out = d_in, d_out
        self.in_axis, self.out_axis = in_axis, out_axis
        # on a mesh (``dist.parallel.shard_model``): the vocabulary slice
        # that this rank's ``w`` holds when ``out_axis`` is "vocab"
        self.tp, self.vocab_range = None, None
        self.compute_dtype = compute_dtype
        self.std = std if std is not None else d_in ** -0.5
        self.w = param((d_in, d_out), param_dtype, device)
        self.b = param((d_out,), param_dtype, device) if bias else None

    def init(self, generator: torch.Generator):
        trunc_normal_(self.w, self.std, generator)
        if self.b is not None:
            nn.init.zeros_(self.b)

    def specs(self):
        s = {"w": logical(self.in_axis, self.out_axis)}
        if self.b is not None:
            s["b"] = logical(self.out_axis)
        return s

    def forward(self, x):
        cd = self.compute_dtype
        y = x.to(cd) @ self.w.to(cd)
        if self.b is not None:
            y = y + self.b.to(cd)
        return y


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, param_dtype=torch.float32,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.table = param((vocab, dim), param_dtype, device)
        # on a mesh: the vocabulary rows [lo, hi) that this rank holds
        self.tp, self.vocab_range = None, None

    def init(self, generator: torch.Generator):
        trunc_normal_(self.table, 1.0, generator)

    def specs(self):
        return {"table": logical("vocab", "embed")}

    def forward(self, ids):
        if self.tp is None:
            return self.table.to(self.compute_dtype)[ids]
        # vocab-parallel lookup: this rank's rows, zeros elsewhere, summed
        lo, hi = self.vocab_range
        local = ids - lo
        ok = (local >= 0) & (local < hi - lo)
        rows = self.table.to(self.compute_dtype)[local.clamp(0, hi - lo - 1)]
        return reduce_from(torch.where(ok[..., None], rows, 0.0), self.tp)

    def attend(self, x):
        """Tied unembedding: logits = x @ table.T in fp32."""
        t = self.table.to(self.compute_dtype)
        return (x.to(self.compute_dtype) @ t.T).float()


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, param_dtype=torch.float32,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.scale = param((dim,), param_dtype, device)

    def init(self, generator: torch.Generator):
        nn.init.ones_(self.scale)

    def specs(self):
        return {"scale": logical(None)}

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(self.compute_dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, param_dtype=torch.float32,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.scale = param((dim,), param_dtype, device)
        self.bias = param((dim,), param_dtype, device)

    def init(self, generator: torch.Generator):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def specs(self):
        return {"scale": logical(None), "bias": logical(None)}

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        y = y * self.scale.float() + self.bias.float()
        return y.to(self.compute_dtype)
