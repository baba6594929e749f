"""The paper's sparse-attention baselines: Fixed and Routing Attention
(port of ``repro.core.baselines``).

Fixed sparse attention (Child et al.): the special case of MoSA with
``I = [0, rho, 2*rho, ...]`` and ``r = 1`` — the same strided indices for
every head, no router.

Routing Attention (Routing Transformer): each head clusters the tokens
into ``rho`` clusters of k by their similarity to learned centroids in a
tied Q = K space; attention runs within each cluster (causal on the
original indices).  The clusters are flattened into "virtual heads", so
the gather / attend / scatter-add is MoSA's.  The centroids are k-means
state, updated by an EMA toward their members (``ema_centroids``), never
by gradients: the loss reaches them only through top-k indices, so their
gradient is zero (``torch.autograd.grad`` returns None; the train step
turns that into zeros, as JAX's gradient is).

Both are train-only, as in the JAX package: ``HybridAttention`` refuses
to serve them.  Plain torch ops: the JAX package has no Pallas kernel
here.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import rope as rope_lib
from repro_torch.core.mosa import _gather_tokens, _scatter_heads
from repro_torch.core.router import selection_mask, topk_indices
from repro_torch.dist.sharding import logical
from repro_torch.nn.layers import param, trunc_normal_

NEG_INF = -1e30


def fixed_indices(T: int, k: int, batch_shape=(), device=None):
    """Strided selection I = [0, rho, 2rho, ...] of length k (int64),
    broadcast to ``batch_shape + (k,)``."""
    rho = max(T // k, 1)
    idx = torch.clamp(torch.arange(k, device=device) * rho, max=T - 1)
    return idx.expand(*batch_shape, k)


def _attend(q, k, v, idx, d):
    """Index-causal softmax attention over gathered rows: q, k, v (..., k,
    d) in compute dtype, idx (..., k).  Scores and softmax in fp32, the
    weighted sum in compute dtype, as the JAX einsums do."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * d ** -0.5
    s = torch.where(selection_mask(idx, idx), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v)


class FixedSparseAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_head: int = 64,
                 sparsity: int = 32, rope_theta: float = 10000.0,
                 rotary_frac: float = 0.5, param_dtype=torch.float32,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.d_model, self.n_heads, self.d_head = d_model, n_heads, d_head
        self.sparsity = sparsity
        self.rope_theta, self.rotary_frac = rope_theta, rotary_frac
        self.compute_dtype = compute_dtype
        H, h, d = n_heads, d_model, d_head
        self.wq = param((H, h, d), param_dtype, device)
        self.wk = param((H, h, d), param_dtype, device)
        self.wv = param((H, h, d), param_dtype, device)
        self.wo = param((H, d, h), param_dtype, device)

    def init(self, generator: torch.Generator):
        std = self.d_model ** -0.5
        for w in (self.wq, self.wk, self.wv):
            trunc_normal_(w, std, generator)
        trunc_normal_(self.wo, self.d_head ** -0.5, generator)

    def specs(self):
        return {"wq": logical("mosa_heads", "embed", None),
                "wk": logical("mosa_heads", "embed", None),
                "wv": logical("mosa_heads", "embed", None),
                "wo": logical("mosa_heads", None, "embed")}

    def forward(self, x, positions=None, segments=None):
        """x: (B, T, h) -> (B, T, h).  ``positions`` is ignored (RoPE at
        the selected indices), as in the JAX layer; packed rows are not
        taken."""
        if segments is not None:
            raise NotImplementedError("the fixed baseline takes no packed "
                                      "rows (train-only, as in JAX)")
        cd = self.compute_dtype
        B, T, h = x.shape
        H, d = self.wq.shape[0], self.d_head     # this rank's heads on a mesh
        k = max(T // self.sparsity, 2)
        idx = fixed_indices(T, k, (B, H), x.device)             # (B, H, k)
        xs = _gather_tokens(x.to(cd), idx)                       # (B, H, k, h)
        q, kk, v = (torch.einsum("bnkh,nhd->bnkd", xs, w.to(cd))
                    for w in (self.wq, self.wk, self.wv))
        q = rope_lib.apply_rope(q, idx, self.rope_theta, self.rotary_frac)
        kk = rope_lib.apply_rope(kk, idx, self.rope_theta, self.rotary_frac)
        att = _attend(q, kk, v, idx, d)
        y_heads = torch.einsum("bnkd,ndh->bnkh", att, self.wo.to(cd))
        return _scatter_heads(y_heads, idx, T)


class RoutingAttention(nn.Module):
    """Routing Transformer attention head(s) with online k-means clusters:
    ``sparsity`` = rho clusters per head, each of k = max(T // rho, 2)."""

    # parameters the loss never reaches (the top-k indices carry no
    # gradient): the train step gives them zeros, as JAX's gradient is
    GRADIENT_FREE = ("centroids",)

    def __init__(self, d_model: int, n_heads: int, d_head: int = 64,
                 sparsity: int = 32, rope_theta: float = 10000.0,
                 rotary_frac: float = 0.5, ema_decay: float = 0.999,
                 param_dtype=torch.float32, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.d_model, self.n_heads, self.d_head = d_model, n_heads, d_head
        self.sparsity = sparsity
        self.rope_theta, self.rotary_frac = rope_theta, rotary_frac
        self.ema_decay = ema_decay
        self.compute_dtype = compute_dtype
        H, h, d = n_heads, d_model, d_head
        self.wqk = param((H, h, d), param_dtype, device)
        self.wv = param((H, h, d), param_dtype, device)
        self.wo = param((H, d, h), param_dtype, device)
        # k-means state (EMA-updated, not gradient-trained), always fp32
        self.centroids = param((H, sparsity, d), torch.float32, device)

    def init(self, generator: torch.Generator):
        std = self.d_model ** -0.5
        trunc_normal_(self.wqk, std, generator)
        trunc_normal_(self.wv, std, generator)
        trunc_normal_(self.wo, self.d_head ** -0.5, generator)
        trunc_normal_(self.centroids, 1.0, generator)

    def specs(self):
        return {"wqk": logical("mosa_heads", "embed", None),
                "wv": logical("mosa_heads", "embed", None),
                "wo": logical("mosa_heads", None, "embed"),
                "centroids": logical("mosa_heads", None, None)}

    def _cluster_select(self, qk, k: int):
        """qk: (B, H, T, d) normalized fp32 -> idx (B, H, rho, k): each
        cluster's k most similar tokens (ties: lower index first, as
        ``lax.top_k``), sorted ascending."""
        sim = torch.einsum("bntd,ncd->bnct", qk,
                           self.centroids.to(qk.dtype))           # (B,H,rho,T)
        return torch.sort(topk_indices(sim, k), dim=-1).values

    def _normalized_qk(self, x):
        """The L2-normalised tied projection of every token, (B, H, T, d)
        in compute dtype: the space the clusters live in."""
        cd = self.compute_dtype
        qk = torch.einsum("bth,nhd->bntd", x.to(cd).float(),
                          self.wqk.to(cd).float())
        qk = qk / (torch.linalg.vector_norm(qk, dim=-1, keepdim=True) + 1e-6)
        return qk.to(cd)

    def forward(self, x, positions=None, segments=None,
                update_state: bool = False):
        """x: (B, T, h) -> (B, T, h), or with ``update_state`` (y, the
        centroids after one EMA step).  ``positions`` is ignored, as in the
        JAX layer; packed rows are not taken."""
        if segments is not None:
            raise NotImplementedError("the routing baseline takes no packed "
                                      "rows (train-only, as in JAX)")
        cd = self.compute_dtype
        B, T, h = x.shape
        H, d, rho = self.wqk.shape[0], self.d_head, self.sparsity
        k = max(T // rho, 2)
        with torch.no_grad():        # the selection carries no gradient
            qk = self._normalized_qk(x)
            idx = self._cluster_select(qk.float(), k)            # (B,H,rho,k)

        # the clusters flattened into virtual heads: (B, H * rho, k)
        idxf = idx.reshape(B, H * rho, k)
        xs = _gather_tokens(x.to(cd), idxf).reshape(B, H, rho, k, h)
        # attention uses the un-normalised projection as both q and k
        qkv = torch.einsum("bnckh,nhd->bnckd", xs, self.wqk.to(cd))
        v = torch.einsum("bnckh,nhd->bnckd", xs, self.wv.to(cd))
        qr = rope_lib.apply_rope(qkv, idx, self.rope_theta, self.rotary_frac)
        att = _attend(qr, qr, v, idx, d)
        y_heads = torch.einsum("bnckd,ndh->bnckh", att, self.wo.to(cd))
        y = _scatter_heads(y_heads.reshape(B, H * rho, k, h), idxf, T)
        if not update_state:
            return y
        return y, self.ema_centroids(qk, idx)

    def ema_centroids(self, qk, idx):
        """Online k-means: the centroids after one EMA step toward the mean
        of their members, renormalised (no gradient).  qk: (B, H, T, d),
        idx: (B, H, rho, k).  The JAX signature without ``params`` (the
        centroids are this module's)."""
        B, H, T, d = qk.shape
        with torch.no_grad():
            qk = qk.float()
            members = torch.gather(
                qk[:, :, None].expand(B, H, idx.shape[2], T, d), 3,
                idx[..., None].expand(*idx.shape, d))    # (B, H, rho, k, d)
            mean = members.mean(dim=(0, 3))                       # (H, rho, d)
            new = (self.ema_decay * self.centroids
                   + (1 - self.ema_decay) * mean)
            return new / (torch.linalg.vector_norm(new, dim=-1, keepdim=True)
                          + 1e-6)
