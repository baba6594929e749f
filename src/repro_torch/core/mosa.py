"""Mixture of Sparse Attention — the paper's layer (port of the token-choice
path of ``repro.core.mosa``).

Per head: router scores r = sigmoid(X W^r); expert-choice top-k token
selection; Q/K/V/O computed only for the selected tokens; attention over
the k x k submatrix with the index-derived causal mask (I_q >= I_k) and
RoPE at the original positions; outputs scaled by the router score and
scatter-added back to the sequence.

``impl="kernel"`` runs the inner attention through
``repro_torch.kernels.mosa_attention.mosa_attention``: the CUDA kernels for
CUDA tensors, their plain versions for CPU tensors, and under autograd the
``torch.autograd.Function`` of ``kernels.mosa_vjp``, whose backward
returns dq, dk, dv and the router-score gradient dr (through it, and the
gather of the selected scores, the router weights learn).  ``impl="einsum"``
is the port of the JAX package's XLA path in plain PyTorch.  Block-choice
selection is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import MoSAConfig
from repro_torch.core import rope as rope_lib
from repro_torch.core.kv_cache import MoSAKVCache
from repro_torch.core.router import (ExpertChoiceRouter, router_health_stats,
                                     select_topk, selection_mask,
                                     streaming_topk_update)
from repro_torch.kernels import mosa_attention as kmosa
from repro_torch.nn.layers import param, trunc_normal_

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


def _gather_tokens(x, idx):
    """x: (B, T, ...) and idx: (B, H, k) -> (B, H, k, ...): row b's tokens
    at idx[b] (the batch dimension written out where JAX vmaps)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, idx]


class MoSAAttention(nn.Module):
    def __init__(self, d_model: int, cfg: MoSAConfig,
                 rope_theta: float = 10000.0, rotary_frac: float = 0.5,
                 param_dtype=torch.float32, compute_dtype=torch.float32,
                 impl: str = "einsum", device=None):
        super().__init__()
        if cfg.selection_granularity != "token":
            raise NotImplementedError("block-choice MoSA is not ported yet")
        if impl not in ("einsum", "kernel"):
            raise ValueError(f"unknown MoSA impl {impl!r}")
        self.d_model, self.cfg = d_model, cfg
        self.rope_theta, self.rotary_frac = rope_theta, rotary_frac
        self.compute_dtype = compute_dtype
        self.impl = impl
        H, h, d = cfg.n_mosa_heads, d_model, cfg.d_head
        self.router = ExpertChoiceRouter(d_model, H, device=device)
        self.wq = param((H, h, d), param_dtype, device)
        self.wk = param((H, h, d), param_dtype, device)
        self.wv = param((H, h, d), param_dtype, device)
        self.wo = param((H, d, h), param_dtype, device)

    def init(self, generator: torch.Generator):
        std = self.d_model ** -0.5
        self.router.init(generator)
        trunc_normal_(self.wq, std, generator)
        trunc_normal_(self.wk, std, generator)
        trunc_normal_(self.wv, std, generator)
        trunc_normal_(self.wo, self.cfg.d_head ** -0.5, generator)

    def k_for(self, T: int) -> int:
        """Paper §3.5: k = max(floor(T / rho), min_k), capped at T; constant
        ``k_fixed`` when set."""
        if self.cfg.k_fixed > 0:
            return min(self.cfg.k_fixed, T)
        return max(min(T // self.cfg.sparsity, T), min(self.cfg.min_k, T))

    def _proj(self, xs, w):
        """(B, H, k, h) x (H, h, d) -> (B, H, k, d) in compute dtype."""
        cd = self.compute_dtype
        return torch.einsum("bnkh,nhd->bnkd", xs, w.to(cd))

    def _rope(self, t, positions):
        return rope_lib.apply_rope(t, positions, self.rope_theta,
                                   self.rotary_frac)

    # ------------------------------------------------------------------ call
    def forward(self, x, positions=None, valid=None, segments=None):
        """x: (B, T, h) -> (B, T, h).  ``valid``: optional (B, T) bool,
        False for right-pad tokens, which are kept out of the selection
        (their scores drop to -1.0) and contribute nothing.  ``segments``:
        optional (B, T) document ids of packed rows; the k x k attention
        then also needs seg_q == seg_k (selection stays row-global), and
        ``positions`` should restart at every document."""
        c, cd = self.cfg, self.compute_dtype
        B, T, h = x.shape
        k = self.k_for(T)

        scores = self.router.scores(x)                        # (B, H, T) fp32
        if valid is not None:
            scores = torch.where(valid[:, None, :], scores, -1.0)
        r, idx = select_topk(scores, k, c.force_first_token)  # (B, H, k)
        if valid is not None:
            r = torch.where(r > 0.0, r, 0.0)

        if positions is None:
            pos_sel = idx
        else:
            pos_sel = torch.gather(
                positions[:, None].expand(B, idx.shape[1], T), -1, idx)

        xs = _gather_tokens(x.to(cd), idx)                    # (B, H, k, h)
        q = self._rope(self._proj(xs, self.wq), pos_sel)
        kk = self._rope(self._proj(xs, self.wk), pos_sel)
        v = self._proj(xs, self.wv)

        seg_sel = None
        if segments is not None:
            seg_sel = torch.gather(segments[:, None].expand(B, idx.shape[1], T),
                                   -1, idx)

        if self.impl == "kernel":
            att = kmosa.mosa_attention(
                q.contiguous(), kk.contiguous(), v.contiguous(),
                idx.to(torch.int32), r.float().contiguous(),
                seg=None if seg_sel is None
                else seg_sel.to(torch.int32).contiguous())
        else:
            att = self._einsum_attention(q, kk, v, idx, r, seg_sel)

        y_heads = torch.einsum("bnkd,ndh->bnkh", att.to(cd), self.wo.to(cd))
        # scatter-add every head's rows back to their original positions
        flat = (idx + T * torch.arange(B, device=x.device)[:, None, None])
        y = torch.zeros((B * T, h), dtype=cd, device=x.device)
        y.index_add_(0, flat.reshape(-1), y_heads.reshape(-1, h))
        return y.reshape(B, T, h)

    def _einsum_attention(self, q, k, v, idx, r, seg=None):
        """Reference attention over selected tokens.  All inputs (B,H,k,*);
        ``seg``: optional segment ids of the selected tokens."""
        scale = self.cfg.d_head ** -0.5
        s = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * scale
        mask = selection_mask(idx, idx)
        if seg is not None:
            mask &= seg[..., :, None] == seg[..., None, :]
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("bnqk,bnkd->bnqd", p.to(v.dtype).float(),
                           v.float())
        return att * r[..., None]

    def router_health(self, x):
        """Router health of this layer's selection on input ``x`` (see
        ``router_health_stats``)."""
        T = x.shape[1]
        r, idx = select_topk(self.router.scores(x), self.k_for(T),
                             self.cfg.force_first_token)
        return router_health_stats(r, idx, T)

    # --------------------------------------------------------------- serving
    def prefill(self, x, cache: MoSAKVCache, positions=None, valid=None):
        """Run the prompt through training-style selection and fill the
        cache with each head's top ``min(capacity, T)`` candidates (wide,
        so continued prefill stays exact); the output ``y`` uses the
        training-time ``k_for(T)`` selection."""
        c, cd = self.cfg, self.compute_dtype
        B, T, h = x.shape
        k_cache = cache.k.shape[2]
        k = min(k_cache, T)

        y = self(x, positions, valid)

        scores = self.router.scores(x)
        if valid is not None:
            scores = torch.where(valid[:, None, :], scores, -1.0)
        r, idx = select_topk(scores, k, c.force_first_token)
        xs = _gather_tokens(x.to(cd), idx)
        kk = self._rope(self._proj(xs, self.wk), idx)
        v = self._proj(xs, self.wv)
        if valid is not None:
            sel_ok = r > 0.0
            r = torch.where(sel_ok, r, float("-inf"))
            idx = torch.where(sel_ok, idx, -1)
        pad = k_cache - k
        if pad:
            kk = nn.functional.pad(kk, (0, 0, 0, pad))
            v = nn.functional.pad(v, (0, 0, 0, pad))
            r = nn.functional.pad(r, (0, pad), value=float("-inf"))
            idx = nn.functional.pad(idx, (0, pad), value=-1)
        nv = (T if valid is None else valid.sum(-1).to(torch.int32))
        cache = MoSAKVCache(kk, v, r.float(), idx, cache.length + nv)
        return y, cache

    def decode_step(self, x, cache: MoSAKVCache, positions=None):
        """Streaming expert-choice decode.  x: (B, 1, h).  The new token
        enters a head's top-k set iff its router score beats the current
        minimum (or it is the forced first token); slots are then re-sorted
        by original position, empty slots last."""
        c, cd = self.cfg, self.compute_dtype
        B, _, h = x.shape
        H, d = c.n_mosa_heads, c.d_head
        t = cache.length.long() if positions is None else positions[:, 0]

        x0 = x[:, 0].to(cd)                                       # (B, h)
        score = self.router.scores(x)[..., 0]                     # (B, H)
        is_forced = ((t == 0) if c.force_first_token
                     else torch.zeros_like(t, dtype=torch.bool))[:, None]

        q = torch.einsum("bh,nhd->bnd", x0, self.wq.to(cd))
        kk = torch.einsum("bh,nhd->bnd", x0, self.wk.to(cd))
        v = torch.einsum("bh,nhd->bnd", x0, self.wv.to(cd))
        pos_t = t[:, None, None].expand(B, H, 1)
        q = self._rope(q[:, :, None], pos_t)[:, :, 0]
        kk = self._rope(kk[:, :, None], pos_t)[:, :, 0]

        selected, slot, new_scores, new_idx = streaming_topk_update(
            cache.scores, cache.idx, score, t[:, None].expand(B, H), is_forced)

        slots = torch.arange(cache.k.shape[2], device=x.device)
        hit = ((slot[..., None] == slots) & selected[..., None])[..., None]
        new_k = torch.where(hit, kk[:, :, None].to(cache.k.dtype), cache.k)
        new_v = torch.where(hit, v[:, :, None].to(cache.v.dtype), cache.v)

        # Restore the sorted-ascending slot order (empty slots sort last).
        key = torch.where(new_idx < 0, INT32_MAX, new_idx)
        order = torch.argsort(key, dim=-1, stable=True)
        new_idx = torch.gather(new_idx, -1, order)
        new_scores = torch.gather(new_scores, -1, order)
        order_d = order[..., None].expand(-1, -1, -1, d)
        new_k = torch.gather(new_k, 2, order_d)
        new_v = torch.gather(new_v, 2, order_d)

        # Attention of the (possibly inserted) query over the cached set.
        ok = new_idx >= 0                                         # (B, H, k)
        s = torch.einsum("bnd,bnkd->bnk", q.float(), new_k.float()) * (d ** -0.5)
        s = torch.where(ok, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("bnk,bnkd->bnd", p.to(cd).float(), new_v.float())
        att = att * (score * selected.float())[..., None]
        y = torch.einsum("bnd,ndh->bh", att.to(cd), self.wo.to(cd))

        cache = MoSAKVCache(new_k, new_v, new_scores, new_idx,
                            cache.length + 1)
        return y[:, None], cache
