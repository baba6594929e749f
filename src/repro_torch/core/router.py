"""Expert-choice token router — port of ``repro.core.router``.

Each MoSA head owns one router vector; scores are the non-competitive
sigmoid ``r = sigmoid(X W^r)`` in fp32, and each head selects its top-k
tokens (expert choice: exactly k per head).  ``streaming_topk_update`` is
the serving-time evict-min policy behind ``MoSAKVCache``;
``router_health_stats`` is the train loop's telemetry of one selection.

Indices are ``torch.long`` on the Python side (they index tensors);
kernels take them as int32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.nn.layers import param, trunc_normal_


class ExpertChoiceRouter(nn.Module):
    def __init__(self, d_model: int, n_heads: int, device=None):
        super().__init__()
        self.d_model = d_model
        # Router kept in fp32: top-k boundary decisions are precision-sensitive.
        self.w = param((n_heads, d_model), torch.float32, device)

    def init(self, generator: torch.Generator):
        trunc_normal_(self.w, self.d_model ** -0.5, generator)

    def scores(self, x):
        """x: (B, T, h) -> sigmoid scores (B, H, T) in fp32."""
        return torch.sigmoid(torch.einsum("bth,nh->bnt", x.float(), self.w))


def topk_indices(scores, k: int):
    """Indices of the ``k`` largest entries along the last axis, equal
    scores taken lower index first — the rule of ``jax.lax.top_k``, and the
    same on every device.  (``torch.topk`` leaves the order of ties open, and
    on CUDA it differs from the CPU: a prompt that repeats a token gives its
    copies equal router scores in the first layer.)"""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def select_topk(scores, k: int, force_first: bool = True):
    """scores: (B, H, T) fp32 -> (r, idx), both (B, H, k), ``idx`` sorted
    ascending.  ``force_first`` always includes token 0 (attention sink)."""
    B, H, T = scores.shape
    if not 0 < k <= T:
        raise ValueError(f"k={k} out of range for T={T}")
    if force_first and k >= 2:
        rest = topk_indices(scores[..., 1:], k - 1)
        idx = torch.cat([torch.zeros_like(rest[..., :1]), rest + 1], dim=-1)
    else:
        idx = topk_indices(scores, k)
    idx = torch.sort(idx, dim=-1).values
    r = torch.gather(scores, -1, idx)
    return r, idx


def router_health_stats(r, idx, T: int):
    """Health of one expert-choice selection (train-loop telemetry), as
    ``repro.core.router.router_health_stats``.  r, idx: (B, H, k) from
    ``select_topk`` over (B, H, T) scores.  Returns 0-d fp32 tensors:

      * ``sel_entropy`` — entropy of the aggregate selection distribution
        over positions, normalized by log T (low = heads concentrate on
        few tokens: router collapse);
      * ``drop_rate``   — fraction of tokens selected by no head (they get
        no sparse output and no router gradient this step);
      * ``head_util``   — mean router score over selected tokens."""
    B, H, k = idx.shape
    sel = torch.zeros((B, H, T), dtype=torch.float32, device=idx.device)
    sel.scatter_add_(-1, idx.long(), torch.ones_like(sel[..., :k]))
    drop_rate = (sel.sum(1) == 0).float().mean()
    p = sel.sum((0, 1)) / (B * H * k)
    ent = -torch.where(p > 0, p * torch.log(p.clamp_min(1e-20)), 0.0).sum()
    return {"sel_entropy": ent / math.log(float(max(T, 2))),
            "drop_rate": drop_rate, "head_util": r.float().mean()}


def selection_mask(idx_q, idx_k):
    """Causal mask from original indices: allow iff I_q >= I_k.
    idx_q: (..., kq), idx_k: (..., kk) -> bool (..., kq, kk)."""
    return idx_q[..., :, None] >= idx_k[..., None, :]


def streaming_topk_update(cache_scores, cache_idx, new_score, new_pos,
                          is_forced):
    """One step of the serving-time top-k approximation: the incoming token
    replaces the minimum-score slot iff its score beats that minimum (empty
    slots score ``-inf`` and fill first; ties pick the first slot).

    cache_scores/cache_idx: (..., k); new_score: (...,); new_pos: broadcastable
    to new_score; is_forced: bool broadcastable.  Returns
    (selected, slot, new_scores, new_idx)."""
    min_slot = torch.argmin(cache_scores, dim=-1)
    min_score = torch.gather(cache_scores, -1, min_slot[..., None])[..., 0]
    selected = (new_score > min_score) | is_forced
    slots = torch.arange(cache_scores.shape[-1], device=cache_scores.device)
    hit = (min_slot[..., None] == slots) & selected[..., None]
    new_scores = torch.where(hit, new_score[..., None], cache_scores)
    pos = torch.as_tensor(new_pos, device=cache_idx.device)
    pos = pos.broadcast_to(new_score.shape)[..., None].to(cache_idx.dtype)
    new_idx = torch.where(hit, pos, cache_idx)
    return selected, min_slot, new_scores, new_idx
