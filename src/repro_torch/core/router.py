"""Expert-choice token router — port of ``repro.core.router``.

Each MoSA head owns one router vector; scores are the non-competitive
sigmoid ``r = sigmoid(X W^r)`` in fp32, and each head selects its top-k
tokens (expert choice: exactly k per head).  ``streaming_topk_update`` is
the serving-time evict-min policy behind ``MoSAKVCache``;
``router_health_stats`` is the train loop's telemetry of one selection.
Block choice pools the token scores per block of ``sel_block_size``
tokens (``block_pool_scores``), selects blocks with the same
``select_topk`` and expands the selected blocks back to token positions
(``expand_block_index``).

Indices are ``torch.long`` on the Python side (they index tensors);
kernels take them as int32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.dist.sharding import logical
from repro_torch.nn.layers import param, trunc_normal_


class ExpertChoiceRouter(nn.Module):
    def __init__(self, d_model: int, n_heads: int, device=None):
        super().__init__()
        self.d_model = d_model
        # Router kept in fp32: top-k boundary decisions are precision-sensitive.
        self.w = param((n_heads, d_model), torch.float32, device)

    def init(self, generator: torch.Generator):
        trunc_normal_(self.w, self.d_model ** -0.5, generator)

    def specs(self):
        return {"w": logical("mosa_heads", "embed")}

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


def router_health_stats(r, idx, T: int, heads_sum=None, rows_sum=None):
    """Health of one expert-choice selection (train-loop telemetry), as
    ``repro.core.router.router_health_stats``.  r, idx: (B, H, k) from
    ``select_topk`` over (B, H, T) scores.  Returns 0-d fp32 tensors:

      * ``sel_entropy`` — entropy of the aggregate selection distribution
        over positions, normalized by log T (low = heads concentrate on
        few tokens: router collapse);
      * ``drop_rate``   — fraction of tokens selected by no head (they get
        no sparse output and no router gradient this step);
      * ``head_util``   — mean router score over selected tokens.

    On a mesh, where a rank holds some heads of some rows, ``heads_sum``
    and ``rows_sum`` sum a tensor over the ranks that hold the other heads
    and the other rows: the counts of selections per token are exact, so
    the entropy and the drop rate equal one device's."""
    B, H, k = idx.shape
    sel = torch.zeros((B, H, T), dtype=torch.float32, device=idx.device)
    sel.scatter_add_(-1, idx.long(), torch.ones_like(sel[..., :k]))
    heads_sum = heads_sum or (lambda t: t)
    rows_sum = rows_sum or (lambda t: t)
    # one sum over the head shards, one over the rows (no host data: the
    # counts are filled on the device)
    hs = heads_sum(torch.cat([sel.sum(1).reshape(-1), r.float().sum()[None],
                              r.new_full((1,), float(B * H * k))]))
    count = hs[:B * T].reshape(B, T)                    # over all heads
    sums = rows_sum(torch.cat([count.sum(0), (count == 0).float().sum()[None],
                               hs[B * T:], r.new_full((1,), float(B * T))]))
    p_num, dropped, r_sum, n_sel, n_tok = (
        sums[:T], sums[T], sums[T + 1], sums[T + 2], sums[T + 3])
    drop_rate = dropped / n_tok
    p = p_num / n_sel
    head_util = r_sum / n_sel
    ent = -torch.where(p > 0, p * torch.log(p.clamp_min(1e-20)), 0.0).sum()
    return {"sel_entropy": ent / math.log(float(max(T, 2))),
            "drop_rate": drop_rate, "head_util": head_util}


def selection_mask(idx_q, idx_k):
    """Causal mask from original indices: allow iff I_q >= I_k.
    idx_q: (..., kq), idx_k: (..., kk) -> bool (..., kq, kk)."""
    return idx_q[..., :, None] >= idx_k[..., None, :]


def block_pool_scores(scores, block_size: int):
    """(B, H, T) token scores -> (B, H, ceil(T / block_size)) block scores:
    the mean of each block's in-range tokens (the last block may be short).
    At ``block_size=1`` this returns the scores bit for bit."""
    T = scores.shape[-1]
    bs = block_size
    nb = -(-T // bs)
    s = nn.functional.pad(scores, (0, nb * bs - T))
    in_range = (torch.arange(nb * bs, device=scores.device) < T).view(nb, bs)
    ssum = torch.where(in_range, s.unflatten(-1, (nb, bs)), 0.0).sum(-1)
    return ssum / in_range.sum(-1).to(scores.dtype)


def expand_block_index(bidx, block_size: int, T: int):
    """(..., NB) block indices (-1 = empty) -> (..., NB * block_size) token
    positions ``bidx * bs + offset``, and -1 for every token of an empty
    block or past ``T`` (the ragged tail of the last block)."""
    bs = block_size
    off = torch.arange(bs, device=bidx.device, dtype=bidx.dtype)
    pos = bidx[..., None] * bs + off
    pos = torch.where((bidx[..., None] >= 0) & (pos < T), pos, -1)
    return pos.flatten(-2)


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
