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
is the port of the JAX package's XLA path in plain PyTorch.

Block choice (``selection_granularity="block"``): each head selects whole
KV blocks of ``sel_block_size`` tokens by the mean router score of the
block (``_call_block``); the inner attention is ``kernels.mosa_block``
(kernels #5-#8 on the card) with ``impl="kernel"``.  At
``sel_block_size=1`` the block path computes what the token path does, bit
for bit.  Its serving cache is ``MoSABlockKVCache``: only completed blocks
enter the candidates, so a snapshot at a block boundary is a function of
the prefix alone.

Serving: ``prefill`` (one-shot, training-style selection), ``prefill_past``
(continue a cached prefix with a prompt suffix through the exact
capacity-wide union selection), ``prefill_packed`` (the Scheduler's packed
chunk, unpacked per segment into ``prefill_past``) and the streaming
``decode_step``, each for either granularity.  The suffix attention of
``prefill_past`` and the decode attention are einsums, as in the JAX
package (no Pallas kernel there).

On a mesh the module holds a slice of the heads (``router.w``, ``wq``,
``wk``, ``wv``, ``wo`` cut on their leading ``mosa_heads`` dim by
``dist.parallel.shard_model``) and its forward and serving entry points,
unchanged, return the scatter-add of those heads alone (their head count
is the weights', their caches hold those heads: a shard of heads
h0..h1 selects and caches exactly what the whole layer does for them); the
caller sums the ranks' shares.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import MoSAConfig
from repro_torch.core import rope as rope_lib
from repro_torch.core.kv_cache import (MoSABlockKVCache, MoSAKVCache,
                                      scatter_kept)
from repro_torch.core.router import (ExpertChoiceRouter, block_pool_scores,
                                     expand_block_index, router_health_stats,
                                     select_topk, selection_mask,
                                     streaming_topk_update, topk_indices)
from repro_torch.dist.sharding import logical
from repro_torch.kernels import mosa_attention as kmosa
from repro_torch.kernels import mosa_block as kblock
from repro_torch.nn.layers import param, trunc_normal_
from repro_torch.nn.remat import checkpoint_gather, checkpoint_name
from repro_torch.nn.remat import gather_tokens as _gather_tokens

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


def _gather_rows(t, rows):
    """t: (B, H, R, d), rows: (B, H, k) -> (B, H, k, d)."""
    return torch.gather(t, 2, rows[..., None].expand(-1, -1, -1, t.shape[-1]))


def _scatter_heads(y_heads, tgt, T):
    """Sum every head's rows (B, H, k, h) into (B, T, h) at positions tgt
    (B, H, k); a target of T is dropped."""
    B, h = y_heads.shape[0], y_heads.shape[-1]
    flat = tgt + (T + 1) * torch.arange(B, device=tgt.device)[:, None, None]
    y = torch.zeros((B * (T + 1), h), dtype=y_heads.dtype,
                    device=y_heads.device)
    y.index_add_(0, flat.reshape(-1), y_heads.reshape(-1, h))
    return y.reshape(B, T + 1, h)[:, :T]


def _per_token(x, bs):
    """(B, H, NB) per-block values -> (B, H, NB*bs)."""
    return x[..., None].expand(*x.shape, bs).flatten(-2)


def _block_rows(slots, bs):
    """(B, H, n) block slots -> (B, H, n*bs) the token rows of those
    slots."""
    off = torch.arange(bs, device=slots.device)
    return (slots[..., None] * bs + off).flatten(-2)


class MoSAAttention(nn.Module):
    def __init__(self, d_model: int, cfg: MoSAConfig,
                 rope_theta: float = 10000.0, rotary_frac: float = 0.5,
                 param_dtype=torch.float32, compute_dtype=torch.float32,
                 impl: str = "einsum", device=None):
        super().__init__()
        if cfg.selection_granularity not in ("token", "block"):
            raise ValueError(f"unknown selection granularity "
                             f"{cfg.selection_granularity!r}")
        if impl not in ("einsum", "kernel"):
            raise ValueError(f"unknown MoSA impl {impl!r}")
        self.d_model, self.cfg = d_model, cfg
        self.n_heads = cfg.n_mosa_heads
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

    def specs(self):
        return {**{f"router.{k}": v for k, v in self.router.specs().items()},
                "wq": logical("mosa_heads", "embed", None),
                "wk": logical("mosa_heads", "embed", None),
                "wv": logical("mosa_heads", "embed", None),
                "wo": logical("mosa_heads", None, "embed")}

    def k_for(self, T: int) -> int:
        """Paper §3.5: k = max(floor(T / rho), min_k), capped at T; constant
        ``k_fixed`` when set."""
        if self.cfg.k_fixed > 0:
            return min(self.cfg.k_fixed, T)
        return max(min(T // self.cfg.sparsity, T), min(self.cfg.min_k, T))

    def kb_for(self, T: int) -> int:
        """Block-choice selection width: ``ceil(k_for(T) / bs)`` blocks,
        capped at the blocks of the sequence (``k_for(T)`` at bs = 1)."""
        bs = self.cfg.sel_block_size
        return min(-(-self.k_for(T) // bs), -(-T // bs))

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
        if self.cfg.selection_granularity == "block":
            return self._call_block(x, positions, valid, segments)
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

        # Under remat "mosa" the gathered activations and the selected
        # scores are kept: the recompute runs the router and its top-k
        # again (for idx), but not the gather.
        xs = checkpoint_gather(x.to(cd), idx, "mosa_gather")  # (B, H, k, h)
        r = checkpoint_name(r, "mosa_router")
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
        return _scatter_heads(y_heads, idx, T)

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

    # ------------------------------------------------------- block choice
    def _call_block(self, x, positions=None, valid=None, segments=None):
        """Block-choice forward: expert-choice top-``kb`` over blocks of
        ``bs`` tokens, each scored by the mean of its token scores; the
        selected blocks' tokens are gathered (a ragged last block is
        clamped into range and masked), attend under the position-causal
        mask, are scaled by their BLOCK score and scatter-added back
        (positions -1 dropped).  ``force_first_token`` forces block 0."""
        c, cd = self.cfg, self.compute_dtype
        B, T, h = x.shape
        H, bs = self.wq.shape[0], c.sel_block_size   # this rank's heads
        kb = self.kb_for(T)

        scores = self.router.scores(x)                        # (B, H, T)
        if valid is not None:
            scores = torch.where(valid[:, None, :], scores, -1.0)
        rblk, bidx = select_topk(block_pool_scores(scores, bs), kb,
                                 c.force_first_token)          # (B, H, kb)
        if valid is not None:
            rblk = torch.where(rblk > 0.0, rblk, 0.0)   # all-pad blocks: 0

        pos = expand_block_index(bidx, bs, T)      # (B, H, kb*bs); -1 = pad
        posc = pos.clamp(0, T - 1)
        pos_rope = posc if positions is None else torch.gather(
            positions[:, None].expand(B, H, T), -1, posc)

        xs = checkpoint_gather(x.to(cd), posc, "mosa_gather")  # (B, H, S, h)
        rblk = checkpoint_name(rblk, "mosa_router")
        q = self._rope(self._proj(xs, self.wq), pos_rope)
        kk = self._rope(self._proj(xs, self.wk), pos_rope)
        v = self._proj(xs, self.wv)

        seg_sel = None
        if segments is not None:
            seg_sel = torch.gather(segments[:, None].expand(B, H, T), -1,
                                   posc)

        if self.impl == "kernel":
            att = kblock.mosa_block_attention(
                q.contiguous(), kk.contiguous(), v.contiguous(),
                bidx.to(torch.int32), rblk.float().contiguous(), bs, T,
                seg=None if seg_sel is None
                else seg_sel.to(torch.int32).contiguous())
        else:
            att = self._einsum_block_attention(q, kk, v, pos,
                                               _per_token(rblk, bs), seg_sel)

        y_heads = torch.einsum("bnkd,ndh->bnkh", att.to(cd), self.wo.to(cd))
        return _scatter_heads(y_heads, torch.where(pos >= 0, pos, T), T)

    def _einsum_block_attention(self, q, k, v, pos, r_tok, seg=None):
        """Reference attention over block-expanded tokens: ``pos`` (B, H, S)
        positions (-1 = empty or ragged-tail row), ``r_tok`` (B, H, S) the
        block score of each row.  ``_einsum_attention`` plus the invalid-key
        mask and the zeroing of invalid rows (no-ops at bs = 1)."""
        scale = self.cfg.d_head ** -0.5
        ok = pos >= 0
        s = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * scale
        mask = selection_mask(pos, pos) & ok[..., None, :]
        if seg is not None:
            mask &= seg[..., :, None] == seg[..., None, :]
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("bnqk,bnkd->bnqd", p.to(v.dtype).float(),
                           v.float())
        return att * r_tok[..., None] * ok[..., None]

    def router_health(self, x, heads_sum=None, rows_sum=None):
        """Router health of this layer's selection on input ``x`` (see
        ``router_health_stats``; ``heads_sum`` / ``rows_sum`` on a mesh).
        Block choice is scored in block space: entropy over the blocks,
        drop rate of blocks no head selects."""
        T = x.shape[1]
        scores = self.router.scores(x)
        if self.cfg.selection_granularity == "block":
            bsc = block_pool_scores(scores, self.cfg.sel_block_size)
            r, bidx = select_topk(bsc, self.kb_for(T),
                                  self.cfg.force_first_token)
            return router_health_stats(r, bidx, bsc.shape[-1], heads_sum,
                                       rows_sum)
        r, idx = select_topk(scores, self.k_for(T),
                             self.cfg.force_first_token)
        return router_health_stats(r, idx, T, heads_sum, rows_sum)

    # --------------------------------------------------------------- serving
    def prefill(self, x, cache: MoSAKVCache, positions=None, valid=None):
        """Run the prompt through training-style selection and fill the
        cache with each head's top ``min(capacity, T)`` candidates (wide,
        so continued prefill stays exact); the output ``y`` uses the
        training-time ``k_for(T)`` selection."""
        if self.cfg.selection_granularity == "block":
            return self._prefill_block(x, cache, positions, valid)
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

    def prefill_past(self, x, cache: MoSAKVCache, valid=None):
        """Continued prefill: extend a restored prefix cache with a prompt
        suffix, reproducing training-style selection over the whole prompt.

        Exact for every chunk split: a token in the one-shot top
        ``k_for(T_total)`` has, within any prefix, rank at most
        ``k_for(T_total) <= capacity``; ``prefill`` and this method both
        store the CAPACITY-wide top of their candidate union at every
        boundary, so the union of {cached entries} and {suffix tokens}
        always holds the true selection.  The union top-k takes equal
        scores lower index first (``topk_indices``, the rule of
        ``lax.top_k``); the forced first token is boosted to 2.0 for the
        selection only.  The output uses the one-shot width
        ``min(k_for(L0 + T_valid), capacity)`` by rank-masking the union
        (ordered by score) in the suffix attention only; storage keeps the
        capacity-wide union.  Suffix queries attend the final selection
        under the index-causal mask, scaled by their router score, and the
        heads' outputs are scatter-added to the suffix positions."""
        if self.cfg.selection_granularity == "block":
            return self._prefill_past_block(x, cache, valid)
        c, cd = self.cfg, self.compute_dtype
        B, T, h = x.shape
        H, d = self.wq.shape[0], c.d_head    # this rank's heads
        kc = cache.k.shape[2]
        dev = x.device
        L0 = cache.length.long()                                 # (B,)
        nv = (torch.full((B,), T, dtype=torch.long, device=dev)
              if valid is None else valid.sum(-1).long())

        base_pos = L0[:, None] + torch.arange(T, device=dev)[None]
        idx_new = base_pos[:, None].expand(B, H, T)

        scores_new = self.router.scores(x)                       # (B, H, T)
        if valid is not None:
            scores_new = torch.where(valid[:, None, :], scores_new, -1.0)

        xc = x.to(cd)
        q_all = torch.einsum("bth,nhd->bntd", xc, self.wq.to(cd))
        k_all = torch.einsum("bth,nhd->bntd", xc, self.wk.to(cd))
        v_all = torch.einsum("bth,nhd->bntd", xc, self.wv.to(cd))
        q_all = self._rope(q_all, idx_new)
        k_all = self._rope(k_all, idx_new)

        # Union candidates: the cached prefix top-k (roped at their
        # original positions) and every suffix token; disjoint by
        # construction (cached idx < L0 <= suffix idx).
        scores_cat = torch.cat([cache.scores, scores_new], dim=-1)
        idx_cat = torch.cat([cache.idx.long(), idx_new], dim=-1)
        k_cat = torch.cat([cache.k.to(cd), k_all], dim=2)
        v_cat = torch.cat([cache.v.to(cd), v_all], dim=2)

        sel_scores = scores_cat
        if c.force_first_token:
            sel_scores = torch.where(idx_cat == 0, 2.0, sel_scores)
        j = topk_indices(sel_scores, kc)                         # (B, H, kc)
        r_sel = torch.gather(scores_cat, -1, j)
        idx_sel = torch.gather(idx_cat, -1, j)
        k_sel = _gather_rows(k_cat, j)
        v_sel = _gather_rows(v_cat, j)

        sel_ok = r_sel > 0.0          # -inf empties / -1.0 pads drop out
        total = L0 + nv
        if c.k_fixed > 0:
            k_eff = total.clamp(max=c.k_fixed)
        else:
            k_eff = torch.maximum(torch.minimum(total // c.sparsity, total),
                                  total.clamp(max=c.min_k))
        k_eff = k_eff.clamp(max=kc)
        rank_ok = sel_ok & (torch.arange(kc, device=dev)
                            < k_eff[:, None, None])
        r_st = torch.where(sel_ok, r_sel, float("-inf"))
        idx_st = torch.where(sel_ok, idx_sel, -1)
        order = torch.argsort(torch.where(idx_st < 0, INT32_MAX, idx_st),
                              dim=-1, stable=True)
        idx_st = torch.gather(idx_st, -1, order)
        r_st = torch.gather(r_st, -1, order)
        rank_ok = torch.gather(rank_ok, -1, order)
        k_sel = _gather_rows(k_sel, order)
        v_sel = _gather_rows(v_sel, order)

        # Suffix-query outputs over the final selection, queries and keys
        # rank-masked to the one-shot width.
        L0b = L0[:, None, None]
        is_suffix = rank_ok & (idx_st >= L0b) & (idx_st >= 0)
        t_j = (idx_st - L0b).clamp(0, T - 1)
        q_sel = _gather_rows(q_all, t_j)
        s = torch.einsum("bnqd,bnkd->bnqk", q_sel.float(),
                         k_sel.float()) * (d ** -0.5)
        mask = (selection_mask(idx_st, idx_st)
                & (idx_st >= 0)[:, :, None, :] & rank_ok[:, :, None, :])
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("bnqk,bnkd->bnqd", p.to(cd).float(),
                           v_sel.float())
        r_q = torch.where(is_suffix, r_st.clamp(min=0.0), 0.0)
        att = att * r_q[..., None]
        y_heads = torch.einsum("bnkd,ndh->bnkh", att.to(cd), self.wo.to(cd))

        # scatter-add the heads' suffix rows; non-suffix rows are dropped
        y = _scatter_heads(y_heads, torch.where(is_suffix, t_j, T), T)

        cache = MoSAKVCache(k_sel.to(cache.k.dtype), v_sel.to(cache.v.dtype),
                            r_st.float(), idx_st.to(cache.idx.dtype),
                            total.to(cache.length.dtype))
        return y, cache

    def prefill_packed(self, x, cache: MoSAKVCache, meta):
        """Packed multi-segment chunked prefill.  x: (1, C, h), a chunk of
        N prompt segments, each continuing a different batch row's cache;
        ``meta`` is the layout ``TransformerLM.prefill_packed`` builds
        (``rows`` (N,), -1 = inactive; ``tok_idx``/``in_seg`` (N, C), the
        unpack gather; ``seg_of_tok``/``local_of_tok``/``row_of_tok``
        (C,), the scatter back).

        Expert-choice selection is PER SEGMENT: the chunk is unpacked to an
        (N, C) right-padded batch and run through ``prefill_past`` with
        ``in_seg`` as ``valid``, then the touched rows are written back
        into the B-row cache IN PLACE (inactive segments are dropped).  A
        row appears at most once per chunk.  Either cache type: every field
        of ``MoSAKVCache`` and ``MoSABlockKVCache`` is batch-major."""
        B = cache.k.shape[0]
        rows = meta["rows"].long()
        rowc = rows.clamp(0, B - 1)
        gc = type(cache)(*(f[rowc] for f in cache))
        in_seg = meta["in_seg"]
        xs = x[0][meta["tok_idx"]] * in_seg[..., None].to(x.dtype)
        y_seg, gc2 = self.prefill_past(xs, gc, in_seg)

        keep = rows >= 0
        col = torch.zeros_like(rowc)
        for old, new in zip(cache, gc2):
            scatter_kept(old.unsqueeze(1), rowc, col, new.to(old.dtype), keep)
        segc = meta["seg_of_tok"].clamp(min=0)
        y = y_seg[segc, meta["local_of_tok"]]                    # (C, h)
        y = torch.where((meta["row_of_tok"] >= 0)[:, None], y, 0.0)
        return y[None].to(y_seg.dtype), cache

    def decode_step(self, x, cache: MoSAKVCache, positions=None):
        """Streaming expert-choice decode.  x: (B, 1, h).  The new token
        enters a head's top-k set iff its router score beats the current
        minimum (or it is the forced first token); slots are then re-sorted
        by original position, empty slots last."""
        if self.cfg.selection_granularity == "block":
            return self._decode_block(x, cache, positions)
        c, cd = self.cfg, self.compute_dtype
        B, _, h = x.shape
        H, d = self.wq.shape[0], c.d_head    # this rank's heads
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
        new_k = _gather_rows(new_k, order)
        new_v = _gather_rows(new_v, order)

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

    # ----------------------------------------------- block-choice serving
    def _prefill_block(self, x, cache: MoSABlockKVCache, positions=None,
                       valid=None):
        """Block-choice prefill: the output is the training-style forward;
        the cache holds the top ``CB`` COMPLETED blocks (their mean scores
        are final: streaming decode over the same prompt would hold the
        same) and the trailing partial block in the current slot with its
        running score sum.  Only the kept rows are projected to K/V (the
        JAX package projects the whole prompt and gathers; the values are
        the same), roped at their original positions."""
        c, cd = self.cfg, self.compute_dtype
        B, T, h = x.shape
        H = self.wq.shape[0]                 # this rank's heads
        bs, CB = cache.block_size, cache.n_cand
        nbt = -(-T // bs)
        kcb = min(CB, nbt)
        dev = x.device

        y = self(x, positions, valid)

        scores = self.router.scores(x)
        if valid is not None:
            scores = torch.where(valid[:, None, :], scores, -1.0)
        nv = (torch.full((B,), T, dtype=torch.long, device=dev)
              if valid is None else valid.sum(-1).long())
        cbf = nv // bs                                    # completed blocks

        bsc = block_pool_scores(scores, bs)               # (B, H, nbt)
        done = torch.arange(nbt, device=dev) < cbf[:, None, None]
        r, bidx = select_topk(torch.where(done, bsc, float("-inf")), kcb,
                              c.force_first_token)
        sel_ok = r > 0.0     # not completed, or forced but absent: dropped
        r_st = torch.where(sel_ok, r, float("-inf"))
        b_st = torch.where(sel_ok, bidx, -1)
        order = torch.argsort(torch.where(b_st < 0, INT32_MAX, b_st), dim=-1,
                              stable=True)
        b_st = torch.gather(b_st, -1, order)
        r_st = torch.gather(r_st, -1, order)
        if CB > kcb:
            r_st = nn.functional.pad(r_st, (0, CB - kcb), value=float("-inf"))
            b_st = nn.functional.pad(b_st, (0, CB - kcb), value=-1)

        # candidate rows: the selected completed blocks' token runs, then
        # the current block [cbf*bs, nv)
        rows_pos = _block_rows(b_st, bs)                  # (B, H, CB*bs)
        row_ok = _per_token(b_st >= 0, bs)
        cur_pos = (cbf[:, None] * bs
                   + torch.arange(bs, device=dev))[:, None].expand(B, H, bs)
        cur_ok = cur_pos < nv[:, None, None]
        rows = torch.cat([rows_pos, cur_pos], -1).clamp(0, T - 1)
        xs = _gather_tokens(x.to(cd), rows)
        kk = self._rope(self._proj(xs, self.wk), rows)
        v = self._proj(xs, self.wv)

        has_cur = (nv % bs) > 0
        bidx_cur = torch.where(has_cur, cbf, -1)[:, None, None].expand(B, H, 1)
        t_ar = torch.arange(T, device=dev)
        in_cur = ((t_ar >= cbf[:, None] * bs) & (t_ar < nv[:, None]))
        bsum = torch.where(in_cur[:, None], scores, 0.0).sum(-1)
        new = MoSABlockKVCache(
            kk.to(cache.k.dtype), v.to(cache.v.dtype),
            torch.cat([torch.where(row_ok, rows_pos, -1),
                       torch.where(cur_ok, cur_pos, -1)], -1),
            torch.cat([r_st.float(), torch.full((B, H, 1), float("-inf"),
                                                device=dev)], -1),
            torch.cat([b_st, bidx_cur], -1),
            bsum.float(), cache.length + nv.to(cache.length.dtype))
        return y, new

    def _prefill_past_block(self, x, cache: MoSABlockKVCache, valid=None):
        """Block-choice continued prefill: extend a cached prefix with a
        prompt suffix.  At a block-aligned boundary the cache state is what
        a longer one-shot prefill holds for the same prefix (candidates are
        completed blocks, the current slot is empty), so chunked prefill and
        prefix-cache hits are exact.  A block in the final
        top-``kb_for(total)`` has prefix rank <= ``kb_for(total) <= CB``, so
        capacity-wide storage never drops it.  The suffix may straddle the
        cache's partial current block: its running ``bsum`` carries the
        block's head, and the old current rows are stitched in front of the
        suffix K/V.  Suffix outputs reproduce the one-shot forward over the
        whole prompt restricted to suffix queries: block scores of the
        union pool (old candidates + every suffix-touched block, the last
        one at its partial mean), the force boost on block 0, rank-masked to
        the one-shot width ``kb_for(L0 + nv)``."""
        c, cd = self.cfg, self.compute_dtype
        B, T, h = x.shape
        H, d = self.wq.shape[0], c.d_head    # this rank's heads
        bs, CB = cache.block_size, cache.n_cand
        NSB = -(-T // bs) + 1        # blocks the suffix can straddle
        dev = x.device
        off = torch.arange(bs, device=dev)
        nsb = torch.arange(NSB, device=dev)
        L0 = cache.length.long()                                 # (B,)
        nv = (torch.full((B,), T, dtype=torch.long, device=dev)
              if valid is None else valid.sum(-1).long())
        total = L0 + nv
        base0 = L0 // bs

        base_pos = L0[:, None] + torch.arange(T, device=dev)[None]
        idx_new = base_pos[:, None].expand(B, H, T)
        scores_new = self.router.scores(x)                       # (B, H, T)
        vmask = (torch.ones((B, T), dtype=torch.bool, device=dev)
                 if valid is None else valid)

        xc = x.to(cd)
        q_all = self._rope(torch.einsum("bth,nhd->bntd", xc, self.wq.to(cd)),
                           idx_new)
        k_all = self._rope(torch.einsum("bth,nhd->bntd", xc, self.wk.to(cd)),
                           idx_new)
        v_all = torch.einsum("bth,nhd->bntd", xc, self.wv.to(cd))

        # per-relative-block score sums and counts over the suffix tokens
        rel = base_pos // bs - base0[:, None]                    # (B, T)
        oh = (rel[..., None] == nsb).float() * vmask[..., None]  # (B,T,NSB)
        sums = torch.einsum("bnt,btj->bnj", scores_new, oh)      # (B,H,NSB)
        is0 = (nsb == 0).float()
        tot_cnt = oh.sum(1) + is0 * (L0 % bs).float()[:, None]   # (B, NSB)
        tot_sum = sums + is0 * cache.bsum[..., None]
        done_new = (base0[:, None] + nsb + 1) * bs <= total[:, None]
        # one-shot mean: final for completed blocks, partial for the last
        out_new = torch.where(tot_cnt[:, None] > 0,
                              tot_sum / tot_cnt[:, None].clamp(min=1.0),
                              float("-inf"))                      # (B,H,NSB)
        cand_new = torch.where(done_new[:, None], out_new, float("-inf"))

        # K/V rows of the suffix-touched blocks: row (j, o) holds position
        # (base0 + j)*bs + o, from the cache's old current slot before L0,
        # else from the suffix projections
        p_new = ((base0[:, None, None] + nsb[None, :, None]) * bs
                 + off).reshape(B, NSB * bs)
        from_old = (p_new < L0[:, None])[:, None, :, None]
        t_suf = (p_new - L0[:, None]).clamp(0, T - 1)[:, None].expand(
            B, H, NSB * bs)
        o_pat = off.repeat(NSB)
        k_new_rows = torch.where(from_old, cache.k[:, :, CB * bs:].to(cd)[
            :, :, o_pat], _gather_rows(k_all, t_suf))
        v_new_rows = torch.where(from_old, cache.v[:, :, CB * bs:].to(cd)[
            :, :, o_pat], _gather_rows(v_all, t_suf))
        pos_new_rows = torch.where(p_new < total[:, None], p_new, -1)[
            :, None].expand(B, H, NSB * bs)

        # union pool: old candidates + suffix-touched blocks (disjoint and
        # ascending in block index by construction)
        P = CB + NSB
        pool_sc = torch.cat([cache.bscore[..., :CB], out_new], -1)
        pool_bi = torch.cat([cache.bidx[..., :CB], (base0[:, None] + nsb)[
            :, None].expand(B, H, NSB)], -1)
        pool_k = torch.cat([cache.k[:, :, :CB * bs].to(cd), k_new_rows], 2)
        pool_v = torch.cat([cache.v[:, :, :CB * bs].to(cd), v_new_rows], 2)
        pool_pos = torch.cat([cache.pos[:, :, :CB * bs], pos_new_rows], 2)

        # candidate STORAGE: capacity-wide top-CB over completed blocks
        stor_sc = torch.cat([cache.bscore[..., :CB], cand_new], -1)
        stor_sel = stor_sc
        if c.force_first_token:
            stor_sel = torch.where(pool_bi == 0, 2.0, stor_sel)
        jst = topk_indices(stor_sel, CB)
        r_stor = torch.gather(stor_sc, -1, jst)
        b_stor = torch.gather(pool_bi, -1, jst)
        sel_ok = r_stor > 0.0
        r_stor = torch.where(sel_ok, r_stor, float("-inf"))
        b_stor = torch.where(sel_ok, b_stor, -1)
        order = torch.argsort(torch.where(b_stor < 0, INT32_MAX, b_stor),
                              dim=-1, stable=True)
        b_stor = torch.gather(b_stor, -1, order)
        r_stor = torch.gather(r_stor, -1, order)
        rows_st = _block_rows(torch.gather(jst, -1, order), bs)
        ck = _gather_rows(pool_k, rows_st)
        cv = _gather_rows(pool_v, rows_st)
        cp = torch.where(_per_token(b_stor >= 0, bs),
                         torch.gather(pool_pos, -1, rows_st), -1)

        # new current slot: the (possibly partial) block at total
        cbn = total // bs
        jcur = (cbn - base0)[:, None, None].expand(B, H, 1)
        rows_cur = _block_rows(jcur, bs)                        # (B, H, bs)
        cur_k = _gather_rows(k_new_rows, rows_cur)
        cur_v = _gather_rows(v_new_rows, rows_cur)
        cur_pos = torch.gather(pos_new_rows, -1, rows_cur)
        has_cur = (total % bs) > 0
        bsum_new = torch.where(has_cur[:, None],
                               torch.gather(tot_sum, -1, jcur)[..., 0], 0.0)
        bidx_cur = torch.where(has_cur, cbn, -1)[:, None, None].expand(B, H, 1)

        # suffix-query outputs over the rank-masked one-shot selection
        out_sel = pool_sc
        if c.force_first_token:
            out_sel = torch.where(pool_bi == 0, 2.0, out_sel)
        jo = topk_indices(out_sel, P)                         # full order
        r_o = torch.gather(pool_sc, -1, jo)
        if c.k_fixed > 0:
            k_eff = total.clamp(max=c.k_fixed)
        else:
            k_eff = torch.maximum(torch.minimum(total // c.sparsity, total),
                                  total.clamp(max=c.min_k))
        kb_eff = torch.minimum((k_eff + bs - 1) // bs, (total + bs - 1) // bs)
        rank_ok = (r_o > 0.0) & (torch.arange(P, device=dev)
                                 < kb_eff[:, None, None])
        rows_o = _block_rows(jo, bs)
        kk_o = _gather_rows(pool_k, rows_o)
        vv_o = _gather_rows(pool_v, rows_o)
        pos_o = torch.gather(pool_pos, -1, rows_o)
        ok_row = _per_token(rank_ok, bs) & (pos_o >= 0)
        L0b = L0[:, None, None]
        is_suffix = ok_row & (pos_o >= L0b)
        t_j = (pos_o - L0b).clamp(0, T - 1)
        q_sel = _gather_rows(q_all, t_j)
        s = torch.einsum("bnqd,bnkd->bnqk", q_sel.float(),
                         kk_o.float()) * (d ** -0.5)
        mask = selection_mask(pos_o, pos_o) & ok_row[:, :, None, :]
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("bnqk,bnkd->bnqd", p.to(cd).float(), vv_o.float())
        r_q = torch.where(is_suffix, _per_token(r_o, bs).clamp(min=0.0), 0.0)
        att = att * r_q[..., None]
        y_heads = torch.einsum("bnkd,ndh->bnkh", att.to(cd), self.wo.to(cd))
        y = _scatter_heads(y_heads, torch.where(is_suffix, t_j, T), T)

        new = MoSABlockKVCache(
            torch.cat([ck, cur_k], 2).to(cache.k.dtype),
            torch.cat([cv, cur_v], 2).to(cache.v.dtype),
            torch.cat([cp, cur_pos], 2),
            torch.cat([r_stor.float(), torch.full((B, H, 1), float("-inf"),
                                                  device=dev)], -1),
            torch.cat([b_stor, bidx_cur], -1),
            bsum_new.float(), total.to(cache.length.dtype))
        return y, new

    def _decode_block(self, x, cache: MoSABlockKVCache, positions=None):
        """Streaming block-choice decode, one token per row, before the
        attention (so the token attends itself):

          1. write its K/V into current-slot row ``t % bs`` and add its
             router score to ``bsum``;
          2. if that completes the block, its mean is final: run
             ``streaming_topk_update`` over the candidates, copy the current
             rows into the evicted slot where the block got in, re-sort the
             candidates by block index (stable, empty slots last), and reset
             the current slot;
          3. attend every valid row (``pos >= 0``): candidates and the block
             being built;
          4. scale by the query block's score: final mean x selected on
             completion, the running mean otherwise."""
        c, cd = self.cfg, self.compute_dtype
        B = x.shape[0]
        H, d = self.wq.shape[0], c.d_head    # this rank's heads
        bs, CB = cache.block_size, cache.n_cand
        R = (CB + 1) * bs
        dev = x.device
        t = (cache.length if positions is None else positions[:, 0]).long()

        x0 = x[:, 0].to(cd)
        score = self.router.scores(x)[..., 0]                     # (B, H)
        q = torch.einsum("bh,nhd->bnd", x0, self.wq.to(cd))
        kk = torch.einsum("bh,nhd->bnd", x0, self.wk.to(cd))
        v = torch.einsum("bh,nhd->bnd", x0, self.wv.to(cd))
        pos_t = t[:, None, None].expand(B, H, 1)
        q = self._rope(q[:, :, None], pos_t)[:, :, 0]
        kk = self._rope(kk[:, :, None], pos_t)[:, :, 0]

        # 1. the current-slot row t % bs
        hit = torch.arange(R, device=dev) == (CB * bs + t % bs)[:, None]
        m = hit[:, None, :, None]
        k2 = torch.where(m, kk[:, :, None].to(cache.k.dtype), cache.k)
        v2 = torch.where(m, v[:, :, None].to(cache.v.dtype), cache.v)
        pos2 = torch.where(hit[:, None], t[:, None, None], cache.pos)
        bsum2 = cache.bsum + score
        cur_blk = t // bs

        # 2. completion: the evict-min policy shared with token choice
        completed = (t + 1) % bs == 0                             # (B,)
        final = bsum2 / bs
        is_forced = ((cur_blk == 0) & completed
                     & c.force_first_token)[:, None]
        selected, slot, nbs, nbi = streaming_topk_update(
            cache.bscore[..., :CB], cache.bidx[..., :CB], final,
            cur_blk[:, None].expand(B, H), is_forced)
        sel_flag = selected & completed[:, None]
        comp = completed[:, None, None]
        cand_sc = torch.where(comp, nbs, cache.bscore[..., :CB])
        cand_bi = torch.where(comp, nbi, cache.bidx[..., :CB])

        cur_k, cur_v = k2[:, :, CB * bs:], v2[:, :, CB * bs:]
        cur_pos = pos2[:, :, CB * bs:]
        hit_slot = ((torch.arange(CB, device=dev) == slot[..., None])
                    & sel_flag[..., None])                        # (B,H,CB)
        ck = torch.where(hit_slot[..., None, None], cur_k[:, :, None],
                         k2[:, :, :CB * bs].unflatten(2, (CB, bs)))
        cv = torch.where(hit_slot[..., None, None], cur_v[:, :, None],
                         v2[:, :, :CB * bs].unflatten(2, (CB, bs)))
        cp = torch.where(hit_slot[..., None], cur_pos[:, :, None],
                         pos2[:, :, :CB * bs].unflatten(2, (CB, bs)))

        # re-sort the candidates by block index, empty slots last
        order = torch.argsort(torch.where(cand_bi < 0, INT32_MAX, cand_bi),
                              dim=-1, stable=True)
        cand_bi = torch.gather(cand_bi, -1, order)
        cand_sc = torch.gather(cand_sc, -1, order)
        row_perm = _block_rows(order, bs)
        ck = _gather_rows(ck.flatten(2, 3), row_perm)
        cv = _gather_rows(cv.flatten(2, 3), row_perm)
        cp = torch.gather(cp.flatten(2, 3), -1, row_perm)

        # 4'. the query block's scale, before the current slot resets
        cnt = (t % bs).float() + 1.0
        r_q = torch.where(completed[:, None], final * sel_flag.float(),
                          bsum2 / cnt[:, None])                   # (B, H)
        cur_pos = torch.where(comp, -1, cur_pos)
        bsum3 = torch.where(completed[:, None], 0.0, bsum2)
        bidx_cur = torch.where(completed, -1, cur_blk)[:, None, None].expand(
            B, H, 1)

        # 3. attention over every valid row
        k_full = torch.cat([ck, cur_k], 2)
        v_full = torch.cat([cv, cur_v], 2)
        pos_full = torch.cat([cp, cur_pos], 2)
        s = torch.einsum("bnd,bnkd->bnk", q.float(),
                         k_full.float()) * (d ** -0.5)
        s = torch.where(pos_full >= 0, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("bnk,bnkd->bnd", p.to(cd).float(), v_full.float())
        att = att * r_q[..., None]
        y = torch.einsum("bnd,ndh->bh", att.to(cd), self.wo.to(cd))

        new = MoSABlockKVCache(
            k_full, v_full, pos_full,
            torch.cat([cand_sc, torch.full((B, H, 1), float("-inf"),
                                           device=dev)], -1),
            torch.cat([cand_bi, bidx_cur], -1), bsum3, cache.length + 1)
        return y[:, None], new
