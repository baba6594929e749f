"""Contiguous KV caches for serving (port of ``repro.core.kv_cache``).

  * ``DenseKVCache`` — (B, S, Hkv, d) append cache with per-row ``length``.
  * ``WindowKVCache`` — ring buffer of the last ``W`` tokens (the sliding-
    window dense heads): position ``p`` lives at slot ``p % W``.
  * ``MoSAKVCache``  — each MoSA head keeps only its running top-k tokens;
    KV memory per head is O(k), independent of context length.  Empty-slot
    sentinels: ``scores == -inf`` and ``idx == -1``; ``idx`` stays sorted
    ascending with empty slots last.
  * ``MoSABlockKVCache`` — the block-choice form: each MoSA head keeps its
    running top ``CB`` KV blocks of ``sel_block_size`` tokens plus the
    block being streamed.

The dense/paged appends write into the existing tensors IN PLACE (the JAX
package returns fresh arrays): a serving cache has one owner, and copying
a (B, S, Hkv, d) slab per token would double the decode traffic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def scatter_kept(dst, i0, i1, vals, keep):
    """``dst[i0, i1] = vals`` where ``keep``, dropping the other writes,
    without a device-to-host sync (a boolean-mask index would need one).

    i0, i1, keep: (M,); vals: (M, ...).  A dropped entry repeats the first
    kept entry's write (same index, same value), so every written index
    still receives exactly one value; when nothing is kept, dropped entries
    rewrite ``dst[0, 0]`` with its own value."""
    if keep.numel() == 0:
        return
    any_kept = keep.any()
    first = keep.to(torch.int32).argmax()
    t0 = torch.where(keep, i0, torch.where(any_kept, i0[first], 0))
    t1 = torch.where(keep, i1, torch.where(any_kept, i1[first], 0))
    fill = torch.where(any_kept, vals[first].to(dst.dtype), dst[0, 0])
    mask = keep.view(-1, *([1] * (vals.dim() - 1)))
    dst[t0, t1] = torch.where(mask, vals.to(dst.dtype), fill)


def cache_nbytes(tree) -> int:
    """Total bytes of every tensor in a cache structure (a layer's cache, a
    model's list of them, or any nesting of lists, tuples, NamedTuples and
    dicts): the serving-side KV-memory metric, as the JAX package's
    ``cache_nbytes`` sums a cache pytree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(cache_nbytes(x) for x in tree)
    return 0


class DenseKVCache(NamedTuple):
    k: torch.Tensor        # (B, S, Hkv, d)
    v: torch.Tensor        # (B, S, Hkv, d)
    length: torch.Tensor   # (B,) int32 — tokens filled

    @classmethod
    def create(cls, batch, max_len, n_kv_heads, d_head, dtype=torch.bfloat16,
               device=None):
        shape = (batch, max_len, n_kv_heads, d_head)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))

    def append(self, k_new, v_new, n_valid=None):
        """k_new/v_new: (B, Tnew, Hkv, d).  Row b writes at positions
        ``length[b] + t``; writes past the cache end are dropped.
        ``n_valid`` (B,): real (non right-pad) token count — all Tnew rows
        are written, ``length`` advances by ``n_valid``."""
        B, Tnew = k_new.shape[:2]
        S = self.k.shape[1]
        pos = self.length.long()[:, None] + torch.arange(
            Tnew, device=k_new.device)
        rows = torch.arange(B, device=k_new.device)[:, None].expand(B, Tnew)
        ok = (pos < S).reshape(-1)
        rows, pos = rows.reshape(-1), pos.reshape(-1).clamp(max=S - 1)
        scatter_kept(self.k, rows, pos, k_new.reshape(B * Tnew, *k_new.shape[2:]), ok)
        scatter_kept(self.v, rows, pos, v_new.reshape(B * Tnew, *v_new.shape[2:]), ok)
        adv = Tnew if n_valid is None else n_valid.to(torch.int32)
        return DenseKVCache(self.k, self.v, self.length + adv)


class WindowKVCache(NamedTuple):
    k: torch.Tensor          # (B, W, Hkv, d) ring buffer
    v: torch.Tensor
    positions: torch.Tensor  # (B, W) int32 original positions; -1 = empty
    length: torch.Tensor     # (B,) int32 — tokens seen

    @classmethod
    def create(cls, batch, window, n_kv_heads, d_head, dtype=torch.bfloat16,
               device=None):
        shape = (batch, window, n_kv_heads, d_head)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.full((batch, window), -1, dtype=torch.int32,
                              device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))

    def append_one(self, k_new, v_new):
        """k_new/v_new: (B, Hkv, d) — one decode step; row b writes slot
        ``length[b] % W`` (rows may sit at different positions)."""
        B, W = self.positions.shape
        rows = torch.arange(B, device=k_new.device)
        slot = self.length.long() % W
        self.k[rows, slot] = k_new.to(self.k.dtype)
        self.v[rows, slot] = v_new.to(self.v.dtype)
        self.positions[rows, slot] = self.length
        return WindowKVCache(self.k, self.v, self.positions, self.length + 1)


class MoSAKVCache(NamedTuple):
    """Streaming expert-choice cache: one top-k set per (batch, head).  The
    evict-min policy lives in ``repro_torch.core.router``."""

    k: torch.Tensor        # (B, H, k, d) selected keys
    v: torch.Tensor        # (B, H, k, d) selected values
    scores: torch.Tensor   # (B, H, k) fp32 router scores; -inf = empty slot
    idx: torch.Tensor      # (B, H, k) original positions; -1 = empty
    length: torch.Tensor   # (B,) tokens seen

    @classmethod
    def create(cls, batch, n_heads, k, d_head, dtype=torch.bfloat16,
               device=None):
        return cls(
            torch.zeros((batch, n_heads, k, d_head), dtype=dtype,
                        device=device),
            torch.zeros((batch, n_heads, k, d_head), dtype=dtype,
                        device=device),
            torch.full((batch, n_heads, k), float("-inf"),
                       dtype=torch.float32, device=device),
            torch.full((batch, n_heads, k), -1, dtype=torch.long,
                       device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device))


class MoSABlockKVCache(NamedTuple):
    """Streaming block-choice cache: per (batch, head) ``CB`` candidate KV
    blocks of ``bs`` tokens and one slot for the current, partial block.

      * ``k``/``v``  — (B, H, (CB+1)*bs, d) token rows, block-major: rows
        ``[s*bs, (s+1)*bs)`` belong to slot ``s``; slot ``CB`` (the last) is
        the current block;
      * ``pos``      — (B, H, (CB+1)*bs) original position per row, -1 for
        an empty row (attention masks to ``pos >= 0``);
      * ``bscore``   — (B, H, CB+1) fp32 mean router score per block, -inf
        for an empty slot (slot ``CB``'s entry stays -inf);
      * ``bidx``     — (B, H, CB+1) block index, -1 = empty; candidates
        sorted ascending with empty slots last, slot ``CB`` the current
        block's index (-1 before its first token);
      * ``bsum``     — (B, H) fp32 running sum of the current block's scores;
      * ``length``   — (B,) tokens seen.

    Only completed blocks, whose mean score is final, enter the candidates,
    so a snapshot at a block boundary is a function of the prefix alone
    (what a prefix-cache hit restores).  Eviction is
    ``streaming_topk_update`` over ``bscore``, as for ``MoSAKVCache``."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    bscore: torch.Tensor
    bidx: torch.Tensor
    bsum: torch.Tensor
    length: torch.Tensor

    @classmethod
    def create(cls, batch, n_heads, cb, block_size, d_head,
               dtype=torch.bfloat16, device=None):
        rows = (cb + 1) * block_size
        kw = dict(device=device)
        return cls(
            torch.zeros((batch, n_heads, rows, d_head), dtype=dtype, **kw),
            torch.zeros((batch, n_heads, rows, d_head), dtype=dtype, **kw),
            torch.full((batch, n_heads, rows), -1, dtype=torch.long, **kw),
            torch.full((batch, n_heads, cb + 1), float("-inf"),
                       dtype=torch.float32, **kw),
            torch.full((batch, n_heads, cb + 1), -1, dtype=torch.long, **kw),
            torch.zeros((batch, n_heads), dtype=torch.float32, **kw),
            torch.zeros((batch,), dtype=torch.int32, **kw))

    @property
    def block_size(self) -> int:
        return self.k.shape[2] // self.bidx.shape[2]

    @property
    def n_cand(self) -> int:
        """CB: the candidate block slots, without the current one."""
        return self.bidx.shape[2] - 1

    @property
    def kv_entries(self) -> int:
        """H * (CB+1) * bs: the paper's KV metric for this cache."""
        return self.k.shape[1] * self.k.shape[2]
