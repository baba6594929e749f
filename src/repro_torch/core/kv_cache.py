"""Contiguous KV caches for serving (port of ``repro.core.kv_cache``).

  * ``DenseKVCache`` — (B, S, Hkv, d) append cache with per-row ``length``.
  * ``MoSAKVCache``  — each MoSA head keeps only its running top-k tokens;
    KV memory per head is O(k), independent of context length.  Empty-slot
    sentinels: ``scores == -inf`` and ``idx == -1``; ``idx`` stays sorted
    ascending with empty slots last.

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
