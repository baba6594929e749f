"""Block-paged dense and window KV caches (port of ``repro.serve.paged_kv``).

KV lives in fixed-size blocks of ``block_size`` tokens inside a pool
``(N, block_size, Hkv, d)``; a per-row block table maps logical block
``pos // block_size`` to a physical block id (``-1`` = unallocated).
``append`` / ``gather`` reproduce the contiguous ``DenseKVCache`` and
``WindowKVCache`` semantics: ``gather()`` equals the contiguous cache at
every valid position (the window ring in its ring layout).  Writes through
an unallocated (``-1``) table entry are dropped.

Appends write the pools IN PLACE (see ``repro_torch.core.kv_cache``).

``BlockPool`` is the host-side allocator the ``Scheduler`` drives: free
list, per-block refcounts (prefix blocks shared through
``repro_torch.serve.prefix_cache``), copy-on-write ``ensure_owned``.  Pure
Python.  ``Server.generate`` keeps identity block tables (auto-sized
pools); a Scheduler's server passes an explicit budget (``num_blocks >
0``), and its tables start unallocated (-1).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import torch

from repro_torch.core.kv_cache import scatter_kept
from repro_torch.dist.sharding import register_cache_axes
from repro_torch.obs.metrics import registry as _obs_registry


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Static paged-cache geometry.  ``num_blocks == 0`` auto-sizes the
    dense pool to the contiguous worst case (``batch * ceil(max_len /
    block_size)``) with identity block tables; ``num_window_blocks == 0``
    does the same for the window rings (``batch * W / block_size``)."""

    block_size: int = 16
    num_blocks: int = 0          # dense-group pool size (0 = worst case)
    num_window_blocks: int = 0   # window-group pool size (0 = worst case)


class BlockPool:
    """Host-side free-list allocator with refcounted blocks.

    Refcounts implement prefix sharing: a block referenced by the prefix
    trie AND by live requests has ``ref > 1``; freeing decrements and the
    block returns to the free list only at zero.  ``ensure_owned`` is the
    copy-on-write primitive: a caller about to MUTATE a block gets a fresh
    private id back — plus a flag telling it to copy the payload
    (``copy_blocks``) — whenever the block is shared."""

    def __init__(self, num_blocks: int, block_size: int,
                 name: str = "blocks"):
        assert num_blocks >= 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.name = name             # metrics namespace: pool.<name>.*
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def refcount(self, bid: int) -> int:
        return self._ref[bid]

    def _publish(self) -> None:
        """Mirror occupancy into the obs registry: utilization gauges plus
        a live-blocks high-water mark."""
        reg = _obs_registry()
        if not reg.enabled:
            return
        live = self.num_blocks - len(self._free)
        reg.set(f"pool.{self.name}.free_blocks", len(self._free))
        reg.set(f"pool.{self.name}.live_blocks", live)
        reg.set_max(f"pool.{self.name}.live_high_water", live)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh blocks at ref 1, or None (all-or-nothing)."""
        if n < 0 or n > len(self._free):
            _obs_registry().inc(f"pool.{self.name}.alloc_failures")
            return None
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._ref[b] = 1
        _obs_registry().inc(f"pool.{self.name}.allocs", n)
        self._publish()
        return ids

    def incref(self, ids: Sequence[int]) -> None:
        hi = 0
        for b in ids:
            assert self._ref[b] > 0, f"incref of free block {b}"
            self._ref[b] += 1
            if self._ref[b] > hi:
                hi = self._ref[b]
        if ids:
            _obs_registry().set_max(
                f"pool.{self.name}.refcount_high_water", hi)

    def decref(self, ids: Sequence[int]) -> None:
        for b in ids:
            assert self._ref[b] > 0, f"double free of block {b}"
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
        if ids:
            self._publish()

    def ensure_owned(self, bid: int) -> Optional[tuple]:
        """(owned_id, needs_copy).  Shared blocks come back as a fresh
        allocation (the caller copies ``bid -> owned_id`` on the device and
        swaps its table entry); exclusive blocks come back unchanged.  None
        if the pool is exhausted (the caller preempts)."""
        assert self._ref[bid] > 0, f"ensure_owned of free block {bid}"
        if self._ref[bid] == 1:
            return bid, False
        got = self.alloc(1)
        if got is None:
            return None
        self.decref([bid])
        _obs_registry().inc(f"pool.{self.name}.cow_copies")
        return got[0], True


def _blocks_for(tokens: int, block_size: int) -> int:
    return -(-tokens // block_size)


class PagedDenseKVCache(NamedTuple):
    k: torch.Tensor            # (N, bs, Hkv, d) physical pool
    v: torch.Tensor            # (N, bs, Hkv, d)
    block_table: torch.Tensor  # (B, max_blocks) int32; -1 = unallocated
    length: torch.Tensor       # (B,) int32 — tokens filled

    @classmethod
    def create(cls, batch, max_len, n_kv_heads, d_head, dtype=torch.bfloat16,
               *, block_size: int = 16, num_blocks: int = 0,
               identity_tables: bool = False, device=None):
        nb = _blocks_for(max_len, block_size)
        n = num_blocks or batch * nb
        shape = (n, block_size, n_kv_heads, d_head)
        if identity_tables:
            # row r owns blocks [r*nb, (r+1)*nb) — the no-allocator layout
            # Server.generate uses for whole-batch prefill + decode.
            if n < batch * nb:
                raise ValueError(f"pool of {n} blocks cannot hold identity "
                                 f"tables for {batch} x {nb}")
            table = torch.arange(batch * nb, dtype=torch.int32,
                                 device=device).reshape(batch, nb)
        else:
            table = torch.full((batch, nb), -1, dtype=torch.int32,
                               device=device)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   table,
                   torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def block_size(self) -> int:
        return self.k.shape[1]

    def append(self, k_new, v_new, n_valid=None):
        """k_new/v_new: (B, Tnew, Hkv, d).  ``n_valid`` (B,): real token
        count per row — writes past ``length + n_valid`` are dropped and
        ``length`` advances by ``n_valid``."""
        B, Tnew = k_new.shape[:2]
        bs = self.block_size
        nbt = self.block_table.shape[1]
        dev = k_new.device
        pos = self.length.long()[:, None] + torch.arange(Tnew, device=dev)
        lb = pos // bs
        blk = torch.gather(self.block_table.long(), 1, lb.clamp(0, nbt - 1))
        keep = (lb < nbt) & (blk >= 0)
        if n_valid is not None:
            nv = n_valid.to(torch.int32)
            keep &= torch.arange(Tnew, device=dev)[None] < nv[:, None]
            adv = nv
        else:
            adv = Tnew
        blk, off, keep = blk.reshape(-1), (pos % bs).reshape(-1), keep.reshape(-1)
        rest = k_new.shape[2:]
        scatter_kept(self.k, blk, off, k_new.reshape(B * Tnew, *rest), keep)
        scatter_kept(self.v, blk, off, v_new.reshape(B * Tnew, *rest), keep)
        return PagedDenseKVCache(self.k, self.v, self.block_table,
                                 self.length + adv)

    def append_packed(self, k_new, v_new, row_of_tok, pos_of_tok):
        """Packed-varlen append, the write primitive of chunked prefill.
        k_new/v_new: (total, Hkv, d); row_of_tok (total,): the batch row of
        each token (-1 = padding, dropped); pos_of_tok (total,): the
        token's absolute position in its row's KV space.  Writes through a
        -1 table entry or past the table are dropped; each row's ``length``
        advances by its token count in the stream."""
        bs = self.block_size
        B, nbt = self.block_table.shape
        row = row_of_tok.long()
        pos = pos_of_tok.long()
        lb = pos // bs
        blk = self.block_table.long()[row.clamp(0, B - 1), lb.clamp(0, nbt - 1)]
        keep = (row >= 0) & (lb < nbt) & (blk >= 0)
        scatter_kept(self.k, blk, pos % bs, k_new, keep)
        scatter_kept(self.v, blk, pos % bs, v_new, keep)
        counts = torch.zeros(B + 1, dtype=torch.int32, device=row.device)
        counts.index_add_(0, torch.where(row < 0, B, row),
                          torch.ones_like(row, dtype=torch.int32))
        return PagedDenseKVCache(self.k, self.v, self.block_table,
                                 self.length + counts[:B])

    def gather(self):
        """(k, v) in the contiguous (B, S, Hkv, d) layout."""
        bt = self.block_table.long().clamp(min=0)  # -1 -> junk, masked by length
        B, nb = bt.shape
        S = nb * self.block_size
        kk = self.k[bt].reshape(B, S, *self.k.shape[2:])
        vv = self.v[bt].reshape(B, S, *self.v.shape[2:])
        return kk, vv


class PagedWindowKVCache(NamedTuple):
    """Paged counterpart of ``WindowKVCache`` (ring of the last W tokens).
    The ring arithmetic is the contiguous cache's: the token at position
    ``p`` lives at slot ``p % W``, physically at
    ``pool[table[b, slot // bs], slot % bs]``, so ``gather()`` returns the
    exact ``(B, W, Hkv, d)`` ring ``WindowKVCache.k`` holds.  W must be a
    multiple of ``block_size``.  Ring blocks are overwritten in place as
    the window slides.  (The JAX class's ``append_packed`` has no caller
    there — packed window prefill unpacks the segments — and is not
    ported.)"""

    k: torch.Tensor            # (N, bs, Hkv, d) physical pool
    v: torch.Tensor
    block_table: torch.Tensor  # (B, W // bs) int32; -1 = unallocated
    positions: torch.Tensor    # (B, W) int32 original positions; -1 = empty
    length: torch.Tensor       # (B,) int32 — tokens seen

    @classmethod
    def create(cls, batch, window, n_kv_heads, d_head, dtype=torch.bfloat16,
               *, block_size: int = 16, num_blocks: int = 0,
               identity_tables: bool = False, device=None):
        if window % block_size:
            raise ValueError(f"window {window} must be a multiple of "
                             f"block_size {block_size} (ring slots map to "
                             f"blocks by slot // block_size)")
        wb = window // block_size
        n = num_blocks or batch * wb
        shape = (n, block_size, n_kv_heads, d_head)
        if identity_tables:
            if n < batch * wb:
                raise ValueError(f"pool of {n} blocks cannot hold identity "
                                 f"tables for {batch} x {wb}")
            table = torch.arange(batch * wb, dtype=torch.int32,
                                 device=device).reshape(batch, wb)
        else:
            table = torch.full((batch, wb), -1, dtype=torch.int32,
                               device=device)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   table,
                   torch.full((batch, window), -1, dtype=torch.int32,
                              device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def block_size(self) -> int:
        return self.k.shape[1]

    @property
    def window(self) -> int:
        return self.positions.shape[1]

    def _write(self, k_vals, v_vals, pos, drop):
        """Write (B, T) tokens at ring slots ``pos % W`` in place; ``drop``
        (B, T) masks writes (a -1 table entry drops the KV write too)."""
        W, bs = self.window, self.block_size
        B, T = pos.shape
        pos = pos.long()
        slot = pos % W
        blk = torch.gather(self.block_table.long(), 1, slot // bs)
        keep = (~drop & (blk >= 0)).reshape(-1)
        blk, off = blk.reshape(-1), (slot % bs).reshape(-1)
        rest = k_vals.shape[2:]
        scatter_kept(self.k, blk, off, k_vals.reshape(B * T, *rest), keep)
        scatter_kept(self.v, blk, off, v_vals.reshape(B * T, *rest), keep)
        rows = torch.arange(B, device=pos.device)[:, None].expand(B, T)
        scatter_kept(self.positions, rows.reshape(-1), slot.reshape(-1),
                     pos.reshape(-1), (~drop).reshape(-1))

    def append_one(self, k_new, v_new):
        """k_new/v_new: (B, Hkv, d) — one decode step, per-row slots."""
        pos = self.length[:, None]
        self._write(k_new[:, None], v_new[:, None], pos,
                    torch.zeros_like(pos, dtype=torch.bool))
        return PagedWindowKVCache(self.k, self.v, self.block_table,
                                  self.positions, self.length + 1)

    def append(self, k_new, v_new, n_valid=None):
        """Multi-token (prefill) append, k_new/v_new (B, T, Hkv, d): keep
        the last ``min(W, n)`` real tokens per row; right-pad tails and
        tokens a later token of the same append would overwrite are
        dropped (ring slots must be written once)."""
        B, T = k_new.shape[:2]
        dev = k_new.device
        nv = (torch.full((B,), T, dtype=torch.int32, device=dev)
              if n_valid is None else n_valid.to(torch.int32))
        t = torch.arange(T, device=dev)[None]
        pos = self.length.long()[:, None] + t
        drop = (t >= nv[:, None]) | (t < nv[:, None] - self.window)
        self._write(k_new, v_new, pos, drop)
        return PagedWindowKVCache(self.k, self.v, self.block_table,
                                  self.positions, self.length + nv)

    def gather(self):
        """(k, v) in the contiguous ring (B, W, Hkv, d) layout."""
        bt = self.block_table.long().clamp(min=0)
        B = bt.shape[0]
        kk = self.k[bt].reshape(B, self.window, *self.k.shape[2:])
        vv = self.v[bt].reshape(B, self.window, *self.v.shape[2:])
        return kk, vv


# Placements (``dist.sharding.CACHE_AXES``), as in the JAX package: pool
# dim 0 is the PHYSICAL block dim, which any row's table may point into,
# so it stays replicated over the data-parallel axes; the head dim shards
# over ``model`` as in the contiguous caches; block tables and positions
# are per-row metadata and follow the batch axes.
register_cache_axes(PagedDenseKVCache, {
    "k": (None, None, "kv_heads", None),
    "v": (None, None, "kv_heads", None),
    "block_table": ("batch", None),
    "length": ("batch",),
})
register_cache_axes(PagedWindowKVCache, {
    "k": (None, None, "kv_heads", None),
    "v": (None, None, "kv_heads", None),
    "block_table": ("batch", None),
    "positions": ("batch", None),
    "length": ("batch",),
})


def copy_blocks(cache: PagedDenseKVCache, src, dst) -> PagedDenseKVCache:
    """Copy pool blocks ``src -> dst`` (both (n,) integer) in place — the
    device half of copy-on-write (``BlockPool.ensure_owned`` is the host
    half)."""
    src = torch.as_tensor(src, dtype=torch.long, device=cache.k.device)
    dst = torch.as_tensor(dst, dtype=torch.long, device=cache.k.device)
    cache.k[dst] = cache.k[src]
    cache.v[dst] = cache.v[src]
    return cache
