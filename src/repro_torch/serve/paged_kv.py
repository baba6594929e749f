"""Block-paged dense KV cache (port of ``repro.serve.paged_kv``).

KV lives in fixed-size blocks of ``block_size`` tokens inside a pool
``(N, block_size, Hkv, d)``; a per-row block table maps logical block
``pos // block_size`` to a physical block id (``-1`` = unallocated).
``append`` / ``gather`` reproduce the contiguous ``DenseKVCache``
semantics: ``gather()`` equals the contiguous cache at every valid
position.  Writes through an unallocated (``-1``) table entry are dropped.

Appends write the pools IN PLACE (see ``repro_torch.core.kv_cache``).
The host-side ``BlockPool`` allocator comes with the scheduler slice; this
slice serves whole batches through identity block tables.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.kv_cache import scatter_kept


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Static paged-cache geometry.  ``num_blocks == 0`` auto-sizes the pool
    to the contiguous worst case (``batch * ceil(max_len / block_size)``)
    with identity block tables."""

    block_size: int = 16
    num_blocks: int = 0


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

    def gather(self):
        """(k, v) in the contiguous (B, S, Hkv, d) layout."""
        bt = self.block_table.long().clamp(min=0)  # -1 -> junk, masked by length
        B, nb = bt.shape
        S = nb * self.block_size
        kk = self.k[bt].reshape(B, S, *self.k.shape[2:])
        vv = self.v[bt].reshape(B, S, *self.v.shape[2:])
        return kk, vv
