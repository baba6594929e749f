"""Hybrid attention layer: a few dense heads + many MoSA heads, summed
(port of ``repro.core.hybrid`` for ``variant="mosa"``).

Each side carries its own output projection and the two outputs are added
(eq. 2/3 of the paper).  The fixed / routing baselines, the gated
block-choice combine and window dense heads are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import AttentionConfig, MoSAConfig
from repro_torch.core.attention import MultiHeadAttention
from repro_torch.core.kv_cache import DenseKVCache, MoSAKVCache
from repro_torch.core.mosa import MoSAAttention
from repro_torch.serve.paged_kv import PagedConfig, PagedDenseKVCache


class HybridAttention(nn.Module):
    def __init__(self, d_model: int, cfg: MoSAConfig,
                 rope_theta: float = 10000.0, rotary_frac: float = 0.5,
                 param_dtype=torch.float32, compute_dtype=torch.float32,
                 variant: str = "mosa", impl: str = "einsum", device=None):
        super().__init__()
        if variant != "mosa":
            raise NotImplementedError(f"hybrid variant {variant!r} is not ported")
        if cfg.local_window > 0:
            raise NotImplementedError("window dense heads are not ported yet")
        self.d_model, self.cfg = d_model, cfg
        self.sparse = MoSAAttention(d_model, cfg, rope_theta, rotary_frac,
                                    param_dtype, compute_dtype, impl=impl,
                                    device=device)
        if cfg.n_dense_heads > 0:
            acfg = AttentionConfig(
                kind="gqa", n_heads=cfg.n_dense_heads,
                n_kv_heads=cfg.n_dense_heads, d_head=cfg.d_head,
                rope_theta=rope_theta, window=cfg.local_window)
            self.dense = MultiHeadAttention(d_model, acfg, param_dtype,
                                            compute_dtype,
                                            rotary_frac=rotary_frac,
                                            device=device)
        else:
            self.dense = None

    def init(self, generator: torch.Generator):
        self.sparse.init(generator)
        if self.dense is not None:
            self.dense.init(generator)

    def forward(self, x, positions=None, segments=None):
        """x: (B, T, h) -> sparse + dense heads' outputs.  ``segments``:
        optional (B, T) document ids of packed rows (both sides mask
        cross-document attention)."""
        y = self.sparse(x, positions, segments=segments)
        if self.dense is not None:
            y = y + self.dense(x, positions, segments)
        return y

    def router_health(self, x):
        """Expert-choice health of the sparse side (train telemetry)."""
        return self.sparse.router_health(x)

    # ---------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   paged: PagedConfig | None = None, device=None):
        """``paged``: the dense side then uses a block-paged pool.  The MoSA
        cache stays unpaged: it is already O(k) per head."""
        c = self.cfg
        k = self._sparse_k(max_len)
        caches = {"sparse": MoSAKVCache.create(
            batch, c.n_mosa_heads, min(k, max_len), c.d_head, dtype, device)}
        if c.n_dense_heads > 0:
            if paged is not None:
                caches["dense"] = PagedDenseKVCache.create(
                    batch, max_len, c.n_dense_heads, c.d_head, dtype,
                    block_size=paged.block_size, num_blocks=paged.num_blocks,
                    identity_tables=paged.num_blocks == 0, device=device)
            else:
                caches["dense"] = DenseKVCache.create(
                    batch, max_len, c.n_dense_heads, c.d_head, dtype, device)
        return caches

    def prefill(self, x, caches, positions=None, valid=None):
        y, sc = self.sparse.prefill(x, caches["sparse"], positions, valid)
        out = dict(caches, sparse=sc)
        if self.dense is not None:
            yd, dc = self.dense.prefill(x, caches["dense"], positions, valid)
            out["dense"] = dc
            y = y + yd
        return y, out

    def decode_step(self, x, caches, positions=None):
        y, sc = self.sparse.decode_step(x, caches["sparse"], positions)
        out = dict(caches, sparse=sc)
        if self.dense is not None:
            yd, dc = self.dense.decode_step(x, caches["dense"], positions)
            out["dense"] = dc
            y = y + yd
        return y, out

    def kv_total(self, T: int) -> int:
        """Paper Table 2 metric: KV = T*H_dense + k*H_mosa."""
        c = self.cfg
        return T * c.n_dense_heads + self._sparse_k(T) * c.n_mosa_heads

    def _sparse_k(self, T: int) -> int:
        # Mirrors MoSAAttention.k_for, including the cap at T.
        if self.cfg.k_fixed > 0:
            return min(self.cfg.k_fixed, T)
        return min(max(T // self.cfg.sparsity, self.cfg.min_k), T)
