"""Hybrid attention layer: a few dense (or sliding-window local) heads +
many sparse heads (port of ``repro.core.hybrid``).  ``variant`` picks the
sparse side: the paper's MoSA, or its two baselines for the IsoFLOP
comparisons, ``"fixed"`` (``FixedSparseAttention``, ``n_mosa_heads``
heads) and ``"routing"`` (``RoutingAttention``, ``max(1, n_mosa_heads //
sparsity)`` heads: one routing head costs about rho MoSA heads).  The
baselines are train-only: the serving entry points raise for them, as the
JAX package asserts.

Each side carries its own output projection (eq. 2/3 of the paper) and
the two outputs are added — except for block choice beside window dense
heads (``local_window > 0``, the paper's §3.4 long-sequence form), where
learned per-token sigmoid gates blend them (``_gated`` / ``_combine``,
parameter ``gate`` (d_model, 2), zero init).  The sparse side selects
tokens or, with ``selection_granularity="block"``, KV blocks (its serving
cache is then ``MoSABlockKVCache``); the dense side's serving cache is a
window ring (``WindowKVCache`` / ``PagedWindowKVCache``) when
``local_window > 0``.  ``dense_impl`` picks the dense side's full-forward
attention (``"chunked"`` or ``"kernel"``, the flash kernel #9).

On a mesh (``dist.parallel.shard_model``) a head-sharded side holds its
slice of the heads: ``local_forward`` returns this rank's share of the
layer (its MoSA heads scatter-added into the sequence, plus its dense
heads' share), one all-reduce over ``model`` sums the shares, and a side
whose heads are replicated (a head count that ``model`` does not divide)
is computed on every rank and added once, after the sum.  The gated form
sums each side's shares apart (one all-reduce of both) and gates the
sums: the gates are replicated.  Serving follows the same rule
(``prefill``, ``prefill_packed``, ``decode_step``; their ``local_*``
forms return a rank's share with no collective), on caches that hold a
rank's heads (``init_cache``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import AttentionConfig, MoSAConfig
from repro_torch.core.attention import MultiHeadAttention
from repro_torch.core.baselines import FixedSparseAttention, RoutingAttention
from repro_torch.core.kv_cache import (DenseKVCache, MoSABlockKVCache,
                                      MoSAKVCache, WindowKVCache)
from repro_torch.core.mosa import MoSAAttention
from repro_torch.dist.parallel import copy_to, reduce_from
from repro_torch.dist.sharding import logical
from repro_torch.nn.layers import param
from repro_torch.serve.paged_kv import (PagedConfig, PagedDenseKVCache,
                                        PagedWindowKVCache)


class HybridAttention(nn.Module):
    def __init__(self, d_model: int, cfg: MoSAConfig,
                 rope_theta: float = 10000.0, rotary_frac: float = 0.5,
                 param_dtype=torch.float32, compute_dtype=torch.float32,
                 variant: str = "mosa", impl: str = "einsum",
                 dense_impl: str = "chunked", device=None):
        super().__init__()
        self.d_model, self.cfg, self.variant = d_model, cfg, variant
        if variant == "mosa":
            self.sparse = MoSAAttention(d_model, cfg, rope_theta, rotary_frac,
                                        param_dtype, compute_dtype, impl=impl,
                                        device=device)
        elif variant == "fixed":
            self.sparse = FixedSparseAttention(
                d_model, cfg.n_mosa_heads, cfg.d_head, cfg.sparsity,
                rope_theta, rotary_frac, param_dtype, compute_dtype,
                device=device)
        elif variant == "routing":
            self.sparse = RoutingAttention(
                d_model, max(1, cfg.n_mosa_heads // cfg.sparsity), cfg.d_head,
                cfg.sparsity, rope_theta, rotary_frac,
                param_dtype=param_dtype, compute_dtype=compute_dtype,
                device=device)
        else:
            raise ValueError(f"unknown hybrid variant {variant!r}")
        if cfg.n_dense_heads > 0:
            acfg = AttentionConfig(
                kind="gqa", n_heads=cfg.n_dense_heads,
                n_kv_heads=cfg.n_dense_heads, d_head=cfg.d_head,
                rope_theta=rope_theta, window=cfg.local_window)
            self.dense = MultiHeadAttention(d_model, acfg, param_dtype,
                                            compute_dtype, impl=dense_impl,
                                            rotary_frac=rotary_frac,
                                            device=device)
        else:
            self.dense = None
        if self._gated():
            self.gate = param((d_model, 2), param_dtype, device)
        # on a mesh: the ``model`` group where a side's weights are
        # sharded (``tp``) and whatever they are (``mesh_tp``, serving),
        # and whether the sparse side's heads are sharded (the dense side's
        # placement is its own)
        self.tp, self.mesh_tp, self.sparse_sharded = None, None, False

    def specs(self):
        s = {f"sparse.{k}": v for k, v in self.sparse.specs().items()}
        if self.dense is not None:
            s.update({f"dense.{k}": v for k, v in self.dense.specs().items()})
        if self._gated():
            s["gate"] = logical("embed", None)
        return s

    @property
    def dense_impl(self) -> str:
        """The dense side's full-forward attention: ``"chunked"`` or
        ``"kernel"`` (settable on a built model)."""
        return self.dense.impl if self.dense is not None else "chunked"

    @dense_impl.setter
    def dense_impl(self, impl: str):
        if self.dense is not None:
            self.dense.impl = impl

    def _gated(self) -> bool:
        """Gate-combined form: block choice beside sliding-window dense
        heads blends the two sides with learned per-token sigmoid gates
        instead of summing them; token choice and windowless configs keep
        the paper's plain head sum."""
        c = self.cfg
        return (self.variant == "mosa" and c.selection_granularity == "block"
                and c.local_window > 0 and c.n_dense_heads > 0)

    def init(self, generator: torch.Generator):
        self.sparse.init(generator)
        if self.dense is not None:
            self.dense.init(generator)
        if self._gated():
            # gates open at 0.5 / 0.5: the summed form halved
            nn.init.zeros_(self.gate)

    def _combine(self, x, ys, yd):
        """Merge the sparse and dense outputs: the plain sum, or the learned
        per-token gates when ``_gated()``."""
        if yd is None:
            return ys
        if self._gated():
            g = torch.sigmoid(x.float() @ self.gate.float())
            out = ys.float() * g[..., 0:1] + yd.float() * g[..., 1:2]
            return out.to(ys.dtype)
        return ys + yd

    def forward(self, x, positions=None, segments=None):
        """x: (B, T, h) -> the combined sparse and dense heads' outputs.
        ``segments``: optional (B, T) document ids of packed rows (both
        sides mask cross-document attention)."""
        if self.tp is not None:
            return self._mesh_forward(x, positions, segments)
        y = self.sparse(x, positions, segments=segments)
        yd = (None if self.dense is None
              else self.dense(x, positions, segments))
        return self._combine(x, y, yd)

    def _dense_sharded(self) -> bool:
        return self.dense is not None and self.dense.tp is not None

    def _local_sides(self, x, positions=None, segments=None):
        """(sparse share, dense share) of this rank, None for a side whose
        heads are replicated; ``x`` is inside the tensor-parallel region."""
        ys = (self.sparse(x, positions, segments=segments)
              if self.sparse_sharded else None)
        yd = (self.dense.local_forward(x, positions, segments)
              if self._dense_sharded() else None)
        return ys, yd

    def local_forward(self, x, positions=None, segments=None):
        """This rank's share of the layer on a mesh, before the all-reduce
        over ``model``: the sum of its head-sharded sides' shares (the
        replicated sides are not in it)."""
        ys, yd = self._local_sides(x, positions, segments)
        if ys is None or yd is None:
            return ys if yd is None else yd
        return ys + yd

    def _mesh_forward(self, x, positions=None, segments=None):
        ys, yd = self._local_sides(copy_to(x, self.tp), positions, segments)
        if self._gated():
            summed = iter(reduce_from(torch.stack(
                [t for t in (ys, yd) if t is not None]), self.tp))
            ys = (next(summed) if ys is not None
                  else self.sparse(x, positions, segments=segments))
            yd = (next(summed) if yd is not None
                  else self.dense(x, positions, segments))
            return self._combine(x, ys, yd)
        share = ys if yd is None else (yd if ys is None else ys + yd)
        y = reduce_from(share, self.tp)          # the sharded sides, summed
        if not self.sparse_sharded:              # replicated: added once
            return self._combine(
                x, self.sparse(x, positions, segments=segments), y)
        if self.dense is not None and not self._dense_sharded():
            return self._combine(x, y, self.dense(x, positions, segments))
        return y

    def router_health(self, x, rows_sum=None):
        """Expert-choice health of the sparse side (train telemetry); None
        for the fixed / routing baselines, which have no learned router.
        On a mesh the selection counts are summed over this layer's head
        shards and, through ``rows_sum``, over the data-parallel rows."""
        if self.variant != "mosa":
            return None
        heads_sum = None
        if self.tp is not None and self.sparse_sharded:
            heads_sum = lambda t: reduce_from(t, self.tp)   # noqa: E731
        return self.sparse.router_health(x, heads_sum=heads_sum,
                                         rows_sum=rows_sum)

    def _serving(self):
        if self.variant != "mosa":
            raise NotImplementedError(
                f"serving is implemented for MoSA; the {self.variant!r} "
                "baseline is train-only, as in the JAX package")

    # ---------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   paged: PagedConfig | None = None, device=None):
        """``paged``: the dense side then uses a block-paged pool.  The MoSA
        cache stays unpaged: it is already O(k) per head (block choice:
        ``ceil(k / bs)`` candidate blocks and the current one).  On a mesh
        the caches hold this rank's heads: its MoSA heads, and its dense
        heads where its columns are whole heads (``cache_heads``)."""
        self._serving()
        c = self.cfg
        H = self.sparse.wq.shape[0]
        k = min(self._sparse_k(max_len), max_len)
        if c.selection_granularity == "block":
            bs = c.sel_block_size
            caches = {"sparse": MoSABlockKVCache.create(
                batch, H, -(-k // bs), bs, c.d_head, dtype, device)}
        else:
            caches = {"sparse": MoSAKVCache.create(
                batch, H, k, c.d_head, dtype, device)}
        if c.n_dense_heads > 0:
            Hd = self.dense.cache_heads()
            if c.local_window > 0 and paged is not None:
                W = min(c.local_window, max_len)
                caches["dense"] = PagedWindowKVCache.create(
                    batch, W, Hd, c.d_head, dtype,
                    block_size=paged.block_size,
                    num_blocks=paged.num_window_blocks,
                    identity_tables=paged.num_window_blocks == 0,
                    device=device)
            elif c.local_window > 0:
                caches["dense"] = WindowKVCache.create(
                    batch, c.local_window, Hd, c.d_head, dtype, device)
            elif paged is not None:
                caches["dense"] = PagedDenseKVCache.create(
                    batch, max_len, Hd, c.d_head, dtype,
                    block_size=paged.block_size, num_blocks=paged.num_blocks,
                    identity_tables=paged.num_blocks == 0, device=device)
            else:
                caches["dense"] = DenseKVCache.create(
                    batch, max_len, Hd, c.d_head, dtype, device)
        return caches

    def _served(self, x, caches, sparse, dense, local: bool = False):
        """Both sides' serving results -> (output, caches).  ``sparse`` /
        ``dense``: the sides' calls, each (y, cache).  On a mesh the sides
        that give this rank's share (the MoSA heads when they are sharded;
        the dense side by its cache, ``MultiHeadAttention.serves_share``)
        are summed by one all-reduce over ``model`` and a replicated side
        is added once after it (the gated form sums each side apart and
        gates the sums), as ``_mesh_forward``.  ``local``: return this
        rank's share, the sum of those sides' shares, with no
        collective."""
        tp = self.mesh_tp
        dense_share = (tp is not None and self.dense is not None
                       and self.dense.serves_share(caches["dense"]))
        ys, sc = sparse()
        out = dict(caches, sparse=sc)
        yd = None
        if self.dense is not None:
            yd, out["dense"] = dense()
        shares = [t for t, sharded in ((ys, self.sparse_sharded),
                                       (yd, dense_share)) if sharded]
        if tp is None or not shares:
            return self._combine(x, ys, yd), out
        share = shares[0] if len(shares) == 1 else shares[0] + shares[1]
        if local:
            return share, out
        if self._gated():
            summed = iter(reduce_from(torch.stack(shares), tp))
            ys = next(summed) if self.sparse_sharded else ys
            yd = next(summed) if dense_share else yd
            return self._combine(x, ys, yd), out
        y = reduce_from(share, tp)               # the sharded sides, summed
        if not self.sparse_sharded:              # replicated: added once
            return self._combine(x, ys, y), out
        if yd is not None and not dense_share:
            return self._combine(x, y, yd), out
        return y, out

    def prefill(self, x, caches, positions=None, valid=None,
                continued: bool = False):
        """``continued``: the caches hold a restored prompt prefix
        (prefix-cache hit); the sparse side extends it through the exact
        union selection of ``MoSAAttention.prefill_past``, the dense side's
        paged prefill is past-aware through its cache ``length`` alone."""
        return self._prefill(x, caches, positions, valid, continued, False)

    def prefill_packed(self, x, caches, meta):
        """Packed chunked prefill: the sparse side runs per-segment union
        selection (``MoSAAttention.prefill_packed``), the dense side its
        paged packed path."""
        return self._prefill_packed(x, caches, meta, False)

    def decode_step(self, x, caches, positions=None):
        return self._decode_step(x, caches, positions, False)

    def local_prefill(self, x, caches, positions=None, valid=None,
                      continued: bool = False):
        """This rank's share of ``prefill`` on a mesh, before the sum over
        ``model`` (the replicated sides are not in it; their caches are
        updated all the same), and its caches: no collective where the
        placements are head-parallel."""
        return self._prefill(x, caches, positions, valid, continued, True)

    def local_prefill_packed(self, x, caches, meta):
        """This rank's share of ``prefill_packed`` (see ``local_prefill``)."""
        return self._prefill_packed(x, caches, meta, True)

    def local_decode_step(self, x, caches, positions=None):
        """This rank's share of ``decode_step`` (see ``local_prefill``)."""
        return self._decode_step(x, caches, positions, True)

    def _prefill(self, x, caches, positions, valid, continued, local):
        self._serving()
        if continued:
            def sparse():
                return self.sparse.prefill_past(x, caches["sparse"], valid)
        else:
            def sparse():
                return self.sparse.prefill(x, caches["sparse"], positions,
                                           valid)
        return self._served(
            x, caches, sparse,
            lambda: self.dense.local_prefill(x, caches["dense"], positions,
                                             valid), local)

    def _prefill_packed(self, x, caches, meta, local):
        self._serving()
        return self._served(
            x, caches,
            lambda: self.sparse.prefill_packed(x, caches["sparse"], meta),
            lambda: self.dense.local_prefill_packed(x, caches["dense"], meta),
            local)

    def _decode_step(self, x, caches, positions, local):
        self._serving()
        return self._served(
            x, caches,
            lambda: self.sparse.decode_step(x, caches["sparse"], positions),
            lambda: self.dense.local_decode_step(x, caches["dense"],
                                                 positions), local)

    def kv_total(self, T: int) -> int:
        """Paper Table 2 metric: KV = T*H_dense + k*H_mosa (the window caps
        the dense side)."""
        c = self.cfg
        dense_T = min(T, c.local_window) if c.local_window > 0 else T
        return dense_T * c.n_dense_heads + self._sparse_k(T) * c.n_mosa_heads

    def _sparse_k(self, T: int) -> int:
        # Mirrors MoSAAttention.k_for, including the cap at T.
        if self.cfg.k_fixed > 0:
            return min(self.cfg.k_fixed, T)
        return min(max(T // self.cfg.sparsity, self.cfg.min_k), T)
