"""Dense GQA attention (port of the ``MultiHeadAttention`` part of
``repro.core.attention``).

  * ``chunked_attention`` — flash-style attention over KV chunks with a
    running (max, denom, acc) in fp32: a Python loop where the JAX package
    has ``lax.scan``.  The dense prefill over the gathered paged KV runs
    here (plain PyTorch, as the JAX package leaves it to XLA).
  * ``gqa_attention``     — direct (unchunked) GQA attention.
  * ``MultiHeadAttention`` — projections, RoPE, the forward pass, and the
    serving ``prefill`` / ``decode_step`` on contiguous and paged dense and
    window caches, and the packed chunked ``prefill_packed`` on a paged
    cache.  ``impl`` picks the full forward's attention, as in the JAX
    package: ``"chunked"`` (plain PyTorch, differentiable) or ``"kernel"``
    (``flash_attention``, the CUDA kernel #9 on the card; forward-only, as
    the JAX ``"pallas"`` impl).  Packed rows (``segments``) always take the
    masked chunked path.  Paged dense decode goes through
    ``paged_attention_decode`` and packed dense prefill through
    ``paged_prefill_attention`` (CUDA kernels on the card); the window
    rings' prefill and decode are plain PyTorch, as in the JAX package.
    MLA is not ported yet.

On a mesh (``tp`` set by ``dist.parallel.shard_model``) a rank holds the
columns ``q_cols`` of the fused ``n_heads * d_head`` dim of ``wq`` and the
same rows of ``wo``, and ``kv_cols`` of ``wk`` / ``wv`` (None: replicated);
``local_forward`` computes the heads those columns touch and returns this
rank's share of the output (its rows of ``wo``), which ``forward`` sums
over ``model``.  Serving follows the placement of the rank's cache
(``_serve_mode``): the heads it holds (its own, or every head where the
placement replicates them), or under ``seq_sharded`` every head at a
slice of the positions, whose partial softmaxes (``softmax_partials``)
merge with one MAX and one SUM all-reduce; ``local_prefill``,
``local_decode_step`` and ``local_prefill_packed`` return the share
before the sum.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import AttentionConfig
from repro_torch.core import rope as rope_lib
from repro_torch.core.kv_cache import DenseKVCache, WindowKVCache, scatter_kept
from repro_torch.dist.parallel import (copy_to, gather_last, reduce_from,
                                       tp_all_reduce)
from repro_torch.dist.sharding import logical
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.nn.layers import param, trunc_normal_
from repro_torch.serve.paged_attention import (paged_attention_decode,
                                               paged_prefill_attention)
from repro_torch.serve.paged_kv import PagedDenseKVCache, PagedWindowKVCache

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1
CHUNK = 512          # KV chunk of ``chunked_attention`` in the module's calls
IMPLS = ("chunked", "kernel")


def _mask_bias(q_pos, k_pos, window: int = 0, k_valid=None, q_seg=None,
               k_seg=None):
    """fp32 additive mask: causal (+ sliding window) from explicit positions.
    q_pos: (..., Tq), k_pos: (..., Tk) -> (..., Tq, Tk).  ``q_seg``/``k_seg``:
    optional segment ids of packed rows; attention then also needs
    seg_q == seg_k."""
    ok = q_pos[..., :, None] >= k_pos[..., None, :]
    if window > 0:
        ok &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    if k_valid is not None:
        ok &= k_valid[..., None, :]
    if q_seg is not None:
        ok &= q_seg[..., :, None] == k_seg[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def chunked_attention(q, k, v, q_pos, k_pos, scale, window: int = 0,
                      k_valid=None, chunk: int = 512, q_seg=None, k_seg=None):
    """Flash-style GQA attention over KV chunks.

    q: (B, Hq, Tq, d); k, v: (B, Hkv, Tk, d), Hq % Hkv == 0 (the KV repeat
    stays inside the einsum).  q_pos: (B, Tq) or (Tq,); k_pos likewise for
    Tk; ``q_seg``/``k_seg`` likewise, optional (packed rows).  Returns
    (B, Hq, Tq, dv) in v.dtype."""
    B, Hq, Tq, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    R = Hq // Hkv
    dv = v.shape[-1]
    dev = q.device
    chunk = min(chunk, Tk)
    n_chunks = -(-Tk // chunk)
    pad = n_chunks * chunk - Tk
    kp = torch.broadcast_to(k_pos, (B, Tk))
    kv_valid = (torch.ones((B, Tk), dtype=torch.bool, device=dev)
                if k_valid is None else torch.broadcast_to(k_valid, (B, Tk)))
    ks = None if k_seg is None else torch.broadcast_to(k_seg, (B, Tk))
    if pad:
        k = nn.functional.pad(k, (0, 0, 0, pad))
        v = nn.functional.pad(v, (0, 0, 0, pad))
        kp = nn.functional.pad(kp, (0, pad), value=INT32_MAX)
        kv_valid = nn.functional.pad(kv_valid, (0, pad), value=False)
        if ks is not None:
            ks = nn.functional.pad(ks, (0, pad), value=-1)
    qp = torch.broadcast_to(q_pos, (B, Tq))
    qs = None if q_seg is None else torch.broadcast_to(q_seg, (B, Tq))
    qf = q.reshape(B, Hkv, R, Tq, d).float()

    m = torch.full((B, Hkv, R, Tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, R, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, R, Tq, dv), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = torch.einsum("bgrqd,bgkd->bgrqk", qf, k[:, :, sl].float()) * scale
        bias = _mask_bias(qp[:, None, None], kp[:, None, None, sl], window,
                          kv_valid[:, None, None, sl],
                          None if qs is None else qs[:, None, None],
                          None if qs is None else ks[:, None, None, sl])
        s = s + bias
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bgkd->bgrqd", p, v[:, :, sl].float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Hq, Tq, dv).to(v.dtype)


def gqa_attention(q, k, v, q_pos, k_pos, scale, window: int = 0,
                  k_valid=None, q_seg=None, k_seg=None):
    """Direct (unchunked) GQA attention.  q: (B, Hq, Tq, d); k, v:
    (B, Hkv, Tk, d); ``q_seg``/``k_seg`` optional (packed rows)."""
    B, Hq, Tq, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    R = Hq // Hkv
    dv = v.shape[-1]
    qf = q.reshape(B, Hkv, R, Tq, d).float()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, k.float()) * scale
    qp = torch.broadcast_to(q_pos, (B, Tq))
    kp = torch.broadcast_to(k_pos, (B, Tk))
    kv = (None if k_valid is None
          else torch.broadcast_to(k_valid, (B, Tk))[:, None, None])
    qs = (None if q_seg is None
          else torch.broadcast_to(q_seg, (B, Tq))[:, None, None])
    ks = (None if k_seg is None
          else torch.broadcast_to(k_seg, (B, Tk))[:, None, None])
    s = s + _mask_bias(qp[:, None, None], kp[:, None, None], window, kv,
                       qs, ks)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    out = out / p.sum(-1).clamp_min(1e-30)[..., None]
    return out.reshape(B, Hq, Tq, dv).to(v.dtype)


class MultiHeadAttention(nn.Module):
    """GQA attention with RoPE (partial rotary via ``rotary_frac``),
    optionally sliding-window (``cfg.window``)."""

    def __init__(self, d_model: int, cfg: AttentionConfig,
                 param_dtype=torch.float32, compute_dtype=torch.float32,
                 impl: str = "chunked", rotary_frac: float = 1.0,
                 device=None):
        super().__init__()
        if cfg.mrope_sections or cfg.kind != "gqa":
            raise NotImplementedError("only plain-RoPE GQA attention is ported")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.d_model, self.cfg = d_model, cfg
        self.compute_dtype = compute_dtype
        self.impl = impl
        self.rotary_frac = rotary_frac
        c = cfg
        self.wq = param((d_model, c.n_heads * c.d_head), param_dtype, device)
        self.wk = param((d_model, c.n_kv_heads * c.d_head), param_dtype, device)
        self.wv = param((d_model, c.n_kv_heads * c.d_head), param_dtype, device)
        self.wo = param((c.n_heads * c.d_head, d_model), param_dtype, device)
        if c.qkv_bias:
            self.bq = param((c.n_heads * c.d_head,), param_dtype, device)
            self.bk = param((c.n_kv_heads * c.d_head,), param_dtype, device)
            self.bv = param((c.n_kv_heads * c.d_head,), param_dtype, device)
        self.tp, self.q_cols, self.kv_cols = None, None, None
        # serving on a mesh: the ``model`` group whatever the weights'
        # placement, and whether the contiguous caches hold a slice of the
        # positions of every head (``seq_sharded``)
        self.mesh_tp, self.seq_sharded = None, False

    def specs(self):
        s = {"wq": logical("embed", "heads"),
             "wk": logical("embed", "kv_heads"),
             "wv": logical("embed", "kv_heads"),
             "wo": logical("heads", "embed")}
        if self.cfg.qkv_bias:
            s.update(bq=logical("heads"), bk=logical("kv_heads"),
                     bv=logical("kv_heads"))
        return s

    @property
    def _scale(self):
        return self.cfg.softmax_scale or self.cfg.d_head ** -0.5

    def init(self, generator: torch.Generator):
        c = self.cfg
        std = self.d_model ** -0.5
        trunc_normal_(self.wq, std, generator)
        trunc_normal_(self.wk, std, generator)
        trunc_normal_(self.wv, std, generator)
        trunc_normal_(self.wo, (c.n_heads * c.d_head) ** -0.5, generator)
        if c.qkv_bias:
            for b in (self.bq, self.bk, self.bv):
                nn.init.zeros_(b)

    def _qkv(self, x):
        """x: (B, T, h) -> q (B, Hq, T, d), k and v (B, Hkv, T, d)."""
        c, cd = self.cfg, self.compute_dtype
        B, T, _ = x.shape
        x = x.to(cd)
        q = (x @ self.wq.to(cd)).float()
        k = (x @ self.wk.to(cd)).float()
        v = (x @ self.wv.to(cd)).float()
        if c.qkv_bias:
            q = q + self.bq.float()
            k = k + self.bk.float()
            v = v + self.bv.float()
        q = q.to(cd).reshape(B, T, -1, c.d_head).transpose(1, 2)
        k = k.to(cd).reshape(B, T, -1, c.d_head).transpose(1, 2)
        v = v.to(cd).reshape(B, T, -1, c.d_head).transpose(1, 2)
        return q, k, v

    def _rope(self, t, positions):
        return rope_lib.apply_rope(t, positions[:, None], self.cfg.rope_theta,
                                   self.rotary_frac)

    def _out(self, out):
        """(B, Hq, T, d) heads -> (B, T, h) through ``wo``."""
        B, H, T, d = out.shape
        cd = self.compute_dtype
        out = out.transpose(1, 2).reshape(B, T, H * d)
        return out.to(cd) @ self.wo.to(cd)

    def _attend(self, q, k, v, positions):
        """Causal (windowed) self-attention of the full forward: the flash
        kernel with ``impl="kernel"`` (index order, as the JAX ``pallas``
        impl), else the chunked path over ``positions``."""
        c = self.cfg
        if self.impl == "kernel":
            return flash_attention(q, k, v, window=c.window)
        return chunked_attention(q, k, v, positions, positions, self._scale,
                                 window=c.window, chunk=CHUNK)

    def forward(self, x, positions=None, segments=None):
        """Training / prefill-style full forward.  x: (B, T, h).

        ``segments``: optional (B, T) document ids of packed rows.  Their
        ``positions`` restart at every document (RoPE), so causality takes
        the packed order and seg_q == seg_k keeps attention inside the
        document; packed rows take the masked chunked path with either
        ``impl``.  ``impl="kernel"`` is forward-only: under autograd it
        raises."""
        if self.tp is not None:
            return reduce_from(self.local_forward(copy_to(x, self.tp),
                                                  positions, segments),
                               self.tp)
        c = self.cfg
        B, T, _ = x.shape
        if positions is None:
            positions = torch.arange(T, device=x.device).expand(B, T)
        q, k, v = self._qkv(x)
        q = self._rope(q, positions)
        k = self._rope(k, positions)
        return self._out(self._heads_attention(q, k, v, positions, segments))

    def _heads_attention(self, q, k, v, positions, segments):
        c = self.cfg
        B, _, T, _ = q.shape
        if segments is None:
            out = self._attend(q, k, v, positions)
        else:
            packed = torch.arange(T, device=q.device).expand(B, T)
            out = chunked_attention(q, k, v, packed, packed, self._scale,
                                    window=c.window, chunk=CHUNK,
                                    q_seg=segments, k_seg=segments)
        return out

    def _tp_proj(self, x, w, b, cols):
        """x @ w (+ b) in fp32 on a mesh: a replicated weight (``cols`` is
        None) enters the tensor-parallel region through ``copy_to``."""
        cd = self.compute_dtype
        if cols is None:
            w = copy_to(w, self.tp)
            b = None if b is None else copy_to(b, self.tp)
        y = (x @ w.to(cd)).float()
        return y if b is None else y + b.float()

    def local_forward(self, x, positions=None, segments=None):
        """This rank's share of the output on a mesh (before the sum over
        ``model``): the whole heads that its ``q_cols`` touch (all-gathered
        over ``model`` where the slice cuts a head), each with the kv head
        of its group, then its columns of their output through its rows of
        ``wo``.  ``x`` is already inside the tensor-parallel region."""
        c, cd, tp = self.cfg, self.compute_dtype, self.tp
        B, T, _ = x.shape
        d, R = c.d_head, c.n_heads // c.n_kv_heads
        if positions is None:
            positions = torch.arange(T, device=x.device).expand(B, T)
        xc = x.to(cd)
        bias = c.qkv_bias
        q = self._tp_proj(xc, self.wq, self.bq if bias else None,
                          self.q_cols)
        k = self._tp_proj(xc, self.wk, self.bk if bias else None,
                          self.kv_cols)
        v = self._tp_proj(xc, self.wv, self.bv if bias else None,
                          self.kv_cols)
        qa, qb = self.q_cols
        h0, h1 = qa // d, -(-qb // d)
        if qa % d or qb % d:                     # the slice cuts a head
            q = gather_last(q, tp)[..., h0 * d:h1 * d]
        g0, g1 = h0 // R, (h1 - 1) // R + 1      # kv heads of these groups
        ka, kb = self.kv_cols or (0, k.shape[-1])
        if not ka <= g0 * d < g1 * d <= kb:      # some are another rank's
            k, v = gather_last(k, tp), gather_last(v, tp)
            ka = 0
        k, v = (t[..., g0 * d - ka:g1 * d - ka] for t in (k, v))
        q = q.to(cd).reshape(B, T, h1 - h0, d).transpose(1, 2)
        k = k.to(cd).reshape(B, T, g1 - g0, d).transpose(1, 2)
        v = v.to(cd).reshape(B, T, g1 - g0, d).transpose(1, 2)
        if h0 % R or h1 % R:                     # groups cut: one kv per q
            grp = torch.arange(h0, h1, device=x.device) // R - g0
            k, v = k[:, grp], v[:, grp]
        q = self._rope(q, positions)
        k = self._rope(k, positions)
        out = self._heads_attention(q, k, v, positions, segments)
        out = out.transpose(1, 2).reshape(B, T, (h1 - h0) * d)
        out = out[..., qa - h0 * d:qb - h0 * d]
        return out.to(cd) @ self.wo.to(cd)

    # ---- serving ----
    # On a mesh (``mesh_tp``: the ``model`` group, set by ``shard_model``
    # whatever the weights' placement) every serving entry point has a
    # local form (``local_*``) that returns this rank's share of the
    # output before the sum over ``model``, as ``local_forward``.  Which
    # heads and positions a rank computes and keeps follows its cache's
    # placement (``_serve_mode``).

    def _own_kv_heads(self):
        """(g0, g1): the kv heads of this rank's q heads when its weight
        columns are exactly those whole heads (a head count that ``model``
        divides); else None."""
        if self.tp is None or self.kv_cols is None:
            return None
        c, d = self.cfg, self.cfg.d_head
        (qa, qb), (ka, kb) = self.q_cols, self.kv_cols
        R = c.n_heads // c.n_kv_heads
        if (ka % d or kb % d or qa % d or qb % d
                or qa // d != ka // d * R or qb // d != kb // d * R):
            return None
        return ka // d, kb // d

    def cache_heads(self) -> int:
        """The kv heads of this rank's cache under a head placement
        (``cache_spec``'s rule): its share where ``model`` divides the kv
        heads, else all of them."""
        n, tp = self.cfg.n_kv_heads, self.mesh_tp
        return n // tp.size if tp is not None and n % tp.size == 0 else n

    def _serve_mode(self, cache) -> str:
        """How this rank serves ``cache``:

          * ``"plain"`` — off a mesh, or replicated weights and a cache of
            every head and position: the whole output;
          * ``"local"`` — the cache holds the kv heads of this rank's whole
            weight columns (``_own_kv_heads``);
          * ``"heads"`` — replicated weights, the cache holds this rank's
            share of the kv heads: the columns of those heads;
          * ``"full"`` — sharded weights, a cache of every head (a head
            count that ``model`` does not divide): every rank computes
            every head, its columns all-gathered;
          * ``"seq"`` — a ``seq_sharded`` contiguous cache: every head at
            this rank's slice of the positions.

        Any other cache raises."""
        tp = self.mesh_tp
        if tp is None:
            return "plain"
        c = self.cfg
        held = cache.k.shape[-2]
        own = self._own_kv_heads()
        if own is not None and held == own[1] - own[0]:
            return "local"
        if held != c.n_kv_heads:
            if self.tp is None and held * tp.size == c.n_kv_heads:
                return "heads"
            raise ValueError(
                f"a cache of {held} kv heads matches neither this rank's "
                f"heads (q columns {self.q_cols}, kv columns "
                f"{self.kv_cols}) nor all {c.n_kv_heads}")
        if self.seq_sharded and isinstance(cache, (DenseKVCache,
                                                   WindowKVCache)):
            return "seq"
        return "plain" if self.tp is None else "full"

    def serves_share(self, cache) -> bool:
        """Whether serving ``cache`` gives this rank's share of the output
        (summed over ``model``) rather than the whole of it."""
        mode = self._serve_mode(cache)
        return mode in ("local", "heads", "full") or (
            mode == "seq" and self.tp is not None)

    def _heads_cols(self, cache):
        """(q columns, kv columns) of the heads of a ``"heads"`` cache."""
        d, R = self.cfg.d_head, self.cfg.n_heads // self.cfg.n_kv_heads
        g = cache.k.shape[-2] * d
        r = self.mesh_tp.rank
        return (r * g * R, (r + 1) * g * R), (r * g, (r + 1) * g)

    def _serve_qkv(self, x, mode, cache):
        """q (B, Hq, T, d), k and v (B, Hkv, T, d) of the heads that
        ``mode`` computes: this rank's (``"local"``, ``"heads"``) or every
        head (sharded weights' columns all-gathered over ``model``)."""
        if mode == "plain" or (mode == "seq" and self.tp is None):
            return self._qkv(x)
        c, cd = self.cfg, self.compute_dtype
        B, T, _ = x.shape
        xc = x.to(cd)
        bias = c.qkv_bias
        if mode == "heads":
            (qa, qb), (ka, kb) = self._heads_cols(cache)
            q = self._tp_proj(xc, self.wq[:, qa:qb],
                              self.bq[qa:qb] if bias else None, None)
            k = self._tp_proj(xc, self.wk[:, ka:kb],
                              self.bk[ka:kb] if bias else None, None)
            v = self._tp_proj(xc, self.wv[:, ka:kb],
                              self.bv[ka:kb] if bias else None, None)
        else:
            q = self._tp_proj(xc, self.wq, self.bq if bias else None,
                              self.q_cols)
            k = self._tp_proj(xc, self.wk, self.bk if bias else None,
                              self.kv_cols)
            v = self._tp_proj(xc, self.wv, self.bv if bias else None,
                              self.kv_cols)
            if mode != "local":
                q = gather_last(q, self.tp)
                if self.kv_cols is not None:
                    k, v = gather_last(k, self.tp), gather_last(v, self.tp)
        return tuple(t.to(cd).reshape(B, T, -1, c.d_head).transpose(1, 2)
                     for t in (q, k, v))

    def _serve_out(self, out, mode, cache):
        """(B, H, T, d) heads -> (B, T, h) through ``wo``: the whole output,
        or this rank's share (its columns of the heads' output through its
        rows of ``wo``)."""
        if mode in ("plain", "local") or (mode == "seq" and self.tp is None):
            return self._out(out)
        B, H, T, d = out.shape
        cd = self.compute_dtype
        out = out.transpose(1, 2).reshape(B, T, H * d)
        if mode == "heads":
            qa, qb = self._heads_cols(cache)[0]
            return out.to(cd) @ self.wo[qa:qb].to(cd)
        qa, qb = self.q_cols
        return out[..., qa:qb].to(cd) @ self.wo.to(cd)

    def _summed(self, cache, served):
        """(y, new cache) -> y summed over ``model`` where it is this
        rank's share of the output (``serves_share`` of ``cache``)."""
        y, new = served
        if self.mesh_tp is not None and self.serves_share(cache):
            y = reduce_from(y, self.mesh_tp)
        return y, new

    def prefill(self, x, cache, positions=None, valid=None):
        """``valid``: optional (B, T) bool — False marks right-pad tokens;
        it only sets how far the cache ``length`` advances."""
        return self._summed(cache, self.local_prefill(x, cache, positions,
                                                      valid))

    def decode_step(self, x, cache, positions=None):
        """x: (B, 1, h); attends over the cache + itself."""
        return self._summed(cache, self.local_decode_step(x, cache,
                                                          positions))

    def prefill_packed(self, x, cache, meta):
        """Packed multi-segment chunked prefill.  x: (1, C, h), N prompt
        segments back to back, each continuing a different batch row of the
        paged cache; ``meta`` is the layout ``TransformerLM.prefill_packed``
        builds.  A paged window cache unpacks the segments
        (``_prefill_packed_window``); a paged dense cache takes ONE pass
        over the packed stream (``_prefill_packed_dense``)."""
        return self._summed(cache, self.local_prefill_packed(x, cache,
                                                             meta))

    def local_prefill(self, x, cache, positions=None, valid=None):
        """``prefill``'s share of this rank (off a mesh, ``prefill``)."""
        mode = self._serve_mode(cache)
        if isinstance(cache, PagedWindowKVCache):
            return self._prefill_window_paged(x, cache, positions, valid,
                                              mode)
        if isinstance(cache, PagedDenseKVCache):
            return self._prefill_dense_paged(x, cache, positions, valid,
                                             mode)
        if isinstance(cache, WindowKVCache):
            return self._prefill_window(x, cache, positions, valid, mode)
        if not isinstance(cache, DenseKVCache):
            raise NotImplementedError(f"{type(cache).__name__} is not ported")
        c = self.cfg
        B, T, _ = x.shape
        if positions is None:
            positions = torch.arange(T, device=x.device).expand(B, T)
        q, k, v = self._serve_qkv(x, mode, cache)
        q = self._rope(q, positions)
        k = self._rope(k, positions)
        nv = None if valid is None else valid.sum(-1).to(torch.int32)
        if mode == "seq":
            cache = self._seq_append(cache, k, v, nv)
        else:
            cache = cache.append(k.transpose(1, 2), v.transpose(1, 2),
                                 n_valid=nv)
        out = chunked_attention(q, k, v, positions, positions, self._scale,
                                window=c.window, chunk=CHUNK)
        return self._serve_out(out, mode, cache), cache

    def local_decode_step(self, x, cache, positions=None):
        """``decode_step``'s share of this rank (off a mesh,
        ``decode_step``).  A ``seq_sharded`` cache merges the ranks'
        partial softmaxes with one MAX and one SUM all-reduce over
        ``model``."""
        mode = self._serve_mode(cache)
        if isinstance(cache, PagedWindowKVCache):
            return self._decode_window_paged(x, cache, positions, mode)
        if isinstance(cache, PagedDenseKVCache):
            return self._decode_dense_paged(x, cache, positions, mode)
        if isinstance(cache, WindowKVCache):
            return self._decode_window(x, cache, positions, mode)
        if not isinstance(cache, DenseKVCache):
            raise NotImplementedError(f"{type(cache).__name__} is not ported")
        return self._decode_dense(x, cache, positions, mode)

    def local_prefill_packed(self, x, cache, meta):
        """``prefill_packed``'s share of this rank (off a mesh,
        ``prefill_packed``)."""
        mode = self._serve_mode(cache)
        if isinstance(cache, PagedWindowKVCache):
            return self._prefill_packed_window(x, cache, meta, mode)
        if not isinstance(cache, PagedDenseKVCache):
            raise ValueError(f"packed prefill requires a paged cache, got "
                             f"{type(cache).__name__}")
        return self._prefill_packed_dense(x, cache, meta, mode)

    # -- seq-sharded contiguous caches: a rank holds positions (or ring
    #    slots) [rank * n, (rank + 1) * n) of every head
    def _seq_lo(self, cache) -> int:
        return self.mesh_tp.rank * cache.k.shape[1]

    def _seq_append(self, cache: DenseKVCache, k, v, n_valid=None):
        """``DenseKVCache.append`` of k/v (B, Hkv, T, d) on a seq-sharded
        cache: this rank writes the positions of its slice, and every
        rank's ``length`` advances."""
        B, _, T, _ = k.shape
        n, lo = cache.k.shape[1], self._seq_lo(cache)
        pos = cache.length.long()[:, None] + torch.arange(
            T, device=k.device) - lo
        rows = torch.arange(B, device=k.device)[:, None].expand(B, T)
        keep = ((pos >= 0) & (pos < n)).reshape(-1)
        rows, pos = rows.reshape(-1), pos.clamp(0, n - 1).reshape(-1)
        for dst, t in ((cache.k, k), (cache.v, v)):
            scatter_kept(dst, rows, pos,
                         t.transpose(1, 2).reshape(B * T, *t.shape[1:2],
                                                   t.shape[-1]), keep)
        adv = T if n_valid is None else n_valid.to(torch.int32)
        return DenseKVCache(cache.k, cache.v, cache.length + adv)

    def _seq_ring_write(self, cache: WindowKVCache, k, v, pos, keep):
        """Write tokens at their ring slots ``pos % W`` where this rank
        holds the slot: k/v (M, Hkv, d), pos (M,), keep (M,); rows
        ``row`` = the batch row of each token (M = B * T, row-major)."""
        B, n = cache.positions.shape
        W, lo = n * self.mesh_tp.size, self._seq_lo(cache)
        T = pos.shape[0] // B
        rows = torch.arange(B, device=pos.device)[:, None].expand(
            B, T).reshape(-1)
        slot = pos.long() % W - lo
        keep = keep & (slot >= 0) & (slot < n)
        slot = slot.clamp(0, n - 1)
        scatter_kept(cache.k, rows, slot, k, keep)
        scatter_kept(cache.v, rows, slot, v, keep)
        scatter_kept(cache.positions, rows, slot, pos.to(torch.int32), keep)

    def _seq_merge(self, s, ok, v):
        """Attention over the keys of every rank's slice: this rank's
        partial softmax (``softmax_partials``) merged with one MAX and one
        SUM all-reduce over ``model``."""
        m, l, acc = softmax_partials(s, ok, v)
        m_all = tp_all_reduce(m.clone(), self.mesh_tp, "max")
        return finish_partials(tp_all_reduce(
            rescale_partials(m, l, acc, m_all), self.mesh_tp))

    def _prefill_dense_paged(self, x, cache: PagedDenseKVCache,
                             positions=None, valid=None, mode="plain"):
        """New K/V scatter into the row's pool blocks, then attention runs
        over the row's whole gathered range with a validity mask (fresh
        prefill and prefix continuation alike)."""
        c = self.cfg
        B, T, _ = x.shape
        if positions is None:
            positions = cache.length.long()[:, None] + torch.arange(
                T, device=x.device)[None]
        q, k, v = self._serve_qkv(x, mode, cache)
        q = self._rope(q, positions)
        k = self._rope(k, positions)
        nv = None if valid is None else valid.sum(-1).to(torch.int32)
        cache = cache.append(k.transpose(1, 2), v.transpose(1, 2), n_valid=nv)
        kk, vv = cache.gather()                        # (B, S, Hkv, d)
        S = kk.shape[1]
        k_pos = torch.arange(S, device=x.device).expand(B, S)
        k_valid = k_pos < cache.length[:, None]
        out = chunked_attention(q, kk.transpose(1, 2), vv.transpose(1, 2),
                                positions, k_pos, self._scale,
                                window=c.window, k_valid=k_valid,
                                chunk=CHUNK)
        return self._serve_out(out, mode, cache), cache

    def _prefill_window_paged(self, x, cache: PagedWindowKVCache,
                              positions=None, valid=None, mode="plain"):
        """Paged window prefill, past-aware: the ring as it was before the
        append (gathered once) supplies the past keys — it holds the last W
        past tokens, every key a new query's window can reach."""
        c = self.cfg
        B, T, _ = x.shape
        if positions is None:
            positions = cache.length.long()[:, None] + torch.arange(
                T, device=x.device)[None]
        pk, pv = cache.gather()                        # copies, pre-append
        ppos = cache.positions.clone()                 # the append writes it
        q, k, v = self._serve_qkv(x, mode, cache)
        q = self._rope(q, positions)
        k = self._rope(k, positions)
        nv = None if valid is None else valid.sum(-1).to(torch.int32)
        cache = cache.append(k.transpose(1, 2), v.transpose(1, 2), n_valid=nv)
        k_all = torch.cat([pk.transpose(1, 2).to(k.dtype), k], dim=2)
        v_all = torch.cat([pv.transpose(1, 2).to(v.dtype), v], dim=2)
        kpos_all = torch.cat([ppos.long(),
                              torch.broadcast_to(positions, (B, T)).long()], 1)
        new_valid = (torch.ones((B, T), dtype=torch.bool, device=x.device)
                     if valid is None else torch.broadcast_to(valid, (B, T)))
        k_valid = torch.cat([ppos >= 0, new_valid], dim=1)
        out = chunked_attention(q, k_all, v_all, positions, kpos_all,
                                self._scale, window=c.window, k_valid=k_valid,
                                chunk=CHUNK)
        return self._serve_out(out, mode, cache), cache

    def _prefill_window(self, x, cache: WindowKVCache, positions=None,
                        valid=None, mode="plain"):
        """Window prefill: the full forward (the flash kernel with
        ``impl="kernel"``), then the ring keeps the last W valid tokens'
        K/V at slot ``position % W`` — the slot ``append_one`` would have
        used, so the first decode step overwrites the oldest kept token.
        Right-pad tokens (``valid`` False) are dropped, and ``length``
        advances by the real token count.  The ring is rewritten in place
        from empty, as the JAX package builds it anew; a seq-sharded ring
        keeps the slots of this rank's slice."""
        B, T, _ = x.shape
        pos = (positions if positions is not None
               else torch.arange(T, device=x.device).expand(B, T))
        q, k, v = self._serve_qkv(x, mode, cache)
        q = self._rope(q, pos)
        k = self._rope(k, pos)
        y = self._serve_out(self._attend(q, k, v, pos), mode, cache)
        W = cache.k.shape[1] * (self.mesh_tp.size if mode == "seq" else 1)
        nv = (torch.full((B,), T, dtype=torch.int32, device=x.device)
              if valid is None else valid.sum(-1).to(torch.int32))
        base_pos = torch.broadcast_to(pos, (B, T)).long()
        t = torch.arange(T, device=x.device)[None]
        keep = ((t < nv[:, None]) & (t >= nv[:, None] - W)).reshape(-1)
        cache.k.zero_()
        cache.v.zero_()
        cache.positions.fill_(-1)
        kt = k.transpose(1, 2).reshape(B * T, -1, k.shape[-1])
        vt = v.transpose(1, 2).reshape(B * T, -1, v.shape[-1])
        if mode == "seq":
            self._seq_ring_write(cache, kt, vt, base_pos.reshape(-1), keep)
        else:
            rows = torch.arange(B, device=x.device)[:, None].expand(B, T)
            rows, slots = rows.reshape(-1), (base_pos % W).reshape(-1)
            scatter_kept(cache.k, rows, slots, kt, keep)
            scatter_kept(cache.v, rows, slots, vt, keep)
            scatter_kept(cache.positions, rows, slots, base_pos.reshape(-1),
                         keep)
        return y, WindowKVCache(cache.k, cache.v, cache.positions,
                                cache.length + nv)

    def _window_attend(self, q, kk, vv, kpos, pos, mode, cache):
        """Ring-decode attention shared by the contiguous and paged window
        caches: q (B, H, 1, d); kk/vv (B, W, Hkv, d) in the ring layout;
        kpos (B, W) positions (-1 = empty); pos (B, 1)."""
        B, H, _, d = q.shape
        kk = kk.transpose(1, 2).to(q.dtype)                # (B, Hkv, W, d)
        vv = vv.transpose(1, 2).to(q.dtype)
        Hkv = kk.shape[1]
        qg = q.reshape(B, Hkv, H // Hkv, 1, d).float()
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, kk.float()) * self._scale
        ok = ((kpos >= 0)[:, None, None, None, :]
              & (kpos[:, None, None, None, :] <= pos[:, None, None, :, None]))
        if mode == "seq":
            out = self._seq_merge(s, ok, vv[:, :, None, None]).to(vv.dtype)
        else:
            s = torch.where(ok, s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            out = torch.einsum("bgrqk,bgkd->bgrqd", p.to(vv.dtype), vv)
        return self._serve_out(out.reshape(B, H, 1, d), mode, cache)

    def _decode_window(self, x, cache: WindowKVCache, positions=None,
                       mode="plain"):
        pos = cache.length.long()[:, None] if positions is None else positions
        q, k, v = self._serve_qkv(x, mode, cache)         # (B, H, 1, d)
        q = self._rope(q, pos)
        k = self._rope(k, pos)
        if mode == "seq":
            B = x.shape[0]
            self._seq_ring_write(cache, k[:, :, 0], v[:, :, 0],
                                 cache.length, torch.ones(
                                     B, dtype=torch.bool, device=x.device))
            cache = WindowKVCache(cache.k, cache.v, cache.positions,
                                  cache.length + 1)
        else:
            cache = cache.append_one(k[:, :, 0], v[:, :, 0])
        return self._window_attend(q, cache.k, cache.v, cache.positions,
                                   pos, mode, cache), cache

    def _decode_window_paged(self, x, cache: PagedWindowKVCache,
                             positions=None, mode="plain"):
        """The gather path (the paged decode kernel serves dense caches
        only, as in the JAX package)."""
        pos = cache.length.long()[:, None] if positions is None else positions
        q, k, v = self._serve_qkv(x, mode, cache)
        q = self._rope(q, pos)
        k = self._rope(k, pos)
        cache = cache.append_one(k[:, :, 0], v[:, :, 0])
        kk, vv = cache.gather()            # ring layout == WindowKVCache.k
        return self._window_attend(q, kk, vv, cache.positions, pos, mode,
                                   cache), cache

    def _prefill_packed_window(self, x, cache: PagedWindowKVCache, meta,
                               mode="plain"):
        """Window side of packed prefill: unpack to a (N, C) right-padded
        batch over an N-row view of the paged cache (row fields gathered,
        pools shared) and reuse ``_prefill_window_paged``; the updated row
        fields are written back in place (inactive segments, row -1, are
        not).  The window side is O(W)-bounded, so the N*C re-projection is
        the price of sharing the ring math, as in the JAX package."""
        B = cache.block_table.shape[0]
        rows = meta["rows"].long()
        rowc = rows.clamp(0, B - 1)
        gc = PagedWindowKVCache(cache.k, cache.v, cache.block_table[rowc],
                                cache.positions[rowc], cache.length[rowc])
        xs = x[0][meta["tok_idx"]] * meta["in_seg"][..., None].to(x.dtype)
        y_seg, gc2 = self._prefill_window_paged(xs, gc, None, meta["in_seg"],
                                                mode)
        # segment of each batch row (-1: none); slot B takes the inactive
        sel = torch.full((B + 1,), -1, dtype=torch.long, device=x.device)
        sel.index_copy_(0, torch.where(rows < 0, B, rows),
                        torch.arange(rows.shape[0], device=x.device))
        sel = sel[:B]
        has, selc = sel >= 0, sel.clamp(min=0)
        cache.positions.copy_(torch.where(has[:, None], gc2.positions[selc],
                                          cache.positions))
        length = torch.where(has, gc2.length[selc], cache.length)
        cache = PagedWindowKVCache(cache.k, cache.v, cache.block_table,
                                   cache.positions, length)
        segc = meta["seg_of_tok"].long().clamp(min=0)
        y = y_seg[segc, meta["local_of_tok"].long()]          # (C, h)
        y = torch.where((meta["row_of_tok"] >= 0)[:, None], y, 0.0)
        return y[None].to(y_seg.dtype), cache

    def _prefill_packed_dense(self, x, cache: PagedDenseKVCache, meta,
                              mode="plain"):
        """Dense side of packed prefill: ONE pass over the packed stream.
        K/V scatter straight into each token's row blocks
        (``append_packed``), then every token attends its row's keys up to
        its own position through ``paged_prefill_attention`` (the CUDA
        kernel on the card)."""
        if self.cfg.window:
            raise ValueError("a paged dense cache implies window == 0")
        pos = meta["pos_of_tok"][None]                     # (1, C)
        q, k, v = self._serve_qkv(x, mode, cache)         # (1, H, C, d)
        q = self._rope(q, pos)
        k = self._rope(k, pos)
        cache = cache.append_packed(k[0].transpose(0, 1), v[0].transpose(0, 1),
                                    meta["row_of_tok"], meta["pos_of_tok"])
        out = paged_prefill_attention(
            q[0].transpose(0, 1).contiguous(), cache, meta["cu"],
            meta["rows"], meta["past_lens"], scale=self._scale)
        return self._serve_out(out.transpose(0, 1)[None], mode,
                               cache), cache

    def _decode_dense_paged(self, x, cache: PagedDenseKVCache, positions=None,
                            mode="plain"):
        """Append into the row's pool blocks, then paged-attention decode
        (the CUDA kernel for CUDA tensors)."""
        pos = cache.length.long()[:, None] if positions is None else positions
        q, k, v = self._serve_qkv(x, mode, cache)         # (B, H, 1, d)
        q = self._rope(q, pos)
        k = self._rope(k, pos)
        cache = cache.append(k.transpose(1, 2), v.transpose(1, 2))
        out = paged_attention_decode(q[:, :, 0].contiguous(), cache,
                                     scale=self._scale)
        return self._serve_out(out[:, :, None], mode, cache), cache

    def _decode_dense(self, x, cache: DenseKVCache, positions=None,
                      mode="plain"):
        c = self.cfg
        B = x.shape[0]
        pos = cache.length.long()[:, None] if positions is None else positions
        q, k, v = self._serve_qkv(x, mode, cache)
        q = self._rope(q, pos)
        k = self._rope(k, pos)
        if mode == "seq":
            cache = self._seq_append(cache, k, v)
            lo = self._seq_lo(cache)
        else:
            cache = cache.append(k.transpose(1, 2), v.transpose(1, 2))
            lo = 0
        S, Hkv = cache.k.shape[1], cache.k.shape[2]
        H, d = q.shape[1], q.shape[-1]
        k_pos = lo + torch.arange(S, device=x.device).expand(B, S)
        k_valid = k_pos < cache.length[:, None]
        qg = q.reshape(B, Hkv, H // Hkv, 1, d).float()
        s = torch.einsum("bgrqd,bsgd->bgrqs", qg, cache.k.float()) * self._scale
        ok = (pos[:, None, None, :, None] >= k_pos[:, None, None, None, :]) \
            & k_valid[:, None, None, None, :]
        if c.window:
            ok &= (pos[:, None, None, :, None]
                   - k_pos[:, None, None, None, :]) < c.window
        if mode == "seq":
            vv = cache.v.transpose(1, 2)[:, :, None, None]
            out = self._seq_merge(s, ok, vv)
        else:
            s = torch.where(ok, s, NEG_INF)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            out = torch.einsum("bgrqs,bsgd->bgrqd", p, cache.v.float())
            out = out / p.sum(-1).clamp_min(1e-30)[..., None]
        out = out.to(self.compute_dtype).reshape(B, H, 1, d)
        return self._serve_out(out, mode, cache), cache


# ----------------------------------------------- partial softmax (seq shards)
def softmax_partials(s, ok, v):
    """One slice of the keys' share of a softmax attention: s (..., K)
    fp32 scores, ok (..., K) the keys that count, v (..., K, d) (batch
    dims broadcast).  Returns (m, l, acc) in fp32: the row max over the
    counted keys (NEG_INF where none count), the sum of exp(s - m) over
    them and the unnormalised output sum exp(s - m) v."""
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    acc = torch.matmul(p[..., None, :], v.float())[..., 0, :]
    return m, p.sum(-1), acc


def rescale_partials(m, l, acc, m_all):
    """A slice's (l, acc) rescaled to the row max of every slice
    ``m_all``, packed as (..., 1 + d): the terms that sum over the
    slices."""
    e = torch.exp(m - m_all)
    return torch.cat([(l * e)[..., None], acc * e[..., None]], -1)


def finish_partials(packed):
    """The sum over the slices of ``rescale_partials`` -> the attention
    output (..., d)."""
    return packed[..., 1:] / packed[..., :1].clamp_min(1e-30)
