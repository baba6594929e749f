"""Dense GQA attention (port of the ``MultiHeadAttention`` part of
``repro.core.attention``).

  * ``chunked_attention`` — flash-style attention over KV chunks with a
    running (max, denom, acc) in fp32: a Python loop where the JAX package
    has ``lax.scan``.  The dense prefill over the gathered paged KV runs
    here (plain PyTorch, as the JAX package leaves it to XLA).
  * ``gqa_attention``     — direct (unchunked) GQA attention.
  * ``MultiHeadAttention`` — projections, RoPE, the forward pass, and the
    serving ``prefill`` / ``decode_step`` on contiguous and paged dense
    caches.  Paged decode goes through ``paged_attention_decode`` (the
    CUDA kernel on the card).  Window caches, MLA and the flash kernels are
    not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import AttentionConfig
from repro_torch.core import rope as rope_lib
from repro_torch.core.kv_cache import DenseKVCache
from repro_torch.nn.layers import param, trunc_normal_
from repro_torch.serve.paged_attention import paged_attention_decode
from repro_torch.serve.paged_kv import PagedDenseKVCache

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1
CHUNK = 512          # KV chunk of ``chunked_attention`` in the module's calls


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
    """GQA attention with RoPE (partial rotary via ``rotary_frac``)."""

    def __init__(self, d_model: int, cfg: AttentionConfig,
                 param_dtype=torch.float32, compute_dtype=torch.float32,
                 rotary_frac: float = 1.0, device=None):
        super().__init__()
        if cfg.mrope_sections or cfg.kind != "gqa":
            raise NotImplementedError("only plain-RoPE GQA attention is ported")
        self.d_model, self.cfg = d_model, cfg
        self.compute_dtype = compute_dtype
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
        q = q.to(cd).reshape(B, T, c.n_heads, c.d_head).transpose(1, 2)
        k = k.to(cd).reshape(B, T, c.n_kv_heads, c.d_head).transpose(1, 2)
        v = v.to(cd).reshape(B, T, c.n_kv_heads, c.d_head).transpose(1, 2)
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

    def forward(self, x, positions=None, segments=None):
        """Training / prefill-style full forward.  x: (B, T, h).

        ``segments``: optional (B, T) document ids of packed rows.  Their
        ``positions`` restart at every document (RoPE), so causality takes
        the packed order and seg_q == seg_k keeps attention inside the
        document."""
        c = self.cfg
        B, T, _ = x.shape
        if positions is None:
            positions = torch.arange(T, device=x.device).expand(B, T)
        q, k, v = self._qkv(x)
        q = self._rope(q, positions)
        k = self._rope(k, positions)
        if segments is None:
            out = chunked_attention(q, k, v, positions, positions,
                                    self._scale, window=c.window, chunk=CHUNK)
        else:
            packed = torch.arange(T, device=x.device).expand(B, T)
            out = chunked_attention(q, k, v, packed, packed, self._scale,
                                    window=c.window, chunk=CHUNK,
                                    q_seg=segments, k_seg=segments)
        return self._out(out)

    # ---- serving ----
    def prefill(self, x, cache, positions=None, valid=None):
        """``valid``: optional (B, T) bool — False marks right-pad tokens;
        it only sets how far the cache ``length`` advances."""
        if isinstance(cache, PagedDenseKVCache):
            return self._prefill_dense_paged(x, cache, positions, valid)
        if not isinstance(cache, DenseKVCache):
            raise NotImplementedError(f"{type(cache).__name__} is not ported")
        c = self.cfg
        B, T, _ = x.shape
        if positions is None:
            positions = torch.arange(T, device=x.device).expand(B, T)
        q, k, v = self._qkv(x)
        q = self._rope(q, positions)
        k = self._rope(k, positions)
        nv = None if valid is None else valid.sum(-1).to(torch.int32)
        cache = cache.append(k.transpose(1, 2), v.transpose(1, 2), n_valid=nv)
        out = chunked_attention(q, k, v, positions, positions, self._scale,
                                window=c.window, chunk=CHUNK)
        return self._out(out), cache

    def _prefill_dense_paged(self, x, cache: PagedDenseKVCache,
                             positions=None, valid=None):
        """New K/V scatter into the row's pool blocks, then attention runs
        over the row's whole gathered range with a validity mask (fresh
        prefill and prefix continuation alike)."""
        c = self.cfg
        B, T, _ = x.shape
        if positions is None:
            positions = cache.length.long()[:, None] + torch.arange(
                T, device=x.device)[None]
        q, k, v = self._qkv(x)
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
        return self._out(out), cache

    def _decode_dense_paged(self, x, cache: PagedDenseKVCache, positions=None):
        """Append into the row's pool blocks, then paged-attention decode
        (the CUDA kernel for CUDA tensors)."""
        pos = cache.length.long()[:, None] if positions is None else positions
        q, k, v = self._qkv(x)                             # (B, H, 1, d)
        q = self._rope(q, pos)
        k = self._rope(k, pos)
        cache = cache.append(k.transpose(1, 2), v.transpose(1, 2))
        out = paged_attention_decode(q[:, :, 0].contiguous(), cache,
                                     scale=self._scale)
        return self._out(out[:, :, None]), cache

    def decode_step(self, x, cache, positions=None):
        """x: (B, 1, h); attends over the cache + itself."""
        if isinstance(cache, PagedDenseKVCache):
            return self._decode_dense_paged(x, cache, positions)
        if not isinstance(cache, DenseKVCache):
            raise NotImplementedError(f"{type(cache).__name__} is not ported")
        c = self.cfg
        B = x.shape[0]
        pos = cache.length.long()[:, None] if positions is None else positions
        q, k, v = self._qkv(x)
        q = self._rope(q, pos)
        k = self._rope(k, pos)
        cache = cache.append(k.transpose(1, 2), v.transpose(1, 2))
        S = cache.k.shape[1]
        k_pos = torch.arange(S, device=x.device).expand(B, S)
        k_valid = k_pos < cache.length[:, None]
        Hkv = c.n_kv_heads
        R = c.n_heads // Hkv
        qg = q.reshape(B, Hkv, R, 1, c.d_head).float()
        s = torch.einsum("bgrqd,bsgd->bgrqs", qg, cache.k.float()) * self._scale
        ok = (pos[:, None, None, :, None] >= k_pos[:, None, None, None, :]) \
            & k_valid[:, None, None, None, :]
        if c.window:
            ok &= (pos[:, None, None, :, None]
                   - k_pos[:, None, None, None, :]) < c.window
        s = torch.where(ok, s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        out = torch.einsum("bgrqs,bsgd->bgrqd", p, cache.v.float())
        out = out / p.sum(-1).clamp_min(1e-30)[..., None]
        out = out.to(self.compute_dtype).reshape(B, c.n_heads, 1, c.d_head)
        return self._out(out), cache
