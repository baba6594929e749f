"""Block-choice MoSA inner attention: the selected tokens come as whole KV
blocks of ``bs`` tokens, one index and one router score per block.

Replaces the four TPU kernels of ``repro/kernels/mosa_block.py``:
``_mosa_block_kernel`` (#5, serving and no-grad calls),
``_mosa_block_fwd_res_kernel`` (#6, the training forward),
``_mosa_block_bwd_dq_kernel`` (#7) and ``_mosa_block_bwd_dkv_kernel`` (#8).
The kernels take ``bidx`` (B, H, NB) int32 (-1 = empty slot) and ``rblk``
(B, H, NB) fp32 and expand them inside the kernel, per element: selected
row j of a (b, h) row holds position ``pos = bidx[j / bs] * bs + j % bs``,
valid iff ``bidx >= 0 and pos < T`` (T is the true sequence length: the
last block may run past it).  The mask is

    seg_q == seg_k  and  pos_q >= pos_k  and  valid_k,

the output of query row j is scaled by ``rblk[j / bs]``, and a query row
that is not valid comes out as zeros.  At ``bs = 1`` the expansion is the
identity and each function equals its token-choice counterpart
(``kernels.mosa_attention``, ``kernels.mosa_backward``) bit for bit.

  * ``*_ref`` — the plain PyTorch versions (what CPU tensors run, and what
    the kernels are checked against on the card);
  * ``*_cuda`` — the hand-written CUDA kernels, the block-choice mode of
    ``csrc/mosa_attention.cu`` and ``csrc/mosa_backward.cu``, each with its
    launch counter.  #5 and #6 have two routes, as token choice's #1 and
    #2: the one-row kernel (``*_row_cuda``) when ``row_fits(S, d)`` and the
    streaming kernel (``*_stream_cuda``: owned tiles of 64 queries, key
    tiles of 32 skipped by value over the expanded positions) otherwise,
    counted on one counter per kernel.  The backward has two routes, as token choice's has:
    ``mosa_block_attention_bwd_fused_cuda``, #7 and #8 fused into one
    launch (the block form of ``mosa_bwd_fused_kernel``) when a row's S =
    NB * bs selected tokens fit one tile (``fused_bwd_fits``: S <= 64,
    d <= 128), and the split #7 (``_bwd_dq_cuda``) and #8
    (``_bwd_dkv_cuda``) otherwise; ``mosa_block_attention_bwd_cuda``
    picks between them;
  * ``MoSABlockAttentionFunction`` — the ``torch.autograd.Function`` (the
    counterpart of ``_build`` in the JAX module), whose router gradient is
    per block;
  * ``mosa_block_attention`` — dispatch, as ``mosa_attention`` does.

Unlike the TPU wrapper nothing is padded at d <= 128: S = NB * bs for any
NB, any d <= 128.  At 128 < d <= 256 every kernel takes the wide route
(``csrc/wide_attention.cu``, the inputs zero-padded to d 256), as token
choice's do.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODE, NARROW_HEAD_DIM,
                                      LaunchCounter, check_head_dim,
                                      check_tensor, launch, route_entry,
                                      unpad_head)
from repro_torch.kernels.mosa_attention import (check_route, pair_mask,
                                                route_of, row_fits,
                                                softmax_parts, wide)
from repro_torch.kernels.mosa_backward import (FUSED_MAX_S, bwd_from_mask,
                                               fused_bwd_fits)

LAUNCHES = LaunchCounter("mosa_block_attention")
LAUNCHES_FWD_RES = LaunchCounter("mosa_block_attention_fwd_res")
LAUNCHES_BWD = LaunchCounter("mosa_block_attention_bwd")
LAUNCHES_DQ = LaunchCounter("mosa_block_attention_bwd_dq")
LAUNCHES_DKV = LaunchCounter("mosa_block_attention_bwd_dkv")


def expand_blocks(bidx, bs: int, T: int):
    """(B, H, NB) block indices -> per-token (pos, ok), both (B, H, NB*bs):
    ``pos = bidx * bs + offset`` (not clamped) and ``ok = bidx >= 0 and
    pos < T``."""
    off = torch.arange(bs, device=bidx.device, dtype=bidx.dtype)
    pos = bidx[..., None] * bs + off
    ok = (bidx[..., None] >= 0) & (pos < T)
    return pos.flatten(-2), ok.flatten(-2)


def _block_mask(bidx, bs, T, seg):
    """The pair mask of the block kernels and the query rows' validity."""
    pos, ok = expand_blocks(bidx, bs, T)
    return pair_mask(pos, pos, ok, seg), ok


def scale_rows(x, rblk, bs):
    """x (B, H, NB*bs, d) with each row scaled by its block's score in
    rblk (B, H, NB), through a view (no per-token copy of the scores)."""
    return (x.unflatten(2, (-1, bs)) * rblk[..., None, None]).flatten(2, 3)


def mosa_block_attention_ref(q, k, v, bidx, rblk, bs: int, T: int,
                             scale=None, seg=None):
    """q, k, v: (B, H, S = NB*bs, d) block-major selected tokens; bidx:
    (B, H, NB) block indices (-1 = empty); rblk: (B, H, NB) fp32 block
    scores; seg: optional (B, H, S) segment ids.  Returns (B, H, S, d) in
    q.dtype: softmax(q k^T masked) v times the query's block score, zero on
    invalid query rows."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    mask, ok = _block_mask(bidx, bs, T, seg)
    _, p, denom = softmax_parts(q, k, mask, scale)
    att = torch.einsum("bhqk,bhkd->bhqd", p / denom, wide(v))
    att = scale_rows(att, wide(rblk), bs) * ok[..., None]
    return att.to(q.dtype)


def mosa_block_attention_fwd_res_ref(q, k, v, bidx, bs: int, T: int,
                                     scale=None, seg=None):
    """The training forward in plain PyTorch: ``o_pre`` (B, H, S, d) fp32
    = softmax(q k^T masked) v, not scaled, zero on invalid query rows, and
    ``lse`` (B, H, S) fp32 = m + log(max(l, 1e-30))."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    mask, ok = _block_mask(bidx, bs, T, seg)
    m, p, denom = softmax_parts(q, k, mask, scale)
    o_pre = torch.einsum("bhqk,bhkd->bhqd", p / denom, wide(v))
    return (torch.where(ok[..., None], o_pre, 0.0),
            m[..., 0] + torch.log(denom[..., 0]))


def mosa_block_attention_bwd_ref(q, k, v, bidx, gt, lse, delta, bs: int,
                                 T: int, scale=None, seg=None):
    """(dq, dk, dv) by recompute under the block mask: P = exp(S - lse) on
    the mask, dS = P * (g~ . v - delta), dQ = scale dS K, dK = scale dS^T Q,
    dV = P^T g~.  gt = g~ (B, H, S, d) fp32 and delta (B, H, S) fp32 come
    from the caller, zero on invalid query rows."""
    mask, _ = _block_mask(bidx, bs, T, seg)
    return bwd_from_mask(q, k, v, mask, gt, lse, delta, scale)


# ------------------------------------------------------------------ CUDA
def _check_block_inputs(name, q, k, v, bidx, seg, bs, T):
    """Validate the shared inputs of the block kernels; returns
    (B, H, S, d, NB)."""
    check_head_dim(q.shape[-1])
    if not q.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, d), got {tuple(q.shape)}")
    B, H, S, d = q.shape
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if S < 1:
        raise ValueError(f"need S >= 1, got S={S}")
    if bs < 1 or S % bs or T < 1:
        raise ValueError(f"need S = NB * bs and T >= 1, got S={S}, bs={bs}, "
                         f"T={T}")
    NB = S // bs
    dev = q.device
    check_tensor("q", q, (B, H, S, d), q.dtype, dev)
    check_tensor("k", k, (B, H, S, d), q.dtype, dev)
    check_tensor("v", v, (B, H, S, d), q.dtype, dev)
    check_tensor("bidx", bidx, (B, H, NB), torch.int32, dev)
    if seg is not None:
        check_tensor("seg", seg, (B, H, S), torch.int32, dev)
    return B, H, S, d, NB


def _forward_cuda(route, q, k, v, bidx, rblk, bs, T, scale, seg):
    """One launch of #5 (``rblk`` given) or #6 (``rblk`` None) on
    ``route``, "row", "stream" or "wide"."""
    name = ("mosa_block_attention" if rblk is not None
            else "mosa_block_attention_fwd_res")
    B, H, S, d, NB = _check_block_inputs(f"{name}_{route}_cuda", q, k, v,
                                         bidx, seg, bs, T)
    check_route(route, S, d)
    entry, (q, k, v) = route_entry(
        f"repro_{name}" + ("_row" if route == "row" else ""), d, q, k, v)
    scale = float(scale if scale is not None else d ** -0.5)
    w = q.shape[-1]
    if rblk is not None:
        check_tensor("rblk", rblk, (B, H, NB), torch.float32, q.device)
        out = torch.empty_like(q)
        launch(entry, LAUNCHES, q, k, v, bidx, seg, rblk, out, B * H, S, w,
               bs, T, scale, DTYPE_CODE[q.dtype])
        return unpad_head(out, d)
    o_pre = torch.empty((B, H, S, w), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    launch(entry, LAUNCHES_FWD_RES, q, k, v, bidx, seg, o_pre, lse, B * H, S,
           w, bs, T, scale, DTYPE_CODE[q.dtype])
    return unpad_head(o_pre, d), lse


def mosa_block_attention_row_cuda(q, k, v, bidx, rblk, bs: int, T: int,
                                  scale=None, seg=None):
    """Kernel #5 on the one-row route.  q, k, v: (B, H, NB*bs, d)
    contiguous fp32 or bf16 with ``row_fits(NB*bs, d)``; bidx: (B, H, NB)
    int32; rblk: (B, H, NB) fp32; seg: optional (B, H, NB*bs) int32.
    Raises on anything else."""
    return _forward_cuda("row", q, k, v, bidx, rblk, bs, T, scale, seg)


def mosa_block_attention_stream_cuda(q, k, v, bidx, rblk, bs: int, T: int,
                                     scale=None, seg=None):
    """Kernel #5 on the streaming route (any S, d <= 128)."""
    return _forward_cuda("stream", q, k, v, bidx, rblk, bs, T, scale, seg)


def mosa_block_attention_wide_cuda(q, k, v, bidx, rblk, bs: int, T: int,
                                   scale=None, seg=None):
    """Kernel #5 on the wide route (any S, 128 < d <= 256)."""
    return _forward_cuda("wide", q, k, v, bidx, rblk, bs, T, scale, seg)


def mosa_block_attention_cuda(q, k, v, bidx, rblk, bs: int, T: int,
                              scale=None, seg=None):
    """Kernel #5 on the route ``fwd_route(S, d)`` names (the one-row kernel
    where ``row_fits(S, d)``, the wide one at d > 128, the streaming one
    otherwise).  Inputs as ``mosa_block_attention_row_cuda``."""
    fn = {"row": mosa_block_attention_row_cuda,
          "stream": mosa_block_attention_stream_cuda,
          "wide": mosa_block_attention_wide_cuda}[route_of(q)]
    return fn(q, k, v, bidx, rblk, bs, T, scale, seg)


def mosa_block_attention_fwd_res_row_cuda(q, k, v, bidx, bs: int, T: int,
                                          scale=None, seg=None):
    """Kernel #6 on the one-row route: (o_pre fp32 (B, H, S, d), lse fp32
    (B, H, S)).  Inputs as ``mosa_block_attention_row_cuda`` without
    rblk."""
    return _forward_cuda("row", q, k, v, bidx, None, bs, T, scale, seg)


def mosa_block_attention_fwd_res_stream_cuda(q, k, v, bidx, bs: int, T: int,
                                             scale=None, seg=None):
    """Kernel #6 on the streaming route."""
    return _forward_cuda("stream", q, k, v, bidx, None, bs, T, scale, seg)


def mosa_block_attention_fwd_res_wide_cuda(q, k, v, bidx, bs: int, T: int,
                                           scale=None, seg=None):
    """Kernel #6 on the wide route."""
    return _forward_cuda("wide", q, k, v, bidx, None, bs, T, scale, seg)


def mosa_block_attention_fwd_res_cuda(q, k, v, bidx, bs: int, T: int,
                                      scale=None, seg=None):
    """Kernel #6 on the route ``mosa_block_attention_cuda`` takes."""
    fn = {"row": mosa_block_attention_fwd_res_row_cuda,
          "stream": mosa_block_attention_fwd_res_stream_cuda,
          "wide": mosa_block_attention_fwd_res_wide_cuda}[route_of(q)]
    return fn(q, k, v, bidx, bs, T, scale, seg)


def _check_bwd(name, q, k, v, bidx, seg, gt, lse, delta, bs, T):
    B, H, S, d, _ = _check_block_inputs(name, q, k, v, bidx, seg, bs, T)
    dev = q.device
    check_tensor("gt", gt, (B, H, S, d), torch.float32, dev)
    check_tensor("lse", lse, (B, H, S), torch.float32, dev)
    check_tensor("delta", delta, (B, H, S), torch.float32, dev)
    return B * H, S, d


def mosa_block_attention_bwd_dq_cuda(q, k, v, bidx, gt, lse, delta, bs: int,
                                     T: int, scale=None, seg=None):
    """Kernel #7: dq.  Inputs as ``mosa_block_attention_fwd_res_cuda`` plus
    gt (B, H, S, d), lse and delta (B, H, S), all fp32."""
    BH, S, d = _check_bwd("mosa_block_attention_bwd_dq_cuda", q, k, v, bidx,
                          seg, gt, lse, delta, bs, T)
    scale = float(scale if scale is not None else d ** -0.5)
    entry, (q, k, v, gt) = route_entry("repro_mosa_block_attention_bwd_dq",
                                       d, q, k, v, gt)
    dq = torch.empty_like(q)
    launch(entry, LAUNCHES_DQ, q, k, v, bidx, seg, gt, lse, delta, dq, BH, S,
           q.shape[-1], bs, T, scale, DTYPE_CODE[q.dtype])
    return unpad_head(dq, d)


def mosa_block_attention_bwd_dkv_cuda(q, k, v, bidx, gt, lse, delta,
                                      bs: int, T: int, scale=None, seg=None):
    """Kernel #8: (dk, dv).  Inputs as ``mosa_block_attention_bwd_dq_cuda``."""
    BH, S, d = _check_bwd("mosa_block_attention_bwd_dkv_cuda", q, k, v, bidx,
                          seg, gt, lse, delta, bs, T)
    scale = float(scale if scale is not None else d ** -0.5)
    entry, (q, k, v, gt) = route_entry("repro_mosa_block_attention_bwd_dkv",
                                       d, q, k, v, gt)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch(entry, LAUNCHES_DKV, q, k, v, bidx, seg, gt, lse, delta, dk, dv,
           BH, S, q.shape[-1], bs, T, scale, DTYPE_CODE[q.dtype])
    return unpad_head(dk, d), unpad_head(dv, d)


def mosa_block_attention_bwd_fused_cuda(q, k, v, bidx, gt, lse, delta,
                                        bs: int, T: int, scale=None,
                                        seg=None):
    """#7 + #8 in one launch, one block per row: (dq, dk, dv).  Inputs as
    ``mosa_block_attention_bwd_dq_cuda``, with ``fused_bwd_fits(S, d)``.
    Raises on anything else."""
    BH, S, d = _check_bwd("mosa_block_attention_bwd_fused_cuda", q, k, v,
                          bidx, seg, gt, lse, delta, bs, T)
    if not fused_bwd_fits(S, d):
        raise ValueError(f"the fused backward takes S <= {FUSED_MAX_S} and "
                         f"d <= {NARROW_HEAD_DIM}, got S={S}, d={d}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    launch("repro_mosa_block_attention_bwd", LAUNCHES_BWD, q, k, v, bidx,
            seg, gt, lse, delta, dq, dk, dv, BH, S, d, bs, T,
            float(scale if scale is not None else d ** -0.5),
            DTYPE_CODE[q.dtype])
    return dq, dk, dv


def mosa_block_attention_bwd_cuda(q, k, v, bidx, gt, lse, delta, bs: int,
                                  T: int, scale=None, seg=None):
    """(dq, dk, dv): the fused kernel where ``fused_bwd_fits``, else the
    split kernels #7 and #8."""
    if fused_bwd_fits(q.shape[-2], q.shape[-1]):
        return mosa_block_attention_bwd_fused_cuda(q, k, v, bidx, gt, lse,
                                                   delta, bs, T, scale, seg)
    dq = mosa_block_attention_bwd_dq_cuda(q, k, v, bidx, gt, lse, delta, bs,
                                          T, scale, seg)
    dk, dv = mosa_block_attention_bwd_dkv_cuda(q, k, v, bidx, gt, lse, delta,
                                               bs, T, scale, seg)
    return dq, dk, dv


# -------------------------------------------------------------- dispatch
def mosa_block_attention_fwd_res(q, k, v, bidx, bs, T, scale=None, seg=None):
    """Kernel #6 for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return mosa_block_attention_fwd_res_cuda(q, k, v, bidx, bs, T, scale,
                                                 seg)
    return mosa_block_attention_fwd_res_ref(q, k, v, bidx, bs, T, scale, seg)


def mosa_block_attention_bwd(q, k, v, bidx, gt, lse, delta, bs, T,
                             scale=None, seg=None):
    """The backward kernels for CUDA tensors (the fused #7 + #8 where a
    row fits one tile, the split pair otherwise), the plain version for CPU
    tensors: (dq, dk, dv)."""
    if q.is_cuda:
        return mosa_block_attention_bwd_cuda(q, k, v, bidx, gt, lse, delta,
                                             bs, T, scale, seg)
    return mosa_block_attention_bwd_ref(q, k, v, bidx, gt, lse, delta, bs, T,
                                        scale, seg)


class MoSABlockAttentionFunction(torch.autograd.Function):
    """``apply(q, k, v, bidx, seg, rblk, bs, T, scale)`` -> (B, H, S, d) in
    q.dtype; ``seg`` and ``scale`` may be None.  Gradients for q, k, v and
    the per-block scores rblk.

    Forward: ``o_pre, lse`` from kernel #6 (the plain version on the CPU),
    ``out = o_pre`` with each row scaled by its block's score.
    Backward, the wrapper math kept out of the kernels:

      g~     = g scaled by each row's block score, zero on invalid query
               rows (no gradient may reach the layer's clamped gather
               from them)
      delta  = rowsum(g~ * o_pre)
      dr_blk = rowsum(g * o_pre) summed over each block

    then ``mosa_block_attention_bwd`` gives dq, dk and dv (#7 + #8 fused
    at S <= 64, split above).  Every tensor is detached before it reaches
    a kernel (the kernels refuse autograd inputs)."""

    @staticmethod
    def forward(ctx, q, k, v, bidx, seg, rblk, bs, T, scale):
        q, k, v = (t.detach().contiguous() for t in (q, k, v))
        rf = wide(rblk.detach()).contiguous()
        o_pre, lse = mosa_block_attention_fwd_res(q, k, v, bidx, bs, T,
                                                  scale, seg)
        ctx.bs, ctx.T, ctx.scale = bs, T, scale
        ctx.r_dtype = rblk.dtype
        ctx.save_for_backward(q, k, v, bidx, seg, rf, o_pre, lse)
        return scale_rows(o_pre, rf, bs).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bidx, seg, rf, o_pre, lse = (
            None if t is None else t.detach() for t in ctx.saved_tensors)
        bs, T = ctx.bs, ctx.T
        _, ok = expand_blocks(bidx, bs, T)
        g32 = wide(g)
        gt = torch.where(ok[..., None], scale_rows(g32, rf, bs),
                         0.0).contiguous()
        dr_tok = (g32 * o_pre).sum(-1)
        delta = (gt * o_pre).sum(-1).contiguous()
        dq, dk, dv = mosa_block_attention_bwd(q, k, v, bidx, gt, lse, delta,
                                              bs, T, ctx.scale, seg)
        dr = dr_tok.unflatten(-1, (-1, bs)).sum(-1)
        return (dq, dk, dv, None, None, dr.to(ctx.r_dtype), None, None,
                None)


def mosa_block_attention(q, k, v, bidx, rblk, bs: int, T: int, scale=None,
                         seg=None):
    """Block-choice MoSA inner attention.  Differentiable calls (grad
    enabled and any of q, k, v, rblk requiring grad) go through
    ``MoSABlockAttentionFunction`` (kernels #6-#8 on the card); others run
    kernel #5 for CUDA tensors and the plain version for CPU tensors."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, rblk)):
        return MoSABlockAttentionFunction.apply(q, k, v, bidx, seg, rblk, bs,
                                                T, scale)
    if q.is_cuda:
        return mosa_block_attention_cuda(q, k, v, bidx, rblk, bs, T, scale,
                                         seg)
    return mosa_block_attention_ref(q, k, v, bidx, rblk, bs, T, scale, seg)
