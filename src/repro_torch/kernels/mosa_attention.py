"""MoSA inner attention over the expert-choice-selected tokens.

Replaces two TPU kernels of ``repro/kernels/mosa_attention.py``:
``_mosa_kernel`` (serving and no-grad calls) and ``_mosa_fwd_res_kernel``
(the training forward, which keeps the backward's residuals).

  * ``mosa_attention_ref`` / ``mosa_attention_cuda`` — plain PyTorch (a
    port of ``repro.kernels.ref.mosa_attention_ref``) and the hand-written
    CUDA kernels (``csrc/mosa_attention.cu``);
  * ``mosa_attention_fwd_res_ref`` / ``mosa_attention_fwd_res_cuda`` — the
    training forward: ``o_pre`` (not scaled by r) and ``lse`` per query;
  * each ``*_cuda`` picks one of three routes (``fwd_route``) and launches
    it once: the one-row kernel (``*_row_cuda``: one thread block holds a
    whole row, when ``row_fits(S, d)``: S <= 64, d <= 128), the streaming
    kernel (``*_stream_cuda``: any S at d <= 128; one block per row and
    owned tile of 64 queries, the keys streamed in tiles of 32 through two
    cp.async stages, key tiles no query of the block can see skipped by
    value, register-tiled products and an online softmax; two launches
    bitwise equal, and at S <= 32 the bits of the one-row kernel) or, at
    128 < d <= 256, the wide kernel (``*_wide_cuda``,
    ``csrc/wide_attention.cu``: q, k and v zero-padded to d 256, one warp
    per query, keys streamed in tiles of 32); all count on the same launch
    counter;
  * ``mosa_attention`` — dispatch.  A call that autograd must
    differentiate (grad enabled and any of q, k, v, r requiring grad) goes
    through the ``torch.autograd.Function`` of ``kernels.mosa_vjp``;
    otherwise a CUDA tensor goes to the kernel and a CPU tensor to the
    plain version.  There is no other route.

Unlike the TPU wrapper nothing is padded at d <= 128: the kernels take
any S and any d <= 128, mask a ragged key tile, and compute no padded
query.  A wider head (up to 256) is padded to 256, as the TPU wrapper pads
to its 128 lanes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODE, NARROW_HEAD_DIM,
                                      LaunchCounter, check_head_dim,
                                      check_tensor, is_wide, launch,
                                      route_entry, unpad_head)

NEG_INF = -1e30
ROW_MAX_S = 64
LAUNCHES = LaunchCounter("mosa_attention")
LAUNCHES_FWD_RES = LaunchCounter("mosa_attention_fwd_res")


def row_fits(S, d):
    """Whether a row of S selected tokens of width d fits one thread block:
    the route of the one-row forward (#1, #2 and their block forms #5,
    #6) and of the fused backward (``kernels.mosa_backward``)."""
    return 1 <= S <= ROW_MAX_S and 1 <= d <= NARROW_HEAD_DIM


def fwd_route(S, d):
    """The forward kernels' route at S selected tokens of width d:
    "row" where ``row_fits``, "wide" at d > 128, else "stream"."""
    if row_fits(S, d):
        return "row"
    return "wide" if is_wide(d) else "stream"


def wide(t):
    """``t`` in fp32, or fp64 when it is fp64 (the plain versions compute in
    fp32; fp64 keeps ``torch.autograd.gradcheck`` meaningful)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def pair_mask(pos_q, pos_k, ok_k, seg):
    """(B, H, S, S) mask of the MoSA kernels: pos_q >= pos_k & ok_k (&
    seg_q == seg_k)."""
    mask = (pos_q[..., :, None] >= pos_k[..., None, :]) & ok_k[..., None, :]
    if seg is not None:
        mask &= seg[..., :, None] == seg[..., None, :]
    return mask


def softmax_parts(q, k, mask, scale):
    """Masked softmax parts of the plain versions: the row max ``m``, the
    unnormalized probabilities ``p`` and the floored denominator, in
    ``wide`` precision."""
    s = torch.einsum("bhqd,bhkd->bhqk", wide(q), wide(k)) * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    return m, p, denom


def mosa_attention_ref(q, k, v, idx, r, scale=None, seg=None):
    """q, k, v: (B, H, S, d); idx: (B, H, S) original positions (-1 = pad);
    r: (B, H, S) fp32 router scores of the query tokens; seg: optional
    (B, H, S) segment ids.  Returns softmax(q k^T masked) v * r_q in
    q.dtype; mask = idx_q >= idx_k & idx_k >= 0 (& seg_q == seg_k)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, p, denom = softmax_parts(q, k, pair_mask(idx, idx, idx >= 0, seg),
                                scale)
    att = torch.einsum("bhqk,bhkd->bhqd", p / denom, wide(v))
    return (att * r[..., None]).to(q.dtype)


def mosa_attention_fwd_res_ref(q, k, v, idx, scale=None, seg=None):
    """The training forward in plain PyTorch.  Same inputs as
    ``mosa_attention_ref`` without r.  Returns ``o_pre`` (B, H, S, d) fp32
    = softmax(q k^T masked) v, NOT scaled by r, and ``lse`` (B, H, S) fp32
    = m + log(max(l, 1e-30)) (about -1e30 for a row with no valid key)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    m, p, denom = softmax_parts(q, k, pair_mask(idx, idx, idx >= 0, seg),
                                scale)
    o_pre = torch.einsum("bhqk,bhkd->bhqd", p / denom, wide(v))
    return o_pre, m[..., 0] + torch.log(denom[..., 0])


def check_mosa_inputs(name, q, k, v, idx, seg):
    """Validate the shared inputs of the MoSA kernels; returns (B, H, S, d)."""
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
    dev = q.device
    check_tensor("q", q, (B, H, S, d), q.dtype, dev)
    check_tensor("k", k, (B, H, S, d), q.dtype, dev)
    check_tensor("v", v, (B, H, S, d), q.dtype, dev)
    check_tensor("idx", idx, (B, H, S), torch.int32, dev)
    if seg is not None:
        check_tensor("seg", seg, (B, H, S), torch.int32, dev)
    return B, H, S, d


def check_route(route, S, d):
    """Raise unless the forward route ``route`` takes (S, d)."""
    if route == "row" and not row_fits(S, d):
        raise ValueError(f"the one-row kernel takes S <= {ROW_MAX_S} and "
                         f"d <= {NARROW_HEAD_DIM}, got S={S}, d={d}")
    if route == "stream" and is_wide(d):
        raise ValueError(f"the streaming kernel takes d <= "
                         f"{NARROW_HEAD_DIM}, got d={d}")
    if route == "wide" and not is_wide(d):
        raise ValueError(f"the wide kernel takes d > {NARROW_HEAD_DIM}, got "
                         f"d={d}")


def _forward_cuda(route, q, k, v, idx, r, scale, seg):
    """One launch of #1 (``r`` given) or #2 (``r`` None) on ``route``,
    "row", "stream" or "wide" (q, k, v zero-padded to d 256, the output
    sliced back)."""
    name = "mosa_attention" if r is not None else "mosa_attention_fwd_res"
    B, H, S, d = check_mosa_inputs(f"{name}_{route}_cuda", q, k, v, idx, seg)
    check_route(route, S, d)
    entry, (q, k, v) = route_entry(
        f"repro_{name}" + ("_row" if route == "row" else ""), d, q, k, v)
    scale = float(scale if scale is not None else d ** -0.5)
    w = q.shape[-1]
    if r is not None:
        check_tensor("r", r, (B, H, S), torch.float32, q.device)
        out = torch.empty_like(q)
        launch(entry, LAUNCHES, q, k, v, idx, seg, r, out, B * H, S, w, scale,
               DTYPE_CODE[q.dtype])
        return unpad_head(out, d)
    o_pre = torch.empty((B, H, S, w), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    launch(entry, LAUNCHES_FWD_RES, q, k, v, idx, seg, o_pre, lse, B * H, S,
           w, scale, DTYPE_CODE[q.dtype])
    return unpad_head(o_pre, d), lse


def mosa_attention_row_cuda(q, k, v, idx, r, scale=None, seg=None):
    """Kernel #1 on the one-row route.  q, k, v: (B, H, S, d) contiguous
    fp32 or bf16 with ``row_fits(S, d)``; idx, seg: (B, H, S) int32; r:
    (B, H, S) fp32.  Raises on anything else."""
    return _forward_cuda("row", q, k, v, idx, r, scale, seg)


def mosa_attention_stream_cuda(q, k, v, idx, r, scale=None, seg=None):
    """Kernel #1 on the streaming route (any S, d <= 128)."""
    return _forward_cuda("stream", q, k, v, idx, r, scale, seg)


def mosa_attention_wide_cuda(q, k, v, idx, r, scale=None, seg=None):
    """Kernel #1 on the wide route (any S, 128 < d <= 256)."""
    return _forward_cuda("wide", q, k, v, idx, r, scale, seg)


def route_of(q):
    """``fwd_route`` of q (B, H, S, d); any other shape goes to the
    streaming wrapper, whose checks refuse it."""
    return fwd_route(q.shape[-2], q.shape[-1]) if q.dim() == 4 else "stream"


def mosa_attention_cuda(q, k, v, idx, r, scale=None, seg=None):
    """Kernel #1 on the route ``fwd_route(S, d)`` names.  Inputs as
    ``mosa_attention_row_cuda``."""
    fn = {"row": mosa_attention_row_cuda,
          "stream": mosa_attention_stream_cuda,
          "wide": mosa_attention_wide_cuda}[route_of(q)]
    return fn(q, k, v, idx, r, scale, seg)


def mosa_attention_fwd_res_row_cuda(q, k, v, idx, scale=None, seg=None):
    """Kernel #2 (the training forward, ``kResiduals``) on the one-row
    route.  Inputs as ``mosa_attention_row_cuda`` without r; returns
    (o_pre fp32 (B, H, S, d), lse fp32 (B, H, S))."""
    return _forward_cuda("row", q, k, v, idx, None, scale, seg)


def mosa_attention_fwd_res_stream_cuda(q, k, v, idx, scale=None, seg=None):
    """Kernel #2 on the streaming route."""
    return _forward_cuda("stream", q, k, v, idx, None, scale, seg)


def mosa_attention_fwd_res_wide_cuda(q, k, v, idx, scale=None, seg=None):
    """Kernel #2 on the wide route."""
    return _forward_cuda("wide", q, k, v, idx, None, scale, seg)


def mosa_attention_fwd_res_cuda(q, k, v, idx, scale=None, seg=None):
    """Kernel #2 on the route ``mosa_attention_cuda`` takes."""
    fn = {"row": mosa_attention_fwd_res_row_cuda,
          "stream": mosa_attention_fwd_res_stream_cuda,
          "wide": mosa_attention_fwd_res_wide_cuda}[route_of(q)]
    return fn(q, k, v, idx, scale, seg)


def mosa_attention_fwd_res(q, k, v, idx, scale=None, seg=None):
    """The training forward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.is_cuda:
        return mosa_attention_fwd_res_cuda(q, k, v, idx, scale=scale, seg=seg)
    return mosa_attention_fwd_res_ref(q, k, v, idx, scale=scale, seg=seg)


def mosa_attention(q, k, v, idx, r, scale=None, seg=None):
    """MoSA inner attention.  Differentiable calls go through the autograd
    Function (kernels #2-#4 on the card); others run the CUDA kernel for
    CUDA tensors and the plain version for CPU tensors."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, r)):
        from repro_torch.kernels.mosa_vjp import MoSAAttentionFunction
        return MoSAAttentionFunction.apply(q, k, v, idx, seg, r, scale)
    if q.is_cuda:
        return mosa_attention_cuda(q, k, v, idx, r, scale=scale, seg=seg)
    return mosa_attention_ref(q, k, v, idx, r, scale=scale, seg=seg)
