"""MoSA inner attention over the expert-choice-selected tokens.

Replaces two TPU kernels of ``repro/kernels/mosa_attention.py``:
``_mosa_kernel`` (serving and no-grad calls) and ``_mosa_fwd_res_kernel``
(the training forward, which keeps the backward's residuals).

  * ``mosa_attention_ref`` / ``mosa_attention_cuda`` — plain PyTorch (a
    port of ``repro.kernels.ref.mosa_attention_ref``) and the hand-written
    CUDA kernel (``csrc/mosa_attention.cu``);
  * ``mosa_attention_fwd_res_ref`` / ``mosa_attention_fwd_res_cuda`` — the
    training forward: ``o_pre`` (not scaled by r) and ``lse`` per query;
  * ``mosa_attention`` — dispatch.  A call that autograd must
    differentiate (grad enabled and any of q, k, v, r requiring grad) goes
    through the ``torch.autograd.Function`` of ``kernels.mosa_vjp``;
    otherwise a CUDA tensor goes to the kernel and a CPU tensor to the
    plain version.  There is no other route.

Unlike the TPU wrapper nothing is padded: the kernels take any S and any
d <= 128, mask a ragged key tile, and compute no padded query.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODE, LaunchCounter,
                                      check_launch, check_tensor, library)

NEG_INF = -1e30
MAX_D = 128
LAUNCHES = LaunchCounter("mosa_attention")
LAUNCHES_FWD_RES = LaunchCounter("mosa_attention_fwd_res")


def wide(t):
    """``t`` in fp32, or fp64 when it is fp64 (the plain versions compute in
    fp32; fp64 keeps ``torch.autograd.gradcheck`` meaningful)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _masked_softmax_parts(q, k, idx, scale, seg):
    """Masked scores of the plain versions: (mask, s, m, p, denom), in
    ``wide`` precision."""
    s = torch.einsum("bhqd,bhkd->bhqk", wide(q), wide(k)) * scale
    mask = (idx[..., :, None] >= idx[..., None, :]) & (idx >= 0)[..., None, :]
    if seg is not None:
        mask &= seg[..., :, None] == seg[..., None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    return mask, s, m, p, denom


def mosa_attention_ref(q, k, v, idx, r, scale=None, seg=None):
    """q, k, v: (B, H, S, d); idx: (B, H, S) original positions (-1 = pad);
    r: (B, H, S) fp32 router scores of the query tokens; seg: optional
    (B, H, S) segment ids.  Returns softmax(q k^T masked) v * r_q in
    q.dtype; mask = idx_q >= idx_k & idx_k >= 0 (& seg_q == seg_k)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, _, _, p, denom = _masked_softmax_parts(q, k, idx, scale, seg)
    att = torch.einsum("bhqk,bhkd->bhqd", p / denom, wide(v))
    return (att * r[..., None]).to(q.dtype)


def mosa_attention_fwd_res_ref(q, k, v, idx, scale=None, seg=None):
    """The training forward in plain PyTorch.  Same inputs as
    ``mosa_attention_ref`` without r.  Returns ``o_pre`` (B, H, S, d) fp32
    = softmax(q k^T masked) v, NOT scaled by r, and ``lse`` (B, H, S) fp32
    = m + log(max(l, 1e-30)) (about -1e30 for a row with no valid key)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, _, m, p, denom = _masked_softmax_parts(q, k, idx, scale, seg)
    o_pre = torch.einsum("bhqk,bhkd->bhqd", p / denom, wide(v))
    return o_pre, m[..., 0] + torch.log(denom[..., 0])


def check_mosa_inputs(name, q, k, v, idx, seg):
    """Validate the shared inputs of the MoSA kernels; returns (B, H, S, d)."""
    if not q.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, d), got {tuple(q.shape)}")
    B, H, S, d = q.shape
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if not (1 <= d <= MAX_D) or S < 1:
        raise ValueError(f"need 1 <= d <= {MAX_D} and S >= 1, got d={d}, S={S}")
    dev = q.device
    check_tensor("q", q, (B, H, S, d), q.dtype, dev)
    check_tensor("k", k, (B, H, S, d), q.dtype, dev)
    check_tensor("v", v, (B, H, S, d), q.dtype, dev)
    check_tensor("idx", idx, (B, H, S), torch.int32, dev)
    if seg is not None:
        check_tensor("seg", seg, (B, H, S), torch.int32, dev)
    return B, H, S, d


def data_ptr(t):
    """``t.data_ptr()``, or None (a null pointer) for a missing tensor."""
    return None if t is None else t.data_ptr()


def mosa_attention_cuda(q, k, v, idx, r, scale=None, seg=None):
    """The CUDA kernel.  q, k, v: (B, H, S, d) contiguous fp32 or bf16 with
    d <= 128; idx, seg: (B, H, S) int32; r: (B, H, S) fp32.  Raises on
    anything else."""
    B, H, S, d = check_mosa_inputs("mosa_attention_cuda", q, k, v, idx, seg)
    check_tensor("r", r, (B, H, S), torch.float32, q.device)
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    lib = library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_mosa_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
            data_ptr(seg), r.data_ptr(), out.data_ptr(), B * H, S, d, scale,
            DTYPE_CODE[q.dtype], stream)
    check_launch(rc, "mosa_attention")
    LAUNCHES.count += 1
    return out


def mosa_attention_fwd_res_cuda(q, k, v, idx, scale=None, seg=None):
    """The training-forward CUDA kernel (``kResiduals`` form of
    ``csrc/mosa_attention.cu``).  Inputs as ``mosa_attention_cuda`` without
    r; returns (o_pre fp32 (B, H, S, d), lse fp32 (B, H, S))."""
    B, H, S, d = check_mosa_inputs("mosa_attention_fwd_res_cuda", q, k, v,
                                   idx, seg)
    scale = float(scale if scale is not None else d ** -0.5)
    o_pre = torch.empty((B, H, S, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_mosa_attention_fwd_res(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
            data_ptr(seg), o_pre.data_ptr(), lse.data_ptr(), B * H, S, d, scale,
            DTYPE_CODE[q.dtype], stream)
    check_launch(rc, "mosa_attention_fwd_res")
    LAUNCHES_FWD_RES.count += 1
    return o_pre, lse


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
