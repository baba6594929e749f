"""Backward of the MoSA inner attention, recompute style.

Replaces the TPU kernels ``_mosa_bwd_dq_kernel`` and
``_mosa_bwd_dkv_kernel`` of ``repro/kernels/mosa_backward.py``.  With
S_ij = scale * q_i.k_j under the mask seg_i == seg_j & idx_i >= idx_j &
idx_j >= 0, P_ij = exp(S_ij - lse_i) recomputed from the forward's
log-sum-exp, g~ = r * g and delta_i = g~_i . o_pre_i (both fp32, from the
caller, ``kernels.mosa_vjp``):

  dS_ij = P_ij * (g~_i . v_j - delta_i)
  dQ_i  = scale * sum_j dS_ij k_j
  dK_j  = scale * sum_i dS_ij q_i
  dV_j  = sum_i P_ij g~_i

P is recomputed under the explicit mask: an empty row has lse ~ -1e30, and
exp(-1e30 - lse) is not ~0.

  * ``mosa_attention_bwd_ref``  — the math above in plain PyTorch (not
    autograd), so the card can check dq, dk and dv one by one;
  * ``mosa_attention_bwd_dq_cuda`` / ``mosa_attention_bwd_dkv_cuda`` — the
    two hand-written CUDA kernels (``csrc/mosa_backward.cu``), each with its
    launch counter; ``mosa_attention_bwd_cuda`` runs both;
  * ``mosa_attention_bwd`` — the kernels for CUDA tensors, the plain
    version for CPU tensors.

Every function returns (dq, dk, dv) in the dtypes of (q, k, v).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODE, LaunchCounter,
                                      check_launch, check_tensor, library)
from repro_torch.kernels.mosa_attention import (check_mosa_inputs, data_ptr,
                                                wide)

LAUNCHES_DQ = LaunchCounter("mosa_attention_bwd_dq")
LAUNCHES_DKV = LaunchCounter("mosa_attention_bwd_dkv")


def mosa_attention_bwd_ref(q, k, v, idx, gt, lse, delta, scale=None,
                           seg=None):
    """q, k, v: (B, H, S, d); idx, seg: (B, H, S) (seg optional); gt: (B, H,
    S, d) fp32 = r * g; lse, delta: (B, H, S) fp32."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qf, kf, vf = wide(q), wide(k), wide(v)
    mask = (idx[..., :, None] >= idx[..., None, :]) & (idx >= 0)[..., None, :]
    if seg is not None:
        mask &= seg[..., :, None] == seg[..., None, :]
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", gt, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gt)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(name, q, k, v, idx, seg, gt, lse, delta):
    B, H, S, d = check_mosa_inputs(name, q, k, v, idx, seg)
    dev = q.device
    check_tensor("gt", gt, (B, H, S, d), torch.float32, dev)
    check_tensor("lse", lse, (B, H, S), torch.float32, dev)
    check_tensor("delta", delta, (B, H, S), torch.float32, dev)
    return B, H, S, d


def mosa_attention_bwd_dq_cuda(q, k, v, idx, gt, lse, delta, scale=None,
                               seg=None):
    """Kernel #3: dq.  q, k, v: (B, H, S, d) contiguous fp32 or bf16 with
    d <= 128; idx, seg: (B, H, S) int32; gt fp32 (B, H, S, d); lse, delta
    fp32 (B, H, S).  Raises on anything else."""
    B, H, S, d = _check_bwd("mosa_attention_bwd_dq_cuda", q, k, v, idx, seg,
                            gt, lse, delta)
    scale = float(scale if scale is not None else d ** -0.5)
    dq = torch.empty_like(q)
    lib = library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_mosa_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
            data_ptr(seg), gt.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), B * H, S, d, scale, DTYPE_CODE[q.dtype], stream)
    check_launch(rc, "mosa_attention_bwd_dq")
    LAUNCHES_DQ.count += 1
    return dq


def mosa_attention_bwd_dkv_cuda(q, k, v, idx, gt, lse, delta, scale=None,
                                seg=None):
    """Kernel #4: (dk, dv).  Inputs as ``mosa_attention_bwd_dq_cuda``."""
    B, H, S, d = _check_bwd("mosa_attention_bwd_dkv_cuda", q, k, v, idx, seg,
                            gt, lse, delta)
    scale = float(scale if scale is not None else d ** -0.5)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_mosa_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
            data_ptr(seg), gt.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B * H, S, d, scale,
            DTYPE_CODE[q.dtype], stream)
    check_launch(rc, "mosa_attention_bwd_dkv")
    LAUNCHES_DKV.count += 1
    return dk, dv


def mosa_attention_bwd_cuda(q, k, v, idx, gt, lse, delta, scale=None,
                            seg=None):
    """Kernels #3 and #4: (dq, dk, dv)."""
    dq = mosa_attention_bwd_dq_cuda(q, k, v, idx, gt, lse, delta, scale, seg)
    dk, dv = mosa_attention_bwd_dkv_cuda(q, k, v, idx, gt, lse, delta, scale,
                                         seg)
    return dq, dk, dv


def mosa_attention_bwd(q, k, v, idx, gt, lse, delta, scale=None, seg=None):
    """The backward kernels for CUDA tensors, the plain version for CPU
    tensors."""
    if q.is_cuda:
        return mosa_attention_bwd_cuda(q, k, v, idx, gt, lse, delta, scale,
                                       seg)
    return mosa_attention_bwd_ref(q, k, v, idx, gt, lse, delta, scale, seg)
