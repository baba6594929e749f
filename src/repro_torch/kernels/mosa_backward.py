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
  * ``mosa_attention_bwd_fused_cuda`` — the fused hand-written CUDA kernel
    (``csrc/mosa_backward.cu``, ``mosa_bwd_fused_kernel``): dq, dk and dv in
    one launch when a row's S selected tokens fit one tile
    (``fused_bwd_fits``: S <= 64, d <= 128);
  * ``mosa_attention_bwd_dq_cuda`` / ``mosa_attention_bwd_dkv_cuda`` — the
    two split CUDA kernels (any S; the route above S = 64), each with its
    launch counter.  One block per (row, owned tile of 64 queries or
    keys) streams the opposite rows in tiles of 32 through two cp.async
    stages, skips the tile pairs in which no pair can pass the mask (by
    the tiles' ranges of positions and segments, never assuming sorted
    idx) and keeps its outputs in register tiles across the streamed
    tiles.  At the IsoFLOP sweep's mosa8 point (k = 128, d 64, fp32) dq
    is bound by bytes and dk/dv by operations on paper, and on an H100
    both by shared-memory loads feeding the fp32 products
    (``csrc/mosa_backward.cu``, PERF.md);
  * ``mosa_attention_bwd_cuda`` — the fused kernel where it fits, the two
    split kernels otherwise;
  * ``mosa_attention_bwd`` — the kernels for CUDA tensors, the plain
    version for CPU tensors.

Every function returns (dq, dk, dv) in the dtypes of (q, k, v).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODE, MAX_HEAD_DIM,
                                      LaunchCounter, check_tensor, launch)
from repro_torch.kernels.mosa_attention import (ROW_MAX_S,
                                                check_mosa_inputs, pair_mask,
                                                row_fits, wide)

LAUNCHES = LaunchCounter("mosa_attention_bwd")
LAUNCHES_DQ = LaunchCounter("mosa_attention_bwd_dq")
LAUNCHES_DKV = LaunchCounter("mosa_attention_bwd_dkv")
# The fused kernel holds a whole row in one block, as the one-row forward
# does (csrc/mosa_row.cuh): the same bounds.
FUSED_MAX_S = ROW_MAX_S
fused_bwd_fits = row_fits


def mosa_attention_bwd_ref(q, k, v, idx, gt, lse, delta, scale=None,
                           seg=None):
    """q, k, v: (B, H, S, d); idx, seg: (B, H, S) (seg optional); gt: (B, H,
    S, d) fp32 = r * g; lse, delta: (B, H, S) fp32."""
    return bwd_from_mask(q, k, v, pair_mask(idx, idx, idx >= 0, seg), gt,
                         lse, delta, scale)


def bwd_from_mask(q, k, v, mask, gt, lse, delta, scale=None):
    """The backward math under an explicit (B, H, S, S) pair mask."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qf, kf, vf = wide(q), wide(k), wide(v)
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
    launch("repro_mosa_attention_bwd_dq", LAUNCHES_DQ, q, k, v, idx, seg, gt,
           lse, delta, dq, B * H, S, d, scale, DTYPE_CODE[q.dtype])
    return dq


def mosa_attention_bwd_dkv_cuda(q, k, v, idx, gt, lse, delta, scale=None,
                                seg=None):
    """Kernel #4: (dk, dv).  Inputs as ``mosa_attention_bwd_dq_cuda``."""
    B, H, S, d = _check_bwd("mosa_attention_bwd_dkv_cuda", q, k, v, idx, seg,
                            gt, lse, delta)
    scale = float(scale if scale is not None else d ** -0.5)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch("repro_mosa_attention_bwd_dkv", LAUNCHES_DKV, q, k, v, idx, seg,
           gt, lse, delta, dk, dv, B * H, S, d, scale, DTYPE_CODE[q.dtype])
    return dk, dv


def mosa_attention_bwd_fused_cuda(q, k, v, idx, gt, lse, delta, scale=None,
                                  seg=None):
    """The fused kernel (#3 + #4 in one launch, one block per row): (dq, dk,
    dv).  Inputs as ``mosa_attention_bwd_dq_cuda``, with
    ``fused_bwd_fits(S, d)``.  Raises on anything else."""
    B, H, S, d = _check_bwd("mosa_attention_bwd_fused_cuda", q, k, v, idx,
                            seg, gt, lse, delta)
    if not fused_bwd_fits(S, d):
        raise ValueError(f"the fused backward takes S <= {FUSED_MAX_S} and "
                         f"d <= {MAX_HEAD_DIM}, got S={S}, d={d}")
    scale = float(scale if scale is not None else d ** -0.5)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    launch("repro_mosa_attention_bwd", LAUNCHES, q, k, v, idx, seg, gt, lse,
           delta, dq, dk, dv, B * H, S, d, scale, DTYPE_CODE[q.dtype])
    return dq, dk, dv


def mosa_attention_bwd_cuda(q, k, v, idx, gt, lse, delta, scale=None,
                            seg=None):
    """(dq, dk, dv): the fused kernel where ``fused_bwd_fits``, else the
    split kernels #3 and #4."""
    if fused_bwd_fits(q.shape[-2], q.shape[-1]):
        return mosa_attention_bwd_fused_cuda(q, k, v, idx, gt, lse, delta,
                                             scale, seg)
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
