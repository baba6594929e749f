"""MoSA inner attention over the expert-choice-selected tokens.

Replaces the TPU kernel ``_mosa_kernel`` of
``repro/kernels/mosa_attention.py`` (reached through
``repro.kernels.ops.mosa_attention``).

  * ``mosa_attention_ref``  — plain PyTorch, a port of
    ``repro.kernels.ref.mosa_attention_ref``;
  * ``mosa_attention_cuda`` — the hand-written CUDA kernel
    (``csrc/mosa_attention.cu``);
  * ``mosa_attention``      — dispatch: a CUDA tensor goes to the kernel, a
    CPU tensor to the plain version.  There is no other route.

Unlike the TPU wrapper nothing is padded: the kernel takes any S and any
d <= 128, masks a ragged key tile, and computes no padded query.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODE, LaunchCounter,
                                      check_launch, check_tensor, library)

NEG_INF = -1e30
MAX_D = 128
LAUNCHES = LaunchCounter("mosa_attention")


def mosa_attention_ref(q, k, v, idx, r, scale=None, seg=None):
    """q, k, v: (B, H, S, d); idx: (B, H, S) original positions (-1 = pad);
    r: (B, H, S) fp32 router scores of the query tokens; seg: optional
    (B, H, S) segment ids.  Returns softmax(q k^T masked) v * r_q in
    q.dtype; mask = idx_q >= idx_k & idx_k >= 0 (& seg_q == seg_k)."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = (idx[..., :, None] >= idx[..., None, :]) & (idx >= 0)[..., None, :]
    if seg is not None:
        mask &= seg[..., :, None] == seg[..., None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    att = torch.einsum("bhqk,bhkd->bhqd", p / denom, v.float())
    return (att * r[..., None]).to(q.dtype)


def mosa_attention_cuda(q, k, v, idx, r, scale=None, seg=None):
    """The CUDA kernel.  q, k, v: (B, H, S, d) contiguous fp32 or bf16 with
    d <= 128; idx, seg: (B, H, S) int32; r: (B, H, S) fp32.  Raises on
    anything else."""
    if not q.is_cuda:
        raise ValueError("mosa_attention_cuda needs CUDA tensors")
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
    check_tensor("r", r, (B, H, S), torch.float32, dev)
    if seg is not None:
        check_tensor("seg", seg, (B, H, S), torch.int32, dev)
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_mosa_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
            None if seg is None else seg.data_ptr(), r.data_ptr(),
            out.data_ptr(), B * H, S, d, scale, DTYPE_CODE[q.dtype], stream)
    check_launch(rc, "mosa_attention")
    LAUNCHES.count += 1
    return out


def mosa_attention(q, k, v, idx, r, scale=None, seg=None):
    """MoSA inner attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.is_cuda:
        return mosa_attention_cuda(q, k, v, idx, r, scale=scale, seg=seg)
    return mosa_attention_ref(q, k, v, idx, r, scale=scale, seg=seg)
