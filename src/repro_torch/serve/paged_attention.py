"""Paged-attention decode: one query token per row over a paged dense cache.

Replaces the TPU kernel ``_paged_kernel`` of
``repro/serve/paged_attention.py``.

  * ``paged_attention_ref``    — plain PyTorch, a port of the JAX gather
    reference: gather the row's blocks back to the contiguous layout and
    run the contiguous decode math (NEG_INF where-mask, fp32 softmax);
  * ``paged_attention_cuda``   — the hand-written CUDA kernel
    (``csrc/paged_attention.cu``): block-table indirect loads and an online
    softmax, no gather buffer;
  * ``paged_attention_decode`` — the dispatcher: a CUDA tensor goes to the
    kernel, a CPU tensor to the plain version.  There is no other route.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODE, LaunchCounter,
                                      check_launch, check_tensor, library)
from repro_torch.serve.paged_kv import PagedDenseKVCache

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8            # query heads per KV head the kernel takes
LAUNCHES = LaunchCounter("paged_attention_decode")


def paged_attention_ref(q, k_pool, v_pool, block_table, lengths, scale):
    """q: (B, Hq, d); pools (N, bs, Hkv, d); block_table (B, nb);
    lengths (B,).  Returns (B, Hq, d) in q.dtype: every position
    ``< length`` of the row attends."""
    B, Hq, d = q.shape
    nb, bs = block_table.shape[1], k_pool.shape[1]
    Hkv = k_pool.shape[2]
    R = Hq // Hkv
    S = nb * bs
    bt = block_table.long().clamp(min=0)
    kk = k_pool[bt].reshape(B, S, Hkv, d)
    vv = v_pool[bt].reshape(B, S, Hkv, d)
    qg = q.reshape(B, Hkv, R, 1, d).float()
    s = torch.einsum("bgrqd,bsgd->bgrqs", qg, kk.float()) * scale
    k_pos = torch.arange(S, device=q.device)
    ok = (k_pos[None, :] < lengths[:, None])[:, None, None, None, :]
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bgrqs,bsgd->bgrqd", p, vv.float())
    out = out / p.sum(-1).clamp_min(1e-30)[..., None]
    return out.reshape(B, Hq, d).to(q.dtype)


def paged_attention_cuda(q, k_pool, v_pool, block_table, lengths, scale):
    """The CUDA kernel.  q: (B, Hq, d); pools (N, bs, Hkv, d), contiguous
    fp32 or bf16 with d in (32, 64, 128) and Hq / Hkv <= 8; block_table
    (B, nb) int32; lengths (B,) int32.  Raises on anything else."""
    if not q.is_cuda:
        raise ValueError("paged_attention_cuda needs CUDA tensors")
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be (B, Hq, d) and pools (N, bs, Hkv, d), got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    B, Hq, d = q.shape
    N, bs, Hkv = k_pool.shape[:3]
    nb = block_table.shape[-1]
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"need Hq % Hkv == 0 and Hq / Hkv <= {MAX_GROUP}, "
                         f"got Hq={Hq}, Hkv={Hkv}")
    dev = q.device
    check_tensor("q", q, (B, Hq, d), q.dtype, dev)
    check_tensor("k_pool", k_pool, (N, bs, Hkv, d), q.dtype, dev)
    check_tensor("v_pool", v_pool, (N, bs, Hkv, d), q.dtype, dev)
    check_tensor("block_table", block_table, (B, nb), torch.int32, dev)
    check_tensor("lengths", lengths, (B,), torch.int32, dev)
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_paged_attention_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, d, bs, nb, float(scale), DTYPE_CODE[q.dtype], stream)
    check_launch(rc, "paged_attention_decode")
    LAUNCHES.count += 1
    return out


def paged_attention_decode(q, cache: PagedDenseKVCache, *, scale: float):
    """Decode attention of one token per row over a paged dense cache.
    q: (B, Hq, d).  The CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    args = (q, cache.k, cache.v, cache.block_table, cache.length, scale)
    if q.is_cuda:
        return paged_attention_cuda(*args)
    return paged_attention_ref(*args)
