"""Causal or sliding-window GQA flash attention: the dense (or local) heads'
full forward.

Replaces two TPU kernels of ``repro/kernels/flash_attention.py``:
``_flash_kernel`` (kernel #9: one batch of rows, queries the last Tq
positions of a Tk-long context) and ``_flash_varlen_kernel`` (kernel #10:
one packed ``cu_seqlens`` stream, attention never crossing a segment).

  * ``flash_attention_ref`` / ``flash_attention_varlen_ref`` — plain
    PyTorch, ports of ``repro.kernels.ref.flash_attention_ref`` and of
    ``flash_attention_varlen_ref`` (written over the whole stream with the
    segment-equality mask instead of a host loop over segments);
  * ``flash_attention_cuda`` / ``flash_attention_varlen_cuda`` — the
    hand-written CUDA kernel (``csrc/flash_attention.cu``, one template,
    ``kVarlen`` for #10);
  * ``flash_attention`` / ``flash_attention_varlen`` — the entry points,
    counterparts of ``repro.kernels.ops.flash_attention`` /
    ``flash_attention_varlen`` with the JAX layouts: a CUDA tensor goes to
    the kernel, a CPU tensor to the plain version.  There is no other
    route.  The kernel has no backward, as the TPU kernel has none: a call
    that autograd would have to differentiate raises, on either device.

Unlike the TPU wrappers nothing is padded at d <= 128 (no 128-lane d, no
power-of-two lengths); at 128 < d <= 256 q, k and v are zero-padded to 256
for the wide kernel (``csrc/wide_attention.cu``, one warp per query, keys
streamed in tiles of 32; the same launch counter).  The mask semantics are
kept: a masked key never attends, a
padding token of the varlen stream (past ``cu[N]``) returns zeros, masked
scores are ``NEG_INF = -1e30``, not ``-inf``.  (The TPU varlen kernel lets
padding tokens attend one another; its callers slice them off.)
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODE, LaunchCounter,
                                      check_head_dim, check_tensor, launch,
                                      route_entry, unpad_head)

NEG_INF = -1e30
LAUNCHES = LaunchCounter("flash_attention")
LAUNCHES_VARLEN = LaunchCounter("flash_attention_varlen")


def segments_from_cu_seqlens(cu_seqlens, total: int):
    """(seg, pos) per packed token from cumulative offsets, both (total,)
    int32.  cu_seqlens: (N+1,) with cu[0] == 0 and cu[N] <= total.  Tokens
    in [cu[s], cu[s+1]) get seg = s and pos = their offset within the
    segment; tokens >= cu[N] (the padding tail) get seg = -1, pos = 0."""
    cu = torch.as_tensor(cu_seqlens).to(torch.int64)
    t = torch.arange(total, device=cu.device)
    seg = torch.searchsorted(cu[1:].contiguous(), t, right=True)
    in_range = t < cu[-1]
    seg = torch.where(in_range, seg, -1)
    pos = torch.where(in_range, t - cu[seg.clamp(min=0)], 0)
    return seg.to(torch.int32), pos.to(torch.int32)


def token_segments(cu_seqlens, total: int):
    """(total,) int32 segment of each packed token, as kernel #10 reads it,
    in two device ops: the segment whose end is the first past the token;
    a token of the padding tail (>= cu[N]) gets N, which the kernel takes as
    padding.  cu_seqlens: (N+1,) int32, contiguous."""
    t = torch.arange(total, dtype=torch.int32, device=cu_seqlens.device)
    return torch.searchsorted(cu_seqlens[1:], t, right=True, out_int32=True)


def _masked_gqa(q, k, v, ok, scale):
    """softmax(q k^T * scale, masked by ``ok``) v over (B, Hq, Tq, d) /
    (B, Hkv, Tk, d), fp32 inside; ``ok`` broadcasts to (B, 1, Tq, Tk).  A
    row with no visible key gives zeros."""
    B, Hq, Tq, d = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, Tq, d).float()
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * scale
    ok = ok[:, :, None]                                  # (B, 1, 1, Tq, Tk)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, Hq, Tq, d).to(q.dtype)


def _window_mask(q_pos, k_pos, window):
    ok = q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return ok


def flash_attention_ref(q, k, v, scale=None, window: int = 0):
    """q: (B, Hq, Tq, d); k, v: (B, Hkv, Tk, d), Hq % Hkv == 0.  The q rows
    are the LAST Tq positions of the Tk-long context; causal, and with
    ``window`` > 0 a query at p sees keys in (p - window, p].  Returns
    (B, Hq, Tq, d) in q.dtype."""
    Tq, d = q.shape[2], q.shape[3]
    Tk = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    ok = _window_mask(torch.arange(Tk - Tq, Tk, device=dev),
                      torch.arange(Tk, device=dev), window)
    return _masked_gqa(q, k, v, ok[None, None], scale)


def flash_attention_varlen_ref(q, k, v, cu_seqlens, scale=None,
                               window: int = 0):
    """Packed ragged causal attention.  q: (total, Hq, d); k, v: (total,
    Hkv, d); cu_seqlens: (N+1,).  Each segment attends only itself,
    causally (and within ``window``); padding tokens past cu[N] return
    zeros.  Returns (total, Hq, d) in q.dtype."""
    total, _, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    seg, _ = segments_from_cu_seqlens(cu_seqlens.to(q.device), total)
    t = torch.arange(total, device=q.device)
    ok = (_window_mask(t, t, window) & (seg[:, None] == seg[None, :])
          & (seg >= 0)[:, None])
    out = _masked_gqa(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                      v.transpose(0, 1)[None], ok[None, None], scale)
    return out[0].transpose(0, 1)


def _check_common(name, q, k, v, q_shape, kv_shape):
    check_head_dim(q_shape[-1])
    if not q.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}")
    dev = q.device
    check_tensor("q", q, q_shape, q.dtype, dev)
    check_tensor("k", k, kv_shape, q.dtype, dev)
    check_tensor("v", v, kv_shape, q.dtype, dev)


def flash_attention_cuda(q, k, v, scale=None, window: int = 0):
    """Kernel #9.  q: (B, Hq, Tq, d); k, v: (B, Hkv, Tk, d), contiguous fp32
    or bf16, d <= 256 (the wide kernel above 128), Hq % Hkv == 0; q rows at
    positions Tk - Tq + i.  Raises on anything else."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-d, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, Hq, Tq, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if Hkv < 1 or Hq % Hkv or Tq < 1 or Tk < 1 or window < 0:
        raise ValueError(f"need Hq % Hkv == 0, Tq, Tk >= 1 and window >= 0; "
                         f"got Hq={Hq}, Hkv={Hkv}, Tq={Tq}, Tk={Tk}, "
                         f"window={window}")
    _check_common("flash_attention_cuda", q, k, v, (B, Hq, Tq, d),
                  (B, Hkv, Tk, d))
    scale = float(scale if scale is not None else d ** -0.5)
    entry, (q, k, v) = route_entry("repro_flash_attention", d, q, k, v)
    out = torch.empty_like(q)
    launch(entry, LAUNCHES, q, k, v, out, B, Hq, Hkv, Tq, Tk, q.shape[-1],
           int(window), Tk - Tq, scale, DTYPE_CODE[q.dtype])
    return unpad_head(out, d)


def flash_attention_varlen_cuda(q, k, v, cu_seqlens, scale=None,
                                window: int = 0):
    """Kernel #10.  q: (total, Hq, d); k, v: (total, Hkv, d), contiguous
    fp32 or bf16, d <= 256 (the wide kernel above 128); cu_seqlens: (N+1,) int32 on the same device,
    cu[0] == 0, nondecreasing, cu[N] <= total.  Raises on anything else."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q and k must be (total, H, d), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    total, Hq, d = q.shape
    Hkv = k.shape[1]
    if Hkv < 1 or Hq % Hkv or total < 1 or window < 0:
        raise ValueError(f"need Hq % Hkv == 0, total >= 1 and window >= 0; "
                         f"got Hq={Hq}, Hkv={Hkv}, total={total}, "
                         f"window={window}")
    _check_common("flash_attention_varlen_cuda", q, k, v, (total, Hq, d),
                  (total, Hkv, d))
    N = cu_seqlens.shape[0] - 1
    if cu_seqlens.dim() != 1 or N < 1:
        raise ValueError(f"cu_seqlens must be (N+1,) with N >= 1, got "
                         f"{tuple(cu_seqlens.shape)}")
    check_tensor("cu_seqlens", cu_seqlens, (N + 1,), torch.int32, q.device)
    seg = token_segments(cu_seqlens, total)
    scale = float(scale if scale is not None else d ** -0.5)
    entry, (q, k, v) = route_entry("repro_flash_attention_varlen", d, q, k,
                                   v)
    out = torch.empty_like(q)
    launch(entry, LAUNCHES_VARLEN, q, k, v, seg, cu_seqlens, out, total, N,
           Hq, Hkv, q.shape[-1], int(window), scale, DTYPE_CODE[q.dtype])
    return unpad_head(out, d)


def _refuse_autograd(name, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only (the flash kernel has no backward, as "
            "in the JAX package): call it under torch.no_grad(), or use the "
            "chunked path (MultiHeadAttention(impl='chunked')) to train")


def flash_attention(q, k, v, *, window: int = 0):
    """Causal/windowed GQA flash attention.  q: (B, Hq, Tq, d); k, v:
    (B, Hkv, Tk, d); the q rows are the last Tq positions of the context
    (q_offset = Tk - Tq).  The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; forward-only."""
    _refuse_autograd("flash_attention", q, k, v)
    if q.is_cuda:
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), window=window)
    return flash_attention_ref(q, k, v, window=window)


def flash_attention_varlen(q, k, v, cu_seqlens, *, window: int = 0):
    """Packed ragged (cu_seqlens) causal/windowed GQA flash attention.
    q: (total, Hq, d); k, v: (total, Hkv, d) — one flattened stream of N
    sequences back to back; cu_seqlens: (N+1,) offsets (cu[0] = 0, cu[N]
    <= total; the tail past cu[N] is padding and returns zeros).  The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors;
    forward-only."""
    _refuse_autograd("flash_attention_varlen", q, k, v)
    cu = torch.as_tensor(cu_seqlens, device=q.device).to(torch.int32)
    if q.is_cuda:
        return flash_attention_varlen_cuda(q.contiguous(), k.contiguous(),
                                           v.contiguous(), cu.contiguous(),
                                           window=window)
    return flash_attention_varlen_ref(q, k, v, cu, window=window)
