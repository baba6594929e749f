"""Paged attention over a paged dense cache: decode (one query token per
row) and packed chunked prefill.

Decode replaces the TPU kernel ``_paged_kernel`` of
``repro/serve/paged_attention.py``:

  * ``paged_attention_ref``    — plain PyTorch, a port of the JAX gather
    reference: gather the row's blocks back to the contiguous layout and
    run the contiguous decode math (NEG_INF where-mask, fp32 softmax);
  * ``paged_attention_cuda``   — the hand-written CUDA kernel
    (``csrc/paged_attention.cu``): each row's pages split over a cluster of
    ``DECODE_CLUSTER`` thread blocks, read through the block table with
    cp.async (no gather buffer), the row's exact max and the merge through
    distributed shared memory (``decode_grid`` and ``decode_spans`` give the
    geometry);
  * ``paged_attention_decode`` — the dispatcher: a CUDA tensor goes to the
    kernel, a CPU tensor to the plain version.  There is no other route.

Both kernels are built for head dims 32, 64 and 128, and each has a wide
form at 256 (``csrc/wide_attention.cu``: one block per (row or token, KV
head), one warp per query head of the group, keys streamed through the
block table in tiles of 32; the same launch counter); together these are
``HEAD_DIMS``.  The wrappers take any 1 <= d <= 256 by zero-padding q and
the pools to the next of these widths and slicing the output back
(``_run_padded``, as the JAX wrappers' ``_pad_lane``), and raise for
d > 256 (ROADMAP C.2).

Packed prefill replaces ``_paged_prefill_kernel``: a chunk of N segments
flattened back to back (``cu_seqlens``), segment n continuing batch row
``rows[n]`` after ``past_lens[n]`` cached tokens.

  * ``paged_prefill_attention_ref``  — plain PyTorch, the JAX reference:
    every token attends the gathered keys of its row at positions <= its
    own;
  * ``paged_prefill_attention_cuda`` — the hand-written CUDA kernel
    (``csrc/paged_prefill.cu``), reading the packed stream directly, the
    key axis cut into splits that a second launch merges
    (``prefill_grid`` gives the geometry);
  * ``paged_prefill_attention``      — the dispatcher, as for decode.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODE, LaunchCounter,
                                      check_head_dim, check_tensor, launch,
                                      route_entry, route_width, unpad_head)
from repro_torch.serve.paged_kv import PagedDenseKVCache

NEG_INF = -1e30
NARROW_DIMS = (32, 64, 128)     # the narrow kernels' builds
HEAD_DIMS = NARROW_DIMS + (256,)
MAX_GROUP = 8            # query heads per KV head the kernel takes
LAUNCHES = LaunchCounter("paged_attention_decode")
LAUNCHES_PREFILL = LaunchCounter("paged_prefill_attention")
# The packed-prefill kernel's tiles (kRows, kSplitKeys in
# csrc/paged_prefill.cu): query rows per block, key positions per split.
PREFILL_ROWS = 32
PREFILL_SPLIT_KEYS = 128
# The decode kernel's constants (csrc/paged_attention.cu): blocks per
# (row, KV head) cluster, threads per block, positions per pipeline stage,
# the ring's target bytes and most stages, the score capacity of a window
# (floats) and the largest table staged whole.
DECODE_CLUSTER = 8
DECODE_THREADS = 256
DECODE_TILE = 32
DECODE_RING_BYTES = 49152
DECODE_MAX_STAGES = 8
DECODE_SCORE_FLOATS = 16384
DECODE_FULL_TABLE = 4096


def paged_attention_ref(q, k_pool, v_pool, block_table, lengths, scale):
    """q: (B, Hq, d); pools (N, bs, Hkv, d); block_table (B, nb);
    lengths (B,).  Returns (B, Hq, d) in q.dtype: every position
    ``< length`` of the row attends.

    A row of length 0 has no valid key: every score is NEG_INF, so every p
    is 1 and the row gets the mean of V over its (clamped) gathered blocks,
    as JAX's ``paged_attention_ref`` does.  The kernels (the TPU's
    ``_paged_kernel`` and ``paged_attention_cuda``) return exact zeros
    there; the serving paths never attend a row of length 0."""
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


def decode_spans(length: int, nb: int, bs: int):
    """The decode kernel's work split of one row of ``length`` cached
    positions (clamped to [0, nb * bs]): for each of the
    ``DECODE_CLUSTER`` blocks of its cluster, the span [s0, s1) of
    positions it reads -- a balanced, page-aligned share of the row's
    ceil(length / bs) pages (rank c takes pages [c * n // 8, (c + 1) * n //
    8)); an empty span is (s0, s0)."""
    length = max(0, min(length, nb * bs))
    pages = -(-length // bs)
    out = []
    for c in range(DECODE_CLUSTER):
        p0 = c * pages // DECODE_CLUSTER
        p1 = (c + 1) * pages // DECODE_CLUSTER
        s0 = p0 * bs
        out.append((s0, max(s0, min(p1 * bs, length))))
    return out


def decode_stages(d: int, elem_bytes: int = 4) -> int:
    """Tiles of the decode kernel's ring: ``DECODE_RING_BYTES`` of tiles of
    ``DECODE_TILE`` positions, 2 to ``DECODE_MAX_STAGES``."""
    n = DECODE_RING_BYTES // (DECODE_TILE * d * elem_bytes)
    return min(DECODE_MAX_STAGES, max(2, n))


def decode_grid(B: int, Hq: int, Hkv: int, d: int, nb: int, bs: int,
                elem_bytes: int = 4):
    """Launch geometry of the decode kernel for B rows of ``nb`` blocks of
    ``bs`` (elements of ``elem_bytes``): (grid, cluster, shared-memory
    bytes, window).  One cluster of ``DECODE_CLUSTER`` blocks per (row, KV
    head).  A window is the span positions whose scores shared memory
    holds: the longest span (ceil(nb / 8) pages) rounded up to whole
    tiles, capped at ``DECODE_SCORE_FLOATS / R`` floats; a longer span
    streams its later windows' keys again in the second pass.  Shared
    memory: the ring (``decode_stages`` tiles), the scores [R][window], the
    partials and denominators the peers push, the maxima and warp slots,
    the row's table entries (rows of more than ``DECODE_FULL_TABLE`` blocks
    read them from device memory instead)."""
    R = Hq // Hkv

    def round4(x):
        return (x + 3) & ~3

    pages = -(-nb // DECODE_CLUSTER)
    tile = DECODE_TILE
    cap = DECODE_SCORE_FLOATS // R // tile * tile
    window = max(tile, min(-(-(pages * bs) // tile) * tile, cap))
    slots = nb if nb <= DECODE_FULL_TABLE else 0
    warps = DECODE_THREADS // 32
    floats = (R * window + round4(R * d)
              + (DECODE_CLUSTER + 2 + warps) * MAX_GROUP)
    smem = (elem_bytes * decode_stages(d, elem_bytes) * tile * d
            + 4 * floats + 4 * round4(slots))
    return (DECODE_CLUSTER * B * Hkv,), (DECODE_CLUSTER,), smem, window


def padded_head_dim(d: int) -> int:
    """The width the paged kernels run a head dim ``d`` at: the smallest
    of ``HEAD_DIMS`` that is >= d.  Raises for d > 256 (ROADMAP C.2)."""
    check_head_dim(d)
    return route_width(d, NARROW_DIMS)


def _run_padded(entry, kernel, q, k_pool, v_pool, *args):
    """``kernel`` on the C entry ``route_entry`` picks for head dim d, with
    q and both pools zero-padded on the last axis to ``padded_head_dim(d)``
    and its output sliced back to d, as the JAX wrappers' ``_pad_lane``
    does.  Zero columns change no score and add only zero output columns,
    in fp32 and bf16 alike; the caller's scale (computed on the true d) is
    passed through.  At d in ``HEAD_DIMS`` the tensors go to the kernel as
    they are, with no copy; otherwise each call copies q and both whole
    pools (ROADMAP B names the kernel-side alternative)."""
    d = q.shape[-1]
    check_head_dim(d)
    entry, (q, k_pool, v_pool) = route_entry(entry, d, q, k_pool, v_pool,
                                             narrow=NARROW_DIMS)
    return unpad_head(kernel(q, k_pool, v_pool, *args, entry=entry), d)


def _check_geometry(q, k_pool):
    """Head dim, dtype and GQA group the paged kernels take."""
    d, Hq, Hkv = q.shape[-1], q.shape[-2], k_pool.shape[2]
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"need Hq % Hkv == 0 and Hq / Hkv <= {MAX_GROUP}, "
                         f"got Hq={Hq}, Hkv={Hkv}")


def _check_aligned(**tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention_cuda(q, k_pool, v_pool, block_table, lengths, scale):
    """The CUDA kernel.  q: (B, Hq, d); pools (N, bs, Hkv, d), contiguous
    fp32 or bf16 with 1 <= d <= 256 and Hq / Hkv <= 8; block_table (B, nb)
    int32; lengths (B,) int32.  Raises on anything else.  A d outside
    ``HEAD_DIMS`` runs zero-padded (``_run_padded``: a copy of q and both
    pools per call); one launch either way."""
    return _run_padded("repro_paged_attention_decode", _decode_kernel, q,
                       k_pool, v_pool, block_table, lengths, scale)


def _decode_kernel(q, k_pool, v_pool, block_table, lengths, scale, *, entry):
    """One launch of the decode kernel's C entry ``entry`` at d in
    ``HEAD_DIMS``."""
    if not q.is_cuda:
        raise ValueError("paged_attention_cuda needs CUDA tensors")
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be (B, Hq, d) and pools (N, bs, Hkv, d), got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    B, Hq, d = q.shape
    N, bs, Hkv = k_pool.shape[:3]
    nb = block_table.shape[-1]
    _check_geometry(q, k_pool)
    dev = q.device
    check_tensor("q", q, (B, Hq, d), q.dtype, dev)
    check_tensor("k_pool", k_pool, (N, bs, Hkv, d), q.dtype, dev)
    check_tensor("v_pool", v_pool, (N, bs, Hkv, d), q.dtype, dev)
    check_tensor("block_table", block_table, (B, nb), torch.int32, dev)
    check_tensor("lengths", lengths, (B,), torch.int32, dev)
    _check_aligned(q=q, k_pool=k_pool, v_pool=v_pool)
    out = torch.empty_like(q)
    launch(entry, LAUNCHES, q, k_pool, v_pool, block_table, lengths, out, B,
           Hq, Hkv, d, bs, nb, float(scale), DTYPE_CODE[q.dtype])
    return out


def paged_attention_decode(q, cache: PagedDenseKVCache, *, scale: float):
    """Decode attention of one token per row over a paged dense cache.
    q: (B, Hq, d).  The CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    args = (q, cache.k, cache.v, cache.block_table, cache.length, scale)
    if q.is_cuda:
        return paged_attention_cuda(*args)
    return paged_attention_ref(*args)


# ------------------------------------------------- packed varlen prefill
def packed_token_layout(cu_seqlens, row_of_seg, past_lens, total: int):
    """Per-token view of a packed chunk: (seg, local, row_of_tok,
    pos_in_kv), each (total,).  ``seg`` is -1 on the padding tail
    (t >= cu[N]); ``row_of_tok`` is -1 there and on inactive segments;
    ``pos_in_kv`` is the token's absolute position in its row's KV space
    (-1 where ``seg`` is -1)."""
    cu = cu_seqlens.long()
    t = torch.arange(total, device=cu.device)
    seg = torch.searchsorted(cu[1:].contiguous(), t, right=True)
    seg = torch.where(t < cu[-1], seg, -1)
    segc = seg.clamp(min=0)
    local = t - cu[segc]
    row_of_tok = torch.where(seg >= 0, row_of_seg.long()[segc], -1)
    pos_in_kv = torch.where(seg >= 0, past_lens.long()[segc] + local, -1)
    return seg, local, row_of_tok, pos_in_kv


def paged_prefill_attention_ref(q, k_pool, v_pool, block_table, row_of_tok,
                                pos_in_kv, scale):
    """Packed ragged prefill attention over paged pools (the plain version).

    q: (total, Hq, d); pools (P, bs, Hkv, d); block_table (B, nb);
    row_of_tok (total,): the batch row whose KV each token reads (-1 =
    padding -> zero output); pos_in_kv (total,): the token's own position
    in that row's KV space; it attends every key at a position <= it.
    Returns (total, Hq, d) in q.dtype.  The chunk's own K/V must already be
    in the pools."""
    total, Hq, d = q.shape
    nb, bs = block_table.shape[1], k_pool.shape[1]
    Hkv = k_pool.shape[2]
    R = Hq // Hkv
    S = nb * bs
    B = block_table.shape[0]
    bt = block_table.long().clamp(min=0)
    kk = k_pool[bt].reshape(B, S, Hkv, d)
    vv = v_pool[bt].reshape(B, S, Hkv, d)
    row = row_of_tok.long().clamp(min=0)
    kt, vt = kk[row], vv[row]                                # (T, S, Hkv, d)
    qg = q.reshape(total, Hkv, R, d).float()
    s = torch.einsum("tgrd,tsgd->tgrs", qg, kt.float()) * scale
    k_pos = torch.arange(S, device=q.device)
    ok = (k_pos[None, :] <= pos_in_kv.long()[:, None]) \
        & (row_of_tok >= 0)[:, None]                         # (T, S)
    ok = ok[:, None, None, :]
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    out = torch.einsum("tgrs,tsgd->tgrd", p, vt.float())
    out = out / p.sum(-1).clamp_min(1e-30)[..., None]
    return out.reshape(total, Hq, d).to(q.dtype)


def prefill_grid(total: int, N: int, Hq: int, Hkv: int, d: int, nb: int,
                 bs: int):
    """Launch geometry of the packed-prefill kernel for a chunk of
    ``total`` tokens in ``N`` segments over rows of ``nb`` blocks of ``bs``:
    (grid, splits, workspace shape).  A block holds ``PREFILL_ROWS`` query
    rows (the R = Hq / Hkv heads of one KV head for PREFILL_ROWS // R tokens
    of one segment) against one split of ``PREFILL_SPLIT_KEYS`` key
    positions.  grid = (query tiles, splits, Hkv): the active segments have
    at most ceil(total / tokens per tile) + N - 1 tiles.  The fp32
    workspace (total, Hq, splits, d + 2) holds each split's partial
    output, running max and denominator per (token, query head)."""
    tq = PREFILL_ROWS // (Hq // Hkv)
    splits = -(-(nb * bs) // PREFILL_SPLIT_KEYS)
    grid = (-(-total // tq) + N - 1, splits, Hkv)
    return grid, splits, (total, Hq, splits, d + 2)


def paged_prefill_attention_cuda(q, k_pool, v_pool, block_table, cu_seqlens,
                                 row_of_seg, past_lens, scale):
    """The CUDA kernel.  q: (total, Hq, d) packed; pools (P, bs, Hkv, d),
    contiguous fp32 or bf16 with 1 <= d <= 256 and Hq / Hkv <= 8;
    block_table (B, nb), cu_seqlens (N + 1,), row_of_seg and past_lens
    (N,), all int32.  Raises on anything else.  Padding tokens and
    inactive segments come back as exact zeros (the kernel writes them).
    A d outside ``HEAD_DIMS`` runs zero-padded, as for decode."""
    return _run_padded("repro_paged_prefill_attention", _prefill_kernel, q,
                       k_pool, v_pool, block_table, cu_seqlens, row_of_seg,
                       past_lens, scale)


def _prefill_kernel(q, k_pool, v_pool, block_table, cu_seqlens, row_of_seg,
                    past_lens, scale, *, entry):
    """The C entry ``entry``: the split and merge launches (one count) at
    d <= 128, the wide kernel's one launch at d 256."""
    if not q.is_cuda:
        raise ValueError("paged_prefill_attention_cuda needs CUDA tensors")
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be (total, Hq, d) and pools (P, bs, Hkv, "
                         f"d), got {tuple(q.shape)} and "
                         f"{tuple(k_pool.shape)}")
    total, Hq, d = q.shape
    P, bs, Hkv = k_pool.shape[:3]
    B, nb = block_table.shape
    N = row_of_seg.shape[0]
    _check_geometry(q, k_pool)
    dev = q.device
    check_tensor("q", q, (total, Hq, d), q.dtype, dev)
    check_tensor("k_pool", k_pool, (P, bs, Hkv, d), q.dtype, dev)
    check_tensor("v_pool", v_pool, (P, bs, Hkv, d), q.dtype, dev)
    check_tensor("block_table", block_table, (B, nb), torch.int32, dev)
    check_tensor("cu_seqlens", cu_seqlens, (N + 1,), torch.int32, dev)
    check_tensor("row_of_seg", row_of_seg, (N,), torch.int32, dev)
    check_tensor("past_lens", past_lens, (N,), torch.int32, dev)
    _check_aligned(q=q, k_pool=k_pool, v_pool=v_pool)
    if N == 0 or total == 0:
        return torch.zeros_like(q)
    out = torch.empty_like(q)
    if entry.endswith("_wide"):         # one launch, no split workspace
        ws = None
    else:
        _, _, ws_shape = prefill_grid(total, N, Hq, Hkv, d, nb, bs)
        ws = torch.empty(ws_shape, dtype=torch.float32, device=dev)
    launch(entry, LAUNCHES_PREFILL, q, k_pool, v_pool, block_table,
           cu_seqlens, row_of_seg, past_lens, out, ws, total, N, Hq, Hkv, d,
           bs, nb, float(scale), DTYPE_CODE[q.dtype])
    return out


def paged_prefill_attention(q, cache: PagedDenseKVCache, cu_seqlens,
                            row_of_seg, past_lens, *, scale: float):
    """Packed ragged prefill over a paged dense cache.  q: (total, Hq, d),
    N segments back to back; cu_seqlens (N + 1,) offsets (cu[N] may be <
    total: the tail is padding); row_of_seg (N,) batch row per segment (-1
    = inactive); past_lens (N,) tokens in the row's cache BEFORE this
    chunk.  The chunk's K/V must already be appended (``append_packed``).
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return paged_prefill_attention_cuda(
            q, cache.k, cache.v, cache.block_table, cu_seqlens, row_of_seg,
            past_lens, scale)
    _, _, row_of_tok, pos_in_kv = packed_token_layout(
        cu_seqlens, row_of_seg, past_lens, q.shape[0])
    return paged_prefill_attention_ref(q, cache.k, cache.v, cache.block_table,
                                       row_of_tok, pos_in_kv, scale)
