// Backward of MoSA attention over the expert-choice-selected tokens, written
// by hand for Hopper (sm_90a).
//
// Replaces the two TPU kernels of src/repro/kernels/mosa_backward.py,
// `_mosa_bwd_dq_kernel` (:49) and `_mosa_bwd_dkv_kernel` (:100), both
// launched by `mosa_attention_bwd_pallas` (:162; calls at :188 and :206).
// Recompute-style (flash-attention backward): no O(S^2) matrix is read from
// memory.  With S_ij = scale * q_i.k_j under the mask
// seg_i == seg_j && idx_i >= idx_j && idx_j >= 0, P_ij = exp(S_ij - lse_i)
// recomputed from the forward's per-query log-sum-exp, g~ = r * g and
// delta_i = g~_i . o_pre_i (both from the wrapper, fp32):
//
//   dS_ij = P_ij * (g~_i . v_j - delta_i)
//   dQ_i  = scale * sum_j dS_ij k_j            (mosa_bwd_dq_kernel)
//   dK_j  = scale * sum_i dS_ij q_i            (mosa_bwd_dkv_kernel)
//   dV_j  = sum_i P_ij g~_i                    (mosa_bwd_dkv_kernel)
//
// P is recomputed under the explicit mask, never as exp(s - lse) alone: a
// row with no valid key has lse ~ -1e30, and exp(-1e30 - lse) is not ~0.
//
// Two forms.  When a row's S selected tokens fit one tile (S <= 64, d <=
// 128) the fused kernel below computes dq, dk and dv in one launch, one
// block per row.  Above that, the split pair: `mosa_bwd_dq_kernel` (#3)
// and `mosa_bwd_dkv_kernel` (#4), one template each for token and block
// choice.
//
// Block choice (`kBlock`): the same kernels replace the two TPU kernels of
// src/repro/kernels/mosa_block.py, `_mosa_block_bwd_dq_kernel` (:182) and
// `_mosa_block_bwd_dkv_kernel` (:227), both launched by
// `mosa_block_attention_bwd_pallas` (:371; calls at :390 and :409): the
// fused kernel whenever a row fits one tile (S = NB * bs <= 64), the split
// pair otherwise.  `idx` is the block table (BH, S / bs), and each kernel
// expands it per selected row (sel_pos in common.cuh): pos = bidx[j / bs]
// * bs + j % bs; a row is a valid key iff its block is not empty and pos <
// seq_len, while as a query it keeps its raw position.  Invalid query rows
// arrive with g~ = 0 and delta = 0 (the wrapper zeroes them), so their dS
// is exactly 0 and their share of dV vanishes term by term.  At bs = 1
// every kernel computes what its token-choice form does, bit for bit.
//
// Split pair (any S; the route above S = 64).  What bounds it on an H100,
// at the IsoFLOP sweep's mosa8 point (8 x 69 rows, S = k = 128, d = 64,
// fp32, sorted idx): #3 moves ~91 MB (q, k, v, g~ read once, dq written
// once) against ~1.75 GFLOP of valid pairs, so bytes (0.027 ms at 3.35
// TB/s); #4 does ~2.33 GFLOP (S, dP, dK and dV: 8 d FMAs a pair) against
// ~109 MB, so operations (0.035 ms at 67 TFLOP/s).  Both are fp32
// register-tiled products on the CUDA cores, and the design feeds those:
//
//   * one block per (row, owned tile of 64 rows): queries for dq (the last,
//     heaviest tile launched first), keys for dk/dv (the first launched
//     first).  No two blocks write the same output, there are no atomics,
//     and every output element is summed in a fixed order (dq's two halves
//     added once, in order), so the result is deterministic run to run;
//   * the owned tile is staged once with cp.async 16-byte copies
//     (mosa_row.cuh's stage_rows, at RowLayout's padded strides), and the
//     opposite operand streams in tiles of 32 rows through two stages: the
//     next needed tile's copies are in flight while this one computes;
//   * per streamed tile, phase A computes S and dP as 4 x 4 register tiles
//     per thread, the two halves of a warp over the two halves of d (one
//     shuffle adds them); P and dS under the explicit mask go to a small
//     shared scratch; phase B adds the output products into register tiles
//     (dq: dS k, 8 x 4 per thread, the tile's keys cut in two halves whose
//     sums are added once at the end; dk/dv: dS^T q and P^T g~, 4 x 4
//     each).  The accumulators stay in registers across all streamed tiles
//     and are written once, with 16-byte stores (8-byte for bf16), scale
//     applied at the end.  On the H100 the products are bound by shared
//     memory: a warp's 16-byte load costs ~4 SM clocks when the 8 lanes of
//     each quarter-warp read 8 addresses and ~2.3 when they read one
//     (PERF.md, tools/shared_load_probe.py), against 4 warp FMA
//     instructions a clock, so the tiles give every quarter-warp one
//     address of the owned operand;
//   * tile pairs with no valid pair are skipped by value before they are
//     copied (plan_tiles: the owned tile's and each streamed tile's range
//     of positions and segments, read from device memory; idx is never
//     assumed sorted): at mosa8 a quarter of the tile pairs, the upper
//     off-diagonal of each row;
//   * 256 threads and ~80 KB (dq) / ~89 KB (dk/dv) of shared memory a block
//     at d = 64 fp32 and at most 128 registers a thread, so two blocks per
//     SM; d up to 128 widens the register tiles to two groups of 64
//     columns (~145 / ~154 KB, one block per SM).
//
// Any S >= 1 and any d <= 128, fp32 or bf16 (widened to fp32 as it is read
// from shared memory), are taken without padding in device memory: columns
// d..dpad-1 of every staged tile and the rows past S of a ragged streamed
// tile are zeros, so masked or padded pairs give P = dS = 0 by selection
// and never by multiplying a NaN.  Rows whose d (or whose pointers) do not
// allow 16-byte copies are staged with plain loads.  Tensor cores are not
// used: fp32 inputs would need TF32, whose ~3 decimal digits break the 2e-5
// fp32 tolerance.
//
// Fused backward (`mosa_bwd_fused_kernel`, S <= 64): the training path's
// form of #3 + #4 (token choice) and of #7 + #8 (block choice), one
// template for both.  When a row's S selected tokens fit one tile, one
// block holds the whole row, so dq needs no key outside the block and one
// block can produce dq, dk and dv with no atomics, computing the 5 S x S x d
// products the three need where the split pair computes 7 (each of its
// kernels recomputes S = q.k^T and dP = g~.v^T).  The fused kernel:
//
//   * stages the row's q, k, v (in their dtype) and g~ (fp32) in shared
//     memory (mosa_row.cuh's RowStage and fetch_row, which the one-row
//     forward in mosa_attention.cu shares) with cp.async 16-byte copies (cp.async.cg.shared.global; 4-byte
//     copies for lse, delta, idx and seg), rows at a padded stride of
//     d + 16 bytes' worth of elements, which keeps 16-byte alignment and
//     spreads neighbouring rows over the banks.  The copy is a pure copy:
//     q is not pre-scaled, the scale multiplies each score and dK instead.
//     Block choice copies the row's block table (NB ints) the same way,
//     into the scratch that P later takes, and expands it in shared memory
//     once the copies have landed, into two arrays: each row's query
//     position and its key position (-1 where the row is no key).  Token
//     choice reads both from the one idx array.  Expanding each row from
//     device memory while the copies were in flight put a dependent load on
//     every block's critical path and was slower on the H100 (PERF.md).
//     Padded rows S..Sp-1 are no query and no key (the i < S and j < S
//     tests of phase A), in both modes;
//   * phase A: S and dP as register-tiled products, each thread a 2 x 4
//     micro-tile of both (queries i0, i0+1; keys j0 + m * Sp/4, strided so
//     the 8 key rows a warp reads lie on distinct banks), 16-byte operand
//     loads, 5.3 FMAs per load instruction; P = exp(scale * s - lse) and
//     dS = P * (dP - delta) under the explicit mask, into shared memory as
//     P, dS and dS^T (Sp x (Sp + 4) floats each);
//   * phase B: dQ = scale * dS k, dK = scale * dS^T q, dV = P^T g~ as
//     register-tiled S x d products, each thread a 4 x 4 micro-tile of all
//     three (48 accumulators, 8 FMAs per 16-byte load instruction), each
//     output element written once, straight from registers to device
//     memory with 16-byte stores (8-byte for bf16);
//   * one block per row (~49 KB of shared memory at the slice, so 4 blocks
//     of 4 warps per SM; registers allow 5): the resident blocks overlap one
//     another's copies with their compute.  A persistent form (occupancy x
//     SMs blocks walking over rows, the next row's copies in flight in a
//     second stage) kept only 2 blocks per SM at the slice and measured
//     4-12% slower on the H100 (PERF.md), so it is not kept.
//
// Bound on an H100 at either slice (2208 rows, S = 32, d = 64, fp32; block
// choice as NB = 2 blocks of bs = 16): 10 * pairs * d ~ 0.75 GFLOP of
// valid work, ~0.011 ms at 67 TFLOP/s, against ~127 MB moved (q, k, v, g~
// read once, dq, dk, dv written once, plus lse, delta and the idx or block
// table), ~0.038 ms at 3.35 TB/s: bound by bytes.  bf16 inputs are widened
// to fp32 as they are read from shared memory, and the reduction order is
// fixed.  Any d <= 128 and any 1 <= S <= 64 (any bs that divides S) are
// taken without padding in device memory, as the split pair.  On the H100
// the fused form runs at about twice the byte bound (chip_smoke [4],
// PERF.md): within a block a row's copies and its compute do not overlap,
// and the resident blocks hide only part of that.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "mosa_row.cuh"

namespace {

using namespace repro;

// ------------------------------------------------ split dq, dk/dv (any S)
constexpr int kSplitThreads = 256;  // 8 warps
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kOwn = 64;     // owned rows per block: queries (dq), keys (dkv)
constexpr int kStream = 32;  // streamed rows per tile: keys (dq), queries (dkv)
constexpr int kSG = kStream / 4;  // phase A: streamed rows j0 + kSG * m
constexpr int kCG = 16;  // phase B: groups of 4 columns per 64 columns

// Shared-memory layout of a split kernel's block for (S, d, element size):
// dpad = d rounded up to 4 (the width the products run over), row strides
// of 16 bytes' worth of elements past the rounded width (RowLayout's),
// ps = the row stride of the [kStream][kOwn] scratch, nt = the number of
// streamed tiles.  The owned tile, two stages of the streamed tile, the
// scratch, then one byte per streamed tile (whether it is needed).
struct SplitLayout {
  int dpad, dsT, dsF, ps, nt;
  size_t own_bytes, stage_bytes, bytes;
};

__host__ __device__ inline SplitLayout split_layout(int S, int d, int tsize,
                                                    bool dq) {
  SplitLayout L;
  const int vT = 16 / tsize;
  L.dpad = (d + 3) / 4 * 4;
  L.dsT = (d + vT - 1) / vT * vT + vT;
  L.dsF = L.dpad + 4;
  L.ps = kOwn + 4;
  L.nt = (S + kStream - 1) / kStream;
  const size_t own_t = static_cast<size_t>(kOwn) * L.dsT * tsize;
  const size_t str_t = static_cast<size_t>(kStream) * L.dsT * tsize;
  const size_t own_f = static_cast<size_t>(kOwn) * L.dsF * sizeof(float);
  const size_t str_f = static_cast<size_t>(kStream) * L.dsF * sizeof(float);
  const size_t scratch = static_cast<size_t>(kStream) * L.ps * sizeof(float);
  size_t scratch_bytes;
  if (dq) {
    // owned q (T), g~, lse, delta, query pos, seg; per stage k, v (T), key
    // idx or block table, seg; dS^T
    L.own_bytes = own_t + own_f + 4 * kOwn * sizeof(float);
    L.stage_bytes = 2 * str_t + 2 * kStream * sizeof(int);
    scratch_bytes = scratch;
  } else {
    // owned k, v (T), key pos, seg; per stage q (T), g~, lse, delta, query
    // idx or block table, seg; P, dS
    L.own_bytes = 2 * own_t + 2 * kOwn * sizeof(int);
    L.stage_bytes = str_t + str_f + 4 * kStream * sizeof(float);
    scratch_bytes = 2 * scratch;
  }
  L.bytes = L.own_bytes + 2 * L.stage_bytes + scratch_bytes +
            (L.nt + 15) / 16 * 16;
  // dq's add_halves (8 x 4 floats per thread of a half and group of 64
  // columns) reuses the memory past the owned tile
  const size_t red = (L.dpad <= 64 ? 1 : 2) * 32 * (kSplitThreads / 2) *
                     sizeof(float);
  if (dq && L.bytes < L.own_bytes + red) L.bytes = L.own_bytes + red;
  return L;
}

// What a set of rows can take part in: as queries, the largest position
// and the range of segments (every row); as keys, the smallest position and
// the range of segments (valid keys only).  An empty set meets nothing.
struct Span {
  int qmax, qsmin, qsmax, kmin, ksmin, ksmax;
};

__device__ __forceinline__ Span empty_span() {
  return {INT_MIN, INT_MAX, INT_MIN, INT_MAX, INT_MAX, INT_MIN};
}

__device__ __forceinline__ void span_add(Span& s, int pos, bool key, int sg) {
  s.qmax = max(s.qmax, pos);
  s.qsmin = min(s.qsmin, sg);
  s.qsmax = max(s.qsmax, sg);
  if (key) {
    s.kmin = min(s.kmin, pos);
    s.ksmin = min(s.ksmin, sg);
    s.ksmax = max(s.ksmax, sg);
  }
}

__device__ __forceinline__ Span warp_span(Span s) {
  s.qmax = __reduce_max_sync(kFullMask, s.qmax);
  s.qsmin = __reduce_min_sync(kFullMask, s.qsmin);
  s.qsmax = __reduce_max_sync(kFullMask, s.qsmax);
  s.kmin = __reduce_min_sync(kFullMask, s.kmin);
  s.ksmin = __reduce_min_sync(kFullMask, s.ksmin);
  s.ksmax = __reduce_max_sync(kFullMask, s.ksmax);
  return s;
}

// Whether a query of `qs` and a key of `ks` can pass pair_ok: a valid key
// at or before the last query, in a segment both ranges share.  A tile pair
// that fails this has no valid pair and is skipped; one that passes is
// computed under the per-pair mask.
__device__ __forceinline__ bool spans_meet(const Span& qs, const Span& ks) {
  return ks.kmin <= qs.qmax && ks.ksmin <= qs.qsmax && qs.qsmin <= ks.ksmax;
}

// Once per block, before the streamed tiles: the owned tile's positions
// (kDQ: each query's raw position; else each key's, -1 where the row is no
// key; -1 for rows past S in both) and segments into shared memory, and
// need[t] = whether streamed tile t meets the owned tile.  Every warp reads
// the owned rows (64 ints, cached) and every 8th streamed tile from device
// memory (sel_pos expands block choice's table).  Ends with a barrier.
template <bool kBlock, bool kDQ>
__device__ void plan_tiles(const int* __restrict__ idx,
                           const int* __restrict__ seg, size_t row, int S,
                           int o0, int bs, int seq_len, int* pos_o, int* seg_o,
                           unsigned char* need, int nt) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  Span own = empty_span();
  for (int h = lane; h < kOwn; h += 32) {
    const int r = o0 + h;
    int p = -1, sg = 0;
    if (r < S) {
      bool valid;
      p = sel_pos<kBlock>(idx, row, S, r, bs, seq_len, valid);
      sg = seg ? seg[row * S + r] : 0;
      span_add(own, p, valid, sg);
      if (!kDQ && !valid) p = -1;
    }
    if (warp == 0) {
      pos_o[h] = p;
      seg_o[h] = sg;
    }
  }
  own = warp_span(own);
  for (int t = warp; t < nt; t += kSplitWarps) {
    Span sp = empty_span();
    const int r = t * kStream + lane;
    if (r < S) {
      bool valid;
      const int p = sel_pos<kBlock>(idx, row, S, r, bs, seq_len, valid);
      span_add(sp, p, valid, seg ? seg[row * S + r] : 0);
    }
    sp = warp_span(sp);
    if (lane == 0) need[t] = kDQ ? spans_meet(own, sp) : spans_meet(sp, own);
  }
  __syncthreads();
}

// The first needed streamed tile after t (nt when there is none).
__device__ __forceinline__ int next_tile(const unsigned char* need, int t,
                                         int nt) {
  for (++t; t < nt && !need[t]; ++t) {
  }
  return t;
}

// Start the copies of streamed tile [s0, s0 + ns)'s per-row words,
// uncommitted: into `pos` the tile's idx (token choice) or the span of the
// block table its rows fall in (block choice, at most kStream entries;
// tile_pos expands it), into `sg` its seg when there is one.
template <bool kBlock>
__device__ __forceinline__ void stage_meta(int* pos, int* sg,
                                           const int* __restrict__ idx,
                                           const int* __restrict__ seg,
                                           size_t row, int S, int s0, int ns,
                                           int bs) {
  const int t = threadIdx.x;
  if constexpr (kBlock) {
    const int b0 = s0 / bs;
    if (t <= (s0 + ns - 1) / bs - b0)
      cp_async4(pos + t, idx + row * (S / bs) + b0 + t);
  } else {
    if (t < ns) cp_async4(pos + t, idx + row * S + s0 + t);
  }
  if (seg && t >= 32 && t < 32 + ns)
    cp_async4(sg + t - 32, seg + row * S + s0 + t - 32);
}

// Streamed row j's position from the staged words (sel_pos's rule): the
// raw position, valid iff it is a key.
template <bool kBlock>
__device__ __forceinline__ int tile_pos(const int* pos, int s0, int j, int bs,
                                        int seq_len, bool& valid) {
  if constexpr (kBlock) {
    const int r = s0 + j;
    const int b = pos[r / bs - s0 / bs];
    const int p = b * bs + r % bs;
    valid = b >= 0 && p < seq_len;
    return p;
  } else {
    const int p = pos[j];
    valid = p >= 0;
    return p;
  }
}

// Zero rows [r0, r1) x columns [c0, c1) of a staged array (plain stores).
template <typename T>
__device__ __forceinline__ void zero_rect(T* p, int stride, int r0, int r1,
                                          int c0, int c1) {
  const int w = c1 - c0;
  for (int i = threadIdx.x; i < (r1 - r0) * w; i += kSplitThreads) {
    const int r = i / w;
    store_as(p + (r0 + r) * stride + c0 + i - r * w, 0.f);
  }
}

// Phase A: S = a1 . b1 and E = a2 . b2 for owned rows o0..o0+3 and
// streamed rows j0 + kSG * m (m < 4): a 4 x 4 register tile of each per
// thread.  The two halves of a warp take the two halves of the dpad
// columns and add their sums with one shuffle each, so 256 threads cover a
// 64 x 32 tile pair.  The 8 lanes of a quarter-warp share their owned rows
// (a 16-byte load read by all 8 costs about half a load of 8 addresses on
// the H100, tools/shared_load_probe.py) and read 8 streamed rows that start
// 4 banks apart;
// 128 FMAs per 16 such loads.
template <typename A1, typename A2, typename B1, typename B2>
__device__ __forceinline__ void tile_dots(const A1* a1, int sa1,
                                          const A2* a2, int sa2,
                                          const B1* b1, int sb1,
                                          const B2* b2, int sb2, int o0,
                                          int j0, int c0, int c1,
                                          float s[4][4], float e[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < 4; ++m) s[r][m] = e[r][m] = 0.f;
  // S, then dP: the first product's operands are dead before the second's
  // load, which keeps the registers for the accumulators.
#pragma unroll 2
  for (int c = c0; c < c1; c += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = ld4(a1 + (o0 + r) * sa1 + c);
#pragma unroll
    for (int m = 0; m < 4; ++m) y[m] = ld4(b1 + (j0 + kSG * m) * sb1 + c);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < 4; ++m) s[r][m] = dot4(x[r], y[m], s[r][m]);
  }
#pragma unroll 2
  for (int c = c0; c < c1; c += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = ld4(a2 + (o0 + r) * sa2 + c);
#pragma unroll
    for (int m = 0; m < 4; ++m) y[m] = ld4(b2 + (j0 + kSG * m) * sb2 + c);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < 4; ++m) e[r][m] = dot4(x[r], y[m], e[r][m]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      s[r][m] += __shfl_xor_sync(kFullMask, s[r][m], 16);
      e[r][m] += __shfl_xor_sync(kFullMask, e[r][m], 16);
    }
}

// Phase A's thread layout: micro-tile u = warp * 16 + lane % 16 takes owned
// rows 4 * (u / 8) .. +3 and streamed rows u % 8 + kSG * m; lane / 16 picks
// the half of the columns [c0, c1) and the two owned rows of the four whose
// P and dS the thread writes.
struct PhaseA {
  int o0, j0, half, c0, c1;
  __device__ PhaseA(int tid, int dpad) {
    const int u = (tid / 32) * 16 + tid % 16;
    o0 = (u / kSG) * 4;
    j0 = u % kSG;
    half = (tid % 32) / 16;
    const int mid = (dpad / 4 + 1) / 2 * 4;
    c0 = half ? mid : 0;
    c1 = half ? dpad : mid;
  }
};

// Phase B's register tile: kR rows x 4 columns per group of 64 columns.
// With kR = 8 the streamed rows of a tile are cut in two halves (kJS = 2),
// each taken by 128 threads, and the halves' sums are added once, at the
// end (add_halves).  Thread layout: half js = tid / (256 / kJS), rows r0 =
// kR * ((tid % (256 / kJS)) / 16), columns 4 * (tid % 16) + 64 w: the 8
// lanes of a quarter-warp share their rows (one address) and read 8
// neighbouring column groups.
template <int kR>
struct PhaseB {
  static constexpr int kJS = kR / 4;
  static constexpr int kRows = kStream / kJS;  // streamed rows per half
  int js, r0, cb;
  __device__ explicit PhaseB(int tid) {
    const int per = kSplitThreads / kJS;
    js = tid / per;
    r0 = kR * ((tid % per) / kCG);
    cb = (tid % kCG) * 4;
  }
};

// acc[a][b] += x[a] * y[b] over a kR x 4 register tile, x as kR / 4 float4s.
template <int kR>
__device__ __forceinline__ void outer(float acc[kR][4], const float4* x,
                                      float4 y) {
  const float yb[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int g = 0; g < kR / 4; ++g) {
    const float xa[4] = {x[g].x, x[g].y, x[g].z, x[g].w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc[4 * g + a][b] = fmaf(xa[a], yb[b], acc[4 * g + a][b]);
  }
}

// With two halves of streamed rows (kJS = 2): the second half's threads
// leave their tiles in `red` (n floats each, coalesced), and after a
// barrier the first half's add them to theirs, in that order.  Every thread
// must call it (it holds barriers); `red` may alias the stages, free once
// the streamed tiles are done.
template <int kN>
__device__ __forceinline__ void add_halves(float* acc, float* red, int js) {
  const int t = threadIdx.x % (kSplitThreads / 2);
  __syncthreads();
  if (js == 1)
#pragma unroll
    for (int i = 0; i < kN; ++i) red[i * (kSplitThreads / 2) + t] = acc[i];
  __syncthreads();
  if (js == 0)
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] += red[i * (kSplitThreads / 2) + t];
}

// Write rows r0..r0+kR-1 (those < n) x columns c..c+3 (those < d) of a
// register tile, times `mul`, to out (row stride d): one 16-byte (bf16:
// 8-byte) store per row when `vec` and the four columns are real.
template <int kR, typename T>
__device__ __forceinline__ void store_tile(T* out, int d, int n, int r0,
                                           int c, float acc[kR][4], float mul,
                                           bool vec) {
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    if (r0 + a >= n) continue;
    float o[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) o[b] = acc[a][b] * mul;
    T* p = out + static_cast<size_t>(r0 + a) * d + c;
    if (vec && c + 4 <= d) {
      st4(p, o);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (c + b < d) store_as(p + b, o[b]);
    }
  }
}

// dq (#3, #7): one block per (row, query tile of 64), the last query tile
// launched first.  The block stages its queries' q, g~, lse and delta once
// and streams the keys' k and v in tiles of 32; per needed tile, phase A
// (S and dP; dS under the explicit mask into dS^T in shared memory), then
// phase B (dq += dS k: 8 x 4 register tiles, each half of the threads over
// one half of the tile's keys; 3 loads per 32 FMAs).
template <typename T, bool kBlock, int kCW>
__global__ void __launch_bounds__(kSplitThreads, kCW == 1 ? 2 : 1)
mosa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ idx,
                   const int* __restrict__ seg, const float* __restrict__ gt,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int S,
                   int d, float scale, bool vec, int bs, int seq_len) {
  extern __shared__ float4 split_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(split_smem);
  const SplitLayout L = split_layout(S, d, sizeof(T), true);
  T* qo = reinterpret_cast<T*>(base);                       // [kOwn][dsT]
  float* go = reinterpret_cast<float*>(qo + kOwn * L.dsT);  // [kOwn][dsF]
  float* lse_o = go + kOwn * L.dsF;
  float* delta_o = lse_o + kOwn;
  int* pos_o = reinterpret_cast<int*>(delta_o + kOwn);
  int* seg_o = pos_o + kOwn;
  struct Stage {
    T *k, *v;  // [kStream][dsT]
    int *pos, *seg;
  };
  auto stage = [&](int s) {
    T* p = reinterpret_cast<T*>(base + L.own_bytes + s * L.stage_bytes);
    int* w = reinterpret_cast<int*>(p + 2 * kStream * L.dsT);
    return Stage{p, p + kStream * L.dsT, w, w + kStream};
  };
  float* dst = reinterpret_cast<float*>(base + L.own_bytes +
                                        2 * L.stage_bytes);  // [kStream][ps]
  unsigned char* need = reinterpret_cast<unsigned char*>(dst + kStream * L.ps);

  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const size_t row0 = row * S;
  const int o0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  const int no = min(kOwn, S - o0);

  stage_rows(qo, L.dsT, q + (row0 + o0) * d, no, d, vec, tid, kSplitThreads);
  stage_rows(go, L.dsF, gt + (row0 + o0) * d, no, d, vec, tid,
             kSplitThreads);
  for (int i = tid; i < no; i += kSplitThreads) {
    cp_async4(lse_o + i, lse + row0 + o0 + i);
    cp_async4(delta_o + i, delta + row0 + o0 + i);
  }
  cp_async_commit();
  // Columns d..dpad-1 are never copied, nor is seg when there is none
  // (every key in segment 0): zeros.
  if (d < L.dpad) {
    zero_rect(qo, L.dsT, 0, kOwn, d, L.dpad);
    zero_rect(go, L.dsF, 0, kOwn, d, L.dpad);
    for (int s = 0; s < 2; ++s) {
      zero_rect(stage(s).k, L.dsT, 0, kStream, d, L.dpad);
      zero_rect(stage(s).v, L.dsT, 0, kStream, d, L.dpad);
    }
  }
  if (!seg && tid < 2 * kStream) stage(tid / kStream).seg[tid % kStream] = 0;
  plan_tiles<kBlock, true>(idx, seg, row, S, o0, bs, seq_len, pos_o, seg_o,
                           need, L.nt);

  // Rows past S of a ragged tile are zeros: phase B multiplies them by 0.
  auto issue = [&](int t, int s) {
    const int s0 = t * kStream, ns = min(kStream, S - s0);
    const Stage st = stage(s);
    T* const kv[2] = {st.k, st.v};
    const T* const src[2] = {k + (row0 + s0) * d, v + (row0 + s0) * d};
    stage_rows(kv, L.dsT, src, ns, d, vec, tid, kSplitThreads);
    stage_meta<kBlock>(st.pos, st.seg, idx, seg, row, S, s0, ns, bs);
    if (ns < kStream) {
      zero_rect(st.k, L.dsT, ns, kStream, 0, L.dpad);
      zero_rect(st.v, L.dsT, ns, kStream, 0, L.dpad);
    }
  };

  constexpr int kR = 8;
  const PhaseA pa(tid, L.dpad);
  const PhaseB<kR> pb(tid);
  float acc[kCW][kR][4] = {};
  int cur = next_tile(need, -1, L.nt);
  if (cur < L.nt) issue(cur, 0);
  cp_async_commit();
  for (int s = 0; cur < L.nt; s ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // tile cur landed; the other stage and dS^T are free
    const int nxt = next_tile(need, cur, L.nt);
    if (nxt < L.nt) issue(nxt, s ^ 1);
    cp_async_commit();
    const Stage st = stage(s);
    const int s0 = cur * kStream, ns = min(kStream, S - s0);

    float sc[4][4], dp[4][4];
    tile_dots(qo, L.dsT, go, L.dsF, st.k, L.dsT, st.v, L.dsT, pa.o0, pa.j0,
              pa.c0, pa.c1, sc, dp);
    int kp[4], ks[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = pa.j0 + kSG * m;
      bool valid;
      const int p = tile_pos<kBlock>(st.pos, s0, j, bs, seq_len, valid);
      kp[m] = (j < ns && valid) ? p : -1;
      ks[m] = st.seg[j];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = pa.o0 + 2 * pa.half + r;
      const int iq = pos_o[i], sq = seg_o[i];
      const float lse_i = lse_o[i], delta_i = delta_o[i];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float sv = pa.half ? sc[2 + r][m] : sc[r][m];
        const float ev = pa.half ? dp[2 + r][m] : dp[r][m];
        const bool ok = pair_ok(iq, sq, kp[m], ks[m]);
        const float p = ok ? expf(sv * scale - lse_i) : 0.f;
        dst[(pa.j0 + kSG * m) * L.ps + i] = ok ? p * (ev - delta_i) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < pb.kRows; ++jj) {
      const int j = pb.js * pb.kRows + jj;
      float4 a[kR / 4];
#pragma unroll
      for (int g = 0; g < kR / 4; ++g) a[g] = ld4(dst + j * L.ps + pb.r0 + 4 * g);
#pragma unroll
      for (int w = 0; w < kCW; ++w)
        if (pb.cb + 64 * w < L.dpad)
          outer<kR>(acc[w], a, ld4(st.k + j * L.dsT + pb.cb + 64 * w));
    }
    cur = nxt;
  }
  cp_async_wait_all();
  add_halves<kCW * kR * 4>(&acc[0][0][0],
                           reinterpret_cast<float*>(base + L.own_bytes),
                           pb.js);

  if (pb.js == 0) {
    T* out = dq + (row0 + o0) * d;
#pragma unroll
    for (int w = 0; w < kCW; ++w)
      if (pb.cb + 64 * w < L.dpad)
        store_tile<kR>(out, d, no, pb.r0, pb.cb + 64 * w, acc[w], scale, vec);
  }
}

// dk, dv (#4, #8): one block per (row, key tile of 64), the first key tile
// launched first; dq's schedule with the roles swapped: the block stages
// its keys' k and v once and streams the queries' q, g~, lse and delta in
// tiles of 32; phase A writes P and dS ([query][key]), phase B adds dS^T q
// and P^T g~ into two 4 x 4 register tiles over all of the tile's queries
// (4 loads per 32 FMAs; 8 x 4 tiles over halves, as dq's, need more than
// the 128 registers two blocks an SM leave and were slower on the H100).
template <typename T, bool kBlock, int kCW>
__global__ void __launch_bounds__(kSplitThreads, kCW == 1 ? 2 : 1)
mosa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ idx,
                    const int* __restrict__ seg, const float* __restrict__ gt,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int S, int d, float scale, bool vec,
                    int bs, int seq_len) {
  extern __shared__ float4 split_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(split_smem);
  const SplitLayout L = split_layout(S, d, sizeof(T), false);
  T* ko = reinterpret_cast<T*>(base);  // [kOwn][dsT]
  T* vo = ko + kOwn * L.dsT;
  int* pos_o = reinterpret_cast<int*>(vo + kOwn * L.dsT);
  int* seg_o = pos_o + kOwn;
  struct Stage {
    T* q;      // [kStream][dsT]
    float* g;  // [kStream][dsF]
    float *lse, *delta;
    int *pos, *seg;
  };
  auto stage = [&](int s) {
    T* p = reinterpret_cast<T*>(base + L.own_bytes + s * L.stage_bytes);
    float* g = reinterpret_cast<float*>(p + kStream * L.dsT);
    float* f = g + kStream * L.dsF;
    int* w = reinterpret_cast<int*>(f + 2 * kStream);
    return Stage{p, g, f, f + kStream, w, w + kStream};
  };
  float* P = reinterpret_cast<float*>(base + L.own_bytes +
                                      2 * L.stage_bytes);  // [kStream][ps]
  float* dS = P + kStream * L.ps;
  unsigned char* need = reinterpret_cast<unsigned char*>(dS + kStream * L.ps);

  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const size_t row0 = row * S;
  const int o0 = blockIdx.y * kOwn;
  const int no = min(kOwn, S - o0);

  {
    T* const kv[2] = {ko, vo};
    const T* const src[2] = {k + (row0 + o0) * d, v + (row0 + o0) * d};
    stage_rows(kv, L.dsT, src, no, d, vec, tid, kSplitThreads);
  }
  cp_async_commit();
  if (d < L.dpad) {
    zero_rect(ko, L.dsT, 0, kOwn, d, L.dpad);
    zero_rect(vo, L.dsT, 0, kOwn, d, L.dpad);
    for (int s = 0; s < 2; ++s) {
      zero_rect(stage(s).q, L.dsT, 0, kStream, d, L.dpad);
      zero_rect(stage(s).g, L.dsF, 0, kStream, d, L.dpad);
    }
  }
  if (!seg && tid < 2 * kStream) stage(tid / kStream).seg[tid % kStream] = 0;
  plan_tiles<kBlock, false>(idx, seg, row, S, o0, bs, seq_len, pos_o, seg_o,
                            need, L.nt);

  auto issue = [&](int t, int s) {
    const int s0 = t * kStream, ns = min(kStream, S - s0);
    const Stage st = stage(s);
    stage_rows(st.q, L.dsT, q + (row0 + s0) * d, ns, d, vec, tid,
               kSplitThreads);
    stage_rows(st.g, L.dsF, gt + (row0 + s0) * d, ns, d, vec, tid,
               kSplitThreads);
    stage_meta<kBlock>(st.pos, st.seg, idx, seg, row, S, s0, ns, bs);
    if (tid >= 64 && tid < 64 + ns) {
      cp_async4(st.lse + tid - 64, lse + row0 + s0 + tid - 64);
      cp_async4(st.delta + tid - 64, delta + row0 + s0 + tid - 64);
    }
    if (ns < kStream) {
      zero_rect(st.q, L.dsT, ns, kStream, 0, L.dpad);
      zero_rect(st.g, L.dsF, ns, kStream, 0, L.dpad);
    }
  };

  constexpr int kR = 4;
  const PhaseA pa(tid, L.dpad);
  const PhaseB<kR> pb(tid);
  float ak[kCW][kR][4] = {}, av[kCW][kR][4] = {};
  int cur = next_tile(need, -1, L.nt);
  if (cur < L.nt) issue(cur, 0);
  cp_async_commit();
  for (int s = 0; cur < L.nt; s ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // tile cur landed; the other stage, P and dS are free
    const int nxt = next_tile(need, cur, L.nt);
    if (nxt < L.nt) issue(nxt, s ^ 1);
    cp_async_commit();
    const Stage st = stage(s);
    const int s0 = cur * kStream, ns = min(kStream, S - s0);

    float sc[4][4], dp[4][4];
    tile_dots(ko, L.dsT, vo, L.dsT, st.q, L.dsT, st.g, L.dsF, pa.o0, pa.j0,
              pa.c0, pa.c1, sc, dp);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = pa.j0 + kSG * m;
      bool valid;
      const int iq = tile_pos<kBlock>(st.pos, s0, j, bs, seq_len, valid);
      const bool q_ok = j < ns;
      const int sq = st.seg[j];
      const float lse_j = st.lse[j], delta_j = st.delta[j];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = pa.o0 + 2 * pa.half + r;
        const float sv = pa.half ? sc[2 + r][m] : sc[r][m];
        const float ev = pa.half ? dp[2 + r][m] : dp[r][m];
        const bool ok = q_ok && pair_ok(iq, sq, pos_o[i], seg_o[i]);
        const float p = ok ? expf(sv * scale - lse_j) : 0.f;
        P[j * L.ps + i] = p;
        dS[j * L.ps + i] = ok ? p * (ev - delta_j) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < pb.kRows; ++jj) {
      const int j = pb.js * pb.kRows + jj;
      float4 a_k[kR / 4], a_v[kR / 4];
#pragma unroll
      for (int g = 0; g < kR / 4; ++g) {
        a_k[g] = ld4(dS + j * L.ps + pb.r0 + 4 * g);
        a_v[g] = ld4(P + j * L.ps + pb.r0 + 4 * g);
      }
#pragma unroll
      for (int w = 0; w < kCW; ++w) {
        const int c = pb.cb + 64 * w;
        if (c < L.dpad) {
          outer<kR>(ak[w], a_k, ld4(st.q + j * L.dsT + c));
          outer<kR>(av[w], a_v, ld4(st.g + j * L.dsF + c));
        }
      }
    }
    cur = nxt;
  }
  cp_async_wait_all();

  T* out_k = dk + (row0 + o0) * d;
  T* out_v = dv + (row0 + o0) * d;
#pragma unroll
  for (int w = 0; w < kCW; ++w) {
    const int c = pb.cb + 64 * w;
    if (c < L.dpad) {
      store_tile<kR>(out_k, d, no, pb.r0, c, ak[w], scale, vec);
      store_tile<kR>(out_v, d, no, pb.r0, c, av[w], 1.f, vec);
    }
  }
}

// Both split kernels: grid (BH, ceil(S / 64)) of 256 threads; kCW (the
// register tiles' groups of 64 columns) from d.
bool split_args_ok(int BH, int S, int d, int bs) {
  return S >= 1 && d >= 1 && d <= kRowMaxD && BH >= 0 && bs >= 1 &&
         S % bs == 0;
}

template <typename T, bool kBlock>
int launch_dq(const void* q, const void* k, const void* v, const void* idx,
              const void* seg, const void* gt, const void* lse,
              const void* delta, void* dq, int BH, int S, int d, float scale,
              int bs, int seq_len, cudaStream_t stream) {
  if (!split_args_ok(BH, S, d, bs))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaSuccess);
  const SplitLayout L = split_layout(S, d, sizeof(T), true);
  const bool vec = d % (16 / sizeof(T)) == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v) && aligned16(gt) &&
                   aligned16(dq);
  auto* kernel = L.dpad <= 64 ? mosa_bwd_dq_kernel<T, kBlock, 1>
                              : mosa_bwd_dq_kernel<T, kBlock, 2>;
  const cudaError_t err = allow_smem(kernel, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (S + kOwn - 1) / kOwn);
  kernel<<<grid, kSplitThreads, L.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(gt),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, d, scale, vec, bs, seq_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBlock>
int launch_dkv(const void* q, const void* k, const void* v, const void* idx,
               const void* seg, const void* gt, const void* lse,
               const void* delta, void* dk, void* dv, int BH, int S, int d,
               float scale, int bs, int seq_len, cudaStream_t stream) {
  if (!split_args_ok(BH, S, d, bs))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaSuccess);
  const SplitLayout L = split_layout(S, d, sizeof(T), false);
  const bool vec = d % (16 / sizeof(T)) == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v) && aligned16(gt) &&
                   aligned16(dk) && aligned16(dv);
  auto* kernel = L.dpad <= 64 ? mosa_bwd_dkv_kernel<T, kBlock, 1>
                              : mosa_bwd_dkv_kernel<T, kBlock, 2>;
  const cudaError_t err = allow_smem(kernel, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (S + kOwn - 1) / kOwn);
  kernel<<<grid, kSplitThreads, L.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(gt),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, d, scale, vec, bs,
      seq_len);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBlock>
int dq_dtype(int dtype, const void* q, const void* k, const void* v,
             const void* idx, const void* seg, const void* gt,
             const void* lse, const void* delta, void* dq, int BH, int S,
             int d, float scale, int bs, int seq_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_dq<float, kBlock>(q, k, v, idx, seg, gt, lse, delta, dq, BH,
                                    S, d, scale, bs, seq_len, st);
  if (dtype == kBFloat16)
    return launch_dq<__nv_bfloat16, kBlock>(q, k, v, idx, seg, gt, lse, delta,
                                            dq, BH, S, d, scale, bs, seq_len,
                                            st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kBlock>
int dkv_dtype(int dtype, const void* q, const void* k, const void* v,
              const void* idx, const void* seg, const void* gt,
              const void* lse, const void* delta, void* dk, void* dv, int BH,
              int S, int d, float scale, int bs, int seq_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_dkv<float, kBlock>(q, k, v, idx, seg, gt, lse, delta, dk,
                                     dv, BH, S, d, scale, bs, seq_len, st);
  if (dtype == kBFloat16)
    return launch_dkv<__nv_bfloat16, kBlock>(q, k, v, idx, seg, gt, lse,
                                             delta, dk, dv, BH, S, d, scale,
                                             bs, seq_len, st);
  return static_cast<int>(cudaErrorInvalidValue);
}


// ------------------------------------------------- fused dq, dk, dv (S <= 64)
// The row's staging (RowLayout, RowStage, fetch_row) is mosa_row.cuh's,
// shared with the one-row forward.
template <typename T, bool kBlock>
__global__ void __launch_bounds__(kRowThreads)
mosa_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ idx,
                      const int* __restrict__ seg,
                      const float* __restrict__ gt,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dq,
                      T* __restrict__ dk, T* __restrict__ dv, int S, int d,
                      float scale, bool vec, int bs, int seq_len) {
  extern __shared__ float4 fused_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(fused_smem);
  const RowLayout L = row_layout(S, d, sizeof(T), kBlock, true);
  const RowStage<T, kBlock, true> st(smem, L);
  float* P = reinterpret_cast<float*>(smem + L.stage_bytes);
  float* dS = P + L.Sp * L.ps;
  float* dSt = dS + L.Sp * L.ps;
  const int nkg = L.Sp / 4;  // groups of 4 keys (phase A), of 4 rows (B)
  const int nqg = L.Sp / 2;  // pairs of queries (phase A)
  const int ncg = L.dpad / 4;  // groups of 4 columns (phase B)
  const int row = blockIdx.x;

  // Start the row's copies, then zero the padding (rows S..Sp-1, columns
  // d..dpad-1), which the copies never write.  Without seg every key is in
  // segment 0.  Block choice then expands the staged block table (sel_pos).
  fetch_row(st, L, q, k, v, gt, lse, delta, nullptr, idx, seg, row, S, d,
            vec, bs);
  cp_async_commit();
  zero_row_padding(st, L, S, d, seg != nullptr);
  cp_async_wait_all();
  __syncthreads();
  if constexpr (kBlock) {
    expand_row_blocks(st, S, bs, seq_len, false);
    __syncthreads();
  }

  // Phase A: S and dP, a 2 x 4 micro-tile of each per thread.
  for (int t = threadIdx.x; t < nqg * nkg; t += kRowThreads) {
    const int i0 = (t / nkg) * 2;
    const int j0 = t % nkg;
    float s[2][4] = {}, dp[2][4] = {};
    for (int c = 0; c < L.dpad; c += 4) {
      float4 qa[2], ga[2], kb[4], vb[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        qa[r] = ld4(st.q + (i0 + r) * L.dsT + c);
        ga[r] = ld4(st.g + (i0 + r) * L.dsF + c);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        kb[m] = ld4(st.k + (j0 + m * nkg) * L.dsT + c);
        vb[m] = ld4(st.v + (j0 + m * nkg) * L.dsT + c);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          s[r][m] = dot4(qa[r], kb[m], s[r][m]);
          dp[r][m] = dot4(ga[r], vb[m], dp[r][m]);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + r;
      const bool q_ok = i < S;
      const int iq = q_ok ? st.pos[i] : -1;
      const int sq = q_ok ? st.seg[i] : 0;
      const float lse_i = q_ok ? st.lse[i] : 0.f;
      const float delta_i = q_ok ? st.delta[i] : 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = j0 + m * nkg;
        const bool ok =
            q_ok && j < S && pair_ok(iq, sq, st.idx[j], st.seg[j]);
        const float p = ok ? expf(s[r][m] * scale - lse_i) : 0.f;
        const float ds = ok ? p * (dp[r][m] - delta_i) : 0.f;
        P[i * L.ps + j] = p;
        dS[i * L.ps + j] = ds;
        dSt[j * L.ps + i] = ds;
      }
    }
  }
  __syncthreads();

  // Phase B: dQ, dK and dV, a 4 x 4 micro-tile of each per thread.
  const size_t base = static_cast<size_t>(row) * S;
  for (int t = threadIdx.x; t < nkg * ncg; t += kRowThreads) {
    const int r0 = (t / ncg) * 4;
    const int c0 = (t % ncg) * 4;
    float aq[4][4] = {}, ak[4][4] = {}, av[4][4] = {};
    for (int u = 0; u < S; ++u) {
      const float4 dst4 = ld4(dSt + u * L.ps + r0);  // dS[r0 + a][u]
      const float4 ds4 = ld4(dS + u * L.ps + r0);    // dS[u][r0 + a]
      const float4 p4 = ld4(P + u * L.ps + r0);      // P[u][r0 + a]
      const float4 k4 = ld4(st.k + u * L.dsT + c0);
      const float4 q4 = ld4(st.q + u * L.dsT + c0);
      const float4 g4 = ld4(st.g + u * L.dsF + c0);
      const float a_q[4] = {dst4.x, dst4.y, dst4.z, dst4.w};
      const float a_k[4] = {ds4.x, ds4.y, ds4.z, ds4.w};
      const float a_v[4] = {p4.x, p4.y, p4.z, p4.w};
      const float b_q[4] = {k4.x, k4.y, k4.z, k4.w};
      const float b_k[4] = {q4.x, q4.y, q4.z, q4.w};
      const float b_v[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          aq[a][b] = fmaf(a_q[a], b_q[b], aq[a][b]);
          ak[a][b] = fmaf(a_k[a], b_k[b], ak[a][b]);
          av[a][b] = fmaf(a_v[a], b_v[b], av[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = r0 + a;
      if (r < S) {
        float out_q[4], out_k[4], out_v[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          out_q[b] = aq[a][b] * scale;
          out_k[b] = ak[a][b] * scale;
          out_v[b] = av[a][b];
        }
        T* pq = dq + (base + r) * d + c0;
        T* pk = dk + (base + r) * d + c0;
        T* pv = dv + (base + r) * d + c0;
        if (vec && c0 + 4 <= d) {
          st4(pq, out_q);
          st4(pk, out_k);
          st4(pv, out_v);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c0 + b < d) {
              store_as(pq + b, out_q[b]);
              store_as(pk + b, out_k[b]);
              store_as(pv + b, out_v[b]);
            }
        }
      }
    }
  }
}

// One block per row.
template <typename T, bool kBlock>
int launch_fused(const void* q, const void* k, const void* v, const void* idx,
                 const void* seg, const void* gt, const void* lse,
                 const void* delta, void* dq, void* dk, void* dv, int BH,
                 int S, int d, float scale, int bs, int seq_len,
                 cudaStream_t stream) {
  if (S < 1 || S > kRowMaxS || d < 1 || d > kRowMaxD || BH < 0 || bs < 1 ||
      S % bs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaSuccess);
  const RowLayout L = row_layout(S, d, sizeof(T), kBlock, true);
  const size_t smem = L.stage_bytes + L.scratch_bytes;
  const bool vec = d % (16 / sizeof(T)) == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v) && aligned16(gt) &&
                   aligned16(dq) && aligned16(dk) && aligned16(dv);
  auto* kernel = mosa_bwd_fused_kernel<T, kBlock>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<BH, kRowThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(gt),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), S, d,
      scale, vec, bs, seq_len);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBlock>
int fused_dtype(int dtype, const void* q, const void* k, const void* v,
                const void* idx, const void* seg, const void* gt,
                const void* lse, const void* delta, void* dq, void* dk,
                void* dv, int BH, int S, int d, float scale, int bs,
                int seq_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_fused<float, kBlock>(q, k, v, idx, seg, gt, lse, delta, dq,
                                       dk, dv, BH, S, d, scale, bs, seq_len,
                                       st);
  if (dtype == kBFloat16)
    return launch_fused<__nv_bfloat16, kBlock>(q, k, v, idx, seg, gt, lse,
                                               delta, dq, dk, dv, BH, S, d,
                                               scale, bs, seq_len, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Both entry points: q, k, v (and dq, dk, dv): (BH, S, d) contiguous in
// `dtype`; idx, seg: (BH, S) int32 (seg may be null); gt: (BH, S, d) float32
// (= r * g); lse, delta: (BH, S) float32.  Each launches its kernel on
// `stream` and returns cudaGetLastError().
extern "C" int repro_mosa_attention_bwd_dq(const void* q, const void* k,
                                           const void* v, const void* idx,
                                           const void* seg, const void* gt,
                                           const void* lse, const void* delta,
                                           void* dq, int BH, int S, int d,
                                           float scale, int dtype,
                                           void* stream) {
  return dq_dtype<false>(dtype, q, k, v, idx, seg, gt, lse, delta, dq, BH, S,
                         d, scale, 1, 0, stream);
}

extern "C" int repro_mosa_attention_bwd_dkv(const void* q, const void* k,
                                            const void* v, const void* idx,
                                            const void* seg, const void* gt,
                                            const void* lse,
                                            const void* delta, void* dk,
                                            void* dv, int BH, int S, int d,
                                            float scale, int dtype,
                                            void* stream) {
  return dkv_dtype<false>(dtype, q, k, v, idx, seg, gt, lse, delta, dk, dv,
                          BH, S, d, scale, 1, 0, stream);
}

// The fused backward (token choice, S <= 64, d <= 128): inputs as above,
// dq, dk, dv (BH, S, d) in `dtype`, all three from one launch.  Returns
// cudaErrorInvalidValue for S > 64 or d > 128, else cudaGetLastError().
extern "C" int repro_mosa_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* idx,
                                        const void* seg, const void* gt,
                                        const void* lse, const void* delta,
                                        void* dq, void* dk, void* dv, int BH,
                                        int S, int d, float scale, int dtype,
                                        void* stream) {
  return fused_dtype<false>(dtype, q, k, v, idx, seg, gt, lse, delta, dq, dk,
                            dv, BH, S, d, scale, 1, 0, stream);
}

// Block choice (kernels #7 and #8): as above with S = NB * bs, bidx (BH,
// NB) int32 block indices in place of idx, and T the true sequence length;
// gt and delta are zero on invalid query rows.
extern "C" int repro_mosa_block_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bidx,
    const void* seg, const void* gt, const void* lse, const void* delta,
    void* dq, int BH, int S, int d, int bs, int T, float scale, int dtype,
    void* stream) {
  return dq_dtype<true>(dtype, q, k, v, bidx, seg, gt, lse, delta, dq, BH, S,
                        d, scale, bs, T, stream);
}

extern "C" int repro_mosa_block_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* bidx,
    const void* seg, const void* gt, const void* lse, const void* delta,
    void* dk, void* dv, int BH, int S, int d, int bs, int T, float scale,
    int dtype, void* stream) {
  return dkv_dtype<true>(dtype, q, k, v, bidx, seg, gt, lse, delta, dk, dv,
                         BH, S, d, scale, bs, T, stream);
}

// The fused block-choice backward (#7 + #8 in one launch; S = NB * bs <=
// 64, d <= 128, bs divides S): inputs as the two entries above, dq, dk, dv
// as repro_mosa_attention_bwd.  Returns cudaErrorInvalidValue outside that
// range, else cudaGetLastError().
extern "C" int repro_mosa_block_attention_bwd(
    const void* q, const void* k, const void* v, const void* bidx,
    const void* seg, const void* gt, const void* lse, const void* delta,
    void* dq, void* dk, void* dv, int BH, int S, int d, int bs, int T,
    float scale, int dtype, void* stream) {
  return fused_dtype<true>(dtype, q, k, v, bidx, seg, gt, lse, delta, dq, dk,
                           dv, BH, S, d, scale, bs, T, stream);
}
