// One (batch, head) row of MoSA attention held by one thread block: the
// shared-memory staging that the one-row forward (mosa_attention.cu,
// `mosa_fwd_row_kernel`: kernels #1, #2, #5 and #6 at S <= 64) and the
// fused backward (mosa_backward.cu, `mosa_bwd_fused_kernel`: #3 + #4 and
// #7 + #8 at S <= 64) share; its copy loop, `stage_rows`, also stages the
// tiles of the split backward kernels (mosa_backward.cu, S > 64).
//
// A row's S selected tokens are staged whole: q, k and v in their dtype at
// a padded row stride of d + 16 bytes' worth of elements (16-byte aligned
// rows, neighbouring rows on other banks), copied with 16-byte cp.async
// (cp.async.cg.shared.global; 4-byte copies for the per-row words).  The
// copy is a pure copy: q is not pre-scaled.  Per row the backward stages
// g~ (fp32), lse and delta, the forward its router score; both stage the
// key position (idx, -1 where the row is no key) and the segment.  Block
// choice copies the row's block table (NB ints, then the forward's NB
// block scores) to the start of the scratch that follows the stage, and
// expands it in shared memory once the copies have landed into each row's
// query position (`pos`, raw: an invalid row is still a query), key
// position and block score; token choice reads both positions from the one
// idx array.  Rows S..Sp-1 and columns d..dpad-1 are zeros.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kRowThreads = 128;  // one block of 4 warps per row
constexpr int kRowMaxS = 64;
constexpr int kRowMaxD = 128;

__device__ __forceinline__ bool pair_ok(int idx_q, int seg_q, int idx_k,
                                        int seg_k) {
  return idx_k >= 0 && idx_q >= idx_k && seg_q == seg_k;
}

// Shared-memory layout of one staged row for (S, d, element size, mode).
// Sp = S rounded up to 4, dpad = d rounded up to 4 (the width the products
// run over), row strides of 16 bytes' worth of elements past the rounded
// width; ps = the row stride of the scratch matrices (the forward's P^T,
// the backward's P, dS and dS^T), which follow the stage.
struct RowLayout {
  int Sp, dpad, dsT, dsF, ps;
  size_t stage_bytes, scratch_bytes;
};

__host__ __device__ inline RowLayout row_layout(int S, int d, int tsize,
                                                bool block, bool bwd) {
  RowLayout L;
  const int vT = 16 / tsize;
  L.Sp = (S + 3) / 4 * 4;
  L.dpad = (d + 3) / 4 * 4;
  L.dsT = (d + vT - 1) / vT * vT + vT;
  L.dsF = L.dpad + 4;
  L.ps = L.Sp + 4;
  // per-row words: g~, lse, delta, idx, seg (backward) or score, idx, seg
  // (forward), and block choice's pos
  const int words = (bwd ? L.dsF + 4 : 3) + (block ? 1 : 0);
  L.stage_bytes = static_cast<size_t>(L.Sp) * (3 * L.dsT * tsize + words * 4);
  L.scratch_bytes = sizeof(float) * static_cast<size_t>(L.Sp) *
                    (bwd ? 3 * L.ps : L.ps + 2);
  return L;
}

// The staged row: q, k, v [Sp][dsT] (dtype T); the backward's g~ [Sp][dsF],
// lse and delta [Sp], or the forward's score [Sp]; idx (each row's key
// position, -1 = not a key) and seg [Sp]; pos (each row's query position):
// its own [Sp] array in block choice, idx itself in token choice; `table`,
// the start of the scratch, where block choice copies its block table.
template <typename T, bool kBlock, bool kBwd>
struct RowStage {
  T *q, *k, *v;
  float *g, *lse, *delta, *score;
  int *idx, *seg, *pos, *table;

  __device__ RowStage(unsigned char* base, const RowLayout& L) {
    const size_t n = static_cast<size_t>(L.Sp) * L.dsT;
    q = reinterpret_cast<T*>(base);
    k = q + n;
    v = k + n;
    float* f = reinterpret_cast<float*>(v + n);
    if constexpr (kBwd) {
      g = f;
      lse = g + static_cast<size_t>(L.Sp) * L.dsF;
      delta = lse + L.Sp;
      score = nullptr;
      f = delta + L.Sp;
    } else {
      g = lse = delta = nullptr;
      score = f;
      f = score + L.Sp;
    }
    idx = reinterpret_cast<int*>(f);
    seg = idx + L.Sp;
    pos = kBlock ? seg + L.Sp : idx;
    table = reinterpret_cast<int*>(base + L.stage_bytes);
  }
};

// Start the copies of n rows of width d of each of kN arrays (src[a] at
// row stride d) into dst[a] at row stride ds, uncommitted, in one loop:
// 16-byte cp.async when `vec` (d a multiple of 16 bytes' worth of
// elements, the pointers 16-byte aligned), else plain loads.  Thread `tid`
// of `nthreads` takes every nthreads-th copy.  The one-row kernels stage a
// whole row with it, the split backward kernels (mosa_backward.cu) a tile.
template <typename T, int kN>
__device__ __forceinline__ void stage_rows(T* const (&dst)[kN], int ds,
                                           const T* const (&src)[kN], int n,
                                           int d, bool vec, int tid,
                                           int nthreads) {
  if (vec) {
    constexpr int kV = 16 / sizeof(T);
    const int cpr = d / kV;
    for (int i = tid; i < n * cpr; i += nthreads) {
      const int rr = i / cpr;
      const int c = (i - rr * cpr) * kV;
#pragma unroll
      for (int a = 0; a < kN; ++a)
        cp_async16(dst[a] + rr * ds + c, src[a] + rr * d + c);
    }
  } else {
    for (int i = tid; i < n * d; i += nthreads) {
      const int rr = i / d;
#pragma unroll
      for (int a = 0; a < kN; ++a) dst[a][rr * ds + i - rr * d] = src[a][i];
    }
  }
}

// One array.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ds,
                                           const T* __restrict__ src, int n,
                                           int d, bool vec, int tid,
                                           int nthreads) {
  T* const dsts[1] = {dst};
  const T* const srcs[1] = {src};
  stage_rows(dsts, ds, srcs, n, d, vec, tid, nthreads);
}

// Start the copies of row `row` into `st` (stage_rows), uncommitted: q, k,
// v; g~, lse and delta (backward) or the router scores r (forward; none
// when r is null); idx and seg, or block choice's table and block scores.
template <typename T, bool kBlock, bool kBwd>
__device__ void fetch_row(const RowStage<T, kBlock, kBwd>& st,
                          const RowLayout& L, const T* __restrict__ q,
                          const T* __restrict__ k, const T* __restrict__ v,
                          const float* __restrict__ gt,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ r,
                          const int* __restrict__ idx,
                          const int* __restrict__ seg, size_t row, int S,
                          int d, bool vec, int bs) {
  const size_t base = row * S;
  const int tid = threadIdx.x;
  T* const qkv[3] = {st.q, st.k, st.v};
  const T* const src[3] = {q + base * d, k + base * d, v + base * d};
  stage_rows(qkv, L.dsT, src, S, d, vec, tid, kRowThreads);
  if constexpr (kBwd)
    stage_rows(st.g, L.dsF, gt + base * d, S, d, vec, tid, kRowThreads);
  const int nb = S / bs;
  for (int i = tid; i < S; i += kRowThreads) {
    if constexpr (kBwd) {
      cp_async4(st.lse + i, lse + base + i);
      cp_async4(st.delta + i, delta + base + i);
    }
    if constexpr (kBlock) {
      if (i < nb) {
        cp_async4(st.table + i, idx + row * nb + i);
        if (r) cp_async4(st.table + nb + i, r + row * nb + i);
      }
    } else {
      cp_async4(st.idx + i, idx + base + i);
      if (r) cp_async4(st.score + i, r + base + i);
    }
    if (seg) cp_async4(st.seg + i, seg + base + i);
  }
}

// Zero what the copies never write: rows S..Sp-1 and columns d..dpad-1 of
// q, k, v (and g~), and seg when there is none (every key in segment 0).
template <typename T, bool kBlock, bool kBwd>
__device__ void zero_row_padding(const RowStage<T, kBlock, kBwd>& st,
                                 const RowLayout& L, int S, int d,
                                 bool has_seg) {
  if (S < L.Sp || d < L.dpad) {
    for (int i = threadIdx.x; i < L.Sp * L.dpad; i += kRowThreads) {
      const int r = i / L.dpad;
      const int c = i - r * L.dpad;
      if (r >= S || c >= d) {
        store_as(st.q + r * L.dsT + c, 0.f);
        store_as(st.k + r * L.dsT + c, 0.f);
        store_as(st.v + r * L.dsT + c, 0.f);
        if constexpr (kBwd) st.g[r * L.dsF + c] = 0.f;
      }
    }
  }
  if (!has_seg)
    for (int i = threadIdx.x; i < L.Sp; i += kRowThreads) st.seg[i] = 0;
}

// Block choice, once the copies have landed (after a barrier; follow with
// one): each row's query position (raw), key position (-1 for an empty
// block or a row past seq_len, sel_pos in common.cuh) and, when the block
// scores were staged, its block's score.
template <typename T, bool kBwd>
__device__ void expand_row_blocks(const RowStage<T, true, kBwd>& st, int S,
                                  int bs, int seq_len, bool scores) {
  const float* tscore = reinterpret_cast<const float*>(st.table + S / bs);
  for (int i = threadIdx.x; i < S; i += kRowThreads) {
    bool valid;
    const int p = sel_pos<true>(st.table, 0, S, i, bs, seq_len, valid);
    st.pos[i] = p;
    st.idx[i] = valid ? p : -1;
    if constexpr (!kBwd)
      if (scores) st.score[i] = tscore[i / bs];
  }
}

}  // namespace repro
