// The tile schedule of the MoSA kernels that own a tile of one (batch,
// head) row's selected rows and stream the opposite rows in tiles: the
// streaming forward (mosa_attention.cu, `mosa_fwd_stream_kernel`: #1, #2,
// #5 and #6 above S = 64), whose owned rows are queries and whose streamed
// rows are keys, as the split dq's (mosa_backward.cu, `mosa_bwd_dq_kernel`:
// #3 and #7), and the split dk/dv (`mosa_bwd_dkv_kernel`: #4 and #8), the
// other way round.
//
// A block owns kOwn rows and streams the opposite rows in tiles of kStream.
// Before it streams, it skips by value every tile pair in which no pair can
// pass the mask (plan_tiles): from device memory it reads the owned rows'
// and every streamed tile's range of positions and segments (a Span), and a
// tile pair is needed only where a valid key lies at or before the last
// query in a segment both ranges share (spans_meet).  idx is never assumed
// sorted; block choice's positions are expanded from the block table
// (sel_pos in common.cuh).  A needed tile's per-row words are staged beside
// its rows (stage_meta) and read back as positions with tile_pos.
#pragma once

#include <limits.h>

#include "common.cuh"

namespace repro {

constexpr int kOwn = 64;     // owned rows per block
constexpr int kStream = 32;  // streamed rows per tile

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

// Once per block of kThreads threads, before the streamed tiles: the owned
// tile's positions (kQueries, the owned rows are queries: each row's raw
// position; else keys: each key's, -1 where the row is no key; -1 for rows
// past S in both) and segments into shared memory, and need[t] = whether
// streamed tile t meets the owned tile.  Every warp reads the owned rows
// (64 ints, cached) and every (kThreads / 32)-th streamed tile from device
// memory (sel_pos expands block choice's table).  Ends with a barrier.
template <bool kBlock, bool kQueries, int kThreads>
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
      if (!kQueries && !valid) p = -1;
    }
    if (warp == 0) {
      pos_o[h] = p;
      seg_o[h] = sg;
    }
  }
  own = warp_span(own);
  for (int t = warp; t < nt; t += kThreads / 32) {
    Span sp = empty_span();
    const int r = t * kStream + lane;
    if (r < S) {
      bool valid;
      const int p = sel_pos<kBlock>(idx, row, S, r, bs, seq_len, valid);
      span_add(sp, p, valid, seg ? seg[row * S + r] : 0);
    }
    sp = warp_span(sp);
    if (lane == 0)
      need[t] = kQueries ? spans_meet(own, sp) : spans_meet(sp, own);
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
// uncommitted (threads 0..63 of the block take part): into `pos` the
// tile's idx (token choice) or the span of the block table its rows fall
// in (block choice, at most kStream entries; tile_pos expands it), into
// `sg` its seg when there is one.
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

// Zero rows [r0, r1) x columns [c0, c1) of a staged array (plain stores by
// a block of kThreads threads).
template <int kThreads, typename T>
__device__ __forceinline__ void zero_rect(T* p, int stride, int r0, int r1,
                                          int c0, int c1) {
  const int w = c1 - c0;
  for (int i = threadIdx.x; i < (r1 - r0) * w; i += kThreads) {
    const int r = i / w;
    store_as(p + (r0 + r) * stride + c0 + i - r * w, 0.f);
  }
}

}  // namespace repro
