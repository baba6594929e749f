// Causal or sliding-window GQA flash attention, written by hand for Hopper
// (sm_90a): the dense (or local) heads' full forward.
//
// Replaces two TPU kernels of src/repro/kernels/flash_attention.py:
// `_flash_kernel` (:26, launched by `flash_attention_pallas`, :78) and, as
// the `kVarlen` form of the same template, `_flash_varlen_kernel` (:116,
// launched by `flash_attention_varlen_pallas`, :188).
//
//   flash:  q (B, Hq, Tq, d), k/v (B, Hkv, Tk, d).  Query row i sits at
//           position qpos = q_offset + i (q_offset = Tk - Tq: the queries
//           are the last Tq positions of the context) and attends key p
//           iff p <= qpos and, with a window W > 0, qpos - p < W.
//   varlen: q (total, Hq, d), k/v (total, Hkv, d), one packed stream of N
//           segments [cu[s], cu[s+1]).  Token t of segment seg[t] attends
//           key p iff cu[seg[t]] <= p <= t and, with W > 0, t - p < W (the
//           segment-equality mask of the TPU kernel, written as a lower
//           bound: within one segment global order is local order).  A
//           padding token (t >= cu[N], seg -1) attends nothing.
//
// GQA: query head h reads KV head h / (Hq / Hkv); nothing is repeated.
// Softmax statistics are fp32 (running max, denominator, accumulator);
// masked scores are -1e30 with p zeroed, the denominator is floored at
// 1e-30, so a query with no visible key (a padding token, or a query at a
// negative position when Tq > Tk) gives exact zeros.  The output is in the
// input dtype.  Unlike the TPU wrapper nothing is padded: d is any width
// up to 128 (staged zero-padded to the next of 32, 64, 128 in shared
// memory), and any Tq, Tk and total work (ragged tiles are masked).
//
// What bounds it on an H100: at the window model's shape (B 8, H 4, T 1024,
// d 64, W 256, fp32) the bytes are q, k, v read once and o written once,
// 33.5 MB (~0.010 ms at 3.35 TB/s), and the operations are 4*d per
// visible (query, key) pair, 229,504 pairs per head, 1.88 GFLOP (~0.028
// ms at 67 TFLOP/s fp32 outside the tensor cores); at the dense baseline's
// causal shape (8, 9, 1024, 64) 9.7 GFLOP (~0.144 ms).  So the bound is the
// operations, and the design spends its effort on the inner products:
//
//   * one thread block per (b, query head, tile of 64 query rows); the
//     rows are staged pre-scaled in shared memory (fp32);
//   * a loop over key tiles of 32 in [lo, hi): lo and hi are cut by
//     causality, the window and (varlen) the first row's segment start,
//     so the work per tile is O(min(q_end, W)), not O(Tk);
//   * each K/V tile is staged in shared memory once and serves all 64
//     rows; warp w owns rows 8w..8w+7: lane j scores key j against its
//     8 rows (the key row is read once for 8 rows, the query values come
//     as 16-byte broadcasts), the warp reduces max and sum with shuffles,
//     writes its p row to shared memory, and each lane accumulates the
//     output columns it owns from 16-byte broadcasts of p;
//   * a row whose visible range misses the tile skips its update.
//
// No cp.async, TMA or tensor cores yet: the products run on the CUDA cores
// in fp32 and the loads of one tile do not overlap the products of the
// last.  That is the work of a later redesign.

#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kKeys = 32;                      // keys per tile, one per lane

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kRows) * DP            // q rows, pre-scaled
          + static_cast<size_t>(kKeys) * (DP + 1)    // K tile, padded rows
          + static_cast<size_t>(kKeys) * DP          // V tile
          + static_cast<size_t>(kRows) * kKeys);     // p, one row per query
}

// Visible key range [lo, hi] of query `t` (hi < lo: none).
template <bool kVarlen>
__device__ __forceinline__ void key_range(int t, int n_q, int Tk, int q_offset,
                                          int window,
                                          const int* __restrict__ seg,
                                          const int* __restrict__ cu, int& lo,
                                          int& hi) {
  lo = 1;
  hi = 0;
  if (t >= n_q) return;
  if constexpr (kVarlen) {
    const int s = seg[t];
    if (s < 0) return;                          // padding token
    lo = cu[s];
    hi = t;
  } else {
    lo = 0;
    hi = min(q_offset + t, Tk - 1);             // may be < 0: no key
  }
  if (window > 0) lo = max(lo, (kVarlen ? t : q_offset + t) - window + 1);
}

template <typename T, int DP, bool kVarlen>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ seg,
             const int* __restrict__ cu, T* __restrict__ o, int Hq, int Hkv,
             int Tq, int Tk, int d, int window, int q_offset, int n_seg,
             float scale) {
  constexpr int kCols = DP / 32;               // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                            // [kRows][DP]
  float* ks = qs + kRows * DP;                 // [kKeys][DP + 1]
  float* vs = ks + kKeys * (DP + 1);           // [kKeys][DP]
  float* ps = vs + kKeys * DP;                 // [kRows][kKeys]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (Hq / Hkv);
  const int t0 = blockIdx.x * kRows;           // first query row of the tile
  // Row strides and bases: (B, H, T, d) or the packed (total, H, d).
  size_t q_base, k_base, q_stride, k_stride;
  if constexpr (kVarlen) {
    q_base = static_cast<size_t>(h) * d;
    k_base = static_cast<size_t>(g) * d;
    q_stride = static_cast<size_t>(Hq) * d;
    k_stride = static_cast<size_t>(Hkv) * d;
  } else {
    q_base = (static_cast<size_t>(b) * Hq + h) * Tq * d;
    k_base = (static_cast<size_t>(b) * Hkv + g) * Tk * d;
    q_stride = d;
    k_stride = d;
  }

  // The block's key range: the rows' ranges are nondecreasing in t, so it
  // runs from the first row's lo to the last real row's hi (a varlen tile
  // may end in padding rows, which lie past cu[n_seg]).
  const int n_rows = min(kRows, Tq - t0);
  int last = t0 + n_rows - 1;
  if constexpr (kVarlen) last = min(last, cu[n_seg] - 1);
  int key_lo = 0, key_hi = -1;                 // inclusive
  if (last >= t0) {
    int lo0, hi0, lo1, hi1;
    key_range<kVarlen>(t0, Tq, Tk, q_offset, window, seg, cu, lo0, hi0);
    key_range<kVarlen>(last, Tq, Tk, q_offset, window, seg, cu, lo1, hi1);
    key_lo = max(lo0, 0);
    key_hi = hi1;
  }

  for (int i = threadIdx.x; i < kRows * DP; i += kThreads) {
    const int r = i / DP, c = i - r * DP;
    float val = 0.f;
    if (r < n_rows && c < d)
      val = to_float(q[q_base + static_cast<size_t>(t0 + r) * q_stride + c]) *
            scale;
    qs[i] = val;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
  int rlo[kRowsPerWarp], rhi[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    key_range<kVarlen>(t0 + r0 + i, Tq, Tk, q_offset, window, seg, cu,
                       rlo[i], rhi[i]);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int p0 = key_lo; p0 <= key_hi; p0 += kKeys) {
    __syncthreads();                           // previous tile consumed
    for (int i = threadIdx.x; i < kKeys * DP; i += kThreads) {
      const int j = i / DP, c = i - j * DP;
      const int p = p0 + j;
      float kx = 0.f, vx = 0.f;
      if (p <= key_hi && c < d) {
        const size_t off = k_base + static_cast<size_t>(p) * k_stride + c;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
      }
      ks[j * (DP + 1) + c] = kx;
      vs[j * DP + c] = vx;
    }
    __syncthreads();

    // scores of key p0 + lane against the warp's 8 rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* kr = ks + lane * (DP + 1);
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      const float k0 = kr[c], k1 = kr[c + 1], k2 = kr[c + 2], k3 = kr[c + 3];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (r0 + i) * DP + c);
        s[i] = fmaf(qv.x, k0, fmaf(qv.y, k1, fmaf(qv.z, k2, fmaf(qv.w, k3, s[i]))));
      }
    }

    const int p = p0 + lane;
    bool active[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      // warp-uniform: does row i see any key of this tile?
      active[i] = rlo[i] <= rhi[i] && p0 <= rhi[i] && p0 + kKeys - 1 >= rlo[i];
      float pj = 0.f;
      if (active[i]) {
        const bool ok = p >= rlo[i] && p <= rhi[i];
        const float si = ok ? s[i] : kNegInf;
        const float m_new = fmaxf(m[i], warp_max(si));
        pj = ok ? expf(si - m_new) : 0.f;
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(pj);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      }
      ps[(r0 + i) * kKeys + lane] = pj;
    }
    __syncwarp();

    // acc[i][c] += sum_j p[i][j] * v[j][c * 32 + lane]
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float vx[4][kCols];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < kCols; ++c) vx[e][c] = vs[(j + e) * DP + c * 32 + lane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (!active[i]) continue;
        const float4 pv = *reinterpret_cast<const float4*>(ps + (r0 + i) * kKeys + j);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pv.x, vx[0][c], fmaf(pv.y, vx[1][c],
                      fmaf(pv.z, vx[2][c], fmaf(pv.w, vx[3][c], acc[i][c]))));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i;
    if (r >= n_rows) continue;
    T* orow = o + q_base + static_cast<size_t>(t0 + r) * q_stride;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c * 32 + lane;
      if (col < d) store_as(orow + col, acc[i][c] * inv);
    }
  }
}

template <typename T, int DP, bool kVarlen>
int launch(const void* q, const void* k, const void* v, const void* seg,
           const void* cu, void* o, int B, int Hq, int Hkv, int Tq, int Tk,
           int d, int window, int q_offset, int n_seg, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_kernel<T, DP, kVarlen>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kRows - 1) / kRows, Hq, B);
  flash_kernel<T, DP, kVarlen><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg),
      static_cast<const int*>(cu), static_cast<T*>(o), Hq, Hkv, Tq, Tk, d,
      window, q_offset, n_seg, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVarlen>
int launch_any(int dtype, const void* q, const void* k, const void* v,
               const void* seg, const void* cu, void* o, int B, int Hq,
               int Hkv, int Tq, int Tk, int d, int window, int q_offset,
               int n_seg, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || B <= 0 || Tq <= 0 || Tk <= 0 || d <= 0 ||
      d > 128 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_LAUNCH(T, DP)                                            \
  return launch<T, DP, kVarlen>(q, k, v, seg, cu, o, B, Hq, Hkv, Tq, Tk, d, \
                                window, q_offset, n_seg, scale, st)
  if (dtype == kFloat32) {
    if (d <= 32) REPRO_FLASH_LAUNCH(float, 32);
    if (d <= 64) REPRO_FLASH_LAUNCH(float, 64);
    REPRO_FLASH_LAUNCH(float, 128);
  }
  if (dtype == kBFloat16) {
    if (d <= 32) REPRO_FLASH_LAUNCH(__nv_bfloat16, 32);
    if (d <= 64) REPRO_FLASH_LAUNCH(__nv_bfloat16, 64);
    REPRO_FLASH_LAUNCH(__nv_bfloat16, 128);
  }
#undef REPRO_FLASH_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Kernel #9: q, o (B, Hq, Tq, d); k, v (B, Hkv, Tk, d); contiguous in
// `dtype`, d <= 128, Hq % Hkv == 0.  q row i sits at position q_offset + i;
// window 0 = causal only.  Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Hq,
                                     int Hkv, int Tq, int Tk, int d,
                                     int window, int q_offset, float scale,
                                     int dtype, void* stream) {
  return launch_any<false>(dtype, q, k, v, nullptr, nullptr, o, B, Hq, Hkv,
                           Tq, Tk, d, window, q_offset, 0, scale, stream);
}

// Kernel #10: q, o (total, Hq, d); k, v (total, Hkv, d), contiguous in
// `dtype`; seg (total,) int32 segment per token (-1 = padding tail); cu
// (N + 1,) int32 offsets with cu[0] = 0, nondecreasing, cu[N] <= total.
// Every row of o is written (padding rows as zeros).  Returns
// cudaGetLastError().
extern "C" int repro_flash_attention_varlen(const void* q, const void* k,
                                            const void* v, const void* seg,
                                            const void* cu, void* o,
                                            int total, int N, int Hq, int Hkv,
                                            int d, int window, float scale,
                                            int dtype, void* stream) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any<true>(dtype, q, k, v, seg, cu, o, 1, Hq, Hkv, total,
                          total, d, window, 0, N, scale, stream);
}
