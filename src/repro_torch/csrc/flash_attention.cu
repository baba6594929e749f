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
// operations, and the design keeps the CUDA cores fed from registers:
//
//   * tile shape: one block of 128 threads (4 warps) per (b, query head,
//     tile of kRows = 64 query rows), over key tiles of kKeys = 64 in
//     [lo, hi], cut by causality, the window and (varlen) the first row's
//     segment start, so the work per query tile is O(min(q_end, W));
//   * register micro-tiles: thread t owns query rows t/8 + 16a (a < 4)
//     and, in S = q k^T, keys t%8 + 8b (b < 8): a 4 x 8 tile of S, fed per
//     4 columns of d by 4 + 8 16-byte shared loads for 128 FMAs (10.7
//     FMAs per load; the 8 lanes of a row read 8 consecutive key rows, the
//     4 rows of a warp broadcast); in O += P V the same rows and columns
//     4(t%8) + 32h: a 4 x (d/8) tile of O in registers, fed per 4 keys by
//     4 + d/8 16-byte loads of P and V (10.7 FMAs per load at d 64);
//   * the softmax is exact over each row, in two passes over the block's
//     key tiles: pass 1 computes S and the row max over the visible keys;
//     pass 2 computes S again, p = exp(s - max) under the mask, the
//     denominator and O += P V, with no running correction -- the plain
//     version's formula (s = (q.k) scale summed over d in order; o = sum p
//     v, summed over the keys in order, / max(sum p, 1e-30)).  A row's 8
//     lanes are neighbours of one warp, so its max and sum are three
//     shuffles.  Pass 1 costs half the operations again; it buys
//     agreement with the plain version's and the chunked route's rounding
//     of every score, max and p (PERF.md: an online form of this kernel
//     broke an exact fp32 tie of the window model's router the other way
//     from the chunked route);
//   * only the key tiles that cut the causal diagonal, the window edge, a
//     segment start or a ragged edge are masked per element; a tile whose
//     every key every row of the block sees (all 64 rows real, the tile
//     inside [lo of the last row, hi of the first]) takes no test;
//   * q is staged once in fp32 while the first tile's copies fly; the K
//     (pass 1) or K and V (pass 2) tiles arrive by 16-byte cp.async into
//     the second of two buffers while the current tile computes, one
//     pipeline over both passes (plain loads when d or a pointer does not
//     allow 16-byte copies; rows past the block's last key are zeros); K
//     and V stay in the input dtype in shared memory (bf16 is widened as it
//     is loaded);
//   * the grid's slowest dimension is the query tile, walked last tile
//     first: under causality the last tiles see the most keys, so the
//     heaviest blocks start first and the light ones fill the tail.
//
// Shared memory per block: q (64 x (d + 4) floats), two K and two V
// buffers (4 x 64 rows of d + 16 bytes' worth of elements) and p (64 x 72
// floats): at d 64 105,472 bytes in fp32 (2 blocks, 8 warps per SM) and
// 72,704 in bf16 (3 blocks); 187,392 at d 128 fp32 (1 block).  Registers
// (~170 a thread at d 64) do not bind before shared memory does.  The
// products run in fp32 on the CUDA cores: TF32 tensor cores would keep ~3
// decimal digits, and fp32 inputs are held to 2e-5.

#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 128;                  // 4 warps
constexpr int kRows = 64;                      // query rows per block
constexpr int kKeys = 64;                      // keys per tile
constexpr int kRowStep = kThreads / 8;         // a thread's rows: t/8 + 16a
constexpr int kPStride = kKeys + 8;            // row stride of p (floats)

// Row stride (elements) of the staged q, K and V: d padded to DP, plus 16
// bytes, which keeps 16-byte alignment and moves each row 4 banks on.
template <typename T, int DP>
__host__ __device__ constexpr int row_stride() {
  return DP + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * static_cast<size_t>(kRows) * (DP + 4)  // q (fp32)
         + sizeof(T) * static_cast<size_t>(row_stride<T, DP>()) * 4 * kKeys
         + sizeof(float) * static_cast<size_t>(kRows) * kPStride;  // p
}

// Visible key range [lo, hi] of query `t` (hi < lo: none).
template <bool kVarlen>
__device__ __forceinline__ void key_range(int t, int n_q, int Tk, int q_offset,
                                          int window,
                                          const int* __restrict__ seg,
                                          const int* __restrict__ cu,
                                          int n_seg, int& lo, int& hi) {
  lo = 1;
  hi = 0;
  if (t >= n_q) return;
  if constexpr (kVarlen) {
    const int s = seg[t];
    if (s < 0 || s >= n_seg) return;            // padding token
    lo = cu[s];
    hi = t;
  } else {
    lo = 0;
    hi = min(q_offset + t, Tk - 1);             // may be < 0: no key
  }
  if (window > 0) lo = max(lo, (kVarlen ? t : q_offset + t) - window + 1);
}

// Stage rows 0..n-1 of `src` (row stride `stride`) into dst[count][LD],
// columns 0..d-1: 16-byte cp.async copies when `vec` (uncommitted), plain
// loads otherwise; rows n..count-1 are written as zeros.
template <typename T, int DP>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           size_t stride, int n, int count,
                                           int d, bool vec) {
  constexpr int LD = row_stride<T, DP>();
  if (vec) {
    constexpr int kV = 16 / sizeof(T);
    const int cpr = d / kV;
    for (int i = threadIdx.x; i < count * cpr; i += kThreads) {
      const int r = i / cpr;
      const int c = (i - r * cpr) * kV;
      T* s = dst + r * LD + c;
      if (r < n)
        cp_async16(s, src + r * stride + c);
      else
        *reinterpret_cast<uint4*>(s) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < count * d; i += kThreads) {
      const int r = i / d;
      const int c = i - r * d;
      if (r < n)
        dst[r * LD + c] = src[r * stride + c];
      else
        store_as(dst + r * LD + c, 0.f);
    }
  }
}

__device__ __forceinline__ float lane(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

template <typename T, int DP, bool kVarlen>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ seg,
             const int* __restrict__ cu, T* __restrict__ o, int Hq, int Hkv,
             int Tq, int Tk, int d, int window, int q_offset, int n_seg,
             float scale, bool vec) {
  constexpr int LD = row_stride<T, DP>();
  constexpr int LDQ = DP + 4;
  constexpr int kColGroups = DP / 32;          // a thread's columns 4(t%8) + 32h
  extern __shared__ float4 flash_smem[];
  float* qs = reinterpret_cast<float*>(flash_smem);  // [kRows][LDQ], scaled
  T* kbuf = reinterpret_cast<T*>(qs + kRows * LDQ);  // [2][kKeys][LD]
  T* vbuf = kbuf + 2 * kKeys * LD;             // [2][kKeys][LD]
  float* ps = reinterpret_cast<float*>(vbuf + 2 * kKeys * LD);  // [kRows][kPStride]

  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int g = h / (Hq / Hkv);
  const int t0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // last tile first
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

  // The block's key range: the rows' lo and hi are nondecreasing in t, so
  // it runs from the first row's lo to the last real row's hi (a varlen
  // tile may end in padding rows, which lie past cu[n_seg]).  A key tile
  // that starts at or after the last row's lo and ends at or before the
  // first row's hi is visible to every row (when all kRows rows are real).
  const int n_rows = min(kRows, Tq - t0);
  int last = t0 + n_rows - 1;
  if constexpr (kVarlen) last = min(last, cu[n_seg] - 1);
  int key_lo = 0, key_hi = -1, lo_max = 0, hi_min = -1;
  if (last >= t0) {
    int lo0, lo1, hi1;
    key_range<kVarlen>(t0, Tq, Tk, q_offset, window, seg, cu, n_seg, lo0,
                       hi_min);
    key_range<kVarlen>(last, Tq, Tk, q_offset, window, seg, cu, n_seg, lo1,
                       hi1);
    key_lo = max(lo0, 0);
    key_hi = hi1;
    lo_max = lo1;
  }
  const bool rows_full = last == t0 + kRows - 1;
  const int n_tiles = key_hi >= key_lo ? (key_hi - key_lo) / kKeys + 1 : 0;

  // Columns d..DP-1 of every staged K and V row stay zero (the four
  // buffers are one run of 4 kKeys rows); the first K tile's copies start,
  // then q is staged in fp32 (zeros past d and past the last row).
  if (d < DP)
    for (int i = threadIdx.x; i < 4 * kKeys * (DP - d); i += kThreads) {
      const int r = i / (DP - d);
      store_as(kbuf + r * LD + d + (i - r * (DP - d)), 0.f);
    }
  // Step st < n_tiles of the pipeline is pass 1 over key tile st (K only),
  // step n_tiles + i pass 2 over key tile i (K and V); step st's tile sits
  // in buffer st & 1 and the copies of step st + 1 fly while st computes.
  const int n_steps = 2 * n_tiles;
  auto fetch = [&](int st) {
    const int tile = st < n_tiles ? st : st - n_tiles;
    const int p = key_lo + tile * kKeys;
    const int n = min(kKeys, key_hi - p + 1);
    const size_t off = k_base + static_cast<size_t>(p) * k_stride;
    const int nb = (st & 1) * kKeys * LD;
    stage_rows<T, DP>(kbuf + nb, k + off, k_stride, n, kKeys, d, vec);
    if (st >= n_tiles)
      stage_rows<T, DP>(vbuf + nb, v + off, k_stride, n, kKeys, d, vec);
    cp_async_commit();
  };
  if (n_steps > 0) fetch(0);
  for (int i = threadIdx.x; i < kRows * DP; i += kThreads) {
    const int r = i / DP, c = i - r * DP;
    float x = 0.f;
    if (r < n_rows && c < d)
      x = to_float(q[q_base + static_cast<size_t>(t0 + r) * q_stride + c]);
    qs[r * LDQ + c] = x;
  }

  const int kg = threadIdx.x % 8;              // key / column lane of a row
  const int rg = threadIdx.x / 8;              // row group
  float m[4], l[4], acc[4][4 * kColGroups];
  int rlo[4], rhi[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    key_range<kVarlen>(t0 + rg + kRowStep * a, Tq, Tk, q_offset, window, seg,
                       cu, n_seg, rlo[a], rhi[a]);
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kColGroups; ++c) acc[a][c] = 0.f;
  }

  for (int st = 0; st < n_steps; ++st) {
    const bool pass1 = st < n_tiles;
    const int p0 = key_lo + (pass1 ? st : st - n_tiles) * kKeys;
    cp_async_wait_all();
    __syncthreads();                           // step st landed; st-1 consumed
    if (st + 1 < n_steps) fetch(st + 1);
    const T* kt = kbuf + (st & 1) * kKeys * LD;
    const T* vt = vbuf + (st & 1) * kKeys * LD;

    // S = q k^T: rows rg + 16a, keys kg + 8b, each a sum over d in order
    float s[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[a][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; c += 4) {
      float4 qa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = ld4(qs + (rg + kRowStep * a) * LDQ + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kb = ld4(kt + (kg + 8 * j) * LD + c);
#pragma unroll
        for (int a = 0; a < 4; ++a) s[a][j] = dot4(qa[a], kb, s[a][j]);
      }
    }

    // scale and mask; per element only off the fully visible tiles
    const bool full = rows_full && p0 >= lo_max && p0 + kKeys - 1 <= hi_min;
    unsigned ok[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      ok[a] = 0xffu;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!full) {
          const int p = p0 + kg + 8 * j;
          if (p < rlo[a] || p > rhi[a]) ok[a] &= ~(1u << j);
        }
        s[a][j] = (ok[a] >> j & 1u) ? s[a][j] * scale : kNegInf;
      }
    }
    if (pass1) {                               // the row max
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float mx = m[a];
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, s[a][j]);
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
        m[a] = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 4));
      }
      continue;
    }

    // pass 2: p = exp(s - m) under the mask, the denominator, and O += P V
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float sum = 0.f;
      float* prow = ps + (rg + kRowStep * a) * kPStride + kg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = (ok[a] >> j & 1u) ? expf(s[a][j] - m[a]) : 0.f;
        sum += pj;
        prow[8 * j] = pj;
      }
      sum += __shfl_xor_sync(kFullMask, sum, 1);
      sum += __shfl_xor_sync(kFullMask, sum, 2);
      l[a] += sum + __shfl_xor_sync(kFullMask, sum, 4);
    }
    __syncthreads();                           // p complete

    // rows rg + 16a, columns 4 kg + 32 h; each a sum over the keys in order
#pragma unroll 4
    for (int j = 0; j < kKeys; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = ld4(ps + (rg + kRowStep * a) * kPStride + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const T* vr = vt + (j + e) * LD + 4 * kg;
#pragma unroll
        for (int hg = 0; hg < kColGroups; ++hg) {
          const float4 vv = ld4(vr + 32 * hg);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float pe = lane(pa[a], e);
            float* ac = acc[a] + 4 * hg;
            ac[0] = fmaf(pe, vv.x, ac[0]);
            ac[1] = fmaf(pe, vv.y, ac[1]);
            ac[2] = fmaf(pe, vv.z, ac[2]);
            ac[3] = fmaf(pe, vv.w, ac[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = rg + kRowStep * a;
    if (r >= n_rows) continue;
    T* orow = o + q_base + static_cast<size_t>(t0 + r) * q_stride;
    const float den = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int hg = 0; hg < kColGroups; ++hg) {
      const int col = 4 * kg + 32 * hg;
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[a][4 * hg + e] / den;
      if (vec && col + 4 <= d) {
        st4(orow + col, out);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) store_as(orow + col + e, out[e]);
      }
    }
  }
}

template <typename T, int DP, bool kVarlen>
int launch(const void* q, const void* k, const void* v, const void* seg,
           const void* cu, void* o, int B, int Hq, int Hkv, int Tq, int Tk,
           int d, int window, int q_offset, int n_seg, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DP>();
  const int n_tiles = (Tq + kRows - 1) / kRows;
  if (n_tiles > 65535 || static_cast<long long>(B) * Hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % (16 / sizeof(T)) == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v) && aligned16(o);
  auto* kernel = flash_kernel<T, DP, kVarlen>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, n_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg),
      static_cast<const int*>(cu), static_cast<T*>(o), Hq, Hkv, Tq, Tk, d,
      window, q_offset, n_seg, scale, vec);
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
// `dtype`; seg (total,) int32 segment per token (-1 or N and above =
// padding tail); cu
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
