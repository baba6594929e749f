// Packed chunked prefill over paged KV, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_prefill_kernel`
// (src/repro/serve/paged_attention.py:260, launched by
// `paged_prefill_attention_kernel`, :317).  A chunk packs the next tokens
// of N segments back to back: segment n holds tokens [cu[n], cu[n+1]) of
// batch row rows[n], whose cache already held past_lens[n] tokens.  Query
// token t of segment n sits at position pos = past_lens[n] + (t - cu[n]) of
// its row and attends every key of that row at a position <= pos; keys and
// values live in a pool of blocks (N_pool, bs, Hkv, d) addressed through
// the row's block table (a -1 entry is clamped to block 0, as in the decode
// kernel; only a position past the row's length can land there).  The
// chunk's own K/V are already in the pool, so causality inside the chunk
// comes from the positions alone.  GQA: query head h reads KV head
// h / (Hq / Hkv).  Softmax statistics are fp32; masked scores are -1e30
// with p zeroed, and the denominator is floored at 1e-30.
//
// The TPU wrapper unfolds the packed stream into one right-padded (N, C)
// row per segment and pads d to 128 lanes, computing N times the queries.
// This kernel reads the packed stream through cu_seqlens directly.
//
// What bounds it on an H100: bytes are q, the output, and each active
// segment's visible K/V read once (at the slice's chunk, 256 tokens in 4
// segments with pasts up to 960, d 64, fp32: ~4.6 MB, ~1.4 us at 3.35
// TB/s); operations are 4*d per valid (query, key) pair and query head
// (~0.12 GFLOP there, ~1.8 us at 67 TFLOP/s fp32 outside the tensor
// cores), so the bound is the operations, and both are small.  The design
// is simple and right first: one thread block per (segment, query tile,
// KV head) holds kRows = 32 query rows (the R = Hq/Hkv heads of its KV
// head for 32/R tokens), so every K/V tile it stages in shared memory
// serves all of them; it walks the row's positions in tiles of 32 up to
// its deepest query, each warp carrying the running max, denominator and
// accumulator of its own 4 query rows.  A score is one lane per key (the
// padded stride d+1 puts 32 lanes on 32 banks), the output one lane per
// column.  The grid is sized from static shapes (N, ceil(total / tile),
// Hkv) with no host sync: each block reads cu_seqlens, rows and past_lens
// itself, and a block past its segment's end, or of an inactive segment
// (row -1), exits at once; the wrapper zero-fills the output, so padding
// tokens and inactive segments come back as exact zeros.  No cp.async or
// tensor cores yet: the products run on the CUDA cores in fp32, and a
// key tile is only reused by the 32 rows of one block.

#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32;                  // query rows per block
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kKeys = 32;                  // key positions per tile
constexpr int kMaxR = 8;                   // query heads per KV head

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kRows) * D      // q rows
                          + 2 * static_cast<size_t>(kKeys) * (D + 1));  // K, V
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool,
                     const int* __restrict__ block_table,
                     const int* __restrict__ cu, const int* __restrict__ rows,
                     const int* __restrict__ past_lens, T* __restrict__ o,
                     int Hkv, int R, int bs, int nb, float scale) {
  using V = Vec16<T>;
  constexpr int kCols = D / 32;           // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                        // [kRows][D], pre-scaled
  float* ks = qs + kRows * D;              // [kKeys][D + 1]
  float* vs = ks + kKeys * (D + 1);        // [kKeys][D + 1]

  const int n = blockIdx.x;
  const int g = blockIdx.z;
  const int row = rows[n];
  const int seg0 = cu[n];
  const int seg_len = cu[n + 1] - seg0;
  const int tq = kRows / R;                // tokens per block
  const int tok0 = blockIdx.y * tq;        // first token of the tile, local
  if (row < 0 || tok0 >= seg_len) return;  // whole block: no barrier yet
  const int n_tok = min(tq, seg_len - tok0);
  const int past = past_lens[n];
  const int Hq = Hkv * R;
  const int S = nb * bs;                   // keys a row can hold
  // deepest query position of the tile, and the last key it can see
  const int key_lim = min(past + tok0 + n_tok - 1, S - 1);
  const int* table = block_table + static_cast<size_t>(row) * nb;

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int ri = i / D, c = i - ri * D;
    const int ti = ri / R, r = ri - ti * R;
    float val = 0.f;
    if (ti < n_tok) {
      const size_t t = static_cast<size_t>(seg0 + tok0 + ti);
      val = to_float(q[(t * Hq + g * R + r) * D + c]) * scale;
    }
    qs[i] = val;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int ri = warp * kRowsPerWarp + i;
    const int ti = ri / R;
    // -1 marks a row of this warp that holds no query
    qpos[i] = (ri < tq * R && ti < n_tok) ? past + tok0 + ti : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  constexpr int kVecs = D / V::kN;         // 16-byte vectors per key row
  const int n_tiles = key_lim / kKeys + 1;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int p0 = tile * kKeys;
    __syncthreads();                       // previous tile fully consumed
    for (int i = threadIdx.x; i < kKeys * kVecs; i += kThreads) {
      const int j = i / kVecs, c = (i - j * kVecs) * V::kN;
      const int p = p0 + j;
      float kx[V::kN], vx[V::kN];
      if (p <= key_lim) {
        const int blk = max(table[p / bs], 0);
        const size_t off = ((static_cast<size_t>(blk) * bs + p % bs) * Hkv + g) * D + c;
        V::load(k_pool + off, kx);
        V::load(v_pool + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < V::kN; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V::kN; ++e) {
        ks[j * (D + 1) + c + e] = kx[e];
        vs[j * (D + 1) + c + e] = vx[e];
      }
    }
    __syncthreads();

    const int p = p0 + lane;               // this lane's key
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (qpos[i] < p0) continue;          // no key of the tile visible
      const float* qr = qs + (warp * kRowsPerWarp + i) * D;
      const bool ok = p <= qpos[i] && p <= key_lim;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(qr[c], ks[lane * (D + 1) + c], s);
      s = ok ? s : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float pj = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(pj);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      for (int j = 0; j < kKeys; ++j) {
        const float pb = __shfl_sync(kFullMask, pj, j);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pb, vs[j * (D + 1) + c * 32 + lane], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (qpos[i] < 0) continue;
    const int ri = warp * kRowsPerWarp + i;
    const int ti = ri / R, r = ri - ti * R;
    const size_t t = static_cast<size_t>(seg0 + tok0 + ti);
    T* orow = o + (t * Hq + g * R + r) * D;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) store_as(orow + c * 32 + lane, acc[i][c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_table, const void* cu, const void* rows,
           const void* past_lens, void* o, int total, int N, int Hkv, int R,
           int bs, int nb, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = allow_smem(paged_prefill_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tq = kRows / R;
  const dim3 grid(N, (total + tq - 1) / tq, Hkv);
  paged_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(cu), static_cast<const int*>(rows),
      static_cast<const int*>(past_lens), static_cast<T*>(o), Hkv, R, bs, nb,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k_pool, const void* v_pool,
             const void* block_table, const void* cu, const void* rows,
             const void* past_lens, void* o, int total, int N, int Hkv, int R,
             int d, int bs, int nb, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k_pool, v_pool, block_table, cu, rows, past_lens, o, total, N, Hkv, R, bs, nb, scale, stream);
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, block_table, cu, rows, past_lens, o, total, N, Hkv, R, bs, nb, scale, stream);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, block_table, cu, rows, past_lens, o, total, N, Hkv, R, bs, nb, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (total, Hq, d) packed, o zero-filled by the caller; k_pool, v_pool:
// (N_pool, bs, Hkv, d), all contiguous in `dtype`; block_table: (B, nb)
// int32; cu: (N + 1,) int32 nondecreasing with cu[N] <= total; rows,
// past_lens: (N,) int32 (rows[n] = -1: inactive segment).  d is 32, 64 or
// 128 and Hq / Hkv <= 8.  Returns cudaGetLastError().
extern "C" int repro_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* cu, const void* rows,
    const void* past_lens, void* o, int total, int N, int Hq, int Hkv, int d,
    int bs, int nb, float scale, int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxR || N <= 0 || total <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = Hq / Hkv;
  if (dtype == repro::kFloat32)
    return launch_d<float>(q, k_pool, v_pool, block_table, cu, rows, past_lens, o, total, N, Hkv, R, d, bs, nb, scale, st);
  if (dtype == repro::kBFloat16)
    return launch_d<__nv_bfloat16>(q, k_pool, v_pool, block_table, cu, rows, past_lens, o, total, N, Hkv, R, d, bs, nb, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
