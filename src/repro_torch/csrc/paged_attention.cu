// Paged-attention decode, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` (src/repro/serve/paged_attention.py:87,
// launched by `paged_attention_kernel`, :141).  One query token per batch
// row attends every cached position `< length` of that row; keys and values
// live in a pool of blocks (N, bs, Hkv, d) addressed through the row's block
// table (negative ids are clamped to block 0, as the TPU kernel does; their
// positions are at or past `length` and are masked).  GQA: query head h
// reads KV head h / (Hq / Hkv).  Softmax statistics are fp32.
//
// What bounds it on an H100: each cached key and value element is used by
// R = Hq/Hkv queries only (R = 1 on the slice), so the kernel is bound by
// device-memory bytes -- the K and V of every valid position, read once.
// The design keeps many independent 16-byte loads in flight: one thread
// block per (row, KV head) with 8 warps; a warp takes 32 consecutive
// positions at a time, lane j loads the whole key and value row of position
// j with 16-byte vector loads (each row is d contiguous elements of the
// pool), scores it against the R queries held in shared memory, and passes
// its value row through shared memory so each lane can accumulate the
// output columns it owns.  Each warp keeps its own running max, denominator
// and accumulator; the 8 partial softmaxes are merged once at the end.
// With only B*Hkv thread blocks (32 on the slice) the card is not full;
// splitting one row's positions over several blocks (flash decoding), and
// cp.async/TMA staging, are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;   // positions per warp step (one per lane)
constexpr int kMaxR = 8;    // query heads per KV head

template <int D>
size_t smem_bytes(int R) {
  const size_t tile = kWarps * (static_cast<size_t>(kTile) * (D + 1)  // v rows
                                + kMaxR * kTile);                     // p
  const size_t merge = kWarps * static_cast<size_t>(R) * (D + 2);
  return sizeof(float) * (static_cast<size_t>(R) * D + (tile > merge ? tile : merge));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ block_table,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    int Hkv, int R, int bs, int nb, float scale) {
  using V = Vec16<T>;
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                      // [R][D], pre-scaled
  float* work = qs + R * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* vs = work + warp * (kTile * (D + 1) + kMaxR * kTile);  // [kTile][D+1]
  float* pw = vs + kTile * (D + 1);                              // [kMaxR][kTile]

  const int b = blockIdx.x / Hkv;
  const int g = blockIdx.x % Hkv;
  const int Hq = Hkv * R;
  const int len = min(lengths[b], nb * bs);

  const T* qb = q + (static_cast<size_t>(b) * Hq + g * R) * D;
  for (int i = threadIdx.x; i < R * D; i += kThreads) qs[i] = to_float(qb[i]) * scale;
  __syncthreads();

  float m[kMaxR], l[kMaxR], acc[kMaxR][kCols];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[r][t] = 0.f;
  }

  const int n_tiles = (len + kTile - 1) / kTile;
  for (int tile = warp; tile < n_tiles; tile += kWarps) {
    const int p0 = tile * kTile;
    const int nk = min(kTile, len - p0);
    const bool valid = lane < nk;
    float s[kMaxR];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) s[r] = 0.f;
    if (valid) {
      const int pos = p0 + lane;
      const int blk = max(block_table[static_cast<size_t>(b) * nb + pos / bs], 0);
      const size_t row = ((static_cast<size_t>(blk) * bs + pos % bs) * Hkv + g) * D;
      const T* kr = k_pool + row;
      const T* vr = v_pool + row;
      float* vrow = vs + lane * (D + 1);
#pragma unroll
      for (int c = 0; c < D; c += V::kN) {
        float kx[V::kN], vx[V::kN];
        V::load(kr + c, kx);
        V::load(vr + c, vx);
#pragma unroll
        for (int e = 0; e < V::kN; ++e) vrow[c + e] = vx[e];
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r < R) {
#pragma unroll
            for (int e = 0; e < V::kN; ++e) s[r] = fmaf(qs[r * D + c + e], kx[e], s[r]);
          }
        }
      }
    }
    float corr[kMaxR];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r < R) {
        const float sr = valid ? s[r] : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sr));
        const float p = valid ? expf(sr - m_new) : 0.f;
        corr[r] = expf(m[r] - m_new);
        l[r] = l[r] * corr[r] + warp_sum(p);
        m[r] = m_new;
        pw[r * kTile + lane] = p;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r < R) {
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int c = t * 32 + lane;
          if (c < D) {
            float a = acc[r][t] * corr[r];
            for (int j = 0; j < nk; ++j) a = fmaf(pw[r * kTile + j], vs[j * (D + 1) + c], a);
            acc[r][t] = a;
          }
        }
      }
    }
    __syncwarp();  // vs and pw are rewritten by this warp's next tile
  }

  // Merge the warps' partial softmaxes: work = [kWarps][R][D + 2]
  // (accumulator, then max and denominator).
  __syncthreads();
  float* mine = work + warp * R * (D + 2);
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r < R) {
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const int c = t * 32 + lane;
        if (c < D) mine[r * (D + 2) + c] = acc[r][t];
      }
      if (lane == 0) {
        mine[r * (D + 2) + D] = m[r];
        mine[r * (D + 2) + D + 1] = l[r];
      }
    }
  }
  __syncthreads();
  T* ob = o + (static_cast<size_t>(b) * Hq + g * R) * D;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, work[(w * R + r) * (D + 2) + D]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* part = work + (w * R + r) * (D + 2);
      const float f = expf(part[D] - mx);
      den = fmaf(part[D + 1], f, den);
      num = fmaf(part[c], f, num);
    }
    store_as(ob + i, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_table, const void* lengths, void* o, int B,
           int Hkv, int R, int bs, int nb, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(R);
  cudaError_t err = allow_smem(paged_decode_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<T, D><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(lengths), static_cast<T*>(o), Hkv, R, bs, nb,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k_pool, const void* v_pool,
             const void* block_table, const void* lengths, void* o, int B,
             int Hkv, int R, int d, int bs, int nb, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k_pool, v_pool, block_table, lengths, o, B, Hkv, R, bs, nb, scale, stream);
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, block_table, lengths, o, B, Hkv, R, bs, nb, scale, stream);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, block_table, lengths, o, B, Hkv, R, bs, nb, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (B, Hq, d); k_pool, v_pool: (N, bs, Hkv, d), all contiguous in
// `dtype`; block_table: (B, nb) int32; lengths: (B,) int32.  d is 32, 64 or
// 128 and Hq / Hkv <= 8.  Returns cudaGetLastError().
extern "C" int repro_paged_attention_decode(const void* q, const void* k_pool,
                                            const void* v_pool,
                                            const void* block_table,
                                            const void* lengths, void* o,
                                            int B, int Hq, int Hkv, int d,
                                            int bs, int nb, float scale,
                                            int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = Hq / Hkv;
  if (dtype == repro::kFloat32)
    return launch_d<float>(q, k_pool, v_pool, block_table, lengths, o, B, Hkv, R, d, bs, nb, scale, st);
  if (dtype == repro::kBFloat16)
    return launch_d<__nv_bfloat16>(q, k_pool, v_pool, block_table, lengths, o, B, Hkv, R, d, bs, nb, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
