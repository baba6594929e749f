// Packed chunked prefill over paged KV, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_prefill_kernel`
// (src/repro/serve/paged_attention.py:260, launched by
// `paged_prefill_attention_kernel` at :355).  A chunk packs the next
// tokens of N segments back to back: segment n holds tokens [cu[n],
// cu[n+1]) of batch row rows[n], whose cache already held past_lens[n]
// tokens.  Query token t of segment n sits at position pos = past_lens[n]
// + (t - cu[n]) of its row and attends every key of that row at a position
// <= pos; keys and values live in a pool of blocks (N_pool, bs, Hkv, d)
// addressed through the row's block table (a -1 entry is clamped to block
// 0; only a position past the row's length can land there).  The chunk's
// own K/V are already in the pool, so causality inside the chunk comes
// from the positions alone.  GQA: query head h reads KV head h / (Hq /
// Hkv).  Softmax statistics are fp32; masked scores are -1e30 with p
// zeroed, and the denominator is floored at 1e-30.  The TPU wrapper
// unfolds the stream into one right-padded row per segment; this kernel
// reads the packed stream through cu_seqlens directly.
//
// What bounds it on an H100: at the serving slice's chunk (256 tokens in
// 4 segments of 64 at pasts 0, 256, 512, 960; Hq = Hkv = 4, d 64, bs 16,
// fp32) the operations are 4*d per valid (query, key) pair and query head,
// 0.122 GFLOP or ~1.8 us at 67 TFLOP/s fp32 outside the tensor cores; the
// bytes (q, the output, each segment's visible K/V read once) are ~4.6 MB
// or ~1.4 us at 3.35 TB/s.  Both are tiny: what sets the time is how many
// SMs work and how long the deepest query's walk over its keys is.
//
// Design.  One block per (query tile, key split, KV head):
//   * A query tile is kRows = 32 rows: the R = Hq/Hkv query heads of one
//     KV head for 32/R tokens of one segment, so every K/V tile staged in
//     shared memory serves all of them.  blockIdx.x counts the tiles of the
//     active segments in order (at most ceil(total / tq) + N - 1 of them,
//     tq = 32/R); a block finds its segment with one warp-parallel prefix
//     scan over cu_seqlens (32 segments per round of loads).
//   * The key axis is cut into splits of kSplitKeys = 128 positions;
//     blockIdx.y is the split.  The grid, (ceil(total/tq) + N - 1,
//     ceil(nb*bs / 128), Hkv), comes from static shapes, with no host
//     sync.  A block whose split starts past its tile's deepest query, or
//     whose tile index lies past the active segments' tiles, exits at once.
//     At the slice's chunk 136 blocks work (of 396 in the grid), for 132
//     SMs, and none walks more than 128 keys; without splits 32 blocks
//     would work, the deepest walking 1024 keys.
//   * A split is two key tiles of kKeys = 64 positions, double buffered:
//     the block-table entries of the split are staged once, and the second
//     tile's K and V rows (one row of one KV head is d contiguous elements)
//     are copied with 16-byte cp.async through the table while the first
//     computes.
//   * Both products are register-tiled on the CUDA cores in fp32 (TF32
//     would lose the fp32 tolerance).  The 256 threads are two halves of 4
//     warps; each half takes 32 of every tile's 64 keys with its own
//     running max, denominator and accumulator, and the halves combine
//     through shared memory at the end, so each SM scheduler has two warps
//     where one half alone would leave it one.  Thread t of a half owns
//     rows 4*(t/16) .. +3 and, for S = q k^T, its half's keys t%16 and
//     t%16 + 16 (4 x 2 scores from 16-byte shared loads of q and K); for
//     O += P V, the same 4 rows and d/16 columns.  Row max and row sum go
//     by shuffles among the 16 threads that share a row; P passes through
//     shared memory, transposed, so one 16-byte load gives a thread its 4
//     rows.  bf16 is widened to fp32 at the shared loads.  Only key
//     half-tiles that cross the tile's diagonal (or the split's end) are
//     masked; half-tiles past the split's end are skipped.
//   * Merge.  A tile whose keys fit one split writes its output directly.
//     Otherwise each split writes its partial (m, l, acc), fp32, to a
//     workspace (total, Hq, splits, d + 2) that the caller allocates, and a
//     second launch from the same C entry merges the splits of each token
//     in split order (exp(m_s - max m) weights; a split whose keys are all
//     masked for a row has m = -1e30, l = 0 and weighs 0): no atomics, so
//     two launches give the same bits.  The merge launch also writes the
//     zeros of padding tokens (t >= cu[N]) and inactive segments (row -1),
//     so the caller need not zero-fill the output.
//   * Pointers must be 16-byte aligned (the entry refuses others) and d is
//     32, 64 or 128, so every row is copied by 16-byte cp.async: there is
//     no plain-load path.
//
// What bounds the design (chip_smoke [4], NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md section 6, row #12): at the slice the two launches take ~0.028
// ms with a cold L2, the split kernel ~0.017 ms of it and the merge
// ~0.004 ms.  The products, not the bytes, hold it: per FMA a thread
// reads 3 bytes of q and K from shared memory in S and 2 bytes of P and V
// in P V, while an SM's shared memory serves 128 bytes per cycle to 128
// FMA lanes, so counted per thread both products wait on shared memory;
// larger register tiles, or tensor cores at an fp32-exact precision, are
// the next step.

#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;             // two halves of 4 warps
constexpr int kHalf = 128;                 // threads of one half
constexpr int kRows = 32;                  // query rows per block
constexpr int kSplitKeys = 128;            // key positions per split
constexpr int kKeys = 64;                  // key positions per staged tile
constexpr int kHalfKeys = kKeys / 2;       // of them, each half's
constexpr int kMaxR = 8;                   // query heads per KV head
constexpr int kTableSlots = kSplitKeys + 4;  // table entries one split reads
constexpr int kMergeWarps = 4;             // (token, head) rows per merge block

static_assert(kSplitKeys % kKeys == 0, "a split is whole key tiles");
static_assert(kHalf == 16 * (kRows / 4) && kHalfKeys == 32,
              "thread t of a half owns rows 4*(t/16).. and keys t%16, "
              "t%16 + 16 of the half's keys");

// Shared-memory layout for one (dtype, d): q [kRows][kStride], K and V
// [2][kKeys][kStride] (dtype T, rows padded by 16 bytes so that 8
// consecutive rows fall on 8 distinct 16-byte bank groups), P^T
// [2 halves][kHalfKeys][kPStride] (fp32), the split's table entries.
// After the key loop the K buffers hold the second half's (m, l, acc)
// [kRows][D + 2] (fp32) for the first half to combine.
template <typename T, int D>
struct Layout {
  static constexpr int kStride = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int kPStride = kRows + 4;
  static constexpr size_t kQ = sizeof(T) * kRows * kStride;
  static constexpr size_t kKV = sizeof(T) * kKeys * kStride;
  static constexpr size_t kP = sizeof(float) * 2 * kHalfKeys * kPStride;
  static constexpr size_t kBytes = kQ + 4 * kKV + kP + sizeof(int) * kTableSlots;
  static_assert(sizeof(float) * kRows * (D + 2) <= 2 * kKV,
                "the combine fits the K buffers");
};

// Two consecutive shared-memory elements widened to float, and two
// consecutive outputs in one store (the column pairs of d = 32).
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, const float* x) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, const float* x) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
}

// kW consecutive elements at p, widened to float (kW = 2 or 4).
template <int kW, typename T>
__device__ __forceinline__ void load_cols(const T* p, float* out) {
  if constexpr (kW == 4) {
    const float4 x = ld4(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    const float2 x = ld2(p);
    out[0] = x.x; out[1] = x.y;
  }
}

template <int kW, typename T>
__device__ __forceinline__ void store_cols(T* p, const float* x) {
  if constexpr (kW == 4) {
    st4(p, x);
  } else {
    st2(p, x);
  }
}

// Max and sum over the 16 lanes of a half warp (the threads of one row).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// One segment of the chunk: its first token, length, past and batch row.
struct Segment {
  int seg0, len, past, row;
};

// The segment of this block's query tile: lane i of every warp reads
// segment s0 + i, so one round of loads serves 32 segments.  `tile` is the
// index among the tiles of the active segments (tq tokens each) on entry
// and the tile within the segment on return.  Returns false when the index
// lies past every active segment's tiles.  Uniform across the block.
__device__ __forceinline__ bool find_tile(const int* __restrict__ cu,
                                          const int* __restrict__ rows,
                                          const int* __restrict__ past_lens,
                                          int N, int tq, int& tile,
                                          Segment& sg) {
  const int lane = threadIdx.x % 32;
  for (int s0 = 0; s0 < N; s0 += 32) {
    const int i = s0 + lane;
    int nt = 0, c0 = 0, len = 0, past = 0, row = -1;
    if (i < N) {
      c0 = cu[i];
      len = cu[i + 1] - c0;
      row = rows[i];
      past = past_lens[i];
      nt = row < 0 ? 0 : (len + tq - 1) / tq;
    }
    int incl = nt;                         // inclusive prefix of the tiles
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned hit = __ballot_sync(kFullMask, incl > tile);
    if (hit) {
      const int src = __ffs(hit) - 1;
      tile -= __shfl_sync(kFullMask, incl - nt, src);
      sg.seg0 = __shfl_sync(kFullMask, c0, src);
      sg.len = __shfl_sync(kFullMask, len, src);
      sg.past = __shfl_sync(kFullMask, past, src);
      sg.row = __shfl_sync(kFullMask, row, src);
      return true;
    }
    tile -= __shfl_sync(kFullMask, incl, 31);
  }
  return false;
}

// The deepest key position the tile `tile` (of tq tokens) of a segment with
// `len` tokens at past `past` can see, in a row of S positions.
__device__ __forceinline__ int tile_key_lim(int past, int len, int tile,
                                            int tq, int S) {
  const int n_tok = min(tq, len - tile * tq);
  return min(past + tile * tq + n_tok - 1, S - 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_split_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pool,
                           const T* __restrict__ v_pool,
                           const int* __restrict__ block_table,
                           const int* __restrict__ cu,
                           const int* __restrict__ rows,
                           const int* __restrict__ past_lens,
                           T* __restrict__ o, float* __restrict__ ws, int N,
                           int Hkv, int R, int bs, int nb, int splits,
                           float scale) {
  using L = Layout<T, D>;
  constexpr int QS = L::kStride;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per cp.async
  constexpr int kCpr = D / kVec;           // 16-byte copies per row
  constexpr int kCW = D >= 64 ? 4 : 2;     // output columns per group
  constexpr int kCG = D / (16 * kCW);      // column groups per thread
  extern __shared__ float4 prefill_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(prefill_smem);
  T* qs = reinterpret_cast<T*>(base);
  T* kbuf = reinterpret_cast<T*>(base + L::kQ);
  T* vbuf = reinterpret_cast<T*>(base + L::kQ + 2 * L::kKV);
  float* pt = reinterpret_cast<float*>(base + L::kQ + 4 * L::kKV);
  int* tbl = reinterpret_cast<int*>(base + L::kQ + 4 * L::kKV + L::kP);

  // This block's (segment, query tile): blockIdx.x counts the tiles of the
  // active segments in order.
  const int tq = kRows / R;                // tokens per tile
  int tile = blockIdx.x;
  Segment sg;
  if (!find_tile(cu, rows, past_lens, N, tq, tile, sg))
    return;                                // whole block: no barrier yet
  const int seg0 = sg.seg0, len = sg.len, past = sg.past;
  const int S = nb * bs;
  const int key_lim = tile_key_lim(past, len, tile, tq, S);
  const int k0 = blockIdx.y * kSplitKeys;  // first key of the split
  if (k0 > key_lim) return;
  const int k_end = min(k0 + kSplitKeys - 1, key_lim);
  const bool direct = key_lim < kSplitKeys;  // the tile has one split
  const int g = blockIdx.z;
  const int Hq = Hkv * R;
  const int tok0 = tile * tq;
  const int n_tok = min(tq, len - tok0);
  const int* table = block_table + static_cast<size_t>(sg.row) * nb;

  // q rows of the tile (zeros past its tokens), not pre-scaled; their
  // copies fly while the table entries load.
  for (int i = threadIdx.x; i < kRows * kCpr; i += kThreads) {
    const int ri = i / kCpr, c = (i - ri * kCpr) * kVec;
    const int ti = ri / R;
    T* dst = qs + ri * QS + c;
    if (ri < tq * R && ti < n_tok) {
      const size_t t = static_cast<size_t>(seg0 + tok0 + ti);
      cp_async16(dst, q + (t * Hq + g * R + (ri - ti * R)) * D + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  // The split's table entries, clamped, once.
  const int b0 = k0 / bs;
  for (int i = threadIdx.x; i <= k_end / bs - b0; i += kThreads)
    tbl[i] = max(table[b0 + i], 0);
  __syncthreads();                         // tbl visible

  // Start the copies of key tile `it` into buffer `buf` (keys past the
  // split's end are zeros: a masked key's p is 0 and 0 * V must be 0).
  auto fetch = [&](int it, int buf) {
    const int p0 = k0 + it * kKeys;
    T* kd = kbuf + buf * kKeys * QS;
    T* vd = vbuf + buf * kKeys * QS;
    for (int i = threadIdx.x; i < kKeys * kCpr; i += kThreads) {
      const int j = i / kCpr, c = (i - j * kCpr) * kVec;
      const int p = p0 + j;
      if (p <= k_end) {
        const size_t off =
            ((static_cast<size_t>(tbl[p / bs - b0]) * bs + p % bs) * Hkv + g) *
                D + c;
        cp_async16(kd + j * QS + c, k_pool + off);
        cp_async16(vd + j * QS + c, v_pool + off);
      } else {
        *reinterpret_cast<uint4*>(kd + j * QS + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd + j * QS + c) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  // Each half runs the online softmax over its 32 keys of every tile, with
  // its own (m, l, acc); the halves combine after the loop.
  const int half = threadIdx.x / kHalf;
  const int rg = threadIdx.x % kHalf / 16;  // rows 4*rg .. 4*rg + 3
  const int kq = threadIdx.x % 16;         // keys kq, kq + 16; column groups
  int qpos[4];
  float m[4], l[4], acc[4][kCG * kCW];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int ri = 4 * rg + a;
    const int ti = ri / R;
    // -1 marks a row that holds no query: every key is masked for it
    qpos[a] = (ri < tq * R && ti < n_tok) ? past + tok0 + ti : -1;
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kCG * kCW; ++c) acc[a][c] = 0.f;
  }
  // keys at or below both need no mask for any query row of the tile
  const int unmasked_lim = min(past + tok0, k_end);
  float* pth = pt + half * kHalfKeys * L::kPStride;  // this half's P^T

  const int n_tiles = (k_end - k0) / kKeys + 1;
  fetch(0, 0);
  cp_async_commit();                       // group 0: q and key tile 0
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      fetch(it + 1, buf ^ 1);              // its buffer was freed last tile
      cp_async_commit();
      cp_async_wait<1>();                  // tile `it` has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int p0 = k0 + it * kKeys + half * kHalfKeys;  // this half's keys
    const T* kt = kbuf + (buf * kKeys + half * kHalfKeys) * QS;
    const T* vt = vbuf + (buf * kKeys + half * kHalfKeys) * QS;
    const bool live = p0 <= k_end;         // warp-uniform

    if (live) {
      // S = q k^T: 4 rows x 2 keys per thread.
      float s[4][2] = {};
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        float4 qa[4], kb[2];
#pragma unroll
        for (int a = 0; a < 4; ++a) qa[a] = ld4(qs + (4 * rg + a) * QS + c);
#pragma unroll
        for (int j = 0; j < 2; ++j) kb[j] = ld4(kt + (kq + 16 * j) * QS + c);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 2; ++j) s[a][j] = dot4(qa[a], kb[j], s[a][j]);
      }

      // Online softmax, rows shared by the 16 lanes of a half warp.
      const bool masked = p0 + kHalfKeys - 1 > unmasked_lim;
      float p[4][2];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        bool ok[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int pos = p0 + kq + 16 * j;
          ok[j] = !masked || (pos <= qpos[a] && pos <= k_end);
          s[a][j] = ok[j] ? s[a][j] * scale : kNegInf;
        }
        const float m_new = fmaxf(m[a], row_max(fmaxf(s[a][0], s[a][1])));
        const float corr = expf(m[a] - m_new);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          p[a][j] = ok[j] ? expf(s[a][j] - m_new) : 0.f;
        l[a] = l[a] * corr + (p[a][0] + p[a][1]);
        m[a] = m_new;
#pragma unroll
        for (int c = 0; c < kCG * kCW; ++c) acc[a][c] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<float4*>(pth + (kq + 16 * j) * L::kPStride + 4 * rg) =
            make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    }
    __syncthreads();

    if (live) {
      // O += P V: 4 rows x kCG groups of kCW columns per thread.
#pragma unroll 4
      for (int j = 0; j < kHalfKeys; ++j) {
        const float4 p4 = *reinterpret_cast<const float4*>(
            pth + j * L::kPStride + 4 * rg);
        const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int cg = 0; cg < kCG; ++cg) {
          float vv[kCW];
          load_cols<kCW>(vt + j * QS + (cg * 16 + kq) * kCW, vv);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < kCW; ++e)
              acc[a][cg * kCW + e] = fmaf(pa[a], vv[e], acc[a][cg * kCW + e]);
        }
      }
    }
    __syncthreads();                       // K, V and P^T free again
  }

  // Combine the halves: the second hands its (m, l, acc) over through the
  // K buffers; the first, which owns the same rows and columns, merges them
  // and writes.
  float* cmb = reinterpret_cast<float*>(kbuf);   // [kRows][D + 2]
  float l_row[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) l_row[a] = row_sum(l[a]);
  if (half == 1) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* c_row = cmb + (4 * rg + a) * (D + 2);
#pragma unroll
      for (int cg = 0; cg < kCG; ++cg)
#pragma unroll
        for (int e = 0; e < kCW; ++e)
          c_row[(cg * 16 + kq) * kCW + e] = acc[a][cg * kCW + e];
      if (kq == 0) {
        c_row[D] = m[a];
        c_row[D + 1] = l_row[a];
      }
    }
  }
  __syncthreads();
  if (half == 1) return;

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (qpos[a] < 0) continue;
    const float* c_row = cmb + (4 * rg + a) * (D + 2);
    const float m_new = fmaxf(m[a], c_row[D]);
    const float e0 = expf(m[a] - m_new), e1 = expf(c_row[D] - m_new);
    const float l_ab = l_row[a] * e0 + c_row[D + 1] * e1;
    float out[kCG * kCW];
#pragma unroll
    for (int cg = 0; cg < kCG; ++cg)
#pragma unroll
      for (int e = 0; e < kCW; ++e)
        out[cg * kCW + e] = acc[a][cg * kCW + e] * e0 +
                            c_row[(cg * 16 + kq) * kCW + e] * e1;
    const int ri = 4 * rg + a;
    const int ti = ri / R;
    const size_t trow = (static_cast<size_t>(seg0 + tok0 + ti) * Hq + g * R +
                         (ri - ti * R));
    if (direct) {
      const float inv = 1.f / fmaxf(l_ab, 1e-30f);
#pragma unroll
      for (int c = 0; c < kCG * kCW; ++c) out[c] *= inv;
#pragma unroll
      for (int cg = 0; cg < kCG; ++cg)
        store_cols<kCW>(o + trow * D + (cg * 16 + kq) * kCW, out + cg * kCW);
    } else {
      float* w = ws + (trow * splits + blockIdx.y) * (D + 2);
#pragma unroll
      for (int cg = 0; cg < kCG; ++cg)
#pragma unroll
        for (int e = 0; e < kCW; e += 2)
          st2(w + (cg * 16 + kq) * kCW + e, out + cg * kCW + e);
      if (kq == 0) {
        w[D] = m_new;
        w[D + 1] = l_ab;
      }
    }
  }
}

// One warp per (token, query head): merges the token's splits in split
// order, or writes zeros for a padding token or an inactive segment; a
// token whose tile had one split was written by the split kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kMergeWarps * 32)
paged_prefill_merge_kernel(const float* __restrict__ ws,
                           const int* __restrict__ cu,
                           const int* __restrict__ rows,
                           const int* __restrict__ past_lens,
                           T* __restrict__ o, int total, int N, int Hq, int R,
                           int bs, int nb, int splits) {
  constexpr int kC = D / 32;               // columns per lane
  const int w = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= total * Hq) return;             // whole warp
  const int t = w / Hq;
  T* orow = o + static_cast<size_t>(w) * D;
  // the token's segment n = #{i : cu[i + 1] <= t} (cu is nondecreasing),
  // 32 segments per round of loads
  int n = 0;
  for (int s0 = 0; s0 < N; s0 += 32) {
    const int i = s0 + lane;
    n += __popc(__ballot_sync(kFullMask, i < N && cu[i + 1] <= t));
  }
  if (n == N || t < cu[n] || rows[n] < 0) {
#pragma unroll
    for (int c = 0; c < kC; ++c) store_as(orow + lane + 32 * c, 0.f);
    return;
  }
  const int tq = kRows / R;
  const int key_lim = tile_key_lim(past_lens[n], cu[n + 1] - cu[n],
                                   (t - cu[n]) / tq, tq, nb * bs);
  if (key_lim < kSplitKeys) return;        // written directly
  const int n_splits = key_lim / kSplitKeys + 1;
  const float* part = ws + static_cast<size_t>(w) * splits * (D + 2);
  // lane j holds split s0 + j's max and denominator
  float m_max = kNegInf;
  for (int s = lane; s < n_splits; s += 32)
    m_max = fmaxf(m_max, part[s * (D + 2) + D]);
  m_max = warp_max(m_max);
  float l = 0.f, acc[kC] = {};
  for (int s0 = 0; s0 < n_splits; s0 += 32) {
    const int s = s0 + lane;
    float wgt = 0.f, ls = 0.f;
    if (s < n_splits) {
      wgt = expf(part[s * (D + 2) + D] - m_max);
      ls = part[s * (D + 2) + D + 1];
    }
    const int cnt = min(32, n_splits - s0);
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float wj = __shfl_sync(kFullMask, wgt, j);
      l = fmaf(wj, __shfl_sync(kFullMask, ls, j), l);
      const float* ps = part + (s0 + j) * (D + 2);
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = fmaf(wj, ps[lane + 32 * c], acc[c]);
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < kC; ++c) store_as(orow + lane + 32 * c, acc[c] * inv);
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_table, const void* cu, const void* rows,
           const void* past_lens, void* o, void* ws, int total, int N,
           int Hkv, int R, int bs, int nb, float scale, cudaStream_t stream) {
  using L = Layout<T, D>;
  cudaError_t err = allow_smem(paged_prefill_split_kernel<T, D>, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tq = kRows / R;
  const int splits = (nb * bs + kSplitKeys - 1) / kSplitKeys;
  const dim3 grid((total + tq - 1) / tq + N - 1, splits, Hkv);
  paged_prefill_split_kernel<T, D><<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(cu), static_cast<const int*>(rows),
      static_cast<const int*>(past_lens), static_cast<T*>(o),
      static_cast<float*>(ws), N, Hkv, R, bs, nb, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Hq = Hkv * R;
  const int merge_blocks = (total * Hq + kMergeWarps - 1) / kMergeWarps;
  paged_prefill_merge_kernel<T, D><<<merge_blocks, kMergeWarps * 32, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(cu),
      static_cast<const int*>(rows), static_cast<const int*>(past_lens),
      static_cast<T*>(o), total, N, Hq, R, bs, nb, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k_pool, const void* v_pool,
             const void* block_table, const void* cu, const void* rows,
             const void* past_lens, void* o, void* ws, int total, int N,
             int Hkv, int R, int d, int bs, int nb, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k_pool, v_pool, block_table, cu, rows, past_lens, o, ws, total, N, Hkv, R, bs, nb, scale, stream);
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, block_table, cu, rows, past_lens, o, ws, total, N, Hkv, R, bs, nb, scale, stream);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, block_table, cu, rows, past_lens, o, ws, total, N, Hkv, R, bs, nb, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (total, Hq, d) packed; k_pool, v_pool: (N_pool, bs, Hkv, d), all
// contiguous in `dtype` and 16-byte aligned; ws: fp32 workspace of (total,
// Hq, ceil(nb * bs / 128), d + 2), 16-byte aligned; block_table: (B, nb)
// int32; cu: (N + 1,) int32 nondecreasing with cu[N] <= total; rows,
// past_lens: (N,) int32 (rows[n] = -1: inactive segment).  d is 32, 64 or
// 128 and Hq / Hkv <= 8.  Every element of o is written (zeros for padding
// tokens and inactive segments).  Two launches on `stream` (the splits,
// then the merge); returns cudaGetLastError().
extern "C" int repro_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* cu, const void* rows,
    const void* past_lens, void* o, void* ws, int total, int N, int Hq,
    int Hkv, int d, int bs, int nb, float scale, int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxR || N <= 0 || total <= 0 ||
      bs <= 0 || nb <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k_pool) || !aligned16(v_pool) ||
      !aligned16(o) || !aligned16(ws))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = Hq / Hkv;
  if (dtype == repro::kFloat32)
    return launch_d<float>(q, k_pool, v_pool, block_table, cu, rows, past_lens, o, ws, total, N, Hkv, R, d, bs, nb, scale, st);
  if (dtype == repro::kBFloat16)
    return launch_d<__nv_bfloat16>(q, k_pool, v_pool, block_table, cu, rows, past_lens, o, ws, total, N, Hkv, R, d, bs, nb, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
