// Paged-attention decode, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` (src/repro/serve/paged_attention.py:87,
// launched by `paged_attention_kernel`, :141).  One query token per batch
// row attends every cached position `< length` of that row; keys and values
// live in a pool of blocks ("pages", (N, bs, Hkv, d)) addressed through the
// row's block table (negative ids are clamped to block 0, as the TPU kernel
// does; their positions are at or past `length` and are never read).  GQA:
// query head h reads KV head h / (Hq / Hkv).  Softmax statistics are fp32.
// A row of length 0 gives exact zeros, as the TPU kernel does (the gather
// reference gives the mean of V there; ROADMAP C).
//
// What bounds it on an H100: each cached key and value element is used by
// R = Hq/Hkv queries only (R = 1 on the serving slice), so the kernel is
// bound by device-memory bytes -- the K and V of every valid position, read
// once: 18 MB at the slice (8 rows of ~1100 positions, Hkv 4, d 64, fp32),
// 5.3 us at 3.35 TB/s.  What keeps a kernel from that bound is an empty
// card (one block per (row, KV head) is 32 blocks for 132 SMs) and load
// latency that nothing hides.
//
// Design.
//   * Each (row, KV head) is one thread-block cluster of kCluster = 8
//     blocks (`__cluster_dims__`), so the grid is 8 * B * Hkv blocks (256
//     at the slice).  A block reads `lengths[b]` on the device and takes a
//     balanced, page-aligned span of the row's ceil(length / bs) pages:
//     pages [rank * n / 8, (rank + 1) * n / 8).  A block whose span is
//     empty still takes part in the cluster's barriers and contributes an
//     empty partial.  The geometry comes from static shapes, so the host
//     reads nothing back.
//   * The row's block-table entries are staged in shared memory while
//     `lengths[b]` is read, so no copy waits on a table load from device
//     memory (rows of more than kFullTable blocks read their entries from
//     device memory as they copy).
//   * Pages stream through a ring of tiles of kTile = 32 positions in
//     shared memory (kRingBytes of them: 6 tiles of 8 KB at fp32 d 64),
//     copied with 16-byte cp.async: neighbouring threads copy neighbouring
//     16-byte chunks of one position's d contiguous elements.  All tiles
//     but one are in flight while one computes.
//   * Two passes, as the plain version computes: pass 1 streams the span's
//     K and writes each score s = (q . k) * scale to shared memory; the
//     blocks then exchange their maxima through distributed shared memory
//     (`map_shared_rank` after `cluster.sync()`), so every block knows the
//     row's exact max M and turns its scores into p = exp(s - M); pass 2
//     streams V and accumulates l = sum p and acc = sum p v.  The first V
//     tiles are already in flight while the cluster synchronises.  K and V
//     are separate arrays, so the two passes read no extra bytes.
//   * Scores of up to `window` positions fit shared memory (a window is the
//     span of ceil(nb / 8) pages, capped at kScoreFloats / R floats: rows
//     of more than 8 * 16384 / R positions).  A longer span keeps its first
//     window's scores from pass 1 and, in pass 2, streams each later
//     window's K again to recompute its scores bit for bit before its V.
//   * Inside a block (8 warps): for the scores, d/4 lanes share one
//     position (4 columns each, a shuffle tree over them); for P V, thread
//     t owns 4 output columns of every head over the positions t / (d/4)
//     mod 1024/d of each tile, reading p and V from shared memory; the
//     slices are summed by shuffles within a warp and in warp order.
//   * Merge: each block pushes its (acc, l) for every rank's eighth of the
//     R * d outputs into that rank's shared memory (every peer is past the
//     first barrier, so its shared memory is live); after a second cluster
//     barrier, rank c sums the 8 partials of its eighth in rank order and
//     writes them.  Nothing reads a peer's shared memory after that
//     barrier, so no third one is needed.  One launch, no workspace, no
//     atomics: two launches give the same bits.
//   * Residency.  A cluster runs only when 8 SMs of one GPC have room for
//     it at once.  The kernel is templated on the query heads per KV head
//     it keeps registers for (kR = 1, 2, 4 or 8 >= R) and asks for 3
//     blocks per SM up to kR = 4 (80 registers), so at the slice 45
//     clusters fit the card at once (`cudaOccupancyMaxActiveClusters`) and
//     its 32 run in one wave; with 2 blocks per SM (84-128 registers) only
//     30 fit, and the last 2 clusters run in a second wave (0.0236 against
//     0.0153 ms of device time; tools/paged_decode_probe.py).
//   * Pointers must be 16-byte aligned (the wrapper refuses others) and d
//     is 32, 64 or 128, so every row is copied by 16-byte cp.async.
//
// What bounds the design (chip_smoke [4] and tools/paged_decode_probe.py,
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6, row #11): at the
// slice one call takes ~0.0154 ms of device time (0.0413 before this
// design), 2.9x the byte bound.  One position per row already takes
// ~0.0057 ms: the dependent round trips (length and table, then the first
// tiles), the max exchange and the merge.  The cluster costs ~0.003 ms at
// the slice (the same grid with block barriers in place of the cluster's,
// and a wrong result, takes 0.0123 ms), mostly as each cluster waits twice
// for its slowest block; contiguous pages time the same as scattered ones.

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace repro;

constexpr int kCluster = 8;        // thread blocks per (row, KV head)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // positions per pipeline stage
constexpr int kRingBytes = 49152;  // the ring's target size
constexpr int kMaxStages = 8;
constexpr int kMaxR = 8;           // query heads per KV head
constexpr int kScoreFloats = 16384;  // score capacity of a window (64 KB)
constexpr int kFullTable = 4096;   // rows of at most this many blocks
                                   // stage their table

static_assert(kCluster <= kWarps, "the max exchange reuses the warp slots");

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Tiles of the ring for (T, D): kRingBytes of them, 2 to kMaxStages.
template <typename T, int D>
__host__ __device__ constexpr int stages() {
  constexpr int n = kRingBytes / (kTile * D * static_cast<int>(sizeof(T)));
  return n < 2 ? 2 : (n > kMaxStages ? kMaxStages : n);
}

// Launch geometry for (dtype T, head dim D), mirrored by
// `serve.paged_attention.decode_grid`.  Shared memory, in order: the ring
// [stages][kTile][D] (T; after the last tile it holds the warps' partials
// [kWarps][R][D], fp32), the window's scores [R][window], the partials
// the peers push [kCluster][R * D / kCluster] and their l [kCluster][kMaxR],
// the block's max and the row's [2][kMaxR], the warps' slots
// [kWarps][kMaxR], the table entries.
struct Geometry {
  int window;    // span positions whose scores shared memory holds
  int slots;     // block-table entries staged
  size_t bytes;  // dynamic shared memory
};

template <typename T, int D>
Geometry geometry(int R, int nb, int bs) {
  const int pages = (nb + kCluster - 1) / kCluster;
  const int span = pages * bs;
  const int cap = kScoreFloats / R / kTile * kTile;
  const int window = max(kTile, min((span + kTile - 1) / kTile * kTile, cap));
  const int slots = nb <= kFullTable ? nb : 0;
  const size_t floats = static_cast<size_t>(R) * window + round4(R * D)
                        + (kCluster + 2 + kWarps) * kMaxR;
  return {window, slots,
          sizeof(T) * stages<T, D>() * kTile * D + sizeof(float) * floats
              + sizeof(int) * round4(slots)};
}

// The pipeline's work items, in order: pass 1 scores every tile of the
// span (keeping the first window's scores); pass 2 takes each window's V
// tiles, preceded, from the second window on, by its K tiles again.
enum Kind { kScore = 0, kRescore = 1, kValue = 2 };
struct Item {
  int kind, tile;
};

__device__ __forceinline__ Item item_at(int j, int n_tiles, int tpw) {
  if (j < n_tiles) return {kScore, j};
  j -= n_tiles;
  const int n0 = min(n_tiles, tpw);
  if (j < n0) return {kValue, j};
  j -= n0;
  const int w = 1 + j / (2 * tpw), r = j % (2 * tpw);
  const int first = w * tpw, nw = min(tpw, n_tiles - first);
  return r < nw ? Item{kRescore, first + r} : Item{kValue, first + r - nw};
}

// kR >= R query heads per KV head (1, 2, 4 or 8): the registers a thread
// keeps per head are sized by it.
template <typename T, int D, int kR>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, kR <= 4 ? 3 : 2)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ block_table,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    int Hkv, int R, int bs, int nb, int window, float scale) {
  constexpr int kStages = stages<T, D>();
  constexpr int kLanes = D / 4;               // lanes per position, 4 columns each
  constexpr int kRowsPerWarp = 32 / kLanes;   // positions a warp scores at once
  constexpr int kSlices = kThreads / kLanes;  // position slices of P V
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;  // per row
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  constexpr size_t kRing = sizeof(T) * kStages * kTile * D;
  static_assert(kTile % (kWarps * kRowsPerWarp) == 0 && kTile % kSlices == 0,
                "whole steps per tile");
  static_assert(sizeof(float) * kWarps * kR * D <= kRing,
                "the warps' partials fit the ring");
  static_assert(kR <= kMaxR && D % (4 * kCluster) == 0,
                "each rank merges whole groups of 4 outputs");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / kCluster;   // b * Hkv + g
  const int b = row / Hkv, g = row % Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col = (tid % kLanes) * 4;      // this thread's 4 columns
  const int E = R * D, share = E / kCluster;  // outputs, and each rank's

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem);
  float* sc = reinterpret_cast<float*>(smem + kRing);
  float* mrg = sc + R * window;            // [kCluster][share], pushed
  float* lall = mrg + round4(E);           // [kCluster][kMaxR], pushed
  float* mx = lall + kCluster * kMaxR;
  float* row_max = mx + kMaxR;
  float* wred = row_max + kMaxR;
  int* tbl = reinterpret_cast<int*>(wred + kWarps * kMaxR);

  // The table and q are requested before the length is known.
  const int* trow = block_table + static_cast<size_t>(b) * nb;
  const bool staged = nb <= kFullTable;
  if (staged) {
    for (int i = tid; i < nb; i += kThreads) cp_async4(tbl + i, trow + i);
  }
  cp_async_commit();
  const T* qb = q + static_cast<size_t>(row) * E;
  float4 qr[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    qr[r] = r < R ? ld4(qb + r * D + col) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int len = max(0, min(lengths[b], nb * bs));
  const int pages = (len + bs - 1) / bs;
  const int pg0 = static_cast<int>(static_cast<long long>(rank) * pages / kCluster);
  const int pg1 = static_cast<int>(static_cast<long long>(rank + 1) * pages / kCluster);
  const int s0 = pg0 * bs;
  const int span = max(0, min(pg1 * bs, len) - s0);
  cp_async_wait_all();
  __syncthreads();

  const int n_tiles = (span + kTile - 1) / kTile;
  const int tpw = window / kTile;
  const int n_items = 2 * n_tiles + max(0, n_tiles - tpw);
  const size_t pos_stride = static_cast<size_t>(Hkv) * D;

  auto issue = [&](int j) {
    if (j < n_items) {
      const Item it = item_at(j, n_tiles, tpw);
      const T* pool = (it.kind == kValue ? v_pool : k_pool) + static_cast<size_t>(g) * D;
      T* dst = ring + (j % kStages) * (kTile * D);
      for (int c = tid; c < kTile * kChunks; c += kThreads) {
        const int i = c / kChunks, ch = c % kChunks;
        const int p = it.tile * kTile + i;
        if (p < span) {
          const int pos = s0 + p;
          const int blk = max(staged ? tbl[pos / bs] : trow[pos / bs], 0);
          cp_async16(dst + i * D + ch * kElems,
                     pool + (static_cast<size_t>(blk) * bs + pos % bs) * pos_stride
                         + ch * kElems);
        }
      }
    }
    cp_async_commit();
  };

  float tmax[kR], lsum[kR], acc[kR][4];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    tmax[r] = kNegInf;
    lsum[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }

  // Scores of one K tile: d/4 lanes per position, a shuffle tree over them.
  auto score = [&](const T* buf, Item it) {
    const bool keep = it.kind == kRescore || it.tile < tpw;
    const int base = (it.tile / tpw) * window;
#pragma unroll
    for (int st = 0; st < kTile / (kWarps * kRowsPerWarp); ++st) {
      const int i = (st * kWarps + warp) * kRowsPerWarp + lane / kLanes;
      const int p = it.tile * kTile + i;
      const float4 kx = ld4(buf + i * D + col);
      float s[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r < R) {
          s[r] = dot4(qr[r], kx, 0.f);
#pragma unroll
          for (int off = kLanes / 2; off > 0; off >>= 1)
            s[r] += __shfl_xor_sync(kFullMask, s[r], off);
        }
      }
      if (p < span && lane % kLanes == 0) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r < R) {
            const float v = s[r] * scale;
            tmax[r] = fmaxf(tmax[r], v);
            if (keep) sc[r * window + p - base] = v;
          }
        }
      }
    }
  };

  // The row's max over the cluster: the block's, then every rank's read
  // through distributed shared memory after the first cluster barrier.
  auto exchange = [&]() {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r < R) {
        const float m = warp_max(tmax[r]);
        if (lane == 0) wred[warp * kMaxR + r] = m;
      }
    }
    __syncthreads();
    if (tid < R) {
      float m = kNegInf;
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wred[w * kMaxR + tid]);
      mx[tid] = m;
    }
    cluster.sync();
    if (tid < kCluster * R) {             // block-local: peers push into lall
      const int c = tid / R, r = tid % R;
      wred[c * kMaxR + r] = *cluster.map_shared_rank(mx + r, c);
    }
    __syncthreads();
    if (tid < R) {
      float m = kNegInf;
      for (int c = 0; c < kCluster; ++c) m = fmaxf(m, wred[c * kMaxR + tid]);
      row_max[tid] = m;
    }
    __syncthreads();
  };

  // p = exp(s - M) in place over window w, and its share of l.
  auto to_p = [&](int w) {
    const int base = w * window;
    const int wlen = min(window, span - base);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r < R) {
        const float m = row_max[r];
        for (int x = tid; x < wlen; x += kThreads) {
          const float p = expf(sc[r * window + x] - m);
          sc[r * window + x] = p;
          lsum[r] += p;
        }
      }
    }
  };

  // acc += p v over this thread's positions of one V tile.
  auto pv = [&](const T* buf, int tile) {
    const int base = (tile / tpw) * window;
#pragma unroll
    for (int k = 0; k < kTile / kSlices; ++k) {
      const int i = tid / kLanes + k * kSlices;
      const int p = tile * kTile + i;
      if (p < span) {
        const float4 vx = ld4(buf + i * D + col);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r < R) {
            const float pr = sc[r * window + p - base];
            acc[r][0] = fmaf(pr, vx.x, acc[r][0]);
            acc[r][1] = fmaf(pr, vx.y, acc[r][1]);
            acc[r][2] = fmaf(pr, vx.z, acc[r][2]);
            acc[r][3] = fmaf(pr, vx.w, acc[r][3]);
          }
        }
      }
    }
  };

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);
  bool exchanged = false;
  for (int j = 0; j < n_items; ++j) {
    issue(j + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const Item it = item_at(j, n_tiles, tpw);
    const T* buf = ring + (j % kStages) * (kTile * D);
    if (it.kind == kValue) {
      const int w = it.tile / tpw;
      if (it.tile == w * tpw) {         // the window's first V tile
        if (w == 0) {
          exchange();
          exchanged = true;
        }
        to_p(w);
        __syncthreads();
      }
      pv(buf, it.tile);
    } else {
      score(buf, it);
    }
    __syncthreads();
  }
  if (!exchanged) exchange();          // an empty span

  // The block's partial: the slices of a warp by shuffles, then the warps
  // in order through the (now idle) ring.  Each sum is pushed into the
  // shared memory of the rank that merges it (every peer is past the first
  // cluster barrier, so its shared memory is live).
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r < R) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int off = kLanes; off < 32; off <<= 1)
          acc[r][e] += __shfl_xor_sync(kFullMask, acc[r][e], off);
      }
      if (lane < kLanes) st4(red + (warp * R + r) * D + col, acc[r]);
      const float l = warp_sum(lsum[r]);
      if (lane == 0) wred[warp * kMaxR + r] = l;
    }
  }
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * E + e];
    *cluster.map_shared_rank(mrg + rank * share + e % share, e / share) = s;
  }
  if (tid < kCluster * R) {
    const int c = tid / R, r = tid % R;
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += wred[w * kMaxR + r];
    *cluster.map_shared_rank(lall + rank * kMaxR + r, c) = l;
  }
  cluster.sync();

  // This rank's share of the outputs: the partials summed in rank order.
  // Nothing reads a peer's shared memory from here on.
  T* ob = o + static_cast<size_t>(row) * E + rank * share;
  for (int x = tid; x < share; x += kThreads) {
    const int r = (rank * share + x) / D;
    float num = 0.f, den = 0.f;
    for (int c = 0; c < kCluster; ++c) {
      num += mrg[c * share + x];
      den += lall[c * kMaxR + r];
    }
    store_as(ob + x, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, int kR>
int launch_r(const void* q, const void* k_pool, const void* v_pool,
             const void* block_table, const void* lengths, void* o, int B,
             int Hkv, int R, int bs, int nb, float scale, cudaStream_t stream) {
  const Geometry geo = geometry<T, D>(R, nb, bs);
  cudaError_t err = allow_smem(paged_decode_kernel<T, D, kR>, geo.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<T, D, kR><<<kCluster * B * Hkv, kThreads, geo.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_table),
      static_cast<const int*>(lengths), static_cast<T*>(o), Hkv, R, bs, nb,
      geo.window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_table, const void* lengths, void* o, int B,
           int Hkv, int R, int bs, int nb, float scale, cudaStream_t stream) {
  if (R == 1)
    return launch_r<T, D, 1>(q, k_pool, v_pool, block_table, lengths, o, B, Hkv, R, bs, nb, scale, stream);
  if (R == 2)
    return launch_r<T, D, 2>(q, k_pool, v_pool, block_table, lengths, o, B, Hkv, R, bs, nb, scale, stream);
  if (R <= 4)
    return launch_r<T, D, 4>(q, k_pool, v_pool, block_table, lengths, o, B, Hkv, R, bs, nb, scale, stream);
  return launch_r<T, D, 8>(q, k_pool, v_pool, block_table, lengths, o, B, Hkv, R, bs, nb, scale, stream);
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
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxR || Hq / Hkv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = Hq / Hkv;
  if (dtype == repro::kFloat32)
    return launch_d<float>(q, k_pool, v_pool, block_table, lengths, o, B, Hkv, R, d, bs, nb, scale, st);
  if (dtype == repro::kBFloat16)
    return launch_d<__nv_bfloat16>(q, k_pool, v_pool, block_table, lengths, o, B, Hkv, R, d, bs, nb, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
