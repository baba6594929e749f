// Wide-head attention (head dims 129..256, run at 256), written by hand for
// Hopper (sm_90a): the route every kernel family takes where d > 128.
//
// The kernels of the other sources hold their tiles in registers sized for
// d <= 128 (mosa_row.cuh's one-row staging, the streaming and split MoSA
// tiles, the flash kernel's 64-row tiles, the paged kernels' lanes of 4
// columns), and at d = 256 those tiles pass the 255 registers a thread or
// the 227 KB of shared memory a block may hold.  This file replaces the
// same TPU kernels at d > 128, one template per direction, each a simple
// design that is right first (ROADMAP B holds making it fast):
//
//   * `wide_fwd_kernel<T, P>`: one warp per query row, keys streamed in
//     tiles of kTK = 32 through two cp.async stages in shared memory and
//     shared by the block's warps, an online softmax in fp32.  In a tile
//     lane j scores key j (the whole 256-wide dot product from shared
//     memory, q broadcast), the warp takes the tile's max and sum by
//     shuffles, and each lane accumulates 8 output columns over the tile's
//     keys.  The policy P says which queries a block takes, where a key row
//     lives and what the mask is; every family's mask is one form:
//
//       valid_k && pos_q >= pos_k && (W == 0 || pos_q - pos_k < W)
//              && seg_q == seg_k,
//
//     and an invalid query row (a padding token, an empty block) is
//     written as zeros.  Policies:
//       - `MosaFwd<T, kBlock, kRes>`: #1 `_mosa_kernel`
//         (src/repro/kernels/mosa_attention.py:55), #2 `_mosa_fwd_res_kernel`
//         (:110), and their block forms #5 `_mosa_block_kernel`
//         (src/repro/kernels/mosa_block.py:67) and #6
//         `_mosa_block_fwd_res_kernel` (:128); 8 queries of one (batch,
//         head) row a block;
//       - `FlashFwd<T>`: #9 `_flash_kernel`
//         (src/repro/kernels/flash_attention.py:26); 8 positions of one
//         query head a block, the keys from the first one's window start;
//       - `VarlenFwd<T>`: #10 `_flash_varlen_kernel` (:116); 8 packed
//         tokens of one query head a block;
//       - `PagedDecode<T>`: #11 `_paged_kernel`
//         (src/repro/serve/paged_attention.py:87); one block per (row, KV
//         head), one warp per query head of its group;
//       - `PagedPrefill<T>`: #12 `_paged_prefill_kernel` (:260); one block
//         per (packed token, KV head), one warp per query head of its
//         group;
//   * `wide_bwd_dq_kernel<T, kBlock>`: #3 `_mosa_bwd_dq_kernel`
//     (src/repro/kernels/mosa_backward.py:49) and #7
//     `_mosa_block_bwd_dq_kernel` (mosa_block.py:182): one warp per query
//     row, K and V streamed as in the forward, lane j computing key j's
//     P and dS, each lane accumulating 8 columns of dQ;
//   * `wide_bwd_dkv_kernel<T, kBlock>`: #4 `_mosa_bwd_dkv_kernel` (:100)
//     and #8 `_mosa_block_bwd_dkv_kernel` (mosa_block.py:227): one warp per
//     key row, q and g~ streamed in tiles of 32 queries, lane i computing
//     query i's P and dS, each lane accumulating 8 columns of dK and dV.
//
// The arithmetic is the plain versions' (kernels/*.py): scores scaled
// after the dot product, masked scores -1e30 with zero probability, the
// denominator floored at 1e-30 (so a row with no valid key gives zeros),
// lse = m + log(max(l, 1e-30)), P recomputed in the backward under the
// explicit mask.  Each output element is summed by one lane in a fixed
// order, without atomics, so two launches are bitwise equal.
//
// Layout.  Every tensor's rows are 256 wide (the wrappers zero-pad d to
// 256, which changes no score and adds only zero output columns) and
// 16-byte aligned.  A tile row in shared memory is padded to 260 floats or
// 264 bf16s, so lane j reading row j with 16-byte loads and lane l reading
// its 8 columns of one row are both free of bank conflicts.  Lane l owns
// columns [4l, 4l + 4) and [128 + 4l, 128 + 4l + 4) of an fp32 row, and
// [8l, 8l + 8) of a bf16 row.  A key index past the block's range is
// copied from the range's last row (finite data, masked out), so no
// shared row is ever left uninitialised.
//
// What bounds it on an H100: at gemma3-4b's shapes these kernels are far
// from either bound.  Every block reads its keys from L2 once per block of
// queries, and the products run on the fp32 units one lane per key, at a
// shuffle per key and tile; PERF.md section 6 has each kernel's time at
// d 256 beside its bound and SDPA's.

#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kD = 256;        // the width every row runs at
constexpr int kTK = 32;        // keys (or queries) per streamed tile
constexpr int kWarps = 8;      // warps of a MoSA or flash block
constexpr int kThreads = 32 * kWarps;

template <typename T>
struct Row;
template <>
struct Row<float> {
  static constexpr int kStride = kD + 4;   // floats of a shared tile row
};
template <>
struct Row<__nv_bfloat16> {
  static constexpr int kStride = kD + 8;
};

// 8 consecutive elements from `p`, widened to float.
__device__ __forceinline__ void load8_row(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8_row(const __nv_bfloat16* p,
                                          float* out) {
  Vec16<__nv_bfloat16>::load(p, out);
}

// Column of lane `lane`'s e-th owned element (e < 8) in a row of T.
__device__ __forceinline__ int col8(const float*, int lane, int e) {
  return (e < 4 ? 0 : 128 - 4) + 4 * lane + e;
}
__device__ __forceinline__ int col8(const __nv_bfloat16*, int lane, int e) {
  return 8 * lane + e;
}

// Lane `lane`'s 8 owned elements of a row, widened to float.
__device__ __forceinline__ void load8(const float* row, int lane, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * lane);
  const float4 b = *reinterpret_cast<const float4*>(row + 128 + 4 * lane);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int lane,
                                      float* out) {
  Vec16<__nv_bfloat16>::load(row + 8 * lane, out);
}

// Writes lane `lane`'s 8 owned values into a row of T.
__device__ __forceinline__ void store8(float* row, int lane, const float* x) {
  st4(row + 4 * lane, x);
  st4(row + 128 + 4 * lane, x + 4);
}
__device__ __forceinline__ void store8(__nv_bfloat16* row, int lane,
                                       const float* x) {
  st4(row + 8 * lane, x);
  st4(row + 8 * lane + 4, x + 4);
}

// Writes lane `lane`'s 8 values, owned in T's column mapping, into an fp32
// row (o_pre of a bf16 call).
template <typename T>
__device__ __forceinline__ void store8_f32(float* row, int lane,
                                           const float* x) {
  if constexpr (sizeof(T) == sizeof(float)) {
    store8(row, lane, x);
  } else {
    st4(row + 8 * lane, x);
    st4(row + 8 * lane + 4, x + 4);
  }
}

// dot(x, row) over the 256 columns: `x` an fp32 row in shared memory (the
// same address for every lane: a broadcast), `row` lane-private.
template <typename T>
__device__ __forceinline__ float dot_row(const float* x, const T* row) {
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < kD; c += 8) {
    float r[8];
    load8_row(row + c, r);
    const float4 a = *reinterpret_cast<const float4*>(x + c);
    const float4 b = *reinterpret_cast<const float4*>(x + c + 4);
    s = fmaf(a.x, r[0], s); s = fmaf(a.y, r[1], s);
    s = fmaf(a.z, r[2], s); s = fmaf(a.w, r[3], s);
    s = fmaf(b.x, r[4], s); s = fmaf(b.y, r[5], s);
    s = fmaf(b.z, r[6], s); s = fmaf(b.w, r[7], s);
  }
  return s;
}

// Copies one 256-wide row of T into shared memory, 16 bytes a thread.
template <typename T>
__device__ __forceinline__ void copy_row_async(T* dst, const T* src,
                                               int chunk) {
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  cp_async16(dst + chunk * kElems, src + chunk * kElems);
}

// An fp32 copy of lane `lane`'s 8 owned elements of `src` in `dst`.
template <typename T>
__device__ __forceinline__ void stage_row_f32(float* dst, const T* src,
                                              int lane) {
  float x[8];
  load8(src, lane, x);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[col8(src, lane, e)] = x[e];
}

// The query a warp of a forward block serves.
struct Query {
  bool has;    // a query row exists for this warp
  bool valid;  // its output is kept (false: written as zeros)
  int pos, seg;
};

// ------------------------------------------------------------- policies
// A policy describes one launch: `job(blk)` the block's work (its key range
// [j0, j1) and what locates its rows), `query(job, w)` warp w's query, and
// `qrow`, `krow`, `vrow`, `key(job, j, ...)` (position, segment, validity
// of key j) and `write(...)` (the lane's 8 columns of the output, m, l).

struct MosaJob {
  int row, q0, j0, j1;
};

template <typename T, bool kBlock, bool kRes>
struct MosaFwd {
  const T *q, *k, *v;
  const int* idx;
  const int* seg;
  const float* r;
  T* o;
  float* o_pre;
  float* lse;
  int S, bs, T_len, n_tiles;
  float scale;

  __device__ MosaJob job(int blk) const {
    return {blk / n_tiles, (blk % n_tiles) * kWarps, 0, S};
  }
  __device__ Query query(const MosaJob& jb, int w) const {
    const int i = jb.q0 + w;
    if (i >= S) return {false, false, 0, 0};
    bool valid;
    const int pos = sel_pos<kBlock>(idx, jb.row, S, i, bs, T_len, valid);
    const int sg = seg ? seg[static_cast<size_t>(jb.row) * S + i] : 0;
    return {true, kBlock ? valid : true, pos, sg};
  }
  __device__ const T* qrow(const MosaJob& jb, int w) const {
    return q + (static_cast<size_t>(jb.row) * S + jb.q0 + w) * kD;
  }
  __device__ const T* krow(const MosaJob& jb, int j) const {
    return k + (static_cast<size_t>(jb.row) * S + j) * kD;
  }
  __device__ const T* vrow(const MosaJob& jb, int j) const {
    return v + (static_cast<size_t>(jb.row) * S + j) * kD;
  }
  __device__ void key(const MosaJob& jb, int j, int& pos, int& sg,
                      bool& ok) const {
    pos = sel_pos<kBlock>(idx, jb.row, S, j, bs, T_len, ok);
    sg = seg ? seg[static_cast<size_t>(jb.row) * S + j] : 0;
  }
  __device__ void write(const MosaJob& jb, int w, const Query& qr, int lane,
                        const float* acc, float m, float l) const {
    const size_t i = static_cast<size_t>(jb.row) * S + jb.q0 + w;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float x[8];
    if constexpr (kRes) {
      const float keep = qr.valid ? inv : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = acc[e] * keep;
      store8_f32<T>(o_pre + i * kD, lane, x);
      if (lane == 0) lse[i] = m + logf(fmaxf(l, 1e-30f));
    } else {
      const float rq = qr.valid ? sel_score<kBlock>(r, jb.row, S,
                                                    jb.q0 + w, bs)
                                : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = acc[e] * inv * rq;
      store8(o + i * kD, lane, x);
    }
  }
};

struct FlashJob {
  int b, h, g, i0, j0, j1;
};

template <typename T>
struct FlashFwd {
  const T *q, *k, *v;
  T* o;
  int Hq, Hkv, Tq, Tk, window, q_offset, n_tiles;
  float scale;

  __device__ FlashJob job(int blk) const {
    const int bh = blk / n_tiles, i0 = (blk % n_tiles) * kWarps;
    const int b = bh / Hq, h = bh % Hq;
    const int p0 = q_offset + i0;
    const int p1 = q_offset + min(Tq, i0 + kWarps) - 1;
    const int j0 = window > 0 ? max(0, p0 - window + 1) : 0;
    return {b, h, h / (Hq / Hkv), i0, j0, min(Tk, p1 + 1)};
  }
  __device__ Query query(const FlashJob& jb, int w) const {
    const int i = jb.i0 + w;
    return {i < Tq, true, q_offset + i, 0};
  }
  __device__ const T* qrow(const FlashJob& jb, int w) const {
    return q + ((static_cast<size_t>(jb.b) * Hq + jb.h) * Tq + jb.i0 + w) * kD;
  }
  __device__ const T* krow(const FlashJob& jb, int j) const {
    return k + ((static_cast<size_t>(jb.b) * Hkv + jb.g) * Tk + j) * kD;
  }
  __device__ const T* vrow(const FlashJob& jb, int j) const {
    return v + ((static_cast<size_t>(jb.b) * Hkv + jb.g) * Tk + j) * kD;
  }
  __device__ void key(const FlashJob&, int j, int& pos, int& sg,
                      bool& ok) const {
    pos = j;
    sg = 0;
    ok = true;
  }
  __device__ void write(const FlashJob& jb, int w, const Query&, int lane,
                        const float* acc, float, float l) const {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = acc[e] * inv;
    store8(o + ((static_cast<size_t>(jb.b) * Hq + jb.h) * Tq + jb.i0 + w) * kD,
           lane, x);
  }
};

struct VarlenJob {
  int h, g, t0, j0, j1;
};

// `seg` is each packed token's segment (N on the padding tail), `cu` the
// segments' offsets (N + 1 entries).
template <typename T>
struct VarlenFwd {
  const T *q, *k, *v;
  const int* seg;
  const int* cu;
  T* o;
  int total, N, Hq, Hkv, window, n_tiles;
  float scale;

  __device__ VarlenJob job(int blk) const {
    const int h = blk / n_tiles, t0 = (blk % n_tiles) * kWarps;
    int j0 = cu[min(seg[t0], N)];
    if (window > 0) j0 = max(j0, t0 - window + 1);
    return {h, h / (Hq / Hkv), t0, j0, min(total, t0 + kWarps)};
  }
  __device__ Query query(const VarlenJob& jb, int w) const {
    const int t = jb.t0 + w;
    if (t >= total) return {false, false, 0, 0};
    const int sg = seg[t];
    return {true, sg < N, t, sg};
  }
  __device__ const T* qrow(const VarlenJob& jb, int w) const {
    return q + (static_cast<size_t>(jb.t0 + w) * Hq + jb.h) * kD;
  }
  __device__ const T* krow(const VarlenJob& jb, int j) const {
    return k + (static_cast<size_t>(j) * Hkv + jb.g) * kD;
  }
  __device__ const T* vrow(const VarlenJob& jb, int j) const {
    return v + (static_cast<size_t>(j) * Hkv + jb.g) * kD;
  }
  __device__ void key(const VarlenJob&, int j, int& pos, int& sg,
                      bool& ok) const {
    pos = j;
    sg = seg[j];
    ok = true;
  }
  __device__ void write(const VarlenJob& jb, int w, const Query& qr, int lane,
                        const float* acc, float, float l) const {
    const float inv = qr.valid ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = acc[e] * inv;
    store8(o + (static_cast<size_t>(jb.t0 + w) * Hq + jb.h) * kD, lane, x);
  }
};

// The paged policies: one block per (row or token, KV head), R warps.
struct PagedJob {
  int row, g, qi, pos, j0, j1;   // qi: the query's row in q (b or token)
};

template <typename T>
__device__ __forceinline__ const T* page_row(const T* pool,
                                             const int* table, int row,
                                             int nb, int bs, int Hkv, int g,
                                             int j) {
  const int blk = max(table[static_cast<size_t>(row) * nb + j / bs], 0);
  return pool + ((static_cast<size_t>(blk) * bs + j % bs) * Hkv + g) * kD;
}

template <typename T>
struct PagedDecode {
  const T *q, *k, *v;
  const int* table;
  const int* lengths;
  T* o;
  int Hq, Hkv, bs, nb;
  float scale;

  __device__ PagedJob job(int blk) const {
    const int b = blk / Hkv, g = blk % Hkv;
    const int len = max(0, min(lengths[b], nb * bs));
    return {b, g, b, len - 1, 0, len};
  }
  __device__ Query query(const PagedJob& jb, int) const {
    return {true, true, jb.pos, 0};
  }
  __device__ const T* qrow(const PagedJob& jb, int w) const {
    return q + (static_cast<size_t>(jb.qi) * Hq + jb.g * (Hq / Hkv) + w) * kD;
  }
  __device__ const T* krow(const PagedJob& jb, int j) const {
    return page_row(k, table, jb.row, nb, bs, Hkv, jb.g, j);
  }
  __device__ const T* vrow(const PagedJob& jb, int j) const {
    return page_row(v, table, jb.row, nb, bs, Hkv, jb.g, j);
  }
  __device__ void key(const PagedJob&, int j, int& pos, int& sg,
                      bool& ok) const {
    pos = j;
    sg = 0;
    ok = true;
  }
  __device__ void write(const PagedJob& jb, int w, const Query&, int lane,
                        const float* acc, float, float l) const {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = acc[e] * inv;
    store8(o + (static_cast<size_t>(jb.qi) * Hq + jb.g * (Hq / Hkv) + w) * kD,
           lane, x);
  }
};

// Packed prefill: token t of segment n (cu[n] <= t < cu[n + 1]) continues
// row rows[n] after past_lens[n] cached tokens and attends that row's keys
// at positions <= its own; padding tokens and inactive segments (row -1)
// are written as zeros.
template <typename T>
struct PagedPrefill {
  const T *q, *k, *v;
  const int* table;
  const int* cu;
  const int* rows;
  const int* past;
  T* o;
  int N, Hq, Hkv, bs, nb;
  float scale;

  __device__ PagedJob job(int blk) const {
    const int t = blk / Hkv, g = blk % Hkv;
    int lo = 0, hi = N;                // the last n with cu[n] <= t
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (cu[mid] <= t) lo = mid; else hi = mid;
    }
    const int row = t < cu[N] ? rows[lo] : -1;
    if (row < 0) return {0, g, t, -1, 0, 0};
    const int pos = past[lo] + t - cu[lo];
    return {row, g, t, pos, 0, min(pos + 1, nb * bs)};
  }
  __device__ Query query(const PagedJob& jb, int) const {
    return {true, jb.pos >= 0, jb.pos, 0};
  }
  __device__ const T* qrow(const PagedJob& jb, int w) const {
    return q + (static_cast<size_t>(jb.qi) * Hq + jb.g * (Hq / Hkv) + w) * kD;
  }
  __device__ const T* krow(const PagedJob& jb, int j) const {
    return page_row(k, table, jb.row, nb, bs, Hkv, jb.g, j);
  }
  __device__ const T* vrow(const PagedJob& jb, int j) const {
    return page_row(v, table, jb.row, nb, bs, Hkv, jb.g, j);
  }
  __device__ void key(const PagedJob&, int j, int& pos, int& sg,
                      bool& ok) const {
    pos = j;
    sg = 0;
    ok = true;
  }
  __device__ void write(const PagedJob& jb, int w, const Query& qr, int lane,
                        const float* acc, float, float l) const {
    const float inv = qr.valid ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = acc[e] * inv;
    store8(o + (static_cast<size_t>(jb.qi) * Hq + jb.g * (Hq / Hkv) + w) * kD,
           lane, x);
  }
};

// ------------------------------------------------------------- forward
// Shared memory: K and V tiles [2][kTK][stride] (T), the warps' query rows
// [kWarps][kD] (fp32), the tiles' key metadata [2][3][kTK] (int).
template <typename T>
constexpr size_t fwd_smem_bytes() {
  return sizeof(T) * 4 * kTK * Row<T>::kStride + sizeof(float) * kWarps * kD
         + sizeof(int) * 6 * kTK;
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(const P p, int window) {
  constexpr int kS = Row<T>::kStride;
  constexpr int kChunks = kD * static_cast<int>(sizeof(T)) / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kt = reinterpret_cast<T*>(smem);
  T* vt = kt + 2 * kTK * kS;
  float* qs = reinterpret_cast<float*>(vt + 2 * kTK * kS);
  int* meta = reinterpret_cast<int*>(qs + kWarps * kD);   // [2][3][kTK]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nthr = blockDim.x;
  const auto jb = p.job(blockIdx.x);
  const Query qr = p.query(jb, warp);
  float* qw = qs + warp * kD;
  if (qr.has) stage_row_f32(qw, p.qrow(jb, warp), lane);

  const int n_keys = max(0, jb.j1 - jb.j0);
  const int n_tiles = (n_keys + kTK - 1) / kTK;
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int st = t & 1, base = jb.j0 + t * kTK;
      for (int c = tid; c < kTK * kChunks; c += nthr) {
        const int i = c / kChunks, ch = c % kChunks;
        const int j = min(base + i, jb.j1 - 1);
        copy_row_async(kt + (st * kTK + i) * kS, p.krow(jb, j), ch);
        copy_row_async(vt + (st * kTK + i) * kS, p.vrow(jb, j), ch);
      }
      if (tid < kTK) {
        const int j = base + tid;
        int pos = 0, sg = 0;
        bool ok = j < jb.j1;
        if (ok) p.key(jb, j, pos, sg, ok);
        int* mt = meta + st * 3 * kTK;
        mt[tid] = pos;
        mt[kTK + tid] = sg;
        mt[2 * kTK + tid] = ok;
      }
    }
    cp_async_commit();
  };

  float acc[8], m = kNegInf, l = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;

  issue(0);
  for (int t = 0; t < n_tiles; ++t) {
    issue(t + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int st = t & 1;
    if (qr.has) {
      const T* krow_s = kt + (st * kTK + lane) * kS;
      const int* mt = meta + st * 3 * kTK;
      const int kpos = mt[lane], kseg = mt[kTK + lane];
      const bool ok = mt[2 * kTK + lane] && qr.pos >= kpos
                      && (window <= 0 || qr.pos - kpos < window)
                      && qr.seg == kseg;
      float s = dot_row(qw, krow_s);
      s = ok ? s * p.scale : kNegInf;
      const float mnew = fmaxf(m, warp_max(s));
      const float alpha = expf(m - mnew);
      const float pj = ok ? expf(s - mnew) : 0.f;
      l = l * alpha + warp_sum(pj);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] *= alpha;
      for (int jj = 0; jj < kTK; ++jj) {
        const float pk = __shfl_sync(kFullMask, pj, jj);
        if (pk != 0.f) {
          float x[8];
          load8(vt + (st * kTK + jj) * kS, lane, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(pk, x[e], acc[e]);
        }
      }
      m = mnew;
    }
    __syncthreads();
  }
  cp_async_wait_all();
  if (qr.has) p.write(jb, warp, qr, lane, acc, m, l);
}

template <typename T, typename P>
int launch_fwd(const P& p, int blocks, int threads, int window,
               cudaStream_t stream) {
  if (blocks <= 0) return static_cast<int>(cudaSuccess);
  constexpr size_t bytes = fwd_smem_bytes<T>();
  cudaError_t err = allow_smem(wide_fwd_kernel<T, P>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_fwd_kernel<T, P><<<blocks, threads, bytes, stream>>>(p, window);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ backward
// dq.  Shared memory: K and V tiles [2][kTK][stride] (T), the warps' q and
// g~ rows [2][kWarps][kD] (fp32), the key tiles' metadata [2][3][kTK].
template <typename T>
constexpr size_t dq_smem_bytes() {
  return sizeof(T) * 4 * kTK * Row<T>::kStride
         + sizeof(float) * 2 * kWarps * kD + sizeof(int) * 6 * kTK;
}

template <typename T, bool kBlock>
__global__ void __launch_bounds__(kThreads)
wide_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ idx,
                   const int* __restrict__ seg, const float* __restrict__ gt,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int S, int bs, int T_len, int n_qtiles, float scale) {
  constexpr int kS = Row<T>::kStride;
  constexpr int kChunks = kD * static_cast<int>(sizeof(T)) / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kt = reinterpret_cast<T*>(smem);
  T* vt = kt + 2 * kTK * kS;
  float* qs = reinterpret_cast<float*>(vt + 2 * kTK * kS);
  float* gs = qs + kWarps * kD;
  int* meta = reinterpret_cast<int*>(gs + kWarps * kD);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = blockIdx.x / n_qtiles;
  const int i = (blockIdx.x % n_qtiles) * kWarps + warp;
  const size_t base_row = static_cast<size_t>(row) * S;
  const bool has = i < S;
  int qpos = 0, qseg = 0;
  float qlse = 0.f, qdelta = 0.f;
  float* qw = qs + warp * kD;
  float* gw = gs + warp * kD;
  if (has) {
    bool unused;
    qpos = sel_pos<kBlock>(idx, row, S, i, bs, T_len, unused);
    qseg = seg ? seg[base_row + i] : 0;
    qlse = lse[base_row + i];
    qdelta = delta[base_row + i];
    stage_row_f32(qw, q + (base_row + i) * kD, lane);
    stage_row_f32(gw, gt + (base_row + i) * kD, lane);
  }

  const int n_tiles = (S + kTK - 1) / kTK;
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int st = t & 1, base = t * kTK;
      for (int c = tid; c < kTK * kChunks; c += kThreads) {
        const int r = c / kChunks, ch = c % kChunks;
        const int j = min(base + r, S - 1);
        copy_row_async(kt + (st * kTK + r) * kS, k + (base_row + j) * kD, ch);
        copy_row_async(vt + (st * kTK + r) * kS, v + (base_row + j) * kD, ch);
      }
      if (tid < kTK) {
        const int j = base + tid;
        int pos = 0, sg = 0;
        bool ok = j < S;
        if (ok) {
          pos = sel_pos<kBlock>(idx, row, S, j, bs, T_len, ok);
          sg = seg ? seg[base_row + j] : 0;
        }
        int* mt = meta + st * 3 * kTK;
        mt[tid] = pos;
        mt[kTK + tid] = sg;
        mt[2 * kTK + tid] = ok;
      }
    }
    cp_async_commit();
  };

  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;

  issue(0);
  for (int t = 0; t < n_tiles; ++t) {
    issue(t + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int st = t & 1;
    if (has) {
      const int* mt = meta + st * 3 * kTK;
      const bool ok = mt[2 * kTK + lane] && qpos >= mt[lane]
                      && qseg == mt[kTK + lane];
      const float s = dot_row(qw, kt + (st * kTK + lane) * kS) * scale;
      const float pj = ok ? expf(s - qlse) : 0.f;
      const float dp = dot_row(gw, vt + (st * kTK + lane) * kS);
      const float ds = pj * (dp - qdelta);
      for (int jj = 0; jj < kTK; ++jj) {
        const float dk = __shfl_sync(kFullMask, ds, jj);
        if (dk != 0.f) {
          float x[8];
          load8(kt + (st * kTK + jj) * kS, lane, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(dk, x[e], acc[e]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait_all();
  if (has) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= scale;
    store8(dq + (base_row + i) * kD, lane, acc);
  }
}

// dk, dv.  Shared memory: q tiles [2][kTK][stride] (T), g~ tiles
// [2][kTK][kD + 4] (fp32), the warps' k and v rows [2][kWarps][kD] (fp32),
// the query tiles' metadata [2][4][kTK] (pos, seg; lse, delta as floats).
template <typename T>
constexpr size_t dkv_smem_bytes() {
  return sizeof(T) * 2 * kTK * Row<T>::kStride
         + sizeof(float) * 2 * kTK * Row<float>::kStride
         + sizeof(float) * 2 * kWarps * kD + sizeof(int) * 8 * kTK;
}

template <typename T, bool kBlock>
__global__ void __launch_bounds__(kThreads)
wide_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ idx,
                    const int* __restrict__ seg, const float* __restrict__ gt,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int S, int bs, int T_len,
                    int n_ktiles, float scale) {
  constexpr int kS = Row<T>::kStride;
  constexpr int kSG = Row<float>::kStride;
  constexpr int kChunks = kD * static_cast<int>(sizeof(T)) / 16;
  constexpr int kChunksG = kD * static_cast<int>(sizeof(float)) / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qt = reinterpret_cast<T*>(smem);
  float* gtt = reinterpret_cast<float*>(qt + 2 * kTK * kS);
  float* ks = gtt + 2 * kTK * kSG;
  float* vs = ks + kWarps * kD;
  int* meta = reinterpret_cast<int*>(vs + kWarps * kD);   // [2][4][kTK]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = blockIdx.x / n_ktiles;
  const int j = (blockIdx.x % n_ktiles) * kWarps + warp;
  const size_t base_row = static_cast<size_t>(row) * S;
  const bool has = j < S;
  int kpos = 0, kseg = 0;
  bool kok = false;
  float* kw = ks + warp * kD;
  float* vw = vs + warp * kD;
  if (has) {
    kpos = sel_pos<kBlock>(idx, row, S, j, bs, T_len, kok);
    kseg = seg ? seg[base_row + j] : 0;
    stage_row_f32(kw, k + (base_row + j) * kD, lane);
    stage_row_f32(vw, v + (base_row + j) * kD, lane);
  }

  const int n_tiles = (S + kTK - 1) / kTK;
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int st = t & 1, base = t * kTK;
      for (int c = tid; c < kTK * kChunks; c += kThreads) {
        const int r = c / kChunks, ch = c % kChunks;
        const int i = min(base + r, S - 1);
        copy_row_async(qt + (st * kTK + r) * kS, q + (base_row + i) * kD, ch);
      }
      for (int c = tid; c < kTK * kChunksG; c += kThreads) {
        const int r = c / kChunksG, ch = c % kChunksG;
        const int i = min(base + r, S - 1);
        copy_row_async(gtt + (st * kTK + r) * kSG, gt + (base_row + i) * kD,
                       ch);
      }
      if (tid < kTK) {
        const int i = base + tid;
        int pos = 0, sg = 0;
        float ls = 0.f, dl = 0.f;
        if (i < S) {
          bool unused;
          pos = sel_pos<kBlock>(idx, row, S, i, bs, T_len, unused);
          sg = seg ? seg[base_row + i] : 0;
          ls = lse[base_row + i];
          dl = delta[base_row + i];
        }
        int* mt = meta + st * 4 * kTK;
        mt[tid] = pos;
        mt[kTK + tid] = sg;
        reinterpret_cast<float*>(mt)[2 * kTK + tid] = ls;
        reinterpret_cast<float*>(mt)[3 * kTK + tid] = dl;
      }
    }
    cp_async_commit();
  };

  float adk[8], adv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) adk[e] = adv[e] = 0.f;

  issue(0);
  for (int t = 0; t < n_tiles; ++t) {
    issue(t + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int st = t & 1;
    if (has) {
      const int* mt = meta + st * 4 * kTK;
      const float* mf = reinterpret_cast<const float*>(mt);
      const bool ok = kok && t * kTK + lane < S && mt[lane] >= kpos
                      && mt[kTK + lane] == kseg;
      const float s = dot_row(kw, qt + (st * kTK + lane) * kS) * scale;
      const float pi = ok ? expf(s - mf[2 * kTK + lane]) : 0.f;
      const float dp = dot_row(vw, gtt + (st * kTK + lane) * kSG);
      const float ds = pi * (dp - mf[3 * kTK + lane]);
      for (int ii = 0; ii < kTK; ++ii) {
        const float pv = __shfl_sync(kFullMask, pi, ii);
        const float dsv = __shfl_sync(kFullMask, ds, ii);
        if (pv != 0.f) {
          float g[8], x[8];
          load8(gtt + (st * kTK + ii) * kSG, lane, g);
          load8(qt + (st * kTK + ii) * kS, lane, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            adv[e] = fmaf(pv, g[e], adv[e]);
            adk[e] = fmaf(dsv, x[e], adk[e]);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait_all();
  if (has) {
    // The g~ columns' lane mapping is fp32's; dv is written in T's.
    const float* gmap = nullptr;
    const T* tmap = nullptr;
    float dvt[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) adk[e] *= scale;
    // Re-map dv from fp32's owned columns to T's through shared memory
    // (this warp's k row, no longer read).
#pragma unroll
    for (int e = 0; e < 8; ++e) kw[col8(gmap, lane, e)] = adv[e];
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) dvt[e] = kw[col8(tmap, lane, e)];
    store8(dk + (base_row + j) * kD, lane, adk);
    store8(dv + (base_row + j) * kD, lane, dvt);
  }
}

// ------------------------------------------------------------ launchers
template <typename T, bool kBlock>
int mosa_fwd_t(const void* q, const void* k, const void* v, const void* idx,
               const void* seg, const void* r, void* o, void* o_pre,
               void* lse, int BH, int S, int bs, int T_len, float scale,
               cudaStream_t stream) {
  const int n_tiles = (S + kWarps - 1) / kWarps;
  if (r != nullptr) {
    MosaFwd<T, kBlock, false> p{
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(idx),
        static_cast<const int*>(seg), static_cast<const float*>(r),
        static_cast<T*>(o), nullptr, nullptr, S, bs, T_len, n_tiles, scale};
    return launch_fwd<T>(p, BH * n_tiles, kThreads, 0, stream);
  }
  MosaFwd<T, kBlock, true> p{
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), nullptr, nullptr,
      static_cast<float*>(o_pre), static_cast<float*>(lse), S, bs, T_len,
      n_tiles, scale};
  return launch_fwd<T>(p, BH * n_tiles, kThreads, 0, stream);
}

template <bool kBlock>
int mosa_fwd(const void* q, const void* k, const void* v, const void* idx,
             const void* seg, const void* r, void* o, void* o_pre, void* lse,
             int BH, int S, int d, int bs, int T_len, float scale, int dtype,
             void* stream) {
  if (d != kD || BH <= 0 || S <= 0 || bs <= 0 || S % bs != 0 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return mosa_fwd_t<float, kBlock>(q, k, v, idx, seg, r, o, o_pre, lse, BH,
                                     S, bs, T_len, scale, st);
  if (dtype == kBFloat16)
    return mosa_fwd_t<__nv_bfloat16, kBlock>(q, k, v, idx, seg, r, o, o_pre,
                                             lse, BH, S, bs, T_len, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool kBlock>
int mosa_bwd_t(const void* q, const void* k, const void* v, const void* idx,
               const void* seg, const void* gt, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int BH, int S,
               int bs, int T_len, float scale, cudaStream_t stream) {
  const int n_tiles = (S + kWarps - 1) / kWarps;
  if (dq != nullptr) {
    constexpr size_t bytes = dq_smem_bytes<T>();
    cudaError_t err = allow_smem(wide_bwd_dq_kernel<T, kBlock>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    wide_bwd_dq_kernel<T, kBlock><<<BH * n_tiles, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(idx),
        static_cast<const int*>(seg), static_cast<const float*>(gt),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), S, bs, T_len, n_tiles, scale);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr size_t bytes = dkv_smem_bytes<T>();
  cudaError_t err = allow_smem(wide_bwd_dkv_kernel<T, kBlock>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_bwd_dkv_kernel<T, kBlock><<<BH * n_tiles, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(gt),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, bs, T_len, n_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBlock>
int mosa_bwd(const void* q, const void* k, const void* v, const void* idx,
             const void* seg, const void* gt, const void* lse,
             const void* delta, void* dq, void* dk, void* dv, int BH, int S,
             int d, int bs, int T_len, float scale, int dtype, void* stream) {
  if (d != kD || BH <= 0 || S <= 0 || bs <= 0 || S % bs != 0 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(gt))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return mosa_bwd_t<float, kBlock>(q, k, v, idx, seg, gt, lse, delta, dq,
                                     dk, dv, BH, S, bs, T_len, scale, st);
  if (dtype == kBFloat16)
    return mosa_bwd_t<__nv_bfloat16, kBlock>(q, k, v, idx, seg, gt, lse,
                                             delta, dq, dk, dv, BH, S, bs,
                                             T_len, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int flash_t(const void* q, const void* k, const void* v, const void* seg,
            const void* cu, void* o, int B, int Hq, int Hkv, int Tq, int Tk,
            int window, int q_offset, int N, float scale,
            cudaStream_t stream) {
  const int n_tiles = (Tq + kWarps - 1) / kWarps;
  if (seg == nullptr) {
    FlashFwd<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Tq,
                  Tk, window, q_offset, n_tiles, scale};
    return launch_fwd<T>(p, B * Hq * n_tiles, kThreads, window, stream);
  }
  VarlenFwd<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<const int*>(seg),
                 static_cast<const int*>(cu), static_cast<T*>(o), Tq, N, Hq,
                 Hkv, window, n_tiles, scale};
  return launch_fwd<T>(p, Hq * n_tiles, kThreads, window, stream);
}

int flash(const void* q, const void* k, const void* v, const void* seg,
          const void* cu, void* o, int B, int Hq, int Hkv, int Tq, int Tk,
          int d, int window, int q_offset, int N, float scale, int dtype,
          void* stream) {
  if (d != kD || Hkv <= 0 || Hq % Hkv != 0 || Tq <= 0 || Tk <= 0 ||
      window < 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return flash_t<float>(q, k, v, seg, cu, o, B, Hq, Hkv, Tq, Tk, window,
                          q_offset, N, scale, st);
  if (dtype == kBFloat16)
    return flash_t<__nv_bfloat16>(q, k, v, seg, cu, o, B, Hq, Hkv, Tq, Tk,
                                  window, q_offset, N, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int paged_t(const void* q, const void* k_pool, const void* v_pool,
            const void* table, const void* lengths, const void* cu,
            const void* rows, const void* past, void* o, int n_rows, int N,
            int Hq, int Hkv, int bs, int nb, float scale,
            cudaStream_t stream) {
  const int R = Hq / Hkv;
  if (cu == nullptr) {
    PagedDecode<T> p{static_cast<const T*>(q), static_cast<const T*>(k_pool),
                     static_cast<const T*>(v_pool),
                     static_cast<const int*>(table),
                     static_cast<const int*>(lengths), static_cast<T*>(o), Hq,
                     Hkv, bs, nb, scale};
    return launch_fwd<T>(p, n_rows * Hkv, 32 * R, 0, stream);
  }
  PagedPrefill<T> p{static_cast<const T*>(q), static_cast<const T*>(k_pool),
                    static_cast<const T*>(v_pool),
                    static_cast<const int*>(table),
                    static_cast<const int*>(cu), static_cast<const int*>(rows),
                    static_cast<const int*>(past), static_cast<T*>(o), N, Hq,
                    Hkv, bs, nb, scale};
  return launch_fwd<T>(p, n_rows * Hkv, 32 * R, 0, stream);
}

int paged(const void* q, const void* k_pool, const void* v_pool,
          const void* table, const void* lengths, const void* cu,
          const void* rows, const void* past, void* o, int n_rows, int N,
          int Hq, int Hkv, int d, int bs, int nb, float scale, int dtype,
          void* stream) {
  if (d != kD || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kWarps ||
      bs <= 0 || nb <= 0 || !aligned16(q) || !aligned16(k_pool) ||
      !aligned16(v_pool) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return paged_t<float>(q, k_pool, v_pool, table, lengths, cu, rows, past,
                          o, n_rows, N, Hq, Hkv, bs, nb, scale, st);
  if (dtype == kBFloat16)
    return paged_t<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, cu,
                                  rows, past, o, n_rows, N, Hq, Hkv, bs, nb,
                                  scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Every entry takes its family's narrow entry's arguments, with d == 256
// (the wrappers pad), and returns cudaGetLastError() after its one launch
// (cudaErrorInvalidValue, launching nothing, on arguments it does not
// take).  Token choice passes bs = 1 and T = 0 to the shared launchers.
extern "C" int repro_mosa_attention_wide(const void* q, const void* k,
                                         const void* v, const void* idx,
                                         const void* seg, const void* r,
                                         void* o, int BH, int S, int d,
                                         float scale, int dtype,
                                         void* stream) {
  if (r == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return mosa_fwd<false>(q, k, v, idx, seg, r, o, nullptr, nullptr, BH, S, d,
                         1, 0, scale, dtype, stream);
}

extern "C" int repro_mosa_attention_fwd_res_wide(const void* q, const void* k,
                                                 const void* v,
                                                 const void* idx,
                                                 const void* seg, void* o_pre,
                                                 void* lse, int BH, int S,
                                                 int d, float scale,
                                                 int dtype, void* stream) {
  return mosa_fwd<false>(q, k, v, idx, seg, nullptr, nullptr, o_pre, lse, BH,
                         S, d, 1, 0, scale, dtype, stream);
}

extern "C" int repro_mosa_block_attention_wide(
    const void* q, const void* k, const void* v, const void* bidx,
    const void* seg, const void* rblk, void* o, int BH, int S, int d, int bs,
    int T, float scale, int dtype, void* stream) {
  if (rblk == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return mosa_fwd<true>(q, k, v, bidx, seg, rblk, o, nullptr, nullptr, BH, S,
                        d, bs, T, scale, dtype, stream);
}

extern "C" int repro_mosa_block_attention_fwd_res_wide(
    const void* q, const void* k, const void* v, const void* bidx,
    const void* seg, void* o_pre, void* lse, int BH, int S, int d, int bs,
    int T, float scale, int dtype, void* stream) {
  return mosa_fwd<true>(q, k, v, bidx, seg, nullptr, nullptr, o_pre, lse, BH,
                        S, d, bs, T, scale, dtype, stream);
}

extern "C" int repro_mosa_attention_bwd_dq_wide(
    const void* q, const void* k, const void* v, const void* idx,
    const void* seg, const void* gt, const void* lse, const void* delta,
    void* dq, int BH, int S, int d, float scale, int dtype, void* stream) {
  return mosa_bwd<false>(q, k, v, idx, seg, gt, lse, delta, dq, nullptr,
                         nullptr, BH, S, d, 1, 0, scale, dtype, stream);
}

extern "C" int repro_mosa_attention_bwd_dkv_wide(
    const void* q, const void* k, const void* v, const void* idx,
    const void* seg, const void* gt, const void* lse, const void* delta,
    void* dk, void* dv, int BH, int S, int d, float scale, int dtype,
    void* stream) {
  if (dk == nullptr || dv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return mosa_bwd<false>(q, k, v, idx, seg, gt, lse, delta, nullptr, dk, dv,
                         BH, S, d, 1, 0, scale, dtype, stream);
}

extern "C" int repro_mosa_block_attention_bwd_dq_wide(
    const void* q, const void* k, const void* v, const void* bidx,
    const void* seg, const void* gt, const void* lse, const void* delta,
    void* dq, int BH, int S, int d, int bs, int T, float scale, int dtype,
    void* stream) {
  return mosa_bwd<true>(q, k, v, bidx, seg, gt, lse, delta, dq, nullptr,
                        nullptr, BH, S, d, bs, T, scale, dtype, stream);
}

extern "C" int repro_mosa_block_attention_bwd_dkv_wide(
    const void* q, const void* k, const void* v, const void* bidx,
    const void* seg, const void* gt, const void* lse, const void* delta,
    void* dk, void* dv, int BH, int S, int d, int bs, int T, float scale,
    int dtype, void* stream) {
  if (dk == nullptr || dv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return mosa_bwd<true>(q, k, v, bidx, seg, gt, lse, delta, nullptr, dk, dv,
                        BH, S, d, bs, T, scale, dtype, stream);
}

extern "C" int repro_flash_attention_wide(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int Hq, int Hkv, int Tq, int Tk,
                                          int d, int window, int q_offset,
                                          float scale, int dtype,
                                          void* stream) {
  return flash(q, k, v, nullptr, nullptr, o, B, Hq, Hkv, Tq, Tk, d, window,
               q_offset, 0, scale, dtype, stream);
}

extern "C" int repro_flash_attention_varlen_wide(const void* q, const void* k,
                                                 const void* v,
                                                 const void* seg,
                                                 const void* cu, void* o,
                                                 int total, int N, int Hq,
                                                 int Hkv, int d, int window,
                                                 float scale, int dtype,
                                                 void* stream) {
  if (N <= 0 || seg == nullptr || cu == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return flash(q, k, v, seg, cu, o, 1, Hq, Hkv, total, total, d, window, 0, N,
               scale, dtype, stream);
}

extern "C" int repro_paged_attention_decode_wide(const void* q,
                                                 const void* k_pool,
                                                 const void* v_pool,
                                                 const void* block_table,
                                                 const void* lengths, void* o,
                                                 int B, int Hq, int Hkv,
                                                 int d, int bs, int nb,
                                                 float scale, int dtype,
                                                 void* stream) {
  return paged(q, k_pool, v_pool, block_table, lengths, nullptr, nullptr,
               nullptr, o, B, 0, Hq, Hkv, d, bs, nb, scale, dtype, stream);
}

// `ws` is unused (the narrow entry's split workspace): one launch writes
// every token's output, zeros for padding and inactive segments.
extern "C" int repro_paged_prefill_attention_wide(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* cu, const void* rows,
    const void* past_lens, void* o, void* ws, int total, int N, int Hq,
    int Hkv, int d, int bs, int nb, float scale, int dtype, void* stream) {
  (void)ws;
  if (N <= 0 || total <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return paged(q, k_pool, v_pool, block_table, nullptr, cu, rows, past_lens,
               o, total, N, Hq, Hkv, d, bs, nb, scale, dtype, stream);
}
