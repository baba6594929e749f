// MoSA attention over the expert-choice-selected tokens, written by hand for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/mosa_attention.py: `_mosa_kernel`
// (:55, launched by `mosa_attention_pallas`, :163) and, as the `kResiduals`
// form of the same template, `_mosa_fwd_res_kernel` (:110, launched by
// `mosa_attention_fwd_res`, :204).  For every (batch, head) row of S
// selected tokens it computes
//
//   o[q] = r[q] * sum_k softmax_k(scale * q.k  masked) v[k],
//   mask = seg_q == seg_k  &&  idx_q >= idx_k  &&  idx_k >= 0.
//
// Masked scores are -1e30 and their probabilities are zeroed, and the
// denominator is floored at 1e-30, so a row with no valid key (or r == 0)
// gives exact zeros.  `seg == nullptr` means one segment.
//
// The training form (`kResiduals`) writes no `o`: it writes the residuals
// the backward (mosa_backward.cu) needs, `o_pre[q] = o[q] / r[q]` in fp32
// (not scaled by r, so it survives rows with r == 0: the router gradient
// dr = rowsum(g * o_pre) needs it) and `lse[q] = m + log(max(l, 1e-30))`.
// An empty row has m = -1e30, so its lse is ~-1e30 too; the backward
// re-applies the mask rather than trusting exp(s - lse) there.
//
// Block choice (`kBlock`) is the same template with one index and one
// router score per selected KV block of `bs` tokens.  It replaces the TPU
// kernels of src/repro/kernels/mosa_block.py: `_mosa_block_kernel` (:67,
// launched by `mosa_block_attention_pallas`, :297) and, with `kResiduals`,
// `_mosa_block_fwd_res_kernel` (:128, launched by
// `mosa_block_attention_fwd_res`, :334).  `idx` is then the block table
// (BH, S / bs) and `r` the block scores (BH, S / bs); selected row j sits
// at pos = idx[j / bs] * bs + j % bs and is a valid key iff its block is
// not empty and pos < seq_len.  The mask becomes seg_q == seg_k && pos_q
// >= pos_k && valid_k, the output row is scaled by its block's score, and
// an invalid query row (an empty block, or the ragged tail past seq_len)
// is written as zeros, in `o` and in `o_pre`.  At bs = 1 every staged value
// and every float operation is the token form's, on either route, so the
// two agree bit for bit.
//
// What bounds it on an H100: at the serving and training shapes (S = k =
// 32 selected tokens, d = 64) the work is ~2 S*S*d FMAs per row against
// 4 S*d elements moved, so the kernels are bound by device-memory bytes (q,
// k, v read once, o written once; 0.0218 ms at the slice's 2208 rows),
// not by operations.  Two routes, chosen by the Python wrappers:
//
//   * the one-row kernel (`mosa_fwd_row_kernel`, S <= 64 and d <= 128:
//     every slice shape), the forward counterpart of the fused backward:
//     one block of 4 warps per row holds the whole row.  mosa_row.cuh
//     stages q, k and v with 16-byte cp.async (block choice: the NB-entry
//     block table and block scores too, expanded once in shared memory
//     into query positions, key positions and per-row scores), so the
//     write-out reads nothing from device memory but writes its output.
//     S = q k^T runs as 2 x 4 register micro-tiles (16-byte shared loads,
//     5.3 FMAs per load), the softmax is exact over the whole row (max,
//     exp and sum, no running correction; P^T stays in shared memory), and
//     O = P V as 4 x 4 micro-tiles (8 FMAs per load) written once with
//     16-byte stores.  At the slice a block takes ~31 KB of shared memory,
//     so ~7 rows are resident per SM and overlap one another's copies with
//     their compute.  The arithmetic is the TPU kernel's and the streaming
//     kernel's (q scaled first, scores summed over d in order, P V summed
//     over the keys in order, o = acc / max(l, 1e-30) * r), so at S <= 32,
//     one key tile of the streaming kernel, the two routes agree bit for
//     bit;
//   * the streaming kernel (`mosa_fwd_stream_kernel`, any S; the route for
//     S > 64, e.g. the IsoFLOP sweep's mosa8 point: 8 x 69 rows of S = k =
//     128, d = 64).  Bytes bound it there too: q, k, v read once, o_pre
//     and lse written once, ~73 MB, 0.0218 ms at 3.35 TB/s, against 1.167
//     GFLOP of valid pairs, 0.017 ms at 67 TFLOP/s.  The design is the
//     split dq's (mosa_backward.cu) with one product fewer and the TPU
//     kernel's online softmax:
//       - one block of 4 warps per (row, owned tile of 64 queries), the
//         last (heaviest) tile launched first.  Each output element is
//         written by one block and summed in a fixed order, without
//         atomics, so two launches are bitwise equal;
//       - q is copied once with 16-byte cp.async (mosa_row.cuh's
//         stage_rows) into the second key stage, free until the second
//         tile, and scaled into an fp32 tile; K and V stream in tiles of 32
//         keys through two cp.async stages, the next needed tile's copies
//         in flight while this one computes.  Rows whose d or pointers do
//         not allow 16-byte copies take plain loads; bf16 is staged as
//         bf16 and widened as it is read;
//       - key tiles no query of the block can see are skipped by value
//         before they are copied (mosa_tiles.cuh's plan_tiles, shared with
//         the split backward; idx need not be sorted): at mosa8 a quarter
//         of the tile pairs;
//       - per tile, S = (scale q) k^T as 4 x 4 register micro-tiles and,
//         in the same registers, the running max, the correction
//         exp(m_prev - m_new) and the sum of each query row (a row's 32
//         keys lie in one quarter-warp: 3 shuffles, no pass over shared
//         memory; a warp per row, as the one-row kernel's softmax, cost
//         over a third of the time, PERF.md), then O = corr O + P V as 8 x
//         4 micro-tiles held in registers across all tiles and written
//         once with 16-byte stores.  The products are bound by shared-
//         memory loads, not FMAs (PERF.md), so the 8 lanes of a
//         quarter-warp share the owned operand's address: 8 loads per 64
//         FMAs in S, 12 per 128 in P V.  Tensor cores are not used: TF32
//         breaks the 2e-5 fp32 tolerance;
//       - ~62 KB of shared memory and at most 168 registers a block at
//         d <= 64 (3 blocks an SM), ~110 KB at d up to 128 (2).
//     Each score is summed over d in order, each output element over the
//     keys in order by one thread, and each row sum takes the tree of the
//     one-row kernel's warp_sum, so at S <= 32 (one key tile) the routes
//     agree bit for bit.  Block choice expands each key tile's positions
//     from the staged span of its block table (bs may exceed the 32-key
//     tile).
//
// Rows are independent, so either grid has B*H blocks or more (2208 on the
// slice), enough to fill 132 SMs several times over.  Unlike the TPU
// version nothing is padded: S may be any length and d any width up to 128.

#include <stdint.h>

#include "common.cuh"
#include "mosa_row.cuh"
#include "mosa_tiles.cuh"

namespace {

using namespace repro;

// ------------------------------------------------ streaming kernel (any S)
constexpr int kStreamThreads = 128;  // 4 warps
constexpr int kSP = kStream + 4;     // row stride of the S/P scratch
static_assert(kOwn == 2 * kStream, "q is staged in one stage's K and V");

// Shared-memory layout of a streaming block for (S, d, element size):
// dpad = d rounded up to 4 (the width the products run over), dsT = the
// staged K and V row stride (16 bytes' worth of elements past the rounded
// width, RowLayout's), dsF = the scaled q tile's (fp32), nt = the number of
// key tiles.  The owned tile (q, then per query row m, l, the tile's
// correction, the router score, position and segment), two stages of a
// key tile (K, V, then per key its idx or block table and segment), the
// S/P scratch, then one byte per key tile (whether it is needed).
struct StreamLayout {
  int dpad, dsT, dsF, nt;
  size_t own_bytes, stage_bytes, bytes;
};

__host__ __device__ inline StreamLayout stream_layout(int S, int d,
                                                      int tsize) {
  StreamLayout L;
  const int vT = 16 / tsize;
  L.dpad = (d + 3) / 4 * 4;
  L.dsT = (d + vT - 1) / vT * vT + vT;
  L.dsF = L.dpad + 4;
  L.nt = (S + kStream - 1) / kStream;
  L.own_bytes = sizeof(float) * static_cast<size_t>(kOwn) * (L.dsF + 6);
  L.stage_bytes = static_cast<size_t>(2 * kStream) * L.dsT * tsize +
                  2 * kStream * sizeof(int);
  L.bytes = L.own_bytes + 2 * L.stage_bytes +
            sizeof(float) * kOwn * kSP + (L.nt + 15) / 16 * 16;
  return L;
}

// One block per (row, owned tile of 64 queries), the last (heaviest) tile
// launched first.  The block stages its queries once (scaled to fp32) and
// streams the keys' K and V in tiles of 32 through two cp.async stages,
// skipping by value the tiles no query of the block can see (plan_tiles);
// per needed tile:
//   phase A: S = (scale q) k^T as 4 x 4 register micro-tiles (queries
//            a0..a0+3, keys aj + 8 m; each score summed over d in order,
//            dot4 by dot4), then, still in registers, the running softmax
//            of those rows under the explicit mask: the 8 lanes of a
//            quarter-warp hold a row's 32 keys, so its max, the correction
//            exp(m_prev - m_new) and its sum reduce over the micro-tile
//            and 3 shuffles; P and the corrections go to shared memory;
//   phase B: O = corr * O + P V as 8 x 4 register micro-tiles (rows
//            b0..b0+7, columns bc + 64 w; each element summed by one thread
//            over the keys in order), held in registers across all tiles.
// The end divides by the floored sum, times the router score (or o_pre and
// lse), and writes each output element once with 16-byte stores.
template <typename T, bool kResiduals, bool kBlock, int kCW>
__global__ void __launch_bounds__(kStreamThreads, kCW == 1 ? 3 : 2)
mosa_fwd_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ idx,
                       const int* __restrict__ seg,
                       const float* __restrict__ r, T* __restrict__ o,
                       float* __restrict__ o_pre, float* __restrict__ lse,
                       int S, int d, float scale, bool vec, int bs,
                       int seq_len) {
  extern __shared__ float4 stream_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(stream_smem);
  const StreamLayout L = stream_layout(S, d, sizeof(T));
  float* qs = reinterpret_cast<float*>(base);  // [kOwn][dsF], scale * q
  float* m_o = qs + kOwn * L.dsF;              // the row max, at the end
  float* l_o = m_o + kOwn;                     // the row sum, at the end
  float* corr_o = l_o + kOwn;                  // this tile's correction
  float* score_o = corr_o + kOwn;              // router score (#1, #5)
  int* pos_o = reinterpret_cast<int*>(score_o + kOwn);
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
  float* sp = reinterpret_cast<float*>(base + L.own_bytes +
                                       2 * L.stage_bytes);  // [kOwn][kSP]
  unsigned char* need = reinterpret_cast<unsigned char*>(sp + kOwn * kSP);

  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const size_t row0 = row * S;
  const int o0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  const int no = min(kOwn, S - o0);

  // q lands in its dtype in stage 1's K and V ([kOwn][dsT]), free until
  // the second needed tile is issued; the router scores beside it.
  T* qt = stage(1).k;
  stage_rows(qt, L.dsT, q + (row0 + o0) * d, no, d, vec, tid,
             kStreamThreads);
  if constexpr (!kResiduals)
    for (int i = tid; i < no; i += kStreamThreads)
      cp_async4(score_o + i, kBlock ? r + row * (S / bs) + (o0 + i) / bs
                                    : r + row0 + o0 + i);
  cp_async_commit();
  // Columns d..dpad-1 are never copied, nor is seg when there is none
  // (every key in segment 0): zeros.
  if (d < L.dpad)
    for (int s = 0; s < 2; ++s) {
      zero_rect<kStreamThreads>(stage(s).k, L.dsT, 0, kStream, d, L.dpad);
      zero_rect<kStreamThreads>(stage(s).v, L.dsT, 0, kStream, d, L.dpad);
    }
  if (!seg && tid < 2 * kStream) stage(tid / kStream).seg[tid % kStream] = 0;
  plan_tiles<kBlock, true, kStreamThreads>(idx, seg, row, S, o0, bs, seq_len,
                                           pos_o, seg_o, need, L.nt);

  // Rows past S of a ragged tile are zeros: P V multiplies them by 0.
  auto issue = [&](int t, int s) {
    const int s0 = t * kStream, ns = min(kStream, S - s0);
    const Stage st = stage(s);
    T* const kv[2] = {st.k, st.v};
    const T* const src[2] = {k + (row0 + s0) * d, v + (row0 + s0) * d};
    stage_rows(kv, L.dsT, src, ns, d, vec, tid, kStreamThreads);
    stage_meta<kBlock>(st.pos, st.seg, idx, seg, row, S, s0, ns, bs);
    if (ns < kStream) {
      zero_rect<kStreamThreads>(st.k, L.dsT, ns, kStream, 0, L.dpad);
      zero_rect<kStreamThreads>(st.v, L.dsT, ns, kStream, 0, L.dpad);
    }
  };

  int cur = next_tile(need, -1, L.nt);
  if (cur < L.nt) issue(cur, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();  // q and the first needed tile have landed
  // q scaled first, in fp32, as the one-row kernel and the TPU kernel do;
  // rows past S are zeros
  for (int i = tid; i < kOwn * L.dpad / 4; i += kStreamThreads) {
    const int rr = i / (L.dpad / 4);
    const int c = (i - rr * (L.dpad / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rr < no) {
      x = ld4(qt + rr * L.dsT + c);
      x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
    *reinterpret_cast<float4*>(qs + rr * L.dsF + c) = x;
  }

  // Phase A's micro-tile: rows a0..a0+3, keys aj + 8 m (the 8 lanes of a
  // quarter-warp hold a row's 32 keys); phase B's: rows b0..b0+7, columns
  // bc + 64 w.  m_r and l_r, each row's running max and sum, are the same
  // in the 8 lanes of its quarter-warp.
  const int a0 = (tid / 8) * 4, aj = tid % 8;
  const int b0 = (tid / 16) * 8, bc = (tid % 16) * 4;
  float m_r[4] = {kNegInf, kNegInf, kNegInf, kNegInf}, l_r[4] = {};
  float acc[kCW][8][4] = {};
  for (int s = 0; cur < L.nt; s ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // tile cur landed; the other stage and S/P are free
    const int nxt = next_tile(need, cur, L.nt);
    if (nxt < L.nt) issue(nxt, s ^ 1);
    cp_async_commit();
    const Stage st = stage(s);
    const int s0 = cur * kStream, ns = min(kStream, S - s0);

    // Phase A: the 8 lanes of a quarter-warp share their queries (one
    // address) and read 8 key rows that start 4 banks apart.
    {
      float sc[4][4] = {};
#pragma unroll 2
      for (int c = 0; c < L.dpad; c += 4) {
        float4 x[4], y[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) x[a] = ld4(qs + (a0 + a) * L.dsF + c);
#pragma unroll
        for (int m = 0; m < 4; ++m) y[m] = ld4(st.k + (aj + 8 * m) * L.dsT + c);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int m = 0; m < 4; ++m) sc[a][m] = dot4(x[a], y[m], sc[a][m]);
      }

      // The running softmax of rows a0..a0+3 over this tile, under the
      // explicit mask (a masked score is -1e30, and exp(-1e30 - m) is not 0
      // in a row with no valid key yet).  The row max and sum reduce over
      // m in registers, then over the quarter-warp's 8 lanes with
      // shuffles: the tree of warp_sum over a warp whose lane j holds key
      // j (the one-row kernel's), key j + 16 added first, then j + 8.
      int kp[4], ks[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = aj + 8 * m;
        bool valid;
        const int pj = tile_pos<kBlock>(st.pos, s0, j, bs, seq_len, valid);
        kp[m] = (j < ns && valid) ? pj : -1;
        ks[m] = st.seg[j];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = a0 + a;
        const int iq = pos_o[i], sq = seg_o[i];
        bool ok[4];
        float x[4], pr[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          ok[m] = pair_ok(iq, sq, kp[m], ks[m]);
          x[m] = ok[m] ? sc[a][m] : kNegInf;
        }
        float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
#pragma unroll
        for (int o = 4; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));
        const float m_new = fmaxf(m_r[a], mx);
#pragma unroll
        for (int m = 0; m < 4; ++m) pr[m] = ok[m] ? expf(x[m] - m_new) : 0.f;
        const float corr = expf(m_r[a] - m_new);
        float sum = (pr[0] + pr[2]) + (pr[1] + pr[3]);
#pragma unroll
        for (int o = 4; o > 0; o >>= 1)
          sum += __shfl_xor_sync(kFullMask, sum, o);
        m_r[a] = m_new;
        l_r[a] = l_r[a] * corr + sum;
#pragma unroll
        for (int m = 0; m < 4; ++m) sp[i * kSP + aj + 8 * m] = pr[m];
        if (aj == 0) corr_o[i] = corr;
      }
    }
    __syncthreads();  // P and the corrections

    // Phase B: a quarter-warp shares its rows of P (one address) and reads
    // 8 neighbouring column groups of V.
    {
      const float4 c4[2] = {ld4(corr_o + b0), ld4(corr_o + b0 + 4)};
      const float cr[8] = {c4[0].x, c4[0].y, c4[0].z, c4[0].w,
                           c4[1].x, c4[1].y, c4[1].z, c4[1].w};
#pragma unroll
      for (int w = 0; w < kCW; ++w)
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[w][a][b] *= cr[a];
#pragma unroll 2
      for (int j = 0; j < kStream; j += 4) {
        float pa[8][4];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float4 p4 = ld4(sp + (b0 + a) * kSP + j);
          pa[a][0] = p4.x;
          pa[a][1] = p4.y;
          pa[a][2] = p4.z;
          pa[a][3] = p4.w;
        }
#pragma unroll
        for (int w = 0; w < kCW; ++w) {
          const int c = bc + 64 * w;
          if (c >= L.dpad) continue;
#pragma unroll
          for (int u = 0; u < 4; ++u) {  // keys j + u, in order
            const float4 v4 = ld4(st.v + (j + u) * L.dsT + c);
            const float vb[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b)
                acc[w][a][b] = fmaf(pa[a][u], vb[b], acc[w][a][b]);
          }
        }
      }
    }
    cur = nxt;
  }
  if (aj == 0)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      m_o[a0 + a] = m_r[a];
      l_o[a0 + a] = l_r[a];
    }
  __syncthreads();  // every row's m and l

  // Block choice: an invalid query row (an empty block, or past seq_len;
  // its raw position says which) is 0.
#pragma unroll
  for (int w = 0; w < kCW; ++w) {
    const int c = bc + 64 * w;
    if (c >= L.dpad) continue;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = b0 + a;
      if (i >= no) continue;
      const bool valid =
          !kBlock || (pos_o[i] >= 0 && pos_o[i] < seq_len);
      const float den = fmaxf(l_o[i], 1e-30f);
      float out[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float x = acc[w][a][b] / den;
        out[b] = valid ? (kResiduals ? x : x * score_o[i]) : 0.f;
      }
      const size_t at = (row0 + o0 + i) * d + c;
      if constexpr (kResiduals) {
        if (vec && c + 4 <= d) {
          st4(o_pre + at, out);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c + b < d) o_pre[at + b] = out[b];
        }
      } else {
        if (vec && c + 4 <= d) {
          st4(o + at, out);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c + b < d) store_as(o + at + b, out[b]);
        }
      }
    }
  }
  if constexpr (kResiduals)
    for (int i = tid; i < no; i += kStreamThreads)
      lse[row0 + o0 + i] = m_o[i] + logf(fmaxf(l_o[i], 1e-30f));
}

// Grid (BH, ceil(S / 64)) of 128 threads; kCW (phase B's groups of 64
// columns) from d.
template <typename T, bool kResiduals, bool kBlock>
int launch(const void* q, const void* k, const void* v, const void* idx,
           const void* seg, const void* r, void* o, void* o_pre, void* lse,
           int BH, int S, int d, float scale, int bs, int seq_len,
           cudaStream_t stream) {
  if (S < 1 || d < 1 || d > kRowMaxD || BH < 0 || bs < 1 || S % bs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaSuccess);
  const StreamLayout L = stream_layout(S, d, sizeof(T));
  const bool vec = d % (16 / sizeof(T)) == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v) &&
                   aligned16(kResiduals ? o_pre : o);
  auto* kernel = L.dpad <= 64
                     ? mosa_fwd_stream_kernel<T, kResiduals, kBlock, 1>
                     : mosa_fwd_stream_kernel<T, kResiduals, kBlock, 2>;
  const cudaError_t err = allow_smem(kernel, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (S + kOwn - 1) / kOwn);
  kernel<<<grid, kStreamThreads, L.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(r),
      static_cast<T*>(o), static_cast<float*>(o_pre),
      static_cast<float*>(lse), S, d, scale, vec, bs, seq_len);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ one row per block (S <= 64)
// mosa_row.cuh stages the row (q, k, v, each row's key and query position,
// segment and router score); then
//   phase A: S = (scale q) k^T as 2 x 4 register micro-tiles (queries i0,
//            i0+1; keys j0 + m Sp/4), masked, into scratch as S^T;
//   softmax: warp w takes rows w, w+4, ...; lane j keys j and j+32: the
//            row's max, exp and sum over all its keys at once (no running
//            correction); P^T replaces S^T in place;
//   phase B: O = P V as 4 x 4 register micro-tiles (rows r0..r0+3,
//            columns c0..c0+3; one 16-byte load of P^T and one of V per 16
//            FMAs), divided by the denominator, times the router score (or
//            o_pre and lse), written once with 16-byte stores.
template <typename T, bool kResiduals, bool kBlock>
__global__ void __launch_bounds__(kRowThreads)
mosa_fwd_row_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ idx,
                    const int* __restrict__ seg, const float* __restrict__ r,
                    T* __restrict__ o, float* __restrict__ o_pre,
                    float* __restrict__ lse, int S, int d, float scale,
                    bool vec, int bs, int seq_len) {
  extern __shared__ float4 row_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(row_smem);
  const RowLayout L = row_layout(S, d, sizeof(T), kBlock, false);
  const RowStage<T, kBlock, false> st(smem, L);
  float* Pt = reinterpret_cast<float*>(smem + L.stage_bytes);  // [Sp][ps]
  float* m_row = Pt + L.Sp * L.ps;                            // [Sp]
  float* l_row = m_row + L.Sp;                                // [Sp]
  const int nkg = L.Sp / 4;    // groups of 4 keys (phase A), of 4 rows (B)
  const int nqg = L.Sp / 2;    // pairs of queries (phase A)
  const int ncg = L.dpad / 4;  // groups of 4 columns (phase B)
  const size_t row = blockIdx.x;

  fetch_row(st, L, q, k, v, nullptr, nullptr, nullptr,
            kResiduals ? nullptr : r, idx, seg, row, S, d, vec, bs);
  cp_async_commit();
  zero_row_padding(st, L, S, d, seg != nullptr);
  cp_async_wait_all();
  __syncthreads();
  if constexpr (kBlock) {
    expand_row_blocks(st, S, bs, seq_len, !kResiduals);
    __syncthreads();
  }

  // Phase A: scores, a 2 x 4 micro-tile per thread, stored transposed.
  for (int t = threadIdx.x; t < nqg * nkg; t += kRowThreads) {
    const int i0 = (t / nkg) * 2;
    const int j0 = t % nkg;
    float s[2][4] = {};
    for (int c = 0; c < L.dpad; c += 4) {
      float4 qa[2], kb[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {  // q scaled first, as the TPU kernel does
        qa[a] = ld4(st.q + (i0 + a) * L.dsT + c);
        qa[a] = make_float4(qa[a].x * scale, qa[a].y * scale,
                            qa[a].z * scale, qa[a].w * scale);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) kb[m] = ld4(st.k + (j0 + m * nkg) * L.dsT + c);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int m = 0; m < 4; ++m) s[a][m] = dot4(qa[a], kb[m], s[a][m]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int i = i0 + a;
      const bool q_ok = i < S;
      const int iq = q_ok ? st.pos[i] : -1;
      const int sq = q_ok ? st.seg[i] : 0;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = j0 + m * nkg;
        const bool ok = q_ok && j < S && pair_ok(iq, sq, st.idx[j], st.seg[j]);
        Pt[j * L.ps + i] = ok ? s[a][m] : kNegInf;
      }
    }
  }
  __syncthreads();

  // Softmax over each whole row; the mask is applied again (a masked
  // score is -1e30, and exp(-1e30 - m) is not 0 in an empty row).
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < S; i += kRowThreads / 32) {
    const int iq = st.pos[i], sq = st.seg[i];
    bool ok[2];
    float x[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      ok[h] = j < S && pair_ok(iq, sq, st.idx[j], st.seg[j]);
      x[h] = j < S ? Pt[j * L.ps + i] : kNegInf;
    }
    const float mx = warp_max(fmaxf(x[0], x[1]));
    float p[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) p[h] = ok[h] ? expf(x[h] - mx) : 0.f;
    const float sum = warp_sum(p[0] + p[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (lane + 32 * h < S) Pt[(lane + 32 * h) * L.ps + i] = p[h];
    if (lane == 0) {
      m_row[i] = mx;
      l_row[i] = sum;
    }
  }
  __syncthreads();

  // Phase B: O = P V, a 4 x 4 micro-tile per thread, written once.
  const size_t base = row * S;
  for (int t = threadIdx.x; t < nkg * ncg; t += kRowThreads) {
    const int r0 = (t / ncg) * 4;
    const int c0 = (t % ncg) * 4;
    float acc[4][4] = {};
    for (int u = 0; u < S; ++u) {
      const float4 p4 = ld4(Pt + u * L.ps + r0);  // P[r0 + a][u]
      const float4 v4 = ld4(st.v + u * L.dsT + c0);
      const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
      const float vb[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(pa[a], vb[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = r0 + a;
      if (i >= S) continue;
      // block choice: an invalid query row (its key position is -1) is 0
      const bool valid = !kBlock || st.idx[i] >= 0;
      const float den = fmaxf(l_row[i], 1e-30f);
      float out[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float x = acc[a][b] / den;
        out[b] = valid ? (kResiduals ? x : x * st.score[i]) : 0.f;
      }
      if constexpr (kResiduals) {
        float* dst = o_pre + (base + i) * d + c0;
        if (vec && c0 + 4 <= d) {
          st4(dst, out);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c0 + b < d) dst[b] = out[b];
        }
      } else {
        T* dst = o + (base + i) * d + c0;
        if (vec && c0 + 4 <= d) {
          st4(dst, out);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c0 + b < d) store_as(dst + b, out[b]);
        }
      }
    }
  }
  if constexpr (kResiduals)
    for (int i = threadIdx.x; i < S; i += kRowThreads)
      lse[base + i] = m_row[i] + logf(fmaxf(l_row[i], 1e-30f));
}

// One block per row.
template <typename T, bool kResiduals, bool kBlock>
int launch_row(const void* q, const void* k, const void* v, const void* idx,
               const void* seg, const void* r, void* o, void* o_pre,
               void* lse, int BH, int S, int d, float scale, int bs,
               int seq_len, cudaStream_t stream) {
  if (S < 1 || S > kRowMaxS || d < 1 || d > kRowMaxD || BH < 0 || bs < 1 ||
      S % bs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaSuccess);
  const RowLayout L = row_layout(S, d, sizeof(T), kBlock, false);
  const size_t smem = L.stage_bytes + L.scratch_bytes;
  const bool vec = d % (16 / sizeof(T)) == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v) &&
                   aligned16(kResiduals ? o_pre : o);
  auto* kernel = mosa_fwd_row_kernel<T, kResiduals, kBlock>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<BH, kRowThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(r),
      static_cast<T*>(o), static_cast<float*>(o_pre),
      static_cast<float*>(lse), S, d, scale, vec, bs, seq_len);
  return static_cast<int>(cudaGetLastError());
}

// The launch of the one-row kernel (`one_row`) or the streaming one for
// `dtype` (see common.cuh), or cudaErrorInvalidValue.
template <bool kResiduals, bool kBlock>
int launch_dtype(bool one_row, int dtype, const void* q, const void* k,
                 const void* v, const void* idx, const void* seg,
                 const void* r, void* o, void* o_pre, void* lse, int BH,
                 int S, int d, float scale, int bs, int seq_len,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_MOSA_LAUNCH(T)                                                  \
  return (one_row ? launch_row<T, kResiduals, kBlock>                         \
                  : launch<T, kResiduals, kBlock>)(q, k, v, idx, seg, r, o,   \
                                                   o_pre, lse, BH, S, d,      \
                                                   scale, bs, seq_len, st)
  if (dtype == kFloat32) REPRO_MOSA_LAUNCH(float);
  if (dtype == kBFloat16) REPRO_MOSA_LAUNCH(__nv_bfloat16);
#undef REPRO_MOSA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each entry below launches the streaming kernel (any S); its `_row` twin
// launches the one-row kernel (1 <= S <= 64, d <= 128, else
// cudaErrorInvalidValue) on the same arguments.  The wrappers in
// kernels/mosa_attention.py and kernels/mosa_block.py pick the route.

// q, k, v, o: (BH, S, d) contiguous in `dtype`; idx, seg: (BH, S) int32
// (seg may be null); r: (BH, S) float32.  Returns cudaGetLastError().
extern "C" int repro_mosa_attention(const void* q, const void* k, const void* v,
                                    const void* idx, const void* seg,
                                    const void* r, void* o, int BH, int S,
                                    int d, float scale, int dtype,
                                    void* stream) {
  return launch_dtype<false, false>(false, dtype, q, k, v, idx, seg, r, o,
                                    nullptr, nullptr, BH, S, d, scale, 1, 0,
                                    stream);
}

extern "C" int repro_mosa_attention_row(const void* q, const void* k,
                                        const void* v, const void* idx,
                                        const void* seg, const void* r,
                                        void* o, int BH, int S, int d,
                                        float scale, int dtype, void* stream) {
  return launch_dtype<false, false>(true, dtype, q, k, v, idx, seg, r, o,
                                    nullptr, nullptr, BH, S, d, scale, 1, 0,
                                    stream);
}

// Training forward: q, k, v as above; o_pre: (BH, S, d) float32 and lse:
// (BH, S) float32 are written (no router scaling, no `o`).  Returns
// cudaGetLastError().
extern "C" int repro_mosa_attention_fwd_res(const void* q, const void* k,
                                            const void* v, const void* idx,
                                            const void* seg, void* o_pre,
                                            void* lse, int BH, int S, int d,
                                            float scale, int dtype,
                                            void* stream) {
  return launch_dtype<true, false>(false, dtype, q, k, v, idx, seg, nullptr,
                                   nullptr, o_pre, lse, BH, S, d, scale, 1, 0,
                                   stream);
}

extern "C" int repro_mosa_attention_fwd_res_row(const void* q, const void* k,
                                                const void* v,
                                                const void* idx,
                                                const void* seg, void* o_pre,
                                                void* lse, int BH, int S,
                                                int d, float scale, int dtype,
                                                void* stream) {
  return launch_dtype<true, false>(true, dtype, q, k, v, idx, seg, nullptr,
                                   nullptr, o_pre, lse, BH, S, d, scale, 1, 0,
                                   stream);
}

// Block choice (kernel #5): q, k, v, o: (BH, S, d) with S = NB * bs; bidx:
// (BH, NB) int32 block indices (-1 = empty); seg: (BH, S) int32 or null;
// rblk: (BH, NB) float32 block scores; T: the true sequence length.
extern "C" int repro_mosa_block_attention(const void* q, const void* k,
                                          const void* v, const void* bidx,
                                          const void* seg, const void* rblk,
                                          void* o, int BH, int S, int d,
                                          int bs, int T, float scale,
                                          int dtype, void* stream) {
  return launch_dtype<false, true>(false, dtype, q, k, v, bidx, seg, rblk, o,
                                   nullptr, nullptr, BH, S, d, scale, bs, T,
                                   stream);
}

extern "C" int repro_mosa_block_attention_row(const void* q, const void* k,
                                              const void* v, const void* bidx,
                                              const void* seg,
                                              const void* rblk, void* o,
                                              int BH, int S, int d, int bs,
                                              int T, float scale, int dtype,
                                              void* stream) {
  return launch_dtype<false, true>(true, dtype, q, k, v, bidx, seg, rblk, o,
                                   nullptr, nullptr, BH, S, d, scale, bs, T,
                                   stream);
}

// Block-choice training forward (kernel #6): inputs as above without rblk;
// writes o_pre (BH, S, d) and lse (BH, S), float32, o_pre zero on invalid
// query rows.
extern "C" int repro_mosa_block_attention_fwd_res(
    const void* q, const void* k, const void* v, const void* bidx,
    const void* seg, void* o_pre, void* lse, int BH, int S, int d, int bs,
    int T, float scale, int dtype, void* stream) {
  return launch_dtype<true, true>(false, dtype, q, k, v, bidx, seg, nullptr,
                                  nullptr, o_pre, lse, BH, S, d, scale, bs, T,
                                  stream);
}

extern "C" int repro_mosa_block_attention_fwd_res_row(
    const void* q, const void* k, const void* v, const void* bidx,
    const void* seg, void* o_pre, void* lse, int BH, int S, int d, int bs,
    int T, float scale, int dtype, void* stream) {
  return launch_dtype<true, true>(true, dtype, q, k, v, bidx, seg, nullptr,
                                  nullptr, o_pre, lse, BH, S, d, scale, bs, T,
                                  stream);
}
