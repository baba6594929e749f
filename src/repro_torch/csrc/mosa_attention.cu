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
//   * the streaming kernel (`mosa_attention_kernel`, any S; the route for
//     S > 64): one block per (row, tile of up to 64 queries) stages its
//     query tile and each 32-key tile of K and V in shared memory (fp32);
//     warp w owns queries w, w+4, ...: lane j scores key j (the key tile
//     has a padded row stride, so the 32 lanes hit 32 banks), the warp
//     reduces max and sum with shuffles (a running softmax over the key
//     tiles), and each lane accumulates the output columns it owns in a
//     shared accumulator.  Block choice expands each staged row's position
//     per element (bs may exceed the 32-key tile).
//
// Rows are independent, so either grid has B*H blocks or more (2208 on the
// slice), enough to fill 132 SMs several times over.  Unlike the TPU
// version nothing is padded: S may be any length and d any width up to 128.

#include <stdint.h>

#include "common.cuh"
#include "mosa_row.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 64;  // queries per thread block
constexpr int kBlockK = 32;  // keys per shared-memory tile (one per lane)

size_t smem_bytes(int rows, int d) {
  return sizeof(float) * (2 * static_cast<size_t>(rows) * d  // q tile, acc
                          + kBlockK * (d + 1) + kBlockK * d  // k, v tiles
                          + 2 * rows                         // m, l
                          + kWarps * 32)                     // p per warp
         + sizeof(int) * (2 * kBlockK + 2 * rows);           // idx, seg
}

template <typename T, bool kResiduals, bool kBlock>
__global__ void __launch_bounds__(kThreads)
mosa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ idx,
                      const int* __restrict__ seg, const float* __restrict__ r,
                      T* __restrict__ o, float* __restrict__ o_pre,
                      float* __restrict__ lse, int S, int d, int rows,
                      float scale, int bs, int seq_len) {
  extern __shared__ float smem[];
  const int dp = d + 1;  // padded row stride of the key tile
  float* qs = smem;                     // [rows][d], pre-scaled
  float* acc = qs + rows * d;           // [rows][d]
  float* ks = acc + rows * d;           // [kBlockK][d + 1]
  float* vs = ks + kBlockK * dp;        // [kBlockK][d]
  float* m = vs + kBlockK * d;          // [rows]
  float* l = m + rows;                  // [rows]
  float* pw = l + rows;                 // [kWarps][32]
  int* idx_k = reinterpret_cast<int*>(pw + kWarps * 32);  // [kBlockK]
  int* seg_k = idx_k + kBlockK;         // [kBlockK]
  int* idx_q = seg_k + kBlockK;         // [rows]
  int* seg_q = idx_q + rows;            // [rows]

  const size_t row = blockIdx.x;        // (b, h) row
  const size_t row0 = static_cast<size_t>(blockIdx.x) * S;
  const int q0 = blockIdx.y * kBlockQ;
  const int nq = min(kBlockQ, S - q0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qb = q + (row0 + q0) * d;
  for (int i = threadIdx.x; i < nq * d; i += kThreads) {
    qs[i] = to_float(qb[i]) * scale;
    acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < nq; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
    if constexpr (kBlock) {
      bool valid;
      idx_q[i] = sel_pos<kBlock>(idx, row, S, q0 + i, bs, seq_len, valid);
    } else {
      idx_q[i] = idx[row0 + q0 + i];
    }
    seg_q[i] = seg ? seg[row0 + q0 + i] : 0;
  }

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    const int nk = min(kBlockK, S - k0);
    __syncthreads();  // the previous tile is consumed (first pass: q is staged)
    const T* kb = k + (row0 + k0) * d;
    const T* vb = v + (row0 + k0) * d;
    for (int i = threadIdx.x; i < nk * d; i += kThreads) {
      const int j = i / d;
      ks[j * dp + (i - j * d)] = to_float(kb[i]);
      vs[i] = to_float(vb[i]);
    }
    if (threadIdx.x < nk) {
      if constexpr (kBlock) {
        bool valid;
        const int p = sel_pos<kBlock>(idx, row, S, k0 + threadIdx.x, bs,
                                      seq_len, valid);
        idx_k[threadIdx.x] = valid ? p : -1;
      } else {
        idx_k[threadIdx.x] = idx[row0 + k0 + threadIdx.x];
      }
      seg_k[threadIdx.x] = seg ? seg[row0 + k0 + threadIdx.x] : 0;
    }
    __syncthreads();

    const bool has_key = lane < nk;
    const int ik = has_key ? idx_k[lane] : -1;
    const int sk = has_key ? seg_k[lane] : 0;
    const float* kr = ks + lane * dp;
    for (int qi = warp; qi < nq; qi += kWarps) {
      const bool ok = has_key && ik >= 0 && idx_q[qi] >= ik && seg_q[qi] == sk;
      float s = kNegInf;
      if (ok) {
        const float* qr = qs + qi * d;
        float a = 0.f;
        for (int c = 0; c < d; ++c) a = fmaf(qr[c], kr[c], a);
        s = a;
      }
      const float m_prev = m[qi];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m_prev - m_new);
      const float p_sum = warp_sum(p);
      pw[warp * 32 + lane] = p;
      __syncwarp();
      float* ar = acc + qi * d;
      for (int c = lane; c < d; c += 32) {
        float a = ar[c] * corr;
        for (int j = 0; j < nk; ++j) a = fmaf(pw[warp * 32 + j], vs[j * d + c], a);
        ar[c] = a;
      }
      if (lane == 0) {
        m[qi] = m_new;
        l[qi] = l[qi] * corr + p_sum;
      }
      __syncwarp();  // pw and m/l are reused by this warp's next query
    }
  }
  __syncthreads();

  // Block choice zeroes invalid query rows; their validity and block
  // score are read again here, off the hot loop.
  if constexpr (kResiduals) {
    float* ob = o_pre + (row0 + q0) * d;
    if constexpr (kBlock) {
      for (int i = threadIdx.x; i < nq * d; i += kThreads) {
        bool valid;
        sel_pos<kBlock>(idx, row, S, q0 + i / d, bs, seq_len, valid);
        ob[i] = valid ? acc[i] / fmaxf(l[i / d], 1e-30f) : 0.f;
      }
    } else {
      for (int i = threadIdx.x; i < nq * d; i += kThreads)
        ob[i] = acc[i] / fmaxf(l[i / d], 1e-30f);
    }
    for (int i = threadIdx.x; i < nq; i += kThreads)
      lse[row0 + q0 + i] = m[i] + logf(fmaxf(l[i], 1e-30f));
  } else {
    T* ob = o + (row0 + q0) * d;
    for (int i = threadIdx.x; i < nq * d; i += kThreads) {
      const int qi = i / d;
      if constexpr (kBlock) {
        bool valid;
        sel_pos<kBlock>(idx, row, S, q0 + qi, bs, seq_len, valid);
        const float out = acc[i] / fmaxf(l[qi], 1e-30f) *
                          sel_score<kBlock>(r, row, S, q0 + qi, bs);
        store_as(ob + i, valid ? out : 0.f);
      } else {
        const float out = acc[i] / fmaxf(l[qi], 1e-30f) * r[row0 + q0 + qi];
        store_as(ob + i, out);
      }
    }
  }
}

template <typename T, bool kResiduals, bool kBlock>
int launch(const void* q, const void* k, const void* v, const void* idx,
           const void* seg, const void* r, void* o, void* o_pre, void* lse,
           int BH, int S, int d, float scale, int bs, int seq_len,
           cudaStream_t stream) {
  const int rows = S < kBlockQ ? S : kBlockQ;
  const size_t smem = smem_bytes(rows, d);
  cudaError_t err = allow_smem(mosa_attention_kernel<T, kResiduals, kBlock>,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (S + kBlockQ - 1) / kBlockQ);
  mosa_attention_kernel<T, kResiduals, kBlock><<<grid, kThreads, smem,
                                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(r),
      static_cast<T*>(o), static_cast<float*>(o_pre),
      static_cast<float*>(lse), S, d, rows, scale, bs, seq_len);
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
