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
//   mask = seg_q == seg_k  &&  idx_q >= idx_k  &&  idx_k >= 0,
//
// with a streaming softmax (running max, denominator and accumulator in
// fp32).  Masked scores are -1e30 and their probabilities are zeroed, and
// the denominator is floored at 1e-30, so a row with no valid key (or
// r == 0) gives exact zeros.  `seg == nullptr` means one segment.
//
// The training form (`kResiduals`) writes no `o`: it writes the residuals
// the backward (mosa_backward.cu) needs, `o_pre[q] = o[q] / r[q]` in fp32
// (not scaled by r, so it survives rows with r == 0: the router gradient
// dr = rowsum(g * o_pre) needs it) and `lse[q] = m + log(max(l, 1e-30))`.
// An empty row has m = -1e30, so its lse is ~-1e30 too; the backward
// re-applies the mask rather than trusting exp(s - lse) there.
//
// What bounds it on an H100: at the serving shapes (S = k = 32 selected
// tokens, d = 64) the work is ~S*S*d FMAs per row against 4*S*d elements
// moved, so the kernel is bound by device-memory bytes (q, k, v read once,
// o written once), not by operations.  The design therefore reads every
// input element from device memory exactly once: one thread block per
// (row, tile of up to 64 queries) stages its query tile and each 32-key
// tile of K and V in shared memory (fp32), and all query-key work runs out
// of shared memory.  Rows are independent, so the grid has B*H blocks
// (2208 on the slice) -- enough to fill 132 SMs several times over.  Unlike
// the TPU version nothing is padded: S may be any length (the ragged key
// tile masks its missing lanes, the ragged query tile computes no missing
// query) and d may be any width up to 128.
//
// Inside a block, warp w owns queries w, w+4, ...; for each key tile, lane
// j scores key j (the key tile is stored with a padded row stride, so the
// 32 lanes hit 32 banks), the warp reduces max and sum with shuffles, and
// each lane accumulates the output columns it owns.

#include <stdint.h>

#include "common.cuh"

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

template <typename T, bool kResiduals>
__global__ void __launch_bounds__(kThreads)
mosa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ idx,
                      const int* __restrict__ seg, const float* __restrict__ r,
                      T* __restrict__ o, float* __restrict__ o_pre,
                      float* __restrict__ lse, int S, int d, int rows,
                      float scale) {
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

  const size_t row0 = static_cast<size_t>(blockIdx.x) * S;  // (b, h) row
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
    idx_q[i] = idx[row0 + q0 + i];
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
      idx_k[threadIdx.x] = idx[row0 + k0 + threadIdx.x];
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

  if constexpr (kResiduals) {
    float* ob = o_pre + (row0 + q0) * d;
    for (int i = threadIdx.x; i < nq * d; i += kThreads)
      ob[i] = acc[i] / fmaxf(l[i / d], 1e-30f);
    for (int i = threadIdx.x; i < nq; i += kThreads)
      lse[row0 + q0 + i] = m[i] + logf(fmaxf(l[i], 1e-30f));
  } else {
    T* ob = o + (row0 + q0) * d;
    for (int i = threadIdx.x; i < nq * d; i += kThreads) {
      const int qi = i / d;
      const float out = acc[i] / fmaxf(l[qi], 1e-30f) * r[row0 + q0 + qi];
      store_as(ob + i, out);
    }
  }
}

template <typename T, bool kResiduals>
int launch(const void* q, const void* k, const void* v, const void* idx,
           const void* seg, const void* r, void* o, void* o_pre, void* lse,
           int BH, int S, int d, float scale, cudaStream_t stream) {
  const int rows = S < kBlockQ ? S : kBlockQ;
  const size_t smem = smem_bytes(rows, d);
  cudaError_t err = allow_smem(mosa_attention_kernel<T, kResiduals>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (S + kBlockQ - 1) / kBlockQ);
  mosa_attention_kernel<T, kResiduals><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(r),
      static_cast<T*>(o), static_cast<float*>(o_pre),
      static_cast<float*>(lse), S, d, rows, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (BH, S, d) contiguous in `dtype`; idx, seg: (BH, S) int32
// (seg may be null); r: (BH, S) float32.  Returns cudaGetLastError().
extern "C" int repro_mosa_attention(const void* q, const void* k, const void* v,
                                    const void* idx, const void* seg,
                                    const void* r, void* o, int BH, int S,
                                    int d, float scale, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch<float, false>(q, k, v, idx, seg, r, o, nullptr, nullptr, BH,
                                S, d, scale, st);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16, false>(q, k, v, idx, seg, r, o, nullptr,
                                        nullptr, BH, S, d, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch<float, true>(q, k, v, idx, seg, nullptr, nullptr, o_pre,
                               lse, BH, S, d, scale, st);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16, true>(q, k, v, idx, seg, nullptr, nullptr,
                                       o_pre, lse, BH, S, d, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
