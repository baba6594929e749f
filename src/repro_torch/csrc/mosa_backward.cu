// Backward of MoSA attention over the expert-choice-selected tokens, written
// by hand for Hopper (sm_90a).
//
// Replaces the two TPU kernels of src/repro/kernels/mosa_backward.py,
// `_mosa_bwd_dq_kernel` (:49) and `_mosa_bwd_dkv_kernel` (:100), both
// launched by `mosa_attention_bwd_pallas` (:162; calls at :188 and :206).
// Recompute-style (flash-attention backward): no O(S^2) matrix is read from
// memory.  With S_ij = scale * q_i.k_j under the mask
// seg_i == seg_j && idx_i >= idx_j && idx_j >= 0, P_ij = exp(S_ij - lse_i)
// recomputed from the forward's per-query log-sum-exp, g~ = r * g and
// delta_i = g~_i . o_pre_i (both from the wrapper, fp32):
//
//   dS_ij = P_ij * (g~_i . v_j - delta_i)
//   dQ_i  = scale * sum_j dS_ij k_j            (mosa_bwd_dq_kernel)
//   dK_j  = scale * sum_i dS_ij q_i            (mosa_bwd_dkv_kernel)
//   dV_j  = sum_i P_ij g~_i                    (mosa_bwd_dkv_kernel)
//
// P is recomputed under the explicit mask, never as exp(s - lse) alone: a
// row with no valid key has lse ~ -1e30, and exp(-1e30 - lse) is not ~0.
//
// What bounds it on an H100: at the training shapes (S = k = 32 selected
// tokens, d = 64) each pair costs ~3d FMAs against ~6 S*d elements moved
// per row, so both kernels are bound by device-memory bytes, not by
// operations.  As in the forward, each block stages its own tile and each
// streamed tile of the opposite operand in shared memory (fp32), so every
// input element of the tile a block owns is read from device memory once;
// the streamed operand is read once per tile of the owner (once in all at
// S <= 64).  Rows are independent blocks (B*H = 2208 on the slice), and no
// two blocks write the same output, so there are no atomics and the result
// is deterministic.  Any S and any d <= 128 are taken without padding: the
// ragged streamed tile masks its missing lanes and the ragged owned tile
// computes nothing for its missing rows.
//
// Inside a block, warp w owns rows w, w+4, ... of its tile; for each
// streamed tile of 32, lane j takes element j of that tile (stored with a
// padded row stride, so the 32 lanes hit 32 banks), the warp publishes its
// 32 coefficients in shared memory, and each lane accumulates the output
// columns it owns.

#include <stdint.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockRows = 64;  // owned rows (queries or keys) per block
constexpr int kBlockStream = 32;  // streamed rows per tile (one per lane)

__device__ __forceinline__ bool pair_ok(int idx_q, int seg_q, int idx_k,
                                        int seg_k) {
  return idx_k >= 0 && idx_q >= idx_k && seg_q == seg_k;
}

// ---------------------------------------------------------------- dq
size_t dq_smem_bytes(int rows, int d) {
  return sizeof(float) * (3 * static_cast<size_t>(rows) * d  // q, g~, acc
                          + 2 * kBlockStream * (d + 1)       // k, v tiles
                          + 2 * rows                         // lse, delta
                          + kWarps * 32)                     // dS per warp
         + sizeof(int) * (2 * kBlockStream + 2 * rows);      // idx, seg
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mosa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ idx,
                   const int* __restrict__ seg, const float* __restrict__ gt,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int S,
                   int d, int rows, float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* qs = smem;                     // [rows][d], pre-scaled
  float* gs = qs + rows * d;            // [rows][d]
  float* acc = gs + rows * d;           // [rows][d]
  float* ks = acc + rows * d;           // [kBlockStream][d + 1]
  float* vs = ks + kBlockStream * dp;   // [kBlockStream][d + 1]
  float* lse_q = vs + kBlockStream * dp;  // [rows]
  float* delta_q = lse_q + rows;        // [rows]
  float* dsw = delta_q + rows;          // [kWarps][32]
  int* idx_k = reinterpret_cast<int*>(dsw + kWarps * 32);  // [kBlockStream]
  int* seg_k = idx_k + kBlockStream;
  int* idx_q = seg_k + kBlockStream;    // [rows]
  int* seg_q = idx_q + rows;

  const size_t row0 = static_cast<size_t>(blockIdx.x) * S;
  const int q0 = blockIdx.y * kBlockRows;
  const int nq = min(kBlockRows, S - q0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qb = q + (row0 + q0) * d;
  const float* gb = gt + (row0 + q0) * d;
  for (int i = threadIdx.x; i < nq * d; i += kThreads) {
    qs[i] = to_float(qb[i]) * scale;
    gs[i] = gb[i];
    acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < nq; i += kThreads) {
    lse_q[i] = lse[row0 + q0 + i];
    delta_q[i] = delta[row0 + q0 + i];
    idx_q[i] = idx[row0 + q0 + i];
    seg_q[i] = seg ? seg[row0 + q0 + i] : 0;
  }

  for (int k0 = 0; k0 < S; k0 += kBlockStream) {
    const int nk = min(kBlockStream, S - k0);
    __syncthreads();  // the previous tile is consumed (first pass: q staged)
    const T* kb = k + (row0 + k0) * d;
    const T* vb = v + (row0 + k0) * d;
    for (int i = threadIdx.x; i < nk * d; i += kThreads) {
      const int j = i / d;
      const int c = i - j * d;
      ks[j * dp + c] = to_float(kb[i]);
      vs[j * dp + c] = to_float(vb[i]);
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
    const float* vr = vs + lane * dp;
    for (int qi = warp; qi < nq; qi += kWarps) {
      float ds = 0.f;
      if (has_key && pair_ok(idx_q[qi], seg_q[qi], ik, sk)) {
        const float* qr = qs + qi * d;
        const float* gr = gs + qi * d;
        float s = 0.f, dpv = 0.f;
        for (int c = 0; c < d; ++c) {
          s = fmaf(qr[c], kr[c], s);
          dpv = fmaf(gr[c], vr[c], dpv);
        }
        const float p = expf(s - lse_q[qi]);
        ds = p * (dpv - delta_q[qi]);
      }
      dsw[warp * 32 + lane] = ds;
      __syncwarp();
      float* ar = acc + qi * d;
      for (int c = lane; c < d; c += 32) {
        float a = ar[c];
        for (int j = 0; j < nk; ++j)
          a = fmaf(dsw[warp * 32 + j], ks[j * dp + c], a);
        ar[c] = a;
      }
      __syncwarp();  // dsw is reused by this warp's next query
    }
  }
  __syncthreads();

  T* ob = dq + (row0 + q0) * d;
  for (int i = threadIdx.x; i < nq * d; i += kThreads)
    store_as(ob + i, acc[i] * scale);
}

// --------------------------------------------------------------- dk, dv
size_t dkv_smem_bytes(int rows, int d) {
  return sizeof(float) * (4 * static_cast<size_t>(rows) * d  // k, v, dk, dv
                          + 2 * kBlockStream * (d + 1)       // q, g~ tiles
                          + 2 * kBlockStream                 // lse, delta
                          + 2 * kWarps * 32)                 // P, dS per warp
         + sizeof(int) * (2 * kBlockStream + 2 * rows);      // idx, seg
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mosa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ idx,
                    const int* __restrict__ seg, const float* __restrict__ gt,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int S, int d, int rows, float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* ks = smem;                     // [rows][d]
  float* vs = ks + rows * d;            // [rows][d]
  float* dks = vs + rows * d;           // [rows][d]
  float* dvs = dks + rows * d;          // [rows][d]
  float* qs = dvs + rows * d;           // [kBlockStream][d + 1], pre-scaled
  float* gs = qs + kBlockStream * dp;   // [kBlockStream][d + 1]
  float* lse_q = gs + kBlockStream * dp;  // [kBlockStream]
  float* delta_q = lse_q + kBlockStream;
  float* pw = delta_q + kBlockStream;   // [kWarps][32]
  float* dsw = pw + kWarps * 32;        // [kWarps][32]
  int* idx_q = reinterpret_cast<int*>(dsw + kWarps * 32);  // [kBlockStream]
  int* seg_q = idx_q + kBlockStream;
  int* idx_k = seg_q + kBlockStream;    // [rows]
  int* seg_k = idx_k + rows;

  const size_t row0 = static_cast<size_t>(blockIdx.x) * S;
  const int k0 = blockIdx.y * kBlockRows;
  const int nk = min(kBlockRows, S - k0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* kb = k + (row0 + k0) * d;
  const T* vb = v + (row0 + k0) * d;
  for (int i = threadIdx.x; i < nk * d; i += kThreads) {
    ks[i] = to_float(kb[i]);
    vs[i] = to_float(vb[i]);
    dks[i] = 0.f;
    dvs[i] = 0.f;
  }
  for (int i = threadIdx.x; i < nk; i += kThreads) {
    idx_k[i] = idx[row0 + k0 + i];
    seg_k[i] = seg ? seg[row0 + k0 + i] : 0;
  }

  for (int qt = 0; qt < S; qt += kBlockStream) {
    const int nq = min(kBlockStream, S - qt);
    __syncthreads();  // the previous tile is consumed (first pass: k staged)
    const T* qb = q + (row0 + qt) * d;
    const float* gb = gt + (row0 + qt) * d;
    for (int i = threadIdx.x; i < nq * d; i += kThreads) {
      const int j = i / d;
      const int c = i - j * d;
      qs[j * dp + c] = to_float(qb[i]) * scale;
      gs[j * dp + c] = gb[i];
    }
    if (threadIdx.x < nq) {
      const size_t o = row0 + qt + threadIdx.x;
      lse_q[threadIdx.x] = lse[o];
      delta_q[threadIdx.x] = delta[o];
      idx_q[threadIdx.x] = idx[o];
      seg_q[threadIdx.x] = seg ? seg[o] : 0;
    }
    __syncthreads();

    const bool has_q = lane < nq;
    const int iq = has_q ? idx_q[lane] : -1;
    const int sq = has_q ? seg_q[lane] : 0;
    const float* qr = qs + lane * dp;
    const float* gr = gs + lane * dp;
    for (int kj = warp; kj < nk; kj += kWarps) {
      float p = 0.f, ds = 0.f;
      if (has_q && pair_ok(iq, sq, idx_k[kj], seg_k[kj])) {
        const float* kr = ks + kj * d;
        const float* vr = vs + kj * d;
        float s = 0.f, dpv = 0.f;
        for (int c = 0; c < d; ++c) {
          s = fmaf(qr[c], kr[c], s);
          dpv = fmaf(gr[c], vr[c], dpv);
        }
        p = expf(s - lse_q[lane]);
        ds = p * (dpv - delta_q[lane]);
      }
      pw[warp * 32 + lane] = p;
      dsw[warp * 32 + lane] = ds;
      __syncwarp();
      float* dkr = dks + kj * d;
      float* dvr = dvs + kj * d;
      for (int c = lane; c < d; c += 32) {
        float a = dkr[c], b = dvr[c];
        for (int i = 0; i < nq; ++i) {
          a = fmaf(dsw[warp * 32 + i], qs[i * dp + c], a);
          b = fmaf(pw[warp * 32 + i], gs[i * dp + c], b);
        }
        dkr[c] = a;
        dvr[c] = b;
      }
      __syncwarp();  // pw and dsw are reused by this warp's next key
    }
  }
  __syncthreads();

  // q was staged pre-scaled, so dks already holds scale * sum dS q.
  T* dkb = dk + (row0 + k0) * d;
  T* dvb = dv + (row0 + k0) * d;
  for (int i = threadIdx.x; i < nk * d; i += kThreads) {
    store_as(dkb + i, dks[i]);
    store_as(dvb + i, dvs[i]);
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* idx,
              const void* seg, const void* gt, const void* lse,
              const void* delta, void* dq, int BH, int S, int d, float scale,
              cudaStream_t stream) {
  const int rows = S < kBlockRows ? S : kBlockRows;
  const size_t smem = dq_smem_bytes(rows, d);
  cudaError_t err = allow_smem(mosa_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (S + kBlockRows - 1) / kBlockRows);
  mosa_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(gt),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, d, rows, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* idx,
               const void* seg, const void* gt, const void* lse,
               const void* delta, void* dk, void* dv, int BH, int S, int d,
               float scale, cudaStream_t stream) {
  const int rows = S < kBlockRows ? S : kBlockRows;
  const size_t smem = dkv_smem_bytes(rows, d);
  cudaError_t err = allow_smem(mosa_bwd_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (S + kBlockRows - 1) / kBlockRows);
  mosa_bwd_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(gt),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, d, rows, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points: q, k, v (and dq, dk, dv): (BH, S, d) contiguous in
// `dtype`; idx, seg: (BH, S) int32 (seg may be null); gt: (BH, S, d) float32
// (= r * g); lse, delta: (BH, S) float32.  Each launches its kernel on
// `stream` and returns cudaGetLastError().
extern "C" int repro_mosa_attention_bwd_dq(const void* q, const void* k,
                                           const void* v, const void* idx,
                                           const void* seg, const void* gt,
                                           const void* lse, const void* delta,
                                           void* dq, int BH, int S, int d,
                                           float scale, int dtype,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_dq<float>(q, k, v, idx, seg, gt, lse, delta, dq, BH, S, d,
                            scale, st);
  if (dtype == repro::kBFloat16)
    return launch_dq<__nv_bfloat16>(q, k, v, idx, seg, gt, lse, delta, dq, BH,
                                    S, d, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int repro_mosa_attention_bwd_dkv(const void* q, const void* k,
                                            const void* v, const void* idx,
                                            const void* seg, const void* gt,
                                            const void* lse,
                                            const void* delta, void* dk,
                                            void* dv, int BH, int S, int d,
                                            float scale, int dtype,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_dkv<float>(q, k, v, idx, seg, gt, lse, delta, dk, dv, BH, S,
                             d, scale, st);
  if (dtype == repro::kBFloat16)
    return launch_dkv<__nv_bfloat16>(q, k, v, idx, seg, gt, lse, delta, dk,
                                     dv, BH, S, d, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
