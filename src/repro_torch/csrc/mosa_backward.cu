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
//
// Block choice (`kBlock`): the same kernels replace the two TPU kernels of
// src/repro/kernels/mosa_block.py, `_mosa_block_bwd_dq_kernel` (:182) and
// `_mosa_block_bwd_dkv_kernel` (:227), both launched by
// `mosa_block_attention_bwd_pallas` (:371; calls at :390 and :409): the
// fused kernel below whenever a row fits one tile (S = NB * bs <= 64), the
// split pair above otherwise.  `idx` is the block table (BH, S / bs), and
// each kernel expands it per selected row (sel_pos in common.cuh): pos =
// bidx[j / bs] * bs + j % bs; a row is a valid key iff its block is not
// empty and pos < seq_len, while as a query it keeps its raw position.
// Invalid query rows arrive with g~ = 0 and delta = 0 (the wrapper zeroes
// them), so their dS is exactly 0 and their share of dV vanishes term by
// term.  At bs = 1 every kernel computes what its token-choice form does,
// bit for bit.
//
// Fused backward (`mosa_bwd_fused_kernel`, S <= 64): the training path's
// form of #3 + #4 (token choice) and of #7 + #8 (block choice), one
// template for both.  When a row's S selected tokens fit one tile, one
// block holds the whole row, so dq needs no key outside the block and one
// block can produce dq, dk and dv with no atomics.  The two split kernels
// above each recompute S = q.k^T and dP = g~.v^T and each read q, k, v and
// g~ from device memory (7 S x S x d products where 5 are needed), and
// both are bound by shared-memory instructions: one scalar load pair per
// FMA pair in the pair dots and a read-modify-write of a shared
// accumulator per output, rows one after another in each warp.  The fused
// kernel:
//
//   * stages the row's q, k, v (in their dtype) and g~ (fp32) in shared
//     memory with cp.async 16-byte copies (cp.async.cg.shared.global; 4-byte
//     copies for lse, delta, idx and seg), rows at a padded stride of
//     d + 16 bytes' worth of elements, which keeps 16-byte alignment and
//     spreads neighbouring rows over the banks.  The copy is a pure copy:
//     q is not pre-scaled, the scale multiplies each score and dK instead.
//     Block choice copies the row's block table (NB ints) the same way,
//     into the scratch that P later takes, and expands it in shared memory
//     once the copies have landed, into two arrays: each row's query
//     position and its key position (-1 where the row is no key).  Token
//     choice reads both from the one idx array.  Expanding each row from
//     device memory while the copies were in flight put a dependent load on
//     every block's critical path and was slower on the H100 (PERF.md).
//     Padded rows S..Sp-1 are no query and no key (the i < S and j < S
//     tests of phase A), in both modes;
//   * phase A: S and dP as register-tiled products, each thread a 2 x 4
//     micro-tile of both (queries i0, i0+1; keys j0 + m * Sp/4, strided so
//     the 8 key rows a warp reads lie on distinct banks), 16-byte operand
//     loads, 5.3 FMAs per load instruction; P = exp(scale * s - lse) and
//     dS = P * (dP - delta) under the explicit mask, into shared memory as
//     P, dS and dS^T (Sp x (Sp + 4) floats each);
//   * phase B: dQ = scale * dS k, dK = scale * dS^T q, dV = P^T g~ as
//     register-tiled S x d products, each thread a 4 x 4 micro-tile of all
//     three (48 accumulators, 8 FMAs per 16-byte load instruction), each
//     output element written once, straight from registers to device
//     memory with 16-byte stores (8-byte for bf16);
//   * one block per row (~49 KB of shared memory at the slice, so 4 blocks
//     of 4 warps per SM; registers allow 5): the resident blocks overlap one
//     another's copies with their compute.  A persistent form (occupancy x
//     SMs blocks walking over rows, the next row's copies in flight in a
//     second stage) kept only 2 blocks per SM at the slice and measured
//     4-12% slower on the H100 (PERF.md), so it is not kept.
//
// Bound on an H100 at either slice (2208 rows, S = 32, d = 64, fp32; block
// choice as NB = 2 blocks of bs = 16): 10 * pairs * d ~ 0.75 GFLOP of
// valid work, ~0.011 ms at 67 TFLOP/s, against ~127 MB moved (q, k, v, g~
// read once, dq, dk, dv written once, plus lse, delta and the idx or block
// table), ~0.038 ms at 3.35 TB/s: bound by bytes.  Tensor cores are not
// used: fp32 inputs would need TF32, whose ~3 decimal digits break the
// 2e-5 fp32 tolerance, and the CUDA cores' operations bound is already
// below the byte bound; bf16 inputs are widened to fp32 as they are read
// from shared memory.  The reduction order is fixed, so the result is
// deterministic run to run.  Any d <= 128 and any 1 <= S <= 64 (any bs
// that divides S) are taken without padding in device memory: padded rows
// and columns of the staged tiles are zeros, and masked or padded pairs
// give P = dS = 0 by selection (never by multiplying a NaN).  Rows whose d
// (or whose pointers) do not allow 16-byte copies are staged with plain
// loads.  On the H100 both forms run at about twice the byte bound, ~0.077
// ms at either slice against 0.32-0.35 ms for the split pairs (chip_smoke
// [4], PERF.md): within a block a row's copies and its compute do not
// overlap, and the resident blocks hide only part of that.

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

template <typename T, bool kBlock>
__global__ void __launch_bounds__(kThreads)
mosa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ idx,
                   const int* __restrict__ seg, const float* __restrict__ gt,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int S,
                   int d, int rows, float scale, int bs, int seq_len) {
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

  const size_t row = blockIdx.x;
  const size_t row0 = row * S;
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
    bool valid;
    lse_q[i] = lse[row0 + q0 + i];
    delta_q[i] = delta[row0 + q0 + i];
    idx_q[i] = sel_pos<kBlock>(idx, row, S, q0 + i, bs, seq_len, valid);
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
      bool valid;
      const int p = sel_pos<kBlock>(idx, row, S, k0 + threadIdx.x, bs,
                                    seq_len, valid);
      idx_k[threadIdx.x] = (!kBlock || valid) ? p : -1;
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

template <typename T, bool kBlock>
__global__ void __launch_bounds__(kThreads)
mosa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ idx,
                    const int* __restrict__ seg, const float* __restrict__ gt,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int S, int d, int rows, float scale,
                    int bs, int seq_len) {
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

  const size_t row = blockIdx.x;
  const size_t row0 = row * S;
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
    bool valid;
    const int p = sel_pos<kBlock>(idx, row, S, k0 + i, bs, seq_len, valid);
    idx_k[i] = (!kBlock || valid) ? p : -1;
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
      bool valid;
      lse_q[threadIdx.x] = lse[o];
      delta_q[threadIdx.x] = delta[o];
      idx_q[threadIdx.x] = sel_pos<kBlock>(idx, row, S, qt + threadIdx.x, bs,
                                           seq_len, valid);
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

template <typename T, bool kBlock>
int launch_dq(const void* q, const void* k, const void* v, const void* idx,
              const void* seg, const void* gt, const void* lse,
              const void* delta, void* dq, int BH, int S, int d, float scale,
              int bs, int seq_len, cudaStream_t stream) {
  const int rows = S < kBlockRows ? S : kBlockRows;
  const size_t smem = dq_smem_bytes(rows, d);
  auto* kernel = mosa_bwd_dq_kernel<T, kBlock>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (S + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(gt),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, d, rows, scale, bs, seq_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBlock>
int launch_dkv(const void* q, const void* k, const void* v, const void* idx,
               const void* seg, const void* gt, const void* lse,
               const void* delta, void* dk, void* dv, int BH, int S, int d,
               float scale, int bs, int seq_len, cudaStream_t stream) {
  const int rows = S < kBlockRows ? S : kBlockRows;
  const size_t smem = dkv_smem_bytes(rows, d);
  auto* kernel = mosa_bwd_dkv_kernel<T, kBlock>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (S + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(gt),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, d, rows, scale, bs,
      seq_len);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBlock>
int dq_dtype(int dtype, const void* q, const void* k, const void* v,
             const void* idx, const void* seg, const void* gt,
             const void* lse, const void* delta, void* dq, int BH, int S,
             int d, float scale, int bs, int seq_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_dq<float, kBlock>(q, k, v, idx, seg, gt, lse, delta, dq, BH,
                                    S, d, scale, bs, seq_len, st);
  if (dtype == kBFloat16)
    return launch_dq<__nv_bfloat16, kBlock>(q, k, v, idx, seg, gt, lse, delta,
                                            dq, BH, S, d, scale, bs, seq_len,
                                            st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kBlock>
int dkv_dtype(int dtype, const void* q, const void* k, const void* v,
              const void* idx, const void* seg, const void* gt,
              const void* lse, const void* delta, void* dk, void* dv, int BH,
              int S, int d, float scale, int bs, int seq_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_dkv<float, kBlock>(q, k, v, idx, seg, gt, lse, delta, dk,
                                     dv, BH, S, d, scale, bs, seq_len, st);
  if (dtype == kBFloat16)
    return launch_dkv<__nv_bfloat16, kBlock>(q, k, v, idx, seg, gt, lse,
                                             delta, dk, dv, BH, S, d, scale,
                                             bs, seq_len, st);
  return static_cast<int>(cudaErrorInvalidValue);
}


// ------------------------------------------------- fused dq, dk, dv (S <= 64)
constexpr int kFusedThreads = 128;
constexpr int kFusedMaxS = 64;
constexpr int kMaxD = 128;

// Shared-memory layout of the fused kernel for one (S, d, element size,
// mode).  Sp = S rounded up to 4, dpad = d rounded up to 4 (the width the
// products run over), row strides of 16 bytes' worth of elements past the
// rounded width; ps = the row stride of P, dS and dS^T.  Block choice
// stages one more int per row (the query positions).
struct FusedLayout {
  int Sp, dpad, dsT, dsF, ps;
  size_t stage_bytes, scratch_bytes;
};

__host__ __device__ inline FusedLayout fused_layout(int S, int d, int tsize,
                                                    bool block) {
  FusedLayout L;
  const int vT = 16 / tsize;
  L.Sp = (S + 3) / 4 * 4;
  L.dpad = (d + 3) / 4 * 4;
  L.dsT = (d + vT - 1) / vT * vT + vT;
  L.dsF = L.dpad + 4;
  L.ps = L.Sp + 4;
  L.stage_bytes = static_cast<size_t>(L.Sp) *
                  (3 * L.dsT * tsize + L.dsF * 4 + (block ? 5 : 4) * 4);
  L.scratch_bytes = 3 * sizeof(float) * static_cast<size_t>(L.Sp) * L.ps;
  return L;
}

// The staged row: q, k, v [Sp][dsT] (dtype T), g~ [Sp][dsF], lse, delta,
// idx (each row's key position, -1 = not a key) and seg [Sp], and pos
// (each row's query position): its own [Sp] array in block choice, where
// an invalid row keeps its raw position as a query; idx itself in token
// choice.  Block choice copies the row's block table (NB ints) to `table`,
// the start of P's scratch, and expands it into idx and pos before phase
// A writes P.
template <typename T, bool kBlock>
struct Stage {
  T *q, *k, *v;
  float *g, *lse, *delta;
  int *idx, *seg, *pos, *table;

  __device__ Stage(unsigned char* base, const FusedLayout& L) {
    const size_t n = static_cast<size_t>(L.Sp) * L.dsT;
    q = reinterpret_cast<T*>(base);
    k = q + n;
    v = k + n;
    g = reinterpret_cast<float*>(v + n);
    lse = g + static_cast<size_t>(L.Sp) * L.dsF;
    delta = lse + L.Sp;
    idx = reinterpret_cast<int*>(delta + L.Sp);
    seg = idx + L.Sp;
    pos = kBlock ? seg + L.Sp : idx;
    table = reinterpret_cast<int*>(base + L.stage_bytes);
  }
};

// Start the copies of row `row` into `st` (16-byte cp.async when `vec`,
// else plain loads), uncommitted.
template <typename T, bool kBlock>
__device__ void fetch_row(const Stage<T, kBlock>& st, const FusedLayout& L,
                          const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ gt,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ idx,
                          const int* __restrict__ seg, size_t row, int S,
                          int d, bool vec, int bs) {
  const size_t base = row * S;
  const T* qb = q + base * d;
  const T* kb = k + base * d;
  const T* vb = v + base * d;
  const float* gb = gt + base * d;
  if (vec) {
    constexpr int kV = 16 / sizeof(T);
    const int cpr = d / kV;
    for (int i = threadIdx.x; i < S * cpr; i += kFusedThreads) {
      const int r = i / cpr;
      const int c = (i - r * cpr) * kV;
      cp_async16(st.q + r * L.dsT + c, qb + r * d + c);
      cp_async16(st.k + r * L.dsT + c, kb + r * d + c);
      cp_async16(st.v + r * L.dsT + c, vb + r * d + c);
    }
    const int cprf = d / 4;
    for (int i = threadIdx.x; i < S * cprf; i += kFusedThreads) {
      const int r = i / cprf;
      const int c = (i - r * cprf) * 4;
      cp_async16(st.g + r * L.dsF + c, gb + r * d + c);
    }
  } else {
    for (int i = threadIdx.x; i < S * d; i += kFusedThreads) {
      const int r = i / d;
      const int c = i - r * d;
      st.q[r * L.dsT + c] = qb[i];
      st.k[r * L.dsT + c] = kb[i];
      st.v[r * L.dsT + c] = vb[i];
      st.g[r * L.dsF + c] = gb[i];
    }
  }
  for (int i = threadIdx.x; i < S; i += kFusedThreads) {
    cp_async4(st.lse + i, lse + base + i);
    cp_async4(st.delta + i, delta + base + i);
    if constexpr (kBlock) {
      if (i < S / bs) cp_async4(st.table + i, idx + row * (S / bs) + i);
    } else {
      cp_async4(st.idx + i, idx + base + i);
    }
    if (seg) cp_async4(st.seg + i, seg + base + i);
  }
}

template <typename T, bool kBlock>
__global__ void __launch_bounds__(kFusedThreads)
mosa_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ idx,
                      const int* __restrict__ seg,
                      const float* __restrict__ gt,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dq,
                      T* __restrict__ dk, T* __restrict__ dv, int S, int d,
                      float scale, bool vec, int bs, int seq_len) {
  extern __shared__ float4 fused_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(fused_smem);
  const FusedLayout L = fused_layout(S, d, sizeof(T), kBlock);
  const Stage<T, kBlock> st(smem, L);
  float* P = reinterpret_cast<float*>(smem + L.stage_bytes);
  float* dS = P + L.Sp * L.ps;
  float* dSt = dS + L.Sp * L.ps;
  const int nkg = L.Sp / 4;  // groups of 4 keys (phase A), of 4 rows (B)
  const int nqg = L.Sp / 2;  // pairs of queries (phase A)
  const int ncg = L.dpad / 4;  // groups of 4 columns (phase B)
  const int row = blockIdx.x;

  // Start the row's copies, then zero the padding (rows S..Sp-1, columns
  // d..dpad-1), which the copies never write.  Without seg every key is in
  // segment 0.  Block choice then expands the staged block table (sel_pos).
  fetch_row(st, L, q, k, v, gt, lse, delta, idx, seg, row, S, d, vec, bs);
  cp_async_commit();
  if (S < L.Sp || d < L.dpad) {
    for (int i = threadIdx.x; i < L.Sp * L.dpad; i += kFusedThreads) {
      const int r = i / L.dpad;
      const int c = i - r * L.dpad;
      if (r >= S || c >= d) {
        store_as(st.q + r * L.dsT + c, 0.f);
        store_as(st.k + r * L.dsT + c, 0.f);
        store_as(st.v + r * L.dsT + c, 0.f);
        st.g[r * L.dsF + c] = 0.f;
      }
    }
  }
  if (!seg)
    for (int i = threadIdx.x; i < L.Sp; i += kFusedThreads) st.seg[i] = 0;
  cp_async_wait_all();
  __syncthreads();
  if constexpr (kBlock) {
    for (int i = threadIdx.x; i < S; i += kFusedThreads) {
      bool valid;
      const int p = sel_pos<true>(st.table, 0, S, i, bs, seq_len, valid);
      st.pos[i] = p;
      st.idx[i] = valid ? p : -1;
    }
    __syncthreads();
  }

  // Phase A: S and dP, a 2 x 4 micro-tile of each per thread.
  for (int t = threadIdx.x; t < nqg * nkg; t += kFusedThreads) {
    const int i0 = (t / nkg) * 2;
    const int j0 = t % nkg;
    float s[2][4] = {}, dp[2][4] = {};
    for (int c = 0; c < L.dpad; c += 4) {
      float4 qa[2], ga[2], kb[4], vb[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        qa[r] = ld4(st.q + (i0 + r) * L.dsT + c);
        ga[r] = ld4(st.g + (i0 + r) * L.dsF + c);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        kb[m] = ld4(st.k + (j0 + m * nkg) * L.dsT + c);
        vb[m] = ld4(st.v + (j0 + m * nkg) * L.dsT + c);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          s[r][m] = dot4(qa[r], kb[m], s[r][m]);
          dp[r][m] = dot4(ga[r], vb[m], dp[r][m]);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + r;
      const bool q_ok = i < S;
      const int iq = q_ok ? st.pos[i] : -1;
      const int sq = q_ok ? st.seg[i] : 0;
      const float lse_i = q_ok ? st.lse[i] : 0.f;
      const float delta_i = q_ok ? st.delta[i] : 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = j0 + m * nkg;
        const bool ok =
            q_ok && j < S && pair_ok(iq, sq, st.idx[j], st.seg[j]);
        const float p = ok ? expf(s[r][m] * scale - lse_i) : 0.f;
        const float ds = ok ? p * (dp[r][m] - delta_i) : 0.f;
        P[i * L.ps + j] = p;
        dS[i * L.ps + j] = ds;
        dSt[j * L.ps + i] = ds;
      }
    }
  }
  __syncthreads();

  // Phase B: dQ, dK and dV, a 4 x 4 micro-tile of each per thread.
  const size_t base = static_cast<size_t>(row) * S;
  for (int t = threadIdx.x; t < nkg * ncg; t += kFusedThreads) {
    const int r0 = (t / ncg) * 4;
    const int c0 = (t % ncg) * 4;
    float aq[4][4] = {}, ak[4][4] = {}, av[4][4] = {};
    for (int u = 0; u < S; ++u) {
      const float4 dst4 = ld4(dSt + u * L.ps + r0);  // dS[r0 + a][u]
      const float4 ds4 = ld4(dS + u * L.ps + r0);    // dS[u][r0 + a]
      const float4 p4 = ld4(P + u * L.ps + r0);      // P[u][r0 + a]
      const float4 k4 = ld4(st.k + u * L.dsT + c0);
      const float4 q4 = ld4(st.q + u * L.dsT + c0);
      const float4 g4 = ld4(st.g + u * L.dsF + c0);
      const float a_q[4] = {dst4.x, dst4.y, dst4.z, dst4.w};
      const float a_k[4] = {ds4.x, ds4.y, ds4.z, ds4.w};
      const float a_v[4] = {p4.x, p4.y, p4.z, p4.w};
      const float b_q[4] = {k4.x, k4.y, k4.z, k4.w};
      const float b_k[4] = {q4.x, q4.y, q4.z, q4.w};
      const float b_v[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          aq[a][b] = fmaf(a_q[a], b_q[b], aq[a][b]);
          ak[a][b] = fmaf(a_k[a], b_k[b], ak[a][b]);
          av[a][b] = fmaf(a_v[a], b_v[b], av[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = r0 + a;
      if (r < S) {
        float out_q[4], out_k[4], out_v[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          out_q[b] = aq[a][b] * scale;
          out_k[b] = ak[a][b] * scale;
          out_v[b] = av[a][b];
        }
        T* pq = dq + (base + r) * d + c0;
        T* pk = dk + (base + r) * d + c0;
        T* pv = dv + (base + r) * d + c0;
        if (vec && c0 + 4 <= d) {
          st4(pq, out_q);
          st4(pk, out_k);
          st4(pv, out_v);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c0 + b < d) {
              store_as(pq + b, out_q[b]);
              store_as(pk + b, out_k[b]);
              store_as(pv + b, out_v[b]);
            }
        }
      }
    }
  }
}

// One block per row.
template <typename T, bool kBlock>
int launch_fused(const void* q, const void* k, const void* v, const void* idx,
                 const void* seg, const void* gt, const void* lse,
                 const void* delta, void* dq, void* dk, void* dv, int BH,
                 int S, int d, float scale, int bs, int seq_len,
                 cudaStream_t stream) {
  if (S < 1 || S > kFusedMaxS || d < 1 || d > kMaxD || BH < 0 || bs < 1 ||
      S % bs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaSuccess);
  const FusedLayout L = fused_layout(S, d, sizeof(T), kBlock);
  const size_t smem = L.stage_bytes + L.scratch_bytes;
  const bool vec = d % (16 / sizeof(T)) == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v) && aligned16(gt) &&
                   aligned16(dq) && aligned16(dk) && aligned16(dv);
  auto* kernel = mosa_bwd_fused_kernel<T, kBlock>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<BH, kFusedThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(idx),
      static_cast<const int*>(seg), static_cast<const float*>(gt),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), S, d,
      scale, vec, bs, seq_len);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBlock>
int fused_dtype(int dtype, const void* q, const void* k, const void* v,
                const void* idx, const void* seg, const void* gt,
                const void* lse, const void* delta, void* dq, void* dk,
                void* dv, int BH, int S, int d, float scale, int bs,
                int seq_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_fused<float, kBlock>(q, k, v, idx, seg, gt, lse, delta, dq,
                                       dk, dv, BH, S, d, scale, bs, seq_len,
                                       st);
  if (dtype == kBFloat16)
    return launch_fused<__nv_bfloat16, kBlock>(q, k, v, idx, seg, gt, lse,
                                               delta, dq, dk, dv, BH, S, d,
                                               scale, bs, seq_len, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
  return dq_dtype<false>(dtype, q, k, v, idx, seg, gt, lse, delta, dq, BH, S,
                         d, scale, 1, 0, stream);
}

extern "C" int repro_mosa_attention_bwd_dkv(const void* q, const void* k,
                                            const void* v, const void* idx,
                                            const void* seg, const void* gt,
                                            const void* lse,
                                            const void* delta, void* dk,
                                            void* dv, int BH, int S, int d,
                                            float scale, int dtype,
                                            void* stream) {
  return dkv_dtype<false>(dtype, q, k, v, idx, seg, gt, lse, delta, dk, dv,
                          BH, S, d, scale, 1, 0, stream);
}

// The fused backward (token choice, S <= 64, d <= 128): inputs as above,
// dq, dk, dv (BH, S, d) in `dtype`, all three from one launch.  Returns
// cudaErrorInvalidValue for S > 64 or d > 128, else cudaGetLastError().
extern "C" int repro_mosa_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* idx,
                                        const void* seg, const void* gt,
                                        const void* lse, const void* delta,
                                        void* dq, void* dk, void* dv, int BH,
                                        int S, int d, float scale, int dtype,
                                        void* stream) {
  return fused_dtype<false>(dtype, q, k, v, idx, seg, gt, lse, delta, dq, dk,
                            dv, BH, S, d, scale, 1, 0, stream);
}

// Block choice (kernels #7 and #8): as above with S = NB * bs, bidx (BH,
// NB) int32 block indices in place of idx, and T the true sequence length;
// gt and delta are zero on invalid query rows.
extern "C" int repro_mosa_block_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bidx,
    const void* seg, const void* gt, const void* lse, const void* delta,
    void* dq, int BH, int S, int d, int bs, int T, float scale, int dtype,
    void* stream) {
  return dq_dtype<true>(dtype, q, k, v, bidx, seg, gt, lse, delta, dq, BH, S,
                        d, scale, bs, T, stream);
}

extern "C" int repro_mosa_block_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* bidx,
    const void* seg, const void* gt, const void* lse, const void* delta,
    void* dk, void* dv, int BH, int S, int d, int bs, int T, float scale,
    int dtype, void* stream) {
  return dkv_dtype<true>(dtype, q, k, v, bidx, seg, gt, lse, delta, dk, dv,
                         BH, S, d, scale, bs, T, stream);
}

// The fused block-choice backward (#7 + #8 in one launch; S = NB * bs <=
// 64, d <= 128, bs divides S): inputs as the two entries above, dq, dk, dv
// as repro_mosa_attention_bwd.  Returns cudaErrorInvalidValue outside that
// range, else cudaGetLastError().
extern "C" int repro_mosa_block_attention_bwd(
    const void* q, const void* k, const void* v, const void* bidx,
    const void* seg, const void* gt, const void* lse, const void* delta,
    void* dq, void* dk, void* dv, int BH, int S, int d, int bs, int T,
    float scale, int dtype, void* stream) {
  return fused_dtype<true>(dtype, q, k, v, bidx, seg, gt, lse, delta, dq, dk,
                           dv, BH, S, d, scale, bs, T, stream);
}
