// Shared tile body of the filter kernel (bregman_ub.cu) and the fused
// filter+prune kernel (bregman_fused.cu).
//
// One block owns a TN x TQ tile of the (n, q) output; each of its 256
// threads owns RPT = 4 outputs of one query column, so a warp writes 32
// neighbouring queries of one row.  The subspace axis M is walked in chunks
// of MC: each chunk stages the block's rows of the point tables and the
// query tile's columns of the query tables in shared memory, then every
// thread folds the chunk into its running sums.  M is looped at its real
// width; nothing is padded to a lane multiple.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace brekernels {

constexpr int TN = 32;        // rows per block
constexpr int TQ = 32;        // queries per block
constexpr int MC = 32;        // subspaces staged per chunk
constexpr int THREADS = 256;
constexpr int ROW_STRIDE = THREADS / TQ;   // 8 row groups
constexpr int RPT = TN / ROW_STRIDE;       // 4 outputs per thread

// ub[r, j]    = (sum_i alpha[r, i] + qsum[j]) + sum_i sg[r, i] * sd[j, i]
// admit[r, j] = any_i (amin[r, i] + qc[j, i]) - gmax[r, i] * sd[j, i] <= qb[j, i]
// (PRUNE only).  Point tables are (n, m) row-major, query tables (q, m).
template <bool PRUNE>
__global__ void __launch_bounds__(THREADS)
filter_tile_kernel(const float* __restrict__ alpha,
                   const float* __restrict__ sg,
                   const float* __restrict__ amin,
                   const float* __restrict__ gmax,
                   const float* __restrict__ qsum,
                   const float* __restrict__ qc,
                   const float* __restrict__ sd,
                   const float* __restrict__ qb,
                   float* __restrict__ ub,
                   int32_t* __restrict__ admit,
                   int64_t n, int m, int q) {
  constexpr int PR = PRUNE ? TN : 1;
  constexpr int PQ = PRUNE ? MC : 1;
  __shared__ float s_alpha[TN][MC + 1];
  __shared__ float s_sg[TN][MC + 1];
  __shared__ float s_amin[PR][MC + 1];
  __shared__ float s_gmax[PR][MC + 1];
  __shared__ float s_sd[MC][TQ + 1];
  __shared__ float s_qc[PQ][TQ + 1];
  __shared__ float s_qb[PQ][TQ + 1];

  const int tid = threadIdx.x;
  const int tq = tid % TQ;
  const int tr = tid / TQ;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TN;
  const int q0 = blockIdx.y * TQ;

  float rowsum[RPT];
  float cauchy[RPT];
  bool hit[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    rowsum[i] = 0.f;
    cauchy[i] = 0.f;
    hit[i] = false;
  }

  for (int m0 = 0; m0 < m; m0 += MC) {
    const int mc = min(MC, m - m0);
    for (int e = tid; e < TN * MC; e += THREADS) {
      const int r = e / MC;
      const int c = e % MC;
      const int64_t row = row0 + r;
      const bool ok = row < n && c < mc;
      const int64_t off = row * m + m0 + c;
      s_alpha[r][c] = ok ? alpha[off] : 0.f;
      s_sg[r][c] = ok ? sg[off] : 0.f;
      if constexpr (PRUNE) {
        s_amin[r][c] = ok ? amin[off] : 0.f;
        s_gmax[r][c] = ok ? gmax[off] : 0.f;
      }
    }
    for (int e = tid; e < TQ * MC; e += THREADS) {
      const int j = e / MC;
      const int c = e % MC;
      const bool ok = q0 + j < q && c < mc;
      const int64_t off = static_cast<int64_t>(q0 + j) * m + m0 + c;
      s_sd[c][j] = ok ? sd[off] : 0.f;
      if constexpr (PRUNE) {
        s_qc[c][j] = ok ? qc[off] : 0.f;
        s_qb[c][j] = ok ? qb[off] : 0.f;
      }
    }
    __syncthreads();
    for (int c = 0; c < mc; ++c) {
      const float sdv = s_sd[c][tq];
      float qcv = 0.f;
      float qbv = 0.f;
      if constexpr (PRUNE) {
        qcv = s_qc[c][tq];
        qbv = s_qb[c][tq];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = tr + i * ROW_STRIDE;
        rowsum[i] += s_alpha[r][c];
        cauchy[i] = fmaf(s_sg[r][c], sdv, cauchy[i]);
        if constexpr (PRUNE) {
          // Each operation rounded on its own, as the plain version does:
          // the intrinsics keep nvcc from contracting into a fused
          // multiply-add, so the admit bit is the same on both.
          const float lb = __fsub_rn(__fadd_rn(s_amin[r][c], qcv),
                                     __fmul_rn(s_gmax[r][c], sdv));
          hit[i] = hit[i] || (lb <= qbv);
        }
      }
    }
    __syncthreads();
  }

  const int j = q0 + tq;
  if (j >= q) return;
  const float qs = qsum[j];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t row = row0 + tr + i * ROW_STRIDE;
    if (row < n) {
      ub[row * q + j] = (rowsum[i] + qs) + cauchy[i];
      if constexpr (PRUNE) admit[row * q + j] = hit[i] ? 1 : 0;
    }
  }
}

template <bool PRUNE>
inline int launch_filter_tile(const float* alpha, const float* sg,
                              const float* amin, const float* gmax,
                              const float* qsum, const float* qc,
                              const float* sd, const float* qb, float* ub,
                              int32_t* admit, int64_t n, int64_t m, int64_t q,
                              int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || q <= 0) return 0;
  if (m <= 0 || m > INT32_MAX || q > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + TN - 1) / TN),
                  static_cast<unsigned>((q + TQ - 1) / TQ));
  filter_tile_kernel<PRUNE><<<grid, THREADS, 0, stream>>>(
      alpha, sg, amin, gmax, qsum, qc, sd, qb, ub, admit, n,
      static_cast<int>(m), static_cast<int>(q));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace brekernels
