// The tile body of the fp32 prune-only kernel #5 (bregman_prune.cu): the
// Theorem-3 admit mask of a row block,
//
//   admit[r, j] = any_i (amin[r, i] + qc[j, i]) - gmax[r, i] * sd[j, i]
//                       <= qb[j, i]
//
// Every other filter and prune kernel (#1-#4, #6) runs filter_span.cuh,
// whose compare is this tile's operation for operation, so the masks are
// bit-equal.  The file goes when #5 moves to the span tile (ROADMAP).
//
// One block owns a TN x TQ tile of the (n, q) mask; each of its 256
// threads owns RPT = 4 outputs of one query column, so a warp writes 32
// neighbouring queries of one row.  The subspace axis M is walked in chunks
// of MC: each chunk stages the block's rows of the corner tables and the
// query tile's columns of the query tables in shared memory, then every
// thread folds the chunk into its admit flags.  M is looped at its real
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

// Operands of one launch: corner tables (n, m) row-major, query tables
// (q, m), the (n, q) int32 mask.
struct PruneArgs {
  const float* amin;
  const float* gmax;
  const float* qc;
  const float* sd;
  const float* qb;
  int32_t* admit;
  int64_t n;
  int m;
  int q;
};

__global__ void __launch_bounds__(THREADS)
filter_tile_kernel(const PruneArgs p) {
  __shared__ float s_amin[TN][MC + 1];
  __shared__ float s_gmax[TN][MC + 1];
  __shared__ float s_sd[MC][TQ + 1];
  __shared__ float s_qc[MC][TQ + 1];
  __shared__ float s_qb[MC][TQ + 1];

  const int tid = threadIdx.x;
  const int tq = tid % TQ;
  const int tr = tid / TQ;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TN;
  const int q0 = blockIdx.y * TQ;
  const int64_t n = p.n;
  const int m = p.m;
  const int q = p.q;

  bool hit[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) hit[i] = false;

  for (int m0 = 0; m0 < m; m0 += MC) {
    const int mc = min(MC, m - m0);
    for (int e = tid; e < TN * MC; e += THREADS) {
      const int r = e / MC;
      const int c = e % MC;
      const int64_t row = row0 + r;
      const bool ok = row < n && c < mc;
      const int64_t off = row * m + m0 + c;
      s_amin[r][c] = ok ? p.amin[off] : 0.f;
      s_gmax[r][c] = ok ? p.gmax[off] : 0.f;
    }
    for (int e = tid; e < TQ * MC; e += THREADS) {
      const int j = e / MC;
      const int c = e % MC;
      const bool ok = q0 + j < q && c < mc;
      const int64_t off = static_cast<int64_t>(q0 + j) * m + m0 + c;
      s_sd[c][j] = ok ? p.sd[off] : 0.f;
      s_qc[c][j] = ok ? p.qc[off] : 0.f;
      s_qb[c][j] = ok ? p.qb[off] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < mc; ++c) {
      const float sdv = s_sd[c][tq];
      const float qcv = s_qc[c][tq];
      const float qbv = s_qb[c][tq];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = tr + i * ROW_STRIDE;
        // Each operation rounded on its own, as the plain version does:
        // the intrinsics keep nvcc from contracting into a fused
        // multiply-add, so the admit bit is the same on both.
        const float lb = __fsub_rn(__fadd_rn(s_amin[r][c], qcv),
                                   __fmul_rn(s_gmax[r][c], sdv));
        hit[i] = hit[i] || (lb <= qbv);
      }
    }
    __syncthreads();
  }

  const int j = q0 + tq;
  if (j >= q) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t row = row0 + tr + i * ROW_STRIDE;
    if (row < n) p.admit[row * q + j] = hit[i] ? 1 : 0;
  }
}

inline int launch_filter_tile(const PruneArgs& args, int64_t m, int64_t q,
                              int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (args.n <= 0 || q <= 0) return 0;
  if (m <= 0 || m > INT32_MAX || q > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  PruneArgs p = args;
  p.m = static_cast<int>(m);
  p.q = static_cast<int>(q);
  const dim3 grid(static_cast<unsigned>((p.n + TN - 1) / TN),
                  static_cast<unsigned>((q + TQ - 1) / TQ));
  filter_tile_kernel<<<grid, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace brekernels
