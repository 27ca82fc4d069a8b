// Shared tile body of the int8 filter kernel #2 (bregman_ub.cu) and of the
// prune-only kernels #5 and #6 (bregman_prune.cu), fp32 and int8 tables
// alike; the fp32 filter #1 and the fused kernels #3 and #4 run
// filter_span.cuh, which keeps this tile's arithmetic operation for
// operation (and takes its Decode column order).
//
// One block owns a TN x TQ tile of the (n, q) output; each of its 256
// threads owns RPT = 4 outputs of one query column, so a warp writes 32
// neighbouring queries of one row.  The subspace axis M is walked in chunks
// of MC: each chunk stages the block's rows of the point tables and the
// query tile's columns of the query tables in shared memory, then every
// thread folds the chunk into its running sums.  M is looped at its real
// width; nothing is padded to a lane multiple.
//
// The table type T is float (the fp32 tier) or int8_t (codes of the int8
// tier, each row with its own affine decode ``code * scale + zp``).  For
// int8 the row loader differs and nothing else: the filter stats stay
// codes and their per-row affine is applied once per output, factored out
// of both sums (the row sum of codes is an exact integer); the corner
// codes are decoded as they are staged, op by op, so the admit compare
// sees the values ``dequantize_stats`` gives.
//
// Two switches pick the outputs: UB computes and writes the (n, q) totals,
// PRUNE the int32 admit mask.  Without UB the filter tables and their
// decode are neither staged nor read, so the prune-only kernels read just
// the corners; their decode and admit compare are the fused kernels'
// (filter_span.cuh) operation for operation, so the masks are bit-equal.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace brekernels {

constexpr int TN = 32;        // rows per block
constexpr int TQ = 32;        // queries per block
constexpr int MC = 32;        // subspaces staged per chunk
constexpr int THREADS = 256;
constexpr int ROW_STRIDE = THREADS / TQ;   // 8 row groups
constexpr int RPT = TN / ROW_STRIDE;       // 4 outputs per thread

// The per-row decode columns of an int8 block, in this order.
enum Decode { kAlphaScale = 0, kAlphaZp, kSgScale, kSgZp,
              kAminScale, kAminZp, kGmaxScale, kGmaxZp, kDecodeCols };

// Operands of one launch.  Point tables are (n, m) row-major, query tables
// (q, m); ``decode`` (int8 only) holds the (n,) decode columns: the first
// four always, the corners' four only where the kernel prunes.
//   ub[r, j]    = rowsum(alpha_hat)[r] + qsum[j] + sg_hat[r, :] . sd[j, :]
//                                                          (UB only)
//   admit[r, j] = any_i (amin_hat[r, i] + qc[j, i]) - gmax_hat[r, i] * sd[j, i]
//                       <= qb[j, i]                        (PRUNE only)
template <typename T>
struct FilterArgs {
  const T* alpha;
  const T* sg;
  const T* amin;
  const T* gmax;
  const float* decode[kDecodeCols];
  const float* qsum;
  const float* qc;
  const float* sd;
  const float* sdsum;      // int8 only: sum_i sd[j, i]
  const float* qb;
  float* ub;
  int32_t* admit;
  int64_t n;
  int m;
  int q;
};

template <typename T, bool PRUNE, bool UB>
__global__ void __launch_bounds__(THREADS)
filter_tile_kernel(const FilterArgs<T> p) {
  static_assert(UB || PRUNE, "a tile writes the totals, the mask or both");
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  // Row sums: exact integers for codes (|code| <= 128, M < 2^24 / 128).
  using RowSum = typename std::conditional<QUANT, int, float>::type;
  constexpr int PR = PRUNE ? TN : 1;
  constexpr int PQ = PRUNE ? MC : 1;
  constexpr int DR = QUANT ? TN : 1;
  constexpr int UR = UB ? TN : 1;
  __shared__ T s_alpha[UR][MC + 1];
  __shared__ float s_sg[UR][MC + 1];
  __shared__ float s_amin[PR][MC + 1];
  __shared__ float s_gmax[PR][MC + 1];
  __shared__ float s_sd[MC][TQ + 1];
  __shared__ float s_qc[PQ][TQ + 1];
  __shared__ float s_qb[PQ][TQ + 1];
  __shared__ float s_dec[kDecodeCols][DR];

  const int tid = threadIdx.x;
  const int tq = tid % TQ;
  const int tr = tid / TQ;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * TN;
  const int q0 = blockIdx.y * TQ;
  const int64_t n = p.n;
  const int m = p.m;
  const int q = p.q;

  if constexpr (QUANT) {
    // The filter stats' columns where the kernel sums, and the corners'
    // where it prunes.
    constexpr int first = UB ? 0 : kAminScale;
    constexpr int last = PRUNE ? kDecodeCols : kAminScale;
    for (int e = tid; e < (last - first) * TN; e += THREADS) {
      const int col = first + e / TN;
      const int r = e % TN;
      s_dec[col][r] = row0 + r < n ? p.decode[col][row0 + r] : 0.f;
    }
    __syncthreads();
  }

  RowSum rowsum[RPT];
  float cauchy[RPT];
  bool hit[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    rowsum[i] = 0;
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
      if constexpr (UB) {
        s_alpha[r][c] = ok ? p.alpha[off] : T(0);
        s_sg[r][c] = ok ? static_cast<float>(p.sg[off]) : 0.f;
      }
      if constexpr (PRUNE) {
        float am = 0.f;
        float gm = 0.f;
        if (ok) {
          if constexpr (QUANT) {
            // code * scale + zp, each operation rounded on its own.
            am = __fadd_rn(__fmul_rn(static_cast<float>(p.amin[off]),
                                     s_dec[kAminScale][r]),
                           s_dec[kAminZp][r]);
            gm = __fadd_rn(__fmul_rn(static_cast<float>(p.gmax[off]),
                                     s_dec[kGmaxScale][r]),
                           s_dec[kGmaxZp][r]);
          } else {
            am = p.amin[off];
            gm = p.gmax[off];
          }
        }
        s_amin[r][c] = am;
        s_gmax[r][c] = gm;
      }
    }
    for (int e = tid; e < TQ * MC; e += THREADS) {
      const int j = e / MC;
      const int c = e % MC;
      const bool ok = q0 + j < q && c < mc;
      const int64_t off = static_cast<int64_t>(q0 + j) * m + m0 + c;
      s_sd[c][j] = ok ? p.sd[off] : 0.f;
      if constexpr (PRUNE) {
        s_qc[c][j] = ok ? p.qc[off] : 0.f;
        s_qb[c][j] = ok ? p.qb[off] : 0.f;
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
        if constexpr (UB) {
          rowsum[i] += s_alpha[r][c];
          cauchy[i] = fmaf(s_sg[r][c], sdv, cauchy[i]);
        }
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
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tr + i * ROW_STRIDE;
    const int64_t row = row0 + r;
    if (row >= n) continue;
    if constexpr (PRUNE) p.admit[row * q + j] = hit[i] ? 1 : 0;
    if constexpr (UB) {
      const float qs = p.qsum[j];
      float total;
      if constexpr (QUANT) {
        // The per-row affine, factored out of both sums.
        const float arow = s_dec[kAlphaScale][r] * static_cast<float>(rowsum[i])
                           + static_cast<float>(m) * s_dec[kAlphaZp][r];
        const float dot = s_dec[kSgScale][r] * cauchy[i]
                          + s_dec[kSgZp][r] * p.sdsum[j];
        total = (arow + qs) + dot;
      } else {
        total = (rowsum[i] + qs) + cauchy[i];
      }
      p.ub[row * q + j] = total;
    }
  }
}

template <typename T, bool PRUNE, bool UB = true>
inline int launch_filter_tile(const FilterArgs<T>& args, int64_t m, int64_t q,
                              int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (args.n <= 0 || q <= 0) return 0;
  if (m <= 0 || m > INT32_MAX || q > INT32_MAX ||
      (std::is_same<T, int8_t>::value && m >= (1 << 24) / 128))
    return static_cast<int>(cudaErrorInvalidValue);
  FilterArgs<T> p = args;
  p.m = static_cast<int>(m);
  p.q = static_cast<int>(q);
  const dim3 grid(static_cast<unsigned>((p.n + TN - 1) / TN),
                  static_cast<unsigned>((q + TQ - 1) / TQ));
  filter_tile_kernel<T, PRUNE, UB><<<grid, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace brekernels
