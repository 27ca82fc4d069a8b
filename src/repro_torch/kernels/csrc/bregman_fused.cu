// Fused filter + prune kernel: a row block's UB tile and Theorem-3 admit mask.
//
//   ub[n, q]    = (rowsum(alpha)[n] + qsum[q]) + sqrt_gamma[n, :] . sd[q, :]
//   admit[n, q] = any_i ( (amin[n, i] + qconst[q, i]) - gmax[n, i] * sd[q, i]
//                         <= qb[q, i] )
//
// Replaces the TPU kernel src/repro/kernels/bregman_fused.py::
// bregman_filter_prune (both tiles in one VMEM-resident pass; the admit
// loop runs over the real M only).
//
// Bound on the H100: bytes.  One launch over a 4096-row block (M of about
// 28-37, q = 50) reads four (n, M) fp32 tables, about 2.4 MB, and writes
// the f32 UB and int32 admit tiles, about 1.6 MB: about 1.2 us at
// 3.35 TB/s, against about 50 MFLOP of compare arithmetic.  The query
// tile's sqrt_delta chunk is staged in shared memory once and feeds both
// the Cauchy sum and the admit loop, each table element is read once, and
// the admit compare is written with round-to-nearest intrinsics so it
// cannot be contracted into an FMA and stays bit-equal to the plain
// PyTorch version.  Rows past n are neither read nor written.
#include "filter_tile.cuh"

extern "C" int brk_filter_prune(const float* alpha, const float* sqrt_gamma,
                                const float* amin, const float* gmax,
                                const float* qsum, const float* qconst,
                                const float* sqrt_delta, const float* qb,
                                float* ub, int32_t* admit, int64_t n,
                                int64_t m, int64_t q, int device,
                                void* stream) {
  return brekernels::launch_filter_tile<true>(
      alpha, sqrt_gamma, amin, gmax, qsum, qconst, sqrt_delta, qb, ub, admit,
      n, m, q, device, static_cast<cudaStream_t>(stream));
}
