// Filter kernel: the (n, q) Cauchy upper-bound totals of a row block.
//
//   ub[n, q] = (rowsum(alpha)[n] + qsum[q]) + sqrt_gamma[n, :] . sqrt_delta[q, :]
//
// Replaces the TPU kernel src/repro/kernels/bregman_ub.py::bregman_ub_matrix
// (a (bn, M) x (M, q) MXU product with a rank-1 bias, M padded to 128 lanes).
//
// Bound on the H100: bytes.  At the search path's shape (a 4096-row block,
// M of about 28-37, q = 50) one launch reads about 1.2 MB of point tables and
// writes 0.8 MB, under a microsecond at 3.35 TB/s, against about 15 MFLOP
// (0.2 us at 67 TFLOP/s fp32).  So the kernel reads each table element once
// into shared memory, keeps the M-loop in registers, writes each output
// once, and loops over the real M instead of padding it.  At this size the
// launch itself costs more than the work; one persistent launch over all
// blocks is later work.
#include "filter_tile.cuh"

extern "C" int brk_ub_matrix(const float* alpha, const float* sqrt_gamma,
                             const float* qsum, const float* sqrt_delta,
                             float* ub, int64_t n, int64_t m, int64_t q,
                             int device, void* stream) {
  return brekernels::launch_filter_tile<false>(
      alpha, sqrt_gamma, nullptr, nullptr, qsum, nullptr, sqrt_delta,
      nullptr, ub, nullptr, n, m, q, device,
      static_cast<cudaStream_t>(stream));
}
