// Filter kernels: the (n, q) Cauchy upper-bound totals of a row block.
//
//   ub[n, q] = (rowsum(alpha)[n] + qsum[q]) + sqrt_gamma[n, :] . sqrt_delta[q, :]
//
// brk_ub_matrix replaces the TPU kernel src/repro/kernels/bregman_ub.py::
// bregman_ub_matrix (a (bn, M) x (M, q) MXU product with a rank-1 bias, M
// padded to 128 lanes); brk_ub_matrix_quant replaces bregman_ub.py::
// bregman_ub_matrix_quant, the same totals from int8 codes with the per-row
// affine factored out of both reductions:
//
//   ub[n, q] = (a_s[n] * sum(alpha_q[n, :]) + M * a_z[n] + qsum[q])
//              + (g_s[n] * (sg_q[n, :] . sd[q, :]) + g_z[n] * sum(sd[q, :]))
//
// Bound on the H100: bytes.  At the search path's shape (a 4096-row block,
// M of about 30-40, q = 14-50) one fp32 launch reads about 1.2 MB of point
// tables and writes 0.8 MB or less, under a microsecond at 3.35 TB/s,
// against about 15 MFLOP (0.2 us at 67 TFLOP/s fp32); the int8 launch reads
// a quarter of the table bytes plus four fp32 scalars a row.  So the kernel
// reads each table element once into shared memory, keeps the M-loop in
// registers, writes each output once, and loops over the real M instead of
// padding it.  At this size the launch itself costs more than the work; one
// persistent launch over all blocks is later work.
#include "filter_tile.cuh"

using brekernels::FilterArgs;

extern "C" int brk_ub_matrix(const float* alpha, const float* sqrt_gamma,
                             const float* qsum, const float* sqrt_delta,
                             float* ub, int64_t n, int64_t m, int64_t q,
                             int device, void* stream) {
  FilterArgs<float> a = {};
  a.alpha = alpha;
  a.sg = sqrt_gamma;
  a.qsum = qsum;
  a.sd = sqrt_delta;
  a.ub = ub;
  a.n = n;
  return brekernels::launch_filter_tile<float, false>(
      a, m, q, device, static_cast<cudaStream_t>(stream));
}

extern "C" int brk_ub_matrix_quant(const int8_t* alpha_q,
                                   const float* alpha_scale,
                                   const float* alpha_zp, const int8_t* sg_q,
                                   const float* sg_scale, const float* sg_zp,
                                   const float* qsum, const float* sqrt_delta,
                                   const float* sdsum, float* ub, int64_t n,
                                   int64_t m, int64_t q, int device,
                                   void* stream) {
  FilterArgs<int8_t> a = {};
  a.alpha = alpha_q;
  a.sg = sg_q;
  a.decode[brekernels::kAlphaScale] = alpha_scale;
  a.decode[brekernels::kAlphaZp] = alpha_zp;
  a.decode[brekernels::kSgScale] = sg_scale;
  a.decode[brekernels::kSgZp] = sg_zp;
  a.qsum = qsum;
  a.sd = sqrt_delta;
  a.sdsum = sdsum;
  a.ub = ub;
  a.n = n;
  return brekernels::launch_filter_tile<int8_t, false>(
      a, m, q, device, static_cast<cudaStream_t>(stream));
}
