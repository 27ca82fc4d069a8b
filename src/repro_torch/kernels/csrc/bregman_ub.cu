// Filter kernels: the (n, q) Cauchy upper-bound totals of a row span.
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
// Bound on the H100: bytes.  The fp32 entry runs filter_span.cuh's tile
// over any row span in one persistent launch: the search hands it many
// consecutive row blocks at once (a Deep attempt's 10^6 rows, 312 MB of
// tables and 56 MB of totals, 0.11 ms at 3.35 TB/s), staged through
// shared memory in contiguous spans, a thread a row and 8 queries.  The
// int8 entry keeps filter_tile.cuh's per-block tile: a 4096-row launch
// reads a quarter of the fp32 bytes plus four fp32 scalars a row, each
// element once, looping over the real M.
#include "filter_span.cuh"
#include "filter_tile.cuh"

using brekernels::FilterArgs;

extern "C" int brk_ub_matrix(const float* alpha, const float* sqrt_gamma,
                             const float* qsum, const float* sqrt_delta,
                             float* ub, int64_t n, int64_t m, int64_t q,
                             int device, void* stream) {
  brekernels::span::Tables<float> t = {};
  t.alpha = alpha;
  t.sg = sqrt_gamma;
  t.qsum = qsum;
  t.sd = sqrt_delta;
  t.ub = ub;
  t.n = n;
  t.bn = n > 0 ? n : 1;      // the span is one block
  t.nblocks = 1;
  return brekernels::span::launch_filter_span<float, false>(
      t, m, q, device, static_cast<cudaStream_t>(stream));
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
