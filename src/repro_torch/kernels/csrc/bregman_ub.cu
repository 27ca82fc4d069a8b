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
// Bound on the H100: bytes.  Both entries run filter_span.cuh's tile over
// any row span in one persistent launch, so the search hands them many
// consecutive row blocks at once.  Over a Deep attempt (10^6 rows, M = 39)
// the fp32 entry reads 312 MB of tables and writes 56 MB of totals at
// q = 14, 0.11 ms at 3.35 TB/s; the int8 entry reads 78 MB of codes and
// 16 MB of decode columns and writes 52 MB at q = 13, 0.044 ms.  Spans are
// staged through shared memory by cp.async (int8 codes in 16-byte pieces
// where aligned, the item's four filter decode columns beside them), a
// thread a row and 8 queries, each element read once.  The int8 epilogue
// is written with _rn intrinsics in the form nvcc contracted the per-block
// kernel's ``s * rowsum + m * z`` and ``g_s * cauchy + g_z * sdsum`` into,
// so the totals keep that kernel's bits (tools/kernel_tree_parity.py
// holds them as int32 words).
#include "filter_span.cuh"

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
  brekernels::span::Tables<int8_t> t = {};
  t.alpha = alpha_q;
  t.sg = sg_q;
  t.decode[brekernels::kAlphaScale] = alpha_scale;
  t.decode[brekernels::kAlphaZp] = alpha_zp;
  t.decode[brekernels::kSgScale] = sg_scale;
  t.decode[brekernels::kSgZp] = sg_zp;
  t.qsum = qsum;
  t.sd = sqrt_delta;
  t.sdsum = sdsum;
  t.ub = ub;
  t.n = n;
  t.bn = n > 0 ? n : 1;      // the span is one block
  t.nblocks = 1;
  return brekernels::span::launch_filter_span<int8_t, false>(
      t, m, q, device, static_cast<cudaStream_t>(stream));
}
