// Fused filter + prune kernels: a row block's UB tile and Theorem-3 admit mask.
//
//   ub[n, q]    = (rowsum(alpha)[n] + qsum[q]) + sqrt_gamma[n, :] . sd[q, :]
//   admit[n, q] = any_i ( (amin[n, i] + qconst[q, i]) - gmax[n, i] * sd[q, i]
//                         <= qb[q, i] )
//
// brk_filter_prune replaces the TPU kernel src/repro/kernels/bregman_fused.py::
// bregman_filter_prune (both tiles in one VMEM-resident pass; the admit
// loop runs over the real M only).  brk_filter_prune_quant replaces
// bregman_fused.py::bregman_filter_prune_quant: the UB of bregman_ub.cu's
// int8 entry, and the admit over corner codes decoded per element as
// amin = code * am_s + am_z (floor-coded) and gmax = code * gm_s + gm_z
// (ceil-coded), each operation rounded on its own.  That decode is the one
// the block envelopes were reduced over (core/index.refresh_envelopes): a
// decode one ulp lower here would admit a row whose block the envelope gate
// skipped, and the row would go missing, so the decode and the compare are
// written with round-to-nearest intrinsics and no FMA.
//
// Bound on the H100: bytes.  One fp32 launch over a 4096-row block (M of
// about 30-40, q = 14-50) reads four (n, M) fp32 tables, about 2.4 MB, and
// writes the f32 UB and int32 admit tiles, up to 1.6 MB: about 1.2 us at
// 3.35 TB/s, against about 50 MFLOP of compare arithmetic; the int8 launch
// reads a quarter of the table bytes plus eight fp32 scalars a row.  The
// query tile's sqrt_delta chunk is staged in shared memory once and feeds
// both the Cauchy sum and the admit loop, each table element is read and
// decoded once, and the admit mask stays bit-equal to the plain PyTorch
// version.  Rows past n are neither read nor written.
#include "filter_tile.cuh"

using brekernels::FilterArgs;

extern "C" int brk_filter_prune(const float* alpha, const float* sqrt_gamma,
                                const float* amin, const float* gmax,
                                const float* qsum, const float* qconst,
                                const float* sqrt_delta, const float* qb,
                                float* ub, int32_t* admit, int64_t n,
                                int64_t m, int64_t q, int device,
                                void* stream) {
  FilterArgs<float> a = {};
  a.alpha = alpha;
  a.sg = sqrt_gamma;
  a.amin = amin;
  a.gmax = gmax;
  a.qsum = qsum;
  a.qc = qconst;
  a.sd = sqrt_delta;
  a.qb = qb;
  a.ub = ub;
  a.admit = admit;
  a.n = n;
  return brekernels::launch_filter_tile<float, true>(
      a, m, q, device, static_cast<cudaStream_t>(stream));
}

extern "C" int brk_filter_prune_quant(
    const int8_t* alpha_q, const float* alpha_scale, const float* alpha_zp,
    const int8_t* sg_q, const float* sg_scale, const float* sg_zp,
    const int8_t* amin_q, const float* amin_scale, const float* amin_zp,
    const int8_t* gmax_q, const float* gmax_scale, const float* gmax_zp,
    const float* qsum, const float* qconst, const float* sqrt_delta,
    const float* sdsum, const float* qb, float* ub, int32_t* admit,
    int64_t n, int64_t m, int64_t q, int device, void* stream) {
  FilterArgs<int8_t> a = {};
  a.alpha = alpha_q;
  a.sg = sg_q;
  a.amin = amin_q;
  a.gmax = gmax_q;
  a.decode[brekernels::kAlphaScale] = alpha_scale;
  a.decode[brekernels::kAlphaZp] = alpha_zp;
  a.decode[brekernels::kSgScale] = sg_scale;
  a.decode[brekernels::kSgZp] = sg_zp;
  a.decode[brekernels::kAminScale] = amin_scale;
  a.decode[brekernels::kAminZp] = amin_zp;
  a.decode[brekernels::kGmaxScale] = gmax_scale;
  a.decode[brekernels::kGmaxZp] = gmax_zp;
  a.qsum = qsum;
  a.qc = qconst;
  a.sd = sqrt_delta;
  a.sdsum = sdsum;
  a.qb = qb;
  a.ub = ub;
  a.admit = admit;
  a.n = n;
  return brekernels::launch_filter_tile<int8_t, true>(
      a, m, q, device, static_cast<cudaStream_t>(stream));
}
