// Prune-only kernels: the Theorem-3 admit mask of a row block, alone.
//
//   admit[n, q] = any_i ( (amin[n, i] + qconst[q, i]) - gmax[n, i] * sd[q, i]
//                         <= qb[q, i] )
//
// brk_prune_mask replaces the TPU kernel src/repro/kernels/bregman_prune.py::
// bregman_prune_mask (the subspace axis a static in-kernel loop over the real
// M, the (bn, M, q) lower-bound tensor never formed); brk_prune_mask_quant
// replaces bregman_prune.py::bregman_prune_mask_quant, the same mask over
// int8 corner codes decoded per element as amin = code * am_s + am_z
// (floor-coded) and gmax = code * gm_s + gm_z (ceil-coded).  The corner codes
// were rounded towards the conservative side at encode, so no slack term
// enters.  Inert pad rows (scale 0, zero-point 1e30) decode to 1e30 like any
// other row and never admit.
//
// Both are filter_tile.cuh's tile with the totals switched off: only the
// corner tables (and their decode) are staged, only the int32 mask is
// written, and the compare __fsub_rn(__fadd_rn(amin, qc), __fmul_rn(gmax,
// sd)) <= qb and the decode __fadd_rn(__fmul_rn(code, scale), zp) are the
// fused kernels' own, so this mask is bit-equal to the admit output of
// brk_filter_prune(_quant) on the same corners.  The tiered store relies
// on that: it prunes fetched blocks with these kernels and must select the
// rows the resident search selects.
//
// Bound on the H100: bytes.  At Deep's block shape (4096 rows, M = 39,
// q = 14) one fp32 launch reads two (n, M) fp32 tables, 1.28 MB, and
// writes a 0.23 MB int32 mask, about 0.45 us at 3.35 TB/s, against about
// 9 MFLOP of compares (0.13 us at 67 TFLOP/s); the int8 launch reads a
// quarter of the table bytes plus four fp32 scalars a row.  The launch,
// not the bytes, bounds it at that size.
#include "filter_tile.cuh"

using brekernels::FilterArgs;

extern "C" int brk_prune_mask(const float* amin, const float* gmax,
                              const float* qconst, const float* sqrt_delta,
                              const float* qb, int32_t* admit, int64_t n,
                              int64_t m, int64_t q, int device, void* stream) {
  FilterArgs<float> a = {};
  a.amin = amin;
  a.gmax = gmax;
  a.qc = qconst;
  a.sd = sqrt_delta;
  a.qb = qb;
  a.admit = admit;
  a.n = n;
  return brekernels::launch_filter_tile<float, true, false>(
      a, m, q, device, static_cast<cudaStream_t>(stream));
}

extern "C" int brk_prune_mask_quant(
    const int8_t* amin_q, const float* amin_scale, const float* amin_zp,
    const int8_t* gmax_q, const float* gmax_scale, const float* gmax_zp,
    const float* qconst, const float* sqrt_delta, const float* qb,
    int32_t* admit, int64_t n, int64_t m, int64_t q, int device,
    void* stream) {
  FilterArgs<int8_t> a = {};
  a.amin = amin_q;
  a.gmax = gmax_q;
  a.decode[brekernels::kAminScale] = amin_scale;
  a.decode[brekernels::kAminZp] = amin_zp;
  a.decode[brekernels::kGmaxScale] = gmax_scale;
  a.decode[brekernels::kGmaxZp] = gmax_zp;
  a.qc = qconst;
  a.sd = sqrt_delta;
  a.qb = qb;
  a.admit = admit;
  a.n = n;
  return brekernels::launch_filter_tile<int8_t, true, false>(
      a, m, q, device, static_cast<cudaStream_t>(stream));
}
