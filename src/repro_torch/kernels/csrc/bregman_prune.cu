// Prune-only kernels: the Theorem-3 admit mask of row blocks, alone.
//
//   admit[n, q] = any_i ( (amin[n, i] + qconst[q, i]) - gmax[n, i] * sd[q, i]
//                         <= qb[q, i] )
//
// brk_prune_mask replaces the TPU kernel src/repro/kernels/bregman_prune.py::
// bregman_prune_mask (the subspace axis a static in-kernel loop over the real
// M, the (bn, M, q) lower-bound tensor never formed); brk_prune_mask_quant
// and brk_prune_mask_blocks_quant replace bregman_prune.py::
// bregman_prune_mask_quant, the same mask over int8 corner codes decoded per
// element as amin = code * am_s + am_z (floor-coded) and gmax = code * gm_s
// + gm_z (ceil-coded).  The corner codes were rounded towards the
// conservative side at encode, so no slack term enters.  Inert pad rows
// (scale 0, zero-point 1e30) decode to 1e30 like any other row and never
// admit.
//
// The fp32 entry (#5) is filter_tile.cuh's per-block tile.  The int8
// entries (#6) run filter_span.cuh's codes path with the totals switched
// off: brk_prune_mask_quant over any row span
// (the tiered store's fetched block or its pooled rows) and
// brk_prune_mask_blocks_quant over a device list of row blocks of the full
// tables (the unfused search's admitted blocks), each in one persistent
// launch.  Only the corner tables and their four decode columns are staged
// and only the int32 mask is written; the decode __fadd_rn(__fmul_rn(code,
// scale), zp) and the compare __fsub_rn(__fadd_rn(amin, qc), __fmul_rn(gmax,
// sd)) <= qb are the fused kernels' own, so each mask is bit-equal to the
// admit output of brk_filter_prune(_blocks)(_quant) on the same corners.
// The tiered store relies on that: it prunes fetched blocks with these
// kernels and must select the rows the resident search selects.
//
// Bound on the H100: bytes.  At Deep's block shape (4096 rows, M = 39,
// q = 14) one fp32 launch reads two (n, M) fp32 tables, 1.28 MB, and
// writes a 0.23 MB int32 mask, about 0.45 us at 3.35 TB/s: the launch, not
// the bytes, bounds it.  Over a Deep int8 attempt's 245 blocks the int8
// block-list launch reads 78 MB of codes and 16 MB of decode columns and
// writes a 52 MB mask at q = 13, about 0.044 ms, against about 2.2 GFLOP
// of decodes and compares (0.033 ms at 67 TFLOP/s).
#include "filter_span.cuh"
#include "filter_tile.cuh"

using brekernels::span::Tables;

namespace {

Tables<int8_t> prune_tables_quant(
    const int8_t* amin_q, const float* amin_scale, const float* amin_zp,
    const int8_t* gmax_q, const float* gmax_scale, const float* gmax_zp,
    const float* qconst, const float* sqrt_delta, const float* qb,
    int32_t* admit, int64_t n) {
  Tables<int8_t> t = {};
  t.amin = amin_q;
  t.gmax = gmax_q;
  t.decode[brekernels::kAminScale] = amin_scale;
  t.decode[brekernels::kAminZp] = amin_zp;
  t.decode[brekernels::kGmaxScale] = gmax_scale;
  t.decode[brekernels::kGmaxZp] = gmax_zp;
  t.qc = qconst;
  t.sd = sqrt_delta;
  t.qb = qb;
  t.admit = admit;
  t.n = n;
  return t;
}

}  // namespace

extern "C" int brk_prune_mask(const float* amin, const float* gmax,
                              const float* qconst, const float* sqrt_delta,
                              const float* qb, int32_t* admit, int64_t n,
                              int64_t m, int64_t q, int device, void* stream) {
  brekernels::PruneArgs a = {};
  a.amin = amin;
  a.gmax = gmax;
  a.qc = qconst;
  a.sd = sqrt_delta;
  a.qb = qb;
  a.admit = admit;
  a.n = n;
  return brekernels::launch_filter_tile(a, m, q, device,
                                        static_cast<cudaStream_t>(stream));
}

// int8: a row span, the code tables' n rows, output (n, q).
extern "C" int brk_prune_mask_quant(
    const int8_t* amin_q, const float* amin_scale, const float* amin_zp,
    const int8_t* gmax_q, const float* gmax_scale, const float* gmax_zp,
    const float* qconst, const float* sqrt_delta, const float* qb,
    int32_t* admit, int64_t n, int64_t m, int64_t q, int device,
    void* stream) {
  Tables<int8_t> t = prune_tables_quant(amin_q, amin_scale, amin_zp, gmax_q,
                                        gmax_scale, gmax_zp, qconst,
                                        sqrt_delta, qb, admit, n);
  t.bn = n > 0 ? n : 1;      // the span is one block
  t.nblocks = 1;
  return brekernels::span::launch_filter_span<int8_t, true, false>(
      t, m, q, device, static_cast<cudaStream_t>(stream));
}

// int8: the row blocks listed in blocks (nblocks int32 ids on the device)
// of the (n, m) corner tables, bn rows a block; output (nblocks * bn, q),
// listed block li's rows at [li * bn, (li + 1) * bn), a short block's rows
// past n inert (admit 0).
extern "C" int brk_prune_mask_blocks_quant(
    const int8_t* amin_q, const float* amin_scale, const float* amin_zp,
    const int8_t* gmax_q, const float* gmax_scale, const float* gmax_zp,
    const float* qconst, const float* sqrt_delta, const float* qb,
    const int32_t* blocks, int32_t* admit, int64_t n, int64_t m, int64_t q,
    int64_t nblocks, int64_t bn, int device, void* stream) {
  if (blocks == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Tables<int8_t> t = prune_tables_quant(amin_q, amin_scale, amin_zp, gmax_q,
                                        gmax_scale, gmax_zp, qconst,
                                        sqrt_delta, qb, admit, n);
  t.blocks = blocks;
  t.bn = bn;
  t.nblocks = nblocks;
  return brekernels::span::launch_filter_span<int8_t, true, false>(
      t, m, q, device, static_cast<cudaStream_t>(stream));
}
