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
// Every entry runs filter_span.cuh's tile with the totals switched off
// (PRUNE true, UB false): brk_prune_mask (fp32, #5) and
// brk_prune_mask_quant (int8 codes, #6) over any row span (the tiered
// store's Stage B window or its pooled rows), brk_prune_mask_blocks and
// brk_prune_mask_blocks_quant over a device list of row blocks of the full
// tables (the unfused search's admitted blocks), each in one persistent
// launch.  Only the corner tables (and, for int8, their four decode
// columns) are staged and only the int32 mask is written; the decode
// __fadd_rn(__fmul_rn(code, scale), zp) and the compare
// __fsub_rn(__fadd_rn(amin, qc), __fmul_rn(gmax, sd)) <= qb are the fused
// kernels' own, so each mask is bit-equal to the admit output of
// brk_filter_prune(_blocks)(_quant) on the same corners.  The tiered store
// relies on that: it prunes fetched blocks with these kernels and must
// select the rows the resident search selects.
//
// Bound on the H100 (80GB HBM3, 3.35 TB/s at 700 W): bytes.  Over a Deep
// attempt's 245 blocks of 4096 rows (M = 39, q = 14) the fp32 block-list
// launch reads two (n, M) fp32 corner tables, 313 MB, and writes a 56 MB
// int32 mask: 0.110 ms, against about 2.2 GFLOP of adds, multiplies,
// subtracts and compares (0.033 ms at 67 TFLOP/s, though they issue at
// about #3's admit share, near 0.1 ms).  The int8 launch reads 78 MB of
// codes and 16 MB of decode columns and writes a 52 MB mask at q = 13,
// about 0.044 ms.  One 4096-row block alone (1.28 MB of fp32 corners) is
// bound by the launch, not its 0.45 us of bytes.
#include "filter_span.cuh"

using brekernels::span::Tables;

namespace {

Tables<float> prune_tables(const float* amin, const float* gmax,
                           const float* qconst, const float* sqrt_delta,
                           const float* qb, int32_t* admit, int64_t n) {
  Tables<float> t = {};
  t.amin = amin;
  t.gmax = gmax;
  t.qc = qconst;
  t.sd = sqrt_delta;
  t.qb = qb;
  t.admit = admit;
  t.n = n;
  return t;
}

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

// fp32: a row span, the corner tables' n rows, output (n, q).
extern "C" int brk_prune_mask(const float* amin, const float* gmax,
                              const float* qconst, const float* sqrt_delta,
                              const float* qb, int32_t* admit, int64_t n,
                              int64_t m, int64_t q, int device, void* stream) {
  Tables<float> t = prune_tables(amin, gmax, qconst, sqrt_delta, qb, admit,
                                 n);
  t.bn = n > 0 ? n : 1;      // the span is one block
  t.nblocks = 1;
  return brekernels::span::launch_filter_span<float, true, false>(
      t, m, q, device, static_cast<cudaStream_t>(stream));
}

// fp32: the row blocks listed in blocks (nblocks int32 ids on the device)
// of the (n, m) corner tables, bn rows a block; output (nblocks * bn, q),
// listed block li's rows at [li * bn, (li + 1) * bn), a short block's rows
// past n inert (admit 0).
extern "C" int brk_prune_mask_blocks(const float* amin, const float* gmax,
                                     const float* qconst,
                                     const float* sqrt_delta, const float* qb,
                                     const int32_t* blocks, int32_t* admit,
                                     int64_t n, int64_t m, int64_t q,
                                     int64_t nblocks, int64_t bn, int device,
                                     void* stream) {
  if (blocks == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Tables<float> t = prune_tables(amin, gmax, qconst, sqrt_delta, qb, admit,
                                 n);
  t.blocks = blocks;
  t.bn = bn;
  t.nblocks = nblocks;
  return brekernels::span::launch_filter_span<float, true, false>(
      t, m, q, device, static_cast<cudaStream_t>(stream));
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
