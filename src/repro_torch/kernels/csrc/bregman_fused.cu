// Fused filter + prune kernels: the UB tile and Theorem-3 admit mask of
// row blocks.
//
//   ub[n, q]    = (rowsum(alpha)[n] + qsum[q]) + sqrt_gamma[n, :] . sd[q, :]
//   admit[n, q] = any_i ( (amin[n, i] + qconst[q, i]) - gmax[n, i] * sd[q, i]
//                         <= qb[q, i] )
//
// brk_filter_prune_blocks and brk_filter_prune replace the TPU kernel
// src/repro/kernels/bregman_fused.py::bregman_filter_prune (both tiles in
// one VMEM-resident pass; the admit loop runs over the real M only):
// brk_filter_prune_blocks over a device list of row blocks in one
// persistent launch, brk_filter_prune over one block (a row span), both
// through filter_span.cuh.  brk_filter_prune_blocks_quant and
// brk_filter_prune_quant replace bregman_fused.py::
// bregman_filter_prune_quant the same two ways, on filter_span.cuh's int8
// codes path: the UB with the per-row affine factored out of both sums,
// and the admit over corner codes decoded per element as amin = code *
// am_s + am_z (floor-coded) and gmax = code * gm_s + gm_z (ceil-coded),
// each operation rounded on its own.  That decode is the one the block
// envelopes were reduced over (core/index.refresh_envelopes): a decode one
// ulp lower here would admit a row whose block the envelope gate skipped,
// and the row would go missing, so the decode and the compare are written
// with round-to-nearest intrinsics and no FMA.
//
// Bound on the H100: bytes.  Over the admitted blocks of a Deep attempt
// (10^6 rows, M = 39, q = 14) the fp32 launch reads four (n, M) tables,
// 624 MB, and writes the f32 UB and int32 admit tiles, 112 MB: 0.22 ms at
// 3.35 TB/s, against 0.13-0.16 ms of issue for the compare arithmetic
// (filter_span.cuh says how the tile meets it).  The int8 launch reads a
// quarter of the table bytes plus eight fp32 decode scalars a row (188 MB)
// and writes 104 MB at q = 13, 0.087 ms: the arithmetic, not the bytes,
// bounds it.  Each table element is read and decoded once, and the admit
// mask stays bit-equal to the plain PyTorch version.  Rows past n are not
// read.
#include "filter_span.cuh"

using brekernels::span::Tables;

namespace {

Tables<float> fused_tables(const float* alpha, const float* sqrt_gamma,
                           const float* amin, const float* gmax,
                           const float* qsum, const float* qconst,
                           const float* sqrt_delta, const float* qb,
                           float* ub, int32_t* admit, int64_t n) {
  Tables<float> t = {};
  t.alpha = alpha;
  t.sg = sqrt_gamma;
  t.amin = amin;
  t.gmax = gmax;
  t.qsum = qsum;
  t.qc = qconst;
  t.sd = sqrt_delta;
  t.qb = qb;
  t.ub = ub;
  t.admit = admit;
  t.n = n;
  return t;
}

Tables<int8_t> fused_tables_quant(
    const int8_t* alpha_q, const float* alpha_scale, const float* alpha_zp,
    const int8_t* sg_q, const float* sg_scale, const float* sg_zp,
    const int8_t* amin_q, const float* amin_scale, const float* amin_zp,
    const int8_t* gmax_q, const float* gmax_scale, const float* gmax_zp,
    const float* qsum, const float* qconst, const float* sqrt_delta,
    const float* sdsum, const float* qb, float* ub, int32_t* admit,
    int64_t n) {
  Tables<int8_t> t = {};
  t.alpha = alpha_q;
  t.sg = sg_q;
  t.amin = amin_q;
  t.gmax = gmax_q;
  t.decode[brekernels::kAlphaScale] = alpha_scale;
  t.decode[brekernels::kAlphaZp] = alpha_zp;
  t.decode[brekernels::kSgScale] = sg_scale;
  t.decode[brekernels::kSgZp] = sg_zp;
  t.decode[brekernels::kAminScale] = amin_scale;
  t.decode[brekernels::kAminZp] = amin_zp;
  t.decode[brekernels::kGmaxScale] = gmax_scale;
  t.decode[brekernels::kGmaxZp] = gmax_zp;
  t.qsum = qsum;
  t.qc = qconst;
  t.sd = sqrt_delta;
  t.sdsum = sdsum;
  t.qb = qb;
  t.ub = ub;
  t.admit = admit;
  t.n = n;
  return t;
}

}  // namespace

// One row block: the tables' n rows, output (n, q).
extern "C" int brk_filter_prune(const float* alpha, const float* sqrt_gamma,
                                const float* amin, const float* gmax,
                                const float* qsum, const float* qconst,
                                const float* sqrt_delta, const float* qb,
                                float* ub, int32_t* admit, int64_t n,
                                int64_t m, int64_t q, int device,
                                void* stream) {
  Tables<float> t = fused_tables(alpha, sqrt_gamma, amin, gmax, qsum, qconst,
                                 sqrt_delta, qb, ub, admit, n);
  t.bn = n > 0 ? n : 1;
  t.nblocks = 1;
  return brekernels::span::launch_filter_span<float, true>(
      t, m, q, device, static_cast<cudaStream_t>(stream));
}

// The row blocks listed in blocks (nblocks int32 ids on the device) of the
// (n, m) tables, bn rows a block; output (nblocks * bn, q), listed block
// li's rows at [li * bn, (li + 1) * bn), a short block's rows past n
// inert (ub +inf, admit 0).
extern "C" int brk_filter_prune_blocks(
    const float* alpha, const float* sqrt_gamma, const float* amin,
    const float* gmax, const float* qsum, const float* qconst,
    const float* sqrt_delta, const float* qb, const int32_t* blocks,
    float* ub, int32_t* admit, int64_t n, int64_t m, int64_t q,
    int64_t nblocks, int64_t bn, int device, void* stream) {
  if (blocks == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Tables<float> t = fused_tables(alpha, sqrt_gamma, amin, gmax, qsum, qconst,
                                 sqrt_delta, qb, ub, admit, n);
  t.blocks = blocks;
  t.bn = bn;
  t.nblocks = nblocks;
  return brekernels::span::launch_filter_span<float, true>(
      t, m, q, device, static_cast<cudaStream_t>(stream));
}

// int8: one row block, the code tables' n rows, output (n, q).
extern "C" int brk_filter_prune_quant(
    const int8_t* alpha_q, const float* alpha_scale, const float* alpha_zp,
    const int8_t* sg_q, const float* sg_scale, const float* sg_zp,
    const int8_t* amin_q, const float* amin_scale, const float* amin_zp,
    const int8_t* gmax_q, const float* gmax_scale, const float* gmax_zp,
    const float* qsum, const float* qconst, const float* sqrt_delta,
    const float* sdsum, const float* qb, float* ub, int32_t* admit,
    int64_t n, int64_t m, int64_t q, int device, void* stream) {
  Tables<int8_t> t = fused_tables_quant(
      alpha_q, alpha_scale, alpha_zp, sg_q, sg_scale, sg_zp, amin_q,
      amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp, qsum, qconst,
      sqrt_delta, sdsum, qb, ub, admit, n);
  t.bn = n > 0 ? n : 1;
  t.nblocks = 1;
  return brekernels::span::launch_filter_span<int8_t, true>(
      t, m, q, device, static_cast<cudaStream_t>(stream));
}

// int8: the listed row blocks, as brk_filter_prune_blocks.
extern "C" int brk_filter_prune_blocks_quant(
    const int8_t* alpha_q, const float* alpha_scale, const float* alpha_zp,
    const int8_t* sg_q, const float* sg_scale, const float* sg_zp,
    const int8_t* amin_q, const float* amin_scale, const float* amin_zp,
    const int8_t* gmax_q, const float* gmax_scale, const float* gmax_zp,
    const float* qsum, const float* qconst, const float* sqrt_delta,
    const float* sdsum, const float* qb, const int32_t* blocks, float* ub,
    int32_t* admit, int64_t n, int64_t m, int64_t q, int64_t nblocks,
    int64_t bn, int device, void* stream) {
  if (blocks == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Tables<int8_t> t = fused_tables_quant(
      alpha_q, alpha_scale, alpha_zp, sg_q, sg_scale, sg_zp, amin_q,
      amin_scale, amin_zp, gmax_q, gmax_scale, gmax_zp, qsum, qconst,
      sqrt_delta, sdsum, qb, ub, admit, n);
  t.blocks = blocks;
  t.bn = bn;
  t.nblocks = nblocks;
  return brekernels::span::launch_filter_span<int8_t, true>(
      t, m, q, device, static_cast<cudaStream_t>(stream));
}
