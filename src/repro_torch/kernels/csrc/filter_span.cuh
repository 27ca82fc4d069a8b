// The fp32 filter tile of kernels #1 (bregman_ub.cu, UB only) and #3
// (bregman_fused.cu, UB and the Theorem-3 admit), one launch over many row
// blocks.
//
//   ub[r, j]    = (rowsum(alpha)[r] + qsum[j]) + sg[r, :] . sd[j, :]
//   admit[r, j] = any_i (amin[r, i] + qc[j, i]) - gmax[r, i] * sd[j, i]
//                       <= qb[j, i]
//
// It replaces, for the fp32 tables, the per-block tile of filter_tile.cuh
// (which keeps the int8 kernels and the prune-only ones).  Both TPU kernels
// (src/repro/kernels/bregman_ub.py::bregman_ub_matrix and
// bregman_fused.py::bregman_filter_prune) are one grid step a row block;
// the search used to launch them once a 4096-row block, 128 blocks of 256
// threads each, less than one wave on 132 SMs.
//
// Bound on the H100: bytes.  Over a Deep attempt (10^6 rows, M = 39,
// q = 14) #3 reads four (n, M) tables, 624 MB, and writes 112 MB of
// outputs: 0.22 ms at 3.35 TB/s, against 0.13-0.16 ms of issue for the
// arithmetic (about six instructions a (row, query, subspace) over 16
// query lanes).  On an H100 80GB HBM3 at 700 W it takes 0.335 ms there,
// 66% of the bound (PERF.md, run T).  The design:
//
// - One launch takes a list of row blocks (block ids on the device, or
//   every block in order) and a persistent grid of the resident blocks the
//   card holds (occupancy API x SMs).  A CTA walks (block, 32-row tile)
//   work items in a fixed order: items blockIdx.x, + gridDim.x, ...
// - A CTA holds a query tile of TQ = 16, 32 or 64 queries (picked from q
//   at launch; q > 64 splits into query tiles along grid.y), and a thread
//   one row and 8 of them: 64, 128 or 256 threads.  Its running sums and
//   admit flags stay in registers, one each a query, so no dependency
//   chain runs across queries; the query values it reads are the same for
//   the whole warp (shared-memory broadcasts, four queries a 16-byte
//   read).  At Deep's shape (M = 39, q = 14) four CTAs fit an SM: small
//   CTAs, so one CTA's barriers and output stores overlap the others'
//   arithmetic.  Every shared pointer is the shared array plus an offset
//   (no array of pointers), so the loads stay LDS, not generic.
// - The rows of a tile are one contiguous span of each table (TN * M
//   floats).  cp.async copies the next work item's spans into the other
//   half of a double-buffered stage while the current one computes: in
//   16-byte copies when M is odd (a thread's row stride M then meets no
//   bank conflict) and the span is aligned, else in 4-byte copies to a row
//   stride padded to an odd width.  Where a stage of all M does not fit
//   shared memory, M is walked in chunks, each its own pipeline step.
// - The query tables (sd, and qc and qb for the admit) are staged once a
//   CTA for all M while they fit QFIX_LIMIT; beyond it each chunk carries
//   its own slice of them.
// - The outputs go through the consumed stage (a padded (rows, q) tile)
//   and leave in coalesced stores: with one query tile a tile's outputs are
//   one contiguous span of the (rows, q) result.
//
// The arithmetic is filter_tile.cuh's, operation for operation, so the UB
// and the mask are bit-equal to it: the row sum over i = 0..M-1 in order,
// the Cauchy term as one fmaf chain in that order, (rowsum + qsum) +
// cauchy, and the admit compare rounded op by op with the _rn intrinsics
// (no contraction into an FMA), as the plain version rounds it.
//
// Output rows: with a block list, listed block li owns output rows
// [li * bn, (li + 1) * bn); the rows of a short (last) block past n are
// inert: ub = +inf, admit = 0.  Without a list the output has the n rows
// of the tables.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace brekernels {
namespace span {

constexpr int TN = 32;                   // rows a work item, one warp
constexpr int QPT = 8;                   // queries a thread
constexpr int SMEM_LIMIT = 232448;       // an H100 block's shared memory
constexpr int QFIX_LIMIT = 64 * 1024;    // query tables held a CTA's life
constexpr int MAX_DEVICES = 64;

// Operands: point tables (n, m) row-major, query tables (q, m); blocks
// (nblocks,) int32 block ids or null (block i is rows [i * bn, ...)).
struct Tables {
  const float* alpha;
  const float* sg;
  const float* amin;
  const float* gmax;
  const float* qsum;
  const float* qc;
  const float* sd;
  const float* qb;
  const int32_t* blocks;
  float* ub;
  int32_t* admit;
  int64_t n;
  int64_t bn;
  int64_t nblocks;
};

// What the launcher planned: the work items and the stage layout.
struct Plan {
  Tables t;
  int m;
  int q;
  int items;            // nblocks * tiles_per_block
  int tiles_per_block;  // ceil(bn / TN)
  int q_per_tile;       // queries of one grid.y tile (<= TQ)
  int mc;               // subspaces a chunk
  int mcp;              // row stride of a staged chunk, floats (odd)
  int nchunks;
  int tstride;          // floats between two tables in a stage
  int stage;            // floats of one stage buffer
  int qfixed;           // query tables staged once for all of M
  int pad;              // block-list mode: inert rows past n are written
  // Divisors' magics (magic_of): [0] a full chunk or query tile, [1] the
  // last one.  Chunk widths, chunk widths x TQ, query tile widths.
  uint64_t mc_magic[2];
  uint64_t qchunk_magic[2];
  uint64_t qn_magic[2];
};

struct Item {
  int64_t grow0;        // first table row of the tile
  int64_t orow0;        // first output row of the tile
  int rows;             // table rows in the tile
  int out_rows;         // output rows of the tile (rows + inert rows)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// A 4-byte copy; zero-fills (and does not read src) when ok is false.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// floor(e / d) as a multiply by magic_of(d), computed on the host: exact
// while e * d < 2^32 (every use here: e < TN * d with d below 5,000, e <
// 3 * d with d = chunk x TQ below 37,000, or e < TN * 64).
inline uint64_t magic_of(int64_t d) {
  return ((uint64_t{1} << 32) + static_cast<uint64_t>(d) - 1)
         / static_cast<uint64_t>(d);
}

__device__ __forceinline__ int div_magic(int e, uint64_t magic) {
  return static_cast<int>((static_cast<uint64_t>(e) * magic) >> 32);
}

__device__ __forceinline__ Item decode(const Plan& p, int item) {
  const int li = item / p.tiles_per_block;
  const int r0 = (item - li * p.tiles_per_block) * TN;
  const int64_t b = p.t.blocks ? static_cast<int64_t>(__ldg(p.t.blocks + li))
                               : li;
  const int64_t start = b * p.t.bn;
  int64_t blen = b < 0 ? 0 : p.t.n - start;
  blen = blen < 0 ? 0 : (blen > p.t.bn ? p.t.bn : blen);
  const int64_t olen = p.pad ? p.t.bn : blen;
  Item it;
  it.grow0 = start + r0;
  it.orow0 = static_cast<int64_t>(li) * p.t.bn + r0;
  it.rows = static_cast<int>(blen - r0 < 0 ? 0 : (blen - r0 > TN ? TN
                                                                 : blen - r0));
  it.out_rows = static_cast<int>(olen - r0 < 0 ? 0
                                 : (olen - r0 > TN ? TN : olen - r0));
  return it;
}

// The k-th staged point table (alpha, sg where it sums; amin, gmax where
// it prunes) and the k-th query table (sd, qc, qb), chosen without an
// array of pointers, which would live in local memory.
template <bool PRUNE, bool UB>
__device__ __forceinline__ const float* point_table(const Plan& p, int k) {
  if constexpr (UB) {
    if (k == 0) return p.t.alpha;
    if (k == 1) return p.t.sg;
  }
  return k == (UB ? 2 : 0) ? p.t.amin : p.t.gmax;
}

__device__ __forceinline__ const float* query_table(const Plan& p, int k) {
  return k == 0 ? p.t.sd : (k == 1 ? p.t.qc : p.t.qb);
}

// Queue the copies of pipeline step `step` (work item, chunk) of this CTA
// into the stage at `buf`: each table's rows of the chunk, and the chunk's
// slice of the query tables where they are not held for the CTA's life.
template <bool PRUNE, bool UB, int TQ, int NTHR>
__device__ __forceinline__ void issue(const Plan& p, int step, float* buf,
                                      int j0, int qn) {
  constexpr int NT = (UB ? 2 : 0) + (PRUNE ? 2 : 0);
  constexpr int NQ = PRUNE ? 3 : 1;
  const int k_item = step / p.nchunks;
  const int item = blockIdx.x + k_item * gridDim.x;
  if (item >= p.items) return;
  const int chunk = step - k_item * p.nchunks;
  const bool last = chunk == p.nchunks - 1;
  const Item it = decode(p, item);
  const int m0 = chunk * p.mc;
  const int mcc = min(p.mc, p.m - m0);
  const int tid = threadIdx.x;
  if (it.rows > 0) {
    const int total = it.rows * mcc;
    const bool span = p.nchunks == 1 && p.mcp == p.m && total % 4 == 0;
    const uint64_t magic = last ? p.mc_magic[1] : p.mc_magic[0];
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const float* src = point_table<PRUNE, UB>(p, k) + it.grow0 * p.m + m0;
      float* dst = buf + k * p.tstride;
      if (span && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        for (int e = tid; e < total / 4; e += NTHR)
          cp16(dst + 4 * e, src + 4 * e);
      } else {
        for (int e = tid; e < total; e += NTHR) {
          const int r = div_magic(e, magic);
          const int c = e - r * mcc;
          cp4(dst + r * p.mcp + c, src + static_cast<int64_t>(r) * p.m + c,
              true);
        }
      }
    }
  }
  if (!p.qfixed) {
    // [NQ][mc][TQ]; queries past the tile zero-filled.
    float* dst = buf + NT * p.tstride;
    const int per = mcc * TQ;
    const uint64_t magic = last ? p.qchunk_magic[1] : p.qchunk_magic[0];
    for (int e = tid; e < NQ * per; e += NTHR) {
      const int k = div_magic(e, magic);
      const int rem = e - k * per;
      const int c = rem / TQ;
      const int j = rem % TQ;
      const bool ok = j < qn;
      cp4(dst + k * p.mc * TQ + c * TQ + j,
          query_table(p, k) + static_cast<int64_t>(j0 + (ok ? j : 0)) * p.m
              + m0 + c,
          ok);
    }
  }
}

template <bool PRUNE, bool UB, int TQ>
__global__ void __launch_bounds__(TN * TQ / QPT)
filter_span_kernel(const Plan p) {
  static_assert(UB || PRUNE, "a tile writes the totals, the mask or both");
  static_assert(TQ == 16 || TQ == 32 || TQ == 64, "TQ is 16, 32 or 64");
  // Staged tables: alpha, sg where it sums (UB); amin, gmax where it
  // prunes.  Query tables: sd, then qc and qb where it prunes.
  constexpr int NT = (UB ? 2 : 0) + (PRUNE ? 2 : 0);
  constexpr int TAM = UB ? 2 : 0;            // amin's place, gmax after it
  constexpr int NQ = PRUNE ? 3 : 1;
  constexpr int NTHR = TN * TQ / QPT;
  // Every shared pointer below is this array plus an offset, so the
  // compiler keeps shared-memory loads (LDS), not generic ones.
  extern __shared__ __align__(16) float smem[];
  float* const s_qsum = smem;                           // [TQ]
  float* const s_qfix = smem + TQ;                      // [NQ][m][TQ]
  const int stage0 = TQ + (p.qfixed ? NQ * p.m * TQ : 0);

  const int tid = threadIdx.x;
  const int r = tid % TN;                    // this thread's row of a tile
  const int jg = tid / TN * QPT;             // and its first query (one
                                             // for the warp: TN is a warp)
  const int j0 = blockIdx.y * p.q_per_tile;
  const int qn = min(p.q_per_tile, p.q - j0);

  if constexpr (UB)
    for (int j = tid; j < TQ; j += NTHR)
      s_qsum[j] = j < qn ? p.t.qsum[j0 + j] : 0.f;
  if (p.qfixed) {
    const int per = p.m * TQ;
    for (int e = tid; e < NQ * per; e += NTHR) {
      const int k = e / per;
      const int rem = e - k * per;
      const int c = rem / TQ;
      const int j = rem % TQ;
      s_qfix[e] = j < qn
          ? query_table(p, k)[static_cast<int64_t>(j0 + j) * p.m + c] : 0.f;
    }
  }

  const int my_items = blockIdx.x < p.items
      ? (p.items - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int steps = my_items * p.nchunks;
  issue<PRUNE, UB, TQ, NTHR>(p, 0, smem + stage0, j0, qn);
  cp_commit();

  // Running sums of this thread's row for its QPT queries; each query's
  // admit flag its own register, set by a predicated move, so no
  // dependency chain runs across queries.
  float rowsum = 0.f;
  float cauchy[QPT];
  int hit[QPT];
  for (int s = 0; s < steps; ++s) {
    const int cur = stage0 + (s & 1) * p.stage;
    const int nxt = stage0 + ((s + 1) & 1) * p.stage;
    issue<PRUNE, UB, TQ, NTHR>(p, s + 1, smem + nxt, j0, qn);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    const int k_item = s / p.nchunks;
    const int chunk = s - k_item * p.nchunks;
    const int m0 = chunk * p.mc;
    const int mcc = min(p.mc, p.m - m0);
    if (chunk == 0) {
      rowsum = 0.f;
#pragma unroll
      for (int u = 0; u < QPT; ++u) {
        cauchy[u] = 0.f;
        hit[u] = 0;
      }
    }
    // This thread's row of each table, and its queries of the chunk's
    // query tables.
    const float* row = smem + cur + r * p.mcp;
    const int qstride = p.qfixed ? p.m * TQ : p.mc * TQ;
    const float* qv = smem + jg
        + (p.qfixed ? TQ + m0 * TQ : cur + NT * p.tstride);
#pragma unroll 2
    for (int c = 0; c < mcc; ++c) {
      float g = 0.f, am = 0.f, gm = 0.f;
      if constexpr (UB) {
        rowsum += row[c];
        g = row[p.tstride + c];
      }
      if constexpr (PRUNE) {
        am = row[TAM * p.tstride + c];
        gm = row[(TAM + 1) * p.tstride + c];
      }
      const float* qc_ = qv + c * TQ;
#pragma unroll
      for (int j4 = 0; j4 < QPT / 4; ++j4) {
        const float4 s4 = reinterpret_cast<const float4*>(qc_)[j4];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        float cv[4] = {0.f, 0.f, 0.f, 0.f};
        float bv[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (PRUNE) {
          const float4 c4 = reinterpret_cast<const float4*>(qc_ + qstride)[j4];
          const float4 b4 =
              reinterpret_cast<const float4*>(qc_ + 2 * qstride)[j4];
          cv[0] = c4.x; cv[1] = c4.y; cv[2] = c4.z; cv[3] = c4.w;
          bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = 4 * j4 + u;
          if constexpr (UB) cauchy[i] = fmaf(g, sv[u], cauchy[i]);
          if constexpr (PRUNE) {
            // Each operation rounded on its own, as the plain version
            // does: no contraction into a fused multiply-add.
            const float lb = __fsub_rn(__fadd_rn(am, cv[u]),
                                       __fmul_rn(gm, sv[u]));
            if (lb <= bv[u]) hit[i] = 1;
          }
        }
      }
    }

    if (chunk == p.nchunks - 1) {
      const Item it = decode(p, blockIdx.x + k_item * gridDim.x);
      const int qp = qn | 1;              // odd: conflict-free row writes
      float* s_ub = smem + cur;
      int32_t* s_adm = reinterpret_cast<int32_t*>(smem + cur
                                                  + (UB ? TN * qp : 0));
      __syncthreads();                    // the stage is read; reuse it
      if (r < it.out_rows) {
        const bool real = r < it.rows;
#pragma unroll
        for (int u = 0; u < QPT; ++u) {
          const int j = jg + u;
          if (j < qn) {
            if constexpr (UB)
              s_ub[r * qp + j] = real ? (rowsum + s_qsum[j]) + cauchy[u]
                                      : __int_as_float(0x7f800000);
            if constexpr (PRUNE)
              s_adm[r * qp + j] = real ? hit[u] : 0;
          }
        }
      }
      __syncthreads();
      const int total = it.out_rows * qn;
      const uint64_t magic =
          blockIdx.y == gridDim.y - 1 ? p.qn_magic[1] : p.qn_magic[0];
      for (int e = tid; e < total; e += NTHR) {
        const int rr = div_magic(e, magic);
        const int j = e - rr * qn;
        const int64_t o = (it.orow0 + rr) * p.q + j0 + j;
        if constexpr (UB) p.t.ub[o] = s_ub[rr * qp + j];
        if constexpr (PRUNE) p.t.admit[o] = s_adm[rr * qp + j];
      }
    }
    __syncthreads();                      // before the stage is refilled
  }
  cp_wait<0>();
}

inline int round4(int64_t x) { return static_cast<int>((x + 3) / 4 * 4); }

template <bool PRUNE, bool UB, int TQ>
int launch_tq(Plan p, int nqt, int device, cudaStream_t stream) {
  constexpr int NT = (UB ? 2 : 0) + (PRUNE ? 2 : 0);
  constexpr int NQ = PRUNE ? 3 : 1;
  constexpr int NOUT = (UB ? 1 : 0) + (PRUNE ? 1 : 0);
  constexpr int NTHR = TN * TQ / QPT;
  const int64_t m = p.m;
  const int64_t qfix = NQ * m * TQ;                 // floats
  p.qfixed = qfix * 4 <= QFIX_LIMIT ? 1 : 0;
  const int64_t fixed = TQ + (p.qfixed ? qfix : 0);
  auto stage_floats = [&](int64_t mc, int64_t mcp) -> int64_t {
    const int64_t rows = NT * round4(TN * mcp)
                         + (p.qfixed ? 0 : NQ * mc * TQ);
    const int64_t out = NOUT * TN * (TQ + 1);
    return round4(rows > out ? rows : out);
  };
  auto fits = [&](int64_t mc, int64_t mcp) {
    return 4 * (fixed + 2 * stage_floats(mc, mcp)) <= SMEM_LIMIT;
  };
  int64_t mc = m;
  int64_t mcp = m % 2 ? m : m + 1;
  if (!fits(mc, mcp)) {
    // The largest odd chunk that fits: odd, so the row stride of the
    // staged chunk meets no bank conflict.
    const int64_t per = NT * TN + (p.qfixed ? 0 : NQ * TQ);
    mc = (SMEM_LIMIT / 4 - fixed - 2 * NT * 4) / (2 * per);
    if (mc >= m) mc = m - 1;
    if (mc % 2 == 0) mc -= 1;
    while (mc > 1 && !fits(mc, mc)) mc -= 2;
    if (mc < 1 || !fits(mc, mc))
      return static_cast<int>(cudaErrorInvalidValue);
    mcp = mc;
  }
  p.mc = static_cast<int>(mc);
  p.mcp = static_cast<int>(mcp);
  p.nchunks = static_cast<int>((m + mc - 1) / mc);
  p.tstride = round4(TN * mcp);
  p.stage = static_cast<int>(stage_floats(mc, mcp));
  const int64_t last_mc = m - (p.nchunks - 1) * mc;
  p.mc_magic[0] = magic_of(mc);
  p.mc_magic[1] = magic_of(last_mc);
  p.qchunk_magic[0] = magic_of(mc * TQ);
  p.qchunk_magic[1] = magic_of(last_mc * TQ);
  p.qn_magic[0] = magic_of(p.q_per_tile);
  p.qn_magic[1] = magic_of(p.q - (nqt - 1) * int64_t{p.q_per_tile});
  const int bytes = static_cast<int>(4 * (fixed + 2 * int64_t{p.stage}));

  // The shared-memory opt-in and the device's SM count, once a device
  // (the opt-in again when a launch needs more than any before).
  static int opted[MAX_DEVICES] = {};
  static int sms[MAX_DEVICES] = {};
  cudaError_t err = cudaSuccess;
  if (bytes > opted[device]) {
    err = cudaFuncSetAttribute(filter_span_kernel<PRUNE, UB, TQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device] = bytes;
  }
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, filter_span_kernel<PRUNE, UB, TQ>, NTHR, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int64_t gx = int64_t{per_sm} * sms[device] / nqt;
  if (gx < 1) gx = 1;
  if (gx > p.items) gx = p.items;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(nqt));
  filter_span_kernel<PRUNE, UB, TQ><<<grid, NTHR, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One launch over `t.nblocks` row blocks of `t.bn` rows (t.blocks null:
// every block in order, the output then has the tables' n rows).
template <bool PRUNE, bool UB = true>
int launch_filter_span(const Tables& t, int64_t m, int64_t q, int device,
                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (t.n < 0 || t.bn <= 0 || t.nblocks < 0 || m <= 0 || m > INT32_MAX ||
      q < 0 || q > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0 || t.nblocks == 0 || (t.blocks == nullptr && t.n == 0))
    return 0;
  const int64_t tiles = (t.bn + TN - 1) / TN;
  if (tiles * t.nblocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p = {};
  p.t = t;
  p.m = static_cast<int>(m);
  p.q = static_cast<int>(q);
  p.tiles_per_block = static_cast<int>(tiles);
  p.items = static_cast<int>(tiles * t.nblocks);
  p.pad = t.blocks != nullptr ? 1 : 0;
  // Query tiles of at most 64; each tile's TQ the smallest that holds it.
  const int64_t nqt = (q + 63) / 64;
  if (nqt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int per = static_cast<int>((q + nqt - 1) / nqt);
  p.q_per_tile = per;
  const int n_qt = static_cast<int>(nqt);
  if (per <= 16) return launch_tq<PRUNE, UB, 16>(p, n_qt, device, stream);
  if (per <= 32) return launch_tq<PRUNE, UB, 32>(p, n_qt, device, stream);
  return launch_tq<PRUNE, UB, 64>(p, n_qt, device, stream);
}

}  // namespace span
}  // namespace brekernels
