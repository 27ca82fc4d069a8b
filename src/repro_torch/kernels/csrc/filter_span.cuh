// The filter tile of kernels #1 and #2 (bregman_ub.cu, the UB alone; fp32
// tables and int8 codes), #3 and #4 (bregman_fused.cu, UB and the
// Theorem-3 admit) and #5 and #6 (bregman_prune.cu, the admit alone), one
// launch over many row blocks.
//
//   ub[r, j]    = (rowsum(alpha)[r] + qsum[j]) + sg[r, :] . sd[j, :]
//   admit[r, j] = any_i (amin[r, i] + qc[j, i]) - gmax[r, i] * sd[j, i]
//                       <= qb[j, i]
//
// In the int8 tier (T = int8_t) the four tables are codes, each row with
// its own affine decode ``code * scale + zp`` (the Decode columns), and
// the totals factor the affine out of both sums:
//
//   ub[r, j] = (a_s * rowsum(alpha_q) + M * a_z + qsum[j])
//              + (g_s * (sg_q . sd[j]) + g_z * sdsum[j])
//
// Two switches pick the outputs: UB the totals, PRUNE the admit mask; a
// stage holds only the tables (and, for int8, the decode columns) its
// outputs read.  It replaces the per-block tiles of the first port: the
// TPU kernels (src/repro/kernels/bregman_ub.py, bregman_fused.py and
// bregman_prune.py) are one grid step a row block, and the search used to
// launch them once a 4096-row block, 128 blocks of 256 threads each, less
// than one wave on 132 SMs.
//
// Bound on the H100 80GB HBM3 (3.35 TB/s at 700 W): bytes.  Over a Deep
// attempt (10^6 rows, M = 39, q = 14) #3 reads four (n, M) tables, 624
// MB, and writes 112 MB of outputs: 0.22 ms, against 0.13-0.16 ms of
// issue for the arithmetic (about six instructions a (row, query,
// subspace) over 16 query lanes); it takes 0.337 ms there at 700 W, 65%
// of the bound (PERF.md, run W).  #5 reads two of the fp32 tables (313
// MB) and writes one output (56 MB): 0.110 ms, with the admit's issue
// about as long.  #4 reads a quarter of the table bytes plus eight fp32
// decode scalars a row, 188 MB, and writes 104 MB at q = 13: 0.087 ms, so
// the same arithmetic bounds it by issue.  #2 and #6 each read two of the
// int8 tables with their four decode columns (94 MB) and write one output
// (52 MB): 0.044 ms each.  The design:
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
//   elements).  cp.async copies the next work item's spans into the other
//   half of a double-buffered stage while the current one computes: fp32
//   in 16-byte copies when M is odd (a thread's row stride M then meets no
//   bank conflict) and the span is aligned, else in 4-byte copies to a row
//   stride padded to an odd width; int8 codes in 16-byte copies of the
//   aligned span (with 32-row items a span starts on 32 * M bytes), the
//   rest byte by byte.  Beside an int8 span the item's 32 rows of the
//   decode columns its tables need (four for #2 or #6, eight for #4) are
//   staged the same way.  Where a stage of all M
//   does not fit shared memory, M is walked in chunks, each its own
//   pipeline step.
// - The query tables (sd, and qc and qb for the admit) are staged once a
//   CTA for all M while they fit QFIX_LIMIT; beyond it each chunk carries
//   its own slice of them.  qsum (and sdsum for int8) once a CTA.
// - The outputs go through the consumed stage (a padded (rows, q) tile)
//   and leave in coalesced stores: with one query tile a tile's outputs are
//   one contiguous span of the (rows, q) result.
//
// The arithmetic is fixed operation for operation, so the UB and the mask
// keep the bits of the per-block kernels this tile replaced (held against
// them by tools/kernel_tree_parity.py): the row sum over i = 0..M-1 in
// order (an exact int for codes), the Cauchy term as one fmaf chain in
// that order, and the admit compare rounded op by op with the _rn
// intrinsics (no contraction into an FMA), as the plain version rounds it.
// An int8 corner is decoded on read as __fadd_rn(__fmul_rn(code, scale),
// zp), its cost spread over the thread's QPT queries; the int8 epilogue is
// written with explicit _rn intrinsics in the form nvcc contracted the
// per-block kernels' ``s * rowsum + m * z`` and ``g_s * cauchy + g_z *
// sdsum`` into, so no layout can change the UB bits.
//
// Output rows: with a block list, listed block li owns output rows
// [li * bn, (li + 1) * bn); the rows of a short (last) block past n are
// not read and come back inert: ub = +inf, admit = 0.  Without a list the
// output has the n rows of the tables.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace brekernels {

// The per-row decode columns of an int8 table set, in this order.
enum Decode { kAlphaScale = 0, kAlphaZp, kSgScale, kSgZp,
              kAminScale, kAminZp, kGmaxScale, kGmaxZp, kDecodeCols };

namespace span {

constexpr int TN = 32;                   // rows a work item, one warp
constexpr int QPT = 8;                   // queries a thread
constexpr int SMEM_LIMIT = 232448;       // an H100 block's shared memory
constexpr int QFIX_LIMIT = 64 * 1024;    // query tables held a CTA's life
constexpr int MAX_DEVICES = 64;
// int8: the widest chunk of M a stage takes (the byte copies' row/column
// split by a multiply stays exact below it).
constexpr int QUANT_MC_LIMIT = 4096;

// Operands: point tables (n, m) row-major (fp32, or int8 codes with their
// (n,) decode columns in Decode order), query tables (q, m); blocks
// (nblocks,) int32 block ids or null (block i is rows [i * bn, ...)).
template <typename T>
struct Tables {
  const T* alpha;
  const T* sg;
  const T* amin;
  const T* gmax;
  const float* decode[kDecodeCols];     // int8 only
  const float* qsum;
  const float* qc;
  const float* sd;
  const float* sdsum;                   // int8 only: sum_i sd[j, i]
  const float* qb;
  const int32_t* blocks;
  float* ub;
  int32_t* admit;
  int64_t n;
  int64_t bn;
  int64_t nblocks;
};

// What the launcher planned: the work items and the stage layout.
template <typename T>
struct Plan {
  Tables<T> t;
  int m;
  int q;
  int items;            // nblocks * tiles_per_block
  int tiles_per_block;  // ceil(bn / TN)
  int q_per_tile;       // queries of one grid.y tile (<= TQ)
  int mc;               // subspaces a chunk
  int mcp;              // row stride of a staged chunk, elements (fp32: odd)
  int nchunks;
  int tstride;          // floats between two tables in a stage
  int doff;             // int8: floats from a stage to its decode columns
  int qoff;             // floats from a stage to its query-table slices
  int stage;            // floats of one stage buffer
  int qfixed;           // query tables staged once for all of M
  int pad;              // block-list mode: inert rows past n are written
  int dec_aligned;      // int8: every decode column 16-byte aligned
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

__device__ __forceinline__ void cp16(void* dst, const void* src) {
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
// while e * d < 2^32 (every use here: e < TN * d with d below 5,000
// (QUANT_MC_LIMIT for int8), e < 3 * d with d = chunk x TQ below 37,000,
// or e < TN * 64).
inline uint64_t magic_of(int64_t d) {
  return ((uint64_t{1} << 32) + static_cast<uint64_t>(d) - 1)
         / static_cast<uint64_t>(d);
}

__device__ __forceinline__ int div_magic(int e, uint64_t magic) {
  return static_cast<int>((static_cast<uint64_t>(e) * magic) >> 32);
}

template <typename T>
__device__ __forceinline__ Item decode(const Plan<T>& p, int item) {
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
// it prunes), the k-th query table (sd, qc, qb) and the col-th decode
// column, chosen without an array of pointers, which would live in local
// memory.
template <typename T, bool PRUNE, bool UB>
__device__ __forceinline__ const T* point_table(const Plan<T>& p, int k) {
  if constexpr (UB) {
    if (k == 0) return p.t.alpha;
    if (k == 1) return p.t.sg;
  }
  return k == (UB ? 2 : 0) ? p.t.amin : p.t.gmax;
}

template <typename T>
__device__ __forceinline__ const float* query_table(const Plan<T>& p, int k) {
  return k == 0 ? p.t.sd : (k == 1 ? p.t.qc : p.t.qb);
}

template <typename T>
__device__ __forceinline__ const float* decode_col(const Plan<T>& p,
                                                   int col) {
  return col < 4
      ? (col < 2 ? (col == 0 ? p.t.decode[0] : p.t.decode[1])
                 : (col == 2 ? p.t.decode[2] : p.t.decode[3]))
      : (col < 6 ? (col == 4 ? p.t.decode[4] : p.t.decode[5])
                 : (col == 6 ? p.t.decode[6] : p.t.decode[7]));
}

// The decode columns an int8 stage holds: the filter stats' where it sums,
// the corners' where it prunes.
template <bool PRUNE, bool UB>
constexpr int kDecFirst = UB ? kAlphaScale : kAminScale;
template <bool PRUNE, bool UB>
constexpr int kDecLast = PRUNE ? kDecodeCols : kAminScale;

// Queue the copies of pipeline step `step` (work item, chunk) of this CTA
// into the stage at `buf`: each table's rows of the chunk (and an int8
// item's decode columns), and the chunk's slice of the query tables where
// they are not held for the CTA's life.
template <typename T, bool PRUNE, bool UB, int TQ, int NTHR>
__device__ __forceinline__ void issue(const Plan<T>& p, int step, float* buf,
                                      int j0, int qn) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
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
    const bool span = p.nchunks == 1 && p.mcp == p.m;
    const uint64_t magic = last ? p.mc_magic[1] : p.mc_magic[0];
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const T* src = point_table<T, PRUNE, UB>(p, k) + it.grow0 * p.m + m0;
      T* dst = reinterpret_cast<T*>(buf + k * p.tstride);
      if constexpr (QUANT) {
        // The aligned span's whole 16 bytes by cp.async, the rest (a
        // short tail, or every byte of an unaligned or chunked span) by
        // plain loads into the same row stride.
        int done = 0;
        if (span && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          done = total & ~15;
          for (int e = tid; e < total / 16; e += NTHR)
            cp16(dst + 16 * e, src + 16 * e);
        }
        for (int e = done + tid; e < total; e += NTHR) {
          const int r = div_magic(e, magic);
          const int c = e - r * mcc;
          dst[r * p.mcp + c] = __ldg(src + static_cast<int64_t>(r) * p.m + c);
        }
      } else if (span && total % 4 == 0
                 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
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
    if constexpr (QUANT) {
      // [kDecodeCols][TN] floats; rows past the tile zero-filled.
      constexpr int first = kDecFirst<PRUNE, UB>;
      constexpr int ncols = kDecLast<PRUNE, UB> - first;
      float* dst = buf + p.doff + first * TN;
      if (it.rows == TN && p.dec_aligned && (it.grow0 & 3) == 0) {
        for (int e = tid; e < ncols * TN / 4; e += NTHR) {
          const int col = e / (TN / 4);
          const int piece = e - col * (TN / 4);
          cp16(dst + col * TN + 4 * piece,
               decode_col(p, first + col) + it.grow0 + 4 * piece);
        }
      } else {
        for (int e = tid; e < ncols * TN; e += NTHR) {
          const int col = e / TN;
          const int r = e - col * TN;
          const bool ok = r < it.rows;
          cp4(dst + e, decode_col(p, first + col) + it.grow0 + (ok ? r : 0),
              ok);
        }
      }
    }
  }
  if (!p.qfixed) {
    // [NQ][mc][TQ]; queries past the tile zero-filled.
    float* dst = buf + p.qoff;
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

template <typename T, bool PRUNE, bool UB, int TQ>
__global__ void __launch_bounds__(TN * TQ / QPT)
filter_span_kernel(const Plan<T> p) {
  static_assert(UB || PRUNE, "a tile writes the totals, the mask or both");
  static_assert(TQ == 16 || TQ == 32 || TQ == 64, "TQ is 16, 32 or 64");
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  // Row sums: exact integers for codes (|code| <= 128, M < 2^24 / 128).
  using RowSum = typename std::conditional<QUANT, int, float>::type;
  // Staged tables: alpha, sg where it sums (UB); amin, gmax where it
  // prunes.  Query tables: sd, then qc and qb where it prunes.
  constexpr int NT = (UB ? 2 : 0) + (PRUNE ? 2 : 0);
  constexpr int TAM = UB ? 2 : 0;            // amin's place, gmax after it
  constexpr int NQ = PRUNE ? 3 : 1;
  constexpr int NTHR = TN * TQ / QPT;
  constexpr int NSDS = QUANT && UB ? TQ : 0;  // sdsum's floats
  // Every shared pointer below is this array plus an offset, so the
  // compiler keeps shared-memory loads (LDS), not generic ones.
  extern __shared__ __align__(16) float smem[];
  float* const s_qsum = smem;                           // [TQ]
  float* const s_sdsum = smem + TQ;                     // [TQ], int8 only
  float* const s_qfix = smem + TQ + NSDS;               // [NQ][m][TQ]
  const int stage0 = TQ + NSDS + (p.qfixed ? NQ * p.m * TQ : 0);

  const int tid = threadIdx.x;
  const int r = tid % TN;                    // this thread's row of a tile
  const int jg = tid / TN * QPT;             // and its first query (one
                                             // for the warp: TN is a warp)
  const int j0 = blockIdx.y * p.q_per_tile;
  const int qn = min(p.q_per_tile, p.q - j0);

  if constexpr (UB)
    for (int j = tid; j < TQ; j += NTHR) {
      s_qsum[j] = j < qn ? p.t.qsum[j0 + j] : 0.f;
      if constexpr (QUANT) s_sdsum[j] = j < qn ? p.t.sdsum[j0 + j] : 0.f;
    }
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
  issue<T, PRUNE, UB, TQ, NTHR>(p, 0, smem + stage0, j0, qn);
  cp_commit();

  // Table elements between two staged tables.
  const int tel = p.tstride * static_cast<int>(sizeof(float) / sizeof(T));
  // Running sums of this thread's row for its QPT queries; each query's
  // admit flag its own register, set by a predicated move, so no
  // dependency chain runs across queries.
  RowSum rowsum = 0;
  float cauchy[QPT];
  int hit[QPT];
  for (int s = 0; s < steps; ++s) {
    const int cur = stage0 + (s & 1) * p.stage;
    const int nxt = stage0 + ((s + 1) & 1) * p.stage;
    issue<T, PRUNE, UB, TQ, NTHR>(p, s + 1, smem + nxt, j0, qn);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    const int k_item = s / p.nchunks;
    const int chunk = s - k_item * p.nchunks;
    const int m0 = chunk * p.mc;
    const int mcc = min(p.mc, p.m - m0);
    if (chunk == 0) {
      rowsum = 0;
#pragma unroll
      for (int u = 0; u < QPT; ++u) {
        cauchy[u] = 0.f;
        hit[u] = 0;
      }
    }
    // This thread's row of each table, its row's corner decode (int8),
    // and its queries of the chunk's query tables.
    const T* row = reinterpret_cast<const T*>(smem + cur) + r * p.mcp;
    const float* dec = smem + cur + p.doff + r;          // [col * TN]
    float am_s = 0.f, am_z = 0.f, gm_s = 0.f, gm_z = 0.f;
    if constexpr (QUANT && PRUNE) {
      am_s = dec[kAminScale * TN];
      am_z = dec[kAminZp * TN];
      gm_s = dec[kGmaxScale * TN];
      gm_z = dec[kGmaxZp * TN];
    }
    const int qstride = p.qfixed ? p.m * TQ : p.mc * TQ;
    const float* qv = smem + jg
        + (p.qfixed ? TQ + NSDS + m0 * TQ : cur + p.qoff);
#pragma unroll 2
    for (int c = 0; c < mcc; ++c) {
      float g = 0.f, am = 0.f, gm = 0.f;
      if constexpr (UB) {
        rowsum += row[c];
        g = static_cast<float>(row[tel + c]);
      }
      if constexpr (PRUNE) {
        if constexpr (QUANT) {
          // code * scale + zp, each operation rounded on its own.
          am = __fadd_rn(__fmul_rn(static_cast<float>(row[TAM * tel + c]),
                                   am_s), am_z);
          gm = __fadd_rn(__fmul_rn(
                             static_cast<float>(row[(TAM + 1) * tel + c]),
                             gm_s), gm_z);
        } else {
          am = row[TAM * tel + c];
          gm = row[(TAM + 1) * tel + c];
        }
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
      // The int8 row sum with its affine (read before the stage is
      // reused): a_s * rowsum + M * a_z and the dot's g_s, g_z.
      float arow = 0.f, g_s = 0.f, g_z = 0.f;
      if constexpr (QUANT && UB) {
        arow = __fmaf_rn(dec[kAlphaScale * TN], static_cast<float>(rowsum),
                         __fmul_rn(static_cast<float>(p.m),
                                   dec[kAlphaZp * TN]));
        g_s = dec[kSgScale * TN];
        g_z = dec[kSgZp * TN];
      }
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
            if constexpr (UB) {
              float total;
              if constexpr (QUANT)
                total = __fadd_rn(__fadd_rn(arow, s_qsum[j]),
                                  __fmaf_rn(g_s, cauchy[u],
                                            __fmul_rn(g_z, s_sdsum[j])));
              else
                total = (rowsum + s_qsum[j]) + cauchy[u];
              s_ub[r * qp + j] = real ? total : __int_as_float(0x7f800000);
            }
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

// What launch_tq caches a device: the dynamic shared memory each kernel
// instance was granted, and the SM count.  Internal linkage: a static
// local of the template function would be one object process-wide
// (STB_GNU_UNIQUE), shared by two builds of this library loaded into one
// process (tools/kernel_tree_parity.py), and one build would then launch
// a kernel the other had opted in.
namespace {
template <typename T, bool PRUNE, bool UB, int TQ>
int opted_bytes[MAX_DEVICES] = {};
int sm_count[MAX_DEVICES] = {};
}  // namespace

template <typename T, bool PRUNE, bool UB, int TQ>
int launch_tq(Plan<T> p, int nqt, int device, cudaStream_t stream) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int NT = (UB ? 2 : 0) + (PRUNE ? 2 : 0);
  constexpr int NQ = PRUNE ? 3 : 1;
  constexpr int NOUT = (UB ? 1 : 0) + (PRUNE ? 1 : 0);
  constexpr int NTHR = TN * TQ / QPT;
  constexpr int NDEC = QUANT ? kDecodeCols * TN : 0;   // decode floats
  constexpr int NSDS = QUANT && UB ? TQ : 0;
  const int64_t m = p.m;
  const int64_t qfix = NQ * m * TQ;                 // floats
  p.qfixed = qfix * 4 <= QFIX_LIMIT ? 1 : 0;
  const int64_t fixed = TQ + NSDS + (p.qfixed ? qfix : 0);
  // Floats of one table's rows at row stride mcp (elements).
  auto table_floats = [&](int64_t mcp) -> int64_t {
    return round4(QUANT ? (TN * mcp + 3) / 4 : TN * mcp);
  };
  auto stage_floats = [&](int64_t mc, int64_t mcp) -> int64_t {
    const int64_t rows = NT * table_floats(mcp) + NDEC
                         + (p.qfixed ? 0 : NQ * mc * TQ);
    const int64_t out = NOUT * TN * (TQ + 1);
    return round4(rows > out ? rows : out);
  };
  auto fits = [&](int64_t mc, int64_t mcp) {
    return 4 * (fixed + 2 * stage_floats(mc, mcp)) <= SMEM_LIMIT
           && (!QUANT || mc <= QUANT_MC_LIMIT);
  };
  int64_t mc = m;
  int64_t mcp = QUANT || m % 2 ? m : m + 1;
  if (!fits(mc, mcp)) {
    if constexpr (QUANT) {
      // The widest chunk that fits; bytes meet no better stride by being
      // odd, so the row stride is the chunk's width.
      mc = m < QUANT_MC_LIMIT ? m - 1 : QUANT_MC_LIMIT;
      while (mc > 1 && !fits(mc, mc)) mc -= 1;
    } else {
      // The largest odd chunk that fits: odd, so the row stride of the
      // staged chunk meets no bank conflict.
      const int64_t per = NT * TN + (p.qfixed ? 0 : NQ * TQ);
      mc = (SMEM_LIMIT / 4 - fixed - 2 * NT * 4) / (2 * per);
      if (mc >= m) mc = m - 1;
      if (mc % 2 == 0) mc -= 1;
      while (mc > 1 && !fits(mc, mc)) mc -= 2;
    }
    if (mc < 1 || !fits(mc, mc))
      return static_cast<int>(cudaErrorInvalidValue);
    mcp = mc;
  }
  p.mc = static_cast<int>(mc);
  p.mcp = static_cast<int>(mcp);
  p.nchunks = static_cast<int>((m + mc - 1) / mc);
  p.tstride = static_cast<int>(table_floats(mcp));
  p.doff = NT * p.tstride;
  p.qoff = p.doff + NDEC;
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
  int* const opted = opted_bytes<T, PRUNE, UB, TQ>;
  int* const sms = sm_count;
  cudaError_t err = cudaSuccess;
  if (bytes > opted[device]) {
    err = cudaFuncSetAttribute(filter_span_kernel<T, PRUNE, UB, TQ>,
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
      &per_sm, filter_span_kernel<T, PRUNE, UB, TQ>, NTHR, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int64_t gx = int64_t{per_sm} * sms[device] / nqt;
  if (gx < 1) gx = 1;
  if (gx > p.items) gx = p.items;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(nqt));
  filter_span_kernel<T, PRUNE, UB, TQ><<<grid, NTHR, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One launch over `t.nblocks` row blocks of `t.bn` rows (t.blocks null:
// every block in order, the output then has the tables' n rows).
template <typename T, bool PRUNE, bool UB = true>
int launch_filter_span(const Tables<T>& t, int64_t m, int64_t q, int device,
                       cudaStream_t stream) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (t.n < 0 || t.bn <= 0 || t.nblocks < 0 || m <= 0 || m > INT32_MAX ||
      q < 0 || q > INT32_MAX || (QUANT && m >= (1 << 24) / 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0 || t.nblocks == 0 || (t.blocks == nullptr && t.n == 0))
    return 0;
  const int64_t tiles = (t.bn + TN - 1) / TN;
  if (tiles * t.nblocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan<T> p = {};
  p.t = t;
  p.m = static_cast<int>(m);
  p.q = static_cast<int>(q);
  p.tiles_per_block = static_cast<int>(tiles);
  p.items = static_cast<int>(tiles * t.nblocks);
  p.pad = t.blocks != nullptr ? 1 : 0;
  p.dec_aligned = 1;
  if constexpr (QUANT)
    for (int col = kDecFirst<PRUNE, UB>; col < kDecLast<PRUNE, UB>; ++col)
      if (reinterpret_cast<uintptr_t>(t.decode[col]) & 15) p.dec_aligned = 0;
  // Query tiles of at most 64; each tile's TQ the smallest that holds it.
  const int64_t nqt = (q + 63) / 64;
  if (nqt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int per = static_cast<int>((q + nqt - 1) / nqt);
  p.q_per_tile = per;
  const int n_qt = static_cast<int>(nqt);
  if (per <= 16) return launch_tq<T, PRUNE, UB, 16>(p, n_qt, device, stream);
  if (per <= 32) return launch_tq<T, PRUNE, UB, 32>(p, n_qt, device, stream);
  return launch_tq<T, PRUNE, UB, 64>(p, n_qt, device, stream);
}

}  // namespace span
}  // namespace brekernels
