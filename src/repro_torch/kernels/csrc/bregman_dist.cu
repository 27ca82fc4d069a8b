// Refine kernels: exact Bregman distances of gathered candidate rows.
//
//   out[q, b] = (sum_j phi(x[q, b, j]) - x[q, b, :] . grad[q, :]) + c_y[q]
//
// brk_refine_batch (#7) replaces the TPU kernel src/repro/kernels/
// bregman_dist.py::bregman_refine_batch (a grid over (query, row tile, d
// tile) whose last axis runs in order and carries the sum in VMEM
// scratch), with x the fp32 rows.  brk_refine_batch_quant (#8) replaces
// bregman_dist.py::bregman_refine_batch_quant: x is decoded from int8
// codes as code * scale[q, b] + zp[q, b], each operation rounded on its
// own, then clamped at DOMAIN_EPS = 1e-6 for the positive-domain families,
// so x is bit-equal to core/quantize.dequantize_rows and the distances
// are exact over the stored points.
//
// Bound on the H100: bytes.  Each candidate row is read once: at the path's
// retry shape (13-14 queries, 10^6 rows, d = 256) that is 14.3 GB of fp32
// rows, 4.3 ms at 3.35 TB/s, or 3.6 GB of codes, 1.1 ms.  In int8 the
// arithmetic comes close: about 14 lane instructions an element in the
// exponential family (decode 4, expf 8 with one MUFU.EX2, the two sums
// 2), near 1.5 ms of issue at that shape.
//
// #7: one warp owns one (query, row) pair and its lanes stride over d, so
// each warp reads its row in coalesced 128-byte pieces; the sequential
// d-tile axis of the TPU grid becomes this loop, the VMEM accumulator two
// registers reduced with warp shuffles, and no block hands a partial sum
// to another.
//
// #8 (refine_quant_kernel) reads a quarter of #7's bytes, so it is built
// around bytes in flight and instructions an element:
// - A row is cut into pieces of 16 codes, each read in one 16-byte load
//   (ld.global.nc, no L1 allocation).  A lane owns NP = 4 pieces of a row
//   (pieces g, g + G, g + 2G, g + 3G of its group of G lanes; NP = 2 or 1
//   below 64 codes), so at d = 256 four lanes read a row and a warp eight
//   rows a load.  A lane issues the next row's loads before it sums the
//   current row.
// - A block's warps take runs of one query's rows, and the block stages
//   that query's grad in shared memory once: no grad load from device
//   memory remains an element, and a thread keeps to 64 registers, four
//   blocks (32 warps) an SM.  Holding the grad slice in registers instead
//   took up to 164 registers, one block an SM, and was slower (H100 runs
//   recorded in PERF.md).
// - A code converts to float exactly by a byte permute into the mantissa
//   of 2^23 and one subtraction, not by I2F, which shares the quarter-rate
//   pipe with expf's MUFU.EX2; it then decodes as
//   __fadd_rn(__fmul_rn(code, s), z) (and fmaxf(., 1e-6) for the positive
//   families), bit-equal to dequantize_rows; phi is expf / logf as in #7.
// - A lane sums its pieces in order, element by element, into fx and
//   cross; its fx - cross then goes through a shuffle tree over the G
//   lanes.  The layout (NP, G) is a function of d alone, so which element
//   goes into which partial sum, and the tree's order, do not depend on b,
//   the pair's position or the row's alignment: rows that do not start on
//   16 bytes (d % 16 != 0, or an unaligned base) read bytes into the same
//   assignment.  So a (query, row) pair gives the same bits at every b,
//   which keeps the resident search, the tiered store's pooled refine and
//   fused=False bit-equal.
// phi is fixed per family by a template argument; log arguments are
// guarded at 1e-30 as on the TPU.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PIECE = 16;        // codes a lane reads at once (16 bytes)
constexpr int RUN_STEPS = 32;    // row loads a warp's run takes (#8)
constexpr int MIN_BLOCKS = 4;    // #8's resident blocks an SM: 64 registers
constexpr int MAX_GRAD_BYTES = 227 * 1024;   // #8's staged grad, at most

enum Family { kSquaredEuclidean = 0, kItakuraSaito, kExponential, kBurg, kShannon };

template <int F>
__device__ __forceinline__ float phi(float x) {
  if (F == kSquaredEuclidean) return 0.5f * x * x;
  if (F == kItakuraSaito) return -logf(fmaxf(x, 1e-30f));
  if (F == kExponential) return expf(x);
  if (F == kBurg) return x - logf(fmaxf(x, 1e-30f));
  return x * logf(fmaxf(x, 1e-30f));
}

// The families whose domain is the open positive axis (core/quantize.py).
template <int F>
constexpr bool kPositive = F == kItakuraSaito || F == kBurg || F == kShannon;

template <int F>
__global__ void __launch_bounds__(THREADS)
refine_kernel(const float* __restrict__ rows, const float* __restrict__ grad,
              const float* __restrict__ c_y, float* __restrict__ out,
              int64_t b, int64_t d, int64_t pairs) {
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (w >= pairs) return;            // whole warps leave together
  const int64_t qi = w / b;
  const float* x = rows + w * d;
  const float* g = grad + qi * d;
  float fx = 0.f;
  float cross = 0.f;
  for (int64_t j = lane; j < d; j += 32) {
    const float v = x[j];
    fx += phi<F>(v);
    cross = fmaf(v, g[j], cross);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    fx += __shfl_down_sync(0xffffffffu, fx, off);
    cross += __shfl_down_sync(0xffffffffu, cross, off);
  }
  if (lane == 0) out[w] = (fx - cross) + c_y[qi];
}

// 16 bytes, streamed: read-only, not kept in L1.
__device__ __forceinline__ uint4 load_stream16(const int8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// Byte e of the word w (a signed code) as a float, exactly: the byte with
// its sign bit flipped, c + 128, goes into the low mantissa bits of magic
// = 2^23 (0x4B000000), and 2^23 + 128 is subtracted.  magic is a kernel
// argument so that the byte selector, not it, is PRMT's immediate.
__device__ __forceinline__ float code_at(uint32_t w, uint32_t magic, int e) {
  const uint32_t bits = __byte_perm(w ^ 0x80808080u, magic, 0x7440u | e);
  return __fsub_rn(__uint_as_float(bits), 8388736.0f);
}

// The lane's sums over one piece (16 codes in four words, the first nv of
// them real) against its grad values gr (shared memory, 16-byte aligned),
// element by element in order.
template <int F, bool FULL>
__device__ __forceinline__ void piece_sums(const uint4& raw, int nv,
                                           const float* gr, uint32_t magic,
                                           float s, float z, float& fx,
                                           float& cross) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  float g4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < PIECE; ++e) {
    if (e % 4 == 0) {
      const float4 t = reinterpret_cast<const float4*>(gr)[e / 4];
      g4[0] = t.x; g4[1] = t.y; g4[2] = t.z; g4[3] = t.w;
    }
    if (FULL || e < nv) {
      float v = __fadd_rn(__fmul_rn(code_at(words[e / 4], magic, e % 4), s),
                          z);
      if constexpr (kPositive<F>) v = fmaxf(v, 1e-6f);
      fx += phi<F>(v);
      cross = fmaf(v, g4[e % 4], cross);
    }
  }
}

// The 16 codes of one piece that starts at x, nv of them real (the rest
// zero): one 16-byte load where VEC (every piece whole and aligned), else
// byte loads.
template <bool VEC>
__device__ __forceinline__ uint4 load_piece(const int8_t* x, int nv) {
  if constexpr (VEC) {
    return load_stream16(x);
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < PIECE; ++e)
      if (e < nv)
        w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(x + e)))
                    << (8 * (e % 4));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The shape of a lane's work, a function of d alone: pieces of 16 codes a
// row, NP of them a lane (pieces g, g + G, ..., g + (NP - 1) G of its
// group's G lanes), so a warp loads 32 / G rows at once.
struct Layout {
  int pieces;
  int group;      // G, a power of two
  int np;         // NP: 1, 2 or 4
};

inline Layout layout_of(int64_t d) {
  Layout l;
  l.pieces = static_cast<int>((d + PIECE - 1) / PIECE);
  l.np = l.pieces >= 4 ? 4 : (l.pieces >= 2 ? 2 : 1);
  const int per = (l.pieces + l.np - 1) / l.np;
  l.group = 1;
  while (l.group < per && l.group < 32) l.group *= 2;
  return l;
}

// Grid: blocks_per_query blocks a query; warp k of a block takes run
// (block % blocks_per_query) * WARPS + k of the query's runs of RUN_STEPS
// loads (RUN_STEPS * 32 / G consecutive rows).  The block stages the
// query's grad (d floats, zero-padded to whole pieces) in shared memory
// once; a lane issues the next row's loads before it sums the current
// one, so they are in flight meanwhile.  Pieces past NP * G (d > 2048)
// are read as they come.
template <int F, bool VEC, int NP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
refine_quant_kernel(const int8_t* __restrict__ codes,
                    const float* __restrict__ scale,
                    const float* __restrict__ zp,
                    const float* __restrict__ grad,
                    const float* __restrict__ c_y, float* __restrict__ out,
                    int64_t b, int d, int group, int64_t runs,
                    int64_t blocks_per_query, uint32_t magic) {
  extern __shared__ __align__(16) float s_grad[];
  const int64_t qi = blockIdx.x / blocks_per_query;
  const int64_t run = (blockIdx.x - qi * blocks_per_query) * WARPS
                      + threadIdx.x / 32;
  for (int i = threadIdx.x; i < (d + PIECE - 1) / PIECE * PIECE; i += THREADS)
    s_grad[i] = i < d ? __ldg(grad + qi * d + i) : 0.f;
  __syncthreads();
  if (run >= runs) return;           // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int pieces = (d + PIECE - 1) / PIECE;
  const int g = lane & (group - 1);  // the lane's first piece of a row
  const int rps = 32 / group;        // rows a load
  const int64_t base = qi * b;       // the query's first pair
  const int64_t r0 = run * RUN_STEPS * rps;
  const int64_t r_end = r0 + RUN_STEPS * rps < b ? r0 + RUN_STEPS * rps : b;
  // Real codes of each of the lane's pieces (0 past d).
  int nv[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int t = g + i * group;
    nv[i] = t < pieces ? min(PIECE, d - t * PIECE) : 0;
  }

  // A row's codes, scale and zero-point (zeros at or past r_end).
  auto load = [&](int64_t r, uint4 (&dst)[NP], float& s, float& z) {
#pragma unroll
    for (int i = 0; i < NP; ++i) dst[i] = make_uint4(0u, 0u, 0u, 0u);
    s = z = 0.f;
    if (r < r_end) {
      const int8_t* x = codes + (base + r) * d;
#pragma unroll
      for (int i = 0; i < NP; ++i)
        if (nv[i] > 0)
          dst[i] = load_piece<VEC>(x + (g + i * group) * PIECE, nv[i]);
      s = __ldg(scale + base + r);
      z = __ldg(zp + base + r);
    }
  };
  int64_t row = r0 + lane / group;
  uint4 raw[NP];
  float sc, zz;
  load(row, raw, sc, zz);
  const float cq = __ldg(c_y + qi);
  for (int64_t s0 = r0; s0 < r_end; s0 += rps, row += rps) {
    uint4 nraw[NP];
    float nsc, nzz;
    load(row + rps, nraw, nsc, nzz);
    float fx = 0.f;
    float cross = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (nv[i] > 0)
        piece_sums<F, VEC>(raw[i], nv[i], s_grad + (g + i * group) * PIECE,
                           magic, sc, zz, fx, cross);
    for (int t = g + NP * group; t < pieces; t += group) {
      if (row >= r_end) break;
      const int tv = min(PIECE, d - t * PIECE);
      piece_sums<F, VEC>(
          load_piece<VEC>(codes + (base + row) * d + t * PIECE, tv), tv,
          s_grad + t * PIECE, magic, sc, zz, fx, cross);
    }
    // The lane's share of the row's distance, then the tree over the
    // group's lanes; lane g = 0 holds the row's sum.
    float part = fx - cross;
    for (int off = group / 2; off > 0; off >>= 1)
      part += __shfl_down_sync(0xffffffffu, part, off, group);
    if (g == 0 && row < r_end) out[base + row] = part + cq;
#pragma unroll
    for (int i = 0; i < NP; ++i) raw[i] = nraw[i];
    sc = nsc;
    zz = nzz;
  }
}

template <int F>
void launch(const float* rows, const float* grad, const float* c_y,
            float* out, int64_t b, int64_t d, int64_t pairs,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((pairs + WARPS - 1) / WARPS));
  refine_kernel<F><<<grid, THREADS, 0, stream>>>(rows, grad, c_y, out, b, d,
                                                 pairs);
}

template <int F>
int launch_quant(const int8_t* codes, const float* scale, const float* zp,
                 const float* grad, const float* c_y, float* out, int64_t q,
                 int64_t b, int d, cudaStream_t stream) {
  const Layout l = layout_of(d);
  const int64_t run_rows = int64_t{32 / l.group} * RUN_STEPS;
  const int64_t runs = (b + run_rows - 1) / run_rows;
  const int64_t per_query = (runs + WARPS - 1) / WARPS;
  const int smem = l.pieces * PIECE * 4;    // the grad, whole pieces
  if (q * per_query > INT32_MAX || smem > MAX_GRAD_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  // Whole aligned pieces: 16-byte loads; else byte loads, same sums.
  const bool vec = d % PIECE == 0
      && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const dim3 grid(static_cast<unsigned>(q * per_query));
  const uint32_t magic = 0x4B000000u;
  cudaError_t err = cudaSuccess;
#define BRK_REFINE_QUANT(V, N)                                               \
  do {                                                                       \
    if (smem > 48 * 1024)                                                    \
      err = cudaFuncSetAttribute(refine_quant_kernel<F, V, N>,               \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                 smem);                                      \
    if (err == cudaSuccess)                                                  \
      refine_quant_kernel<F, V, N><<<grid, THREADS, smem, stream>>>(         \
          codes, scale, zp, grad, c_y, out, b, d, l.group, runs, per_query,  \
          magic);                                                            \
  } while (0)
  if (vec) {
    if (l.np == 4) BRK_REFINE_QUANT(true, 4);
    else if (l.np == 2) BRK_REFINE_QUANT(true, 2);
    else BRK_REFINE_QUANT(true, 1);
  } else {
    if (l.np == 4) BRK_REFINE_QUANT(false, 4);
    else if (l.np == 2) BRK_REFINE_QUANT(false, 2);
    else BRK_REFINE_QUANT(false, 1);
  }
#undef BRK_REFINE_QUANT
  return static_cast<int>(err);
}

}  // namespace

extern "C" int brk_refine_batch(const float* rows, const float* grad,
                                const float* c_y, float* out, int64_t q,
                                int64_t b, int64_t d, int family, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t pairs = q * b;
  if (pairs <= 0) return 0;
  if (d <= 0 || (pairs + WARPS - 1) / WARPS > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case kSquaredEuclidean: launch<kSquaredEuclidean>(rows, grad, c_y, out, b, d, pairs, s); break;
    case kItakuraSaito: launch<kItakuraSaito>(rows, grad, c_y, out, b, d, pairs, s); break;
    case kExponential: launch<kExponential>(rows, grad, c_y, out, b, d, pairs, s); break;
    case kBurg: launch<kBurg>(rows, grad, c_y, out, b, d, pairs, s); break;
    case kShannon: launch<kShannon>(rows, grad, c_y, out, b, d, pairs, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brk_refine_batch_quant(const int8_t* codes, const float* scale,
                                      const float* zp, const float* grad,
                                      const float* c_y, float* out, int64_t q,
                                      int64_t b, int64_t d, int family,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q <= 0 || b <= 0) return 0;
  if (d <= 0 || d > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int di = static_cast<int>(d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (family) {
    case kSquaredEuclidean: rc = launch_quant<kSquaredEuclidean>(codes, scale, zp, grad, c_y, out, q, b, di, s); break;
    case kItakuraSaito: rc = launch_quant<kItakuraSaito>(codes, scale, zp, grad, c_y, out, q, b, di, s); break;
    case kExponential: rc = launch_quant<kExponential>(codes, scale, zp, grad, c_y, out, q, b, di, s); break;
    case kBurg: rc = launch_quant<kBurg>(codes, scale, zp, grad, c_y, out, q, b, di, s); break;
    case kShannon: rc = launch_quant<kShannon>(codes, scale, zp, grad, c_y, out, q, b, di, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* brk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
