// The Gram matrix of centred columns for the PCCP correlation (paper §5.2).
//
//   gram[i, j] = sum_r xc[r, i] * xc[r, j]        xc (n, d) fp32, row-major
//
// brk_pccp_gram replaces the body of the TPU kernel src/repro/kernels/
// pccp_corr.py::pccp_correlation: its pallas_call is this product, tiled
// over (d, d) output tiles and summed over n tiles with an fp32
// accumulator in VMEM scratch, the n axis of the grid running in order.
// The centring, the std, the scaling, abs and the zeroed diagonal stay
// outside the kernel, in the wrapper (kernels/ops.py), as the JAX wrapper
// keeps them outside its pallas_call.  fp32 throughout, one fmaf a term,
// no TF32.
//
// Bound on the H100: operations.  The datastore's keys (n = 65,472, d =
// 3072) need n * d * (d + 1) = 0.62 TFLOP (the tiles on and above the
// diagonal) against 0.8 GB read once: 9.2 ms at the fp32 cores' 67
// TFLOP/s, 0.24 ms of HBM time.  The design:
//
// - Only the 128 x 128 tiles on and above the diagonal are computed.  The
//   host lists them and cuts n into `splits` chunks of `rows_per_chunk`
//   rows (kernels/pccp_corr.py: schedule), so the grid of tiles x chunks
//   fills whole waves of the card's resident blocks: 300 tiles alone run
//   at two blocks an SM in two waves, the second 36 blocks wide.
// - A block owns one tile and one chunk and sums its rows 16 at a time:
//   cp.async copies the next 16 rows of both column slices into the other
//   half of a double-buffered shared tile while the current 16 multiply.
//   Both operands are row slices of xc (xc^T is never formed), so every
//   copy is coalesced; a thread holds an 8 x 8 accumulator, its two 4-wide
//   column groups 64 apart, so its float4 shared reads meet no bank
//   conflict.
// - Each block writes its partial tile to scratch (splits, d, d), and a
//   second kernel sums the partials in chunk order and writes each tile and
//   its mirror (through a 32 x 32 shared transpose, so both writes are
//   coalesced).  No atomics: the result does not depend on the order in
//   which blocks run, and it is symmetric bit for bit: a diagonal tile's
//   (i, j) and (j, i) sum the same products (fmaf commutes in its two
//   factors) in the same order in every chunk, and the chunks in one order.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int BK = 16;               // rows a pipeline step
constexpr int THREADS = 256;         // 16 x 16, 8 x 8 outputs each
constexpr int SUB = 32;              // the reduction's transpose tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (16 or 4) from global to shared memory, zero-filling when
// `ok` is false (the source is then not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const float* src,
                                         bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
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

// VEC: d is a multiple of 4 and xc 16-byte aligned, so a row slice moves
// in 16-byte copies.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
gram_kernel(const float* __restrict__ x, float* __restrict__ out,
            const int* __restrict__ tiles, int64_t n, int64_t d,
            int64_t rows_per_chunk) {
  __shared__ __align__(16) float as[2][BK][TILE];   // xc[r, i0 + c]
  __shared__ __align__(16) float bs[2][BK][TILE];   // xc[r, j0 + c]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t i0 = static_cast<int64_t>(tiles[2 * blockIdx.x]) * TILE;
  const int64_t j0 = static_cast<int64_t>(tiles[2 * blockIdx.x + 1]) * TILE;
  const int64_t r_begin = blockIdx.y * rows_per_chunk;
  const int64_t r_end = min(n, r_begin + rows_per_chunk);
  const int64_t steps = r_end > r_begin ? (r_end - r_begin + BK - 1) / BK : 0;

  auto load = [&](int buf, int64_t r0) {
#pragma unroll
    for (int f = tid; f < BK * TILE / 4; f += THREADS) {
      const int kk = f / (TILE / 4), c = (f % (TILE / 4)) * 4;
      const int64_t r = r0 + kk;
      const bool row_ok = r < r_end;
      const float* row = x + r * d;
      if constexpr (VEC) {
        const bool a_ok = row_ok && i0 + c < d, b_ok = row_ok && j0 + c < d;
        cp_async<16>(&as[buf][kk][c], a_ok ? row + i0 + c : x, a_ok);
        cp_async<16>(&bs[buf][kk][c], b_ok ? row + j0 + c : x, b_ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool a_ok = row_ok && i0 + c + e < d;
          const bool b_ok = row_ok && j0 + c + e < d;
          cp_async<4>(&as[buf][kk][c + e], a_ok ? row + i0 + c + e : x, a_ok);
          cp_async<4>(&bs[buf][kk][c + e], b_ok ? row + j0 + c + e : x, b_ok);
        }
      }
    }
    cp_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (steps > 0) load(0, r_begin);
  for (int64_t s = 0; s < steps; ++s) {
    const int buf = static_cast<int>(s & 1);
    if (s + 1 < steps) {
      load(buf ^ 1, r_begin + (s + 1) * BK);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4 + 64]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();                 // buf is free for the step after next
  }

  float* dst = out + static_cast<int64_t>(blockIdx.y) * d * d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gi = i0 + (i < 4 ? ty * 4 + i : ty * 4 + 64 + i - 4);
    if (gi >= d) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t gj = j0 + (j < 4 ? tx * 4 + j : tx * 4 + 64 + j - 4);
      if (gj >= d) continue;
      dst[gi * d + gj] = acc[i][j];
    }
  }
}

// gram = the sum over chunks, in chunk order, of the partial tiles on and
// above the diagonal; each off-diagonal tile also written mirrored.  A
// block owns a 32 x 32 piece; pieces below the diagonal tiles exit.
__global__ void __launch_bounds__(SUB * 8)
gram_reduce_kernel(const float* __restrict__ parts, float* __restrict__ gram,
                   int64_t d, int splits) {
  __shared__ float piece[SUB][SUB + 1];
  const int64_t bi = blockIdx.y, bj = blockIdx.x;
  const int64_t ti = bi * SUB / TILE, tj = bj * SUB / TILE;
  if (ti > tj) return;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t dd = d * d;
  for (int yy = ty; yy < SUB; yy += 8) {
    const int64_t i = bi * SUB + yy, j = bj * SUB + tx;
    float sum = 0.f;
    if (i < d && j < d) {
      sum = parts[i * d + j];
      for (int c = 1; c < splits; ++c)
        sum = __fadd_rn(sum, parts[c * dd + i * d + j]);
      gram[i * d + j] = sum;
    }
    piece[yy][tx] = sum;
  }
  if (ti == tj) return;              // a diagonal tile holds both triangles
  __syncthreads();
  for (int yy = ty; yy < SUB; yy += 8) {
    const int64_t i = bj * SUB + yy, j = bi * SUB + tx;
    if (i < d && j < d) gram[i * d + j] = piece[tx][yy];
  }
}

}  // namespace

// The resident blocks of gram_kernel the device holds at once: blocks per
// SM x SMs (what the host's split count fills); a CUDA error as a negative
// number.
extern "C" int brk_pccp_slots(int device) {
  cudaError_t err = cudaSetDevice(device);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gram_kernel<true>, THREADS, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

// tiles: (num_tiles, 2) int32 on the device, the (row, column) tile index
// of each block, on or above the diagonal.  splits chunks of
// rows_per_chunk rows; scratch holds (splits, d, d) fp32.
extern "C" int brk_pccp_gram(const float* xc, float* gram, float* scratch,
                             const int* tiles, int num_tiles, int64_t n,
                             int64_t d, int splits, int64_t rows_per_chunk,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d <= 0) return 0;
  if (n < 0 || num_tiles <= 0 || splits <= 0 || splits > 65535 ||
      rows_per_chunk <= 0 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t pieces = (d + SUB - 1) / SUB;
  if (pieces > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(num_tiles),
                  static_cast<unsigned>(splits));
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(xc) % 16 == 0)
    gram_kernel<true><<<grid, THREADS, 0, s>>>(xc, scratch, tiles, n, d,
                                               rows_per_chunk);
  else
    gram_kernel<false><<<grid, THREADS, 0, s>>>(xc, scratch, tiles, n, d,
                                                rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_reduce_kernel<<<dim3(static_cast<unsigned>(pieces),
                            static_cast<unsigned>(pieces)),
                       dim3(SUB, 8), 0, s>>>(scratch, gram, d, splits);
  return static_cast<int>(cudaGetLastError());
}
