// The Gram matrix of centred columns for the PCCP correlation (paper §5.2).
//
//   gram[i, j] = sum_r xc[r, i] * xc[r, j]        xc (n, d) fp32, row-major
//
// brk_pccp_gram replaces the body of the TPU kernel src/repro/kernels/
// pccp_corr.py::pccp_correlation: its pallas_call is this product, tiled
// over (d, d) output tiles and summed over n tiles with an fp32
// accumulator in VMEM scratch, the n axis of the grid running in order.
// Here one block owns a 128 x 128 output tile and loops over n itself, 8
// rows at a time; the accumulator is 8 x 8 registers a thread.  The Gram
// is symmetric, so only the tiles on and above the diagonal are computed
// (the TPU kernel computes every tile): a block off the diagonal writes
// its tile and the tile's transpose.  A diagonal tile is symmetric bit
// for bit as it stands: entry (i, j) and entry (j, i) sum the same
// products (fmaf commutes in its two factors) in the same order.  The
// centring, the std, the scaling, abs and the zeroed diagonal stay outside
// the kernel, in the wrapper (kernels/ops.py), as the JAX wrapper keeps
// them outside its pallas_call.  fp32 throughout, one fmaf a term, no TF32.
//
// Bound on the H100: operations.  The datastore's keys (n = 65,472, d =
// 3072) need n * d * (d + 1) = 0.62 TFLOP (the upper triangle with its
// diagonal) against 0.8 GB read once: 9.2 ms at the fp32 cores' 67
// TFLOP/s, 0.24 ms of HBM time.  Both operands of a tile are row slices
// of xc (xc^T is never formed), so every global load is coalesced; a
// thread's two 4-wide column groups sit 64 apart, so its float4
// shared-memory reads meet no bank conflict; each 8-row step does 64 fmaf
// a thread for four 16-byte shared loads.  The transposed writes are not
// coalesced; they are d * d / 2 words, against n * d * d / 2 fmaf.  Not
// done: double buffering.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;         // 16 x 16, 8 x 8 outputs each

__global__ void __launch_bounds__(THREADS)
gram_kernel(const float* __restrict__ x, float* __restrict__ gram, int64_t n,
            int64_t d) {
  __shared__ __align__(16) float as[BK][TILE];   // xc[r0 + kk, i0 + c]
  __shared__ __align__(16) float bs[BK][TILE];   // xc[r0 + kk, j0 + c]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // Block b -> tile (ti, tj), ti <= tj, row by row of the upper triangle.
  const int64_t tiles = (d + TILE - 1) / TILE;
  int64_t ti = 0, rem = blockIdx.x;
  while (rem >= tiles - ti) {
    rem -= tiles - ti;
    ++ti;
  }
  const int64_t i0 = ti * TILE;
  const int64_t j0 = (ti + rem) * TILE;
  const bool mirror = i0 != j0;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int64_t r0 = 0; r0 < n; r0 += BK) {
#pragma unroll
    for (int e = tid; e < BK * TILE; e += THREADS) {
      const int kk = e / TILE, c = e % TILE;
      const int64_t r = r0 + kk;
      const bool row_ok = r < n;
      as[kk][c] = row_ok && i0 + c < d ? x[r * d + i0 + c] : 0.f;
      bs[kk][c] = row_ok && j0 + c < d ? x[r * d + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4 + 64]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gi = i0 + (i < 4 ? ty * 4 + i : ty * 4 + 64 + i - 4);
    if (gi >= d) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t gj = j0 + (j < 4 ? tx * 4 + j : tx * 4 + 64 + j - 4);
      if (gj >= d) continue;
      gram[gi * d + gj] = acc[i][j];
      if (mirror) gram[gj * d + gi] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int brk_pccp_gram(const float* xc, float* gram, int64_t n,
                             int64_t d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d <= 0) return 0;
  const int64_t tiles = (d + TILE - 1) / TILE;
  if (n < 0 || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(tiles * (tiles + 1) / 2);
  gram_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xc, gram, n, d);
  return static_cast<int>(cudaGetLastError());
}
