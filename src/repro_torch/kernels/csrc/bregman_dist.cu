// Refine kernel: exact Bregman distances of gathered candidate rows.
//
//   out[q, b] = (sum_j phi(rows[q, b, j]) - rows[q, b, :] . grad[q, :]) + c_y[q]
//
// Replaces the TPU kernel src/repro/kernels/bregman_dist.py::
// bregman_refine_batch (a grid over (query, row tile, d tile) whose last
// axis runs in order and carries the sum in VMEM scratch).
//
// Bound on the H100: bytes.  Each candidate row is read once: at the path's
// shape (50 queries, a budget of 2^16 rows, d = 192-256) that is 2.5-3.4 GB,
// about a millisecond at 3.35 TB/s, against three operations per element.
// One warp owns one (query, row) pair and its lanes stride over d, so each
// warp reads its row in coalesced 128-byte pieces; the sequential d-tile
// axis of the TPU grid becomes this loop, the VMEM accumulator becomes two
// registers reduced with warp shuffles, and no block hands a partial sum to
// another.  phi is fixed per family by a template argument; log arguments
// are guarded at 1e-30 as on the TPU.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

enum Family { kSquaredEuclidean = 0, kItakuraSaito, kExponential, kBurg, kShannon };

template <int F>
__device__ __forceinline__ float phi(float x) {
  if (F == kSquaredEuclidean) return 0.5f * x * x;
  if (F == kItakuraSaito) return -logf(fmaxf(x, 1e-30f));
  if (F == kExponential) return expf(x);
  if (F == kBurg) return x - logf(fmaxf(x, 1e-30f));
  return x * logf(fmaxf(x, 1e-30f));
}

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

template <int F>
void launch(const float* rows, const float* grad, const float* c_y,
            float* out, int64_t b, int64_t d, int64_t pairs,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((pairs + WARPS - 1) / WARPS));
  refine_kernel<F><<<grid, THREADS, 0, stream>>>(rows, grad, c_y, out, b, d,
                                                 pairs);
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

extern "C" const char* brk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
