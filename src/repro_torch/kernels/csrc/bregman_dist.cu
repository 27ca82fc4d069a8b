// Refine kernels: exact Bregman distances of gathered candidate rows.
//
//   out[q, b] = (sum_j phi(x[q, b, j]) - x[q, b, :] . grad[q, :]) + c_y[q]
//
// brk_refine_batch replaces the TPU kernel src/repro/kernels/bregman_dist.py::
// bregman_refine_batch (a grid over (query, row tile, d tile) whose last
// axis runs in order and carries the sum in VMEM scratch), with x the fp32
// rows.  brk_refine_batch_quant replaces bregman_dist.py::
// bregman_refine_batch_quant: x is decoded from int8 codes as
// code * scale[q, b] + zp[q, b], each operation rounded on its own, then
// clamped at DOMAIN_EPS = 1e-6 for the positive-domain families, so x is
// bit-equal to core/quantize.dequantize_rows and the distances are exact
// over the stored points.
//
// Bound on the H100: bytes.  Each candidate row is read once: at the path's
// retry shape (14 queries, 10^6 rows, d = 256) that is 14.3 GB of fp32 rows,
// 4.3 ms at 3.35 TB/s, or 3.6 GB of codes, 1.1 ms, against three to five
// operations per element.  One warp owns one (query, row) pair and its
// lanes stride over d, so each warp reads its row in coalesced pieces (128
// bytes of fp32, 32 of codes); the sequential d-tile axis of the TPU grid
// becomes this loop, the VMEM accumulator becomes two registers reduced
// with warp shuffles, and no block hands a partial sum to another.  phi is
// fixed per family by a template argument; log arguments are guarded at
// 1e-30 as on the TPU.
#include <cstdint>
#include <type_traits>
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

// The families whose domain is the open positive axis (core/quantize.py).
template <int F>
constexpr bool kPositive = F == kItakuraSaito || F == kBurg || F == kShannon;

// T is float (fp32 rows) or int8_t (codes decoded with the row's scale, zp).
template <int F, typename T>
__global__ void __launch_bounds__(THREADS)
refine_kernel(const T* __restrict__ rows, const float* __restrict__ scale,
              const float* __restrict__ zp, const float* __restrict__ grad,
              const float* __restrict__ c_y, float* __restrict__ out,
              int64_t b, int64_t d, int64_t pairs) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (w >= pairs) return;            // whole warps leave together
  const int64_t qi = w / b;
  const T* x = rows + w * d;
  const float* g = grad + qi * d;
  float s = 0.f;
  float z = 0.f;
  if constexpr (QUANT) {
    s = scale[w];
    z = zp[w];
  }
  float fx = 0.f;
  float cross = 0.f;
  for (int64_t j = lane; j < d; j += 32) {
    float v;
    if constexpr (QUANT) {
      v = __fadd_rn(__fmul_rn(static_cast<float>(x[j]), s), z);
      if constexpr (kPositive<F>) v = fmaxf(v, 1e-6f);
    } else {
      v = x[j];
    }
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

template <int F, typename T>
void launch(const T* rows, const float* scale, const float* zp,
            const float* grad, const float* c_y, float* out, int64_t b,
            int64_t d, int64_t pairs, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((pairs + WARPS - 1) / WARPS));
  refine_kernel<F, T><<<grid, THREADS, 0, stream>>>(rows, scale, zp, grad,
                                                    c_y, out, b, d, pairs);
}

template <typename T>
int refine(const T* rows, const float* scale, const float* zp,
           const float* grad, const float* c_y, float* out, int64_t q,
           int64_t b, int64_t d, int family, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t pairs = q * b;
  if (pairs <= 0) return 0;
  if (d <= 0 || (pairs + WARPS - 1) / WARPS > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (family) {
    case kSquaredEuclidean: launch<kSquaredEuclidean>(rows, scale, zp, grad, c_y, out, b, d, pairs, s); break;
    case kItakuraSaito: launch<kItakuraSaito>(rows, scale, zp, grad, c_y, out, b, d, pairs, s); break;
    case kExponential: launch<kExponential>(rows, scale, zp, grad, c_y, out, b, d, pairs, s); break;
    case kBurg: launch<kBurg>(rows, scale, zp, grad, c_y, out, b, d, pairs, s); break;
    case kShannon: launch<kShannon>(rows, scale, zp, grad, c_y, out, b, d, pairs, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int brk_refine_batch(const float* rows, const float* grad,
                                const float* c_y, float* out, int64_t q,
                                int64_t b, int64_t d, int family, int device,
                                void* stream) {
  return refine<float>(rows, nullptr, nullptr, grad, c_y, out, q, b, d,
                       family, device, stream);
}

extern "C" int brk_refine_batch_quant(const int8_t* codes, const float* scale,
                                      const float* zp, const float* grad,
                                      const float* c_y, float* out, int64_t q,
                                      int64_t b, int64_t d, int family,
                                      int device, void* stream) {
  return refine<int8_t>(codes, scale, zp, grad, c_y, out, q, b, d, family,
                        device, stream);
}

extern "C" const char* brk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
