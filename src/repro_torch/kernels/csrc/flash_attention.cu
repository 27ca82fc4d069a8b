// Causal GQA flash attention with online softmax in fp32, on the fp32 cores.
//
//   out[b, h, i] = softmax_j( mask(i, j) ? q[b, h, i] . k[b, h/rep, j] * scale
//                                         : -1e30 ) . v[b, h/rep, :]
//
// brk_flash_attention replaces the TPU kernel src/repro/kernels/
// flash_attention.py::flash_attention for fp32 q, k, v; bf16 runs on the
// tensor cores (flash_attention_wgmma.cu), which would need TF32, three
// decimal digits, for fp32 operands.  The TPU kernel is a grid over
// (batch, head, q tile, kv tile) whose last axis runs in order and carries
// m, l and acc in VMEM scratch.  Here one block owns (b, h, a 64-row q
// tile) and loops over the kv tiles itself: m and l per row live in shared
// memory, acc in registers.  The mask is the TPU kernel's: q_pos = i + Skv
// - Sq (end-aligned, so a short query block is the tail of the sequence),
// k_pos < Skv, q_pos >= k_pos when causal, q_pos - k_pos < window when a
// window is given.  The update is the TPU kernel's too: m_new = max(m,
// rowmax(s)), p = exp(s - m_new), alpha = exp(m - m_new), l = alpha * l +
// sum(p), acc = alpha * acc + p . v, out = acc / max(l, 1e-30).  A row that
// meets only masked keys in a tile before its first valid key gains p = 1
// for them, as on the TPU; alpha = exp(-1e30 - m) = 0 wipes that out at the
// first valid key, and every row has one (q_pos >= 0 sees itself).
//
// Differences from the TPU kernel that change no result: kv tiles that lie
// wholly outside the causal or window reach of the q tile are skipped (the
// TPU kernel keeps the dense grid); ragged Sq and Skv are masked here, so
// no padded copy is made; the tensors come with their strides, so the
// model's (B, S, H, D) layout is read in place (the innermost dim must be
// contiguous).
//
// Bound on the H100: operations, 2 * 2 * B*H*Sq*Skv*D (halved when causal)
// at the fp32 cores' 67 TFLOP/s.  Each thread holds a 4 x 2 tile of s and a
// 4 x (D/16) tile of acc and reads q, k, v from shared memory (rows padded
// by one word against bank conflicts), so shared-memory bandwidth, not the
// FMA rate, sets its pace.  At D = 256 the tiles take 140,800 bytes of
// shared memory (the opt-in of `launch`) and acc 64 registers a thread.  The model runs it only where it computes in
// fp32: the first-token logits check of chip_smoke.py and the CPU-parity
// configurations.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows a block
constexpr int BKV = 32;         // keys a tile (one per lane in the softmax)
constexpr int THREADS = 256;    // 16 x 16: rows ty + 16 i, cols tx + 16 j
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  // Element strides of (batch, head, seq); the innermost dim is contiguous.
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int h, kh, sq, skv;
  int causal;
  int window;                   // <= 0: no window
  float scale;
};

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + 2 * BKV * (D + 1) + BQ * (BKV + 1) + 3 * BQ;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const Args a) {
  constexpr int DP = D + 1;          // padded row stride of q, k, v tiles
  constexpr int PP = BKV + 1;        // padded row stride of the p tile
  constexpr int CJ = D / 16;         // acc columns a thread
  extern __shared__ float smem[];
  float* qs = smem;                  // (BQ, DP)
  float* ks = qs + BQ * DP;          // (BKV, DP)
  float* vs = ks + BKV * DP;         // (BKV, DP)
  float* ps = vs + BKV * DP;         // (BQ, PP)
  float* m_s = ps + BQ * PP;         // (BQ,)
  float* l_s = m_s + BQ;             // (BQ,)
  float* alpha_s = l_s + BQ;         // (BQ,)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.h / a.kh);
  const int off = a.skv - a.sq;      // end alignment of the queries

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* op = static_cast<float*>(a.out) + b * a.o_sb + h * a.o_sh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    const int qi = q0 + r;
    qs[r * DP + c] = qi < a.sq ? qp[qi * a.q_ss + c] : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  // The keys any row of this tile can see: [kv_begin, kv_end).
  const int q_lo = q0 + off;
  const int q_hi = min(q0 + BQ, a.sq) - 1 + off;
  const int kv_end = a.causal ? min(a.skv, q_hi + 1) : a.skv;
  int kv_begin = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
  kv_begin -= kv_begin % BKV;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    __syncthreads();                 // the last tile's k, v, p are used up
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, c = e - r * D;
      const int kj = k0 + r;
      const bool ok = kj < a.skv;
      ks[r * DP + c] = ok ? kp[kj * a.k_ss + c] : 0.f;
      vs[r * DP + c] = ok ? vp[kj * a.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qpos = q0 + r + off, kpos = k0 + c;
        bool ok = kpos < a.skv;
        if (a.causal) ok = ok && qpos >= kpos;
        if (a.window > 0) ok = ok && (qpos - kpos) < a.window;
        ps[r * PP + c] = ok ? s[i][j] * a.scale : NEG_INF;
      }
    }
    __syncthreads();

    // Online softmax: a warp takes BQ / WARPS rows, one key a lane.
#pragma unroll
    for (int rr = 0; rr < BQ / WARPS; ++rr) {
      const int r = warp * (BQ / WARPS) + rr;
      const float sv = ps[r * PP + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(sv));
      const float p = expf(sv - m_new);
      const float psum = warp_sum(p);
      ps[r * PP + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = alpha_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float vv = vs[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();                   // l_s holds every row's final sum

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= a.sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      op[qi * a.o_ss + tx + 16 * j] = acc[i][j] / l;
  }
}

template <int D>
int launch(const Args& a, int b, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + BQ - 1) / BQ, a.h, b);
  flash_kernel<D><<<grid, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

// fp32 q, k, v and out.  strides: the (batch, head, seq) element strides of
// q, k, v and out, 12 int64 values.
extern "C" int brk_flash_attention(const void* q, const void* k,
                                   const void* v, void* out,
                                   const int64_t* strides, int b, int h,
                                   int kh, int sq, int skv, int d, int causal,
                                   int window, float scale, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || sq <= 0) return 0;
  if (h <= 0 || kh <= 0 || h % kh != 0 || skv <= 0 || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_ss = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_ss = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_ss = strides[8];
  a.o_sb = strides[9]; a.o_sh = strides[10]; a.o_ss = strides[11];
  a.h = h;
  a.kh = kh;
  a.sq = sq;
  a.skv = skv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(a, b, s);
    case 32: return launch<32>(a, b, s);
    case 64: return launch<64>(a, b, s);
    case 128: return launch<128>(a, b, s);
    case 256: return launch<256>(a, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
