// Causal GQA flash attention in bf16 on Hopper's tensor cores (wgmma + TMA).
//
//   out[b, h, i] = softmax_j( mask(i, j) ? q[b, h, i] . k[b, h/rep, j] * scale
//                                         : -1e30 ) . v[b, h/rep, :]
//
// brk_flash_attention_bf16 replaces the TPU kernel src/repro/kernels/
// flash_attention.py::flash_attention for bf16 q, k, v (fp32 stays on the
// SIMT kernel of flash_attention.cu: an fp32 tensor-core product needs
// TF32).  The function is the TPU kernel's, lines 27-67 there: q_pos = i +
// Skv - Sq (end-aligned), k_pos < Skv, q_pos >= k_pos when causal, q_pos -
// k_pos < window when a window is given, -1e30 for a masked logit; m_new =
// max(m, rowmax(s)), p = exp(s - m_new), alpha = exp(m - m_new), l = alpha
// * l + sum(p), acc = alpha * acc + p . v, out = acc / max(l, 1e-30) in
// bf16.  m, l, the softmax and acc are fp32.
//
// Bound on the H100: operations.  The kNN-LM corpus batch (B = 8, H = 24,
// KH = 2, S = 1024, D = 128, causal) is 51.5 GFLOP of bf16 products
// against 0.1 GB of q, k, v and out: 0.052 ms at 989 TFLOP/s.  The design:
//
// - A block owns (b, h, a 128-row q tile): two consumer warpgroups of 64
//   rows (wgmma's M) and one producer warp.  The grid runs the latest q
//   tiles, the longest under the causal mask, first.
// - The producer issues TMA loads: the q tile once, then 64-key k and v
//   tiles into a 2-stage ring on mbarriers.  The tensor maps describe the
//   strided 4-D view (D, S, H, B), so the model's (B, S, H, D) tensors are
//   read in place; rows past Sq or Skv arrive as zeros (the k_pos < Skv
//   mask stays).  Each 64-column panel of a row is 128 bytes in the
//   128-byte swizzle that the wgmma descriptors read; a head with D < 64
//   is staged as one zero-padded panel.
// - S = Q K^T is wgmma m64n64k16 from shared memory, fp32 accumulated;
//   scale, mask and the online softmax run on its registers (row max and
//   sum across the four lanes of a quad).  Tiles wholly inside every row's
//   reach skip the mask; kv tiles out of causal or window reach are not
//   loaded, and a warpgroup skips a loaded tile that none of its rows
//   reaches.
// - O += P V is wgmma with P in registers (the S accumulator's layout is
//   the A operand's) and V from shared memory (transposed B).  P goes in
//   as two bf16 halves, P_hi = bf16(P) and P_lo = bf16(P - P_hi), into one
//   accumulator: a single bf16 rounding of P would move the output by
//   tens of its own rounding (tests/test_torch_flash_design.py), the
//   split keeps it within the fp32 kernel's error.  l sums the fp32 P.
// - Each warpgroup waits for its products (wait_group 0); the other
//   warpgroup's softmax overlaps them.  Ping-pong scheduling and overlap of
//   softmax with wgmma inside a warpgroup are not done.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 128;               // query rows a block
constexpr int BKV = 64;               // keys a kv tile
constexpr int PANEL = 64;             // bf16 columns of one swizzled panel
constexpr int ROW_BYTES = 128;        // one panel row
constexpr int STAGES = 2;
constexpr int CONSUMERS = 256;        // two warpgroups
constexpr int THREADS = CONSUMERS + 32;
constexpr float NEG_INF = -1e30f;

template <int D>
struct Cfg {
  static constexpr int DP = D < PANEL ? PANEL : D;   // staged columns
  static constexpr int NP = DP / PANEL;              // panels
  static constexpr int KSTEPS = (D + 15) / 16;       // k16 steps of q . k
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BKV * DP * 2;      // k or v, one stage
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024 + 64;
};

struct Params {
  void* out;
  int64_t o_sb, o_sh, o_ss;           // element strides of out
  int h, kh, sq, skv;
  int causal, window;                 // window <= 0: none
  float scale;
  int q_tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier completes the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t desc = (smem_u32(p) & 0x3FFFF) >> 4;
  desc |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  desc |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  desc |= 1ull << 62;
  return desc;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                 uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ void pv_mma(float (&o)[32], const uint32_t* a,
                                       uint64_t db) {
  wgmma_rs_m64n64(o, a, db);
}
__device__ __forceinline__ void pv_mma(float (&o)[64], const uint32_t* a,
                                       uint64_t db) {
  wgmma_rs_m64n128(o, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;                          // NP panels of BQ rows
  uint8_t* ks = qs + C::Q_BYTES;               // STAGES x NP panels of BKV rows
  uint8_t* vs = ks + STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * C::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (p.q_tiles - 1 - static_cast<int>(blockIdx.z)) * BQ;
  const int hk = h / (p.h / p.kh);
  const int off = p.skv - p.sq;                // end alignment of the queries

  // The keys any row of the block can see: [kv_begin, kv_end).
  const int kv_end = p.causal ? min(p.skv, min(q0 + BQ, p.sq) + off) : p.skv;
  int kv_begin = p.window > 0 ? max(0, q0 + off - p.window + 1) : 0;
  kv_begin -= kv_begin % BKV;
  const int n_tiles = (kv_end - kv_begin + BKV - 1) / BKV;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // Producer: one thread issues every load.
    if (tid == CONSUMERS) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::NP; ++pn)
        tma_load(qs + pn * BQ * ROW_BYTES, &tq, q_full, pn * PANEL, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        const int k0 = kv_begin + t * BKV;
        uint8_t* kd = ks + s * C::KV_BYTES;
        uint8_t* vd = vs + s * C::KV_BYTES;
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn) {
          tma_load(kd + pn * BKV * ROW_BYTES, &tk, &full[s], pn * PANEL, k0,
                   hk, b);
          tma_load(vd + pn * BKV * ROW_BYTES, &tv, &full[s], pn * PANEL, k0,
                   hk, b);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [q0 + 64 wg, q0 + 64 wg + 64).
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wrow = q0 + wg * 64;
  const int row0 = wrow + warp * 16 + lane / 4;   // and row0 + 8
  const bool live = wrow < p.sq;
  const int wq_lo = wrow + off;
  const int wq_hi = min(wrow + 64, p.sq) - 1 + off;
  const int w_end = p.causal ? min(p.skv, wq_hi + 1) : p.skv;
  const int w_begin = p.window > 0 ? max(0, wq_lo - p.window + 1) : 0;

  float o[C::DP / 2];
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};                      // this lane's part of the sum

  mbar_wait(q_full, 0);
  const uint8_t* qw = qs + wg * 64 * ROW_BYTES;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const int k0 = kv_begin + t * BKV;
    mbar_wait(&full[s], (t / STAGES) & 1);
    if (live && k0 < w_end && k0 + BKV > w_begin) {
      const uint8_t* kt = ks + s * C::KV_BYTES;
      const uint8_t* vt = vs + s * C::KV_BYTES;
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        const int pn = kk / 4, col = (kk % 4) * 32;
        wgmma_ss_m64n64(sc,
                        sw128_desc(qw + pn * BQ * ROW_BYTES + col, 16, 1024),
                        sw128_desc(kt + pn * BKV * ROW_BYTES + col, 16, 1024),
                        kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(sc);

      // Scale, mask, online softmax.  sc[i] is row row0 + 8 ((i >> 1) & 1),
      // key k0 + 8 (i >> 2) + 2 (lane % 4) + (i & 1).
      const bool inside = k0 + BKV <= p.skv &&
                          (!p.causal || k0 + BKV - 1 <= wq_lo) &&
                          (p.window <= 0 || wq_hi - k0 < p.window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float x = sc[i] * p.scale;
        if (!inside) {
          const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int qpos = row0 + 8 * r + off;
          bool ok = kpos < p.skv;
          if (p.causal) ok = ok && qpos >= kpos;
          if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
          x = ok ? x : NEG_INF;
        }
        sc[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
      uint32_t p_hi[16], p_lo[16];
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = j & 1;
        const float p0 = expf(sc[2 * j] - m[r]);
        const float p1 = expf(sc[2 * j + 1] - m[r]);
        ls[r] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[j] = bf16x2_bits(hi);
        p_lo[j] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + ls[r];
#pragma unroll
      for (int i = 0; i < C::DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      fence_regs(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        pv_mma(o, p_hi + 4 * kk,
               sw128_desc(vt + kk * 16 * ROW_BYTES, BKV * ROW_BYTES, 1024));
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        pv_mma(o, p_lo + 4 * kk,
               sw128_desc(vt + kk * 16 * ROW_BYTES, BKV * ROW_BYTES, 1024));
      wg_commit();
      wg_wait_all();
      fence_regs(o);
    }
    mbar_arrive(&empty[s]);
  }

  // out = acc / max(l, 1e-30), l summed over the quad's four lanes.
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb +
                      h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < C::DP / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = row0 + 8 * r;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    if (row < p.sq && col < D)
      *reinterpret_cast<__nv_bfloat162*>(op + row * p.o_ss + col) =
          __floats2bfloat162_rn(o[i] / l[r], o[i + 1] / l[r]);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links without the driver library.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The (D, S, H, B) view of a bf16 tensor with element strides (b, h, s),
// read in boxes of 64 columns x `rows` rows, 128-byte swizzled.
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int d,
              int s, int heads, int b, const int64_t* strides, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {PANEL, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, bytes, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int MAX_DEVICES = 64;

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Params& p, int b, int device,
           cudaStream_t stream) {
  const int bytes = Cfg<D>::SMEM;
  // The shared-memory opt-in, once a device (the call costs host time).
  static bool opted_in[MAX_DEVICES] = {};
  if (!opted_in[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  const dim3 grid(p.h, b, p.q_tiles);
  flash_tc_kernel<D><<<grid, THREADS, bytes, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v and out.  strides: the (batch, head, seq) element strides
// of q, k, v and out, 12 int64 values; base pointers 16-byte aligned, the
// strides of q, k and v multiples of 8 elements (TMA's 16 bytes), the
// innermost dim contiguous.
extern "C" int brk_flash_attention_bf16(const void* q, const void* k,
                                        const void* v, void* out,
                                        const int64_t* strides, int b, int h,
                                        int kh, int sq, int skv, int d,
                                        int causal, int window, float scale,
                                        int device, void* stream) {
  if (device < 0 || device >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || sq <= 0) return 0;
  if (h <= 0 || kh <= 0 || h % kh != 0 || skv <= 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_tiles = (sq + BQ - 1) / BQ;
  if (q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, encode, q, d, sq, h, b, strides, BQ) ||
      !make_map(&tk, encode, k, d, skv, kh, b, strides + 3, BKV) ||
      !make_map(&tv, encode, v, d, skv, kh, b, strides + 6, BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.out = out;
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.h = h;
  p.kh = kh;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.q_tiles = q_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(tq, tk, tv, p, b, device, s);
    case 32: return launch<32>(tq, tk, tv, p, b, device, s);
    case 64: return launch<64>(tq, tk, tv, p, b, device, s);
    case 128: return launch<128>(tq, tk, tv, p, b, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
