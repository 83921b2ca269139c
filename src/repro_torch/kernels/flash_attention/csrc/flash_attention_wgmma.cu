// Flash attention forward in bf16 on Hopper's tensor cores (wgmma).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py (`_flash_kernel` / `flash_attention_bhsd`) for bf16
// inputs, with the contract of ops.flash_attention: q (B, S, H, hd) and k/v
// (B, T, KV, hd) in the model layout, query head h reading KV head
// h / (H / KV), queries right-aligned to the key timeline (offset T - S),
// keys at or past T and (causal) keys past the query taking no part,
// s = (q . k) * scale then the optional softcap c * tanh(s / c), online
// softmax with m, l and acc in float32, p rounded to bf16 before P @ V (the
// Pallas kernel's p.astype(v.dtype)) while l sums the unrounded p, and
// out = acc / max(l, 1e-30).  float32 inputs go to the three-piece mma.sync
// kernel of flash_attention_mma3.cu: a float32 product here would be TF32.
// Given an lse buffer (float32 (B, H, S); null when serving), the epilogue
// also writes each row's log-sum-exp of its scores, (m f + log2 l) ln 2,
// from the row max and sum already in registers: the backward kernels of
// flash_attention_bwd.cu recompute P from it.
//
// What bounds it on an H100: operations.  The causal slice shape (B 4,
// S = T = 1024, H 16, hd 128) is 17.2 GFLOP against 37.7 MB of bf16
// inputs and output, ~456 FLOP per byte, above the card's ~295 in bf16:
// the floor is the tensor cores' 989 TFLOP/s (17 us).
//
// Design.  One CTA of three warpgroups per (batch * head, 128-query
// block), launched heaviest (latest causal) query block first.  Warpgroup
// 2 is the producer: one thread loads the Q tile once and then each
// 128-key K and V tile with TMA into a two-stage ring in shared memory,
// each stage's arrival counted in bytes by an mbarrier.  Warpgroups 0 and
// 1 own 64 query rows apiece: per key tile, S = Q K^T is hd / 16 wgmma
// m64n128k16 steps from shared memory (both operands K-major); the scores
// are capped and masked in registers, the row max is reduced over the
// four lanes that share a row, and p = 2^(s * scale * log2 e - m) (one FMA
// and one ex2.approx) is packed to bf16 straight into the register A
// fragments of O += P V: eight wgmma m64n{hd}k16 steps with V read
// MN-major (its key rows as stored) through the transpose bit.  Each
// consumer thread then releases the stage on its empty mbarrier.  Key
// tiles wholly above the causal diagonal are never loaded; ragged S and T
// come from TMA's zero fill of out-of-range rows, and are masked.
// setmaxnreg drops the producer warpgroup to 24 registers and raises the
// consumers to 240 (ptxas -v: 168 a thread at launch, no spills).
//
// Layout: the 128-byte swizzle of flash_layout.cuh, with hd zero-padded in
// shared memory to a multiple of 64 columns (hd 80's 160-byte rows divide
// no 128-byte atom).  At hd 80 that costs shared memory only: its tiles
// take 128 columns, as hd 128's do (160 KB, one CTA per SM either way);
// TMA writes the padding as zeros and no wgmma step reads it.  A 32-byte
// swizzle would divide every head dim unpadded, but then the eight 16-byte
// rows of a wgmma core matrix span 256 bytes, two shared-memory wavefronts
// where the 128-byte swizzle needs one.
//
// The tensor maps are encoded per call on the host
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
// library needs no -lcuda) and passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_layout.cuh"

namespace {

constexpr int BQ = 128;           // queries per CTA (two consumer warpgroups)
constexpr int BK = 128;           // keys per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr int CONSUMERS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
// A wait that never ends (a lost TMA or arrival) traps after 2^26 polls,
// failing the stream instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// One TMA box of a 4-d tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- wgmma instructions: S = Q K^T (both from shared memory, N = BK) and
// O += P V (P from registers, V MN-major, N = hd) ------------------------
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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


template <int N> struct PV;
template <> struct PV<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n16(d, a, db);
  }
};
template <> struct PV<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n32(d, a, db);
  }
};
template <> struct PV<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n64(d, a, db);
  }
};
template <> struct PV<80> {
  static __device__ __forceinline__ void mma(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n80(d, a, db);
  }
};
template <> struct PV<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n128(d, a, db);
  }
};

template <int HD>
struct Smem {
  static constexpr uint32_t slices = flash_layout::padded_cols(HD) / 64;
  static constexpr uint32_t q = BQ * slices * flash_layout::kRowBytes;
  static constexpr uint32_t tile = BK * slices * flash_layout::kRowBytes;
  static constexpr uint32_t kv = q;                    // stage s: K, then V
  static constexpr uint32_t bars = kv + STAGES * 2 * tile;
  // full[STAGES], empty[STAGES], q: 8 bytes each; 1024 for the alignment
  static constexpr size_t bytes = 1024 + bars + 8 * (2 * STAGES + 1);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The scores of one key tile, in registers, in the domain x (the raw
// q . k, or the capped score with a softcap) where f (scale * log2 e, or
// log2 e) takes x to log2 units: masked to -inf, the running max m (in x)
// updated with corr = 2^((m_old - m_new) f), and p = 2^(x f - m f) summed
// unrounded into rs and packed to bf16 as the A fragments of P V (step kk
// covers keys 16 kk .. 16 kk + 15: accumulator column blocks 2 kk and
// 2 kk + 1).  Every row has a live key in the first tile (causal S <= T),
// so m is finite from then on and a row masked in a later tile weighs 0,
// as the reference's -1e30 does.
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4], float (&m)[2],
    float (&corr)[2], float (&rs)[2], int k0, int T, int row0, int col0,
    bool edge, int causal, int offset, float scale, float softcap) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = sc[n * 4 + i * 2 + c];
        if (softcap > 0.f) x = softcap * tanhf(x * scale / softcap);
        if (edge) {
          const int kpos = k0 + n * 8 + col0 + c;
          const int qpos = row0 + 8 * i + offset;
          if (kpos >= T || (causal && kpos > qpos)) x = -INFINITY;
        }
        sc[n * 4 + i * 2 + c] = x;
      }
  const float f = softcap > 0.f ? LOG2E : scale * LOG2E;
  float mf[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      mx = fmaxf(mx, fmaxf(sc[n * 4 + i * 2], sc[n * 4 + i * 2 + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    corr[i] = m[i] == -INFINITY ? 0.f : ex2((m[i] - m_new) * f);
    m[i] = m_new;
    mf[i] = m_new == -INFINITY ? 0.f : m_new * f;
    rs[i] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float p0 = ex2(__fmaf_rn(sc[n * 4 + i * 2], f, -mf[i]));
      const float p1 = ex2(__fmaf_rn(sc[n * 4 + i * 2 + 1], f, -mf[i]));
      rs[i] += p0 + p1;
      pa[n / 2][(n % 2) * 2 + i] = pack_bf16(p0, p1);
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int S, int T, int H, int KV, int causal, float softcap,
                   float scale) {
  using L = Smem<HD>;
  constexpr uint32_t ROWB = flash_layout::kRowBytes;
  constexpr int SLICE = flash_layout::kSliceCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bar = base + L::bars;
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (STAGES + s); };
  const uint32_t qbar = bar + 8u * 2 * STAGES;
  auto ktile = [&](int s) { return base + L::kv + (2u * s) * L::tile; };
  auto vtile = [&](int s) { return base + L::kv + (2u * s + 1) * L::tile; };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int offset = T - S;
  int k_end = T;                  // keys past it are above every row's diagonal
  if (causal && q0 + BQ + offset < k_end) k_end = q0 + BQ + offset;
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: one thread drives TMA --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(qbar, L::q);
#pragma unroll
      for (int c = 0; c < (int)L::slices; ++c)
        tma_load_4d(sq + c * BQ * ROWB, &tq, SLICE * c, q0, h, b, qbar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty(s), ((j / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::tile);
#pragma unroll
        for (int c = 0; c < (int)L::slices; ++c) {
          tma_load_4d(ktile(s) + c * BK * ROWB, &tk, SLICE * c, j * BK, kvh,
                      b, full(s));
          tma_load_4d(vtile(s) + c * BK * ROWB, &tv, SLICE * c, j * BK, kvh,
                      b, full(s));
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each -----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int row_wg = q0 + wg * 64;                // first row of this group
    const int row0 = row_wg + warp * 16 + lane / 4; // rows row0, row0 + 8
    const int col0 = 2 * (lane % 4);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};                        // this lane's share
    float sc[BK / 2], corr[2], rs[2];
    uint32_t pa[BK / 16][4];

    mbar_wait(qbar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(full(s), (j / STAGES) & 1);

      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)          // sc = Q K^T
        wgmma_ss_n128(sc, flash_layout::kmajor_desc(sq, BQ, wg * 64, kk),
                      flash_layout::kmajor_desc(ktile(s), BK, 0, kk),
                      kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const int k0 = j * BK;
      const bool edge = k0 + BK > T
                        || (causal && k0 + BK - 1 > row_wg + offset);
      softmax_tile(sc, pa, m, corr, rs, k0, T, row0, col0, edge, causal,
                   offset, scale, softcap);
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[n * 4 + i * 2] *= corr[i];
          acc[n * 4 + i * 2 + 1] *= corr[i];
        }

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)          // acc += P V
        PV<HD>::mma(acc, pa[kk],
                    flash_layout::mnmajor_desc(vtile(s), BK, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty(s));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lt = l[i];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      const int row = row0 + 8 * i;
      if (lse != nullptr && lane % 4 == 0 && row < S) {
        const float f = softcap > 0.f ? LOG2E : scale * LOG2E;
        lse[((int64_t)b * H + h) * S + row] = (m[i] * f + log2f(lt)) * LN2;
      }
      if (row < S) {
        __nv_bfloat16* out = o + (((int64_t)b * S + row) * H + h) * HD + col0;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
              __floats2bfloat162_rn(acc[n * 4 + i * 2] * inv,
                                    acc[n * 4 + i * 2 + 1] * inv);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, rows, heads, hd) bf16 tensor as a 4-d map, boxes of 64 columns x
// box_rows rows of one head, 128-byte swizzle, zero fill past the edges
// (columns past hd included).
int encode(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
           int hd, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {flash_layout::kSliceCols, (cuuint32_t)box_rows,
                             1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int T, int H, int KV, int causal, float softcap,
           float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = encode(&tq, q, B, S, H, HD, BQ);
  if (e == 0) e = encode(&tk, k, B, T, KV, HD, BK);
  if (e == 0) e = encode(&tv, v, B, T, KV, HD, BK);
  if (e != 0) return e;
  constexpr size_t smem = Smem<HD>::bytes;
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  static bool opted_in[64] = {};    // per device, once per process
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_wgmma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted_in[dev] = true;
  }
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_wgmma_kernel<HD><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, T, H, KV, causal,
      softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, o; lse float32 or null; called by flash_attention_launch
// for dtype 1.  Returns cudaGetLastError() after the launch, or the error
// that refused it.
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int S, int T, int H,
                          int KV, int hd, int causal, float softcap,
                          float scale, cudaStream_t stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, lse, B, S, T, H, KV, causal,
                        softcap, scale, stream);
    case 32:
      return launch<32>(q, k, v, o, lse, B, S, T, H, KV, causal,
                        softcap, scale, stream);
    case 64:
      return launch<64>(q, k, v, o, lse, B, S, T, H, KV, causal,
                        softcap, scale, stream);
    case 80:
      return launch<80>(q, k, v, o, lse, B, S, T, H, KV, causal,
                        softcap, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, lse, B, S, T, H, KV, causal,
                        softcap, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
