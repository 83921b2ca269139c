// mma.sync m16n8k16 on bf16 pieces of float32 operands: the helpers the
// port's tensor-core kernels share (ssd_scan.cu, flash_attention_mma3.cu).
//
// A float32 operand v is split into three bf16 pieces hi + mid + lo (each
// residual is exact in float32, so the pieces sum to v in float32's normal
// range), and a product of two split operands sums the six piece products
// that reach float32's rounding on one float32 accumulator, smallest
// first: lo hi, hi lo, mid mid, mid hi, hi mid, hi hi (mma_k); lo mid,
// mid lo and lo lo lie below 2^-24 of it.  The CPU models of
// tests/test_torch_ssd_design.py and tests/test_torch_flash_design.py
// settled the six (repro_torch/kernels/pieces.py: the same split and
// order): two pieces and three products lie 6-30x farther from float64
// than the plain float32 version; three and six as close.
//
// Everything here lives in an unnamed namespace: each source that includes
// it gets its own inline copies.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies done except the newest `N` groups
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix: four 8 x 8 bf16 tiles; lane l gives the row address of tile
// l / 8 (a pointer, or its shared-window address).  .trans hands each
// thread the transposed tile.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  ldsm4(r, smem_u32(p));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  ldsm4t(r, smem_u32(p));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, float32 accumulators.
// Fragments (g = lane / 4, t = lane % 4):
//   a[0] (row g, k 2t..2t+1), a[1] (row g+8, same k), a[2] (row g, k 2t+8..),
//   a[3] (row g+8, k 2t+8..); b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g);
//   d[0..1] (row g, cols 2t..2t+1), d[2..3] (row g+8, same cols).
// (Not volatile: a register-only op the compiler may schedule freely.)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo_k, float hi_k) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack2(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}

// (v0, v1) -> bf16 pairs hi, mid, lo with hi + mid + lo = v exactly.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack2(v0, v1);
  float2 f = unpack2(hi);
  const float r0 = v0 - f.x, r1 = v1 - f.y;
  mid = pack2(r0, r1);
  f = unpack2(mid);
  lo = pack2(r0 - f.x, r1 - f.y);
}

// An m16k16 A operand (or two n8 B operands) in three pieces.
struct Frag3 {
  uint32_t h[4], m[4], l[4];
};

// Product k (0-5) of d += a b over the six piece products, b the n8 tile
// (b0, b1) = pieces [i0], [i1] of `b`, smallest first: lo hi, hi lo,
// mid mid, mid hi, hi mid, hi hi.  The callers take k outermost over
// several accumulators, so that independent mma chains are in flight.
__device__ __forceinline__ void mma_k(int k, float (&d)[4], const Frag3& a,
                                      const Frag3& b, int i0, int i1) {
  switch (k) {
    case 0: mma(d, a.l, b.h[i0], b.h[i1]); break;
    case 1: mma(d, a.h, b.l[i0], b.l[i1]); break;
    case 2: mma(d, a.m, b.m[i0], b.m[i1]); break;
    case 3: mma(d, a.m, b.h[i0], b.h[i1]); break;
    case 4: mma(d, a.h, b.m[i0], b.m[i1]); break;
    default: mma(d, a.h, b.h[i0], b.h[i1]); break;
  }
}

}  // namespace
