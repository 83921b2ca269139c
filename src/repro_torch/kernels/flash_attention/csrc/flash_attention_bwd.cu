// Flash attention backward: dQ, dK and dV of ops.flash_attention from its
// output O, each query row's log-sum-exp (written by the forward kernels
// when asked) and the output's gradient dO, in bf16 or float32.
//
// Replaces no Pallas kernel: the JAX package has no attention backward
// kernel.  Its training attention is `_blocked_sdpa`
// (src/repro/models/layers.py:117), whose gradient is XLA's autodiff of a
// jax.checkpoint-ed key loop that recomputes each probability block; this
// is that gradient as kernels on the card, behind the autograd Function of
// ops.py.  The formula is ref.flash_attention_backward_reference's:
// P = exp(s - lse) recomputed from Q and K (s the scaled, optionally
// softcapped score), dV = P^T dO, dS = P (dO V^T - D) with
// D = rowsum(dO O), times 1 - tanh^2 at the capped score under a softcap,
// dQ = dS K scale, dK = dS^T Q scale; queries right-aligned to the key
// timeline (offset T - S), ragged S and T masked, GQA summed over each KV
// head's group.  The forward's rounding of P to bf16 is passed straight
// through.
//
// Three launches a backward, no atomics, so two runs give the same bits:
//   1. flash_bwd_dsum_kernel: one warp a query row, D = rowsum(dO O);
//   2. flash_bwd_dkdv_kernel: one CTA per (key tile of 32, KV head, batch),
//      looping over the G query heads of its group and over the query
//      tiles that see its keys, in a fixed order (the GQA sum with no
//      atomics); dK and dV stay in registers until the end;
//   3. flash_bwd_dq_kernel: one CTA per (query tile of 32, head, batch),
//      over the key tiles up to its causal diagonal, heaviest tile first.
// The CTA programs are in flash_bwd_tile.cuh, shared with a host build
// that the CPU tests run.
//
// What bounds it on an H100: operations.  Five products of 2 B H S T hd
// FLOP (halved under causal); at the training slice's shape (B 8,
// S = T = 128, 16 heads over 2, hd 128, causal) that is 1.34 GFLOP against
// 3.1 MB of bf16 tensors, and at B 4, S = T = 1024 43 GFLOP.  This first
// design runs them on the FMA pipes in float32 (67 TFLOP/s, 0.64 ms at
// B 4, S = T = 1024) from float32 tiles in shared memory, about one
// shared-memory load an FMA: simple and exact to float32's rounding for
// both types; a tensor-core design (wgmma, TMA) is later work.
// 74.5 KB of shared memory a CTA at hd 128: three CTAs an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_tile.cuh"

namespace {

using flash_bwd::Shape;
using flash_bwd::Tensors;
using flash_bwd::Tile;
using flash_bwd::THREADS;

// One CTA's phases on the card: each ends in a barrier.
template <int N>
struct DevCta {
  float acc[N];
  template <class F>
  __device__ __forceinline__ void each(F&& f) {
    f((int)threadIdx.x, acc);
    __syncthreads();
  }
};

template <int HD, typename E>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dsum_kernel(Tensors<E> t, Shape s) {
  const int64_t row = (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)s.B * s.S * s.H) return;
  float a = flash_bwd::dsum_part<HD>(t.o + row * HD, t.dout + row * HD, lane);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    a += __shfl_xor_sync(0xffffffffu, a, off);
  if (lane == 0) {
    const int h = (int)(row % s.H);
    const int64_t bs = row / s.H;
    const int64_t b = bs / s.S, q = bs % s.S;
    t.dsum[(b * s.H + h) * s.S + q] = a;
  }
}

template <int HD, typename E>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(Tensors<E> t, Shape s) {
  extern __shared__ float sm[];
  DevCta<HD / 4> cta;
  flash_bwd::dkdv_block<HD>(cta, sm, t, s, blockIdx.x, blockIdx.y,
                            blockIdx.z);
}

template <int HD, typename E>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(Tensors<E> t, Shape s) {
  extern __shared__ float sm[];
  DevCta<HD / 8> cta;
  const int it = s.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  flash_bwd::dq_block<HD>(cta, sm, t, s, it, blockIdx.y, blockIdx.z);
}

template <int HD, typename E>
cudaError_t launch(const Tensors<E>& t, const Shape& s, cudaStream_t st) {
  constexpr unsigned smem = Tile<HD>::bytes;
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  static bool opted_in[64] = {};    // per device, once per process
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !opted_in[dev]) {
    e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD, E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD, E>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) opted_in[dev] = true;
  }
  if (s.H > 65535 || s.B > 65535) return cudaErrorInvalidConfiguration;
  const int64_t rows = (int64_t)s.B * s.S * s.H;
  const int64_t blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_bwd_dsum_kernel<HD, E><<<(unsigned)blocks, THREADS, 0, st>>>(t, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 kv_grid((s.T + flash_bwd::C - 1) / flash_bwd::C, s.KV, s.B);
  flash_bwd_dkdv_kernel<HD, E><<<kv_grid, THREADS, smem, st>>>(t, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 q_grid((s.S + flash_bwd::R - 1) / flash_bwd::R, s.H, s.B);
  flash_bwd_dq_kernel<HD, E><<<q_grid, THREADS, smem, st>>>(t, s);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const Tensors<E>& t, const Shape& s, int hd,
                     cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16>(t, s, st);
    case 32: return launch<32>(t, s, st);
    case 64: return launch<64>(t, s, st);
    case 80: return launch<80>(t, s, st);
    case 128: return launch<128>(t, s, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename E>
Tensors<E> tensors(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* dsum, void* dq, void* dk, void* dv) {
  return Tensors<E>{static_cast<const E*>(q),    static_cast<const E*>(k),
                    static_cast<const E*>(v),    static_cast<const E*>(o),
                    static_cast<const E*>(dout), static_cast<const float*>(lse),
                    static_cast<float*>(dsum),   static_cast<E*>(dq),
                    static_cast<E*>(dk),         static_cast<E*>(dv)};
}

}  // namespace

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, T, KV, hd), all of one
// type (dtype 0 float32, 1 bfloat16), contiguous; lse: float32 (B, H, S)
// from the forward; dsum: float32 (B, H, S) scratch.  Three launches on
// `stream`; returns cudaGetLastError() after them, or the first error.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, int B, int S, int T, int H, int KV, int hd, int causal,
    float softcap, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const Shape s{B, S, T, H, KV, causal, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch(
        tensors<float>(q, k, v, o, dout, lse, dsum, dq, dk, dv), s, hd, st);
  if (dtype == 1)
    return (int)dispatch(
        tensors<__nv_bfloat16>(q, k, v, o, dout, lse, dsum, dq, dk, dv), s,
        hd, st);
  return (int)cudaErrorInvalidValue;
}
