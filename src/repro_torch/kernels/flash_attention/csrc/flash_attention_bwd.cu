// Flash attention backward: dQ, dK and dV of ops.flash_attention from its
// output O, each query row's log-sum-exp (written by the forward kernels
// when asked) and the output's gradient dO, in bf16 or float32, on the
// tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulators).
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
// times the scale, dQ = dS K, dK = dS^T Q; queries right-aligned to the key
// timeline (offset T - S), ragged S and T masked, GQA summed over each KV
// head's group.  The forward's rounding of P to bf16 is passed straight
// through.
//
// Launches, no atomics, so two runs give the same bits:
//   1. flash_bwd_dsum_kernel: one warp a query row, D = rowsum(dO O);
//   2. flash_bwd_dkdv_kernel: one CTA per (64-key tile, query head, batch),
//      heaviest (first) key tile first, over the 32-query tiles that see
//      its keys: S^T = K Q^T and dP^T = V dO^T on the tensor cores, P^T and
//      dS^T formed in registers and fed straight back as the A fragments
//      of dV += P^T dO and dK += dS^T Q (Q and dO through ldmatrix.trans);
//      dK and dV accumulate in float32 registers.  With G = H / KV > 1 it
//      writes its head's float32 partials to a (2, G, B, T, KV, hd) scratch
//      (the wrapper's torch.empty), else dK and dV themselves;
//   3. flash_bwd_sum_kernel (G > 1 only): dK and dV as the sum of the G
//      partials in head order g = 0 .. G - 1 (flash_bwd_sched.cuh's
//      head_sum), in the input's type;
//   4. flash_bwd_dq_kernel: one CTA per (64-query tile, head, batch),
//      heaviest (last) tile first, over the 32-key tiles up to its causal
//      diagonal: S and dP recomputed, dS in registers as the A fragment of
//      dQ += dS K (K through ldmatrix.trans).
// The tile schedule and the head order live in flash_bwd_sched.cuh, which
// the CPU tests build with g++.
//
// Precision.  bf16: the operands as stored; P and dS rounded to bf16 in
// registers before the products that take them (as the JAX reference rounds
// p to v's type, layers.py:158-160).  float32: a float32 product on the
// tensor cores would be TF32, so every operand (Q, K, V, dO, and P and dS
// in registers) is split into three bf16 pieces hi + mid + lo and each k16
// step sums the six piece products that reach float32's rounding, smallest
// first, on one float32 accumulator (split3 / mma_k of mma3.cuh), as the
// float32 forward does.  tests/test_torch_flash_bwd_design.py models both
// in plain PyTorch: the float32 model lies as close to a float64 backward
// as the plain float32 version.
//
// What bounds it on an H100: operations.  Five products of 2 B H hd per
// kept (query, key) pair; the design computes seven (S and dP in both
// kernels).  B 4, S = T = 1024, 16 heads over 2, hd 128, causal: 43.0 GFLOP
// for the five (0.0435 ms at 989 TFLOP/s), 60.2 for the seven; float32's
// six bf16 products each are 361 GFLOP.  At the training shape (B 8,
// S = T = 128) the bytes bound it (3.1 MB of bf16 tensors).
//
// Design.  A CTA is 4 warps; each warp owns 16 of the CTA's 64 kept rows,
// so each keeps hd / 2 + hd / 2 accumulators (dK and dV) or hd / 2 (dQ) and
// the 16 x 32 score and dP tiles of a step.  The kept rows' planes are
// loaded once; the streamed tiles are double-buffered by cp.async (bf16:
// straight into the bf16 planes; float32: into a float32 staging tile,
// split once a step for the CTA into three bf16 planes).  Plane rows are
// padded to hd + 8 elements, so the 8 row addresses of an ldmatrix fall on
// distinct banks at every head dim (hd 80: 176-byte rows).  A warp skips
// the steps that lie wholly above its causal diagonal.
// Shared memory at hd 128: bf16 70,144 bytes, 2 CTAs an SM (ptxas: 247
// registers in dK/dV, 196 in dQ, no spill); float32 189,952 bytes, 1 CTA
// an SM (255 and 214 registers, 32 bytes spilled in dK/dV).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd_sched.cuh"
#include "mma3.cuh"  // mma, the bf16 pieces, cp.async, ldmatrix

namespace {

using flash_bwd::FIXED;
using flash_bwd::STREAM;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int WROWS = FIXED / WARPS;   // kept rows a warp
constexpr int NS = STREAM / 8;         // n8 tiles of a warp's score tile
constexpr unsigned FULL = 0xffffffffu;
static_assert(WROWS == 16, "a warp's kept rows are one m16 tile");

// bf16 pieces an operand: bf16 as stored, float32 as hi + mid + lo
template <typename E>
struct Pieces;
template <>
struct Pieces<bf16> {
  static constexpr int N = 1;
};
template <>
struct Pieces<float> {
  static constexpr int N = 3;
};

// An m16k16 A operand (or two n8 B operands) in NP pieces.
template <int NP>
struct FragP {
  uint32_t p[NP][4];
};

// Products a k16 step sums: one in bf16, six piece products in float32.
template <int NP>
constexpr int PRODUCTS = NP == 1 ? 1 : 6;
// Product k of d += a b, b the n8 tile (b0, b1) = words [i0], [i1] of `b`;
// float32 in mma3.cuh's order: lo hi, hi lo, mid mid, mid hi, hi mid, hi hi.
template <int NP>
__device__ __forceinline__ void mma_p(int k, float (&d)[4], const FragP<NP>& a,
                                      const FragP<NP>& b, int i0, int i1) {
  if constexpr (NP == 1) {
    mma(d, a.p[0], b.p[0][i0], b.p[0][i1]);
  } else {
    switch (k) {
      case 0: mma(d, a.p[2], b.p[0][i0], b.p[0][i1]); break;
      case 1: mma(d, a.p[0], b.p[2][i0], b.p[2][i1]); break;
      case 2: mma(d, a.p[1], b.p[1][i0], b.p[1][i1]); break;
      case 3: mma(d, a.p[1], b.p[0][i0], b.p[0][i1]); break;
      case 4: mma(d, a.p[0], b.p[1][i0], b.p[1][i1]); break;
      default: mma(d, a.p[0], b.p[0][i0], b.p[0][i1]); break;
    }
  }
}

// (v0, v1) of a C fragment into the A-fragment word of each piece.
template <int NP>
__device__ __forceinline__ void to_pieces(float v0, float v1, FragP<NP>& f,
                                          int r) {
  if constexpr (NP == 1)
    f.p[0][r] = pack2(v0, v1);
  else
    split3(v0, v1, f.p[0][r], f.p[1][r], f.p[2][r]);
}

// Shared memory of one CTA.  Planes are bf16 [rows][LDP]: the two kept
// tensors' NP planes of FIXED rows, then SBUF sets of the two streamed
// tensors' NP planes of STREAM rows; float32 adds the streamed tile's
// float32 staging; then [2 steps][lse, D][STREAM] float32 (dK/dV).
template <int HD, int NP>
struct Smem {
  static constexpr int LDP = HD + 8;
  static constexpr int FPLANE = FIXED * LDP;
  static constexpr int SPLANE = STREAM * LDP;
  static constexpr int SBUF = NP == 1 ? 2 : 1;
  static constexpr size_t oF = 0;
  static constexpr size_t oS = oF + 2 * NP * (size_t)FPLANE * 2;
  static constexpr size_t oStage = oS + (size_t)SBUF * 2 * NP * SPLANE * 2;
  static constexpr size_t oVec =
      oStage + (NP == 3 ? 2 * (size_t)STREAM * HD * 4 : 0);
  static constexpr size_t bytes = oVec + 2 * 2 * STREAM * 4;
  static_assert(HD % 16 == 0, "k16 steps and n8 pairs over the head dim");
  static_assert((LDP / 8) % 2 == 1, "ldmatrix rows on distinct banks");
  static_assert(bytes <= 232448, "shared memory of one block");
};

template <typename E>
struct Args {
  const E *q, *k, *v, *o, *dout;
  const float* lse;
  float* dsum;
  E *dq, *dk, *dv;
  float* part;       // (2, G, B, T, KV, hd) float32 partials, or null (G = 1)
  int B, S, T, H, KV, causal;
  float softcap, scale;
};

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// Two adjacent outputs of a row as E.
__device__ __forceinline__ void put2(float* d, float a, float b) {
  *reinterpret_cast<float2*>(d) = make_float2(a, b);
}
__device__ __forceinline__ void put2(bf16* d, float a, float b) {
  *reinterpret_cast<uint32_t*>(d) = pack2(a, b);
}

// Four floats (a 16-byte global load) or four bf16 (8 bytes) as float
// pairs, zero where !ok.
__device__ __forceinline__ void load4(const float* p, bool ok, float2& a,
                                      float2& b) {
  const float4 x = ok ? *reinterpret_cast<const float4*>(p)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  a = make_float2(x.x, x.y);
  b = make_float2(x.z, x.w);
}
__device__ __forceinline__ void load4(const bf16* p, bool ok, float2& a,
                                      float2& b) {
  const uint2 x = ok ? *reinterpret_cast<const uint2*>(p) : make_uint2(0, 0);
  a = unpack2(x.x);
  b = unpack2(x.y);
}

// Four values of a row (lo, hi) into the NP bf16 planes at dst, `plane`
// elements apart: bf16 as is, float32 split into hi + mid + lo.
template <int NP>
__device__ __forceinline__ void put_pieces(bf16* dst, int plane, float2 lo,
                                           float2 hi) {
  if constexpr (NP == 1) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack2(lo.x, lo.y), pack2(hi.x, hi.y));
  } else {
    uint32_t h0, m0, l0, h1, m1, l1;
    split3(lo.x, lo.y, h0, m0, l0);
    split3(hi.x, hi.y, h1, m1, l1);
    *reinterpret_cast<uint2*>(dst) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(dst + plane) = make_uint2(m0, m1);
    *reinterpret_cast<uint2*>(dst + 2 * plane) = make_uint2(l0, l1);
  }
}

// X = A B^T of one warp: its 16 kept rows (A, rows of the kept planes at
// `fa`, the lane's ldmatrix address) against the STREAM streamed rows (B,
// the streamed planes at `sb`), over the head dim in k16 steps.
template <int HD, int NP>
__device__ __forceinline__ void score_tile(float (&xa)[NS][4], uint32_t fa,
                                           uint32_t sb) {
  using L = Smem<HD, NP>;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) xa[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    FragP<NP> af, bf[NS / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      ldsm4(af.p[p], fa + 2 * (p * L::FPLANE + ks * 16));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j)
        ldsm4(bf[j].p[p], sb + 2 * (p * L::SPLANE + j * 16 * L::LDP + ks * 16));
    }
#pragma unroll
    for (int kk = 0; kk < PRODUCTS<NP>; ++kk)
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        mma_p<NP>(kk, xa[2 * j], af, bf[j], 0, 1);
        mma_p<NP>(kk, xa[2 * j + 1], af, bf[j], 2, 3);
      }
  }
}

// acc += X B of one warp: X (16 x STREAM, its C fragments in registers) as
// the A operand, B the streamed rows (k) by the head dim (n), read through
// ldmatrix.trans from the streamed planes at `sb`.
template <int HD, int NP>
__device__ __forceinline__ void acc_tile(float (&acc)[HD / 8][4],
                                         const float (&xa)[NS][4],
                                         uint32_t sb) {
  using L = Smem<HD, NP>;
  constexpr int NJ = HD / 16;      // n16 column pairs of the accumulator
#pragma unroll
  for (int s = 0; s < STREAM / 16; ++s) {
    FragP<NP> pa;
    to_pieces<NP>(xa[2 * s][0], xa[2 * s][1], pa, 0);
    to_pieces<NP>(xa[2 * s][2], xa[2 * s][3], pa, 1);
    to_pieces<NP>(xa[2 * s + 1][0], xa[2 * s + 1][1], pa, 2);
    to_pieces<NP>(xa[2 * s + 1][2], xa[2 * s + 1][3], pa, 3);
    const uint32_t rows = sb + 2 * s * 16 * L::LDP;
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += 2) {
      FragP<NP> bf[2];
#pragma unroll
      for (int i = 0; i < 2 && j0 + i < NJ; ++i)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          ldsm4t(bf[i].p[p], rows + 2 * (p * L::SPLANE + (j0 + i) * 16));
#pragma unroll
      for (int kk = 0; kk < PRODUCTS<NP>; ++kk)
#pragma unroll
        for (int i = 0; i < 2 && j0 + i < NJ; ++i) {
          mma_p<NP>(kk, acc[2 * (j0 + i)], pa, bf[i], 0, 1);
          mma_p<NP>(kk, acc[2 * (j0 + i) + 1], pa, bf[i], 2, 3);
        }
    }
  }
}

// The dK/dV kernel (DKDV) and the dQ kernel: one CTA keeps FIXED rows of
// two tensors (K, V or Q, dO) and streams the other two (Q, dO or K, V).
// Per step a warp forms X1 = A1 B1^T and X2 = A2 B2^T over its 16 kept
// rows and the STREAM streamed ones (S^T and dP^T, or S and dP), P and dS
// from them in registers, then acc1 += dS B1 (dK += dS^T Q, or
// dQ += dS K) and, for dK/dV, acc2 += P B2 (dV += P^T dO).
template <int HD, typename E, bool DKDV>
__device__ __forceinline__ void bwd_tile(const Args<E>& a, int n_tiles) {
  constexpr int NP = Pieces<E>::N;
  using L = Smem<HD, NP>;
  constexpr int LDP = L::LDP;
  constexpr int NH = HD / 8;       // n8 tiles of an accumulator
  constexpr int NACC = DKDV ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* fplanes = reinterpret_cast<bf16*>(smem + L::oF);
  bf16* splanes = reinterpret_cast<bf16*>(smem + L::oS);
  float* stage = reinterpret_cast<float*>(smem + L::oStage);
  float* vec = reinterpret_cast<float*>(smem + L::oVec);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const flash_bwd::Tile tl = flash_bwd::tile_of(
      blockIdx.x, n_tiles, a.H, a.B, !DKDV && a.causal);
  const int h = tl.head, b = tl.batch, G = a.H / a.KV, kvh = h / G;
  const int S = a.S, T = a.T;
  const bool causal = a.causal != 0;
  const int f0 = tl.tile * FIXED;

  const int64_t qrow = (int64_t)a.H * HD, krow = (int64_t)a.KV * HD;
  const E* qb = a.q + (int64_t)b * S * qrow + (int64_t)h * HD;
  const E* ob = a.dout + (int64_t)b * S * qrow + (int64_t)h * HD;
  const E* kb = a.k + (int64_t)b * T * krow + (int64_t)kvh * HD;
  const E* vb = a.v + (int64_t)b * T * krow + (int64_t)kvh * HD;
  const float* lse_b = a.lse + ((int64_t)b * a.H + h) * S;
  const float* dsum_b = a.dsum + ((int64_t)b * a.H + h) * S;
  const E* fx0 = DKDV ? kb : qb;
  const E* fx1 = DKDV ? vb : ob;
  const E* sx0 = DKDV ? qb : kb;
  const E* sx1 = DKDV ? ob : vb;
  const int64_t fstride = DKDV ? krow : qrow, sstride = DKDV ? qrow : krow;
  const int frows = DKDV ? T : S, srows = DKDV ? S : T;
  const int s_begin = DKDV ? flash_bwd::first_query(f0, S, T, causal) : 0;
  const int s_end = DKDV ? S : flash_bwd::key_end(f0, S, T, causal);
  const int n_steps = (s_end - s_begin + STREAM - 1) / STREAM;

  // ---- the streamed tile of step st: cp.async, zeros past srows ---------
  auto issue = [&](int st) {
    const int r0 = s_begin + st * STREAM;
    constexpr int CH = HD * (int)sizeof(E) / 16;   // 16-byte chunks a row
    constexpr int EL = 16 / (int)sizeof(E);
    bf16* dst_planes = splanes + (size_t)(st & (L::SBUF - 1)) * 2 * NP *
                                     L::SPLANE;
    for (int i = tid; i < 2 * STREAM * CH; i += THREADS) {
      const int x = i / (STREAM * CH), rem = i % (STREAM * CH);
      const int r = rem / CH, c = rem % CH, row = r0 + r;
      const bool ok = row < srows;
      const E* src = (x ? sx1 : sx0) + (int64_t)(ok ? row : 0) * sstride
                     + c * EL;
      void* dst;
      if constexpr (NP == 1)
        dst = dst_planes + (size_t)x * L::SPLANE + r * LDP + c * EL;
      else
        dst = stage + (x * STREAM + r) * HD + c * EL;
      cp16(dst, src, ok);
    }
    if (DKDV && tid < 2 * STREAM) {       // lse and D of the tile's queries
      const int x = tid / STREAM, r = tid % STREAM, row = r0 + r;
      cp4(vec + ((st & 1) * 2 + x) * STREAM + r,
          (x ? dsum_b : lse_b) + (row < S ? row : 0), row < S);
    }
  };
  issue(0);
  cp_commit();

  // ---- the kept rows: loaded once into their planes (split for float32) --
  for (int i = tid; i < 2 * FIXED * (HD / 4); i += THREADS) {
    const int x = i / (FIXED * (HD / 4)), rem = i % (FIXED * (HD / 4));
    const int r = rem / (HD / 4), c = (rem % (HD / 4)) * 4, row = f0 + r;
    const bool ok = row < frows;
    float2 lo, hi;
    load4((x ? fx1 : fx0) + (int64_t)(ok ? row : 0) * fstride + c, ok, lo,
          hi);
    put_pieces<NP>(fplanes + (size_t)x * NP * L::FPLANE + r * LDP + c,
                   L::FPLANE, lo, hi);
  }
  // dQ: lse and D of this thread's two kept rows (queries)
  const int wrow0 = f0 + warp * WROWS;
  float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};
  if (!DKDV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow0 + g + 8 * r;
      if (row < S) {
        lse_r[r] = lse_b[row];
        d_r[r] = dsum_b[row];
      }
    }
  }

  // ldmatrix lane addresses (tile lt = lane / 8, row lr = lane % 8), as
  // byte offsets within a plane:
  //   A of a k16 step, non-trans: (rows 0-7, k 0-7), (8-15, 0-7),
  //     (0-7, 8-15), (8-15, 8-15);
  //   B of X = A B^T (rows n, cols k), non-trans: (n 0-7, k 0-7),
  //     (0-7, 8-15), (8-15, 0-7), (8-15, 8-15): b0, b1 of n8 tiles 2j, 2j+1;
  //   B of acc += X B (rows k, cols n), .trans: (k 0-7, n 0-7), (8-15, 0-7),
  //     (0-7, 8-15), (8-15, 8-15): b0, b1 of n8 tiles 2j, 2j+1.
  const int lt = lane >> 3, lr = lane & 7;
  const uint32_t a_off =
      2 * ((warp * WROWS + lr + 8 * (lt & 1)) * LDP + 8 * (lt >> 1));
  const uint32_t bn_off = 2 * ((lr + 8 * (lt >> 1)) * LDP + 8 * (lt & 1));
  const uint32_t bt_off = 2 * ((lr + 8 * (lt & 1)) * LDP + 8 * (lt >> 1));
  const uint32_t f_base = smem_u32(fplanes);

  float acc[NACC][NH][4];
#pragma unroll
  for (int x = 0; x < NACC; ++x)
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][n][e] = 0.f;

  for (int st = 0; st < n_steps; ++st) {
    cp_wait<0>();
    __syncthreads();               // step st landed; step st - 1 consumed
    if constexpr (NP == 3) {       // split the float32 tile once for the CTA
      for (int i = tid; i < 2 * STREAM * (HD / 4); i += THREADS) {
        const int x = i / (STREAM * (HD / 4)), rem = i % (STREAM * (HD / 4));
        const int r = rem / (HD / 4), c = (rem % (HD / 4)) * 4;
        const float4 v = reinterpret_cast<const float4*>(stage)[i];
        put_pieces<NP>(splanes + (size_t)x * NP * L::SPLANE + r * LDP + c,
                       L::SPLANE, make_float2(v.x, v.y),
                       make_float2(v.z, v.w));
      }
      __syncthreads();             // planes of step st ready; staging free
    }
    if (st + 1 < n_steps) issue(st + 1);
    cp_commit();

    const int r0 = s_begin + st * STREAM;
    // skip a step with no live pair for this warp's rows
    {
      bool any;
      if (DKDV) {
        const int q_last = min(r0 + STREAM, S) - 1;
        any = wrow0 < T && (!causal || wrow0 <= q_last + T - S);
      } else {
        const int q_last = min(wrow0 + WROWS, S) - 1;
        any = wrow0 < S && (!causal || r0 <= q_last + T - S);
      }
      if (!any) continue;
    }
    const uint32_t s_base =
        smem_u32(splanes) +
        2 * (uint32_t)((st & (L::SBUF - 1)) * 2 * NP * L::SPLANE);

    // ---- X1 = A1 B1^T, X2 = A2 B2^T over the head dim ------------------
    float x1[NS][4], x2[NS][4];
    score_tile<HD, NP>(x1, f_base + a_off, s_base + bn_off);
    score_tile<HD, NP>(x2, f_base + 2 * NP * L::FPLANE + a_off,
                       s_base + 2 * NP * L::SPLANE + bn_off);

    // ---- P and dS in registers ------------------------------------------
    const float* vlse = vec + (st & 1) * 2 * STREAM;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int fr = wrow0 + g + 8 * (e >> 1);
        const int sc = 8 * n + 2 * t4 + (e & 1);
        const int qi = DKDV ? r0 + sc : fr, kj = DKDV ? fr : r0 + sc;
        const float lse = DKDV ? vlse[sc] : lse_r[e >> 1];
        const float dd = DKDV ? vlse[STREAM + sc] : d_r[e >> 1];
        float u = x1[n][e] * a.scale, dcap = 1.f;
        if (a.softcap > 0.f) {
          const float t = tanhf(u / a.softcap);
          u = a.softcap * t;
          dcap = 1.f - t * t;
        }
        const float p = flash_bwd::live(qi, kj, S, T, causal)
                            ? expf(u - lse) : 0.f;
        x1[n][e] = p;
        x2[n][e] = p * (x2[n][e] - dd) * dcap * a.scale;
      }

    // ---- acc1 += dS B1, acc2 += P B2 over the step's streamed rows -----
    acc_tile<HD, NP>(acc[0], x2, s_base + bt_off);
    if constexpr (DKDV)
      acc_tile<HD, NP>(acc[NACC - 1], x1, s_base + 2 * NP * L::SPLANE + bt_off);
  }

  // ---- epilogue: this warp's 16 rows ----------------------------------
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow0 + g + 8 * r;
    if (row >= frows) continue;
#pragma unroll
    for (int x = 0; x < NACC; ++x) {
      if (!DKDV) {
        E* out = a.dq + ((int64_t)b * S + row) * qrow + (int64_t)h * HD;
#pragma unroll
        for (int n = 0; n < NH; ++n)
          put2(out + 8 * n + 2 * t4, acc[x][n][2 * r], acc[x][n][2 * r + 1]);
      } else if (a.part != nullptr) {
        const int64_t n_el = (int64_t)a.B * T * krow;
        float* out = a.part + (int64_t)(x * G + h % G) * n_el
                     + ((int64_t)b * T + row) * krow + (int64_t)kvh * HD;
#pragma unroll
        for (int n = 0; n < NH; ++n)
          put2(out + 8 * n + 2 * t4, acc[x][n][2 * r], acc[x][n][2 * r + 1]);
      } else {
        E* out = (x ? a.dv : a.dk) + ((int64_t)b * T + row) * krow
                 + (int64_t)kvh * HD;
#pragma unroll
        for (int n = 0; n < NH; ++n)
          put2(out + 8 * n + 2 * t4, acc[x][n][2 * r], acc[x][n][2 * r + 1]);
      }
    }
  }
}

// bf16: 2 CTAs an SM (registers); float32: 1 (shared memory)
template <int HD, typename E>
__global__ void __launch_bounds__(THREADS, Pieces<E>::N == 1 ? 2 : 1)
flash_bwd_dkdv_kernel(Args<E> a, int n_tiles) {
  bwd_tile<HD, E, true>(a, n_tiles);
}

template <int HD, typename E>
__global__ void __launch_bounds__(THREADS, Pieces<E>::N == 1 ? 2 : 1)
flash_bwd_dq_kernel(Args<E> a, int n_tiles) {
  bwd_tile<HD, E, false>(a, n_tiles);
}

template <int HD, typename E>
__global__ void __launch_bounds__(256)
flash_bwd_dsum_kernel(Args<E> a) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)a.B * a.S * a.H) return;
  const E* o = a.o + row * HD;
  const E* d = a.dout + row * HD;
  float s = 0.f;
  for (int c = lane; c < HD; c += 32) s = fmaf(to_f(o[c]), to_f(d[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) {
    const int h = (int)(row % a.H);
    const int64_t bs = row / a.H;
    a.dsum[((bs / a.S) * a.H + h) * a.S + bs % a.S] = s;
  }
}

struct Add4 {
  __host__ __device__ float4 operator()(float4 x, float4 y) const {
    return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  }
};

// dK (x 0) and dV (x 1) as the sum of their G float32 partials, head order;
// four elements a thread.
template <typename E>
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part, E* dk, E* dv, int64_t n4,
                     int G) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n4) return;
  const int x = (int)(i / n4);
  const int64_t e = i % n4;
  const float4 s = flash_bwd::head_sum(
      reinterpret_cast<const float4*>(part) + x * G * n4, e, n4, G, Add4{});
  E* out = (x ? dv : dk) + 4 * e;
  put2(out, s.x, s.y);
  put2(out + 2, s.z, s.w);
}

template <int HD, typename E, bool DKDV>
cudaError_t opt_in() {
  auto kernel =
      DKDV ? flash_bwd_dkdv_kernel<HD, E> : flash_bwd_dq_kernel<HD, E>;
  static bool done[64] = {};         // per device, once per process
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Smem<HD, Pieces<E>::N>::bytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <int HD, typename E>
cudaError_t launch(const Args<E>& a, cudaStream_t st) {
  constexpr size_t smem = Smem<HD, Pieces<E>::N>::bytes;
  cudaError_t e = opt_in<HD, E, true>();
  if (e == cudaSuccess) e = opt_in<HD, E, false>();
  if (e != cudaSuccess) return e;
  const int64_t rows = (int64_t)a.B * a.S * a.H;
  const int64_t kt = (a.T + FIXED - 1) / FIXED, qt = (a.S + FIXED - 1) / FIXED;
  const int64_t hb = (int64_t)a.H * a.B;
  const int64_t n4 = (int64_t)a.B * a.T * a.KV * HD / 4;
  if ((rows + 7) / 8 > 0x7fffffff || kt * hb > 0x7fffffff
      || qt * hb > 0x7fffffff || (2 * n4 + 255) / 256 > 0x7fffffff)
    return cudaErrorInvalidConfiguration;
  flash_bwd_dsum_kernel<HD, E><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<HD, E>
      <<<(unsigned)(kt * hb), THREADS, smem, st>>>(a, (int)kt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (a.part != nullptr) {
    flash_bwd_sum_kernel<E><<<(unsigned)((2 * n4 + 255) / 256), 256, 0, st>>>(
        a.part, a.dk, a.dv, n4, a.H / a.KV);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  flash_bwd_dq_kernel<HD, E>
      <<<(unsigned)(qt * hb), THREADS, smem, st>>>(a, (int)qt);
  return cudaGetLastError();
}

template <int HD, typename E>
cudaError_t occupancy(int which, int* per_sm) {
  constexpr size_t smem = Smem<HD, Pieces<E>::N>::bytes;
  cudaError_t e = opt_in<HD, E, true>();
  if (e == cudaSuccess) e = opt_in<HD, E, false>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm,
      which == 0 ? flash_bwd_dkdv_kernel<HD, E> : flash_bwd_dq_kernel<HD, E>,
      THREADS, smem);
}

// Launch the instance for head dim hd, or (per_sm != null) report the
// resident CTAs per SM of its dK/dV (which 0) or dQ (which 1) kernel.
template <typename E>
cudaError_t dispatch(const Args<E>& a, int hd, cudaStream_t st, int which,
                     int* per_sm) {
  switch (hd) {
#define FB_CASE(D)                                                   \
  case D:                                                            \
    return per_sm ? occupancy<D, E>(which, per_sm) : launch<D, E>(a, st);
    FB_CASE(16)
    FB_CASE(32)
    FB_CASE(64)
    FB_CASE(80)
    FB_CASE(128)
#undef FB_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename E>
Args<E> args(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* dsum, void* dq,
             void* dk, void* dv, void* part, int B, int S, int T, int H,
             int KV, int causal, float softcap, float scale) {
  return Args<E>{static_cast<const E*>(q),    static_cast<const E*>(k),
                 static_cast<const E*>(v),    static_cast<const E*>(o),
                 static_cast<const E*>(dout), static_cast<const float*>(lse),
                 static_cast<float*>(dsum),   static_cast<E*>(dq),
                 static_cast<E*>(dk),         static_cast<E*>(dv),
                 static_cast<float*>(part),   B, S, T, H, KV, causal,
                 softcap, scale};
}

}  // namespace

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, T, KV, hd), all of one
// type (dtype 0 float32, 1 bfloat16), contiguous; lse: float32 (B, H, S)
// from the forward; dsum: float32 (B, H, S) scratch; part: float32
// (2, H / KV, B, T, KV, hd) scratch where H / KV > 1, else null.  Three
// launches on `stream` (four with part); returns cudaGetLastError() after
// them, or the first error.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, void* part, int B, int S, int T, int H, int KV, int hd,
    int causal, float softcap, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if ((H / KV > 1) != (part != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch(args<float>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                                     part, B, S, T, H, KV, causal, softcap,
                                     scale),
                         hd, st, 0, nullptr);
  if (dtype == 1)
    return (int)dispatch(args<bf16>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                                    part, B, S, T, H, KV, causal, softcap,
                                    scale),
                         hd, st, 0, nullptr);
  return (int)cudaErrorInvalidValue;
}

// CTAs of the dK/dV (which 0) or dQ (which 1) kernel at head dim hd and
// dtype (0 float32, 1 bfloat16) resident on one SM, or -1 where there is no
// such instance.
extern "C" int flash_attention_bwd_blocks_per_sm(int hd, int dtype,
                                                 int which) {
  int per_sm = -1;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0)
    e = dispatch(Args<float>{}, hd, nullptr, which, &per_sm);
  else if (dtype == 1)
    e = dispatch(Args<bf16>{}, hd, nullptr, which, &per_sm);
  return e == cudaSuccess ? per_sm : -1;
}
