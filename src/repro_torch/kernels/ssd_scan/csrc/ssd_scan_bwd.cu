// Mamba2 SSD (state-space dual) chunked scan, backward.
//
// Replaces no Pallas kernel: the JAX package trains the Mamba2 layer
// through XLA's autodiff of ssd_reference (src/repro/kernels/ssd_scan/
// ref.py:39, called from src/repro/models/mamba2.py).  This is the gradient
// of what ssd_scan.cu's forward computes, for ops.SSD's backward: from x
// (b, l, h, p) and dy (b, l, h, p) in the model's type, dt (b, l, h) and A
// (h,) float32, B/C (b, l, g, n) in the model's type (rows may be strided
// views of one projection), an optional float32 initial state and dstate
// (b, h, p, n), it writes dx (model's type), ddt and dA (float32), dB and dC
// (model's type, summed over the heads of a group) and dinit (float32).
//
// Per (b, h) and chunk of CS = 128 positions, a_i = A dt_i, cum_i its sum
// over the chunk up to i, E = cum_{CS-1}, u_j = x_j dt_j, G_ij = C_i . B_j;
// S0 enters the chunk and S1 leaves it:
//   y_i = sum_{j<=i} G_ij e^{cum_i - cum_j} u_j + e^{cum_i} S0 C_i
//   S1  = e^E S0 + sum_j e^{E - cum_j} u_j B_j^T
// With dS1 the gradient of S1 (the next chunk's dS0, or dstate):
//   M_ij  = G_ij e^{cum_i - cum_j} (i >= j), Wd_ij = (dy_i . u_j) e^{..}
//   du_j  = sum_i M_ij dy_i + e^{E - cum_j} dS1 B_j          dx = du dt
//   dC_i  = sum_j Wd_ij B_j + e^{cum_i} S0^T dy_i
//   dB_j  = sum_i Wd_ij C_i + e^{E - cum_j} dS1^T u_j
//   dS0   = e^E dS1 + sum_i e^{cum_i} dy_i C_i^T              (dinit: chunk 0)
//   dcum_k = sum_j Q_kj - sum_i Q_ik + R_k, Q = M o W,
//           R_k = e^{cum_k} dy_k . (S0 C_k), and e^E <dS1, S0> on
//           dcum_{CS-1} (through E)
//   da_k = sum_{i>=k} dcum_i + sum_{j<k} T_j,
//           T_j = e^{E - cum_j} u_j . dS1 B_j (through E - cum_j)
//   ddt = A da + sum_p du x; dA = sum dt da.
// Exponents are only ever taken of differences (cum_i - cum_j, E - cum_j)
// and of cum_i <= 0, as in the forward.  A position at or past l acts as
// dt = 0, x = 0 (and dy = 0); its gradients are not written.
//
// What bounds it on an H100: at mamba2-1.3b's training shape (B 8, L 128,
// H 64, P 64, G 1, N 128) the gradient is 7.56 GFLOP (the causal half of
// the chunk squares, C B^T once per (b, group)) against 26.7 MB of inputs
// and outputs: bytes in bf16 (0.0080 ms at 3.35 TB/s), operations in
// float32 (six bf16 piece products a product: 0.0459 ms at 989 TFLOP/s).
// The products are small (16 x 16 tiles, k 64-128), so what the design
// must avoid is what made the earlier FMA kernel 180x its bound: products on
// the FMA pipes, full squares, G recomputed per head-dim slice, a chunk
// square in shared memory and 268 MB of slice partials.
//
// Design.  Every product runs on the tensor cores (mma.sync m16n8k16, bf16
// in, float32 accumulators; not wgmma: a warp's 16-row score tile stays in
// registers, is scaled there in float32 and becomes the next product's A
// fragment, as in ssd_scan.cu and flash_attention_bwd.cu).  Three launches:
//   1. ssd_bwd_walk_kernel (only with more than one chunk or an initial
//      state): one CTA per (head, batch row, direction).  Forward, the
//      entering state of each chunk, S <- e^E S + (x o dt o e^{E-cum})^T B;
//      in reverse, the state gradient leaving each chunk,
//      dS <- e^E dS + (dy o e^{cum})^T C, and dinit after chunk 0.  The
//      P x N state lives in float32 accumulators (4 warps, a quarter of
//      the columns each); the next chunk's rows are in flight by cp.async
//      during the current one's product.  Written to float32 scratch
//      (b, h, nc - 1, p, n) each.
//   2. ssd_bwd_chunk_kernel: one CTA per (chunk, head, batch row), all P
//      columns of the head, so W = dy u^T is whole and no sum runs over
//      head-dim slices.  B, C, x and dy of the chunk are staged once by
//      cp.async (16-byte pieces of the strided rows); no chunk square is
//      ever written to shared memory.  Causal 16 x 16 tile pairs only
//      (36 of 64 in a full chunk; a ragged chunk's valid tiles), taken
//      twice (ssd_bwd_sched.cuh):
//        key-major: a warp owns 16 rows j and visits i-tiles i >= j,
//          recomputing G^T = B C^T and W^T = x dy^T dt_j in registers,
//          forming M^T, Wd^T and Q there, and accumulating du += M^T dy,
//          dB += Wd^T C, the row sums of Q^T (sum_i Q_ij) and, per tile, its
//          column sums (sum_j Q_ij, added in tile order afterwards);
//        query-major: a warp owns rows i, recomputes W = dy x^T dt_j over
//          j-tiles j <= i and accumulates dC += Wd B.
//      The state terms start the accumulators and are skipped where their
//      state is zero (no dstate on the last chunk, no initial state on the
//      first: training's one chunk of 128 runs none): e^{E-cum} dS1 B of
//      du (and T), e^{E-cum} dt dS1^T x of dB, e^{cum} S0^T dy of dC (and
//      R), e^E <dS1, S0>; the states are read straight from their float32
//      scratch.  One warp then forms dcum, its reverse prefix sum da, ddt
//      and the chunk's dA partial.  dcum's sums of Q come from the float32
//      products, never from rounded operands (dA cancels).
//   3. ssd_bwd_sum_kernel: dB and dC as the sums of the heads' float32
//      partials (2, h, b, l, n) over each group in head order, dA over
//      (chunk, batch row): fixed orders, no atomics, so two calls give the
//      same bits.
// Precision.  bf16 (design mma): x, dy, B and C exact as operands; the
// float32 factors M^T, Wd^T and Wd rounded to bf16 in registers (as the
// attention backward rounds P and dS: tests/test_torch_ssd_bwd_design.py
// puts every gradient within 7.2e-3 of its scale of the plain version, hi +
// lo factors within 6.0e-3, against BWD_TOL 2e-2); the float32 states and
// the walks' scaled operands split hi + lo.  float32 (design mma3): every
// operand, factors and states included, in three bf16 pieces hi + mid + lo
// and six piece products a k16 step, smallest first (mma3.cuh): as close to
// a float64 gradient as the plain float32 version; TF32 would not be.
// Shapes (p, n) in {(64, 128), (64, 64), (16, 16)}, chunk 128.  bf16: 4
// warps, each taking both passes; at N 128 114,752 bytes of shared memory
// (2 CTAs an SM); float32: staged as float32 (pieces cut while fragments
// are built), 221,248 bytes, 1 CTA an SM, 8 warps (4 a pass).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma3.cuh"  // mma, the bf16 pieces, cp.async, ldmatrix
#include "ssd_bwd_sched.cuh"

namespace {

using ssd_bwd::CS;
using ssd_bwd::PASS_WARPS;
using ssd_bwd::TILE;
constexpr unsigned FULL = 0xffffffffu;

// bf16 pieces of each kind of operand, warps and occupancy, by design:
// OP for x, dy, B and C as stored, FAC for the float32 factors formed in
// registers (M, Wd), ST for the float32 states and the walks' scaled rows.
template <typename E>
struct Design;
template <>
struct Design<bf16> {
  static constexpr int OP = 1, FAC = 1, ST = 2;
  static constexpr int THREADS = 128, BLOCKS = 2;   // both passes a warp
};
template <>
struct Design<float> {
  static constexpr int OP = 3, FAC = 3, ST = 3;
  static constexpr int THREADS = 256, BLOCKS = 1;   // a pass a warp group
};
constexpr int WALK_THREADS = 128;

// An m16k16 A operand, or the B operands of two n8 tiles (words tile 0 b0,
// b1, tile 1 b0, b1), in NP bf16 pieces.
template <int NP>
struct Frag {
  uint32_t p[NP][4];
};

// (v0, v1) -> bf16 pairs hi and lo with hi + lo = v to ~2^-17 relative.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2(v0, v1);
  const float2 f = unpack2(hi);
  lo = pack2(v0 - f.x, v1 - f.y);
}

// (v0, v1) into word r of every piece of f.
template <int NP>
__device__ __forceinline__ void put(Frag<NP>& f, int r, float v0, float v1) {
  if constexpr (NP == 1)
    f.p[0][r] = pack2(v0, v1);
  else if constexpr (NP == 2)
    split2(v0, v1, f.p[0][r], f.p[1][r]);
  else
    split3(v0, v1, f.p[0][r], f.p[1][r], f.p[2][r]);
}

// d0 += a b (tile 0), d1 += a b (tile 1): the piece products that reach
// the result's rounding, smallest first (pieces.order of the CPU model).
template <int NA, int NB>
__device__ __forceinline__ void mma_pair(float (&d0)[4], float (&d1)[4],
                                         const Frag<NA>& a,
                                         const Frag<NB>& b) {
#define MP(i, j)                                  \
  mma(d0, a.p[i], b.p[j][0], b.p[j][1]);          \
  mma(d1, a.p[i], b.p[j][2], b.p[j][3]);
  if constexpr (NA == 1 && NB == 1) {
    MP(0, 0)
  } else if constexpr (NA == 1 && NB == 2) {
    MP(0, 1) MP(0, 0)
  } else if constexpr (NA == 2 && NB == 1) {
    MP(1, 0) MP(0, 0)
  } else {
    static_assert(NA == 3 && NB == 3, "three pieces against three");
    MP(2, 0) MP(0, 2) MP(1, 1) MP(1, 0) MP(0, 1) MP(0, 0)
  }
#undef MP
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return unpack2(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2(a, b);
}

// ---- fragment loaders ------------------------------------------------------
// s: a row-major array with row stride ld (shared memory, or a float32
// state in device memory).  bf16 arrays go through ldmatrix; float32 ones
// are read as floats and cut into NP pieces.

// A: rows r0 .. r0 + 15, k16 at k0, of an [m][k] array.
__device__ __forceinline__ void a_rows(Frag<1>& f, const bf16* s, int ld,
                                       int r0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm4(f.p[0], s + (r0 + (lane & 15)) * ld + k0 + 8 * (lane >> 4));
}
template <int NP>
__device__ __forceinline__ void a_rows(Frag<NP>& f, const float* s, int ld,
                                       int r0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = s + (r0 + g) * ld + k0 + 2 * t;
  float2 v = ld2(p);
  put<NP>(f, 0, v.x, v.y);
  v = ld2(p + 8 * ld);
  put<NP>(f, 1, v.x, v.y);
  v = ld2(p + 8);
  put<NP>(f, 2, v.x, v.y);
  v = ld2(p + 8 * ld + 8);
  put<NP>(f, 3, v.x, v.y);
}

// B of two n8 tiles n0 .. n0 + 15, k16 at k0, of an [n][k] array.
__device__ __forceinline__ void b_rows(Frag<1>& f, const bf16* s, int ld,
                                       int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm4(f.p[0], s + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0
                    + 8 * ((lane >> 3) & 1));
}
template <int NP>
__device__ __forceinline__ void b_rows(Frag<NP>& f, const float* s, int ld,
                                       int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = s + (n0 + g) * ld + k0 + 2 * t;
  float2 v = ld2(p);
  put<NP>(f, 0, v.x, v.y);
  v = ld2(p + 8);
  put<NP>(f, 1, v.x, v.y);
  v = ld2(p + 8 * ld);
  put<NP>(f, 2, v.x, v.y);
  v = ld2(p + 8 * ld + 8);
  put<NP>(f, 3, v.x, v.y);
}

// B of two n8 tiles n0 .. n0 + 15, k16 at k0, of a [k][n] array.
__device__ __forceinline__ void b_cols(Frag<1>& f, const bf16* s, int ld,
                                       int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm4t(f.p[0], s + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0
                     + 8 * (lane >> 4));
}
template <int NP>
__device__ __forceinline__ void b_cols(Frag<NP>& f, const float* s, int ld,
                                       int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    put<NP>(f, 2 * q, p[8 * q], p[ld + 8 * q]);
    put<NP>(f, 2 * q + 1, p[8 * ld + 8 * q], p[9 * ld + 8 * q]);
  }
}

// A: rows m0 .. m0 + 15 of the transpose of a [k][m] array, k16 at k0,
// each column k scaled by fac[k]; float32 products, so NP pieces.
template <int NP>
__device__ __forceinline__ void a_cols_scaled(Frag<NP>& f, const bf16* s,
                                              int ld, int k0, int m0,
                                              const float* fac) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  uint32_t r[4];
  ldsm4t(r, s + (k0 + (lane & 7) + 8 * (lane >> 4)) * ld + m0
                + 8 * ((lane >> 3) & 1));
  const float w0 = fac[k0 + 2 * t], w1 = fac[k0 + 2 * t + 1];
  const float w8 = fac[k0 + 2 * t + 8], w9 = fac[k0 + 2 * t + 9];
  float2 v = unpack2(r[0]);                 // (m g, k 2t .. 2t + 1)
  put<NP>(f, 0, v.x * w0, v.y * w1);
  v = unpack2(r[1]);                        // (m g + 8, k 2t ..)
  put<NP>(f, 1, v.x * w0, v.y * w1);
  v = unpack2(r[2]);                        // (m g, k 2t + 8 ..)
  put<NP>(f, 2, v.x * w8, v.y * w9);
  v = unpack2(r[3]);                        // (m g + 8, k 2t + 8 ..)
  put<NP>(f, 3, v.x * w8, v.y * w9);
}
template <int NP>
__device__ __forceinline__ void a_cols_scaled(Frag<NP>& f, const float* s,
                                              int ld, int k0, int m0,
                                              const float* fac) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k = k0 + 2 * t;
  const float w0 = fac[k], w1 = fac[k + 1], w8 = fac[k + 8], w9 = fac[k + 9];
  const float* p = s + k * ld + m0 + g;
  put<NP>(f, 0, p[0] * w0, p[ld] * w1);
  put<NP>(f, 1, p[8] * w0, p[ld + 8] * w1);
  put<NP>(f, 2, p[8 * ld] * w8, p[9 * ld] * w9);
  put<NP>(f, 3, p[8 * ld + 8] * w8, p[9 * ld + 8] * w9);
}

// The A fragment of a 16 x 16 tile held as two n8 accumulator tiles.
template <int NP>
__device__ __forceinline__ void acc_to_a(Frag<NP>& f, const float (&s)[2][4]) {
  put<NP>(f, 0, s[0][0], s[0][1]);
  put<NP>(f, 1, s[0][2], s[0][3]);
  put<NP>(f, 2, s[1][0], s[1][1]);
  put<NP>(f, 3, s[1][2], s[1][3]);
}

// sum over the 4 lanes of a quad (xor 1, 2: a fixed tree)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// 4 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Rows [0, rows) of a chunk starting at t0 into dst (row stride ld): W
// elements a row from src + t * stride, zero past L, by THREADS threads.
template <int W, int THREADS, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           int64_t stride, int t0, int rows,
                                           int L) {
  constexpr int EL = 16 / sizeof(T);
  constexpr int PIECES = W / EL;
  for (int i = threadIdx.x; i < rows * PIECES; i += THREADS) {
    const int r = i / PIECES, k = i % PIECES, t = t0 + r;
    cp16(dst + r * ld + k * EL,
         src + (int64_t)(t < L ? t : t0) * stride + k * EL, t < L);
  }
}

// One warp: cum, e^{cum} and e^{E - cum} of a chunk from its dt (d, zero
// past l) and a (4 positions a lane, then a shuffle scan).
__device__ __forceinline__ void chunk_cumsum(const float* d, float a,
                                             float* cum, float* ecum,
                                             float* edec) {
  const int lane = threadIdx.x & 31;
  constexpr int PER = CS / 32;
  float v[PER];
  float run = 0.f;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    run = run + d[lane * PER + u] * a;
    v[u] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl = o + incl;
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.f;
  const float tot = __shfl_sync(FULL, excl + v[PER - 1], 31);
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = lane * PER + u;
    const float ci = excl + v[u];
    cum[i] = ci;
    ecum[i] = expf(ci);
    edec[i] = expf(tot - ci);
  }
}

struct Args {
  const void *x, *dt, *A, *B, *C;
  int64_t bc_row;
  const float *init, *dstate;
  const void* dy;
  void* dx;
  float *ddt, *dinit, *states, *dstates, *part_bc, *part_a;
  int b, l, h, g;
};

// ===========================================================================
// 1. the walks
// ===========================================================================

template <typename E, int P, int N>
struct WalkSmem {
  static constexpr int LDN = N + 8, LDP = P + 8;
  static constexpr size_t oX = 0;                              // [2][CS][LDP]
  static constexpr size_t oY = oX + 2 * (size_t)CS * LDP * sizeof(E);
  static constexpr size_t oDt = oY + 2 * (size_t)CS * LDN * sizeof(E);
  // cum, e^cum, e^{E-cum} and the walk's factor: [4][CS]
  static constexpr size_t oV = oDt + 2 * (size_t)CS * 4;
  static constexpr size_t bytes = oV + 4 * (size_t)CS * 4;
  static_assert(bytes <= 232448, "shared memory of one block");
};

// CTA (h, b, dir): dir 0 walks chunks 0 .. nc - 2 forward and writes the
// state entering each next chunk; dir 1 walks nc - 1 .. 1 (.. 0 with an
// initial state) in reverse and writes the state gradient leaving each
// previous chunk (after chunk 0: dinit).  Warp w owns the state's column
// pairs w, w + 4, ... (n16 each) of all P rows.
template <typename E, int P, int N>
__global__ void __launch_bounds__(WALK_THREADS, Design<E>::BLOCKS)
ssd_bwd_walk_kernel(const Args a) {
  using S = WalkSmem<E, P, N>;
  using D = Design<E>;
  constexpr int LDN = S::LDN, LDP = S::LDP;
  constexpr int MS = P / 16;                    // m16 tiles of the rows
  constexpr int PAIRS = N / 16;                 // n16 column pairs
  constexpr int QP = (PAIRS + 3) / 4;           // pairs a warp, at most
  extern __shared__ __align__(128) unsigned char smem[];
  E* Xs = reinterpret_cast<E*>(smem + S::oX);
  E* Ys = reinterpret_cast<E*>(smem + S::oY);
  float* dts = reinterpret_cast<float*>(smem + S::oDt);
  float* cum = reinterpret_cast<float*>(smem + S::oV);
  float* ecum = cum + CS;
  float* edec = ecum + CS;
  float* fac = edec + CS;

  const int hh = blockIdx.x, bi = blockIdx.y, rev = blockIdx.z;
  const int H = a.h, L = a.l, grp = hh / (H / a.g);
  const int nc = (L + CS - 1) / CS;
  const int first = rev ? nc - 1 : 0;
  const int count = rev ? (a.init != nullptr ? nc : nc - 1) : nc - 1;
  if (count <= 0) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float Ah = static_cast<const float*>(a.A)[hh];
  const int64_t bh = (int64_t)bi * H + hh;
  const E* xsrc = static_cast<const E*>(rev ? a.dy : a.x)
                  + ((int64_t)bi * L * H + hh) * P;
  const int64_t xstride = (int64_t)H * P;
  const E* ysrc = static_cast<const E*>(rev ? a.C : a.B)
                  + (int64_t)bi * L * a.bc_row + (int64_t)grp * N;
  const float* dtrow = static_cast<const float*>(a.dt) + (int64_t)bi * L * H
                       + hh;

  float sacc[MS][QP][2][4];
  const float* s_in = rev ? a.dstate : a.init;
#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int q = 0; q < QP; ++q)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n0 = (warp + 4 * q) * 16 + nt * 8 + 2 * t4;
          float2 v = make_float2(0.f, 0.f);
          if (s_in != nullptr && warp + 4 * q < PAIRS)
            v = ld2(s_in + (bh * P + ms * 16 + g + 8 * hf) * N + n0);
          sacc[ms][q][nt][2 * hf] = v.x;
          sacc[ms][q][nt][2 * hf + 1] = v.y;
        }

  auto chunk_of = [&](int step) { return rev ? first - step : step; };
  auto stage = [&](int step) {
    const int c = chunk_of(step), buf = step & 1, t0 = c * CS;
    const int rows = TILE * ssd_bwd::valid_tiles(c, L);
    stage_rows<P, WALK_THREADS>(Xs + buf * CS * LDP, LDP, xsrc, xstride, t0,
                                rows, L);
    stage_rows<N, WALK_THREADS>(Ys + buf * CS * LDN, LDN, ysrc, a.bc_row, t0,
                                rows, L);
    const int t = t0 + tid;
    cp4(dts + buf * CS + tid, dtrow + (int64_t)(t < L ? t : 0) * H, t < L);
  };
  stage(0);
  cp_commit();
  for (int step = 0; step < count; ++step) {
    const int c = chunk_of(step), buf = step & 1;
    const int mt = ssd_bwd::valid_tiles(c, L);
    cp_wait<0>();
    __syncthreads();               // chunk c landed; the other buffer free
    if (step + 1 < count) stage(step + 1);
    cp_commit();
    if (warp == 0) {
      const float* d = dts + buf * CS;
      chunk_cumsum(d, Ah, cum, ecum, edec);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < CS / 32; ++u) {
        const int k = lane * (CS / 32) + u;
        fac[k] = rev ? ecum[k] : d[k] * edec[k];
      }
    }
    __syncthreads();
    const float eE = ecum[CS - 1];
    const E* X = Xs + buf * CS * LDP;
    const E* Y = Ys + buf * CS * LDN;
    if (warp < PAIRS) {
#pragma unroll
      for (int ms = 0; ms < MS; ++ms)
#pragma unroll
        for (int q = 0; q < QP; ++q)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[ms][q][nt][e] *= eE;
      for (int kt = 0; kt < mt; ++kt) {
        Frag<D::ST> af[MS];
#pragma unroll
        for (int ms = 0; ms < MS; ++ms)
          a_cols_scaled<D::ST>(af[ms], X, LDP, kt * 16, ms * 16, fac);
#pragma unroll
        for (int q = 0; q < QP; ++q) {
          if (warp + 4 * q >= PAIRS) break;
          Frag<D::OP> bf;
          b_cols(bf, Y, LDN, kt * 16, (warp + 4 * q) * 16);
#pragma unroll
          for (int ms = 0; ms < MS; ++ms)
            mma_pair<D::ST, D::OP>(sacc[ms][q][0], sacc[ms][q][1], af[ms],
                                   bf);
        }
      }
      float* out = !rev ? a.states + (bh * (nc - 1) + c) * P * N
                   : c > 0 ? a.dstates + (bh * (nc - 1) + c - 1) * P * N
                           : a.dinit + bh * P * N;
#pragma unroll
      for (int ms = 0; ms < MS; ++ms)
#pragma unroll
        for (int q = 0; q < QP; ++q) {
          if (warp + 4 * q >= PAIRS) break;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              st2(out + (ms * 16 + g + 8 * hf) * N + (warp + 4 * q) * 16
                      + nt * 8 + 2 * t4,
                  sacc[ms][q][nt][2 * hf], sacc[ms][q][nt][2 * hf + 1]);
        }
    }
  }
}

// ===========================================================================
// 2. the chunk kernel
// ===========================================================================

// One CTA: B, C, x and dy of the chunk, the vectors dt, cum, e^cum,
// e^{E-cum}, sum_i Q_ij, T, R, sum_p du x ([8][CS]) and the key tiles'
// partial sums of Q ([TILES][CS]).
template <typename E, int P, int N>
struct ChunkSmem {
  static constexpr int LDN = N + 8, LDP = P + 8;
  static constexpr size_t oB = 0;
  static constexpr size_t oC = oB + (size_t)CS * LDN * sizeof(E);
  static constexpr size_t oX = oC + (size_t)CS * LDN * sizeof(E);
  static constexpr size_t oDY = oX + (size_t)CS * LDP * sizeof(E);
  static constexpr size_t oV = oDY + (size_t)CS * LDP * sizeof(E);
  static constexpr size_t oQ = oV + 8 * (size_t)CS * 4;
  static constexpr size_t oR = oQ + (size_t)ssd_bwd::TILES * CS * 4;
  static constexpr size_t bytes = oR + 16 * 4;
  static_assert(bytes <= 232448, "shared memory of one block");
  static_assert(P % 16 == 0 && N % 16 == 0, "k16 steps and n16 pairs");
};

// The rows of a warp's 16 x N accumulator tile as its dB or dC partial (row
// base rows, rows at or past l skipped).
template <int N>
__device__ __forceinline__ void store_partial(float (&acc)[N / 8][4],
                                              float* rows, int r0, int t0,
                                              int L) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bool in0 = t0 + r0 + g < L, in1 = t0 + r0 + g + 8 < L;
  float* o = rows + (r0 + g) * N + 2 * t4;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    if (in0) st2(o + nt * 8, acc[nt][0], acc[nt][1]);
    if (in1) st2(o + 8 * N + nt * 8, acc[nt][2], acc[nt][3]);
  }
}

// CTA (c, h, b): chunk c of head h, batch row b, all P columns.
template <typename E, int P, int N>
__global__ void __launch_bounds__(Design<E>::THREADS, Design<E>::BLOCKS)
ssd_bwd_chunk_kernel(const Args a) {
  using S = ChunkSmem<E, P, N>;
  using D = Design<E>;
  constexpr int LDN = S::LDN, LDP = S::LDP;
  constexpr int WARPS = D::THREADS / 32;
  constexpr int THREADS = D::THREADS;
  constexpr int OP = D::OP, FAC = D::FAC, ST = D::ST;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  E* Bs = reinterpret_cast<E*>(smem + S::oB);
  E* Cs = reinterpret_cast<E*>(smem + S::oC);
  E* Xs = reinterpret_cast<E*>(smem + S::oX);
  E* Ys = reinterpret_cast<E*>(smem + S::oDY);
  float* dts = reinterpret_cast<float*>(smem + S::oV);
  float* cum = dts + CS;
  float* ecum = cum + CS;
  float* edec = ecum + CS;
  float* qcol = edec + CS;
  float* tq = qcol + CS;
  float* rq = tq + CS;
  float* xdu = rq + CS;
  float* qpart = reinterpret_cast<float*>(smem + S::oQ);
  float* red = reinterpret_cast<float*>(smem + S::oR);

  const int c = blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int H = a.h, L = a.l;
  const int grp = hh / (H / a.g);
  const int nc = (L + CS - 1) / CS, t0 = c * CS;
  const int mt = ssd_bwd::valid_tiles(c, L), vr = TILE * mt;
  const float Ah = static_cast<const float*>(a.A)[hh];
  const int64_t bh = (int64_t)bi * H + hh;
  // the states of the chunk (null: zero)
  const float* S0 =
      c > 0 ? a.states + (bh * (nc - 1) + c - 1) * P * N
      : a.init != nullptr ? a.init + bh * P * N : nullptr;
  const float* dS1 =
      c < nc - 1 ? a.dstates + (bh * (nc - 1) + c) * P * N
      : a.dstate != nullptr ? a.dstate + bh * P * N : nullptr;
  // this CTA's dB and dC partials (the head's rows of the chunk)
  float* pB = a.part_bc + (((int64_t)hh * a.b + bi) * L + t0) * N;
  float* pC = a.part_bc + (((int64_t)(H + hh) * a.b + bi) * L + t0) * N;

  // ---- stage the chunk ----------------------------------------------------
  {
    const int64_t row0 = (int64_t)bi * L;
    const int64_t boff = row0 * a.bc_row + (int64_t)grp * N;
    stage_rows<N, THREADS>(Bs, LDN, static_cast<const E*>(a.B) + boff,
                           a.bc_row, t0, vr, L);
    stage_rows<N, THREADS>(Cs, LDN, static_cast<const E*>(a.C) + boff,
                           a.bc_row, t0, vr, L);
    const int64_t xoff = (row0 * H + hh) * P;
    stage_rows<P, THREADS>(Xs, LDP, static_cast<const E*>(a.x) + xoff,
                           (int64_t)H * P, t0, vr, L);
    stage_rows<P, THREADS>(Ys, LDP, static_cast<const E*>(a.dy) + xoff,
                           (int64_t)H * P, t0, vr, L);
    cp_commit();
    const float* dtp = static_cast<const float*>(a.dt);
    for (int r = tid; r < CS; r += THREADS)
      dts[r] = t0 + r < L ? dtp[(row0 + t0 + r) * H + hh] : 0.f;
    cp_wait<0>();
  }
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, Ah, cum, ecum, edec);
  __syncthreads();
  const float eE = ecum[CS - 1];
  const int pw = warp % PASS_WARPS;
  const bool key_pass = WARPS == PASS_WARPS || warp < PASS_WARPS;
  const bool query_pass = WARPS == PASS_WARPS || warp >= PASS_WARPS;

  // ---- key-major: du, dB and the sums of Q, rows j of this warp ----------
  if (key_pass) {
#pragma unroll 1
    for (int s = 0; s < 2; ++s) {
      const int jt = ssd_bwd::warp_tile(pw, s);
      if (jt >= mt) continue;
      const int j0 = jt * TILE, jr0 = j0 + g, jr1 = jr0 + 8;
      const float cj0 = cum[jr0], cj1 = cum[jr1];
      const float dj0 = dts[jr0], dj1 = dts[jr1];
      float du[P / 8][4], db[N / 8][4];
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) du[nt][e] = 0.f;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) db[nt][e] = 0.f;
      float tp0 = 0.f, tp1 = 0.f;
      if (dS1 != nullptr) {
        // du = e^{E - cum_j} B_j dS1^T; T_j = dt_j x_j . du_j
#pragma unroll 1
        for (int kk = 0; kk < N / 16; ++kk) {
          Frag<OP> af;
          a_rows(af, Bs, LDN, j0, kk * 16);
#pragma unroll
          for (int np = 0; np < P / 16; ++np) {
            Frag<ST> bf;
            b_rows<ST>(bf, dS1, N, np * 16, kk * 16);
            mma_pair<OP, ST>(du[2 * np], du[2 * np + 1], af, bf);
          }
        }
        const float e0 = edec[jr0], e1 = edec[jr1];
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          const int col = nt * 8 + 2 * t4;
          du[nt][0] *= e0;
          du[nt][1] *= e0;
          du[nt][2] *= e1;
          du[nt][3] *= e1;
          const float2 x0 = ld2(Xs + jr0 * LDP + col);
          const float2 x1 = ld2(Xs + jr1 * LDP + col);
          tp0 += x0.x * du[nt][0] + x0.y * du[nt][1];
          tp1 += x1.x * du[nt][2] + x1.y * du[nt][3];
        }
        // dB = e^{E - cum_j} dt_j x_j dS1
#pragma unroll 1
        for (int kk = 0; kk < P / 16; ++kk) {
          Frag<OP> af;
          a_rows(af, Xs, LDP, j0, kk * 16);
#pragma unroll
          for (int nn = 0; nn < N / 16; ++nn) {
            Frag<ST> bf;
            b_cols<ST>(bf, dS1, N, kk * 16, nn * 16);
            mma_pair<OP, ST>(db[2 * nn], db[2 * nn + 1], af, bf);
          }
        }
        const float f0 = e0 * dj0, f1 = e1 * dj1;
#pragma unroll
        for (int nt = 0; nt < N / 8; ++nt) {
          db[nt][0] *= f0;
          db[nt][1] *= f0;
          db[nt][2] *= f1;
          db[nt][3] *= f1;
        }
      }
      tp0 = quad_sum(tp0);
      tp1 = quad_sum(tp1);
      if (t4 == 0) {
        tq[jr0] = dj0 * tp0;
        tq[jr1] = dj1 * tp1;
      }
      float qc0 = 0.f, qc1 = 0.f;
#pragma unroll 1
      for (int it = jt; it < mt; ++it) {
        const int i0 = it * TILE;
        float gt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float wt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {     // G^T = B_j C_i^T
          Frag<OP> af, bf;
          a_rows(af, Bs, LDN, j0, kk * 16);
          b_rows(bf, Cs, LDN, i0, kk * 16);
          mma_pair<OP, OP>(gt[0], gt[1], af, bf);
        }
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk) {     // W^T / dt_j = x_j dy_i^T
          Frag<OP> af, bf;
          a_rows(af, Xs, LDP, j0, kk * 16);
          b_rows(bf, Ys, LDP, i0, kk * 16);
          mma_pair<OP, OP>(wt[0], wt[1], af, bf);
        }
        // M^T, Wd^T and Q^T in registers; Q's sums
        float qs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = e < 2 ? jr0 : jr1;
            const int i = i0 + nt * 8 + 2 * t4 + (e & 1);
            const float w = wt[nt][e] * (e < 2 ? dj0 : dj1);
            const float l = i >= j ? expf(cum[i] - (e < 2 ? cj0 : cj1)) : 0.f;
            const float m = gt[nt][e] * l;
            const float q = m * w;
            gt[nt][e] = m;
            wt[nt][e] = w * l;
            if (e < 2) qc0 += q; else qc1 += q;
            qs[nt][e & 1] += q;
          }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float v = qs[nt][cc];
            v += __shfl_xor_sync(FULL, v, 4);
            v += __shfl_xor_sync(FULL, v, 8);
            v += __shfl_xor_sync(FULL, v, 16);
            if (g == 0) qpart[jt * CS + i0 + nt * 8 + 2 * t4 + cc] = v;
          }
        // du += M^T dy_i, dB += Wd^T C_i
        Frag<FAC> mf, wf;
        acc_to_a<FAC>(mf, gt);
        acc_to_a<FAC>(wf, wt);
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          Frag<OP> bf;
          b_cols(bf, Ys, LDP, i0, np * 16);
          mma_pair<FAC, OP>(du[2 * np], du[2 * np + 1], mf, bf);
        }
#pragma unroll
        for (int nn = 0; nn < N / 16; ++nn) {
          Frag<OP> bf;
          b_cols(bf, Cs, LDN, i0, nn * 16);
          mma_pair<FAC, OP>(db[2 * nn], db[2 * nn + 1], wf, bf);
        }
      }
      // dx = du dt, sum_p du x, sum_i Q_ij; dB's partial
      float sx0 = 0.f, sx1 = 0.f;
      const bool in0 = t0 + jr0 < L, in1 = t0 + jr1 < L;
      E* dx0 = static_cast<E*>(a.dx) + (((int64_t)bi * L + t0 + jr0) * H + hh)
               * P + 2 * t4;
      E* dx1 = dx0 + (int64_t)8 * H * P;
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        const int col = nt * 8 + 2 * t4;
        const float2 x0 = ld2(Xs + jr0 * LDP + col);
        const float2 x1 = ld2(Xs + jr1 * LDP + col);
        sx0 += du[nt][0] * x0.x + du[nt][1] * x0.y;
        sx1 += du[nt][2] * x1.x + du[nt][3] * x1.y;
        if (in0) st2(dx0 + nt * 8, du[nt][0] * dj0, du[nt][1] * dj0);
        if (in1) st2(dx1 + nt * 8, du[nt][2] * dj1, du[nt][3] * dj1);
      }
      sx0 = quad_sum(sx0);
      sx1 = quad_sum(sx1);
      qc0 = quad_sum(qc0);
      qc1 = quad_sum(qc1);
      if (t4 == 0) {
        xdu[jr0] = sx0;
        xdu[jr1] = sx1;
        qcol[jr0] = qc0;
        qcol[jr1] = qc1;
      }
      store_partial<N>(db, pB, j0, t0, L);
    }
  }

  // ---- query-major: dC and R, rows i of this warp -------------------------
  if (query_pass) {
#pragma unroll 1
    for (int s = 0; s < 2; ++s) {
      const int it = ssd_bwd::warp_tile(pw, s);
      if (it >= mt) continue;
      const int i0 = it * TILE, ir0 = i0 + g, ir1 = ir0 + 8;
      const float ci0 = cum[ir0], ci1 = cum[ir1];
      float dc[N / 8][4];
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dc[nt][e] = 0.f;
      float r0 = 0.f, r1 = 0.f;
      if (S0 != nullptr) {
        // V = dy_i S0; R_i = e^{cum_i} C_i . V_i; dC = e^{cum_i} V
#pragma unroll 1
        for (int kk = 0; kk < P / 16; ++kk) {
          Frag<OP> af;
          a_rows(af, Ys, LDP, i0, kk * 16);
#pragma unroll
          for (int nn = 0; nn < N / 16; ++nn) {
            Frag<ST> bf;
            b_cols<ST>(bf, S0, N, kk * 16, nn * 16);
            mma_pair<OP, ST>(dc[2 * nn], dc[2 * nn + 1], af, bf);
          }
        }
        const float e0 = ecum[ir0], e1 = ecum[ir1];
#pragma unroll
        for (int nt = 0; nt < N / 8; ++nt) {
          const int col = nt * 8 + 2 * t4;
          const float2 c0 = ld2(Cs + ir0 * LDN + col);
          const float2 c1 = ld2(Cs + ir1 * LDN + col);
          r0 += c0.x * dc[nt][0] + c0.y * dc[nt][1];
          r1 += c1.x * dc[nt][2] + c1.y * dc[nt][3];
          dc[nt][0] *= e0;
          dc[nt][1] *= e0;
          dc[nt][2] *= e1;
          dc[nt][3] *= e1;
        }
        r0 = e0 * quad_sum(r0);
        r1 = e1 * quad_sum(r1);
      }
      if (t4 == 0) {
        rq[ir0] = r0;
        rq[ir1] = r1;
      }
#pragma unroll 1
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TILE;
        float w[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk) {     // W / dt_j = dy_i x_j^T
          Frag<OP> af, bf;
          a_rows(af, Ys, LDP, i0, kk * 16);
          b_rows(bf, Xs, LDP, j0, kk * 16);
          mma_pair<OP, OP>(w[0], w[1], af, bf);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ir0 : ir1;
            const int j = j0 + nt * 8 + 2 * t4 + (e & 1);
            w[nt][e] = i >= j ? w[nt][e] * dts[j]
                                    * expf((e < 2 ? ci0 : ci1) - cum[j])
                              : 0.f;
          }
        Frag<FAC> wf;
        acc_to_a<FAC>(wf, w);
#pragma unroll
        for (int nn = 0; nn < N / 16; ++nn) {     // dC += Wd B_j
          Frag<OP> bf;
          b_cols(bf, Bs, LDN, j0, nn * 16);
          mma_pair<FAC, OP>(dc[2 * nn], dc[2 * nn + 1], wf, bf);
        }
      }
      store_partial<N>(dc, pC, i0, t0, L);
    }
  }

  // ---- <dS1, S0>, then dcum, da, ddt and the chunk's dA (one warp) --------
  float dot = 0.f;
  if (S0 != nullptr && dS1 != nullptr) {
    for (int e = 2 * tid; e < P * N; e += 2 * THREADS) {
      const float2 u = ld2(dS1 + e), v = ld2(S0 + e);
      dot += u.x * v.x + u.y * v.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
    if (lane == 0) red[warp] = dot;
  }
  __syncthreads();
  if (warp == 0) {
    if (S0 != nullptr && dS1 != nullptr) {
      dot = red[0];
      for (int w = 1; w < WARPS; ++w) dot += red[w];
    }
    constexpr int PER = CS / 32;
    float dc[PER], tp[PER];
    float trun = 0.f;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int k = lane * PER + u;
      float v = 0.f, tv = 0.f;
      if (k < vr) {
        float rowq = qpart[k];              // sum_j Q_kj, key tiles in order
        for (int jt = 1; jt <= k / TILE; ++jt) rowq += qpart[jt * CS + k];
        v = rowq - qcol[k] + rq[k];
        tv = tq[k];
      }
      dc[u] = v;
      tp[u] = trun;                         // T over the lane's positions < k
      trun += tv;
    }
    if (lane == 31) dc[PER - 1] += eE * dot;
    // T_j reaches a_k for k > j (through E - cum_j): its prefix sum over
    // the positions before k, not -T_k on dcum_k and sum T on dcum_{CS-1}
    // (those cancel in float32)
    float tincl = trun;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(FULL, tincl, off);
      if (lane >= off) tincl = o + tincl;
    }
    float tbelow = __shfl_up_sync(FULL, tincl, 1);
    if (lane == 0) tbelow = 0.f;
    // suffix sums: within the lane, then across lanes from the top
    float run = 0.f;
#pragma unroll
    for (int u = PER - 1; u >= 0; --u) {
      run += dc[u];
      dc[u] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(FULL, incl, off);
      if (lane + off < 32) incl = o + incl;
    }
    float above = __shfl_down_sync(FULL, incl, 1);
    if (lane == 31) above = 0.f;
    float da_dt = 0.f;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int k = lane * PER + u;
      const float da = (dc[u] + above) + (tp[u] + tbelow);
      const int pos = t0 + k;
      if (pos < L)
        a.ddt[((int64_t)bi * L + pos) * H + hh] = fmaf(Ah, da, xdu[k]);
      da_dt = fmaf(dts[k], da, da_dt);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) da_dt += __shfl_xor_sync(FULL, da_dt, o);
    if (lane == 0) a.part_a[((int64_t)c * a.b + bi) * H + hh] = da_dt;
  }
}

// ===========================================================================
// 3. the sums
// ===========================================================================

struct Add4 {
  __host__ __device__ float4 operator()(float4 x, float4 y) const {
    return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  }
};
struct Add1 {
  __host__ __device__ float operator()(float x, float y) const {
    return x + y;
  }
};

// blockIdx.y 0 dB, 1 dC (four elements a thread: the group's partials, one
// a head, in head order), 2 dA (over (chunk, batch row) in that order).
template <typename E>
__global__ void __launch_bounds__(256) ssd_bwd_sum_kernel(
    const float* __restrict__ part_bc, const float* __restrict__ part_a,
    E* dB, E* dC, float* dA, int b, int l, int h, int g, int n, int nc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int which = blockIdx.y;
  if (which < 2) {
    const int64_t rows = (int64_t)b * l;
    if (i >= rows * g * n / 4) return;
    const int64_t e = 4 * i;
    const int nn = (int)(e % n), gg = (int)((e / n) % g);
    const int64_t row = e / ((int64_t)g * n);
    const int per_group = h / g;
    const int64_t plane = rows * n;            // one head's partial
    const float* src = part_bc
                       + ((int64_t)which * h + (int64_t)gg * per_group)
                         * plane;
    const float4 s = ssd_bwd::ordered_sum(
        reinterpret_cast<const float4*>(src), (row * n + nn) / 4, plane / 4,
        per_group, Add4{});
    E* out = (which == 0 ? dB : dC) + e;
    st2(out, s.x, s.y);
    st2(out + 2, s.z, s.w);
  } else if (i < h) {
    dA[i] = ssd_bwd::ordered_sum(part_a, i, (int64_t)h, nc * b, Add1{});
  }
}

// ===========================================================================
// launch
// ===========================================================================

// The dynamic shared memory opt-in of a kernel, once per device.
template <typename K>
cudaError_t opt_in(K kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

// Launch the (E, P, N) instance, or (per_sm != null) report the resident
// CTAs per SM of its chunk kernel (which 0) or walk kernel (which 1).
template <typename E, int P, int N>
cudaError_t launch(const Args& q, float* dA, void* dB, void* dC,
                   cudaStream_t st, int which, int* per_sm) {
  using CSm = ChunkSmem<E, P, N>;
  using WSm = WalkSmem<E, P, N>;
  constexpr int THREADS = Design<E>::THREADS;
  auto chunk = ssd_bwd_chunk_kernel<E, P, N>;
  auto walk = ssd_bwd_walk_kernel<E, P, N>;
  static bool done_c[64] = {}, done_w[64] = {};
  cudaError_t e = opt_in(chunk, CSm::bytes, done_c);
  if (e == cudaSuccess) e = opt_in(walk, WSm::bytes, done_w);
  if (e != cudaSuccess) return e;
  if (per_sm != nullptr)
    return which == 0
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, chunk,
                                                        THREADS, CSm::bytes)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, walk,
                                                        WALK_THREADS,
                                                        WSm::bytes);
  const int nc = (q.l + CS - 1) / CS;
  if (nc > 1 || q.init != nullptr) {
    walk<<<dim3(q.h, q.b, 2), WALK_THREADS, WSm::bytes, st>>>(q);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  chunk<<<dim3(nc, q.h, q.b), THREADS, CSm::bytes, st>>>(q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t n4 = (int64_t)q.b * q.l * q.g * N / 4;
  const int64_t most = n4 > q.h ? n4 : q.h;
  ssd_bwd_sum_kernel<E><<<dim3((unsigned)((most + 255) / 256), 3), 256, 0,
                          st>>>(q.part_bc, q.part_a, static_cast<E*>(dB),
                                static_cast<E*>(dC), dA, q.b, q.l, q.h, q.g,
                                N, nc);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& q, float* dA, void* dB, void* dC, int p,
                     int n, int chunk, int dtype, cudaStream_t st, int which,
                     int* per_sm) {
  if (chunk != CS) return cudaErrorInvalidValue;
#define SB_CASE(E, P_, N_)                                           \
  if (p == P_ && n == N_)                                            \
    return launch<E, P_, N_>(q, dA, dB, dC, st, which, per_sm);
  if (dtype == 0) {
    SB_CASE(float, 64, 128)
    SB_CASE(float, 64, 64)
    SB_CASE(float, 16, 16)
  } else if (dtype == 1) {
    SB_CASE(bf16, 64, 128)
    SB_CASE(bf16, 64, 64)
    SB_CASE(bf16, 16, 16)
  }
#undef SB_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (design mma3), 1 = bfloat16 (design mma), of x, dy, B,
// C, dx, dB and dC.  init, dstate and dinit may be null (zeros; no dinit);
// dinit is given exactly when init is.  bc_row is the element stride
// between the (batch, position) rows of B and of C.  The float32 scratch:
// states and dstates (b, h, nc - 1, p, n), null when nc = 1; part_bc
// (2, h, b, l, n); part_a (nc, b, h).  Returns
// cudaGetLastError() after the launches (or the error that refused them).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, int64_t bc_row, const void* init, const void* dy,
    const void* dstate, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* dinit, void* states, void* dstates, void* part_bc, void* part_a,
    int b, int l, int h, int g, int p, int n, int chunk, int dtype,
    void* stream) {
  if (b == 0 || h == 0) return 0;
  if (g <= 0 || h % g != 0 || (init == nullptr) != (dinit == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l == 0) {                     // no positions: dA 0, dinit = dstate
    cudaMemsetAsync(dA, 0, sizeof(float) * h, st);
    if (dinit != nullptr) {
      const size_t bytes = sizeof(float) * b * h * p * n;
      if (dstate != nullptr)
        cudaMemcpyAsync(dinit, dstate, bytes, cudaMemcpyDeviceToDevice, st);
      else
        cudaMemsetAsync(dinit, 0, bytes, st);
    }
    return (int)cudaGetLastError();
  }
  const Args q{x, dt, A, B, C, bc_row,
               static_cast<const float*>(init),
               static_cast<const float*>(dstate), dy, dx,
               static_cast<float*>(ddt), static_cast<float*>(dinit),
               static_cast<float*>(states), static_cast<float*>(dstates),
               static_cast<float*>(part_bc), static_cast<float*>(part_a),
               b, l, h, g};
  return (int)dispatch(q, static_cast<float*>(dA), dB, dC, p, n, chunk, dtype,
                       st, 0, nullptr);
}

// CTAs of the (p, n, chunk, dtype) instance's chunk kernel (which 0) or
// walk kernel (which 1) resident on one SM, or -1 where none exists.
extern "C" int ssd_scan_bwd_blocks_per_sm(int p, int n, int chunk, int dtype,
                                          int which) {
  int per_sm = -1;
  if (dispatch(Args{}, nullptr, nullptr, nullptr, p, n, chunk, dtype, nullptr,
               which, &per_sm) != cudaSuccess)
    return -1;
  return per_sm;
}
