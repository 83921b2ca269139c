// Mamba2 SSD (state-space dual) chunked scan, forward, with the final state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py
// (`_ssd_kernel` / `ssd_scan`) together with its wrapper ops.ssd and the
// final state of ref.ssd_reference: x (b, l, h, p) in the model's type,
// dt (b, l, h) and A (h,) float32, B/C (b, l, g, n) in the model's type
// (rows of B and C may be strided views of one projection), an optional
// float32 initial state (b, h, p, n).  Per (b, h) and chunk of CS = 128
// positions:
//   cum   = cumsum(dt * A)                        (within the chunk)
//   L_ij  = exp(cum_i - cum_j) for i >= j, else 0
//   y     = (C B^T o L) (x dt) + exp(cum) o (C S_prev^T)
//   S     = exp(cum_end) S_prev + ((x dt) o exp(cum_end - cum))^T B
// y is rounded once to the model's type; S after the last chunk is the
// final state.  B and C are read for group h / (h_total / g), never
// repeated per head; a position at or past l acts as dt = 0, x = 0 (the
// reference's zero padding), so the final state equals the padded
// reference's and nothing is padded.  Exponents are only ever taken of
// differences (cum_i - cum_j, cum_end - cum_i).  Shapes: (head dim p, state
// n) in {(64, 128), (64, 64), (16, 16)}, chunk 128 (ops.KERNEL_SHAPES: every
// SSM config the port registers, full and smoke).
//
// What bounds it on an H100: bytes in bf16.  mamba2-1.3b's prefill of
// B 4 x L 1024 (H 64, P 64, G 1, N 128) needs 15.1 GFLOP (the causal half
// of the chunk-square products) against 78.6 MB (bf16 x and y, float32 dt
// and final state, bf16 B/C per group): 0.0235 ms at 3.35 TB/s against
// 0.015 ms at the tensor cores' 989 TFLOP/s.  In float32 the call moves
// 147.8 MB (0.044 ms) and its six bf16 products a term take 90.6 GFLOP
// (0.092 ms at 989 TFLOP/s); on the FMA pipes the 15.1 GFLOP would take
// 0.225 ms at 67 TFLOP/s.
//
// bf16: ssd_mma_kernel, the chunk products on the tensor cores.
//   * mma.sync m16n8k16 (bf16 in, float32 accumulators), not wgmma: a
//     chunk is 128 rows and a warp owns 16-row tiles, so the scores
//     C B^T of a 16 x 16 block stay in registers, are scaled there in
//     float32 and become the A operand of the next product with no trip
//     through shared memory (the accumulator layout of two n8 tiles is the
//     A-operand layout of one k16 step); wgmma's 64-row warpgroup tiles
//     would need the scores staged in shared memory, or a register layout
//     per warpgroup, for a product this small.
//   * Precision.  B, C and x are bf16 and exact as operands.  The float32
//     factors are not rounded to bf16 once (2^-8 relative: the final state
//     would miss its 3e-4): exp(cum_i) scales the rows of C S_prev^T in
//     float32 on the accumulator, and every other float32 operand is split
//     into bf16 hi + lo (v = hi + lo to ~2^-17) and multiplied twice:
//     S_prev against C; P = (C B^T) o L o dt_j against x; (x o dt o
//     exp(cum_end - cum)) against B.  The state lives in float32
//     accumulators across chunks and is scaled by exp(cum_end) there.
//   * The card filled: each (b, h) is split over p / 32 CTAs along the head
//     dim (y[:, p] and S[p, :] need only x[:, p], B, C and S_prev[p, :]);
//     each CTA recomputes its chunk's C B^T, and B and C come again from
//     L2.  4 warps a CTA; warp w owns m-tiles w and 7 - w (equal causal
//     work) for y, and a quarter of the state's columns.  Shared memory is
//     107.5 KB at n 128 (C, B, the split state in bf16, x double-buffered):
//     two CTAs per SM (ssd_scan_blocks_per_sm says so on the card).
//   * Staging by cp.async (16-byte pieces from the strided rows; ops.ssd
//     checks the 16-byte alignment): x and dt of chunk c + 1 are in flight
//     during all of chunk c, C of c + 1 during the state update, B of c + 1
//     during the next chunk's cumsum and C S_prev^T.
//   * A ragged last chunk computes only the 16-row tiles that hold rows
//     below l (tiles of y, and k-tiles of the state update); the rest of
//     those tiles is zero-filled by the copies.
// float32: ssd_mma3_kernel, the same tiles on the tensor cores with every
//   operand split into three bf16 pieces and six products a term (see its
//   section below): float32's accuracy, which TF32 (10 mantissa bits)
//   would not keep.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma3.cuh"  // mma, the bf16 pieces, cp.async, ldmatrix

namespace {

constexpr int CS = 128;           // chunk length (ssm_chunk)
constexpr unsigned FULL = 0xffffffffu;

// Per-chunk cumulative sums of dt * a over CS positions, by one warp (4
// positions a lane, then a shuffle scan), dt_at(i) giving dt at position i
// of the chunk (0 past l): cum, exp(cum) and
// wdec_i = dt_i * exp(cum_end - cum_i).
template <typename DtAt>
__device__ __forceinline__ void chunk_cumsum(DtAt dt_at, float a, float* cum,
                                             float* ecum, float* wdec) {
  const int lane = threadIdx.x & 31;
  constexpr int PER = CS / 32;
  float v[PER];
  float run = 0.f;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    run = run + dt_at(lane * PER + u) * a;
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
    wdec[i] = dt_at(i) * expf(tot - ci);
  }
}


// ===========================================================================
// bf16: the tensor-core kernel
// ===========================================================================

constexpr int MMA_THREADS = 128;  // 4 warps
constexpr int MT = CS / 16;       // 16-row tiles of a chunk
static_assert(MT == 2 * (MMA_THREADS / 32), "two m-tiles a warp");
static_assert(MMA_THREADS == CS, "one thread a position stages dt");

// 4 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// ldmatrix.x2.trans: two 8 x 8 bf16 tiles, transposed (the x4 forms are in
// mma3.cuh).
__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// (v0, v1) -> bf16 pairs hi and lo with hi + lo = v to ~2^-17 relative.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2(v0, v1);
  const float2 f = unpack2(hi);
  lo = pack2(v0 - f.x, v1 - f.y);
}

// Shared memory of one CTA, bf16 rows padded by 8 elements (16 B) so the 8
// row addresses of an ldmatrix hit distinct banks: C [CS][LDN], B [CS][LDN],
// x [2][CS][LDX] (double-buffered), the split state hi, lo [PT][LDN]; float
// dt [2][CS], cum, exp(cum), dt exp(cum_end - cum) [CS].
template <int N, int PT>
struct MmaSmem {
  static constexpr int LDN = N + 8;
  static constexpr int LDX = PT + 8;
  static constexpr size_t oC = 0;
  static constexpr size_t oB = oC + (size_t)CS * LDN * 2;
  static constexpr size_t oX = oB + (size_t)CS * LDN * 2;
  static constexpr size_t oSh = oX + (size_t)2 * CS * LDX * 2;
  static constexpr size_t oSl = oSh + (size_t)PT * LDN * 2;
  static constexpr size_t oDt = oSl + (size_t)PT * LDN * 2;
  static constexpr size_t oCum = oDt + (size_t)2 * CS * 4;
  static constexpr size_t oEc = oCum + (size_t)CS * 4;
  static constexpr size_t oW = oEc + (size_t)CS * 4;
  static constexpr size_t bytes = oW + (size_t)CS * 4;
  static_assert(N % 16 == 0 && PT % 16 == 0, "tile shapes");
  static_assert(bytes <= 232448, "shared memory of one block");
};

// Rows [0, rows) of a chunk starting at t0 into dst (row stride ld):
// W elements a row from src + t * stride, zero past l, by a CTA of THREADS.
template <int W, int THREADS, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           int64_t stride, int t0, int rows,
                                           int L) {
  constexpr int EL = 16 / sizeof(T);   // elements a 16-byte piece
  constexpr int PIECES = W / EL;
  for (int i = threadIdx.x; i < rows * PIECES; i += THREADS) {
    const int r = i / PIECES, k = i % PIECES, t = t0 + r;
    cp16(dst + r * ld + k * EL,
         src + (int64_t)(t < L ? t : t0) * stride + k * EL, t < L);
  }
}

// Grid (P / PT, H, B): CTA (pb, h, b) computes y[b, :, h, pb*PT : +PT] and
// the matching rows of the final state.
template <int N, int PT>
__global__ void __launch_bounds__(MMA_THREADS, 2)
ssd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm,
               const bf16* __restrict__ Cm, int64_t bc_row,
               const float* __restrict__ init, bf16* __restrict__ y,
               float* __restrict__ fstate, int L, int H, int G, int P) {
  using S = MmaSmem<N, PT>;
  constexpr int LDN = S::LDN, LDX = S::LDX;
  constexpr int KN = N / 16;       // k16 steps over the state
  constexpr int NTY = PT / 8;      // n8 tiles of y
  constexpr int NTS = N / 8;       // n8 tiles of the state's columns
  constexpr int MTS = PT / 16;     // m16 tiles of the state's rows
  constexpr int NPW = NTS >= 8 ? NTS / 4 : 1;  // state n8 tiles a warp
  static_assert(NPW == 1 || NPW % 2 == 0, "state tiles in pairs");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem + S::oC);
  bf16* Bs = reinterpret_cast<bf16*>(smem + S::oB);
  bf16* Xs = reinterpret_cast<bf16*>(smem + S::oX);
  bf16* Sh = reinterpret_cast<bf16*>(smem + S::oSh);
  bf16* Sl = reinterpret_cast<bf16*>(smem + S::oSl);
  float* dts = reinterpret_cast<float*>(smem + S::oDt);
  float* cum = reinterpret_cast<float*>(smem + S::oCum);
  float* ecum = reinterpret_cast<float*>(smem + S::oEc);
  float* wdec = reinterpret_cast<float*>(smem + S::oW);

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float a = A[h];
  const int64_t sbase = ((int64_t)b * H + h) * P * N + (int64_t)p0 * N;
  const bf16* xrow = x + ((int64_t)b * L * H + h) * P + p0;
  const int64_t xstride = (int64_t)H * P;
  const bf16* brow = Bm + (int64_t)b * L * bc_row + (int64_t)grp * N;
  const bf16* crow = Cm + (int64_t)b * L * bc_row + (int64_t)grp * N;
  const float* dtrow = dt + (int64_t)b * L * H + h;
  // ldmatrix row / column of this lane: a (m, k) tile stored [m][k], a B
  // tile stored [n][k] (and the same two read transposed, stored [k][m]
  // and [k][n])
  const int a_r = lane & 15, a_c = 8 * (lane >> 4);
  const int b_r = (lane & 7) + 8 * (lane >> 4), b_c = 8 * ((lane >> 3) & 1);
  const int at_r = (lane & 7) + 8 * (lane >> 4), at_c = 8 * ((lane >> 3) & 1);
  const int bt_r = (lane & 7) + 8 * ((lane >> 3) & 1), bt_c = 8 * (lane >> 4);

  // the state: warp w owns its columns [nbase, nbase + 8 NPW) of all PT rows
  const bool owner = warp * NPW < NTS;
  const int nbase = warp * NPW * 8;
  float sacc[MTS][NPW][4];
#pragma unroll
  for (int ms = 0; ms < MTS; ++ms)
#pragma unroll
    for (int q = 0; q < NPW; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[ms][q][e] = 0.f;
  // the split state [p][n] in shared memory, B operand of C S_prev^T
  auto put_split = [&]() {
#pragma unroll
    for (int ms = 0; ms < MTS; ++ms)
#pragma unroll
      for (int q = 0; q < NPW; ++q)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int off = (ms * 16 + g + 8 * hf) * LDN + nbase + q * 8 + 2 * t4;
          uint32_t hi, lo;
          split2(sacc[ms][q][2 * hf], sacc[ms][q][2 * hf + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(Sh + off) = hi;
          *reinterpret_cast<uint32_t*>(Sl + off) = lo;
        }
  };
  if (owner && init != nullptr) {
#pragma unroll
    for (int ms = 0; ms < MTS; ++ms)
#pragma unroll
      for (int q = 0; q < NPW; ++q)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 v = *reinterpret_cast<const float2*>(
              init + sbase + (int64_t)(ms * 16 + g + 8 * hf) * N + nbase
              + q * 8 + 2 * t4);
          sacc[ms][q][2 * hf] = v.x;
          sacc[ms][q][2 * hf + 1] = v.y;
        }
    put_split();
  }

  const int nc = (L + CS - 1) / CS;
  auto valid_rows = [&](int c) {
    const int nv = L - c * CS < CS ? L - c * CS : CS;
    return 16 * ((nv + 15) >> 4);  // the 16-row tiles holding rows < l
  };
  auto stage_xdt = [&](int c, int buf) {
    stage_rows<PT, MMA_THREADS>(Xs + buf * CS * LDX, LDX, xrow, xstride,
                              c * CS, valid_rows(c), L);
    const int t = c * CS + tid;
    cp4(dts + buf * CS + tid, dtrow + (int64_t)(t < L ? t : 0) * H, t < L);
  };
  if (nc > 0) {
    stage_rows<N, MMA_THREADS>(Cs, LDN, crow, bc_row, 0, valid_rows(0), L);
    stage_xdt(0, 0);
    cp_commit();
    stage_rows<N, MMA_THREADS>(Bs, LDN, brow, bc_row, 0, valid_rows(0), L);
    cp_commit();
  }

  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1, t0 = c * CS;
    const int mt = valid_rows(c) >> 4;
    const bool more = c + 1 < nc;
    const bf16* X = Xs + buf * CS * LDX;
    const float* d = dts + buf * CS;
    cp_wait<1>();                  // C, x and dt of chunk c (B may pend)
    __syncthreads();
    if (more) stage_xdt(c + 1, buf ^ 1);
    cp_commit();
    if (warp == 0)
      chunk_cumsum([&](int i) { return d[i]; }, a, cum, ecum, wdec);
    __syncthreads();

    // ---- y = exp(cum) o (C S_prev^T), S_prev as hi + lo -------------------
    float yacc[2][NTY][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int nt = 0; nt < NTY; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[s][nt][e] = 0.f;
    if (c > 0 || init != nullptr) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int mi = s ? MT - 1 - warp : warp;
        if (mi >= mt) continue;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          uint32_t af[4];
          ldsm4(af, Cs + (mi * 16 + a_r) * LDN + kk * 16 + a_c);
#pragma unroll
          for (int np = 0; np < PT / 16; ++np) {
            uint32_t bh[4], bl[4];
            const int off = (np * 16 + b_r) * LDN + kk * 16 + b_c;
            ldsm4(bh, Sh + off);
            ldsm4(bl, Sl + off);
            mma(yacc[s][2 * np], af, bh[0], bh[1]);
            mma(yacc[s][2 * np + 1], af, bh[2], bh[3]);
            mma(yacc[s][2 * np], af, bl[0], bl[1]);
            mma(yacc[s][2 * np + 1], af, bl[2], bl[3]);
          }
        }
        const float e0 = ecum[mi * 16 + g], e1 = ecum[mi * 16 + g + 8];
#pragma unroll
        for (int nt = 0; nt < NTY; ++nt) {
          yacc[s][nt][0] = yacc[s][nt][0] * e0;
          yacc[s][nt][1] = yacc[s][nt][1] * e0;
          yacc[s][nt][2] = yacc[s][nt][2] * e1;
          yacc[s][nt][3] = yacc[s][nt][3] * e1;
        }
      }
    }
    cp_wait<1>();                  // B of chunk c
    __syncthreads();

    // ---- y += ((C B^T) o L o dt_j) x, per 16 x 16 block, P as hi + lo -------
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int mi = s ? MT - 1 - warp : warp;
      if (mi >= mt) continue;
      uint32_t cf[KN][4];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        ldsm4(cf[kk], Cs + (mi * 16 + a_r) * LDN + kk * 16 + a_c);
      const int i0 = mi * 16 + g, i1 = i0 + 8;
      const float ci0 = cum[i0], ci1 = cum[i1];
      for (int jt = 0; jt <= mi; ++jt) {
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          uint32_t bf[4];
          ldsm4(bf, Bs + (jt * 16 + b_r) * LDN + kk * 16 + b_c);
          mma(sc[0], cf[kk], bf[0], bf[1]);
          mma(sc[1], cf[kk], bf[2], bf[3]);
        }
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = jt * 16 + nt * 8 + 2 * t4;
          const float cj0 = cum[j], cj1 = cum[j + 1];
          const float d0 = d[j], d1 = d[j + 1];
          const float v00 = i0 >= j ? sc[nt][0] * expf(ci0 - cj0) * d0 : 0.f;
          const float v01 =
              i0 >= j + 1 ? sc[nt][1] * expf(ci0 - cj1) * d1 : 0.f;
          const float v10 = i1 >= j ? sc[nt][2] * expf(ci1 - cj0) * d0 : 0.f;
          const float v11 =
              i1 >= j + 1 ? sc[nt][3] * expf(ci1 - cj1) * d1 : 0.f;
          split2(v00, v01, ph[2 * nt], pl[2 * nt]);          // row g
          split2(v10, v11, ph[2 * nt + 1], pl[2 * nt + 1]);  // row g + 8
        }
#pragma unroll
        for (int np = 0; np < PT / 16; ++np) {
          uint32_t xb[4];
          ldsm4t(xb, X + (jt * 16 + bt_r) * LDX + np * 16 + bt_c);
          mma(yacc[s][2 * np], ph, xb[0], xb[1]);
          mma(yacc[s][2 * np + 1], ph, xb[2], xb[3]);
          mma(yacc[s][2 * np], pl, xb[0], xb[1]);
          mma(yacc[s][2 * np + 1], pl, xb[2], xb[3]);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = t0 + mi * 16 + g + 8 * hf;
        if (t >= L) continue;
        bf16* out = y + (((int64_t)b * L + t) * H + h) * P + p0 + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < NTY; ++nt)
          *reinterpret_cast<uint32_t*>(out + nt * 8) =
              pack2(yacc[s][nt][2 * hf], yacc[s][nt][2 * hf + 1]);
      }
    }
    __syncthreads();               // C and the split state are free
    if (more)
      stage_rows<N, MMA_THREADS>(Cs, LDN, crow, bc_row, t0 + CS,
                              valid_rows(c + 1), L);
    cp_commit();

    // ---- S = exp(cum_end) S + (x o dt o exp(cum_end - cum))^T B -----------
    if (owner) {
      const float eend = ecum[CS - 1];
#pragma unroll
      for (int ms = 0; ms < MTS; ++ms)
#pragma unroll
        for (int q = 0; q < NPW; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[ms][q][e] = sacc[ms][q][e] * eend;
      for (int kt = 0; kt < mt; ++kt) {
        const int j = kt * 16 + 2 * t4;
        const float w0 = wdec[j], w1 = wdec[j + 1];
        const float w8 = wdec[j + 8], w9 = wdec[j + 9];
        uint32_t ah[MTS][4], al[MTS][4];
#pragma unroll
        for (int ms = 0; ms < MTS; ++ms) {
          uint32_t r[4];
          ldsm4t(r, X + (kt * 16 + at_r) * LDX + ms * 16 + at_c);
          float2 f = unpack2(r[0]);                 // (p g, j 2t..2t+1)
          split2(f.x * w0, f.y * w1, ah[ms][0], al[ms][0]);
          f = unpack2(r[1]);                        // (p g+8, j 2t..)
          split2(f.x * w0, f.y * w1, ah[ms][1], al[ms][1]);
          f = unpack2(r[2]);                        // (p g, j 2t+8..)
          split2(f.x * w8, f.y * w9, ah[ms][2], al[ms][2]);
          f = unpack2(r[3]);                        // (p g+8, j 2t+8..)
          split2(f.x * w8, f.y * w9, ah[ms][3], al[ms][3]);
        }
        const bf16* brow_k = Bs + (kt * 16 + bt_r) * LDN + nbase;
        if constexpr (NPW == 1) {
          uint32_t bb[2];
          ldsm2t(bb, brow_k);
#pragma unroll
          for (int ms = 0; ms < MTS; ++ms) mma(sacc[ms][0], ah[ms], bb[0], bb[1]);
#pragma unroll
          for (int ms = 0; ms < MTS; ++ms) mma(sacc[ms][0], al[ms], bb[0], bb[1]);
        } else {
#pragma unroll
          for (int q = 0; q < NPW; q += 2) {
            uint32_t bb[4];
            ldsm4t(bb, brow_k + q * 8 + bt_c);
#pragma unroll
            for (int ms = 0; ms < MTS; ++ms) {
              mma(sacc[ms][q], ah[ms], bb[0], bb[1]);
              mma(sacc[ms][q + 1], ah[ms], bb[2], bb[3]);
            }
#pragma unroll
            for (int ms = 0; ms < MTS; ++ms) {
              mma(sacc[ms][q], al[ms], bb[0], bb[1]);
              mma(sacc[ms][q + 1], al[ms], bb[2], bb[3]);
            }
          }
        }
      }
      if (more) put_split();
    }
    __syncthreads();               // B is free
    if (more)
      stage_rows<N, MMA_THREADS>(Bs, LDN, brow, bc_row, t0 + CS,
                              valid_rows(c + 1), L);
    cp_commit();
  }

  if (owner) {
#pragma unroll
    for (int ms = 0; ms < MTS; ++ms)
#pragma unroll
      for (int q = 0; q < NPW; ++q)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(
              fstate + sbase + (int64_t)(ms * 16 + g + 8 * hf) * N + nbase
              + q * 8 + 2 * t4) =
              make_float2(sacc[ms][q][2 * hf], sacc[ms][q][2 * hf + 1]);
  }
}

// ===========================================================================
// float32: the tensor-core kernel on three bf16 pieces
// ===========================================================================
//
// The bf16 kernel's tiles, warps, head-dim split and cp.async pipeline, on
// float32 x, B and C.  Every operand of every product, x, B and C included,
// is split into three bf16 pieces hi + mid + lo, and a product sums the six
// piece products that reach float32's rounding, smallest first (split3 and
// mma_k of mma3.cuh).  The CPU model of tests/test_torch_ssd_design.py
// settled the six: its y and state lie as close to a float64 recurrence as
// the plain float32 version, and two pieces with three products lie 6-20x
// farther.
//
// Shared memory holds float32 (C, B [CS][N + 8], x double-buffered
// [CS][PT + 4], the state [PT][N + 8]), and the pieces are cut while a
// fragment is built: three bf16 planes of B and C would need 208 KB at
// N 128.  Row pads: a fragment's float pairs (rows g, columns 2t) hit 32
// distinct banks at a stride of 8 mod 32 words; the column reads of x
// (rows 2t, columns g) at a stride of 4 mod 32.  One CTA an SM at N 64 and
// 128 (196 KB at N 128), four at N 16.

// The fragment of rows r0 + g, r0 + g + 8 and columns c0 + 2t, + 1, + 8,
// + 9 of a float32 [row][col] array (p = &a[(r0 + g) * ld + c0 + 2t]):
// [0] (row g, col 2t), [1] (row g + 8), [2] (row g, col 2t + 8), [3] (row
// g + 8, col 2t + 8).  As an A operand: rows m, columns k.  As B operands
// of two n8 tiles stored [n][k]: b0, b1 of tile 0 are [0], [2], of tile 1
// [1], [3].
__device__ __forceinline__ void load3(Frag3& f, const float* p, int ld) {
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
  split3(v0.x, v0.y, f.h[0], f.m[0], f.l[0]);
  split3(v1.x, v1.y, f.h[1], f.m[1], f.l[1]);
  split3(v2.x, v2.y, f.h[2], f.m[2], f.l[2]);
  split3(v3.x, v3.y, f.h[3], f.m[3], f.l[3]);
}

constexpr int MMA3_THREADS = 256;  // 8 warps
constexpr int MMA3_WARPS = MMA3_THREADS / 32;

template <int N, int PT>
struct Mma3Smem {
  static constexpr int LDN = N + 8;
  static constexpr int LDX = PT + 4;
  static constexpr int NTY = PT / 8;
  static constexpr size_t oC = 0;
  static constexpr size_t oB = oC + (size_t)CS * LDN * 4;
  static constexpr size_t oX = oB + (size_t)CS * LDN * 4;
  static constexpr size_t oS = oX + (size_t)2 * CS * LDX * 4;
  static constexpr size_t oY = oS + (size_t)PT * LDN * 4;
  static constexpr size_t oDt = oY + (size_t)(MMA3_WARPS / 2) * 2 * NTY * 4 *
                                         32 * 4;
  static constexpr size_t oCum = oDt + (size_t)2 * CS * 4;
  static constexpr size_t oEc = oCum + (size_t)CS * 4;
  static constexpr size_t oW = oEc + (size_t)CS * 4;
  static constexpr size_t bytes = oW + (size_t)CS * 4;
  static_assert(N % 16 == 0 && PT % 16 == 0, "tile shapes");
  static_assert(LDN % 32 == 8 || LDN % 32 == 24, "fragment rows on banks");
  static_assert(LDX % 8 == 4, "x columns on banks");
  static_assert(bytes <= 232448, "shared memory of one block");
};

// Grid (P / PT, H, B): CTA (pb, h, b) computes y[b, :, h, pb*PT : +PT] and
// the matching rows of the final state.  8 warps: one CTA an SM leaves 4
// warps (the bf16 kernel's) with no other warp to hide a split's or an
// mma's latency behind.  Warps w and w + 4 share the m-tiles w and 7 - w of
// y (equal causal work): for each, the lower half of its j-tiles and of the
// state's k16 steps in C S_prev^T go to warp w, the upper halves to warp
// w + 4, whose partial y warp w adds through shared memory before it
// stores.  Each warp owns N / 64 n8 tiles of the state's columns (one at
// N 64; warps 0 and 1 at N 16).
template <int N, int PT>
__global__ void __launch_bounds__(MMA3_THREADS, 1)
ssd_mma3_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, int64_t bc_row,
                const float* __restrict__ init, float* __restrict__ y,
                float* __restrict__ fstate, int L, int H, int G, int P) {
  using S = Mma3Smem<N, PT>;
  constexpr int LDN = S::LDN, LDX = S::LDX;
  constexpr int KN = N / 16;       // k16 steps over the state
  constexpr int KH = (KN + 1) / 2; // of them, the lower half's
  constexpr int NTY = PT / 8;      // n8 tiles of y
  constexpr int NTS = N / 8;       // n8 tiles of the state's columns
  constexpr int MTS = PT / 16;     // m16 tiles of the state's rows
  constexpr int NPW = NTS >= MMA3_WARPS ? NTS / MMA3_WARPS : 1;
  constexpr int JH = MT / 2;       // j-tiles of a half, at most
  extern __shared__ __align__(128) unsigned char smem[];
  float* Cs = reinterpret_cast<float*>(smem + S::oC);
  float* Bs = reinterpret_cast<float*>(smem + S::oB);
  float* Xs = reinterpret_cast<float*>(smem + S::oX);
  float* Ss = reinterpret_cast<float*>(smem + S::oS);
  float* Ys = reinterpret_cast<float*>(smem + S::oY);
  float* dts = reinterpret_cast<float*>(smem + S::oDt);
  float* cum = reinterpret_cast<float*>(smem + S::oCum);
  float* ecum = reinterpret_cast<float*>(smem + S::oEc);
  float* wdec = reinterpret_cast<float*>(smem + S::oW);

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int pw = warp & 3, hf = warp >> 2;   // m-tile pair, half
  const float a = A[h];
  const int64_t sbase = ((int64_t)b * H + h) * P * N + (int64_t)p0 * N;
  const float* xrow = x + ((int64_t)b * L * H + h) * P + p0;
  const int64_t xstride = (int64_t)H * P;
  const float* brow = Bm + (int64_t)b * L * bc_row + (int64_t)grp * N;
  const float* crow = Cm + (int64_t)b * L * bc_row + (int64_t)grp * N;
  const float* dtrow = dt + (int64_t)b * L * H + h;
  // this thread's slot of the upper half's partial y
  float* ypart = Ys + pw * (2 * NTY * 4 * 32) + lane;

  const bool owner = warp * NPW < NTS;
  const int nbase = warp * NPW * 8;
  float sacc[MTS][NPW][4];
#pragma unroll
  for (int ms = 0; ms < MTS; ++ms)
#pragma unroll
    for (int q = 0; q < NPW; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[ms][q][e] = 0.f;
  // the state [p][n] in shared memory, B operand of C S_prev^T
  auto put_state = [&]() {
#pragma unroll
    for (int ms = 0; ms < MTS; ++ms)
#pragma unroll
      for (int q = 0; q < NPW; ++q)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(
              Ss + (ms * 16 + g + 8 * hh) * LDN + nbase + q * 8 + 2 * t4) =
              make_float2(sacc[ms][q][2 * hh], sacc[ms][q][2 * hh + 1]);
  };
  if (owner && init != nullptr) {
#pragma unroll
    for (int ms = 0; ms < MTS; ++ms)
#pragma unroll
      for (int q = 0; q < NPW; ++q)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 v = *reinterpret_cast<const float2*>(
              init + sbase + (int64_t)(ms * 16 + g + 8 * hh) * N + nbase
              + q * 8 + 2 * t4);
          sacc[ms][q][2 * hh] = v.x;
          sacc[ms][q][2 * hh + 1] = v.y;
        }
    put_state();
  }

  const int nc = (L + CS - 1) / CS;
  auto valid_rows = [&](int c) {
    const int nv = L - c * CS < CS ? L - c * CS : CS;
    return 16 * ((nv + 15) >> 4);  // the 16-row tiles holding rows < l
  };
  auto stage_xdt = [&](int c, int buf) {
    stage_rows<PT, MMA3_THREADS>(Xs + buf * CS * LDX, LDX, xrow, xstride,
                                 c * CS, valid_rows(c), L);
    const int t = c * CS + tid;
    if (tid < CS)
      cp4(dts + buf * CS + tid, dtrow + (int64_t)(t < L ? t : 0) * H, t < L);
  };
  if (nc > 0) {
    stage_rows<N, MMA3_THREADS>(Cs, LDN, crow, bc_row, 0, valid_rows(0), L);
    stage_xdt(0, 0);
    cp_commit();
    stage_rows<N, MMA3_THREADS>(Bs, LDN, brow, bc_row, 0, valid_rows(0), L);
    cp_commit();
  }

  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1, t0 = c * CS;
    const int mt = valid_rows(c) >> 4;
    const bool more = c + 1 < nc;
    const float* X = Xs + buf * CS * LDX;
    const float* d = dts + buf * CS;
    cp_wait<1>();                  // C, x and dt of chunk c (B may pend)
    __syncthreads();
    if (more) stage_xdt(c + 1, buf ^ 1);
    cp_commit();
    if (warp == 0)
      chunk_cumsum([&](int i) { return d[i]; }, a, cum, ecum, wdec);
    __syncthreads();

    // ---- y = exp(cum) o (C S_prev^T), this half's k16 steps ---------------
    float yacc[2][NTY][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int nt = 0; nt < NTY; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[s][nt][e] = 0.f;
    if (c > 0 || init != nullptr) {
      const int k1 = hf ? KN : KH;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int mi = s ? MT - 1 - pw : pw;
        if (mi >= mt) continue;
#pragma unroll 2
        for (int kk = hf * KH; kk < k1; ++kk) {
          Frag3 cf, sf[PT / 16];
          load3(cf, Cs + (mi * 16 + g) * LDN + kk * 16 + 2 * t4, LDN);
#pragma unroll
          for (int np = 0; np < PT / 16; ++np)
            load3(sf[np], Ss + (np * 16 + g) * LDN + kk * 16 + 2 * t4, LDN);
#pragma unroll
          for (int k = 0; k < 6; ++k)
#pragma unroll
            for (int np = 0; np < PT / 16; ++np) {
              mma_k(k, yacc[s][2 * np], cf, sf[np], 0, 2);
              mma_k(k, yacc[s][2 * np + 1], cf, sf[np], 1, 3);
            }
        }
        const float e0 = ecum[mi * 16 + g], e1 = ecum[mi * 16 + g + 8];
#pragma unroll
        for (int nt = 0; nt < NTY; ++nt) {
          yacc[s][nt][0] = yacc[s][nt][0] * e0;
          yacc[s][nt][1] = yacc[s][nt][1] * e0;
          yacc[s][nt][2] = yacc[s][nt][2] * e1;
          yacc[s][nt][3] = yacc[s][nt][3] * e1;
        }
      }
    }
    cp_wait<1>();                  // B of chunk c
    __syncthreads();

    // ---- y += ((C B^T) o L o dt_j) x, this half's j-tiles -------------------
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int mi = s ? MT - 1 - pw : pw;
      if (mi >= mt) continue;
      const int nj = mi + 1, jsplit = (nj + 1) >> 1;
      const int jlo = hf ? jsplit : 0, jn = hf ? nj - jsplit : jsplit;
      // the scores of the m-tile against the half's j-tiles, k outside
      float sc[JH][2][4];
#pragma unroll
      for (int u = 0; u < JH; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[u][0][e] = sc[u][1][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < KN; ++kk) {
        Frag3 cf;
        load3(cf, Cs + (mi * 16 + g) * LDN + kk * 16 + 2 * t4, LDN);
        // j-tiles two at a time: four accumulators in flight
#pragma unroll
        for (int u = 0; u < JH; u += 2) {
          if (u >= jn) break;
          const float* bp =
              Bs + ((jlo + u) * 16 + g) * LDN + kk * 16 + 2 * t4;
          Frag3 b0, b1;
          load3(b0, bp, LDN);
          if (u + 1 < jn) {
            load3(b1, bp + 16 * LDN, LDN);
#pragma unroll
            for (int k = 0; k < 6; ++k) {
              mma_k(k, sc[u][0], cf, b0, 0, 2);
              mma_k(k, sc[u][1], cf, b0, 1, 3);
              mma_k(k, sc[u + 1][0], cf, b1, 0, 2);
              mma_k(k, sc[u + 1][1], cf, b1, 1, 3);
            }
          } else {
#pragma unroll
            for (int k = 0; k < 6; ++k) {
              mma_k(k, sc[u][0], cf, b0, 0, 2);
              mma_k(k, sc[u][1], cf, b0, 1, 3);
            }
          }
        }
      }
      const int i0 = mi * 16 + g, i1 = i0 + 8;
      const float ci0 = cum[i0], ci1 = cum[i1];
#pragma unroll
      for (int u = 0; u < JH; ++u) {
        if (u >= jn) break;
        const int jt = jlo + u;
        Frag3 pf;                  // P as the A operand (rows i, k = j)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = jt * 16 + nt * 8 + 2 * t4;
          const float cj0 = cum[j], cj1 = cum[j + 1];
          const float d0 = d[j], d1 = d[j + 1];
          const float v00 =
              i0 >= j ? sc[u][nt][0] * expf(ci0 - cj0) * d0 : 0.f;
          const float v01 =
              i0 >= j + 1 ? sc[u][nt][1] * expf(ci0 - cj1) * d1 : 0.f;
          const float v10 =
              i1 >= j ? sc[u][nt][2] * expf(ci1 - cj0) * d0 : 0.f;
          const float v11 =
              i1 >= j + 1 ? sc[u][nt][3] * expf(ci1 - cj1) * d1 : 0.f;
          split3(v00, v01, pf.h[2 * nt], pf.m[2 * nt], pf.l[2 * nt]);
          split3(v10, v11, pf.h[2 * nt + 1], pf.m[2 * nt + 1],
                 pf.l[2 * nt + 1]);
        }
        Frag3 xf[NTY];
#pragma unroll
        for (int nt = 0; nt < NTY; ++nt) {
          // x as the B operand (k = j, n = p): rows 2t, 2t + 1 and + 8
          const float* xc = X + (jt * 16 + 2 * t4) * LDX + nt * 8 + g;
          split3(xc[0], xc[LDX], xf[nt].h[0], xf[nt].m[0], xf[nt].l[0]);
          split3(xc[8 * LDX], xc[9 * LDX], xf[nt].h[1], xf[nt].m[1],
                 xf[nt].l[1]);
        }
#pragma unroll
        for (int k = 0; k < 6; ++k)
#pragma unroll
          for (int nt = 0; nt < NTY; ++nt)
            mma_k(k, yacc[s][nt], pf, xf[nt], 0, 1);
      }
      if (hf) {                    // the upper half's partial y
#pragma unroll
        for (int nt = 0; nt < NTY; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ypart[((s * NTY + nt) * 4 + e) * 32] = yacc[s][nt][e];
      }
    }
    __syncthreads();               // C, the state copy and the partials
    if (more)
      stage_rows<N, MMA3_THREADS>(Cs, LDN, crow, bc_row, t0 + CS,
                                  valid_rows(c + 1), L);
    cp_commit();
    if (!hf) {                     // the lower half adds and stores y
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int mi = s ? MT - 1 - pw : pw;
        if (mi >= mt) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = t0 + mi * 16 + g + 8 * hh;
          if (t >= L) continue;
          float* out = y + (((int64_t)b * L + t) * H + h) * P + p0 + 2 * t4;
#pragma unroll
          for (int nt = 0; nt < NTY; ++nt) {
            const float* up = ypart + ((s * NTY + nt) * 4 + 2 * hh) * 32;
            *reinterpret_cast<float2*>(out + nt * 8) =
                make_float2(yacc[s][nt][2 * hh] + up[0],
                            yacc[s][nt][2 * hh + 1] + up[32]);
          }
        }
      }
    }

    // ---- S = exp(cum_end) S + (x o dt o exp(cum_end - cum))^T B -----------
    if (owner) {
      const float eend = ecum[CS - 1];
#pragma unroll
      for (int ms = 0; ms < MTS; ++ms)
#pragma unroll
        for (int q = 0; q < NPW; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[ms][q][e] = sacc[ms][q][e] * eend;
#pragma unroll 2
      for (int kt = 0; kt < mt; ++kt) {
        const int j = kt * 16 + 2 * t4;
        const float w0 = wdec[j], w1 = wdec[j + 1];
        const float w8 = wdec[j + 8], w9 = wdec[j + 9];
        Frag3 wf[MTS];             // W^T as the A operand (rows p, k = j)
#pragma unroll
        for (int ms = 0; ms < MTS; ++ms) {
          const float* xc = X + j * LDX + ms * 16 + g;
          split3(xc[0] * w0, xc[LDX] * w1, wf[ms].h[0], wf[ms].m[0],
                 wf[ms].l[0]);
          split3(xc[8] * w0, xc[LDX + 8] * w1, wf[ms].h[1], wf[ms].m[1],
                 wf[ms].l[1]);
          split3(xc[8 * LDX] * w8, xc[9 * LDX] * w9, wf[ms].h[2],
                 wf[ms].m[2], wf[ms].l[2]);
          split3(xc[8 * LDX + 8] * w8, xc[9 * LDX + 8] * w9, wf[ms].h[3],
                 wf[ms].m[3], wf[ms].l[3]);
        }
        Frag3 bf[NPW];
#pragma unroll
        for (int q = 0; q < NPW; ++q) {
          // B as the B operand (k = j, n = state column): rows 2t, 2t + 1
          // and + 8
          const float* bc = Bs + j * LDN + nbase + q * 8 + g;
          split3(bc[0], bc[LDN], bf[q].h[0], bf[q].m[0], bf[q].l[0]);
          split3(bc[8 * LDN], bc[9 * LDN], bf[q].h[1], bf[q].m[1],
                 bf[q].l[1]);
        }
#pragma unroll
        for (int k = 0; k < 6; ++k)
#pragma unroll
          for (int q = 0; q < NPW; ++q)
#pragma unroll
            for (int ms = 0; ms < MTS; ++ms)
              mma_k(k, sacc[ms][q], wf[ms], bf[q], 0, 1);
      }
      if (more) put_state();
    }
    __syncthreads();               // B and the partials are free
    if (more)
      stage_rows<N, MMA3_THREADS>(Bs, LDN, brow, bc_row, t0 + CS,
                                  valid_rows(c + 1), L);
    cp_commit();
  }

  if (owner) {
#pragma unroll
    for (int ms = 0; ms < MTS; ++ms)
#pragma unroll
      for (int q = 0; q < NPW; ++q)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(
              fstate + sbase + (int64_t)(ms * 16 + g + 8 * hh) * N + nbase
              + q * 8 + 2 * t4) =
              make_float2(sacc[ms][q][2 * hh], sacc[ms][q][2 * hh + 1]);
  }
}

// ===========================================================================
// launch
// ===========================================================================

struct Args {
  const void *x, *dt, *A, *B, *C;
  int64_t bc_row;
  const void* init;
  void *y, *fstate;
  int b, l, h, g, p;
};

template <int N, int PT>
cudaError_t launch_mma(const Args& q, cudaStream_t st, int* per_sm) {
  auto kernel = ssd_mma_kernel<N, PT>;
  constexpr size_t smem = MmaSmem<N, PT>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  if (per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                         MMA_THREADS, smem);
  kernel<<<dim3(q.p / PT, q.h, q.b), MMA_THREADS, smem, st>>>(
      static_cast<const bf16*>(q.x), static_cast<const float*>(q.dt),
      static_cast<const float*>(q.A), static_cast<const bf16*>(q.B),
      static_cast<const bf16*>(q.C), q.bc_row,
      static_cast<const float*>(q.init), static_cast<bf16*>(q.y),
      static_cast<float*>(q.fstate), q.l, q.h, q.g, q.p);
  return cudaGetLastError();
}

template <int N, int PT>
cudaError_t launch_mma3(const Args& q, cudaStream_t st, int* per_sm) {
  auto kernel = ssd_mma3_kernel<N, PT>;
  constexpr size_t smem = Mma3Smem<N, PT>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  if (per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                         MMA3_THREADS, smem);
  kernel<<<dim3(q.p / PT, q.h, q.b), MMA3_THREADS, smem, st>>>(
      static_cast<const float*>(q.x), static_cast<const float*>(q.dt),
      static_cast<const float*>(q.A), static_cast<const float*>(q.B),
      static_cast<const float*>(q.C), q.bc_row,
      static_cast<const float*>(q.init), static_cast<float*>(q.y),
      static_cast<float*>(q.fstate), q.l, q.h, q.g, q.p);
  return cudaGetLastError();
}

// The instance for (p, n, chunk, dtype): launch it, or (per_sm != null)
// report its resident CTAs per SM instead.
cudaError_t dispatch(const Args& q, int n, int chunk, int dtype,
                     cudaStream_t st, int* per_sm) {
  if (chunk != CS) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (q.p == 64 && n == 128) return launch_mma3<128, 32>(q, st, per_sm);
    if (q.p == 64 && n == 64) return launch_mma3<64, 32>(q, st, per_sm);
    if (q.p == 16 && n == 16) return launch_mma3<16, 16>(q, st, per_sm);
  } else if (dtype == 1) {
    if (q.p == 64 && n == 128) return launch_mma<128, 32>(q, st, per_sm);
    if (q.p == 64 && n == 64) return launch_mma<64, 32>(q, st, per_sm);
    if (q.p == 16 && n == 16) return launch_mma<16, 16>(q, st, per_sm);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (the three-piece kernel), 1 = bfloat16 (the bf16
// kernel), of x, B, C and y.  init may be null (a zero initial state).
// bc_row is the element stride between the (batch, position) rows of B and
// of C.  Returns cudaGetLastError() after the launch (or the error that
// refused it).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, int64_t bc_row,
                               const void* init, void* y, void* fstate,
                               int b, int l, int h, int g, int p, int n,
                               int chunk, int dtype, void* stream) {
  if (b == 0 || h == 0) return 0;
  if (g <= 0 || h % g != 0) return (int)cudaErrorInvalidValue;
  const Args q{x, dt, A, B, C, bc_row, init, y, fstate, b, l, h, g, p};
  return (int)dispatch(q, n, chunk, dtype, static_cast<cudaStream_t>(stream),
                       nullptr);
}

// CTAs of the (p, n, chunk, dtype) instance resident on one SM (the
// occupancy the design counts on), or -1 where no instance exists.
extern "C" int ssd_scan_blocks_per_sm(int p, int n, int chunk, int dtype) {
  Args q{};
  q.p = p;
  int per_sm = -1;
  if (dispatch(q, n, chunk, dtype, nullptr, &per_sm) != cudaSuccess)
    return -1;
  return per_sm;
}
