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
// 0.015 ms at the tensor cores' 989 TFLOP/s.  In float32 the bound is the
// FMA pipes' 67 TFLOP/s (0.225 ms).
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
// float32: ssd_fma_kernel, one 256-thread CTA per (b, h) with the chunk loop
// inside and the state in shared memory; its four products are
// register-tiled fmaf loops (the port builds with --fmad=false, so the FMAs
// are written out).  Kept off the tensor cores: TF32 would move the float32
// cuts' tokens and miss the 3e-4 tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CS = 128;           // chunk length (ssm_chunk)
constexpr unsigned FULL = 0xffffffffu;

// Per-chunk cumulative sums of dt * a over CS positions, by one warp (4
// positions a lane, then a shuffle scan), dt_at(i) giving dt at position i
// of the chunk (0 past l): cum, exp(cum) and
// wdec_i = scale_i * exp(cum_end - cum_i) (scale = dt for the bf16 kernel,
// 1 for the float32 one, which folds dt into x).
template <typename DtAt>
__device__ __forceinline__ void chunk_cumsum(DtAt dt_at, float a,
                                             bool times_dt, float* cum,
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
    const float dec = expf(tot - ci);
    wdec[i] = times_dt ? dt_at(i) * dec : dec;
  }
}

// ===========================================================================
// float32: the FMA kernel
// ===========================================================================

constexpr int FMA_THREADS = 256;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// X [CS][LDP] (x dt), Bt and Ct [N][LDC] (transposed, float32), St [N][LDP]
// (St[k][pp] = S[pp][k]), cum / exp(cum) / exp(cum_end - cum), and P
// [CS][LDC], laid over the dead Bt and Ct where they are large enough.
// Rows padded by 4 floats: float4-aligned, and the row-strided float4 reads
// of the state update hit distinct banks.
template <int N, int P>
struct FmaSmem {
  static constexpr int LDP = P + 4;
  static constexpr int LDC = CS + 4;
  static constexpr int kX = CS * LDP;
  static constexpr int kB = N * LDC;
  static constexpr int kS = N * LDP;
  static constexpr int kVec = 3 * CS;
  static constexpr bool kOver = CS * LDC <= 2 * kB;
  static constexpr int kP = kOver ? 0 : CS * LDC;
  static constexpr size_t bytes =
      (size_t)(kX + 2 * kB + kS + kVec + kP) * sizeof(float);
  static_assert(N % 16 == 0 && P % 16 == 0, "tile shapes");
  static_assert(bytes <= 232448, "shared memory of one block");
};

// Threads tile the products three ways:
//   y (1 and 4): (ty, tx) with tx over P/4 column groups, rows ty*4 + RSTEP ra;
//   the state (2): (sy, sx), rows sy*4 of P, columns sx + SX q of N;
//   the scores (3): a 16 x 16 grid of 4 x 4 tiles, 64-row steps.
// At P 64 the first two are the 16 x 16 grid too; at P 16 some threads sit
// out a product (they still meet every barrier).
template <int N, int P>
__global__ void __launch_bounds__(FMA_THREADS, 1)
ssd_fma_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, int64_t bc_row,
               const float* __restrict__ init, float* __restrict__ y,
               float* __restrict__ fstate, int L, int H, int G) {
  using S = FmaSmem<N, P>;
  constexpr int LDP = S::LDP, LDC = S::LDC;
  constexpr int YX = P / 4, YY = FMA_THREADS / YX, RSTEP = 4 * YY;
  constexpr int RA = RSTEP >= CS ? 1 : CS / RSTEP;
  constexpr int SX = FMA_THREADS / (P / 4);
  constexpr int NQ = SX >= N ? 1 : N / SX;
  constexpr int RQ = CS / 64;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);
  float* Bt = X + S::kX;
  float* Ct = Bt + S::kB;
  float* St = Ct + S::kB;
  float* cum = St + S::kS;
  float* ecum = cum + CS;
  float* dec = ecum + CS;
  float* Pm = S::kOver ? Bt : dec + CS;

  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid / YX, tx = tid % YX;
  const bool yact = ty * 4 < CS;
  const int sy = tid / SX, sx = tid % SX;
  const bool sact = sx < N;
  const int qy = tid >> 4, qx = tid & 15;
  const float a = A[h];
  const int64_t sbase = ((int64_t)b * H + h) * P * N;

  for (int i = tid; i < P * N; i += FMA_THREADS)
    St[(i % N) * LDP + i / N] = init != nullptr ? init[sbase + i] : 0.f;

  const int nc = (L + CS - 1) / CS;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * CS;
    __syncthreads();               // last chunk's P and X reads are done

    // ---- stage x dt, B, C; cumulative sums of dt A (warp 0) -------------
    for (int i = tid; i < CS * P; i += FMA_THREADS) {
      const int r = i / P, col = i % P, t = t0 + r;
      float v = 0.f;
      if (t < L) {
        const int64_t row = ((int64_t)b * L + t) * H + h;
        v = x[row * P + col] * dt[row];
      }
      X[r * LDP + col] = v;
    }
    for (int i = tid; i < CS * N; i += FMA_THREADS) {
      const int r = i / N, k = i % N, t = t0 + r;
      float bv = 0.f, cv = 0.f;
      if (t < L) {
        const int64_t off = ((int64_t)b * L + t) * bc_row + (int64_t)grp * N
                            + k;
        bv = Bm[off];
        cv = Cm[off];
      }
      Bt[k * LDC + r] = bv;
      Ct[k * LDC + r] = cv;
    }
    if (tid < 32) {
      auto dt_at = [&](int i) {
        const int t = t0 + i;
        return t < L ? dt[((int64_t)b * L + t) * H + h] : 0.f;
      };
      chunk_cumsum(dt_at, a, false, cum, ecum, dec);
    }
    __syncthreads();

    // ---- 1. y = exp(cum) o (C S^T) ---------------------------------------
    float yacc[RA][4][4];
#pragma unroll
    for (int ra = 0; ra < RA; ++ra)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) yacc[ra][r][q] = 0.f;
    if (yact) {
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        const float4 sv = ld4(&St[k * LDP + tx * 4]);
#pragma unroll
        for (int ra = 0; ra < RA; ++ra) {
          const float4 cv = ld4(&Ct[k * LDC + RSTEP * ra + ty * 4]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              yacc[ra][r][q] = fmaf(at(cv, r), at(sv, q), yacc[ra][r][q]);
        }
      }
#pragma unroll
      for (int ra = 0; ra < RA; ++ra)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float e = ecum[RSTEP * ra + ty * 4 + r];
#pragma unroll
          for (int q = 0; q < 4; ++q) yacc[ra][r][q] = yacc[ra][r][q] * e;
        }
    }

    // ---- 2. S' = exp(cum_end) S + (X o decay)^T B -------------------------
    {
      float snew[4][NQ];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q) snew[r][q] = 0.f;
      if (sact) {
#pragma unroll 2
        for (int i0 = 0; i0 < CS; i0 += 4) {
          const float4 d4 = ld4(&dec[i0]);
          float xd[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 xv = ld4(&X[(i0 + u) * LDP + sy * 4]);
            const float du = at(d4, u);
#pragma unroll
            for (int r = 0; r < 4; ++r) xd[u][r] = at(xv, r) * du;
          }
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const float4 bv = ld4(&Bt[(sx + SX * q) * LDC + i0]);
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                snew[r][q] = fmaf(xd[u][r], at(bv, u), snew[r][q]);
          }
        }
        const float etot = expf(cum[CS - 1]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < NQ; ++q)
            snew[r][q] = St[(sx + SX * q) * LDP + sy * 4 + r] * etot
                         + snew[r][q];
      }
      __syncthreads();             // every read of the old state is done
      if (sact) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < NQ; ++q)
            St[(sx + SX * q) * LDP + sy * 4 + r] = snew[r][q];
      }
    }

    // ---- 3. P = (C B^T) o L -------------------------------------------------
    {
      float sc[RQ][4][RQ][4];
#pragma unroll
      for (int ra = 0; ra < RQ; ++ra)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int rb = 0; rb < RQ; ++rb)
#pragma unroll
            for (int q = 0; q < 4; ++q) sc[ra][r][rb][q] = 0.f;
#pragma unroll 2
      for (int k = 0; k < N; ++k) {
        float4 cv[RQ], bv[RQ];
#pragma unroll
        for (int ra = 0; ra < RQ; ++ra) {
          cv[ra] = ld4(&Ct[k * LDC + 64 * ra + qy * 4]);
          bv[ra] = ld4(&Bt[k * LDC + 64 * ra + qx * 4]);
        }
#pragma unroll
        for (int ra = 0; ra < RQ; ++ra)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int rb = 0; rb < RQ; ++rb)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                sc[ra][r][rb][q] = fmaf(at(cv[ra], r), at(bv[rb], q),
                                        sc[ra][r][rb][q]);
      }
      __syncthreads();             // Bt and Ct are dead: P may go over them
#pragma unroll
      for (int ra = 0; ra < RQ; ++ra)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 64 * ra + qy * 4 + r;
          const float ci = cum[i];
#pragma unroll
          for (int rb = 0; rb < RQ; ++rb) {
            float4 pv;
            float* pw = reinterpret_cast<float*>(&pv);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int j = 64 * rb + qx * 4 + q;
              pw[q] = i >= j ? sc[ra][r][rb][q] * expf(ci - cum[j]) : 0.f;
            }
            *reinterpret_cast<float4*>(&Pm[i * LDC + 64 * rb + qx * 4]) = pv;
          }
        }
      __syncthreads();
    }

    // ---- 4. y += P X (columns j <= the thread's last row) ------------------
    if (yact) {
      const int jend = RSTEP * (RA - 1) + ty * 4 + 4;
      for (int j0 = 0; j0 < jend; j0 += 4) {
        float4 xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) xv[u] = ld4(&X[(j0 + u) * LDP + tx * 4]);
#pragma unroll
        for (int ra = 0; ra < RA; ++ra)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 pv = ld4(&Pm[(RSTEP * ra + ty * 4 + r) * LDC + j0]);
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                yacc[ra][r][q] = fmaf(at(pv, u), at(xv[u], q),
                                      yacc[ra][r][q]);
          }
      }
#pragma unroll
      for (int ra = 0; ra < RA; ++ra)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = t0 + RSTEP * ra + ty * 4 + r;
          if (t >= L) continue;
          float* out = y + (((int64_t)b * L + t) * H + h) * P + tx * 4;
#pragma unroll
          for (int q = 0; q < 4; ++q) out[q] = yacc[ra][r][q];
        }
    }
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += FMA_THREADS)
    fstate[sbase + i] = St[(i % N) * LDP + i / N];
}

// ===========================================================================
// bf16: the tensor-core kernel
// ===========================================================================

typedef __nv_bfloat16 bf16;
constexpr int MMA_THREADS = 128;  // 4 warps
constexpr int MT = CS / 16;       // 16-row tiles of a chunk
static_assert(MT == 2 * (MMA_THREADS / 32), "two m-tiles a warp");
static_assert(MMA_THREADS == CS, "one thread a position stages dt");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
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

// ldmatrix: four (x4) or two (x2) 8 x 8 bf16 tiles; lane l gives the row
// address of tile l / 8.  .trans hands each thread the transposed tile.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
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
// W elements a row from src + t * stride, zero past l.
template <int W>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld,
                                           const bf16* src, int64_t stride,
                                           int t0, int rows, int L) {
  constexpr int PIECES = W / 8;
  for (int i = threadIdx.x; i < rows * PIECES; i += MMA_THREADS) {
    const int r = i / PIECES, k = i % PIECES, t = t0 + r;
    cp16(dst + r * ld + k * 8, src + (int64_t)(t < L ? t : t0) * stride + k * 8,
         t < L);
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
    stage_rows<PT>(Xs + buf * CS * LDX, LDX, xrow, xstride, c * CS,
                   valid_rows(c), L);
    const int t = c * CS + tid;
    cp4(dts + buf * CS + tid, dtrow + (int64_t)(t < L ? t : 0) * H, t < L);
  };
  if (nc > 0) {
    stage_rows<N>(Cs, LDN, crow, bc_row, 0, valid_rows(0), L);
    stage_xdt(0, 0);
    cp_commit();
    stage_rows<N>(Bs, LDN, brow, bc_row, 0, valid_rows(0), L);
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
      chunk_cumsum([&](int i) { return d[i]; }, a, true, cum, ecum, wdec);
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
    if (more) stage_rows<N>(Cs, LDN, crow, bc_row, t0 + CS,
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
    if (more) stage_rows<N>(Bs, LDN, brow, bc_row, t0 + CS,
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
// launch
// ===========================================================================

struct Args {
  const void *x, *dt, *A, *B, *C;
  int64_t bc_row;
  const void* init;
  void *y, *fstate;
  int b, l, h, g, p;
};

template <int N, int P>
cudaError_t launch_fma(const Args& q, cudaStream_t st, int* per_sm) {
  auto kernel = ssd_fma_kernel<N, P>;
  constexpr size_t smem = FmaSmem<N, P>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                         FMA_THREADS, smem);
  kernel<<<dim3(q.h, q.b), FMA_THREADS, smem, st>>>(
      static_cast<const float*>(q.x), static_cast<const float*>(q.dt),
      static_cast<const float*>(q.A), static_cast<const float*>(q.B),
      static_cast<const float*>(q.C), q.bc_row,
      static_cast<const float*>(q.init), static_cast<float*>(q.y),
      static_cast<float*>(q.fstate), q.l, q.h, q.g);
  return cudaGetLastError();
}

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

// The instance for (p, n, chunk, dtype): launch it, or (per_sm != null)
// report its resident CTAs per SM instead.
cudaError_t dispatch(const Args& q, int n, int chunk, int dtype,
                     cudaStream_t st, int* per_sm) {
  if (chunk != CS) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (q.p == 64 && n == 128) return launch_fma<128, 64>(q, st, per_sm);
    if (q.p == 64 && n == 64) return launch_fma<64, 64>(q, st, per_sm);
    if (q.p == 16 && n == 16) return launch_fma<16, 16>(q, st, per_sm);
  } else if (dtype == 1) {
    if (q.p == 64 && n == 128) return launch_mma<128, 32>(q, st, per_sm);
    if (q.p == 64 && n == 64) return launch_mma<64, 32>(q, st, per_sm);
    if (q.p == 16 && n == 16) return launch_mma<16, 16>(q, st, per_sm);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core
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
