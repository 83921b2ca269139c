// Mamba2 SSD (state-space dual) chunked scan, forward, with the final state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py
// (`_ssd_kernel` / `ssd_scan`) together with its wrapper ops.ssd and the
// final state of ref.ssd_reference: x (b, l, h, p) in the model's type,
// dt (b, l, h) and A (h,) float32, B/C (b, l, g, n) in the model's type
// (rows of B and C may be strided views of one projection), an optional
// float32 initial state (b, h, p, n).  Per (b, h) and chunk of CS
// positions, all in float32:
//   cum   = cumsum(dt * A)                        (within the chunk)
//   L_ij  = exp(cum_i - cum_j) for i >= j, else 0
//   y     = (C B^T o L) (x dt) + exp(cum) o (C S_prev^T)
//   S     = exp(cum_end) S_prev + ((x dt) o exp(cum_end - cum))^T B
// y is rounded once to the model's type; S after the last chunk is the
// final state.  The wrapper's work happens here: B and C are read for
// group h / (h_total / g) and never repeated per head, x dt is formed in
// float32 from the model-type x (ref.py: xdt = x.astype(f32) * dt), and a
// position at or past l acts as dt = 0, x = 0 (what the reference's zero
// padding does), so the final state equals the padded reference's and
// nothing is padded.
//
// Design.  The TPU's sequential chunk axis becomes a loop inside one CTA of
// 256 threads per (b, h); the state stays in shared memory between chunks.
// Per chunk the CTA stages x dt as X [CS][P] and B, C transposed as
// Bt, Ct [N][CS] in float32 (rows padded by 4 floats: float4-aligned, and
// the row-strided float4 reads of the state update hit distinct banks),
// then runs four register-tiled products on the FMA pipes, thread (ty, tx)
// of a 16 x 16 grid owning 4-row groups ty*4 + 64a and 4-column groups
// tx*4 (+ 64b):
//   1. y  = C S^T, scaled by exp(cum) per row        (k over N)
//   2. S' = exp(cum_end) S + (X o decay)^T B          (i over CS; own
//      elements in registers, written back after a barrier)
//   3. scores = C B^T in registers (k over N), then P = scores o L is
//      written over Bt/Ct, which are dead by then
//   4. y += P X                                       (j over CS, j <= i)
// Shared memory at CS 128, N 128, P 64 is 206 KB (X 34, Bt 68, Ct 68,
// S 34, cum/exp vectors 1.5): one CTA per SM.  Holding everything in
// shared memory as float32 at once would need 256 KB (the issue's count);
// keeping the scores in registers and laying P over the dead B/C tiles
// brings it under the 227 KB limit for float32 and bf16 alike.  The
// exponent is always taken of a difference (cum_i - cum_j,
// cum_end - cum_i), never a ratio of two exponentials.
//
// What bounds it on an H100: bytes in bf16.  mamba2-1.3b's prefill of
// B 4 x L 1024 (H 64, P 64, G 1, N 128, CS 128) needs 15.1 GFLOP (the
// causal half of the chunk-square products, 21.5 counting full squares)
// against 78.5 MB (bf16 x and y, float32 dt and final state, bf16 B/C per
// group): 23 us at 3.35 TB/s against 15 us at the tensor cores' 989
// TFLOP/s.  In float32 the bound is the FMA pipes' 67 TFLOP/s (0.23 ms).
// This first kernel multiplies on the FMA pipes (fmaf; the port builds
// every source with --fmad=false, so the FMAs are written out), so it
// cannot come near the bf16 bound: wgmma tiles fed by TMA are the later
// step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int P = 64;             // head dim (ssm_head_dim)
constexpr int LDP = P + 4;        // row stride of X and St
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename E> __device__ __forceinline__ E from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int CS, int N>
struct Smem {
  static constexpr int LDC = CS + 4;     // row stride of Bt, Ct and P
  static constexpr int kX = CS * LDP;    // X  [CS][LDP]
  static constexpr int kB = N * LDC;     // Bt [N][LDC], then Ct
  static constexpr int kS = N * LDP;     // St [N][LDP]: St[k][pp] = S[pp][k]
  static constexpr int kVec = 3 * CS;    // cum, exp(cum), exp(cum_end - cum)
  static constexpr size_t bytes =
      (size_t)(kX + 2 * kB + kS + kVec) * sizeof(float);
  static_assert(CS % 64 == 0 && N % 16 == 0, "tile shapes");
  static_assert(CS * LDC <= 2 * kB, "P [CS][LDC] must fit over Bt and Ct");
  static_assert(bytes <= 232448, "shared memory of one block");
};

template <typename E, int CS, int N>
__global__ void __launch_bounds__(THREADS, 1)
ssd_kernel(const E* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const E* __restrict__ Bm,
           const E* __restrict__ Cm, int64_t bc_row,
           const float* __restrict__ init, E* __restrict__ y,
           float* __restrict__ fstate, int L, int H, int G) {
  using S = Smem<CS, N>;
  constexpr int LDC = S::LDC;
  constexpr int RA = CS / 64;      // 64-row groups of the chunk
  constexpr int NQ = N / 16;       // state columns per thread (k = tx + 16q)
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);
  float* Bt = X + S::kX;
  float* Ct = Bt + S::kB;
  float* Pm = Bt;                  // P [CS][LDC] over Bt and Ct
  float* St = Ct + S::kB;
  float* cum = St + S::kS;
  float* ecum = cum + CS;
  float* dec = ecum + CS;

  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float a = A[h];
  const int64_t sbase = ((int64_t)b * H + h) * P * N;

  for (int i = tid; i < P * N; i += THREADS)
    St[(i % N) * LDP + i / N] = init != nullptr ? init[sbase + i] : 0.f;

  const int nc = (L + CS - 1) / CS;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * CS;
    __syncthreads();               // last chunk's P and X reads are done

    // ---- stage x dt, B, C; cumulative sums of dt A (warp 0) -------------
    for (int i = tid; i < CS * P; i += THREADS) {
      const int r = i / P, col = i % P, t = t0 + r;
      float v = 0.f;
      if (t < L) {
        const int64_t row = ((int64_t)b * L + t) * H + h;
        v = to_f(x[row * P + col]) * dt[row];
      }
      X[r * LDP + col] = v;
    }
    for (int i = tid; i < CS * N; i += THREADS) {
      const int r = i / N, k = i % N, t = t0 + r;
      float bv = 0.f, cv = 0.f;
      if (t < L) {
        const int64_t off = ((int64_t)b * L + t) * bc_row + (int64_t)grp * N
                            + k;
        bv = to_f(Bm[off]);
        cv = to_f(Cm[off]);
      }
      Bt[k * LDC + r] = bv;
      Ct[k * LDC + r] = cv;
    }
    if (tid < 32) {
      constexpr int PER = CS / 32;
      float v[PER];
      float run = 0.f;
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int t = t0 + tid * PER + u;
        const float d = t < L ? dt[((int64_t)b * L + t) * H + h] : 0.f;
        run = run + d * a;
        v[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, incl, off);
        if (tid >= off) incl = o + incl;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (tid == 0) excl = 0.f;
      const float tot = __shfl_sync(FULL, excl + v[PER - 1], 31);
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = tid * PER + u;
        const float ci = excl + v[u];
        cum[i] = ci;
        ecum[i] = expf(ci);
        dec[i] = expf(tot - ci);
      }
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
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      const float4 sv = ld4(&St[k * LDP + tx * 4]);
#pragma unroll
      for (int ra = 0; ra < RA; ++ra) {
        const float4 cv = ld4(&Ct[k * LDC + 64 * ra + ty * 4]);
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
        const float e = ecum[64 * ra + ty * 4 + r];
#pragma unroll
        for (int q = 0; q < 4; ++q) yacc[ra][r][q] = yacc[ra][r][q] * e;
      }

    // ---- 2. S' = exp(cum_end) S + (X o decay)^T B -------------------------
    {
      float snew[4][NQ];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q) snew[r][q] = 0.f;
#pragma unroll 2
      for (int i0 = 0; i0 < CS; i0 += 4) {
        const float4 d4 = ld4(&dec[i0]);
        float xd[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 xv = ld4(&X[(i0 + u) * LDP + ty * 4]);
          const float du = at(d4, u);
#pragma unroll
          for (int r = 0; r < 4; ++r) xd[u][r] = at(xv, r) * du;
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 bv = ld4(&Bt[(tx + 16 * q) * LDC + i0]);
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
          snew[r][q] = St[(tx + 16 * q) * LDP + ty * 4 + r] * etot
                       + snew[r][q];
      __syncthreads();             // every read of the old state is done
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          St[(tx + 16 * q) * LDP + ty * 4 + r] = snew[r][q];
    }

    // ---- 3. P = (C B^T) o L -------------------------------------------------
    {
      float sc[RA][4][RA][4];
#pragma unroll
      for (int ra = 0; ra < RA; ++ra)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int rb = 0; rb < RA; ++rb)
#pragma unroll
            for (int q = 0; q < 4; ++q) sc[ra][r][rb][q] = 0.f;
#pragma unroll 2
      for (int k = 0; k < N; ++k) {
        float4 cv[RA], bv[RA];
#pragma unroll
        for (int ra = 0; ra < RA; ++ra) {
          cv[ra] = ld4(&Ct[k * LDC + 64 * ra + ty * 4]);
          bv[ra] = ld4(&Bt[k * LDC + 64 * ra + tx * 4]);
        }
#pragma unroll
        for (int ra = 0; ra < RA; ++ra)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int rb = 0; rb < RA; ++rb)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                sc[ra][r][rb][q] = fmaf(at(cv[ra], r), at(bv[rb], q),
                                        sc[ra][r][rb][q]);
      }
      __syncthreads();             // Bt and Ct are dead: P goes over them
#pragma unroll
      for (int ra = 0; ra < RA; ++ra)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 64 * ra + ty * 4 + r;
          const float ci = cum[i];
#pragma unroll
          for (int rb = 0; rb < RA; ++rb) {
            float4 pv;
            float* pw = reinterpret_cast<float*>(&pv);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int j = 64 * rb + tx * 4 + q;
              pw[q] = i >= j ? sc[ra][r][rb][q] * expf(ci - cum[j]) : 0.f;
            }
            *reinterpret_cast<float4*>(&Pm[i * LDC + 64 * rb + tx * 4]) = pv;
          }
        }
      __syncthreads();
    }

    // ---- 4. y += P X (columns j <= the thread's last row) ------------------
    const int jend = 64 * (RA - 1) + ty * 4 + 4;
    for (int j0 = 0; j0 < jend; j0 += 4) {
      float4 xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) xv[u] = ld4(&X[(j0 + u) * LDP + tx * 4]);
#pragma unroll
      for (int ra = 0; ra < RA; ++ra)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 pv = ld4(&Pm[(64 * ra + ty * 4 + r) * LDC + j0]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              yacc[ra][r][q] = fmaf(at(pv, u), at(xv[u], q), yacc[ra][r][q]);
        }
    }

#pragma unroll
    for (int ra = 0; ra < RA; ++ra)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + 64 * ra + ty * 4 + r;
        if (t >= L) continue;
        E* out = y + (((int64_t)b * L + t) * H + h) * P + tx * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q] = from_f<E>(yacc[ra][r][q]);
      }
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS)
    fstate[sbase + i] = St[(i % N) * LDP + i / N];
}

template <typename E, int CS, int N>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, int64_t bc_row, const void* init, void* y,
           void* fstate, int b, int l, int h, int g, cudaStream_t stream) {
  constexpr size_t smem = Smem<CS, N>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<E, CS, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(h, b);
  ssd_kernel<E, CS, N><<<grid, THREADS, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const E*>(B),
      static_cast<const E*>(C), bc_row, static_cast<const float*>(init),
      static_cast<E*>(y), static_cast<float*>(fstate), l, h, g);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(const void* x, const void* dt, const void* A, const void* B,
             const void* C, int64_t bc_row, const void* init, void* y,
             void* fstate, int b, int l, int h, int g, int n, int chunk,
             cudaStream_t st) {
  if (chunk != 128) return (int)cudaErrorInvalidValue;
  if (n == 128)
    return launch<E, 128, 128>(x, dt, A, B, C, bc_row, init, y, fstate, b, l,
                               h, g, st);
  if (n == 64)
    return launch<E, 128, 64>(x, dt, A, B, C, bc_row, init, y, fstate, b, l,
                              h, g, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, B, C and y).  init may be null
// (a zero initial state).  bc_row is the element stride between the
// (batch, position) rows of B and of C.  Returns cudaGetLastError() after
// the launch (or the error that refused it).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, int64_t bc_row,
                               const void* init, void* y, void* fstate,
                               int b, int l, int h, int g, int p, int n,
                               int chunk, int dtype, void* stream) {
  if (b == 0 || h == 0) return 0;
  if (p != P || g <= 0 || h % g != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, dt, A, B, C, bc_row, init, y, fstate, b, l, h,
                           g, n, chunk, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, A, B, C, bc_row, init, y, fstate,
                                   b, l, h, g, n, chunk, st);
  return (int)cudaErrorInvalidValue;
}
