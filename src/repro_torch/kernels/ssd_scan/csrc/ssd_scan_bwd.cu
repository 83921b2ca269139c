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
// Walking the chunks in reverse with dS1 (the next chunk's dS0, or dstate):
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
// Design: ssd_bwd_kernel, one CTA of 256 threads per (16-wide slice of the
// head dim, head, batch row), every product on the FMA pipes in float32
// (explicit fmaf: the build passes --fmad=false) with the operands staged
// in shared memory as float32, so one code path serves bf16 and float32
// and float32 keeps its accuracy without splitting operands into pieces.
// A simple kernel, right first: the chunk-square products run over the
// full square with the upper triangle's factors zero, and the CTAs of one
// (b, h) each recompute G.  Shared memory holds the chunk's B and C
// (CS x N), M (then Wd) (CS x CS), x and dy for the slice and the
// carried dS slice: 231,560 bytes at N 128, one CTA per SM.
//   * First the CTA walks the chunks forward to recompute each chunk's
//     entering state (its slice of S), written to a float32 scratch;
//     with one chunk (l <= 128) there is nothing to walk: S0 is the
//     initial state.
//   * Then the reverse walk, dS in shared memory from chunk to chunk.
//   * Sums over the head dim (dB, dC, dcum and what comes from it: ddt,
//     dA) are partials of the slice; dB and dC are summed over the heads
//     of a group and the slices, ddt over the slices, dA over (batch row,
//     slice) by ssd_bwd_sum_kernel in a fixed order, with no atomics: two
//     calls give the same bits.
// What bounds it on an H100: at mamba2-1.3b's training shape (B 8, L 128,
// H 64, P 64, G 1, N 128) the gradient needs ~9.7 GFLOP against ~27 MB of
// inputs and outputs, ~0.010 ms at the tensor cores' rate (0.145 ms on the
// FMA pipes' 67 TFLOP/s); this kernel does its products on the FMA pipes
// over full squares, each G four times (once per slice), and took 1.43 ms
// there (PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CS = 128;          // chunk length (ssm_chunk)
constexpr int PT = 16;           // head-dim slice of a CTA
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == 16 * 16, "16 x 16 thread tiles");
static_assert(PT == 16, "the slice's rows are the thread rows of dS");

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// sum over the 16 lanes of a half-warp (xor 8, 4, 2, 1: a fixed tree)
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int N>
struct Smem {
  static constexpr int LDN = N + 1;        // B/C and dS rows, padded
  static constexpr int LDP = PT + 1;       // x and dy rows, padded
  static constexpr int B = 0;
  static constexpr int C = B + CS * LDN;
  static constexpr int M = C + CS * LDN;   // CS x CS, unpadded
  static constexpr int X = M + CS * CS;
  static constexpr int DY = X + CS * LDP;
  static constexpr int DS = DY + CS * LDP;
  static constexpr int DT = DS + PT * LDN;
  static constexpr int CUM = DT + CS;
  static constexpr int ECUM = CUM + CS;
  static constexpr int EDEC = ECUM + CS;
  static constexpr int ROWQ = EDEC + CS;   // sum_j Q_kj
  static constexpr int RQ = ROWQ + CS;     // R_k
  static constexpr int TQ = RQ + CS;       // T_k
  static constexpr int XDU = TQ + CS;      // sum_p du x
  static constexpr int COLQ = XDU + CS;    // WARPS x CS column partials
  static constexpr int RED = COLQ + WARPS * CS;
  static constexpr int FLOATS = RED + 2 * WARPS + 2;
  static constexpr size_t bytes = sizeof(float) * FLOATS;
};
static_assert(Smem<128>::bytes <= 232448, "one CTA's shared memory");

struct Args {
  const void *x, *dt, *A, *B, *C;
  int64_t bc_row;
  const float *init, *dstate;
  const void* dy;
  void* dx;
  float *dinit, *states, *part_bc, *part_dt, *part_a;
  int b, l, h, g, p;
};

// One warp: cum, exp(cum) and exp(E - cum) of the chunk (4 positions a
// lane, then a shuffle scan, as the forward's chunk_cumsum), E kept in
// red[2 * WARPS].
__device__ __forceinline__ void chunk_cumsum(float* sm, int base, float a,
                                             int red) {
  const int lane = threadIdx.x & 31;
  float* dts = sm + base;
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    run = run + dts[lane * 4 + u] * a;
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
  const float tot = __shfl_sync(FULL, excl + v[3], 31);
  float* cum = dts + CS;
  float* ecum = cum + CS;
  float* edec = ecum + CS;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = lane * 4 + u;
    const float ci = excl + v[u];
    cum[i] = ci;
    ecum[i] = expf(ci);
    edec[i] = expf(tot - ci);
  }
  if (lane == 0) sm[red] = tot;
}

// Stage chunk c: dt, the slice of x (and of dy), B (and C) rows as float32,
// zeros at and past l.
template <typename E, int N>
__device__ void stage(const Args& a, float* sm, int c, int bi, int hh, int hg,
                      int p0, bool full) {
  using S = Smem<N>;
  const int t = threadIdx.x;
  const int64_t row0 = (int64_t)bi * a.l;
  for (int i = t; i < CS; i += THREADS) {
    const int pos = c * CS + i;
    sm[S::DT + i] = pos < a.l
        ? static_cast<const float*>(a.dt)[(row0 + pos) * a.h + hh] : 0.f;
  }
  for (int e = t; e < CS * PT; e += THREADS) {
    const int i = e / PT, q = e % PT;
    const int pos = c * CS + i;
    const int64_t off = ((row0 + pos) * a.h + hh) * a.p + p0 + q;
    const bool in = pos < a.l;
    sm[S::X + i * S::LDP + q] =
        in ? ld(static_cast<const E*>(a.x) + off) : 0.f;
    if (full)
      sm[S::DY + i * S::LDP + q] =
          in ? ld(static_cast<const E*>(a.dy) + off) : 0.f;
  }
  for (int e = t; e < CS * N; e += THREADS) {
    const int i = e / N, q = e % N;
    const int pos = c * CS + i;
    const int64_t off = (row0 + pos) * a.bc_row + (int64_t)hg * N + q;
    const bool in = pos < a.l;
    sm[S::B + i * S::LDN + q] =
        in ? ld(static_cast<const E*>(a.B) + off) : 0.f;
    if (full)
      sm[S::C + i * S::LDN + q] =
          in ? ld(static_cast<const E*>(a.C) + off) : 0.f;
  }
}

template <typename E, int N>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_kernel(const Args a) {
  using S = Smem<N>;
  constexpr int NQ = N / 16;               // a thread's columns of N
  extern __shared__ float sm[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tx = t & 15, ty = t >> 4;
  const int s = blockIdx.x, hh = blockIdx.y, bi = blockIdx.z;
  const int slices = a.p / PT, p0 = s * PT;
  const int hg = hh / (a.h / a.g), hl = hh % (a.h / a.g);
  const int nc = (a.l + CS - 1) / CS;
  const float A = static_cast<const float*>(a.A)[hh];
  const int64_t bh = (int64_t)bi * a.h + hh;
  float* dS = sm + S::DS;                  // [PT][LDN]
  const int E_AT = S::RED + 2 * WARPS;     // the chunk's E

  // ---- forward walk: the entering state of chunks 1 .. nc-1 -------------
  if (nc > 1) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int n = tx + 16 * q;
      dS[ty * S::LDN + n] = a.init != nullptr
          ? a.init[(bh * a.p + p0 + ty) * N + n] : 0.f;
    }
    for (int c = 0; c + 1 < nc; ++c) {
      __syncthreads();
      stage<E, N>(a, sm, c, bi, hh, hg, p0, false);
      __syncthreads();
      if (warp == 0) chunk_cumsum(sm, S::DT, A, E_AT);
      __syncthreads();
      const float eE = expf(sm[E_AT]);
      float acc[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
      for (int j = 0; j < CS; ++j) {
        const float w = sm[S::X + j * S::LDP + ty] * sm[S::DT + j]
            * sm[S::EDEC + j];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          acc[q] = fmaf(w, sm[S::B + j * S::LDN + tx + 16 * q], acc[q]);
      }
      float* out = a.states + ((bh * nc + c + 1) * a.p + p0 + ty) * N;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int n = tx + 16 * q;
        const float v = fmaf(eE, dS[ty * S::LDN + n], acc[q]);
        dS[ty * S::LDN + n] = v;
        out[n] = v;
      }
    }
  }

  // ---- reverse walk -----------------------------------------------------
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int n = tx + 16 * q;
    dS[ty * S::LDN + n] = a.dstate != nullptr
        ? a.dstate[(bh * a.p + p0 + ty) * N + n] : 0.f;
  }
  float dA_acc = 0.f;
  const int64_t blN = (int64_t)a.b * a.l * N;
  float* pB = a.part_bc
      + ((int64_t)hg * (a.h / a.g) * slices + hl * slices + s) * blN;
  float* pC = pB + (int64_t)a.g * (a.h / a.g) * slices * blN;
  for (int c = nc - 1; c >= 0; --c) {
    __syncthreads();
    stage<E, N>(a, sm, c, bi, hh, hg, p0, true);
    __syncthreads();
    if (warp == 0) chunk_cumsum(sm, S::DT, A, E_AT);
    __syncthreads();
    const float eE = expf(sm[E_AT]);
    // the entering state (float32, this slice's rows); null: zero
    const float* S0 = c == 0
        ? (a.init != nullptr ? a.init + (bh * a.p + p0) * N : nullptr)
        : a.states + ((bh * nc + c) * a.p + p0) * N;

    // (1) M = (C B^T) o L, the full square, zero above the diagonal
    {
      float acc[8][8];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;
#pragma unroll 2
      for (int k = 0; k < N; ++k) {
        float av[8], bv[8];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          av[m] = sm[S::C + (ty + 16 * m) * S::LDN + k];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          bv[n] = sm[S::B + (tx + 16 * n) * S::LDN + k];
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int i = ty + 16 * m;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int j = tx + 16 * n;
          sm[S::M + i * CS + j] = i >= j
              ? acc[m][n] * expf(sm[S::CUM + i] - sm[S::CUM + j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // (2) du = M^T dy + e^{E - cum} dS1 B: dx, sum_p du x, T
    {
      float acc[8], hv[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) acc[m] = hv[m] = 0.f;
#pragma unroll 2
      for (int i = 0; i < CS; ++i) {
        const float d = sm[S::DY + i * S::LDP + tx];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          acc[m] = fmaf(sm[S::M + i * CS + ty + 16 * m], d, acc[m]);
      }
#pragma unroll 2
      for (int k = 0; k < N; ++k) {
        const float d = dS[tx * S::LDN + k];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          hv[m] = fmaf(sm[S::B + (ty + 16 * m) * S::LDN + k], d, hv[m]);
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int j = ty + 16 * m;
        const int pos = c * CS + j;
        const float du = fmaf(sm[S::EDEC + j], hv[m], acc[m]);
        const float xv = sm[S::X + j * S::LDP + tx];
        if (pos < a.l)
          st(static_cast<E*>(a.dx)
                 + (((int64_t)bi * a.l + pos) * a.h + hh) * a.p + p0 + tx,
             du * sm[S::DT + j]);
        const float sx = half_sum(du * xv);
        const float sh = half_sum(xv * hv[m]);
        if (tx == 0) {
          sm[S::XDU + j] = sx;
          sm[S::TQ + j] = sm[S::EDEC + j] * sm[S::DT + j] * sh;
        }
      }
    }
    __syncthreads();

    // (3) W = dy u^T: Q = M o W (row and column sums), M <- Wd = W o L
    {
      float acc[8][8];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;
#pragma unroll 4
      for (int k = 0; k < PT; ++k) {
        float av[8], bv[8];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          av[m] = sm[S::DY + (ty + 16 * m) * S::LDP + k];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          bv[n] = sm[S::X + (tx + 16 * n) * S::LDP + k];
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
      }
      float col[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) col[n] = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int i = ty + 16 * m;
        float row = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int j = tx + 16 * n;
          float* mp = sm + S::M + i * CS + j;
          const float w = acc[m][n] * sm[S::DT + j];
          float q = 0.f, wd = 0.f;
          if (i >= j) {
            q = *mp * w;
            wd = w * expf(sm[S::CUM + i] - sm[S::CUM + j]);
          }
          *mp = wd;
          row += q;
          col[n] += q;
        }
        row = half_sum(row);
        if (tx == 0) sm[S::ROWQ + i] = row;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float v = col[n] + __shfl_xor_sync(FULL, col[n], 16);
        if (lane < 16) sm[S::COLQ + warp * CS + tx + 16 * n] = v;
      }
    }
    __syncthreads();

    // (4) dC = Wd B + e^{cum} S0^T dy, and R
    {
      float acc[8][NQ];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[m][q] = 0.f;
      if (S0 != nullptr) {
        for (int k = 0; k < PT; ++k) {
          float sv[NQ];
#pragma unroll
          for (int q = 0; q < NQ; ++q) sv[q] = S0[k * N + tx + 16 * q];
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const float d = sm[S::DY + (ty + 16 * m) * S::LDP + k];
#pragma unroll
            for (int q = 0; q < NQ; ++q) acc[m][q] = fmaf(d, sv[q], acc[m][q]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int i = ty + 16 * m;
        float r = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          r = fmaf(sm[S::C + i * S::LDN + tx + 16 * q], acc[m][q], r);
        r = half_sum(r);
        const float ec = sm[S::ECUM + i];
        if (tx == 0) sm[S::RQ + i] = ec * r;
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[m][q] *= ec;
      }
#pragma unroll 2
      for (int j = 0; j < CS; ++j) {
        float bv[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) bv[q] = sm[S::B + j * S::LDN + tx + 16 * q];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float w = sm[S::M + (ty + 16 * m) * CS + j];
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[m][q] = fmaf(w, bv[q], acc[m][q]);
        }
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int pos = c * CS + ty + 16 * m;
        if (pos < a.l) {
          float* o = pC + ((int64_t)bi * a.l + pos) * N + tx;
#pragma unroll
          for (int q = 0; q < NQ; ++q) o[16 * q] = acc[m][q];
        }
      }
    }

    // (5) dB = Wd^T C + e^{E - cum} dt dS1^T x
    {
      float acc[8][NQ];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[m][q] = 0.f;
      for (int k = 0; k < PT; ++k) {
        float sv[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) sv[q] = dS[k * S::LDN + tx + 16 * q];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float xv = sm[S::X + (ty + 16 * m) * S::LDP + k];
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[m][q] = fmaf(xv, sv[q], acc[m][q]);
        }
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int j = ty + 16 * m;
        const float f = sm[S::EDEC + j] * sm[S::DT + j];
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[m][q] *= f;
      }
#pragma unroll 2
      for (int i = 0; i < CS; ++i) {
        float cv[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) cv[q] = sm[S::C + i * S::LDN + tx + 16 * q];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float w = sm[S::M + i * CS + ty + 16 * m];
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[m][q] = fmaf(w, cv[q], acc[m][q]);
        }
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int pos = c * CS + ty + 16 * m;
        if (pos < a.l) {
          float* o = pB + ((int64_t)bi * a.l + pos) * N + tx;
#pragma unroll
          for (int q = 0; q < NQ; ++q) o[16 * q] = acc[m][q];
        }
      }
    }
    __syncthreads();

    // (6) dS0 = e^E dS1 + (dy o e^{cum})^T C, in place; <dS1, S0>
    {
      float acc[NQ];
      float dot = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        acc[q] = 0.f;
        if (S0 != nullptr)
          dot = fmaf(dS[ty * S::LDN + tx + 16 * q], S0[ty * N + tx + 16 * q],
                     dot);
      }
#pragma unroll 2
      for (int i = 0; i < CS; ++i) {
        const float d = sm[S::DY + i * S::LDP + ty] * sm[S::ECUM + i];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          acc[q] = fmaf(d, sm[S::C + i * S::LDN + tx + 16 * q], acc[q]);
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float* ds = dS + ty * S::LDN + tx + 16 * q;
        *ds = fmaf(eE, *ds, acc[q]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
      if (lane == 0) sm[S::RED + warp] = dot;
    }
    __syncthreads();

    // (7) dcum, its reverse cumulative sum da, ddt and dA (one warp)
    if (warp == 0) {
      float dot = 0.f;
      for (int w = 0; w < WARPS; ++w) dot += sm[S::RED + w];
      float dc[4], tp[4];
      float trun = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = lane * 4 + u;
        float colq = 0.f;
        for (int w = 0; w < WARPS; ++w) colq += sm[S::COLQ + w * CS + k];
        dc[u] = sm[S::ROWQ + k] - colq + sm[S::RQ + k];
        tp[u] = trun;                      // T over the lane's positions < k
        trun += sm[S::TQ + k];
      }
      if (lane == 31) dc[3] += eE * dot;
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
      for (int u = 3; u >= 0; --u) {
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
      for (int u = 0; u < 4; ++u) {
        const int k = lane * 4 + u;
        const float da = (dc[u] + above) + (tp[u] + tbelow);
        const int pos = c * CS + k;
        if (pos < a.l)
          a.part_dt[(((int64_t)s * a.b + bi) * a.l + pos) * a.h + hh] =
              fmaf(A, da, sm[S::XDU + k]);
        da_dt = fmaf(sm[S::DT + k], da, da_dt);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) da_dt += __shfl_xor_sync(FULL, da_dt, o);
      dA_acc += da_dt;
    }
  }

  __syncthreads();
  if (a.dinit != nullptr) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int n = tx + 16 * q;
      a.dinit[(bh * a.p + p0 + ty) * N + n] = dS[ty * S::LDN + n];
    }
  }
  if (t == 0) a.part_a[((int64_t)s * a.b + bi) * a.h + hh] = dA_acc;
}

// The fixed-order sums, one output element a thread: blockIdx.y 0 dB and
// 1 dC (over the heads of the group and the slices), 2 ddt (over the
// slices), 3 dA (over the batch rows and slices).
template <typename E>
__global__ void __launch_bounds__(256) ssd_bwd_sum_kernel(
    const float* part_bc, const float* part_dt, const float* part_a, E* dB,
    E* dC, float* ddt, float* dA, int b, int l, int h, int g, int n,
    int slices) {
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int which = blockIdx.y;
  const int64_t rows = (int64_t)b * l;
  if (which < 2) {
    if (o >= rows * g * n) return;
    const int64_t r = o / ((int64_t)g * n);
    const int gg = (int)((o / n) % g), nn = (int)(o % n);
    const int T = (h / g) * slices;
    const float* src = part_bc + ((int64_t)(which * g + gg) * T) * rows * n
        + r * n + nn;
    float v = 0.f;
    for (int t = 0; t < T; ++t) v += src[(int64_t)t * rows * n];
    st((which == 0 ? dB : dC) + o, v);
  } else if (which == 2) {
    const int64_t count = rows * h;
    if (o >= count) return;
    float v = 0.f;
    for (int t = 0; t < slices; ++t) v += part_dt[(int64_t)t * count + o];
    ddt[o] = v;
  } else {
    if (o >= h) return;
    float v = 0.f;
    for (int t = 0; t < slices * b; ++t) v += part_a[(int64_t)t * h + o];
    dA[o] = v;
  }
}

template <typename E, int N>
cudaError_t launch(const Args& q, float* dB, float* dC, float* ddt,
                   float* dA, cudaStream_t st) {
  auto kernel = ssd_bwd_kernel<E, N>;
  constexpr size_t smem = Smem<N>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int slices = q.p / PT;
  kernel<<<dim3(slices, q.h, q.b), THREADS, smem, st>>>(q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t rows = (int64_t)q.b * q.l;
  int64_t most = rows * q.g * N;
  if (rows * q.h > most) most = rows * q.h;
  if (q.h > most) most = q.h;
  const unsigned blocks = (unsigned)((most + 255) / 256);
  ssd_bwd_sum_kernel<E><<<dim3(blocks, 4), 256, 0, st>>>(
      q.part_bc, q.part_dt, q.part_a, reinterpret_cast<E*>(dB),
      reinterpret_cast<E*>(dC), ddt, dA, q.b, q.l, q.h, q.g, N, slices);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of x, dy, B, C, dx, dB and dC.  init,
// dstate, dinit and states may be null (zeros; no dinit; one chunk).
// bc_row is the element stride between the (batch, position) rows of B
// and of C.  The scratch: states (b, h, nc, p, n), part_bc (2, g, h / g,
// p / 16, b, l, n), part_dt (p / 16, b, l, h), part_a (p / 16, b, h), all
// float32.  Returns cudaGetLastError() after the launches (or the error
// that refused them).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, int64_t bc_row, const void* init, const void* dy,
    const void* dstate, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* dinit, void* states, void* part_bc, void* part_dt, void* part_a,
    int b, int l, int h, int g, int p, int n, int chunk, int dtype,
    void* stream) {
  if (b == 0 || h == 0) return 0;
  if (g <= 0 || h % g != 0 || chunk != CS || p % PT != 0 || p == 0)
    return (int)cudaErrorInvalidValue;
  const Args q{x, dt, A, B, C, bc_row,
               static_cast<const float*>(init),
               static_cast<const float*>(dstate), dy, dx,
               static_cast<float*>(dinit), static_cast<float*>(states),
               static_cast<float*>(part_bc), static_cast<float*>(part_dt),
               static_cast<float*>(part_a), b, l, h, g, p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ddt_ = static_cast<float*>(ddt);
  float* dA_ = static_cast<float*>(dA);
  float* dB_ = static_cast<float*>(dB);
  float* dC_ = static_cast<float*>(dC);
  if (dtype == 0) {
    if (n == 128) return (int)launch<float, 128>(q, dB_, dC_, ddt_, dA_, st);
    if (n == 64) return (int)launch<float, 64>(q, dB_, dC_, ddt_, dA_, st);
    if (n == 16) return (int)launch<float, 16>(q, dB_, dC_, ddt_, dA_, st);
  } else if (dtype == 1) {
    if (n == 128) return (int)launch<bf16, 128>(q, dB_, dC_, ddt_, dA_, st);
    if (n == 64) return (int)launch<bf16, 64>(q, dB_, dC_, ddt_, dA_, st);
    if (n == 16) return (int)launch<bf16, 16>(q, dB_, dC_, ddt_, dA_, st);
  }
  return (int)cudaErrorInvalidValue;
}
