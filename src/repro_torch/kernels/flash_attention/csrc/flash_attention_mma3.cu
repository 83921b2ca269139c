// Flash attention forward in float32 on the tensor cores, causal or not,
// with GQA and an optional softcap: flash_mma3_kernel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py (`_flash_kernel` / `flash_attention_bhsd`) together
// with its wrapper ops.flash_attention, for float32 inputs: q (B, S, H, hd)
// and k/v (B, T, KV, hd) in the model layout, query head h reading KV head
// h / (H / KV), queries right-aligned to the key timeline
// (offset = T - S), s = (q . k) * scale, then the optional softcap
// c * tanh(s / c), then keys at or past T and (causal) keys past the query
// set to -1e30; online softmax with m, l and acc in float32, and
// out = acc / max(l, 1e-30), and given an lse buffer (float32 (B, H, S);
// null when serving) each row's log-sum-exp m + log l for the backward
// kernels of flash_attention_bwd.cu.  The TPU kernel's sequential kv grid
// axis is
// a loop inside one CTA; ragged S and T are masked here, so the wrapper
// neither pads nor repeats the KV heads.  hd in {16, 32, 64, 80, 128}.
// bf16 inputs go to the wgmma kernel of flash_attention_wgmma.cu
// (flash_attention_launch below dispatches on the type).
//
// Precision.  A float32 product on the tensor cores is TF32 (about three
// decimal digits), and the float32 serving cuts hold the card to the CPU
// token for token.  So Q, K, V and the probabilities P are split into
// three bf16 pieces hi + mid + lo, and each product sums the six piece
// products that reach float32's rounding, smallest first, one k16 step
// after another on one float32 accumulator (split3 and mma_k of
// mma3.cuh).  tests/test_torch_flash_design.py models this arithmetic in
// plain PyTorch (flash_mma3_model): it lies as close to a float64
// attention as the plain float32 version, and two pieces with three
// products lie 7-31x farther.  Built with --fmad=false like every source of
// the port: the scale, the softmax's exps and the rescales round as
// written, as the model rounds them.
//
// What bounds it on an H100: operations.  The causal slice shape (B 4,
// S = T = 1024, 16 heads over 2, hd 128) is 4 * B * H * hd * 524,800 causal
// pairs = 17.2 GFLOP against 75.5 MB of float32 inputs and output (0.023
// ms at 3.35 TB/s).  Six bf16 products of it are 103.2 GFLOP: 0.104 ms at
// the tensor cores' 989 TFLOP/s, where the FMA pipes would take 0.257 ms
// at 67 TFLOP/s for the 17.2.  zamba2-2.7b's shape (32 heads over 32,
// hd 80): 21.5 GFLOP, 0.130 ms at six products, 0.321 ms on the FMA pipes.
//
// Design.  mma.sync m16n8k16 (bf16 in, float32 accumulators): a warp owns
// 16 query rows of one head; its scores S = Q K^T of a 64-key tile stay in
// registers, where the C-fragment layout of two n8 tiles is the A-fragment
// layout of one k16 step of P V, so P is scaled, masked, exponentiated and
// split into its three pieces in registers, never through shared memory.
//   * A CTA is 8 warps over HG heads of one KV group (HG the largest power
//     of two dividing H / KV, at most 8) and 128 / HG query rows: qwen's
//     G = 8 puts 8 heads on the same 16 rows, zamba2's G = 1 one head on
//     128 rows.  Every warp reads the same K/V tiles.
//   * Q is read from device memory once and split once, into registers
//     (3 pieces x hd / 16 k16 A fragments a thread).
//   * Each K/V tile arrives as float32 by cp.async (16-byte pieces, zero
//     past T) into a staging buffer while the warps compute on the tile
//     before it; then all 256 threads split it once for the CTA into three
//     bf16 planes of K and three of V, read by ldmatrix (K as stored, the
//     B operand of Q K^T; V through .trans, the B operand of P V).  Plane
//     rows are padded to hd + 8 elements, so an ldmatrix's 8 row addresses
//     hit distinct banks.
//   * The six products of a k16 step go out product by product over
//     several accumulators (all 8 n8 tiles of the scores; PV_GROUP pairs
//     of the output's), so that independent mma chains are in flight.
//   * A warp skips the key tiles wholly above its own causal diagonal and
//     a warp past S computes nothing; both still split their share.
//     CTAs are launched heaviest (latest causal) query block first.
// Shared memory at hd 128: six planes 104,448 B + float32 staging 65,536 B
// = 166 KB: one CTA (8 warps) an SM; hd 80 takes 108.5 KB, but its
// registers (Q's 60 and the 40 of the output's accumulators, beside the
// scores' 32) hold it to one CTA too (ptxas: 255 registers at hd 128, a
// few bytes spilled; 254 at hd 80).  Tried on the card and not kept
// (PERF.md): 4-warp CTAs on 32-key tiles, two an SM, were 5% slower;
// 32-key tiles with 8 warps up to 5% faster at hd 128 and 1-3% slower at
// hd 80.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma3.cuh"  // mma, the bf16 pieces, cp.async, ldmatrix

namespace {

constexpr int BK = 64;             // keys a tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int WROWS = 16;          // query rows a warp
constexpr int PV_GROUP = 2;        // n16 column pairs of P V a product step
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of one CTA: K planes hi, mid, lo [BK][LDP] bf16, V planes
// likewise, then the float32 staging of the next K and V tiles [BK][HD].
template <int HD>
struct Mma3Smem {
  static constexpr int LDP = HD + 8;
  static constexpr int PLANE = BK * LDP;       // bf16 elements a plane
  static constexpr size_t oK = 0;
  static constexpr size_t oV = oK + 3 * (size_t)PLANE * 2;
  static constexpr size_t oKf = oV + 3 * (size_t)PLANE * 2;
  static constexpr size_t oVf = oKf + (size_t)BK * HD * 4;
  static constexpr size_t bytes = oVf + (size_t)BK * HD * 4;
  static_assert(HD % 16 == 0, "k16 steps and n8 pairs over the head dim");
  static_assert((LDP / 8) % 2 == 1, "ldmatrix rows on distinct banks");
  static_assert(bytes <= 232448, "shared memory of one block");
};

// Grid: n_qb query blocks x B x (H / HG) head groups, flattened with the
// query block slowest, so that (causal) the heaviest blocks start first.
template <int HD>
__global__ void __launch_bounds__(THREADS, 8 / WARPS)
flash_mma3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int S, int T, int H, int KV,
                  int hg_log, int n_qb, int causal, float softcap,
                  float scale) {
  using L = Mma3Smem<HD>;
  constexpr int LDP = L::LDP, PLANE = L::PLANE;
  constexpr int KS = HD / 16;      // k16 steps of Q K^T
  constexpr int NT = BK / 8;       // n8 tiles of a warp's scores
  constexpr int NO = HD / 8;       // n8 tiles of a warp's output
  constexpr int QUADS = HD / 4;    // 16-byte pieces of a K/V row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* kp = reinterpret_cast<bf16*>(smem + L::oK);
  bf16* vp = reinterpret_cast<bf16*>(smem + L::oV);
  float* kf = reinterpret_cast<float*>(smem + L::oKf);
  float* vf = reinterpret_cast<float*>(smem + L::oVf);

  const int HG = 1 << hg_log;
  const int RQ = WROWS * (WARPS >> hg_log);   // query rows of a head
  const int n_hb = H >> hg_log;
  const int n_bh = gridDim.x / n_qb;
  const int qr = blockIdx.x / n_bh, bh = blockIdx.x % n_bh;
  const int qb = causal ? n_qb - 1 - qr : qr;
  const int b = bh / n_hb, h0 = (bh % n_hb) << hg_log;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = h0 + (warp & (HG - 1));
  const int kvh = h0 / (H / KV);
  const int q0 = qb * RQ;
  const int r0 = q0 + (warp >> hg_log) * WROWS;   // this warp's first row
  const int offset = T - S;
  const bool has_rows = r0 < S;
  // keys past k_end lie above the diagonal of every row of the CTA, keys
  // past w_end above this warp's
  const int last_cta = (q0 + RQ < S ? q0 + RQ : S) - 1;
  const int last_warp = (r0 + WROWS < S ? r0 + WROWS : S) - 1;
  const int k_end = causal ? min(T, last_cta + offset + 1) : T;
  const int w_end = causal ? min(T, last_warp + offset + 1) : T;
  const int n_tiles = (k_end + BK - 1) / BK;

  const int64_t kv_row = (int64_t)KV * HD;      // element stride of a key
  const float* kbase = k + (int64_t)b * T * kv_row + (int64_t)kvh * HD;
  const float* vbase = v + (int64_t)b * T * kv_row + (int64_t)kvh * HD;
  auto stage = [&](int k0) {
    for (int i = tid; i < BK * QUADS; i += THREADS) {
      const int r = i / QUADS, c = (i % QUADS) * 4, t = k0 + r;
      const int64_t off = (int64_t)(t < T ? t : 0) * kv_row + c;
      cp16(kf + r * HD + c, kbase + off, t < T);
      cp16(vf + r * HD + c, vbase + off, t < T);
    }
  };
  if (n_tiles > 0) stage(0);
  cp_commit();

  // Q: this warp's rows g and g + 8, columns 16 ks + 2t (+1, +8, +9),
  // split once into the A fragments of every k16 step
  Frag3 qa[KS];
  {
    const int64_t q_row = (int64_t)H * HD;
    const float* qbase = q + (int64_t)b * S * q_row + (int64_t)h * HD;
    const int ra = r0 + g, rb = ra + 8;
    const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16 + 2 * t4;
      const float2 x0 = ra < S ? *reinterpret_cast<const float2*>(
                                     qbase + ra * q_row + c) : zero;
      const float2 x1 = rb < S ? *reinterpret_cast<const float2*>(
                                     qbase + rb * q_row + c) : zero;
      const float2 x2 = ra < S ? *reinterpret_cast<const float2*>(
                                     qbase + ra * q_row + c + 8) : zero;
      const float2 x3 = rb < S ? *reinterpret_cast<const float2*>(
                                     qbase + rb * q_row + c + 8) : zero;
      split3(x0.x, x0.y, qa[ks].h[0], qa[ks].m[0], qa[ks].l[0]);
      split3(x1.x, x1.y, qa[ks].h[1], qa[ks].m[1], qa[ks].l[1]);
      split3(x2.x, x2.y, qa[ks].h[2], qa[ks].m[2], qa[ks].l[2]);
      split3(x3.x, x3.y, qa[ks].h[3], qa[ks].m[3], qa[ks].l[3]);
    }
  }

  // ldmatrix row addresses of this lane (tile lt = lane / 8, row lr):
  // K as stored [key][hd], tiles (keys 0-7, hd 0-7), (0-7, 8-15),
  // (8-15, 0-7), (8-15, 8-15): b0, b1 of n8 tile 2np, then of 2np + 1.
  // V through .trans, tiles (keys 0-7, hd 0-7), (8-15, 0-7), (0-7, 8-15),
  // (8-15, 8-15): b0, b1 of the output's n8 tile 2np, then of 2np + 1.
  const int lt = lane >> 3, lr = lane & 7;
  const uint32_t k_addr =
      smem_u32(kp) + 2 * ((lr + 8 * (lt >> 1)) * LDP + 8 * (lt & 1));
  const uint32_t v_addr =
      smem_u32(vp) + 2 * ((lr + 8 * (lt & 1)) * LDP + 8 * (lt >> 1));

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    cp_wait<0>();
    __syncthreads();               // tile j staged; tile j - 1's planes read
    for (int i = tid; i < BK * QUADS; i += THREADS) {
      const int dst = (i / QUADS) * LDP + (i % QUADS) * 4;
      const float4 a = reinterpret_cast<const float4*>(kf)[i];
      const float4 c = reinterpret_cast<const float4*>(vf)[i];
      uint32_t h0, m0, l0, h1, m1, l1;
      split3(a.x, a.y, h0, m0, l0);
      split3(a.z, a.w, h1, m1, l1);
      *reinterpret_cast<uint2*>(kp + dst) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(kp + PLANE + dst) = make_uint2(m0, m1);
      *reinterpret_cast<uint2*>(kp + 2 * PLANE + dst) = make_uint2(l0, l1);
      split3(c.x, c.y, h0, m0, l0);
      split3(c.z, c.w, h1, m1, l1);
      *reinterpret_cast<uint2*>(vp + dst) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(vp + PLANE + dst) = make_uint2(m0, m1);
      *reinterpret_cast<uint2*>(vp + 2 * PLANE + dst) = make_uint2(l0, l1);
    }
    __syncthreads();               // planes of tile j ready; staging free
    if (j + 1 < n_tiles) stage(k0 + BK);
    cp_commit();
    if (!has_rows || k0 >= w_end) continue;

    // ---- S = Q K^T: hd / 16 k16 steps, six piece products each ----------
    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      Frag3 kb[NT / 2];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const uint32_t a = k_addr + 2 * (np * 16 * LDP + ks * 16);
        ldsm4(kb[np].h, a);
        ldsm4(kb[np].m, a + 2 * PLANE);
        ldsm4(kb[np].l, a + 4 * PLANE);
      }
#pragma unroll
      for (int kk = 0; kk < 6; ++kk)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          mma_k(kk, sacc[2 * np], qa[ks], kb[np], 0, 1);
          mma_k(kk, sacc[2 * np + 1], qa[ks], kb[np], 2, 3);
        }
    }

    // ---- scale, softcap, mask; online softmax over rows g and g + 8 -----
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t4 + (e & 1);
        const int qpos = r0 + g + 8 * (e >> 1) + offset;
        float x = sacc[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool live = key < T && (!causal || key <= qpos);
        x = live ? x : -1e30f;
        sacc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sacc[n][e] - m_run[e >> 1]);
        sacc[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(FULL, sum[r], 1);
      sum[r] += __shfl_xor_sync(FULL, sum[r], 2);
      l_run[r] = l_run[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[n][0] *= corr[0];
      oacc[n][1] *= corr[0];
      oacc[n][2] *= corr[1];
      oacc[n][3] *= corr[1];
    }

    // ---- O += P V: P's k16 steps split from the score registers ----------
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
      Frag3 pa;
      split3(sacc[2 * s][0], sacc[2 * s][1], pa.h[0], pa.m[0], pa.l[0]);
      split3(sacc[2 * s][2], sacc[2 * s][3], pa.h[1], pa.m[1], pa.l[1]);
      split3(sacc[2 * s + 1][0], sacc[2 * s + 1][1], pa.h[2], pa.m[2],
             pa.l[2]);
      split3(sacc[2 * s + 1][2], sacc[2 * s + 1][3], pa.h[3], pa.m[3],
             pa.l[3]);
#pragma unroll
      for (int n0 = 0; n0 < NO / 2; n0 += PV_GROUP) {
        Frag3 vb[PV_GROUP];
#pragma unroll
        for (int i = 0; i < PV_GROUP && n0 + i < NO / 2; ++i) {
          const uint32_t a = v_addr + 2 * (s * 16 * LDP + (n0 + i) * 16);
          ldsm4t(vb[i].h, a);
          ldsm4t(vb[i].m, a + 2 * PLANE);
          ldsm4t(vb[i].l, a + 4 * PLANE);
        }
#pragma unroll
        for (int kk = 0; kk < 6; ++kk)
#pragma unroll
          for (int i = 0; i < PV_GROUP && n0 + i < NO / 2; ++i) {
            mma_k(kk, oacc[2 * (n0 + i)], pa, vb[i], 0, 1);
            mma_k(kk, oacc[2 * (n0 + i) + 1], pa, vb[i], 2, 3);
          }
      }
    }
  }

  if (!has_rows) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l_run[r], 1e-30f);
    if (lse != nullptr && t4 == 0)
      lse[((int64_t)b * H + h) * S + row] = m_run[r] + logf(l_run[r]);
    float* out = o + (((int64_t)b * S + row) * H + h) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(oacc[n][2 * r] / denom, oacc[n][2 * r + 1] / denom);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, S, T, H, KV;
  int causal;
  float softcap, scale;
};

// log2 of the heads a CTA takes: the largest power of two dividing the
// group size H / KV, at most WARPS.
int heads_log(int G) {
  int lg = 0;
  while ((1 << (lg + 1)) <= WARPS && G % (1 << (lg + 1)) == 0) ++lg;
  return lg;
}

template <int HD>
cudaError_t launch_mma3(const Args& a, cudaStream_t st, int* per_sm) {
  auto kernel = flash_mma3_kernel<HD>;
  constexpr size_t smem = Mma3Smem<HD>::bytes;
  static bool opted_in[64] = {};    // per device, once per process
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !opted_in[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) opted_in[dev] = true;
  }
  if (per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                         THREADS, smem);
  const int lg = heads_log(a.H / a.KV);
  const int rq = WROWS * (WARPS >> lg);
  const int n_qb = (a.S + rq - 1) / rq;
  const int64_t grid = (int64_t)n_qb * a.B * (a.H >> lg);
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, THREADS, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.S,
      a.T, a.H, a.KV, lg, n_qb, a.causal, a.softcap, a.scale);
  return cudaGetLastError();
}

// The float32 instance for head dim hd: launch it, or (per_sm != null)
// report its resident CTAs per SM instead.
cudaError_t dispatch(const Args& a, int hd, cudaStream_t st, int* per_sm) {
  switch (hd) {
    case 16: return launch_mma3<16>(a, st, per_sm);
    case 32: return launch_mma3<32>(a, st, per_sm);
    case 64: return launch_mma3<64>(a, st, per_sm);
    case 80: return launch_mma3<80>(a, st, per_sm);
    case 128: return launch_mma3<128>(a, st, per_sm);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The tensor-core kernel of flash_attention_wgmma.cu (bf16 only).
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int S, int T, int H,
                          int KV, int hd, int causal, float softcap,
                          float scale, cudaStream_t stream);

// dtype: 0 = float32 (this file's three-piece kernel), 1 = bfloat16 (the
// wgmma kernel).  lse: null, or float32 (B, H, S) for each row's
// log-sum-exp.  Returns cudaGetLastError() after the launch (or the error
// that refused it).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int S, int T, int H, int KV,
                                      int hd, int causal, float softcap,
                                      float scale, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Args a{q, k, v, o, static_cast<float*>(lse), B, S, T, H, KV,
                 causal, softcap, scale};
    return (int)dispatch(a, hd, st, nullptr);
  }
  if (dtype == 1)
    return flash_attention_wgmma(q, k, v, o, static_cast<float*>(lse), B, S,
                                 T, H, KV, hd, causal, softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}

// CTAs of the float32 kernel at head dim hd resident on one SM (the
// occupancy the design counts on), or -1 where there is no such instance.
extern "C" int flash_attention_blocks_per_sm(int hd) {
  const Args a{};
  int per_sm = -1;
  if (dispatch(a, hd, nullptr, &per_sm) != cudaSuccess) return -1;
  return per_sm;
}
