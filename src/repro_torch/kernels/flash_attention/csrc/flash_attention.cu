// Flash attention forward in float32, causal or not, with GQA and an
// optional softcap, on the FMA pipes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py (`_flash_kernel` / `flash_attention_bhsd`) together
// with its wrapper ops.flash_attention, for float32 inputs: q (B, S, H, hd)
// and k/v (B, T, KV, hd) in the model layout, query head h reading KV head
// h / (H / KV), queries right-aligned to the key timeline
// (offset = T - S), keys at or past T masked, scores that are masked set to
// -1e30, out = acc / max(l, 1e-30).  The TPU kernel's sequential kv grid
// axis becomes a loop inside one CTA; ragged S and T are masked here, so
// the wrapper neither pads nor repeats the KV heads.  bf16 inputs go to the
// tensor-core kernel in flash_attention_wgmma.cu (flash_attention_launch
// below dispatches on the type); float32 stays here because a float32
// product on the tensor cores is TF32, about three decimal digits, and the
// float32 serving cuts hold the card to the CPU token for token.
//
// Design.  One CTA of 256 threads per (batch * head, 64-query block).  The
// Q tile and each 64-key K tile are staged transposed in shared memory
// ([hd][64 + 4]: float4-aligned rows whose pad spreads the banks of the
// transposed stores), the V tile as [64][hd].  Thread (r, c) owns query
// rows 4r..4r+3: it forms their scores against keys 4c..4c+3 (two float4
// loads per 16 FMAs), the row max and sum reduce over the 16 lanes of a
// half-warp by shuffles, and the probabilities go through shared memory
// (over the K tile, which is dead by then) into the P @ V product, where the
// thread accumulates columns c + 16j of its four rows.  m, l and acc are
// float32 registers.  Key blocks wholly above the causal diagonal are never
// visited.
//
// What bounds it on an H100: operations.  The causal slice shape
// (B 4, S = T = 1024, H 16, hd 128) is 2 * 2 * B * H * S * T * hd / 2 =
// 17.2 GFLOP; in float32 (75 MB of inputs and output, ~228 FLOP per byte)
// the floor is the FMA pipes' 67 TFLOP/s (0.26 ms), and this kernel runs
// at roughly a fifth of it: a known slow path, kept for exactness.  Shared
// memory (100 KB at hd 128, 64 KB at zamba2-2.7b's hd 80, where each
// thread owns NC = 5 output columns) allows two CTAs per SM.
//
// Built with --fmad=false like every source of the port (the simulator's
// float64 EMA needs it); here it only keeps the FMA pipes' products rounded
// once per multiply-add as written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LD = BQ + 4;        // row stride of the transposed Q/K tiles
constexpr int LDP = BK + 1;       // row stride of the probability tile

template <int HD>
struct Smem {
  static constexpr int kQ = HD * LD;
  static constexpr int kK = HD * LD > BQ * LDP ? HD * LD : BQ * LDP;
  static constexpr int kV = BK * HD;
  static constexpr size_t bytes = (size_t)(kQ + kK + kV) * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int S, int T,
             int H, int KV, int causal, float softcap, float scale) {
  constexpr int NC = HD / 16;               // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                         // [HD][LD]
  float* kt = qt + Smem<HD>::kQ;            // [HD][LD], then P [BQ][LDP]
  float* vs = kt + Smem<HD>::kK;            // [BK][HD]
  float* ps = kt;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;
  const int offset = T - S;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int row = i / HD, d = i % HD;
    const int s = q0 + row;
    float x = 0.f;
    if (s < S) x = q[(((int64_t)b * S + s) * H + h) * HD + d];
    qt[d * LD + row] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  // keys past k_end lie above the diagonal for every row of this block
  int k_end = T;
  if (causal && q0 + BQ + offset < k_end) k_end = q0 + BQ + offset;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                        // tiles of the last block read
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int row = i / HD, d = i % HD;
      const int t = k0 + row;
      float kx = 0.f, vx = 0.f;
      if (t < T) {
        const int64_t off = (((int64_t)b * T + t) * KV + kvh) * HD + d;
        kx = k[off];
        vx = v[off];
      }
      kt[d * LD + row] = kx;
      vs[row * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&qt[d * LD + 4 * r]);
      const float4 ka = *reinterpret_cast<const float4*>(&kt[d * LD + 4 * c]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * r + i + offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * c + j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool live = kpos < T && (!causal || kpos <= qpos);
        s[i][j] = live ? x : -1e30f;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        p[i][j] = e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }

    __syncthreads();                        // every score formed: K tile dead
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(4 * r + i) * LDP + 4 * c + j] = p[i][j];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(4 * r + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = vs[kk * HD + c + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pa[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * r + i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* out = o + (((int64_t)b * S + s) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < NC; ++j) out[c + 16 * j] = acc[i][j] / denom;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T, int H, int KV, int causal, float softcap,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = Smem<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, T, H, KV,
      causal, softcap, scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int T, int H, int KV, int hd, int causal, float softcap,
             float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, B, S, T, H, KV, causal, softcap, scale,
                        st);
    case 32:
      return launch<32>(q, k, v, o, B, S, T, H, KV, causal, softcap, scale,
                        st);
    case 64:
      return launch<64>(q, k, v, o, B, S, T, H, KV, causal, softcap, scale,
                        st);
    case 80:
      return launch<80>(q, k, v, o, B, S, T, H, KV, causal, softcap, scale,
                        st);
    case 128:
      return launch<128>(q, k, v, o, B, S, T, H, KV, causal, softcap, scale,
                         st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The tensor-core kernel of flash_attention_wgmma.cu (bf16 only).
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* o, int B, int S, int T, int H, int KV, int hd,
                          int causal, float softcap, float scale,
                          cudaStream_t stream);

// dtype: 0 = float32 (this file's FMA kernel), 1 = bfloat16 (the wgmma
// kernel).  Returns cudaGetLastError() after the launch (or the error that
// refused it).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T, int H, int KV, int hd,
                                      int causal, float softcap, float scale,
                                      int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch(q, k, v, o, B, S, T, H, KV, hd, causal, softcap, scale,
                    st);
  if (dtype == 1)
    return flash_attention_wgmma(q, k, v, o, B, S, T, H, KV, hd, causal,
                                 softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}
