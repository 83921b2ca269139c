// Paged decode attention: one new token per sequence against a KV cache
// kept as fixed-size pages in a global pool.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py (`_paged_kernel` / `paged_attention`): q
// (B, KV, G, hd) with the G = H / KV query heads of each KV head together,
// pools (pool, page, KV, hd), block_table int32 (B, n_pages) naming the
// pool slot of each logical page, lengths int32 (B,).  Tokens at or past
// the length are masked with -1e30, pages wholly past it are never read,
// online softmax in float32, optional softcap, out = acc / max(l, 1e-30).
// The TPU's scalar prefetch of the table and lengths becomes each CTA
// reading its own table row and length; its sequential page axis becomes
// a loop, split over CTAs.
//
// Design.  The live pages of a (sequence, KV head) are cut into n_split
// contiguous ranges, one CTA of 256 threads each, so the G query heads of
// that KV head share every K/V page the CTA reads and B * KV * n_split
// CTAs fill the card even at a small batch.  A CTA walks its range in
// chunks of up to 64 tokens (whole pages): it stages the chunk's K rows
// (padded by one float, so the per-token dot products hit distinct banks)
// and V rows in shared memory as float32, zero past the length; thread i
// forms score (i / chunk, i % chunk); one warp per query head updates m
// and l with shuffles and turns its scores into p (rounded to bf16 in the
// bf16 instantiation before P @ V, as the Pallas kernel's
// p.astype(v.dtype) does); then every thread accumulates (head, column)
// outputs in shared memory.  Each CTA writes its partial (m, l, acc) to a
// float32 workspace, and a second kernel merges the n_split partials of a
// (sequence, KV head) by their maxima.  A live page whose table entry lies
// outside [0, pool) fails a device-side assert (the stream faults, as
// torch's own index checks do): the kernel never reads outside the pool,
// and the check costs no launch.
//
// What bounds it on an H100: bytes.  Each live page is read once per
// (sequence, KV head): 2 * page * hd * sizeof(E) bytes of K and V against
// 4 * G * page * hd FLOP, i.e. G FLOP per byte in bf16 (8 for qwen2.5-3b),
// far below the card's ~295.  The floor is the live K + V bytes at
// 3.35 TB/s (about 1.3 us for 4 sequences of 1055 tokens with 2 KV heads);
// at that size the kernel is latency-bound (one or two chunks per CTA, two
// launches).
//
// Built with --fmad=false like every source of the port.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK_TOKENS = 64;          // tokens staged per iteration

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

int pages_per_chunk(int page) {
  return page >= CHUNK_TOKENS ? 1 : CHUNK_TOKENS / page;
}

size_t smem_floats(int G, int hd, int chunk) {
  return (size_t)G * hd              // q
         + (size_t)chunk * (hd + 1)  // K rows
         + (size_t)chunk * hd        // V rows
         + (size_t)G * chunk         // scores, then p
         + (size_t)G * hd            // acc
         + 3 * (size_t)G;            // m, l, corr
}

// Partials of split s of (b, kvh): ws[((b * KV + kvh) * n_split + s) *
// G * (hd + 2) ...] holds acc (G * hd), then m (G), then l (G).
template <typename E>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const E* __restrict__ q, const E* __restrict__ kp,
                   const E* __restrict__ vp,
                   const int32_t* __restrict__ table,
                   const int32_t* __restrict__ lengths,
                   float* __restrict__ ws, int KV, int G, int hd, int pool,
                   int page, int n_pages, int ppc, float softcap,
                   float scale) {
  extern __shared__ float sm[];
  const int chunk = ppc * page;
  const int ldk = hd + 1;
  float* qs = sm;
  float* ks = qs + G * hd;
  float* vs = ks + chunk * ldk;
  float* sc = vs + chunk * hd;
  float* acc = sc + G * chunk;
  float* mrow = acc + G * hd;
  float* lrow = mrow + G;
  float* crow = lrow + G;

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t qoff = ((int64_t)b * KV + kvh) * G * hd;
  for (int i = tid; i < G * hd; i += THREADS) {
    qs[i] = to_f(q[qoff + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    mrow[g] = -INFINITY;
    lrow[g] = 0.f;
  }

  const int len = max(lengths[b], 0);
  int n_live = (len + page - 1) / page;
  if (n_live > n_pages) n_live = n_pages;
  const int per = (n_live + n_split - 1) / n_split;
  const int p_begin = split * per;
  const int p_end = min(n_live, p_begin + per);
  const int64_t tok_stride = (int64_t)KV * hd;

  __shared__ int slots[CHUNK_TOKENS];
  for (int p0 = p_begin; p0 < p_end; p0 += ppc) {
    const int np = min(ppc, p_end - p0);
    const int ntok = np * page;
    __syncthreads();                        // last chunk's tiles consumed
    if (tid < np) {
      const int slot = table[(int64_t)b * n_pages + p0 + tid];
      assert(slot >= 0 && slot < pool);
      slots[tid] = slot;
    }
    __syncthreads();
    for (int i = tid; i < ntok * hd; i += THREADS) {
      const int t = i / hd, d = i % hd;
      float kx = 0.f, vx = 0.f;
      if (p0 * page + t < len) {
        const int64_t off =
            ((int64_t)slots[t / page] * page + t % page) * tok_stride
            + (int64_t)kvh * hd + d;
        kx = to_f(kp[off]);
        vx = to_f(vp[off]);
      }
      ks[t * ldk + d] = kx;
      vs[t * hd + d] = vx;
    }
    __syncthreads();
    for (int i = tid; i < G * ntok; i += THREADS) {
      const int g = i / ntok, t = i % ntok;
      const float* qg = qs + g * hd;
      const float* kt = ks + t * ldk;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += qg[d] * kt[d];
      float x = dot * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      sc[g * chunk + t] = (p0 * page + t < len) ? x : -1e30f;
    }
    __syncthreads();
    for (int g = warp; g < G; g += WARPS) {
      float* row = sc + g * chunk;
      float mx = -INFINITY;
      for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, row[t]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(mrow[g], mx);
      float sum = 0.f;
      for (int t = lane; t < ntok; t += 32) {
        const float e = expf(row[t] - m_new);
        sum += e;
        row[t] = to_f(from_f<E>(e));
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(mrow[g] - m_new);
        lrow[g] = lrow[g] * corr + sum;
        mrow[g] = m_new;
        crow[g] = corr;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += THREADS) {
      const int g = i / hd, d = i % hd;
      const float* row = sc + g * chunk;
      float pv = 0.f;
      for (int t = 0; t < ntok; ++t) pv += row[t] * vs[t * hd + d];
      acc[i] = acc[i] * crow[g] + pv;
    }
  }
  __syncthreads();
  float* out =
      ws + (((int64_t)b * KV + kvh) * n_split + split) * G * (hd + 2);
  for (int i = tid; i < G * hd; i += THREADS) out[i] = acc[i];
  for (int g = tid; g < G; g += THREADS) {
    out[G * hd + g] = mrow[g];
    out[G * hd + G + g] = lrow[g];
  }
}

// out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30), with
// M the largest m_s; splits that saw no page (m_s = -inf) weigh nothing.
template <typename E>
__global__ void __launch_bounds__(THREADS)
paged_merge_kernel(const float* __restrict__ ws, E* __restrict__ o, int KV,
                   int G, int hd, int n_split) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int64_t base = ((int64_t)b * KV + kvh) * n_split;
  const int64_t stride = (int64_t)G * (hd + 2);
  for (int i = threadIdx.x; i < G * hd; i += THREADS) {
    const int g = i / hd;
    float M = -INFINITY;
    for (int s = 0; s < n_split; ++s)
      M = fmaxf(M, ws[(base + s) * stride + G * hd + g]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* part = ws + (base + s) * stride;
      const float m = part[G * hd + g];
      if (m == -INFINITY) continue;
      const float w = expf(m - M);
      num += part[i] * w;
      den += part[G * hd + G + g] * w;
    }
    o[((int64_t)b * KV + kvh) * G * hd + i] = from_f<E>(
        num / fmaxf(den, 1e-30f));
  }
}

template <typename E>
int launch(const void* q, const void* kp, const void* vp,
           const int32_t* table, const int32_t* lengths, void* o, float* ws,
           int B, int KV, int G, int hd, int pool, int page, int n_pages,
           int n_split, float softcap, float scale, cudaStream_t stream) {
  const int ppc = pages_per_chunk(page);
  const size_t smem = smem_floats(G, hd, ppc * page) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_split_kernel<E><<<dim3(KV, B, n_split), THREADS, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(kp),
      static_cast<const E*>(vp), table, lengths, ws, KV, G, hd, pool, page,
      n_pages, ppc, softcap, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_merge_kernel<E><<<dim3(KV, B), THREADS, 0, stream>>>(
      ws, static_cast<E*>(o), KV, G, hd, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ws: float32 workspace of
// B * KV * n_split * G * (hd + 2) values.  Returns cudaGetLastError() after
// the launches (or the error that refused one).
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const int32_t* table,
                                      const int32_t* lengths, void* o,
                                      float* ws, int B, int KV, int G,
                                      int hd, int pool, int page,
                                      int n_pages, int n_split,
                                      float softcap, float scale, int dtype,
                                      void* stream) {
  if (B == 0 || KV == 0 || G == 0) return 0;
  if (n_split < 1 || page < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kp, vp, table, lengths, o, ws, B, KV, G, hd,
                         pool, page, n_pages, n_split, softcap, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, table, lengths, o, ws, B, KV, G,
                                 hd, pool, page, n_pages, n_split, softcap,
                                 scale, st);
  return (int)cudaErrorInvalidValue;
}
