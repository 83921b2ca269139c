// Paged decode attention: one new token per sequence against a KV cache
// kept as fixed-size pages in a global pool.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py (`_paged_kernel` / `paged_attention`): q
// (B, KV, G, hd) with the G = H / KV query heads of each KV head together,
// pools (pool, page, KV, hd), block_table int32 (B, n_pages) naming the
// pool slot of each logical page, lengths int32 (B,).  Tokens at or past
// the length take no part (the reference masks them with -1e30, which
// weighs exactly 0 beside any live token), pages wholly past it are never
// read, online softmax in float32, optional softcap, p rounded to the
// value type before P @ V (the Pallas kernel's p.astype(v.dtype)) while l
// sums the unrounded p, out = acc / max(l, 1e-30).  The TPU's scalar
// prefetch of the table and lengths becomes each CTA reading its own table
// entries and length; its sequential page axis becomes a loop, split over
// CTAs.
//
// What bounds it on an H100: bytes.  Each live page is read once per
// (sequence, KV head): 2 * page * hd * sizeof(E) bytes of K and V against
// 4 * G * page * hd FLOP, i.e. G FLOP per byte in bf16 (8 for qwen2.5-3b),
// far below the card's ~295.  The floor is the live K + V bytes at
// 3.35 TB/s (about 1.3 us for 4 sequences of 1055 tokens with 2 KV heads).
//
// Design, one launch.  The live pages of a (sequence, KV head) are cut
// into gridDim.x contiguous ranges (the wrapper sizes the split count from
// the table width and the SM count, never from a host read of lengths),
// one CTA of 256 threads each.  A group of tg lanes (the power of two
// covering one token row's 16-byte chunks) reads a token's K and V rows in
// their own type with one 16-byte load per lane straight into registers,
// and holds the matching slice of all G (up to GP at a time) query heads
// in registers, so each K/V byte is read once and used G times; there is
// no float32 staging in shared memory.  Each group keeps its own online
// softmax state (m, l, acc) over TPG tokens per step; one step ahead it
// looks up its next tokens' pool slots and prefetches their rows into L2
// with cp.async.bulk.prefetch, so a step's loads wait on no table read.
// The CTA then merges its groups (shuffles within a warp, shared memory
// across warps) into one partial (m, l, acc), writes it to a float32
// workspace (a range with no live page writes only m = -inf) and takes a
// ticket on the (sequence, KV head)'s counter; the CTA that draws the
// last ticket merges the partials by their maxima, writes the output, and
// resets the counter to 0 for the next call.  With one split the CTA
// writes the output directly.  A live page whose table
// entry lies outside [0, pool) fails a device-side assert (the stream
// faults, as torch's own index checks do): the kernel never reads outside
// the pool, and the check costs no launch.
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
constexpr int HD_MAX = 128;
constexpr int MAX_GROUPS = THREADS / 2;   // tg >= 2
constexpr int MAX_SPLITS = 64;

template <typename E> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;               // values per 16-byte load
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(bytes)
               : "memory");
}

// Partial of split s of pair = (b * KV + kvh) * n_hc + hc in ws, at
// (pair * n_split + s) * GP * (hd + 4) floats: acc (GP * hd), m (GP), l (GP).
template <typename E, int GP, int TPG>
__global__ void __launch_bounds__(THREADS)
paged_kernel(const E* __restrict__ q, const E* __restrict__ kp,
             const E* __restrict__ vp, const int32_t* __restrict__ table,
             const int32_t* __restrict__ lengths, E* __restrict__ o,
             float* __restrict__ ws, int32_t* __restrict__ counters, int KV,
             int G, int hd, int pool, int page, int n_pages, int tg,
             float softcap, float scale) {
  constexpr int VEC = Vec<E>::N;
  __shared__ float grp_m[MAX_GROUPS][GP];
  __shared__ float grp_l[MAX_GROUPS][GP];
  __shared__ float warp_acc[WARPS][GP][HD_MAX];
  __shared__ float cta_m[GP], cta_l[GP];
  __shared__ float split_w[MAX_SPLITS][GP], split_l[MAX_SPLITS][GP];
  __shared__ int is_last;

  const int split = blockIdx.x, n_split = gridDim.x;
  const int n_hc = gridDim.y / KV;
  const int kvh = blockIdx.y / n_hc, hc = blockIdx.y % n_hc;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = tid / tg, cidx = tid % tg;
  const int n_grp = THREADS / tg, grp_per_warp = 32 / tg;
  const bool active = cidx * VEC < hd;
  const int g0 = hc * GP;
  const int ng = min(GP, G - g0);

  const int len = max(lengths[b], 0);
  const int n_live = min((len + page - 1) / page, n_pages);
  const int per = (n_live + n_split - 1) / n_split;
  const int t_begin = split * per * page;
  const int t_end = min(len, min(n_live, (split + 1) * per) * page);

  float qr[GP][VEC];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    uint4 u = make_uint4(0, 0, 0, 0);
    if (g < ng && active)
      u = *reinterpret_cast<const uint4*>(
          q + (((int64_t)b * KV + kvh) * G + g0 + g) * hd + cidx * VEC);
    Vec<E>::unpack(u, qr[g]);
  }
  float m[GP], l[GP], acc[GP][VEC];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const int64_t row = (int64_t)KV * hd;     // elements per pool token row
  const uint32_t row_bytes = hd * sizeof(E);
  const int32_t* trow = table + (int64_t)b * n_pages;
  auto slot_of = [&](int t) {               // pool slot of token t's page
    const int slot = __ldg(trow + t / page);
    assert(slot >= 0 && slot < pool);
    return slot;
  };
  auto offset_of = [&](int slot, int t) {   // element offset of (t, kvh)
    return ((int64_t)slot * page + t % page) * row + (int64_t)kvh * hd;
  };

  // Every lane of a warp runs the same steps (shuffles span the warp).
  // The slots of a step's tokens are looked up one step ahead, beside
  // the L2 prefetch of their rows, so a step's K/V loads wait on no table
  // read.
  const int step = n_grp * TPG;
  int slot[TPG];
#pragma unroll
  for (int u = 0; u < TPG; ++u) {
    const int t = t_begin + grp * TPG + u;
    slot[u] = t < t_end ? slot_of(t) : 0;
  }
  for (int tw = t_begin + warp * grp_per_warp * TPG; tw < t_end;
       tw += step) {
    const int t0 = tw + (lane / tg) * TPG;
    uint4 kr[TPG], vr[TPG];
#pragma unroll
    for (int u = 0; u < TPG; ++u) {
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      if (t0 + u < t_end && active) {
        const int64_t off = offset_of(slot[u], t0 + u) + cidx * VEC;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kp + off));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vp + off));
      }
    }
#pragma unroll
    for (int u = 0; u < TPG; ++u) {
      const int tn = t0 + step + u;
      slot[u] = tn < t_end ? slot_of(tn) : 0;
      if (cidx == 0 && tn < t_end) {
        const int64_t off = offset_of(slot[u], tn);
        prefetch_l2(kp + off, row_bytes);
        prefetch_l2(vp + off, row_bytes);
      }
    }

    float s[TPG][GP];
#pragma unroll
    for (int u = 0; u < TPG; ++u) {
      float kf[VEC];
      Vec<E>::unpack(kr[u], kf);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d += qr[g][e] * kf[e];
        s[u][g] = d;
      }
    }
    for (int off = tg / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < TPG; ++u)
#pragma unroll
        for (int g = 0; g < GP; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);

    float vf[TPG][VEC];
#pragma unroll
    for (int u = 0; u < TPG; ++u) Vec<E>::unpack(vr[u], vf[u]);
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float x[TPG];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < TPG; ++u) {
        x[u] = s[u][g] * scale;
        if (softcap > 0.f) x[u] = softcap * tanhf(x[u] / softcap);
        if (t0 + u < t_end) mx = fmaxf(mx, x[u]);
      }
      if (mx == -INFINITY) continue;        // no token of this group here
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < TPG; ++u) {
        if (t0 + u >= t_end) continue;
        const float p = expf(x[u] - m_new);
        l[g] += p;
        const float pr = Vec<E>::round(p);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] += pr * vf[u][e];
      }
    }
  }

  const int64_t pair = ((int64_t)b * KV + kvh) * n_hc + hc;
  E* out = o + (((int64_t)b * KV + kvh) * G + g0) * hd;
  const int64_t stride = (int64_t)GP * (hd + 4);    // 16-byte multiple
  float* base = ws + pair * n_split * stride;
  float* part = base + split * stride;
  if (t_begin >= t_end) {                   // no live page in this range
    if (n_split == 1) {
      for (int i = tid; i < ng * hd; i += THREADS) out[i] = Vec<E>::store(0.f);
      return;
    }
    if (tid < GP) {                         // weighs 0; acc left unwritten
      part[GP * hd + tid] = -INFINITY;
      part[GP * hd + GP + tid] = 0.f;
    }
  } else {
    // ---- merge the CTA's groups into one partial -------------------------
    if (cidx == 0) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        grp_m[grp][g] = m[g];
        grp_l[grp][g] = l[g];
      }
    }
    __syncthreads();
    if (tid < GP) {
      float M = -INFINITY, L = 0.f;
      for (int r = 0; r < n_grp; ++r) M = fmaxf(M, grp_m[r][tid]);
      if (M != -INFINITY)
        for (int r = 0; r < n_grp; ++r)
          if (grp_m[r][tid] != -INFINITY)
            L += grp_l[r][tid] * expf(grp_m[r][tid] - M);
      cta_m[tid] = M;
      cta_l[tid] = L;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float w = m[g] == -INFINITY ? 0.f : expf(m[g] - cta_m[g]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= w;
    }
    for (int off = tg; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    if (lane < tg && active) {
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          warp_acc[warp][g][cidx * VEC + e] = acc[g][e];
    }
    __syncthreads();

    if (n_split == 1) {
      for (int i = tid; i < ng * hd; i += THREADS) {
        const int g = i / hd, d = i % hd;
        float a = 0.f;
        for (int w = 0; w < WARPS; ++w) a += warp_acc[w][g][d];
        out[i] = Vec<E>::store(a / fmaxf(cta_l[g], 1e-30f));
      }
      return;
    }
    for (int i = tid; i < GP * hd; i += THREADS) {
      const int g = i / hd, d = i % hd;
      float a = 0.f;
      for (int w = 0; w < WARPS; ++w) a += warp_acc[w][g][d];
      part[i] = a;
    }
    if (tid < GP) {
      part[GP * hd + tid] = cta_m[tid];
      part[GP * hd + GP + tid] = cta_l[tid];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(counters + pair, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // ---- the last CTA: out = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30),
  // w_s = e^(m_s - M) with M the largest m_s (0 for an empty split).  The
  // splits' m and l come into shared memory in one parallel pass; then
  // each thread sums 4 outputs over the splits with 16-byte loads, all in
  // flight together.
  for (int i = tid; i < n_split * GP; i += THREADS) {
    const int sp = i / GP, g = i % GP;
    split_w[sp][g] = __ldcg(base + sp * stride + GP * hd + g);
    split_l[sp][g] = __ldcg(base + sp * stride + GP * hd + GP + g);
  }
  __syncthreads();
  if (tid < GP) {
    float M = -INFINITY, den = 0.f;
    for (int sp = 0; sp < n_split; ++sp) M = fmaxf(M, split_w[sp][tid]);
    for (int sp = 0; sp < n_split; ++sp) {
      const float ms = split_w[sp][tid];
      const float w = ms == -INFINITY ? 0.f : expf(ms - M);
      split_w[sp][tid] = w;
      den += split_l[sp][tid] * w;
    }
    cta_l[tid] = 1.f / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int i = 4 * tid; i < ng * hd; i += 4 * THREADS) {
    const int g = i / hd;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < n_split; ++sp) {
      const float w = split_w[sp][g];
      if (w == 0.f) continue;               // an empty split's acc is unset
      const float4 a = __ldcg(reinterpret_cast<const float4*>(
          base + sp * stride + i));
      sum.x += a.x * w;
      sum.y += a.y * w;
      sum.z += a.z * w;
      sum.w += a.w * w;
    }
    const float inv = cta_l[g];
    out[i] = Vec<E>::store(sum.x * inv);
    out[i + 1] = Vec<E>::store(sum.y * inv);
    out[i + 2] = Vec<E>::store(sum.z * inv);
    out[i + 3] = Vec<E>::store(sum.w * inv);
  }
  if (tid == 0) counters[pair] = 0;
}

template <typename E, int GP>
int launch(const void* q, const void* kp, const void* vp,
           const int32_t* table, const int32_t* lengths, void* o, float* ws,
           int32_t* counters, int B, int KV, int G, int hd, int pool,
           int page, int n_pages, int n_split, float softcap, float scale,
           cudaStream_t stream) {
  constexpr int TPG = GP >= 8 ? 2 : 4;      // tokens per group and step
  const int chunks = hd * (int)sizeof(E) / 16;
  int tg = 2;
  while (tg < chunks) tg *= 2;
  if (tg > 32) return (int)cudaErrorInvalidValue;
  const int n_hc = (G + GP - 1) / GP;
  paged_kernel<E, GP, TPG><<<dim3(n_split, KV * n_hc, B), THREADS, 0,
                             stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(kp),
      static_cast<const E*>(vp), table, lengths, static_cast<E*>(o), ws,
      counters, KV, G, hd, pool, page, n_pages, tg, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(int gp, const void* q, const void* kp, const void* vp,
             const int32_t* table, const int32_t* lengths, void* o,
             float* ws, int32_t* counters, int B, int KV, int G, int hd,
             int pool, int page, int n_pages, int n_split, float softcap,
             float scale, cudaStream_t st) {
  switch (gp) {
    case 1:
      return launch<E, 1>(q, kp, vp, table, lengths, o, ws, counters, B, KV,
                          G, hd, pool, page, n_pages, n_split, softcap,
                          scale, st);
    case 2:
      return launch<E, 2>(q, kp, vp, table, lengths, o, ws, counters, B, KV,
                          G, hd, pool, page, n_pages, n_split, softcap,
                          scale, st);
    case 4:
      return launch<E, 4>(q, kp, vp, table, lengths, o, ws, counters, B, KV,
                          G, hd, pool, page, n_pages, n_split, softcap,
                          scale, st);
    case 8:
      return launch<E, 8>(q, kp, vp, table, lengths, o, ws, counters, B, KV,
                          G, hd, pool, page, n_pages, n_split, softcap,
                          scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  gp: query heads per CTA (1, 2, 4 or
// 8; G > 8 takes ceil(G / 8) head chunks); n_split at most 64.  ws:
// float32 workspace of B * KV * ceil(G / gp) * n_split * gp * (hd + 4)
// values, 16-byte aligned; counters: int32,
// B * KV * ceil(G / gp) entries, zero before the first call and left zero
// by every call.  hd * sizeof(dtype) must be a multiple of 16 bytes and at
// most 512, hd at most 128.  Returns cudaGetLastError() after the launch
// (or the error that refused it).
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const int32_t* table,
                                      const int32_t* lengths, void* o,
                                      float* ws, int32_t* counters, int B,
                                      int KV, int G, int gp, int hd,
                                      int pool, int page, int n_pages,
                                      int n_split, float softcap,
                                      float scale, int dtype,
                                      void* stream) {
  if (B == 0 || KV == 0 || G == 0) return 0;
  if (n_split < 1 || n_split > MAX_SPLITS || page < 1 || hd > HD_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (hd * 4 % 16) return (int)cudaErrorInvalidValue;
    return dispatch<float>(gp, q, kp, vp, table, lengths, o, ws, counters, B,
                           KV, G, hd, pool, page, n_pages, n_split, softcap,
                           scale, st);
  }
  if (dtype == 1) {
    if (hd * 2 % 16) return (int)cudaErrorInvalidValue;
    return dispatch<__nv_bfloat16>(gp, q, kp, vp, table, lengths, o, ws,
                                   counters, B, KV, G, hd, pool, page,
                                   n_pages, n_split, softcap, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
