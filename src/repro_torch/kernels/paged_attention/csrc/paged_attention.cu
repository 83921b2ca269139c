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

// ---- the end of both kernels: merging the online-softmax states ----------
// Each group of tg lanes holds (m, l) and a VEC-value piece of acc for
// each of GP heads, over a row of d values.  The CTA merges its groups
// (shuffles within a warp, shared memory across warps) into one partial;
// with one split that is the output.  Else the partial goes to the float32
// workspace at base + split * stride (acc (GP * d), m (GP), l (GP); a
// range with no live token writes only m = -inf and l = 0), the CTA takes
// a ticket on the pair's counter, and the one that draws the last merges
// the partials by their maxima, writes the output, and resets the counter
// to 0 for the next call.  The last merge sums OV outputs a thread (4:
// 16-byte loads, where d and stride are multiples of 4).
template <int GP, int NGRP, int DMAX>
struct MergeSmem {
  float grp_m[NGRP][GP], grp_l[NGRP][GP];
  float warp_acc[WARPS][GP][DMAX];
  float cta_m[GP], cta_l[GP];
  float split_w[MAX_SPLITS][GP], split_l[MAX_SPLITS][GP];
  int is_last;
};

template <typename E, int GP, int VEC, int OV, typename Smem>
__device__ __forceinline__ void merge_store(
    Smem& sm, const float (&m)[GP], const float (&l)[GP],
    float (&acc)[GP][VEC], bool empty, E* __restrict__ out,
    float* __restrict__ base, int64_t stride, int32_t* __restrict__ counter,
    int d, int ng, int tg, bool active) {
  const int split = blockIdx.x, n_split = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = tid / tg, cidx = tid % tg, n_grp = THREADS / tg;
  float* part = base + split * stride;
  if (empty) {                              // no live token in this range
    if (n_split == 1) {
      for (int i = tid; i < ng * d; i += THREADS) out[i] = Vec<E>::store(0.f);
      return;
    }
    if (tid < GP) {                         // weighs 0; acc left unwritten
      part[GP * d + tid] = -INFINITY;
      part[GP * d + GP + tid] = 0.f;
    }
  } else {
    // ---- merge the CTA's groups into one partial -------------------------
    if (cidx == 0) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        sm.grp_m[grp][g] = m[g];
        sm.grp_l[grp][g] = l[g];
      }
    }
    __syncthreads();
    if (tid < GP) {
      float M = -INFINITY, L = 0.f;
      for (int r = 0; r < n_grp; ++r) M = fmaxf(M, sm.grp_m[r][tid]);
      if (M != -INFINITY)
        for (int r = 0; r < n_grp; ++r)
          if (sm.grp_m[r][tid] != -INFINITY)
            L += sm.grp_l[r][tid] * expf(sm.grp_m[r][tid] - M);
      sm.cta_m[tid] = M;
      sm.cta_l[tid] = L;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float w = m[g] == -INFINITY ? 0.f : expf(m[g] - sm.cta_m[g]);
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
          sm.warp_acc[warp][g][cidx * VEC + e] = acc[g][e];
    }
    __syncthreads();

    if (n_split == 1) {
      for (int i = tid; i < ng * d; i += THREADS) {
        const int g = i / d, c = i % d;
        float a = 0.f;
        for (int w = 0; w < WARPS; ++w) a += sm.warp_acc[w][g][c];
        out[i] = Vec<E>::store(a / fmaxf(sm.cta_l[g], 1e-30f));
      }
      return;
    }
    for (int i = tid; i < GP * d; i += THREADS) {
      const int g = i / d, c = i % d;
      float a = 0.f;
      for (int w = 0; w < WARPS; ++w) a += sm.warp_acc[w][g][c];
      part[i] = a;
    }
    if (tid < GP) {
      part[GP * d + tid] = sm.cta_m[tid];
      part[GP * d + GP + tid] = sm.cta_l[tid];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sm.is_last = atomicAdd(counter, 1) == n_split - 1;
  __syncthreads();
  if (!sm.is_last) return;
  __threadfence();

  // ---- the last CTA: out = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30),
  // w_s = e^(m_s - M) with M the largest m_s (0 for an empty split).  The
  // splits' m and l come into shared memory in one parallel pass; then
  // each thread sums OV outputs over the splits, all loads in flight
  // together.
  for (int i = tid; i < n_split * GP; i += THREADS) {
    const int sp = i / GP, g = i % GP;
    sm.split_w[sp][g] = __ldcg(base + sp * stride + GP * d + g);
    sm.split_l[sp][g] = __ldcg(base + sp * stride + GP * d + GP + g);
  }
  __syncthreads();
  if (tid < GP) {
    float M = -INFINITY, den = 0.f;
    for (int sp = 0; sp < n_split; ++sp) M = fmaxf(M, sm.split_w[sp][tid]);
    for (int sp = 0; sp < n_split; ++sp) {
      const float ms = sm.split_w[sp][tid];
      const float w = ms == -INFINITY ? 0.f : expf(ms - M);
      sm.split_w[sp][tid] = w;
      den += sm.split_l[sp][tid] * w;
    }
    sm.cta_l[tid] = 1.f / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int i = OV * tid; i < ng * d; i += OV * THREADS) {
    const int g = i / d;
    float sum[OV];
#pragma unroll
    for (int e = 0; e < OV; ++e) sum[e] = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_split; ++sp) {
      const float w = sm.split_w[sp][g];
      if (w == 0.f) continue;               // an empty split's acc is unset
      const float* a = base + sp * stride + i;
      if constexpr (OV == 4) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(a));
        sum[0] += v.x * w;
        sum[1] += v.y * w;
        sum[2] += v.z * w;
        sum[3] += v.w * w;
      } else {
        sum[0] += __ldcg(a) * w;
      }
    }
    const float inv = sm.cta_l[g];
#pragma unroll
    for (int e = 0; e < OV; ++e) out[i + e] = Vec<E>::store(sum[e] * inv);
  }
  if (tid == 0) *counter = 0;
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
  __shared__ MergeSmem<GP, MAX_GROUPS, HD_MAX> sm;

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
  const int64_t stride = (int64_t)GP * (hd + 4);    // 16-byte multiple
  merge_store<E, GP, VEC, 4>(sm, m, l, acc, t_begin >= t_end,
                             o + (((int64_t)b * KV + kvh) * G + g0) * hd,
                             ws + pair * n_split * stride, stride,
                             counters + pair, hd, ng, tg, active);
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

// ---------------------------------------------------------------------------
// The split mode: a cache split over the model axis by head dim.  Each rank
// holds a d-value slice of every KV head's dim (d = hd / ranks, 4-64), so a
// query head's scores are a sum over the ranks.  Two launches, with the
// ranks' sum between them (an all-reduce of the scores):
//
//   paged_scores_kernel: s[b, h, t] = q[b, h, slice] . k[t, kv(h), slice]
//     in float32 for t < length, no scale.  Entries at or past the length
//     are left unwritten: the apply launch never reads them, and a sum of
//     the ranks' buffers leaves them as undefined as they were.  One
//     thread a live token; a CTA of 256 tokens of one (sequence, KV head,
//     chunk of up to GP query heads) holds the heads' q slices in shared
//     memory as float32 and reads each K row once for all of them; a CTA
//     wholly past the length returns at once.
//   paged_apply_kernel: x = softcap(s * scale) over the live tokens,
//     online softmax in float32, out = sum_t round(p) v[t, kv(h), slice] /
//     max(sum_t p, 1e-30): the whole-head kernel's arithmetic after its
//     scores, on the same split of the live pages over CTAs and the same
//     merge (merge_store).  A group
//     of tg lanes covers a token's V row; all GP heads' scores come from
//     the summed buffer.
//
// A slice of 4 bf16 values is an 8-byte row, under the whole-head kernel's
// 16-byte load: here every lane loads 8 bytes (VEC = 8 / sizeof(E) values),
// or one value where the slice is not a multiple of 8 bytes (VEC = 1).  Row
// offsets are multiples of d values, so every load is aligned.
//
// What bounds it: bytes.  The scores launch reads the live K slice once and
// writes 4 * H * len bytes a sequence; the apply launch reads those scores
// and the live V slice.  Both do 2 FLOP a value read.

namespace {

constexpr int SLICE_MAX = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VEC values at p (8 bytes, or one value) as float32.
template <typename E, int VEC>
__device__ __forceinline__ void load_slice(const E* p, float (&f)[VEC]) {
  if constexpr (VEC * sizeof(E) == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    if constexpr (sizeof(E) == 4) {
      f[0] = __uint_as_float(u.x);
      f[1] = __uint_as_float(u.y);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 a = __bfloat1622float2(h[0]);
      const float2 c = __bfloat1622float2(h[1]);
      f[0] = a.x;
      f[1] = a.y;
      f[2] = c.x;
      f[3] = c.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = to_float(p[e]);
  }
}

template <typename E, int GP, int VEC>
__global__ void __launch_bounds__(THREADS)
paged_scores_kernel(const E* __restrict__ q, const E* __restrict__ kp,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ s, int KV, int G, int d, int pool,
                    int page, int n_pages) {
  __shared__ float qs[GP][SLICE_MAX];
  const int n_hc = gridDim.y / KV;
  const int kvh = blockIdx.y / n_hc, hc = blockIdx.y % n_hc;
  const int b = blockIdx.z;
  const int g0 = hc * GP;
  const int ng = min(GP, G - g0);
  const int T = n_pages * page;
  const int len = min(max(lengths[b], 0), T);
  if (blockIdx.x * THREADS >= len) return;  // every token of the CTA dead
  const E* qb = q + (((int64_t)b * KV + kvh) * G + g0) * d;
  for (int i = threadIdx.x; i < GP * d; i += THREADS) {
    const int g = i / d;
    qs[g][i % d] = g < ng ? to_float(qb[i]) : 0.f;
  }
  __syncthreads();
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= len) return;
  float acc[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) acc[g] = 0.f;
  const int slot = __ldg(table + (int64_t)b * n_pages + t / page);
  assert(slot >= 0 && slot < pool);
  const E* row = kp + (((int64_t)slot * page + t % page) * KV + kvh) * d;
  for (int c = 0; c < d; c += VEC) {
    float kf[VEC];
    load_slice<E, VEC>(row + c, kf);
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g] += qs[g][c + e] * kf[e];
  }
  float* out = s + (((int64_t)b * KV + kvh) * G + g0) * T + t;
#pragma unroll
  for (int g = 0; g < GP; ++g)
    if (g < ng) out[(int64_t)g * T] = acc[g];
}

// Partial of split sp of pair = (b * KV + kvh) * n_hc + hc in ws, at
// (pair * n_split + sp) * GP * (d + 2) floats: acc (GP * d), m (GP), l (GP).
template <typename E, int GP, int TPG, int VEC>
__global__ void __launch_bounds__(THREADS)
paged_apply_kernel(const float* __restrict__ s, const E* __restrict__ vp,
                   const int32_t* __restrict__ table,
                   const int32_t* __restrict__ lengths, E* __restrict__ o,
                   float* __restrict__ ws, int32_t* __restrict__ counters,
                   int KV, int G, int d, int pool, int page, int n_pages,
                   int tg, float softcap, float scale) {
  __shared__ MergeSmem<GP, THREADS, SLICE_MAX> sm;

  const int split = blockIdx.x, n_split = gridDim.x;
  const int n_hc = gridDim.y / KV;
  const int kvh = blockIdx.y / n_hc, hc = blockIdx.y % n_hc;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cidx = tid % tg;
  const int n_grp = THREADS / tg, grp_per_warp = 32 / tg;
  const bool active = cidx * VEC < d;
  const int g0 = hc * GP;
  const int ng = min(GP, G - g0);
  const int T = n_pages * page;

  const int len = max(lengths[b], 0);
  const int n_live = min((len + page - 1) / page, n_pages);
  const int per = (n_live + n_split - 1) / n_split;
  const int t_begin = split * per * page;
  const int t_end = min(len, min(n_live, (split + 1) * per) * page);
  const float* srow = s + (((int64_t)b * KV + kvh) * G + g0) * T;

  float m[GP], l[GP], acc[GP][VEC];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }
  const int64_t row = (int64_t)KV * d;      // values per pool token row
  const int32_t* trow = table + (int64_t)b * n_pages;
  const int step = n_grp * TPG;
  for (int tw = t_begin + warp * grp_per_warp * TPG; tw < t_end;
       tw += step) {
    const int t0 = tw + (lane / tg) * TPG;
    float vf[TPG][VEC], x[TPG][GP];
#pragma unroll
    for (int u = 0; u < TPG; ++u) {
      const int t = t0 + u;
#pragma unroll
      for (int e = 0; e < VEC; ++e) vf[u][e] = 0.f;
#pragma unroll
      for (int g = 0; g < GP; ++g) x[u][g] = 0.f;
      if (t >= t_end) continue;
      const int slot = __ldg(trow + t / page);
      assert(slot >= 0 && slot < pool);
      if (active)
        load_slice<E, VEC>(vp + ((int64_t)slot * page + t % page) * row +
                               (int64_t)kvh * d + cidx * VEC,
                           vf[u]);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g >= ng) continue;
        float xv = __ldg(srow + (int64_t)g * T + t) * scale;
        if (softcap > 0.f) xv = softcap * tanhf(xv / softcap);
        x[u][g] = xv;
      }
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < TPG; ++u)
        if (t0 + u < t_end) mx = fmaxf(mx, x[u][g]);
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
        const float p = expf(x[u][g] - m_new);
        l[g] += p;
        const float pr = Vec<E>::round(p);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] += pr * vf[u][e];
      }
    }
  }

  const int64_t pair = ((int64_t)b * KV + kvh) * n_hc + hc;
  const int64_t stride = (int64_t)GP * (d + 2);
  merge_store<E, GP, VEC, 1>(sm, m, l, acc, t_begin >= t_end,
                             o + (((int64_t)b * KV + kvh) * G + g0) * d,
                             ws + pair * n_split * stride, stride,
                             counters + pair, d, ng, tg, active);
}

template <typename E, int GP, int VEC>
int split_launch(bool scores, const void* x, const void* pages,
                 const int32_t* table, const int32_t* lengths, void* o,
                 float* ws, int32_t* counters, int B, int KV, int G, int d,
                 int pool, int page, int n_pages, int n_split, float softcap,
                 float scale, cudaStream_t stream) {
  const int n_hc = (G + GP - 1) / GP;
  if (scores) {
    const int T = n_pages * page;
    paged_scores_kernel<E, GP, VEC>
        <<<dim3((T + THREADS - 1) / THREADS, KV * n_hc, B), THREADS, 0,
           stream>>>(static_cast<const E*>(x), static_cast<const E*>(pages),
                     table, lengths, static_cast<float*>(o), KV, G, d, pool,
                     page, n_pages);
    return (int)cudaGetLastError();
  }
  constexpr int TPG = GP >= 8 ? 2 : 4;      // tokens per group and step
  const int chunks = (d + VEC - 1) / VEC;
  int tg = 1;
  while (tg < chunks) tg *= 2;
  if (tg > 32) return (int)cudaErrorInvalidValue;
  paged_apply_kernel<E, GP, TPG, VEC>
      <<<dim3(n_split, KV * n_hc, B), THREADS, 0, stream>>>(
          static_cast<const float*>(x), static_cast<const E*>(pages), table,
          lengths, static_cast<E*>(o), ws, counters, KV, G, d, pool, page,
          n_pages, tg, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename E, int GP>
int split_vec(bool scores, const void* x, const void* pages,
              const int32_t* table, const int32_t* lengths, void* o,
              float* ws, int32_t* counters, int B, int KV, int G, int d,
              int pool, int page, int n_pages, int n_split, float softcap,
              float scale, cudaStream_t st) {
  constexpr int V8 = 8 / (int)sizeof(E);
  if (d % V8 == 0)
    return split_launch<E, GP, V8>(scores, x, pages, table, lengths, o, ws,
                                   counters, B, KV, G, d, pool, page,
                                   n_pages, n_split, softcap, scale, st);
  return split_launch<E, GP, 1>(scores, x, pages, table, lengths, o, ws,
                                counters, B, KV, G, d, pool, page, n_pages,
                                n_split, softcap, scale, st);
}

template <typename E>
int split_dispatch(bool scores, int gp, const void* x, const void* pages,
                   const int32_t* table, const int32_t* lengths, void* o,
                   float* ws, int32_t* counters, int B, int KV, int G, int d,
                   int pool, int page, int n_pages, int n_split,
                   float softcap, float scale, cudaStream_t st) {
  switch (gp) {
    case 1:
      return split_vec<E, 1>(scores, x, pages, table, lengths, o, ws,
                             counters, B, KV, G, d, pool, page, n_pages,
                             n_split, softcap, scale, st);
    case 2:
      return split_vec<E, 2>(scores, x, pages, table, lengths, o, ws,
                             counters, B, KV, G, d, pool, page, n_pages,
                             n_split, softcap, scale, st);
    case 4:
      return split_vec<E, 4>(scores, x, pages, table, lengths, o, ws,
                             counters, B, KV, G, d, pool, page, n_pages,
                             n_split, softcap, scale, st);
    case 8:
      return split_vec<E, 8>(scores, x, pages, table, lengths, o, ws,
                             counters, B, KV, G, d, pool, page, n_pages,
                             n_split, softcap, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int split_entry(bool scores, int dtype, int gp, const void* x,
                const void* pages, const int32_t* table,
                const int32_t* lengths, void* o, float* ws,
                int32_t* counters, int B, int KV, int G, int d, int pool,
                int page, int n_pages, int n_split, float softcap,
                float scale, void* stream) {
  if (B == 0 || KV == 0 || G == 0 || n_pages == 0) return 0;
  if (d < 1 || d > SLICE_MAX || page < 1 || n_split < 1 ||
      n_split > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return split_dispatch<float>(scores, gp, x, pages, table, lengths, o, ws,
                                 counters, B, KV, G, d, pool, page, n_pages,
                                 n_split, softcap, scale, st);
  if (dtype == 1)
    return split_dispatch<__nv_bfloat16>(scores, gp, x, pages, table,
                                         lengths, o, ws, counters, B, KV, G,
                                         d, pool, page, n_pages, n_split,
                                         softcap, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The split mode's scores: q (B, KV, G, d) and k pages (pool, page, KV, d)
// in `dtype` (0 float32, 1 bfloat16), d at most 64; scores float32
// (B, KV * G, n_pages * page), written for t < length only.  gp: query
// heads per CTA (1, 2, 4 or 8).
extern "C" int paged_scores_launch(const void* q, const void* kp,
                                   const int32_t* table,
                                   const int32_t* lengths, float* scores,
                                   int B, int KV, int G, int gp, int d,
                                   int pool, int page, int n_pages,
                                   int dtype, void* stream) {
  return split_entry(true, dtype, gp, q, kp, table, lengths, scores, nullptr,
                     nullptr, B, KV, G, d, pool, page, n_pages, 1, 0.f, 0.f,
                     stream);
}

// The split mode's softmax and P @ V: scores float32 (B, KV * G,
// n_pages * page), v pages (pool, page, KV, d), out (B, KV, G, d) in
// `dtype`.  ws: float32, B * KV * ceil(G / gp) * n_split * gp * (d + 2)
// values; counters as paged_attention_launch's (zero before, left zero).
extern "C" int paged_apply_launch(const float* scores, const void* vp,
                                  const int32_t* table,
                                  const int32_t* lengths, void* o, float* ws,
                                  int32_t* counters, int B, int KV, int G,
                                  int gp, int d, int pool, int page,
                                  int n_pages, int n_split, float softcap,
                                  float scale, int dtype, void* stream) {
  return split_entry(false, dtype, gp, scores, vp, table, lengths, o, ws,
                     counters, B, KV, G, d, pool, page, n_pages, n_split,
                     softcap, scale, stream);
}
