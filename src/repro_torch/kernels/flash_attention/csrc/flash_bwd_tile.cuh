// The CTA programs of the flash attention backward (flash_attention_bwd.cu),
// written once for the card and the host.
//
// A CTA program is a sequence of phases; in each, every one of THREADS
// threads runs the same function of its thread index, and a barrier ends
// the phase.  `Cta::each(f)` runs one phase: on the card (DevCta in the
// .cu) it calls f(threadIdx.x, acc) and __syncthreads(); on the host
// (tests/test_torch_flash_backward.py builds this header with g++) it
// calls f(tid, acc[tid]) for every tid in turn.  So the host runs the
// kernels' own arithmetic, in the kernels' own order.  No phase reads what
// another thread writes in the same phase; `acc` is each thread's float32
// accumulators (registers on the card).
//
// Tiles are float32 in shared memory whatever the input type: R = 32 query
// rows by C = 32 keys, rows of Q, dO, K and V padded to HD + 1 floats so
// that the eight K (or V) rows read by one warp lie on distinct banks.
//   * score_tile: thread t takes query row t / 8 and keys t % 8 + 8 e
//     (e < 4): s = q . k and dp = dO . v over the head dim (fmaf), then
//     u = s * scale, the softcap c tanh(u / c), P = exp(u - lse) where the
//     (row, key) pair is live (row < S, key < T, causal: key <= row +
//     T - S) and 0 elsewhere, and dS = P (dp - D) (1 - tanh^2) * scale.
//   * acc_dkdv: thread t owns key t / 8 and head-dim columns t % 8 + 8 c
//     of dK and dV: dK += dS^T Q, dV += P^T dO over the tile's rows.
//   * acc_dq: thread t owns query row t / 8, columns t % 8 + 8 c of dQ:
//     dQ += dS K over the tile's keys.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#define FB_FN __device__ __forceinline__
#define FB_UNROLL _Pragma("unroll")
#else
#define FB_FN inline
#define FB_UNROLL
#endif

namespace flash_bwd {

constexpr int THREADS = 256;
constexpr int R = 32;             // query rows of a tile
constexpr int C = 32;             // keys of a tile

FB_FN float to_f(float x) { return x; }
FB_FN void put(float* d, float x) { *d = x; }
#ifdef __CUDACC__
FB_FN float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
FB_FN void put(__nv_bfloat16* d, float x) { *d = __float2bfloat16_rn(x); }
#endif

struct Shape {
  int B, S, T, H, KV, causal;
  float softcap, scale;
};

// q, o, dout, dq: (B, S, H, HD); k, v, dk, dv: (B, T, KV, HD); lse and the
// pre-pass's dsum (D = rowsum(dO * O)): float32 (B, H, S).
template <typename E>
struct Tensors {
  const E *q, *k, *v, *o, *dout;
  const float* lse;
  float* dsum;
  E *dq, *dk, *dv;
};

// Shared memory of one CTA, in floats.
template <int HD>
struct Tile {
  static constexpr int LD = HD + 1;
  static constexpr int q = 0;
  static constexpr int dout = q + R * LD;
  static constexpr int k = dout + R * LD;
  static constexpr int v = k + C * LD;
  static constexpr int p = v + C * LD;
  static constexpr int ds = p + R * C;
  static constexpr int lse = ds + R * C;
  static constexpr int dsum = lse + R;
  static constexpr int floats = dsum + R;
  static constexpr unsigned bytes = floats * 4u;
  static_assert(HD % 8 == 0, "eight threads share a row's columns");
};

// Rows row0 .. row0 + N - 1 of one head (src: the head's row 0; rows
// `stride` elements apart) into shared rows of HD + 1 floats, zero past
// `rows`.
template <int HD, int N, typename E>
FB_FN void load_rows(float* dst, const E* src, int row0, int rows,
                     int64_t stride, int tid) {
  for (int i = tid; i < N * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD, g = row0 + r;
    dst[r * (HD + 1) + d] = g < rows ? to_f(src[(int64_t)g * stride + d])
                                     : 0.f;
  }
}

FB_FN void load_vec(float* dst, const float* src, int row0, int rows,
                    int tid) {
  for (int i = tid; i < R; i += THREADS)
    dst[i] = row0 + i < rows ? src[row0 + i] : 0.f;
}

template <int HD>
FB_FN void score_tile(float* sm, int i0, int j0, const Shape& s, int tid) {
  using L = Tile<HD>;
  const int i = tid / 8, jl = tid % 8;
  const float* qr = sm + L::q + i * L::LD;
  const float* gr = sm + L::dout + i * L::LD;
  float sc[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < HD; ++d) {
    const float a = qr[d], g = gr[d];
FB_UNROLL
    for (int e = 0; e < 4; ++e) {
      const int j = jl + 8 * e;
      sc[e] = fmaf(a, sm[L::k + j * L::LD + d], sc[e]);
      dp[e] = fmaf(g, sm[L::v + j * L::LD + d], dp[e]);
    }
  }
  const int qi = i0 + i;
  const float lse = sm[L::lse + i], dsum = sm[L::dsum + i];
FB_UNROLL
  for (int e = 0; e < 4; ++e) {
    const int j = jl + 8 * e, kj = j0 + j;
    const bool live = qi < s.S && kj < s.T
                      && (!s.causal || kj <= qi + s.T - s.S);
    float u = sc[e] * s.scale, dcap = 1.f;
    if (s.softcap > 0.f) {
      const float t = tanhf(u / s.softcap);
      u = s.softcap * t;
      dcap = 1.f - t * t;
    }
    const float p = live ? expf(u - lse) : 0.f;
    sm[L::p + i * C + j] = p;
    sm[L::ds + i * C + j] = p * (dp[e] - dsum) * dcap * s.scale;
  }
}

// acc[0, HD / 8): dK, acc[HD / 8, HD / 4): dV
template <int HD>
FB_FN void acc_dkdv(const float* sm, float* acc, int tid) {
  using L = Tile<HD>;
  const int j = tid / 8, dl = tid % 8;
  for (int i = 0; i < R; ++i) {
    const float p = sm[L::p + i * C + j], ds = sm[L::ds + i * C + j];
    const float* qr = sm + L::q + i * L::LD;
    const float* gr = sm + L::dout + i * L::LD;
FB_UNROLL
    for (int c = 0; c < HD / 8; ++c) {
      acc[c] = fmaf(ds, qr[dl + 8 * c], acc[c]);
      acc[HD / 8 + c] = fmaf(p, gr[dl + 8 * c], acc[HD / 8 + c]);
    }
  }
}

template <int HD>
FB_FN void acc_dq(const float* sm, float* acc, int tid) {
  using L = Tile<HD>;
  const int i = tid / 8, dl = tid % 8;
  for (int j = 0; j < C; ++j) {
    const float ds = sm[L::ds + i * C + j];
    const float* kr = sm + L::k + j * L::LD;
FB_UNROLL
    for (int c = 0; c < HD / 8; ++c) acc[c] = fmaf(ds, kr[dl + 8 * c], acc[c]);
  }
}

// A thread's HD / 8 accumulators (row t / 8 of the tile, columns t % 8 +
// 8 c) into rows row0 .. of one head of dst, rows past `rows` dropped.
template <int HD, typename E>
FB_FN void store_rows(E* dst, const float* acc, int row0, int rows,
                      int64_t stride, int tid) {
  const int g = row0 + tid / 8, dl = tid % 8;
  if (g >= rows) return;
FB_UNROLL
  for (int c = 0; c < HD / 8; ++c)
    put(dst + (int64_t)g * stride + dl + 8 * c, acc[c]);
}

// dK and dV of keys jt * C .. of KV head kvh in batch b: the G query heads
// of the group one after another, each over the query tiles that see the
// keys (causal: rows from j0 - (T - S) on), in a fixed order.
template <int HD, typename E, class Cta>
FB_FN void dkdv_block(Cta& cta, float* sm, const Tensors<E>& t,
                      const Shape& s, int jt, int kvh, int b) {
  using L = Tile<HD>;
  const int j0 = jt * C, G = s.H / s.KV;
  const int64_t ks = (int64_t)s.KV * HD, qs = (int64_t)s.H * HD;
  const int64_t kv_off = ((int64_t)b * s.T * s.KV + kvh) * HD;
  cta.each([&](int tid, float* acc) {
FB_UNROLL
    for (int c = 0; c < HD / 4; ++c) acc[c] = 0.f;
    load_rows<HD, C>(sm + L::k, t.k + kv_off, j0, s.T, ks, tid);
    load_rows<HD, C>(sm + L::v, t.v + kv_off, j0, s.T, ks, tid);
  });
  const int first = s.causal && j0 > s.T - s.S ? j0 - (s.T - s.S) : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t q_off = ((int64_t)b * s.S * s.H + h) * HD;
    const int64_t r_off = ((int64_t)b * s.H + h) * s.S;
    for (int i0 = first / R * R; i0 < s.S; i0 += R) {
      cta.each([&](int tid, float*) {
        load_rows<HD, R>(sm + L::q, t.q + q_off, i0, s.S, qs, tid);
        load_rows<HD, R>(sm + L::dout, t.dout + q_off, i0, s.S, qs, tid);
        load_vec(sm + L::lse, t.lse + r_off, i0, s.S, tid);
        load_vec(sm + L::dsum, t.dsum + r_off, i0, s.S, tid);
      });
      cta.each([&](int tid, float*) { score_tile<HD>(sm, i0, j0, s, tid); });
      cta.each([&](int tid, float* acc) { acc_dkdv<HD>(sm, acc, tid); });
    }
  }
  cta.each([&](int tid, float* acc) {
    store_rows<HD>(t.dk + kv_off, acc, j0, s.T, ks, tid);
    store_rows<HD>(t.dv + kv_off, acc + HD / 8, j0, s.T, ks, tid);
  });
}

// dQ of query rows it * R .. of head h in batch b, over the key tiles up
// to the last row's causal diagonal.
template <int HD, typename E, class Cta>
FB_FN void dq_block(Cta& cta, float* sm, const Tensors<E>& t,
                    const Shape& s, int it, int h, int b) {
  using L = Tile<HD>;
  const int i0 = it * R, kvh = h / (s.H / s.KV);
  const int64_t ks = (int64_t)s.KV * HD, qs = (int64_t)s.H * HD;
  const int64_t q_off = ((int64_t)b * s.S * s.H + h) * HD;
  const int64_t kv_off = ((int64_t)b * s.T * s.KV + kvh) * HD;
  const int64_t r_off = ((int64_t)b * s.H + h) * s.S;
  const int last = (i0 + R < s.S ? i0 + R : s.S) - 1;
  const int k_end = s.causal && last + s.T - s.S + 1 < s.T
                        ? last + s.T - s.S + 1 : s.T;
  cta.each([&](int tid, float* acc) {
FB_UNROLL
    for (int c = 0; c < HD / 8; ++c) acc[c] = 0.f;
    load_rows<HD, R>(sm + L::q, t.q + q_off, i0, s.S, qs, tid);
    load_rows<HD, R>(sm + L::dout, t.dout + q_off, i0, s.S, qs, tid);
    load_vec(sm + L::lse, t.lse + r_off, i0, s.S, tid);
    load_vec(sm + L::dsum, t.dsum + r_off, i0, s.S, tid);
  });
  for (int j0 = 0; j0 < k_end; j0 += C) {
    cta.each([&](int tid, float*) {
      load_rows<HD, C>(sm + L::k, t.k + kv_off, j0, s.T, ks, tid);
      load_rows<HD, C>(sm + L::v, t.v + kv_off, j0, s.T, ks, tid);
    });
    cta.each([&](int tid, float*) { score_tile<HD>(sm, i0, j0, s, tid); });
    cta.each([&](int tid, float* acc) { acc_dq<HD>(sm, acc, tid); });
  }
  cta.each([&](int tid, float* acc) {
    store_rows<HD>(t.dq + q_off, acc, i0, s.S, qs, tid);
  });
}

// One lane's share of D for one row of O and dO: columns lane, lane + 32,
// ... (the pre-pass adds the 32 shares by a butterfly over the warp).
template <int HD, typename E>
FB_FN float dsum_part(const E* o, const E* dout, int lane) {
  float a = 0.f;
  for (int d = lane; d < HD; d += 32) a = fmaf(to_f(o[d]), to_f(dout[d]), a);
  return a;
}

}  // namespace flash_bwd
