// The float64 penalty EMA's tile walk, shared by the ema_scan kernel
// (hms_scan.cu) and a host build in the tests.
//
// The kernel stages v in tiles of EMA_TILE doubles.  A tile's even part
// moves by bulk copy (16-byte multiples); an odd last element moves by a
// plain load and store.  Off the chain, wv = weight * v is rounded on its
// own, as bypass.ema_update rounds it; on the chain,
//   avg = keep * avg + wv    (keep = 1 - weight),
// each operation rounded to nearest with no contraction (explicit _rn
// intrinsics on the card, -ffp-contract=off on the host).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define EMA_HD __host__ __device__
#else
#define EMA_HD
#endif

constexpr int64_t EMA_TILE = 1024;

EMA_HD inline double ema_mul(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}

EMA_HD inline double ema_add(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}

EMA_HD inline int64_t ema_tiles(int64_t n) {
  return (n + EMA_TILE - 1) / EMA_TILE;
}

// Elements of tile k, and the part of them a bulk copy moves.
EMA_HD inline int64_t ema_tile_count(int64_t n, int64_t k) {
  const int64_t rest = n - k * EMA_TILE;
  return rest < EMA_TILE ? rest : EMA_TILE;
}
EMA_HD inline int64_t ema_bulk_count(int64_t c) { return c & ~int64_t(1); }

// The chain over one tile of weighted values: returns the last average.
// The loads of the next EMA_GROUP values are issued before this group's
// chain, so the chain never waits on them.
constexpr int EMA_GROUP = 8;

EMA_HD inline double ema_tile(const double* __restrict__ wv, int64_t c,
                              double keep, double avg,
                              double* __restrict__ out) {
  double next[EMA_GROUP];
  int64_t i = 0;
  if (c >= EMA_GROUP) {
    for (int j = 0; j < EMA_GROUP; ++j) next[j] = wv[j];
  }
  for (; i + EMA_GROUP <= c; i += EMA_GROUP) {
    double cur[EMA_GROUP];
    for (int j = 0; j < EMA_GROUP; ++j) cur[j] = next[j];
    if (i + 2 * EMA_GROUP <= c) {
      for (int j = 0; j < EMA_GROUP; ++j) next[j] = wv[i + EMA_GROUP + j];
    }
    for (int j = 0; j < EMA_GROUP; ++j) {
      avg = ema_add(ema_mul(keep, avg), cur[j]);
      out[i + j] = avg;
    }
  }
  for (; i < c; ++i) {
    avg = ema_add(ema_mul(keep, avg), wv[i]);
    out[i] = avg;
  }
  return avg;
}

// The kernel's walk on the host: each tile staged into a buffer (bulk part,
// then the odd element), scaled, run, and written back the same way.
inline void ema_walk(const double* v, int64_t n, double weight,
                     double* out) {
  static double buf[EMA_TILE], obuf[EMA_TILE];
  const double keep = ema_add(1.0, -weight);
  double avg = 0.0;
  for (int64_t k = 0; k < ema_tiles(n); ++k) {
    const int64_t c = ema_tile_count(n, k), bulk = ema_bulk_count(c);
    const double* src = v + k * EMA_TILE;
    double* dst = out + k * EMA_TILE;
    for (int64_t i = 0; i < bulk; ++i) buf[i] = src[i];
    if (c & 1) buf[c - 1] = src[c - 1];
    for (int64_t i = 0; i < c; ++i) buf[i] = ema_mul(weight, buf[i]);
    avg = ema_tile(buf, c, keep, avg, obuf);
    for (int64_t i = 0; i < bulk; ++i) dst[i] = obuf[i];
    if (c & 1) dst[c - 1] = obuf[c - 1];
  }
}
