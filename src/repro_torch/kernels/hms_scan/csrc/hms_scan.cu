// The HMS engine's sequential scan on the card, and its float64 EMA.
//
// hms_scan replaces the reference's XLA scan over the engine step
// (src/repro/core/simulator.py:502-582, with src/repro/core/ctc.py:196-239
// inside it); ema_scan replaces the float64 moving-average scan
// (simulator.py:418-425).  Neither has a Pallas counterpart: XLA compiled
// both from lax.scan.
//
// What bounds hms_scan: a step reads the state earlier steps wrote, so the
// work is chains of dependent steps and the card's bandwidth and arithmetic
// rates do not enter (a 250k-request lane moves ~4 MB).  But a lane is not
// one chain: a step touches one cache word and one CTC row, and the steps of
// different domains (row_group % n_sets under a CTC policy, a row-group
// residue without one; hms_step.cuh) touch disjoint state.  The bound is the
// longest domain chain times the latency of one step.
//
// The design: one CTA per chain c = lane * n_domains + domain, grid
// (n_domains, lanes).  A lane is one config x shard x temporal segment of a
// sweep, with its own CTC ways (lane_ways[l]) and domain count (fig18's CTC
// fractions give configs of one batch different set counts): n_domains is
// the most of any lane, and a lane's chains past its own count are empty
// runs, whose CTA exits at once.  The lane and domain are the CTA's
// coordinates, so the compiler keeps them and everything derived from them
// in uniform registers (a lane read from a per-chain table in device memory
// cost 11% a step).  The wrapper (ops.py) checks that the domains split each lane's
// state and sorts the steps stably by chain, so a chain's steps are one
// contiguous run [offsets[c], offsets[c + 1]) of the sorted slot and meta
// streams, in stream order; the kernel writes each step's decision word at
// its sorted position and the wrapper scatters them back.  A lane starts
// from the cache words and CTC rows the wrapper puts in its state buffers
// (cold, or a temporal segment's boundary guess) and leaves its final state
// there; a step whose meta lacks the live bit (padding, and the replay
// prefix of a segment after the stitch's warm-up round) changes no state.  A CTA stages its run into shared
// memory by bulk copies (TMA), TILE steps a tile, RING tiles ahead, each
// tile's arrival counted on an mbarrier, so no chain waits on device memory
// for its inputs.  A step's cache-word half and its CTC half are two chains:
// the word update does not read the CTC's answer (hms_step.cuh).
//   * The word warp runs the cache-word chains on the lane's `cache` (L1
//     holds a chain's words).  __match_any_sync groups 32 staged steps by
//     word; the first thread of a group runs the group's steps in stream
//     order with the word in a register, groups on distinct words at once.
//   * Under a CTC policy a second warp, the row warp, runs the CTC chain:
//     the domain's one CTC row in registers, one way per thread (two above
//     32 ways, four above 64: ops.kernel_tier, at most 128 ways).  The probe is one __reduce_max_sync of a packed key
//     (ctc_key) whose maximum names the way, its age, the sector hit and the
//     line hit; the LRU touch is one update per thread on its own way; the
//     next step's meta is read before this step's reduction.  It joins each
//     step's hit with the word warp's half of the decision (ybuf, released
//     per tile on an mbarrier) into y, and stages the tiles, as the slower
//     of the two.  The row goes back at the end.
// Without a CTC the CTA is the word warp alone, writing y itself.

// ema_scan is one CTA: a producer thread stages v by bulk copy into a double
// buffer, the other threads of warps 1-3 round weight * v in place off the
// chain, and one thread runs the recurrence from shared memory into an
// output tile that goes back by bulk copy (ema_tile.cuh).  The recurrence
// stays sequential and rounded after every operation (no FMA contraction),
// or the averages differ from the plain version in the last bit; the build
// passes --fmad=false as well.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "ema_tile.cuh"
#include "hms_step.cuh"

namespace {

constexpr int TILE = 256;  // stream entries per staged tile
constexpr int RING = 8;    // staged tiles
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` has completed; a wait that never
// ends (a lost copy) traps after 2^26 polls instead of hanging the stream.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Bulk copy from shared memory to device memory, in the thread's bulk
// group.  The generic-proxy writes to `src` are fenced first.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// ---- hms_scan -----------------------------------------------------------

struct StreamRing {  // shared memory
  uint64_t full[RING];       // a tile's bulk copies have landed
  uint64_t ydone[RING];      // the word warp has written a tile's ybuf
  int32_t slot[RING][TILE];
  int64_t meta[RING][TILE];
  int32_t ybuf[RING][TILE];  // word half of the decision (CTC policies)
};
static_assert(offsetof(StreamRing, slot) % 16 == 0, "bulk copy alignment");
static_assert(offsetof(StreamRing, meta) % 16 == 0, "bulk copy alignment");

// A chain's run of the sorted streams.  Tiles start at `a0`, the run's
// start rounded down to 4 entries, and end at `e4`, its end rounded up (the
// streams are padded to a multiple of 4), so every bulk copy moves whole 16
// bytes from 16-byte aligned addresses; entries outside [b, e) belong to
// other chains and are skipped.
struct ChainRun {
  int64_t b, e, a0, e4, n_tiles;
  __device__ ChainRun(const int64_t* offsets, int64_t c)
      : b(offsets[c]), e(offsets[c + 1]), a0(b & ~(int64_t)3),
        e4((e + 3) & ~(int64_t)3),
        n_tiles(b < e ? (e4 - a0 + TILE - 1) / TILE : 0) {}
  __device__ int64_t start(int64_t k) const { return a0 + k * TILE; }
  __device__ int count(int64_t k) const {
    const int64_t rest = e4 - start(k);
    return (int)(rest < TILE ? rest : TILE);
  }
};

// Stage tile k of the chain's run into its ring slot.
__device__ __forceinline__ void stage_tile(StreamRing& ring,
                                           const int32_t* slot,
                                           const int64_t* meta,
                                           const ChainRun& run, int64_t k) {
  const int b = (int)(k % RING);
  const int64_t t0 = run.start(k);
  const uint32_t c = (uint32_t)run.count(k);
  mbar_expect_tx(&ring.full[b], 12 * c);
  bulk_load(ring.slot[b], slot + t0, 4 * c, &ring.full[b]);
  bulk_load(ring.meta[b], meta + t0, 8 * c, &ring.full[b]);
}

// The word warp's pass over one staged tile (entries t0 + i, i < cnt, of
// which [b, e) are the chain's), 32 entries at a time.  __match_any_sync
// groups the steps by the word they touch; the first thread of each group
// runs the group's steps in stream order with the word in a register, so
// groups on distinct words run at once.  Without a CTC the decision word is
// final and goes to y; under a CTC policy its word half goes to ybuf as
// y | y_ctc << 8, for the row warp.
template <int P>
__device__ __forceinline__ void word_tile(StreamRing& ring, int buf,
                                          int64_t t0, int cnt,
                                          const ChainRun& run,
                                          int32_t* __restrict__ words,
                                          int32_t* __restrict__ y) {
  typedef HmsPolicyTraits<P> T;
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < cnt; c += 32) {
    const int64_t t = t0 + c + lane;
    const bool mine = c + lane < cnt && t >= run.b && t < run.e;
    const int32_t idx = ring.slot[buf][c + lane];
    uint32_t group = __match_any_sync(FULL, mine ? idx : -1 - lane);
    if (mine && (group & ((1u << lane) - 1)) == 0) {
      int32_t w = words[idx];
      int j = lane;
      int64_t m = ring.meta[buf][c + j];
      for (;;) {
        group &= group - 1;
        const int jn = group ? __ffs(group) - 1 : j;
        const int64_t mn = ring.meta[buf][c + jn];  // the next step's
        const HmsWordStep st = hms_word_step<P>(w, m);
        if (hms_live(m)) w = st.word;
        if (T::use_ctc)
          ring.ybuf[buf][c + j] = st.y | (st.y_ctc << 8);
        else
          y[t0 + c + j] = hms_decision(st, T::ideal_probe);
        if (!group) break;
        j = jn;
        m = mn;
      }
      words[idx] = w;
    }
    __syncwarp();
  }
}

// The row warp's pass over one staged tile (CTC policies): the chain's
// steps in a counted loop on the CTC row held in registers (way lane + 32 q
// in hi[q], lo[q]), the next step's meta read before this step's reduction.
// Step i's sector hit is kept by thread i % 32 in bit i / 32 of `hits`;
// then each step's hit is joined with the word warp's half of its decision
// into y.
template <int WPT>
__device__ __forceinline__ void row_tile(StreamRing& ring, int buf,
                                         int64_t t0, int cnt,
                                         const ChainRun& run, int e_ways,
                                         uint32_t (&hi)[WPT],
                                         uint32_t (&lo)[WPT],
                                         int32_t* __restrict__ y) {
  static_assert(TILE <= 32 * 32, "one hit bit a step per thread");
  const int lane = threadIdx.x & 31;
  const int i0 = run.b > t0 ? (int)(run.b - t0) : 0;
  const int i1 = run.e - t0 < cnt ? (int)(run.e - t0) : cnt;
  uint32_t hits = 0;
  int64_t m = ring.meta[buf][i0];
  for (int i = i0; i < i1; ++i) {
    const int64_t mn = ring.meta[buf][i + 1 < i1 ? i + 1 : i];  // the next's
    const uint32_t want = (uint32_t)hms_row_group(m) + 1;
    const uint32_t secbit = 1u << ((m >> 3) & 0x1F);
    uint32_t key = 0;
#pragma unroll
    for (int q = 0; q < WPT; ++q) {
      const int w = lane + 32 * q;
      const uint32_t kq = ctc_key(hi[q], lo[q], w, want, secbit, w < e_ways);
      key = kq > key ? kq : key;
    }
    const uint32_t best = __reduce_max_sync(FULL, key);
    const bool live = hms_live(m);  // a padded step leaves the row alone
#pragma unroll
    for (int q = 0; q < WPT; ++q) {
      uint32_t h = hi[q], l = lo[q];
      ctc_touch(h, l, lane + 32 * q, best, want, secbit);
      hi[q] = live ? h : hi[q];
      lo[q] = live ? l : lo[q];
    }
    hits |= (uint32_t)(ctc_key_sector_hit(best) && (i & 31) == lane)
            << (i >> 5);
    m = mn;
  }
  for (int i = lane; i < cnt; i += 32) {
    if (i < i0 || i >= i1) continue;
    const int32_t e = ring.ybuf[buf][i];
    y[t0 + i] = (e & 0xFF) | ((hits >> (i >> 5)) & 1 ? e >> 8 : 0);
  }
  __syncwarp();
}

// One CTA per chain c = lane * n_domains + domain.  Without a CTC it is one
// warp, the word warp.  Under a CTC policy it is two: warp 0 the row warp
// (the CTC chain, which also stages the tiles, as the slower of the two),
// warp 1 the word warp; both read the same staged tiles.
template <int P, int WPT>
__global__ void __launch_bounds__(64)
    hms_chain_kernel(const int32_t* __restrict__ slot,
                     const int64_t* __restrict__ meta,
                     const int64_t* __restrict__ offsets,
                     const int32_t* __restrict__ lane_ways,
                     int32_t* __restrict__ cache, int64_t lines_alloc,
                     int64_t* __restrict__ ctc, int sets_alloc,
                     int ways_alloc, int n_domains,
                     int32_t* __restrict__ y) {
  typedef HmsPolicyTraits<P> T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StreamRing& ring = *reinterpret_cast<StreamRing*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const bool row_warp = T::use_ctc && threadIdx.x < 32;
  const int d = blockIdx.x;                // the domain, and its CTC row
  const int64_t l = blockIdx.y;
  const ChainRun run(offsets, l * n_domains + d);
  if (run.n_tiles == 0) return;           // no steps: the state stands
  const int e_ways = lane_ways[l];
  int32_t* words = cache + l * lines_alloc;

  if (threadIdx.x == 0) {
    for (int b = 0; b < RING; ++b) {
      mbar_init(&ring.full[b], 1);
      mbar_init(&ring.ydone[b], 32);  // every thread of the word warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int64_t k = 0; k < RING && k < run.n_tiles; ++k)
      stage_tile(ring, slot, meta, run, k);
  }
  __syncthreads();

  if (row_warp) {
    int64_t* row = ctc + ((int64_t)l * sets_alloc + d) * ways_alloc;
    uint32_t hi[WPT], lo[WPT];
#pragma unroll
    for (int q = 0; q < WPT; ++q) {
      const int w = lane + 32 * q;
      const int64_t r = w < ways_alloc ? row[w] : 0;
      hi[q] = (uint32_t)(r >> 32);
      lo[q] = (uint32_t)r;
    }
    for (int64_t k = 0; k < run.n_tiles; ++k) {
      const int b = (int)(k % RING);
      const uint32_t parity = (uint32_t)((k / RING) & 1);
      mbar_wait(&ring.full[b], parity);
      mbar_wait(&ring.ydone[b], parity);
      row_tile<WPT>(ring, b, run.start(k), run.count(k), run, e_ways, hi,
                    lo, y);
      if (lane == 0 && k + RING < run.n_tiles)
        stage_tile(ring, slot, meta, run, k + RING);
    }
#pragma unroll
    for (int q = 0; q < WPT; ++q) {
      const int w = lane + 32 * q;
      if (w < ways_alloc) row[w] = (int64_t)(((uint64_t)hi[q] << 32) | lo[q]);
    }
    return;
  }

  for (int64_t k = 0; k < run.n_tiles; ++k) {
    const int b = (int)(k % RING);
    mbar_wait(&ring.full[b], (uint32_t)((k / RING) & 1));
    word_tile<P>(ring, b, run.start(k), run.count(k), run, words, y);
    if (T::use_ctc) {
      mbar_arrive(&ring.ydone[b]);  // releases ybuf[b] to the row warp
    } else if (lane == 0 && k + RING < run.n_tiles) {
      stage_tile(ring, slot, meta, run, k + RING);
    }
  }
}

struct ChainArgs {
  const int32_t* slot;
  const int64_t* meta;
  const int64_t* offsets;
  const int32_t* lane_ways;
  int lanes;
  int32_t* cache;
  int64_t lines_alloc;
  int64_t* ctc;
  int sets_alloc, ways_alloc, n_domains;
  int32_t* y;
};

template <int P, int WPT>
cudaError_t launch_chains(const ChainArgs& a, cudaStream_t stream) {
  auto kernel = hms_chain_kernel<P, WPT>;
  const size_t smem = sizeof(StreamRing);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = HmsPolicyTraits<P>::use_ctc ? 64 : 32;
  kernel<<<dim3(a.n_domains, a.lanes), threads, smem, stream>>>(
      a.slot, a.meta, a.offsets, a.lane_ways, a.cache, a.lines_alloc, a.ctc,
      a.sets_alloc, a.ways_alloc, a.n_domains, a.y);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_scan(const ChainArgs& a, cudaStream_t s) {
  if (a.ways_alloc > 128 || a.lanes > 65535) return cudaErrorInvalidValue;
  if (a.lanes == 0 || a.n_domains == 0) return cudaSuccess;
  if (HmsPolicyTraits<P>::use_ctc && a.ways_alloc > 64)
    return launch_chains<P, 4>(a, s);
  if (HmsPolicyTraits<P>::use_ctc && a.ways_alloc > 32)
    return launch_chains<P, 2>(a, s);
  return launch_chains<P, 1>(a, s);
}

// ---- ema_scan -----------------------------------------------------------

constexpr int EMA_THREADS = 128;

__global__ void __launch_bounds__(EMA_THREADS)
    ema_scan_kernel(const double* __restrict__ v, int64_t n, double weight,
                    double* __restrict__ out) {
  __shared__ __align__(16) double vbuf[2][EMA_TILE];
  __shared__ __align__(16) double obuf[2][EMA_TILE];
  __shared__ __align__(8) uint64_t full[2];
  const int tid = threadIdx.x;
  const bool chain = tid == 0;       // runs the recurrence
  const bool producer = tid == 32;   // stages v
  const bool helper = tid >= 32;     // rounds weight * v
  const int64_t n_tiles = ema_tiles(n);

  auto stage = [&](int64_t k) {      // tile k of v into vbuf[k & 1]
    const int b = (int)(k & 1);
    const int64_t c = ema_tile_count(n, k), bulk = ema_bulk_count(c);
    if (c & 1) vbuf[b][c - 1] = v[k * EMA_TILE + c - 1];
    mbar_expect_tx(&full[b], (uint32_t)(8 * bulk));
    if (bulk) bulk_load(vbuf[b], v + k * EMA_TILE, (uint32_t)(8 * bulk),
                        &full[b]);
  };
  auto scale = [&](int64_t k) {      // wv = weight * v in place
    const int b = (int)(k & 1);
    mbar_wait(&full[b], (uint32_t)((k >> 1) & 1));
    const int64_t c = ema_tile_count(n, k);
    for (int64_t i = tid - 32; i < c; i += EMA_THREADS - 32)
      vbuf[b][i] = ema_mul(weight, vbuf[b][i]);
    // the next bulk copy into this buffer must follow these writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  if (chain) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer) {
    for (int64_t k = 0; k < 2 && k < n_tiles; ++k) stage(k);
  }
  if (helper && n_tiles > 0) scale(0);
  __syncthreads();

  const double keep = ema_add(1.0, -weight);
  double avg = 0.0;
  for (int64_t k = 0; k < n_tiles; ++k) {
    const int b = (int)(k & 1);
    if (chain) {
      const int64_t c = ema_tile_count(n, k), bulk = ema_bulk_count(c);
      // obuf[b]'s store from tile k - 2 must have read it
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      avg = ema_tile(vbuf[b], c, keep, avg, obuf[b]);
      if (bulk) bulk_store(out + k * EMA_TILE, obuf[b], (uint32_t)(8 * bulk));
      if (c & 1) out[k * EMA_TILE + c - 1] = obuf[b][c - 1];
    } else if (helper && k + 1 < n_tiles) {
      scale(k + 1);
    }
    __syncthreads();
    if (producer && k + 2 < n_tiles) stage(k + 2);
  }
  if (chain) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" int hms_scan_launch(int policy, const int32_t* slot,
                               const int64_t* meta, const int64_t* offsets,
                               const int32_t* lane_ways, int lanes,
                               int32_t* cache, int64_t lines_alloc,
                               int64_t* ctc, int sets_alloc, int ways_alloc,
                               int n_domains, int32_t* y, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const ChainArgs a{slot,        meta,       offsets,   lane_ways,
                    lanes,       cache,      lines_alloc, ctc,
                    sets_alloc,  ways_alloc, n_domains, y};
#define HMS_CASE(p) \
  case p:           \
    return (int)launch_scan<p>(a, s);
  switch (policy) {
    HMS_CASE(P_HMS)
    HMS_CASE(P_NO_BYPASS)
    HMS_CASE(P_NO_BYPASS_NO_CTC)
    HMS_CASE(P_NO_SECOND_LEVEL)
    HMS_CASE(P_BEAR)
    HMS_CASE(P_REDCACHE)
    HMS_CASE(P_MCCACHE)
    HMS_CASE(P_ALWAYS_CACHE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HMS_CASE
}

extern "C" int ema_scan_launch(const double* v, int64_t n, double weight,
                               double* out, void* stream) {
  ema_scan_kernel<<<1, EMA_THREADS, 0, (cudaStream_t)stream>>>(v, n, weight,
                                                                out);
  return (int)cudaGetLastError();
}
