// The HMS engine's sequential scan on the card, and its float64 EMA.
//
// hms_scan replaces the reference's XLA scan over the engine step
// (src/repro/core/simulator.py:502-582, with src/repro/core/ctc.py:196-239
// inside it); ema_scan replaces the float64 moving-average scan
// (simulator.py:418-425).  Neither has a Pallas counterpart: XLA compiled
// both from lax.scan.
//
// What bounds it: every step of a lane reads the state the previous step
// wrote, so a lane is a chain of dependent steps and the card's bandwidth
// and arithmetic rates do not enter (a 250k-request lane moves ~4 MB of
// input).  The bound is the dependent latency of one step times the depth.
// The design keeps that latency short: one thread per lane, the lane's CTC
// rows (sets_alloc x ways_alloc int64, e.g. 16 x 16 x 8 B = 2 KiB) staged in
// shared memory, the policy's branches resolved at compile time, and the
// cache words (<= 256 KiB per lane at the workloads' footprints) in global
// memory, where L1/L2 hold them.  Lanes are state-disjoint shards, so they
// run in parallel with no communication.
//
// ema_scan is one thread: the recurrence must stay sequential and rounded
// after every operation (no FMA contraction), or the averages differ from
// the plain version in the last bit.  The build passes --fmad=false as
// well, and the arithmetic below is written with explicit _rn intrinsics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hms_step.cuh"

template <int P>
__global__ void hms_scan_kernel(const int32_t* __restrict__ slot,
                                const int64_t* __restrict__ meta,
                                int lanes, int64_t depth,
                                int32_t* __restrict__ cache,
                                int64_t lines_alloc,
                                int64_t* __restrict__ ctc, int ctc_words,
                                int ways_alloc, int e_ways, int n_sets,
                                int use_smem, int32_t* __restrict__ y) {
  extern __shared__ int64_t smem[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;  // no block-wide barrier below
  int64_t* g_ctc = ctc + (int64_t)lane * ctc_words;
  int64_t* s_ctc = use_smem ? smem + (int64_t)threadIdx.x * ctc_words : g_ctc;
  if (use_smem) {
    for (int i = 0; i < ctc_words; ++i) s_ctc[i] = g_ctc[i];
  }
  hms_lane<P>(slot + lane * depth, meta + lane * depth, depth,
              cache + lane * lines_alloc, s_ctc, ways_alloc, e_ways, n_sets,
              y + lane * depth);
  if (use_smem) {
    for (int i = 0; i < ctc_words; ++i) g_ctc[i] = s_ctc[i];
  }
}

template <int P>
static cudaError_t launch_scan(const int32_t* slot, const int64_t* meta,
                               int lanes, int64_t depth, int32_t* cache,
                               int64_t lines_alloc, int64_t* ctc,
                               int sets_alloc, int ways_alloc, int e_ways,
                               int n_sets, int32_t* y, cudaStream_t stream) {
  const int ctc_words = sets_alloc * ways_alloc;
  const size_t lane_bytes = (size_t)ctc_words * sizeof(int64_t);
  // lanes per block: as many as fit in 48 KiB of shared memory, up to 32
  int per_block = (int)(48 * 1024 / (lane_bytes ? lane_bytes : 1));
  if (per_block > 32) per_block = 32;
  if (per_block > lanes) per_block = lanes;
  int use_smem = per_block >= 1;
  if (!use_smem) per_block = 1;  // rows too large: carry them in global
  const size_t smem = use_smem ? per_block * lane_bytes : 0;
  const int blocks = (lanes + per_block - 1) / per_block;
  hms_scan_kernel<P><<<blocks, per_block, smem, stream>>>(
      slot, meta, lanes, depth, cache, lines_alloc, ctc, ctc_words,
      ways_alloc, e_ways, n_sets, use_smem, y);
  return cudaGetLastError();
}

extern "C" int hms_scan_launch(int policy, const int32_t* slot,
                               const int64_t* meta, int lanes, int64_t depth,
                               int32_t* cache, int64_t lines_alloc,
                               int64_t* ctc, int sets_alloc, int ways_alloc,
                               int e_ways, int n_sets, int32_t* y,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define HMS_CASE(p)                                                        \
  case p:                                                                  \
    return (int)launch_scan<p>(slot, meta, lanes, depth, cache,            \
                               lines_alloc, ctc, sets_alloc, ways_alloc,   \
                               e_ways, n_sets, y, s);
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

__global__ void ema_scan_kernel(const double* __restrict__ v, int64_t n,
                                double weight, double* __restrict__ out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const double keep = __dadd_rn(1.0, -weight);
  double avg = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    avg = __dadd_rn(__dmul_rn(keep, avg), __dmul_rn(weight, v[i]));
    out[i] = avg;
  }
}

extern "C" int ema_scan_launch(const double* v, int64_t n, double weight,
                               double* out, void* stream) {
  ema_scan_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(v, n, weight, out);
  return (int)cudaGetLastError();
}
