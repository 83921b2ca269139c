// The UM paging engine's scan on the card.
//
// um_scan replaces the reference's XLA scan over the paging step
// (src/repro/um/engine.py, `step` in `_make_um_engine`, :226-294, vmapped
// over UMSpec lanes and temporal segments).  There is no Pallas
// counterpart: XLA compiled it from lax.scan.
//
// What bounds it: each lane is one chain of dependent steps.  Chunked
// migration couples neighbouring pages and the eviction window reads frames
// that any earlier step may have written, so a lane does not split into
// state-disjoint chains as hms_scan's do.  But between two migrations a step
// only adds one to its page's access count (counts commute) and may set its
// dirty flag (idempotent); no page's residence and no frame changes.  So
// the chain that remains is one dependent round trip (about 30 cycles) for
// each migrating step and for each pass of up to 32 hit steps: for the
// slowest lane, (migrating steps + ceil(hit steps / 32)) x 30 cycles at
// 1980 MHz (chip_smoke's um_bounds; a kernel that steps one request at a
// time is held to n x 30 cycles).  The bytes are negligible: a 240k-request stream of page,
// write flag and phase is about 2.2 MB, under a microsecond at 3.35 TB/s.
// Lanes are independent and run side by side on separate SMs.
//
// The design: one CTA of one warp per lane (grid = lanes).  A lane is one
// UMSpec x temporal segment: lane l walks row l % segs of the request
// streams (rows row_stride apart; one row, the whole trace, at T = 1) from
// the state in its buffers (access counts and frames int32, resident and
// dirty flags, the hand: cold, or the segment's boundary guess with the
// frame ring rotated so the hand is at 0), and leaves its final state
// there.  Each step's flags byte carries its write and the segment's
// `real` and `live` gates (um_step.cuh).  The request stream comes through a ring in shared memory that
// cp.async fills ahead of the walk (3-17% faster than loading each pass's
// requests from device memory, on an H100).  A pass (um_step.cuh, um_lane)
// gives each thread one of the next 32 requests, reads its page's resident
// flag, and finds the first migrating step with one ballot: in fault mode
// the first step on a page that is not resident; in nvlink mode the first
// such step whose access count reaches the threshold, the count being the
// page's count (read for those steps only) plus its earlier steps in the
// pass (__match_any_sync).  The steps before it take effect at once: their
// counts are added by reductions in device memory that nothing waits for,
// writes to resident pages set dirty flags, nvlink steps to pages that are
// not resident count as remote; each step's events go to its own phase's
// int64 counter by the same reductions, so interleaved phases (the
// scenarios change phase every 1-3 requests) do not cut passes.  The
// migrating step (um_migrate) reads the window's frames loaded when the
// last migration ended, then the candidates' counts and dirty flags and the
// chunk's resident flags in one round trip; up to 32 candidates (chunks up
// to 8, nvlink) it takes the victims one by one by warp minimum, above that
// it ranks the window from shared memory; its writes need no order between
// threads.  um_walk instantiates the walk per window tier (32, 64, 128 or
// 256 candidates, 1-8 a thread) so a lane pays for its own window only.  The
// wrapper turns the counts into float64 once, so the per-phase sums are
// exact.
//
// um_scan_host runs the same walk on the host, lane after lane: it is the
// kernel's oracle at sizes where the plain PyTorch loop is too slow.

#include <cuda_runtime.h>
#include <stdint.h>

#include "um_step.cuh"

namespace {

// One lane's state, at its offset in the wrapper's [lanes, ...] buffers.
// params: int32[lanes, 4] = (n_frames, chunk, nvlink, hot_thresh).
__host__ __device__ inline UmLane lane_state(
    int l, const int32_t* params, int32_t n_pages, uint8_t* resident,
    uint8_t* dirty, int64_t pages_alloc, int32_t* frames,
    int64_t frames_alloc, int32_t* hotness, const int32_t* ptr) {
  UmLane L;
  L.resident = resident + (int64_t)l * (pages_alloc + 1);
  L.dirty = dirty + (int64_t)l * (pages_alloc + 1);
  L.frames = frames + (int64_t)l * (frames_alloc + 1);
  L.hotness = hotness + (int64_t)l * pages_alloc;
  L.ptr = ptr[l];
  L.n_pages = n_pages;
  L.n_frames = params[4 * l];
  L.chunk = params[4 * l + 1];
  L.nvlink = params[4 * l + 2] != 0;
  L.hot_thresh = params[4 * l + 3];
  return L;
}

// The request stream through a ring in shared memory, filled ahead of the
// walk by cp.async in chunks of RING_CHUNK requests, RING_AHEAD chunks in
// flight, so a pass reads its 32 requests from shared memory.  The stream's
// arrays are 16-byte aligned (the wrapper sees to it); the last chunk's
// copies are cut at the stream's end and zero-filled.
constexpr int RING_CHUNK = 256;
constexpr int RING_AHEAD = 6;
constexpr int RING_SLOTS = RING_AHEAD + 2;  // + the chunks a pass may read
constexpr int RING = RING_CHUNK * RING_SLOTS;

struct UmRing {
  int32_t page[RING];
  int32_t phase[RING];
  uint8_t flags[RING];
};

__device__ inline void copy16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

struct RingStream {
  UmRing* ring;
  const int32_t* page_;
  const uint8_t* flags_;
  const int32_t* phase_;
  int64_t n;
  int64_t have;  // chunks [0, have] are in the ring
  int lane;

  // Copy chunk c into its slot (a group of copies, empty past the end).
  __device__ void issue(int64_t c) {
    const int64_t e0 = c * RING_CHUNK;
    const int slot = (int)(c % RING_SLOTS) * RING_CHUNK;
    if (e0 < n) {
      for (int v = lane; v < RING_CHUNK / 4; v += 32) {
        const int64_t e = e0 + 4 * v;
        const int bytes = e < n ? (n - e < 4 ? (int)(n - e) * 4 : 16) : 0;
        copy16(&ring->page[slot + 4 * v], bytes ? page_ + e : page_, bytes);
        if (phase_)
          copy16(&ring->phase[slot + 4 * v], bytes ? phase_ + e : phase_,
                 bytes);
      }
      if (lane < RING_CHUNK / 16) {
        const int64_t e = e0 + 16 * lane;
        const int bytes = e < n ? (n - e < 16 ? (int)(n - e) : 16) : 0;
        copy16(&ring->flags[slot + 16 * lane], bytes ? flags_ + e : flags_,
               bytes);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // Every group but the RING_AHEAD newest has landed, for every thread.
  __device__ void settle() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING_AHEAD));
    __syncwarp();
  }
  __device__ void start() {
    for (int c = 0; c <= RING_AHEAD; ++c) issue(c);
    settle();
    have = 0;
  }
  // A pass reads [t, t + 32): at most one chunk more than the last pass.
  __device__ void ready(int64_t t) {
    const int64_t c = (t + UM_BATCH - 1) / RING_CHUNK;
    if (c > have) {
      issue(c + RING_AHEAD);
      settle();
      have = c;
    }
  }
  __device__ int32_t page(int64_t i) const { return ring->page[i % RING]; }
  __device__ uint8_t flags(int64_t i) const { return ring->flags[i % RING]; }
  __device__ int32_t phase(int64_t i) const {
    return phase_ ? ring->phase[i % RING] : 0;
  }
};

__global__ void __launch_bounds__(32)
    um_scan_kernel(const int32_t* __restrict__ page,
                   const uint8_t* __restrict__ flags,
                   const int32_t* __restrict__ phase, int64_t n,
                   int64_t row_stride, int segs, int n_phases,
                   const int32_t* __restrict__ params, int32_t n_pages,
                   uint8_t* resident, uint8_t* dirty, int64_t pages_alloc,
                   int32_t* frames, int64_t frames_alloc, int32_t* hotness,
                   int32_t* ptr, int64_t* counts) {
  __shared__ UmWork wk;
  __shared__ __align__(16) UmRing ring;
  const int l = blockIdx.x;
  const int lane = threadIdx.x;
  UmLane L = lane_state(l, params, n_pages, resident, dirty, pages_alloc,
                        frames, frames_alloc, hotness, ptr);
  const int64_t row = (int64_t)(l % segs) * row_stride;
  RingStream src{&ring, page + row, flags + row,
                 phase ? phase + row : nullptr, n, 0, lane};
  src.start();
  um_walk<32>(src, n, n_phases, L, wk, counts + (int64_t)l * 4 * n_phases,
              lane);
  if (lane == 0) ptr[l] = L.ptr;
}

}  // namespace

extern "C" int um_scan_launch(const int32_t* page, const uint8_t* flags,
                              const int32_t* phase, int64_t n,
                              int64_t row_stride, int segs, int n_phases,
                              const int32_t* params, int lanes,
                              int32_t n_pages, uint8_t* resident,
                              uint8_t* dirty, int64_t pages_alloc,
                              int32_t* frames, int64_t frames_alloc,
                              int32_t* hotness, int32_t* ptr,
                              int64_t* counts, void* stream) {
  if (lanes <= 0) return 0;
  if (segs < 1 || (segs > 1 && row_stride % 16)) return 1;
  um_scan_kernel<<<lanes, 32, 0, (cudaStream_t)stream>>>(
      page, flags, phase, n, row_stride, segs, n_phases, params, n_pages,
      resident, dirty, pages_alloc, frames, frames_alloc, hotness, ptr,
      counts);
  return (int)cudaGetLastError();
}

// The same walk on host memory, one lane after another, on one thread
// (left out of the device pass, which would otherwise build the one-thread
// walk for the device too).
#ifndef __CUDA_ARCH__
extern "C" int um_scan_host(const int32_t* page, const uint8_t* flags,
                            const int32_t* phase, int64_t n,
                            int64_t row_stride, int segs, int n_phases,
                            const int32_t* params, int lanes,
                            int32_t n_pages, uint8_t* resident,
                            uint8_t* dirty, int64_t pages_alloc,
                            int32_t* frames, int64_t frames_alloc,
                            int32_t* hotness, int32_t* ptr,
                            int64_t* counts) {
  if (segs < 1) return 1;
  UmWork wk;
  for (int l = 0; l < lanes; ++l) {
    UmLane L = lane_state(l, params, n_pages, resident, dirty, pages_alloc,
                          frames, frames_alloc, hotness, ptr);
    const int64_t row = (int64_t)(l % segs) * row_stride;
    UmStream src{page + row, flags + row, phase ? phase + row : nullptr,
                 flags + row};
    um_walk<1>(src, n, n_phases, L, wk, counts + (int64_t)l * 4 * n_phases,
               0);
    ptr[l] = L.ptr;
  }
  return 0;
}
#endif
