// The UM paging engine's scan on the card.
//
// um_scan replaces the reference's XLA scan over the paging step
// (src/repro/um/engine.py, `step` in `_make_um_engine`, :226-294, vmapped
// over UMSpec lanes, at one temporal segment).  There is no Pallas
// counterpart: XLA compiled it from lax.scan.
//
// What bounds it: each lane is one chain of dependent steps.  Chunked
// migration couples neighbouring pages and the eviction window reads frames
// that any earlier step may have written, so a lane does not split into
// state-disjoint chains as hms_scan's do.  The bound is the chain: n steps
// at about 30 cycles each (one dependent L1 round trip) at 1980 MHz, 3.6 ms
// for 240k steps.  The bytes are negligible: a 240k-request stream of page,
// write flag and phase is about 2.2 MB, under a microsecond at 3.35 TB/s.
// Lanes are independent and run side by side on separate SMs.
//
// The design: one CTA of one warp per lane (grid = lanes).  The lane's
// state (access counts and frames int32, resident and dirty flags) lives in
// the wrapper's device buffers, cold when the kernel starts, and L1 and L2
// hold what they can of it: the step is bound by its own chain of dependent
// instructions, not by where the state lives.  (A variant that kept the
// state in shared memory was 1.7-5% faster on an H100 at the registered
// sizes and was dropped for one path at every footprint.)  Every thread
// reads the request and the page's flags (broadcast loads), the next
// request is loaded while the current one runs, and thread 0 writes the
// count and, at the end, the dirty flag.  A migration spreads the chunk's
// pages and the 4 x chunk eviction window over the warp; the victims are
// ranked by a stable rank (no sort: each candidate counts the colder ones
// and the equally cold ones before it); the writes follow in the
// reference's order, one __syncwarp between dependent phases
// (um_step.cuh).  Counts stay in registers per phase and are added to the
// int64 output at phase changes; the wrapper turns them into float64 once,
// so the per-phase sums are exact.
//
// um_scan_host runs the same step on the host, lane after lane: it is the
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
    int64_t frames_alloc, int32_t* hotness) {
  UmLane L;
  L.resident = resident + (int64_t)l * (pages_alloc + 1);
  L.dirty = dirty + (int64_t)l * (pages_alloc + 1);
  L.frames = frames + (int64_t)l * (frames_alloc + 1);
  L.hotness = hotness + (int64_t)l * pages_alloc;
  L.ptr = 0;
  L.n_pages = n_pages;
  L.n_frames = params[4 * l];
  L.chunk = params[4 * l + 1];
  L.nvlink = params[4 * l + 2] != 0;
  L.hot_thresh = params[4 * l + 3];
  return L;
}

__global__ void __launch_bounds__(32)
    um_scan_kernel(const int32_t* __restrict__ page,
                   const uint8_t* __restrict__ is_write,
                   const int32_t* __restrict__ phase, int64_t n,
                   int n_phases, const int32_t* __restrict__ params,
                   int32_t n_pages, uint8_t* resident, uint8_t* dirty,
                   int64_t pages_alloc, int32_t* frames,
                   int64_t frames_alloc, int32_t* hotness, int32_t* ptr,
                   int64_t* counts) {
  __shared__ UmWork wk;
  const int l = blockIdx.x;
  const int lane = threadIdx.x;
  UmLane L = lane_state(l, params, n_pages, resident, dirty, pages_alloc,
                        frames, frames_alloc, hotness);
  um_lane(page, is_write, phase, n, n_phases, L, wk,
          counts + (int64_t)l * 4 * n_phases, lane, 32);
  if (lane == 0) ptr[l] = L.ptr;
}

}  // namespace

extern "C" int um_scan_launch(const int32_t* page, const uint8_t* is_write,
                              const int32_t* phase, int64_t n, int n_phases,
                              const int32_t* params, int lanes,
                              int32_t n_pages, uint8_t* resident,
                              uint8_t* dirty, int64_t pages_alloc,
                              int32_t* frames, int64_t frames_alloc,
                              int32_t* hotness, int32_t* ptr,
                              int64_t* counts, void* stream) {
  if (lanes <= 0) return 0;
  um_scan_kernel<<<lanes, 32, 0, (cudaStream_t)stream>>>(
      page, is_write, phase, n, n_phases, params, n_pages, resident, dirty,
      pages_alloc, frames, frames_alloc, hotness, ptr, counts);
  return (int)cudaGetLastError();
}

// The same walk on host memory, one lane after another, on one thread.
extern "C" int um_scan_host(const int32_t* page, const uint8_t* is_write,
                            const int32_t* phase, int64_t n, int n_phases,
                            const int32_t* params, int lanes,
                            int32_t n_pages, uint8_t* resident,
                            uint8_t* dirty, int64_t pages_alloc,
                            int32_t* frames, int64_t frames_alloc,
                            int32_t* hotness, int32_t* ptr,
                            int64_t* counts) {
  UmWork wk;
  for (int l = 0; l < lanes; ++l) {
    UmLane L = lane_state(l, params, n_pages, resident, dirty, pages_alloc,
                          frames, frames_alloc, hotness);
    um_lane(page, is_write, phase, n, n_phases, L, wk,
            counts + (int64_t)l * 4 * n_phases, 0, 1);
    ptr[l] = L.ptr;
  }
  return 0;
}
