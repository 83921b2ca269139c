// One step of the UM paging engine's scan, and the walk of one lane.
//
// Replaces the body of the reference's XLA scan (src/repro/um/engine.py,
// `step` inside `_make_um_engine`, :226-294, at one temporal segment).
//
// The functions are __host__ __device__: nvcc builds them into the kernel
// (um_scan.cu) and into a host entry of the same library, and a plain C++
// compiler builds the same code for the tests (the macros below are empty
// without __CUDACC__).  A step is written for `nlanes` threads of which
// this is `lane`: the kernel runs it on one warp (nlanes 32, __syncwarp
// between the phases of a step), the host on one thread (nlanes 1, no sync),
// which walks the same loops in lane order.
//
// State of one lane (one UMSpec):
//   resident, dirty  uint8[pages_alloc + 1]   (the last slot is the
//                                              reference's dump slot; no
//                                              step here writes it)
//   frames           int32[frames_alloc + 1]  page held by each frame, -1
//                                              empty; the clock hand `ptr`
//   hotness          int32[pages_alloc]       accesses per page so far
// Per step, one page and one write flag; per lane, four int64 counters per
// phase (faults, migrated pages, writeback pages, remote accesses).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define UM_HD __host__ __device__
#else
#define UM_HD
#endif

// The kernel's tier: migration chunks up to 64 pages, so eviction windows
// up to 256 candidates (8 a thread of the warp).
constexpr int UM_MAX_CHUNK = 64;
constexpr int UM_MAX_WINDOW = 4 * UM_MAX_CHUNK;

// A step's scratch, shared by the lanes of the warp (shared memory in the
// kernel): the eviction window and the victims in rank order, the chunk's
// pages and whether each comes in new.
struct UmWork {
  int32_t cand_slot[UM_MAX_WINDOW];
  int32_t cand_page[UM_MAX_WINDOW];
  int32_t cand_hot[UM_MAX_WINDOW];
  int32_t ev_slot[UM_MAX_CHUNK];
  int32_t ev_page[UM_MAX_CHUNK];
  int32_t idx[UM_MAX_CHUNK];
  uint8_t newly[UM_MAX_CHUNK];
};

struct UmLane {
  uint8_t* resident;
  uint8_t* dirty;
  int32_t* frames;
  int32_t* hotness;
  int32_t ptr;
  int32_t n_pages;
  int32_t n_frames;
  int32_t chunk;       // fault mode's migration chunk
  int32_t hot_thresh;  // nvlink mode's migration threshold
  bool nvlink;
};

struct UmEvents {
  int fault, remote, migrated, writebacks;
};

UM_HD inline void um_sync() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

UM_HD inline int um_sum(int v) {
#ifdef __CUDA_ARCH__
  return __reduce_add_sync(0xffffffffu, v);
#else
  return v;
#endif
}

// Rank of candidate c in a stable ascending sort of hot[0, w): the
// candidates with a smaller count, and those with the same count at an
// earlier window position.  The ranks are a permutation of [0, w): rank r's
// candidate is order[r] of the reference's argsort.
UM_HD inline int um_stable_rank(const int32_t* hot, int w, int c) {
  const int32_t h = hot[c];
  int r = 0;
  for (int k = 0; k < w; ++k) r += (hot[k] < h) | ((hot[k] == h) & (k < c));
  return r;
}

// One request of page `pp`, write flag `w`, on lane state L.  In the order
// of the reference: the access count first; the link mode's migrate
// decision; on a migration the chunk's pages (the last chunk clipped to the
// last page, so it may repeat that page), the window of 4 x chunk frames
// from the hand (wrapping when it exceeds the frame count), victims coldest
// first by stable rank, writebacks counted from the dirty flags before any
// write, then the writes: the valid victims' flags cleared, the chunk's
// pages made resident, each victim's frame given its new page (on a frame
// named twice the later chunk lane wins, as XLA's scatter does), the hand
// advanced; last the request's own dirty flag.
UM_HD inline UmEvents um_step(UmLane& L, UmWork& wk, int32_t pp, bool w,
                              int lane, int nlanes) {
  const int32_t hot = L.hotness[pp] + 1;
  const bool is_res = L.resident[pp] != 0;
  um_sync();  // every lane read the old count before lane 0 writes it
  if (lane == 0) L.hotness[pp] = hot;
  const bool hot_mig = !is_res && hot >= L.hot_thresh;
  const bool migrate = L.nvlink ? hot_mig : !is_res;
  UmEvents ev = {(int)migrate, (int)(L.nvlink && !is_res && !hot_mig), 0, 0};
  if (migrate) {
    um_sync();  // the new count is what the window reads
    const int mchunk = L.nvlink ? 1 : L.chunk;
    const int window = 4 * mchunk;
    const int32_t base = (pp / mchunk) * mchunk;
    int newly_n = 0;
    for (int j = lane; j < mchunk; j += nlanes) {
      int32_t idx = base + j;
      idx = idx < 0 ? 0 : (idx > L.n_pages - 1 ? L.n_pages - 1 : idx);
      const bool newly = L.resident[idx] == 0;
      wk.idx[j] = idx;
      wk.newly[j] = newly;
      newly_n += newly;
    }
    for (int c = lane; c < window; c += nlanes) {
      const int32_t slot = (int32_t)(((int64_t)L.ptr + c) % L.n_frames);
      const int32_t page = L.frames[slot];
      wk.cand_slot[c] = slot;
      wk.cand_page[c] = page;
      wk.cand_hot[c] = page >= 0 ? L.hotness[page] : 0;
    }
    ev.migrated = um_sum(newly_n);
    um_sync();
    for (int c = lane; c < window; c += nlanes) {
      const int r = um_stable_rank(wk.cand_hot, window, c);
      if (r < mchunk) {
        wk.ev_slot[r] = wk.cand_slot[c];
        wk.ev_page[r] = wk.cand_page[c];
      }
    }
    um_sync();
    int wb_n = 0;
    for (int j = lane; j < mchunk; j += nlanes) {
      const int32_t vp = wk.ev_page[j];
      wb_n += vp >= 0 && wk.newly[j] && L.dirty[vp] != 0;
    }
    ev.writebacks = um_sum(wb_n);
    um_sync();  // every dirty flag read before the first is cleared
    for (int j = lane; j < mchunk; j += nlanes) {
      const int32_t vp = wk.ev_page[j];
      if (vp >= 0 && wk.newly[j]) {
        L.resident[vp] = 0;
        L.dirty[vp] = 0;
      }
    }
    um_sync();
    for (int j = lane; j < mchunk; j += nlanes) L.resident[wk.idx[j]] = 1;
    // a frame named twice only when the window wraps the frame ring
    const bool wraps = window > L.n_frames;
    for (int j = lane; j < mchunk; j += nlanes) {
      const int32_t slot = wk.ev_slot[j];
      bool last = true;
      if (wraps)
        for (int k = j + 1; k < mchunk; ++k) last &= wk.ev_slot[k] != slot;
      if (last) L.frames[slot] = wk.newly[j] ? wk.idx[j] : wk.ev_page[j];
    }
    L.ptr = (int32_t)(((int64_t)L.ptr + ev.migrated) % L.n_frames);
    um_sync();
  }
  if (lane == 0 && w && L.resident[pp] != 0) L.dirty[pp] = 1;
  um_sync();
  return ev;
}

// Walk one lane over the stream from the cold state (the caller zeroes the
// flags, counts and `counts`, and fills frames with -1), adding its events
// into counts[k * n_phases + phase], k = 0 faults, 1 migrated, 2
// writebacks, 3 remote.  `phase` may be null (one phase).  Counts are
// carried in registers and added when the phase changes.  The next
// request is loaded while the current one runs, off the step's chain.
UM_HD inline void um_lane(const int32_t* page, const uint8_t* is_write,
                          const int32_t* phase, int64_t n, int n_phases,
                          UmLane& L, UmWork& wk, int64_t* counts, int lane,
                          int nlanes) {
  int64_t f = 0, m = 0, b = 0, r = 0;
  int cur = 0;
  int32_t pp_next = n ? page[0] : 0;
  bool w_next = n ? is_write[0] != 0 : false;
  int ph_next = n ? (phase ? phase[0] : 0) : -1;
  for (int64_t t = 0; t <= n; ++t) {
    const int32_t pp = pp_next;
    const bool w = w_next;
    const int ph = ph_next;
    if (t + 1 < n) {
      pp_next = page[t + 1];
      w_next = is_write[t + 1] != 0;
      ph_next = phase ? phase[t + 1] : 0;
    } else {
      ph_next = -1;
    }
    if (ph != cur) {
      if (lane == 0) {
        counts[cur] += f;
        counts[n_phases + cur] += m;
        counts[2 * n_phases + cur] += b;
        counts[3 * n_phases + cur] += r;
      }
      f = m = b = r = 0;
      cur = ph;
    }
    if (t == n) break;
    const UmEvents ev = um_step(L, wk, pp, w, lane, nlanes);
    f += ev.fault;
    m += ev.migrated;
    b += ev.writebacks;
    r += ev.remote;
  }
}
