// The UM paging engine's scan: the walk of one lane, in passes of up to 32
// requests, and the migrating step.
//
// Replaces the body of the reference's XLA scan (src/repro/um/engine.py,
// `step` inside `_make_um_engine`, :226-294, with its temporal-segment
// gates: the `real` and `live` flags of :228-246 and :284-289).
//
// The functions are __host__ __device__: nvcc builds them into the kernel
// (um_scan.cu) and into a host entry of the same library, and a plain C++
// compiler builds the same code for the tests (the macros below are empty
// without __CUDACC__).  The walk is a template on NL, the threads that run
// it: the kernel runs it on one warp (NL 32, one request of a pass and up
// to 8 window candidates a thread), the host on one thread (NL 1, every
// request and candidate in loops).  Thread `lane` holds positions
// k * NL + lane.  The warp's collectives (um_ballot, um_match, um_bcast,
// um_sum) are one instruction in the kernel and the same value from a loop
// on the host, so both builds cut the same passes.
//
// State of one lane (one UMSpec):
//   resident, dirty  uint8[pages_alloc + 1]   (the last slot is the
//                                              reference's dump slot; no
//                                              step here writes it)
//   frames           int32[frames_alloc + 1]  page held by each frame, -1
//                                              empty; the clock hand `ptr`
//   hotness          int32[pages_alloc]       accesses per page so far
// Per step, one page and one flags byte: bit 0 the write, bit 1 `real` (a
// core step of the lane's temporal segment: it counts its events and adds
// to its page's access count) and bit 2 `live` (its state updates take
// effect: core steps, and a segment's replay prefix in the stitch's warm-up
// round; padding is neither).  A lane that is the whole trace has every
// step real and live.  Per lane, four int64 counters per phase (faults,
// migrated pages, writeback pages, remote accesses).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define UM_HD __host__ __device__
#define UM_UNROLL _Pragma("unroll")
#else
#define UM_HD
#define UM_UNROLL
#endif

// The kernel's tier: migration chunks up to 64 pages, so eviction windows
// up to 256 candidates (8 a thread of the warp).
constexpr int UM_MAX_CHUNK = 64;
constexpr int UM_MAX_WINDOW = 4 * UM_MAX_CHUNK;
// Requests a pass takes, whatever NL is.
constexpr int UM_BATCH = 32;

// The migrating step's scratch, shared by the threads of the warp (shared
// memory in the kernel): the window's counts, and the victims in rank order.
struct UmWork {
  alignas(16) int32_t cand_hot[UM_MAX_WINDOW];
  int32_t ev_slot[UM_MAX_CHUNK];
  int32_t ev_page[UM_MAX_CHUNK];
  uint8_t ev_dirty[UM_MAX_CHUNK];
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

// The warp's collectives.  In the kernel (NL 32) each is one instruction
// over the warp, every thread holding one position (P = 1 a thread); built
// for one thread (NL 1, P = 32 or more: the host, whose walk nvcc also
// compiles for the device, never to run there) each gives the same value
// from the positions that thread holds.
template <int NL>
UM_HD inline void um_sync() {
#ifdef __CUDA_ARCH__
  if constexpr (NL == 32) __syncwarp();
#endif
}

template <int NL>
UM_HD inline int um_sum(int v) {
#ifdef __CUDA_ARCH__
  if constexpr (NL == 32) return __reduce_add_sync(0xffffffffu, v);
#endif
  return v;
}

// Bit i set where position i's flag is; P = UM_BATCH / NL flags a thread.
template <int P>
UM_HD inline uint32_t um_ballot(const bool (&v)[P]) {
#ifdef __CUDA_ARCH__
  if constexpr (P == 1) return __ballot_sync(0xffffffffu, v[0]);
#endif
  uint32_t m = 0;
  for (int k = 0; k < P; ++k) m |= (uint32_t)v[k] << k;
  return m;
}

// same[k]: the positions whose key equals position k's.
template <int P>
UM_HD inline void um_match(const int32_t (&key)[P], uint32_t (&same)[P]) {
#ifdef __CUDA_ARCH__
  if constexpr (P == 1) {
    same[0] = __match_any_sync(0xffffffffu, key[0]);
    return;
  }
#endif
  for (int k = 0; k < P; ++k) {
    same[k] = 0;
    for (int q = 0; q < P; ++q) same[k] |= (uint32_t)(key[q] == key[k]) << q;
  }
}

// The least of the positions' values.
template <int P>
UM_HD inline int32_t um_min(const int32_t (&v)[P]) {
#ifdef __CUDA_ARCH__
  if constexpr (P == 1) return __reduce_min_sync(0xffffffffu, v[0]);
#endif
  int32_t m = v[0];
  for (int k = 1; k < P; ++k) m = v[k] < m ? v[k] : m;
  return m;
}

// Position src's value, on every thread.
template <typename V, int P>
UM_HD inline V um_bcast(const V (&v)[P], int src) {
#ifdef __CUDA_ARCH__
  if constexpr (P == 1) return (V)__shfl_sync(0xffffffffu, (int)v[0], src);
#endif
  return v[src];
}

UM_HD inline int um_popc(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// The lowest set position of a nonzero mask.
UM_HD inline int um_first(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// Positions below i (0 <= i <= 32).
UM_HD inline uint32_t um_below(int i) {
  return i >= 32 ? 0xffffffffu : (1u << i) - 1u;
}

// Ranks of the window's candidates in a stable ascending sort by access
// count: a candidate's rank counts the candidates with a smaller count and
// those with the same count at an earlier window position, so rank r's
// candidate is order[r] of the reference's argsort.  hot[k] is the count
// of candidate k * NL + lane, for windows up to W candidates (the tiers above
// 32; up to 32, um_migrate takes its few victims by warp minimum instead).
// The counts go to shared memory once (padded to a multiple of 4 with a
// count above any other; the kernel's windows need none); every thread then
// reads them four at a time (one 16-byte load, the same address for the
// whole warp, independent of the others) and compares them with its own, in
// registers.
struct alignas(16) UmQuad {
  int32_t v[4];
};

template <int NL, int W>
UM_HD inline void um_window_ranks(UmWork& wk, const int32_t (&hot)[W / NL],
                                  int window, int lane,
                                  int (&rank)[W / NL]) {
  constexpr int PW = W / NL;
  const int padded = (window + 3) & ~3;
  UM_UNROLL
  for (int k = 0; k < PW; ++k) {
    const int c = k * NL + lane;
    if (c < padded) wk.cand_hot[c] = c < window ? hot[k] : INT32_MAX;
    rank[k] = 0;
  }
  um_sync<NL>();
  for (int c = 0; c < padded; c += 4) {
    const UmQuad q = *reinterpret_cast<const UmQuad*>(&wk.cand_hot[c]);
    UM_UNROLL
    for (int k = 0; k < PW; ++k) {
      const int mine = k * NL + lane;
      UM_UNROLL
      for (int e = 0; e < 4; ++e)
        rank[k] += (q.v[e] < hot[k]) | ((q.v[e] == hot[k]) & (c + e < mine));
    }
  }
}

// The eviction window's frames from the hand: slot and page of candidate
// k * NL + lane in slot[k] and page[k] (page -1 past the window).  Frames
// change only in a migration, so the walk loads the next window when one
// ends, off the next migration's chain.
template <int NL, int W>
struct UmWindow {
  int32_t slot[W / NL];
  int32_t page[W / NL];
};

template <int NL, int W>
UM_HD inline void um_load_window(const UmLane& L, int lane,
                                 UmWindow<NL, W>& win) {
  const int window = 4 * (L.nvlink ? 1 : L.chunk);
  UM_UNROLL
  for (int k = 0; k < W / NL; ++k) {
    const int c = k * NL + lane;
    int32_t s = L.ptr + c;  // the hand stays in [0, n_frames)
    if (window > L.n_frames)
      s %= L.n_frames;
    else if (s >= L.n_frames)
      s -= L.n_frames;
    win.slot[k] = s;
    win.page[k] = c < window ? L.frames[s] : -1;
  }
}

struct UmMoved {
  int migrated;    // pages that came in
  int writebacks;  // dirty victims of this thread's chunk pages
};

// The migrating step of request (pp, w) on a non-resident page, after its
// access count is written, on the window `win` of the frames as they are.
// In the order of the reference's effects: the chunk's pages (the last
// chunk clipped to the last page, so it may repeat that page) and whether
// each comes in new, the window of 4 x chunk frames from the hand
// (wrapping when it exceeds the frame count), victims coldest first by
// stable rank, writebacks counted from the dirty flags before any write,
// then the writes: the valid victims' flags cleared, the chunk's pages made
// resident, each victim's frame given its new page (on a frame named twice
// the later chunk lane wins, as XLA's scatter does), the hand advanced;
// last the request's own dirty flag.
//
// The chain is one round trip of loads (the chunk's flags, and the
// candidates' counts and dirty flags), then the victims in order: for
// windows up to 32 (chunks up to 8, nvlink's 4) each thread holds one
// candidate and the victims are taken one by one by warp minimum and
// shuffled to their chunk lanes; larger windows rank every candidate from
// shared memory (um_window_ranks) and pass the victims through it behind
// one __syncwarp.  The writes need no order between threads: a victim
// inside the chunk is left resident (the chunk makes it so), and the
// request's page, which is not resident and so not dirty before the step
// and resident after it, ends dirty exactly when w, whichever thread
// writes it.
template <int NL, int W>
UM_HD inline UmMoved um_migrate(UmLane& L, UmWork& wk,
                                const UmWindow<NL, W>& win, int32_t pp,
                                bool w, int lane) {
  constexpr int PC = (W / 4 + NL - 1) / NL;  // chunk pages a thread
  constexpr int PW = W / NL;                 // window candidates a thread
  const int mchunk = L.nvlink ? 1 : L.chunk;
  const int window = 4 * mchunk;
  const bool wraps = window > L.n_frames;
  const int32_t base =  // the chunk's first page; chunks are mostly 2^k
      (mchunk & (mchunk - 1)) == 0 ? pp & -mchunk : pp - pp % mchunk;
  const int32_t top = L.n_pages - 1;
  const int32_t last = base + mchunk - 1 < top ? base + mchunk - 1 : top;

  // the chunk's pages and whether each comes in new
  int32_t idx[PC];
  bool newly[PC];
  int newly_n = 0;
  UM_UNROLL
  for (int k = 0; k < PC; ++k) {
    const int j = k * NL + lane;
    idx[k] = base + j < top ? base + j : top;
    newly[k] = j < mchunk && L.resident[idx[k]] == 0;
    newly_n += newly[k];
  }
  int32_t chot[PW];
  bool cdirty[PW];
  UM_UNROLL
  for (int k = 0; k < PW; ++k) {
    const int32_t cp = win.page[k];
    chot[k] = cp >= 0 ? L.hotness[cp] : 0;
    cdirty[k] = cp >= 0 && L.dirty[cp] != 0;
  }
  const int mig_n = um_sum<NL>(newly_n);

  // victim j (rank j) for each of this thread's chunk lanes j
  int32_t vslot[PC], vpage[PC];
  bool vdirty[PC];
  int32_t slots[W <= 32 ? W / 4 : 1];
  if constexpr (W <= 32) {
    // up to 8 victims of up to 32 candidates, one a thread: taken one at a
    // time by warp minimum, the earliest candidate on a tie (the stable
    // order), handed to their chunk lanes by shuffles; every thread keeps
    // every victim's slot for the repeated-frame test
    int32_t key[PW];
    bool at[PW];
    UM_UNROLL
    for (int k = 0; k < PW; ++k)
      key[k] = k * NL + lane < window ? chot[k] : INT32_MAX;
    UM_UNROLL
    for (int r = 0; r < W / 4; ++r) {
      if (r >= mchunk) break;
      const int32_t least = um_min(key);
      UM_UNROLL
      for (int k = 0; k < PW; ++k)
        at[k] = k * NL + lane < window && key[k] == least;
      const int c = um_first(um_ballot(at));
      UM_UNROLL
      for (int k = 0; k < PW; ++k)
        if (k * NL + lane == c) key[k] = INT32_MAX;  // taken
      slots[r] = um_bcast(win.slot, c);
      const int32_t page = um_bcast(win.page, c);
      const bool dirty = um_bcast(cdirty, c);
      UM_UNROLL
      for (int k = 0; k < PC; ++k)
        if (k * NL + lane == r) {
          vslot[k] = slots[r];
          vpage[k] = page;
          vdirty[k] = dirty;
        }
    }
  } else {
    int rank[PW];
    um_window_ranks<NL, W>(wk, chot, window, lane, rank);
    UM_UNROLL
    for (int k = 0; k < PW; ++k) {
      if (k * NL + lane < window && rank[k] < mchunk) {
        wk.ev_slot[rank[k]] = win.slot[k];
        wk.ev_page[rank[k]] = win.page[k];
        wk.ev_dirty[rank[k]] = cdirty[k];
      }
    }
    um_sync<NL>();  // the victims in rank order
    UM_UNROLL
    for (int k = 0; k < PC; ++k) {
      const int j = k * NL + lane < mchunk ? k * NL + lane : 0;
      vslot[k] = wk.ev_slot[j];
      vpage[k] = wk.ev_page[j];
      vdirty[k] = wk.ev_dirty[j];
    }
  }
  int wb_n = 0;
  UM_UNROLL
  for (int k = 0; k < PC; ++k) {
    const int j = k * NL + lane;
    if (j >= mchunk) break;
    const int32_t vs = vslot[k];
    const int32_t vp = vpage[k];
    if (vp >= 0 && newly[k]) {
      wb_n += vdirty[k];
      L.resident[vp] = vp >= base && vp <= last;
      L.dirty[vp] = vp == pp && w;
    }
    L.resident[idx[k]] = 1;
    // a frame named twice (only when the window wraps the frame ring) takes
    // the later chunk lane's page
    bool final_write = true;
    if (wraps) {
      if constexpr (W <= 32) {
        UM_UNROLL
        for (int q = 0; q < W / 4; ++q)
          if (q > j && q < mchunk) final_write &= slots[q] != vs;
      } else {
        for (int q = j + 1; q < mchunk; ++q)
          final_write &= wk.ev_slot[q] != vs;
      }
    }
    if (final_write) L.frames[vs] = newly[k] ? idx[k] : vp;
  }
  if (lane == 0 && w) L.dirty[pp] = 1;
  int32_t p = L.ptr + mig_n;  // mig_n <= chunk <= n_frames / 4 unless wraps
  if (wraps)
    p %= L.n_frames;
  else if (p >= L.n_frames)
    p -= L.n_frames;
  L.ptr = p;
  return {mig_n, wb_n};
}

// Add v to a counter that no step of the pass reads (in the kernel a
// reduction in device memory that nothing waits for).
template <typename V>
UM_HD inline void um_add(V* c, int v) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(V) == 8)
    atomicAdd((unsigned long long*)c, (unsigned long long)(long long)v);
  else
    atomicAdd(c, (V)v);
#else
  *c += v;
#endif
}

// A step's flags byte.
constexpr uint8_t UM_WRITE = 1, UM_REAL = 2, UM_LIVE = 4;

// The request stream read straight from memory (the host's walk): pages,
// write flags and phases, and optionally each step's whole flags byte
// (`flags_`; null: every step real and live, its write from `write_`).
struct UmStream {
  const int32_t* page_;
  const uint8_t* write_;
  const int32_t* phase_;  // null: one phase
  const uint8_t* flags_ = nullptr;
  UM_HD void ready(int64_t) {}
  UM_HD int32_t page(int64_t i) const { return page_[i]; }
  UM_HD uint8_t flags(int64_t i) const {
    return flags_ ? flags_[i]
                  : (uint8_t)(UM_REAL | UM_LIVE | (write_[i] ? UM_WRITE : 0));
  }
  UM_HD int32_t phase(int64_t i) const { return phase_ ? phase_[i] : 0; }
};

// Walk one lane over the stream from the state in its buffers (cold: the
// caller zeroes the flags, counts and `counts`, fills frames with -1 and
// starts the hand at 0; a temporal segment: its boundary guess, the frame
// ring rotated so the hand is at 0), adding each real step's events into
// counts[k * n_phases + its phase], k = 0 faults, 1 migrated, 2 writebacks,
// 3 remote.
//
// A pass takes the next 32 requests (fewer at the stream's end) and reads
// their pages' resident flags once.  Until a page migrates, a step only
// adds one to its page's count (counts commute) and may set its dirty flag
// (idempotent), and no page's residence changes: so the first migrating
// step is found at once (um_ballot).  In fault mode it is the first step on
// a page that is not resident.  In nvlink mode it is the first such step
// whose count reaches the threshold: the count it reaches is its page's
// count at the pass's start plus its page's earlier steps in the pass
// (counted over the pass's steps on pages that are not resident, the only
// ones whose counts decide anything).  The steps before it take effect
// together (counts added, writes to resident pages set dirty flags, nvlink
// steps to pages that are not resident count as remote), that step adds
// its count and runs um_migrate, and the next pass starts after it.  Only
// live steps migrate or set dirty flags, and only real ones add to counts
// (a replay step's count is its page's count as it stands) or count
// events; a step that is neither does nothing.
//
// `src` gives the requests: ready(t) before a pass that starts at t, then
// page(i), flags(i) and phase(i) for t <= i < t + 32.
template <int NL, int W, typename Src>
UM_HD inline void um_lane(Src& src, int64_t n, int n_phases, UmLane& L,
                          UmWork& wk, int64_t* counts, int lane) {
  constexpr int PB = UM_BATCH / NL;
  UmWindow<NL, W> win;
  um_load_window<NL, W>(L, lane, win);
  for (int64_t t = 0; t < n;) {
    const int nb = n - t < UM_BATCH ? (int)(n - t) : UM_BATCH;
    int32_t pp[PB], ph[PB];
    bool w[PB], rl[PB], lv[PB], cold[PB], cand[PB];
    src.ready(t);
    UM_UNROLL
    for (int k = 0; k < PB; ++k) {
      const int i = k * NL + lane;
      const bool in = i < nb;
      const uint8_t f = in ? src.flags(t + i) : 0;
      pp[k] = in ? src.page(t + i) : 0;
      w[k] = (f & UM_WRITE) != 0;
      rl[k] = (f & UM_REAL) != 0;
      lv[k] = (f & UM_LIVE) != 0;
      ph[k] = in ? src.phase(t + i) : 0;
      cold[k] = in && L.resident[pp[k]] == 0;
      cand[k] = cold[k] && lv[k];
    }
    uint32_t migs = um_ballot(cand);
    if (L.nvlink && migs) {
      int32_t key[PB], hot[PB];
      uint32_t same[PB];
      bool mig[PB];
      const uint32_t reals = um_ballot(rl);
      UM_UNROLL
      for (int k = 0; k < PB; ++k) {
        key[k] = cold[k] ? pp[k] : -1 - (k * NL + lane);  // no page's key
        hot[k] = cold[k] ? L.hotness[pp[k]] + (int32_t)rl[k] : 0;
      }
      um_match(key, same);
      UM_UNROLL
      for (int k = 0; k < PB; ++k) {
        hot[k] += um_popc(same[k] & um_below(k * NL + lane) & reals);
        mig[k] = cand[k] && hot[k] >= L.hot_thresh;
      }
      migs = um_ballot(mig);
    }
    const int js = migs ? um_first(migs) : nb;  // the migrating step, or nb
    UM_UNROLL
    for (int k = 0; k < PB; ++k) {
      const int i = k * NL + lane;
      if (i < nb && i <= js && rl[k]) um_add(&L.hotness[pp[k]], 1);
      if (i < js) {
        if (w[k] && lv[k] && !cold[k]) L.dirty[pp[k]] = 1;
        if (L.nvlink && cold[k] && rl[k])
          um_add(&counts[3 * n_phases + ph[k]], 1);
      }
    }
    if (js < nb) {
      um_sync<NL>();  // the window reads the counts and flags written above
      const int p = um_bcast(ph, js);
      const bool real = um_bcast(rl, js);
      const UmMoved mv = um_migrate<NL, W>(L, wk, win, um_bcast(pp, js),
                                           um_bcast(w, js), lane);
      if (lane == 0 && real) {
        um_add(&counts[p], 1);
        um_add(&counts[n_phases + p], mv.migrated);
      }
      if (mv.writebacks && real)
        um_add(&counts[2 * n_phases + p], mv.writebacks);
      um_sync<NL>();  // the next window reads this migration's frames
      um_load_window<NL, W>(L, lane, win);
      t += js + 1;
    } else {
      t += nb;
    }
    um_sync<NL>();  // the next pass reads this one's writes
  }
}

// um_lane at the lane's window tier: windows up to W candidates hold W / NL
// a thread (the kernel: 1, 2, 4 or 8), so a lane pays for no larger window
// than its own.
template <int NL, typename Src>
UM_HD inline void um_walk(Src& src, int64_t n, int n_phases, UmLane& L,
                          UmWork& wk, int64_t* counts, int lane) {
  const int window = 4 * (L.nvlink ? 1 : L.chunk);
  if (window <= 32)
    um_lane<NL, 32>(src, n, n_phases, L, wk, counts, lane);
  else if (window <= 64)
    um_lane<NL, 64>(src, n, n_phases, L, wk, counts, lane);
  else if (window <= 128)
    um_lane<NL, 128>(src, n, n_phases, L, wk, counts, lane);
  else
    um_lane<NL, UM_MAX_WINDOW>(src, n, n_phases, L, wk, counts, lane);
}
