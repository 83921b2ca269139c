// One step of the HMS engine's sequential scan, and the lane loop around it.
//
// Replaces the body of the reference's XLA scan (src/repro/core/simulator.py,
// `step` inside `_make_engine`, :502-565) together with the packed CTC access
// it calls (src/repro/core/ctc.py, `probe_fill_touch_packed`, :196-239).
//
// The functions are __host__ __device__: nvcc builds them into the scan
// kernel (hms_scan.cu), and a plain C++ compiler builds the same code for the
// host (the macros below are empty without __CUDACC__), so the step logic can
// be checked without a card.
//
// State of one lane:
//   cache  int32[lines_alloc]           tag<<10 | aff<<2 | dirty<<1 | valid
//   ctc    int64[sets_alloc*ways_alloc] (tag+1)<<40 | age<<32 | sector mask
// Per step, two input words:
//   slot   int32                         shard-local DRAM-cache slot
//   meta   int64  bit 0 is_write | 1 dec_ok | 2 cand | 3..7 sector |
//                 8..15 req_aff_lvl | 16 live | 17..39 row group | 40.. tag
// and one output word:
//   y      int32  bit 0 hit | 1 ctc hit | 2 fill | 3 rejected | 4 aff decay |
//                 5 dirty writeback | 6 affinity read
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define HMS_HD __host__ __device__
#else
#define HMS_HD
#endif

// Policy ids: the order of repro_torch.core.timing.POLICIES.
enum HmsPolicy {
  P_HMS = 0,
  P_NO_BYPASS = 1,
  P_NO_BYPASS_NO_CTC = 2,
  P_NO_SECOND_LEVEL = 3,
  P_BEAR = 4,
  P_REDCACHE = 5,
  P_MCCACHE = 6,
  P_ALWAYS_CACHE = 7,
};

// Compile-time policy branches (the reference's Python-level `if`s on the
// policy: which policies carry CTC state, which model an ideal probe, which
// use the affinity-comparison accept rule, which keep dirty lines).
template <int P>
struct HmsPolicyTraits {
  static constexpr bool use_ctc =
      P == P_HMS || P == P_NO_BYPASS || P == P_NO_SECOND_LEVEL;
  static constexpr bool ideal_probe =
      P == P_BEAR || P == P_REDCACHE || P == P_MCCACHE;
  static constexpr bool hms_accept = P == P_HMS;
  static constexpr bool dirty_ok = P != P_MCCACHE;
};

// Packed CTC access on the set row of `row_group`: probe, then LRU-touch on
// a sector hit or fill the sector on a miss.  Writes the row back only when
// `update` (padded steps leave the state alone).  Returns the sector hit.
HMS_HD inline bool ctc_probe_fill_touch(int64_t* ctc, int ways_alloc,
                                        int64_t row_group, int64_t sector,
                                        int e_ways, int n_sets, bool update) {
  int64_t* row = ctc + (row_group % n_sets) * ways_alloc;
  const int64_t want = row_group + 1;
  bool hit = false;
  bool line_present = false;
  int way = 0;
  int64_t best = -2;  // below every score, so the first maximum wins
  for (int w = 0; w < ways_alloc; ++w) {
    const int64_t r = row[w];
    const bool enabled = w < e_ways;
    const bool line_hit = ((r >> 40) == want) && enabled;
    const bool sector_hit = line_hit && (((r & 0xFFFFFFFFLL) >> sector) & 1);
    const int64_t score = sector_hit ? (int64_t(2) << 20)
                        : line_hit   ? (int64_t(1) << 20)
                        : enabled    ? ((r >> 32) & 0xFF)
                                     : int64_t(-1);
    if (score > best) {
      best = score;
      way = w;
    }
    hit = hit || sector_hit;
    line_present = line_present || line_hit;
  }
  if (update) {
    const int64_t my_age = (row[way] >> 32) & 0xFF;
    for (int w = 0; w < ways_alloc; ++w) {
      const int64_t r = row[w];
      int64_t tagp1 = r >> 40;
      int64_t age = (r >> 32) & 0xFF;
      int64_t sv = r & 0xFFFFFFFFLL;
      if (w == way) {
        age = 0;
        if (!hit) {  // fill: reuse a present line's sectors, else clear
          sv = (line_present ? sv : 0) | (int64_t(1) << sector);
          tagp1 = want;
        }
      } else if (age < my_age) {
        age += 1;
      }
      row[w] = (tagp1 << 40) | (age << 32) | sv;
    }
  }
  return hit;
}

template <int P>
HMS_HD inline int32_t hms_step(int32_t* cache, int64_t* ctc, int ways_alloc,
                               int e_ways, int n_sets, int32_t slot,
                               int64_t meta) {
  typedef HmsPolicyTraits<P> T;
  const int32_t tag = (int32_t)(meta >> 40);
  const int64_t rg = (meta >> 17) & 0x7FFFFF;
  const bool live = (meta & (1 << 16)) != 0;
  const bool is_wr = (meta & 1) != 0;
  const bool dec_ok = (meta & 2) != 0;
  const bool cand = (meta & 4) != 0;
  const int64_t sector = (meta >> 3) & 0x1F;
  const int32_t raff = (int32_t)((meta >> 8) & 0xFF);

  const int32_t word = cache[slot];
  const bool victim_valid = (word & 1) == 1;
  const bool word_dirty = (word & 2) == 2;
  const bool victim_dirty = word_dirty && victim_valid;
  const int32_t victim_aff = (word >> 2) & 0xFF;
  const int32_t stored_tag = word >> 10;
  const bool hit = victim_valid && stored_tag == tag;

  bool c_hit;
  if (T::use_ctc) {
    c_hit = ctc_probe_fill_touch(ctc, ways_alloc, rg, sector, e_ways, n_sets,
                                 live);
  } else {
    c_hit = T::ideal_probe;
  }

  const bool miss = !hit;
  bool accept = true;
  bool need_aff_read = false;
  if (T::hms_accept) {
    accept = !victim_valid || raff > victim_aff;
    need_aff_read = miss && cand && c_hit && victim_valid;
  }
  const bool do_fill = miss && cand && accept;
  const bool rejected = miss && cand && !accept;
  const bool dec = rejected && victim_valid && dec_ok;

  const bool set_dirty = (hit || do_fill) && is_wr && T::dirty_ok;
  const int32_t new_tag = do_fill ? tag : stored_tag;
  const bool new_valid = victim_valid || do_fill;
  const bool new_dirty =
      do_fill ? set_dirty : (word_dirty || (hit && is_wr && T::dirty_ok));
  int32_t new_aff = victim_aff - (dec ? 1 : 0);
  if (new_aff < 0) new_aff = 0;
  if (do_fill) new_aff = raff;
  if (live) {
    cache[slot] = (new_tag << 10) | (new_aff << 2) | ((int32_t)new_dirty << 1)
                | (int32_t)new_valid;
  }
  return (int32_t)hit | ((int32_t)c_hit << 1) | ((int32_t)do_fill << 2)
       | ((int32_t)rejected << 3) | ((int32_t)dec << 4)
       | ((int32_t)(do_fill && victim_dirty) << 5)
       | ((int32_t)need_aff_read << 6);
}

// Walk one lane's `depth` steps in order, carrying its cache and CTC state.
template <int P>
HMS_HD inline void hms_lane(const int32_t* slot, const int64_t* meta,
                            int64_t depth, int32_t* cache, int64_t* ctc,
                            int ways_alloc, int e_ways, int n_sets,
                            int32_t* y) {
  for (int64_t t = 0; t < depth; ++t) {
    y[t] = hms_step<P>(cache, ctc, ways_alloc, e_ways, n_sets, slot[t],
                       meta[t]);
  }
}
