// One step of the HMS engine's sequential scan, the lane loop around it, and
// the split of a lane into state-disjoint domains that the kernel runs.
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

// The CTC probe as a maximum over one packed key per way.  The key orders
// ways as the reference's argmax does (ctc.py:219-222): by class (sector
// hit 258 > line hit 257 > an enabled way's 1 + age > a disabled way's 0),
// then the first way; the way's own age rides in the low bits, below the
// way, so the maximum also carries the winner's age:
//   key = class << 16 | (255 - way) << 8 | age       (ways_alloc <= 256)
// Ages are LRU ranks below ways_alloc, so the 8-bit age field caps a row at
// 256 ways, and the way field is as wide.  A disabled way's key is 0.  The
// kernel holds up to four ways per thread and takes the maximum with one
// warp reduction; the host loops over the row.
// A way's word is taken in 32-bit halves, hi = (tag+1) << 8 | age and
// lo = the sector mask; `want` is row_group + 1, `secbit` 1 << sector.
HMS_HD inline uint32_t ctc_key(uint32_t hi, uint32_t lo, int way,
                               uint32_t want, uint32_t secbit, bool enabled) {
  const uint32_t age = hi & 0xFF;
  const bool line_hit = (hi >> 8) == want;
  const bool sector_hit = line_hit && (lo & secbit) != 0;
  const uint32_t cls = sector_hit ? 258u : line_hit ? 257u : 1u + age;
  return enabled ? (cls << 16) | ((uint32_t)(255 - way) << 8) | age : 0u;
}

HMS_HD inline int ctc_key_way(uint32_t best) {
  return 255 - (int)((best >> 8) & 255);
}
HMS_HD inline bool ctc_key_sector_hit(uint32_t best) {
  return best >= (258u << 16);
}
HMS_HD inline bool ctc_key_line_hit(uint32_t best) {
  return best >= (257u << 16);
}

// One way's halves after the access that `best` (the row's maximum key)
// describes: the chosen way becomes the youngest (and on a sector miss takes
// the line, keeping its sectors if the line was present), younger ways age.
HMS_HD inline void ctc_touch(uint32_t& hi, uint32_t& lo, int way,
                             uint32_t best, uint32_t want, uint32_t secbit) {
  const uint32_t age = hi & 0xFF;
  const bool chosen = way == ctc_key_way(best);
  const bool fill = chosen && !ctc_key_sector_hit(best);
  lo = fill ? (ctc_key_line_hit(best) ? lo : 0u) | secbit : lo;
  const uint32_t tagp1 = fill ? want : hi >> 8;
  hi = (tagp1 << 8) | (chosen ? 0u : age + (age < (best & 0xFF)));
}

// The same on a packed int64 way word (tag+1) << 40 | age << 32 | mask.
HMS_HD inline uint32_t ctc_way_key(int64_t r, int way, int64_t want,
                                   int64_t sector, bool enabled) {
  return ctc_key((uint32_t)(r >> 32), (uint32_t)r, way, (uint32_t)want,
                 1u << sector, enabled);
}

HMS_HD inline int64_t ctc_way_touch(int64_t r, int way, uint32_t best,
                                    int64_t want, int64_t sector) {
  uint32_t hi = (uint32_t)(r >> 32), lo = (uint32_t)r;
  ctc_touch(hi, lo, way, best, (uint32_t)want, 1u << sector);
  return (int64_t)(((uint64_t)hi << 32) | lo);
}

// Packed CTC access on the set row of `row_group`: probe, then LRU-touch on
// a sector hit or fill the sector on a miss.  Writes the row back only when
// `update` (padded steps leave the state alone).  Returns the sector hit.
HMS_HD inline bool ctc_probe_fill_touch(int64_t* ctc, int ways_alloc,
                                        int64_t row_group, int64_t sector,
                                        int e_ways, int n_sets, bool update) {
  int64_t* row = ctc + (row_group % n_sets) * ways_alloc;
  const int64_t want = row_group + 1;
  uint32_t best = 0;
  for (int w = 0; w < ways_alloc; ++w) {
    const uint32_t k = ctc_way_key(row[w], w, want, sector, w < e_ways);
    best = k > best ? k : best;
  }
  if (update) {
    for (int w = 0; w < ways_alloc; ++w)
      row[w] = ctc_way_touch(row[w], w, best, want, sector);
  }
  return ctc_key_sector_hit(best);
}

// The cache-word half of a step: the word to store (when live) and the
// decision bits.  The CTC's answer enters only the output word (bit 1, and
// bit 6 where the affinity rule reads), so the two halves run side by side.
struct HmsWordStep {
  int32_t word;   // the slot's new word
  int32_t y;      // decision bits without the CTC
  int32_t y_ctc;  // bits a CTC hit adds
};

template <int P>
HMS_HD inline HmsWordStep hms_word_step(int32_t word, int64_t meta) {
  typedef HmsPolicyTraits<P> T;
  const int32_t tag = (int32_t)(meta >> 40);
  const bool is_wr = (meta & 1) != 0;
  const bool dec_ok = (meta & 2) != 0;
  const bool cand = (meta & 4) != 0;
  const int32_t raff = (int32_t)((meta >> 8) & 0xFF);

  const bool victim_valid = (word & 1) == 1;
  const bool word_dirty = (word & 2) == 2;
  const bool victim_dirty = word_dirty && victim_valid;
  const int32_t victim_aff = (word >> 2) & 0xFF;
  const int32_t stored_tag = word >> 10;
  const bool hit = victim_valid && stored_tag == tag;

  const bool miss = !hit;
  bool accept = true;
  bool aff_read = false;  // need_aff_read, before the CTC's answer
  if (T::hms_accept) {
    accept = !victim_valid || raff > victim_aff;
    aff_read = miss && cand && victim_valid;
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
  HmsWordStep s;
  s.word = (new_tag << 10) | (new_aff << 2) | ((int32_t)new_dirty << 1)
         | (int32_t)new_valid;
  s.y = (int32_t)hit | ((int32_t)do_fill << 2) | ((int32_t)rejected << 3)
      | ((int32_t)dec << 4) | ((int32_t)(do_fill && victim_dirty) << 5);
  s.y_ctc = 2 | ((int32_t)aff_read << 6);
  return s;
}

HMS_HD inline int32_t hms_decision(const HmsWordStep& s, bool c_hit) {
  return s.y | (c_hit ? s.y_ctc : 0);
}

HMS_HD inline int64_t hms_row_group(int64_t meta) {
  return (meta >> 17) & 0x7FFFFF;
}
HMS_HD inline bool hms_live(int64_t meta) { return (meta & (1 << 16)) != 0; }

template <int P>
HMS_HD inline int32_t hms_step(int32_t* cache, int64_t* ctc, int ways_alloc,
                               int e_ways, int n_sets, int32_t slot,
                               int64_t meta) {
  typedef HmsPolicyTraits<P> T;
  const bool live = hms_live(meta);
  const HmsWordStep s = hms_word_step<P>(cache[slot], meta);
  bool c_hit;
  if (T::use_ctc) {
    c_hit = ctc_probe_fill_touch(ctc, ways_alloc, hms_row_group(meta),
                                 (meta >> 3) & 0x1F, e_ways, n_sets, live);
  } else {
    c_hit = T::ideal_probe;
  }
  if (live) cache[slot] = s.word;
  return hms_decision(s, c_hit);
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

// ---- Domains: the state-disjoint chains inside one lane -------------------
//
// A step reads and writes one cache word, cache[slot], and (under a CTC
// policy) one CTC row, row_group % n_sets, and row_group == slot / spg
// (spg = lines_per_row * ctc_sectors_per_line slots per row group, the
// invariant traces.shard_plan asserts).  So the steps of one domain
//   domain = row_group % n_domains
// (n_domains = n_sets under a CTC policy, any count without one) touch
// words and rows no other domain touches, and each domain is a chain of its
// own: walking the domains one after another, each in stream order, gives
// the sequential walk's results.

HMS_HD inline int hms_domain(int64_t row_group, int n_domains) {
  return (int)(row_group % n_domains);
}

// What the scan kernel computes for lane `lane`: its chains one after
// another.  The streams are the lanes' steps sorted stably by chain
// c = lane * n_domains + domain (the wrapper's order, ops.py), so chain c
// is the run [offsets[c], offsets[c + 1]) in stream order, and y is written
// at the sorted positions.  Under a CTC policy n_domains must be n_sets, so
// domain d owns CTC row d.
template <int P>
HMS_HD inline void hms_lane_by_domain(const int32_t* slot,
                                      const int64_t* meta,
                                      const int64_t* offsets, int lane,
                                      int n_domains, int32_t* cache,
                                      int64_t* ctc, int ways_alloc,
                                      int e_ways, int32_t* y) {
  for (int d = 0; d < n_domains; ++d) {
    const int64_t b = offsets[(int64_t)lane * n_domains + d];
    const int64_t e = offsets[(int64_t)lane * n_domains + d + 1];
    hms_lane<P>(slot + b, meta + b, e - b, cache, ctc, ways_alloc, e_ways,
                n_domains, y + b);
  }
}
