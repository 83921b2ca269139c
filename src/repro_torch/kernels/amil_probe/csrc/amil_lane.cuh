// The AMIL probe's per-request code, shared by the kernel and a host build.
//
// A request (slot, tag) reads the packed metadata lane table[slot]
// (tag[0:2] | valid[2] | dirty[3] | affinity[4:6], the layout of
// core/amil.py) and gives hit = valid & (tag == want & 3), dirty & hit and
// the affinity.  A slot outside [0, n_slots) is refused before the table is
// read.  The kernel (amil_probe.cu) takes requests four at a time with
// 16-byte transfers; amil_span says which requests go four at a time and
// which one by one.
//
// The functions are __host__ __device__: nvcc builds them into the kernel,
// and a plain C++ compiler builds the same code for the host (the macro is
// plain `inline` without __CUDACC__), so the tests check it without a card.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define AMIL_HD __host__ __device__ __forceinline__
#else
#define AMIL_HD inline
#endif

// One unsigned compare: a negative slot is a large unsigned one.
AMIL_HD bool amil_slot_ok(int32_t slot, int32_t n_slots) {
  return static_cast<uint32_t>(slot) < static_cast<uint32_t>(n_slots);
}

struct AmilOut {
  int32_t hit, dirty, aff;
};

// The probe of one packed lane `m` for the wanted tag `tag`.
AMIL_HD AmilOut amil_lane(int32_t m, int32_t tag) {
  const int32_t hit =
      ((m >> 2) & 1) & static_cast<int32_t>((m & 3) == (tag & 3));
  return {hit, ((m >> 3) & 1) & hit, (m >> 4) & 3};
}

// One request; false (and nothing written, nothing read from the table) when
// its slot is out of range.
AMIL_HD bool amil_one(const int32_t* table, int32_t n_slots, int32_t slot,
                      int32_t tag, int32_t& hit, int32_t& dirty,
                      int32_t& aff) {
  if (!amil_slot_ok(slot, n_slots)) return false;
  const AmilOut o = amil_lane(table[slot], tag);
  hit = o.hit;
  dirty = o.dirty;
  aff = o.aff;
  return true;
}

// Four requests; false (and nothing written, nothing read from the table)
// when any of the four slots is out of range.
AMIL_HD bool amil_quad(const int32_t* table, int32_t n_slots,
                       const int32_t (&slot)[4], const int32_t (&tag)[4],
                       int32_t (&hit)[4], int32_t (&dirty)[4],
                       int32_t (&aff)[4]) {
  const bool ok = amil_slot_ok(slot[0], n_slots) &
                  amil_slot_ok(slot[1], n_slots) &
                  amil_slot_ok(slot[2], n_slots) &
                  amil_slot_ok(slot[3], n_slots);
  if (!ok) return false;
  for (int u = 0; u < 4; ++u) {
    const AmilOut o = amil_lane(table[slot[u]], tag[u]);
    hit[u] = o.hit;
    dirty[u] = o.dirty;
    aff[u] = o.aff;
  }
  return true;
}

// How n requests split: `quads` groups of four from the first request, then
// `tail` one by one.  Four at a time needs all five streams (slots, tags and
// the three outputs) 16-byte aligned; where one is not (a view such as
// slots[1:]), every request goes one by one (quads = 0, tail = n).
struct AmilSpan {
  int64_t quads, tail;
};

AMIL_HD AmilSpan amil_span(const void* slots, const void* tags,
                           const void* hit, const void* dirty,
                           const void* aff, int64_t n) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(slots) |
                        reinterpret_cast<uintptr_t>(tags) |
                        reinterpret_cast<uintptr_t>(hit) |
                        reinterpret_cast<uintptr_t>(dirty) |
                        reinterpret_cast<uintptr_t>(aff);
  if ((any & 15) != 0) return {0, n};
  return {n / 4, n % 4};
}
