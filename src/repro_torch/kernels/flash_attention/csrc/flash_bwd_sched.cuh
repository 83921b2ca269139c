// The tile schedule and the GQA reduction order of the flash attention
// backward (flash_attention_bwd.cu), written once for the card and the host
// (tests/test_torch_flash_bwd_design.py builds this header with g++).
//
// A CTA keeps FIXED rows of two tensors in shared memory and streams the
// other two STREAM rows at a time: the dK/dV kernel keeps 64 keys of K and V
// and streams the queries of Q and dO that see them; the dQ kernel keeps 64
// queries of Q and dO and streams the keys of K and V up to its causal
// diagonal.  Grids are (tiles x H x B) CTAs, one a (tile, query head,
// batch), the tile index slowest, so that the heaviest tiles start first.
// Where a KV head serves G > 1 query heads, each dK/dV CTA writes its head's
// float32 partials and a last launch sums them in head order (head_sum): one
// order, no atomics, so two runs give the same bits.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FBS_FN __host__ __device__ __forceinline__
#else
#define FBS_FN inline
#endif

namespace flash_bwd {

constexpr int FIXED = 64;    // rows a CTA keeps: keys (dK/dV) or queries (dQ)
constexpr int STREAM = 32;   // rows a CTA streams a step

struct Tile {
  int tile, head, batch;
};

// CTA `block` of a grid of n_tiles x H x B.  The tile is the slowest index,
// counted down when `rev`: a causal dK/dV grid starts at key tile 0 (seen by
// every query), a causal dQ grid at the last query tile (which sees every
// key).
FBS_FN Tile tile_of(int64_t block, int n_tiles, int H, int B, bool rev) {
  const int64_t hb = (int64_t)H * B;
  const int slow = (int)(block / hb), rest = (int)(block % hb);
  return Tile{rev ? n_tiles - 1 - slow : slow, rest % H, rest / H};
}

// Queries sit at the end of the key timeline (offset T - S): query q sees
// key k under a causal mask when k <= q + T - S.
FBS_FN bool live(int q, int k, int S, int T, bool causal) {
  return q < S && k < T && (!causal || k <= q + T - S);
}

// The first query a dK/dV CTA of keys key0 .. streams: the start of the
// STREAM tile holding the first query that sees key0.
FBS_FN int first_query(int key0, int S, int T, bool causal) {
  const int q = causal ? key0 - (T - S) : 0;
  return q > 0 ? q / STREAM * STREAM : 0;
}

// The keys a dQ CTA of queries q0 .. streams: [0, key_end), up to the
// causal diagonal of its last query.
FBS_FN int key_end(int q0, int S, int T, bool causal) {
  const int last = (q0 + FIXED < S ? q0 + FIXED : S) - 1;
  return causal && last + T - S + 1 < T ? last + T - S + 1 : T;
}

// The GQA sum of element e over G partials n elements apart, in head order
// g = 0, 1, ..., G - 1 (add(a, b) is a + b for V).
template <class V, class Add>
FBS_FN V head_sum(const V* part, int64_t e, int64_t n, int G, Add add) {
  V a = part[e];
  for (int g = 1; g < G; ++g) a = add(a, part[(int64_t)g * n + e]);
  return a;
}

}  // namespace flash_bwd
