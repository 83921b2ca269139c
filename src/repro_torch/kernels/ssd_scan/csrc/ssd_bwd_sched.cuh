// The tile schedule and the summing orders of the SSD scan's backward
// (ssd_scan_bwd.cu), written once for the card and the host
// (tests/test_torch_ssd_bwd_design.py builds this header with g++).
//
// A chunk of CS positions is TILES tiles of 16 rows.  The chunk kernel
// takes its causal tile pairs (i-tile >= j-tile) twice: in the key-major
// pass a warp owns a j-tile and visits i-tiles jt .. mt - 1; in the
// query-major pass a warp owns an i-tile and visits j-tiles 0 .. it.  Four
// warps a pass, warp w owning tiles w and TILES - 1 - w, so each does
// TILES + 1 tile pairs of a full chunk.  A ragged last chunk has mt valid
// tiles (those holding rows below l) and visits only pairs among them.
// dB and dC are summed over the heads of a group from float32 partials in
// head order, dA over (chunk, batch row) in that order: no atomics, so two
// runs give the same bits.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SBS_FN __host__ __device__ __forceinline__
#else
#define SBS_FN inline
#endif

namespace ssd_bwd {

constexpr int CS = 128;            // chunk length (ssm_chunk)
constexpr int TILE = 16;           // rows of an m16n8k16 tile
constexpr int TILES = CS / TILE;   // tiles of a chunk
constexpr int PASS_WARPS = TILES / 2;

// Tiles of chunk c that hold positions below l.
SBS_FN int valid_tiles(int c, int l) {
  const int rows = l - c * CS < CS ? l - c * CS : CS;
  return rows > 0 ? (rows + TILE - 1) / TILE : 0;
}

// The k-th (0 or 1) tile of warp w (0 .. PASS_WARPS - 1) in either pass.
SBS_FN int warp_tile(int w, int k) { return k ? TILES - 1 - w : w; }

// Element e of a sum over `count` partials `stride` apart, in index order
// 0, 1, ..., count - 1 (add(a, b) is a + b for V): dB and dC over a
// group's heads, dA over (chunk, batch row).
template <class V, class Add>
SBS_FN V ordered_sum(const V* part, int64_t e, int64_t stride, int count,
                     Add add) {
  V a = part[e];
  for (int t = 1; t < count; ++t) a = add(a, part[(int64_t)t * stride + e]);
  return a;
}

}  // namespace ssd_bwd
