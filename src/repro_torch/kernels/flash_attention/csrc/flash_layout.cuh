// Shared-memory layout of the wgmma flash attention kernel's bf16 tiles,
// and the wgmma matrix descriptors that read them.
//
// A tile of `rows` x hd bf16 is what TMA writes for boxes of {64, rows}
// elements under CU_TENSOR_MAP_SWIZZLE_128B, one box per 64-column slice:
// slice c / 64 holds rows x 128 bytes, one 128-byte row per tile row, and
// the 128-byte swizzle (CuTe's Swizzle<3, 4, 3>) XORs the 16-byte chunk
// index of a row with the row's index within its 8-row group (byte-address
// bits 7-9 into bits 4-6), so the eight rows of a wgmma core matrix fall
// in eight different bank groups.  hd is padded to the next multiple of
// 64 in shared memory (padded_cols): TMA zero-fills the columns past hd,
// and no wgmma reads them (Q K^T stops at hd / 16 k16 steps, P V's N is
// hd).  Tiles start on 1024-byte boundaries (the swizzle's repeat), so
// every descriptor below has base offset 0.
//
// __host__ __device__ so that the tests build this header with g++ and
// check the layout and the descriptor fields on the CPU.

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define FLASH_LAYOUT_FN __host__ __device__ __forceinline__
#else
#define FLASH_LAYOUT_FN inline
#endif

namespace flash_layout {

constexpr uint32_t kSliceCols = 64;      // bf16 columns per 128-byte row
constexpr uint32_t kRowBytes = 128;
constexpr uint32_t kGroupBytes = 8 * kRowBytes;   // one 8-row core group

// The descriptor's swizzle mode (bits 62-63) for 128 bytes; 0 is none,
// 2 is 64 bytes and 3 is 32 bytes.
constexpr uint32_t kSwizzle128B = 1;

// Columns a head dim takes in shared memory.
FLASH_LAYOUT_FN constexpr uint32_t padded_cols(uint32_t hd) {
  return (hd + kSliceCols - 1) / kSliceCols * kSliceCols;
}

// Byte offset of element (r, c) from the start of the tile.
FLASH_LAYOUT_FN uint32_t tile_offset(uint32_t rows, uint32_t r, uint32_t c) {
  const uint32_t lin = (c / kSliceCols) * rows * kRowBytes + r * kRowBytes
                       + (c % kSliceCols) * 2;
  return lin ^ (((lin >> 7) & 7u) << 4);
}

// The 64-bit wgmma matrix descriptor: start address >> 4 in bits 0-13,
// leading byte offset >> 4 in bits 16-29, stride byte offset >> 4 in bits
// 32-45, base offset 0 (bits 49-51), swizzle mode in bits 62-63.
FLASH_LAYOUT_FN uint64_t make_desc(uint32_t smem_addr, uint32_t lbo_bytes,
                                   uint32_t sbo_bytes, uint32_t swizzle) {
  return (uint64_t)((smem_addr & 0x3FFFFu) >> 4)
         | (uint64_t)((lbo_bytes >> 4) & 0x3FFFu) << 16
         | (uint64_t)((sbo_bytes >> 4) & 0x3FFFu) << 32
         | (uint64_t)(swizzle & 3u) << 62;
}

// A K-major operand for k16 step `kstep`, from tile row `row0` (a
// multiple of 8): Q as the A of S = Q K^T (64 rows from row0), or K as its
// B (all rows).  The step's 16 columns are 32 bytes of one slice's rows;
// the start is where they sit in row0, whose swizzle is the identity, and
// the hardware swizzles the rows below it.  8-row groups are kGroupBytes
// apart (the stride byte offset); the leading byte offset is unused (16,
// its encoding 1, as CUTLASS sets it).
FLASH_LAYOUT_FN uint64_t kmajor_desc(uint32_t tile, uint32_t rows,
                                     uint32_t row0, uint32_t kstep) {
  return make_desc(tile + tile_offset(rows, row0, kstep * 16), 16,
                   kGroupBytes, kSwizzle128B);
}

// An MN-major operand for k16 step `kstep`: V (keys x head dim, stored
// key-major) as the B of O += P V, read with the transpose bit.  Its K
// (keys) runs down the rows, 8-row groups kGroupBytes apart (stride byte
// offset); its N (head dim) runs across the 64-column slices, rows * 128
// bytes apart (leading byte offset).
FLASH_LAYOUT_FN uint64_t mnmajor_desc(uint32_t tile, uint32_t rows,
                                      uint32_t kstep) {
  return make_desc(tile + tile_offset(rows, kstep * 16, 0),
                   rows * kRowBytes, kGroupBytes, kSwizzle128B);
}

}  // namespace flash_layout
