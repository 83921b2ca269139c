"""The shared-memory layout and wgmma descriptors of the bf16 flash
attention kernel, built for the host.

``kernels/flash_attention/csrc/flash_layout.cuh`` is ``__host__
__device__``: g++ builds it here (the tests skip without g++), and the
layout the kernel's TMA boxes write and its wgmma descriptors read is
checked on the CPU for every head dim the wrapper takes (each padded in
shared memory to a multiple of 64 columns): the tile offsets are a
bijection onto the tile's bytes, every 16-byte chunk of eight bf16 columns
stays contiguous and 16-byte aligned where the 128-byte swizzle puts it,
and each descriptor's start address, leading and stride byte offsets and
swizzle bits equal values worked out by hand from the layout.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels.flash_attention.ops import HEAD_DIMS

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "flash_attention" / "csrc")

_HOST_SRC = r"""
#include <stdint.h>
#include "flash_layout.cuh"

extern "C" uint32_t padded_cols(uint32_t hd) {
  return flash_layout::padded_cols(hd);
}
extern "C" void tile_offsets(uint32_t rows, uint32_t cols, uint32_t* out) {
  for (uint32_t r = 0; r < rows; ++r)
    for (uint32_t c = 0; c < cols; ++c)
      out[r * cols + c] = flash_layout::tile_offset(rows, r, c);
}
extern "C" uint64_t kmajor_desc(uint32_t tile, uint32_t rows, uint32_t row0,
                                uint32_t kstep) {
  return flash_layout::kmajor_desc(tile, rows, row0, kstep);
}
extern "C" uint64_t mnmajor_desc(uint32_t tile, uint32_t rows,
                                 uint32_t kstep) {
  return flash_layout::mnmajor_desc(tile, rows, kstep);
}
extern "C" uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                              uint32_t swizzle) {
  return flash_layout::make_desc(addr, lbo, sbo, swizzle);
}
"""

ROWS = (64, 128)            # a warpgroup's Q rows; the CTA's Q and K/V tiles


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """``flash_layout.cuh`` built for the host by g++ (skips without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of flash_layout.cuh "
                    "needs it")
    d = tmp_path_factory.mktemp("flash_layout")
    (d / "host.cpp").write_text(_HOST_SRC)
    so = d / "libflash_layout.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "host.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    U32, U64 = ctypes.c_uint32, ctypes.c_uint64
    lib.padded_cols.argtypes = [U32]
    lib.padded_cols.restype = U32
    lib.tile_offsets.argtypes = [U32, U32, ctypes.c_void_p]
    lib.tile_offsets.restype = None
    lib.kmajor_desc.argtypes = [U32, U32, U32, U32]
    lib.kmajor_desc.restype = U64
    lib.mnmajor_desc.argtypes = [U32, U32, U32]
    lib.mnmajor_desc.restype = U64
    lib.make_desc.argtypes = [U32, U32, U32, U32]
    lib.make_desc.restype = U64
    return lib


def _offsets(lib, rows, cols):
    out = np.zeros(rows * cols, np.uint32)
    lib.tile_offsets(rows, cols, out.ctypes.data)
    return out.reshape(rows, cols).astype(np.int64)


def _fields(desc):
    """(start address, leading byte offset, stride byte offset, base
    offset, swizzle mode) of a descriptor, in bytes where they are."""
    return ((desc & 0x3FFF) << 4, ((desc >> 16) & 0x3FFF) << 4,
            ((desc >> 32) & 0x3FFF) << 4, (desc >> 49) & 0x7, desc >> 62)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_head_dim_padding(layout, hd):
    """Shared memory holds hd in whole 64-column (128-byte) slices."""
    cols = layout.padded_cols(hd)
    assert cols % 64 == 0 and hd <= cols < hd + 64


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_tile_layout_is_a_bijection(layout, hd, rows):
    """Every element of a rows x padded-hd bf16 tile has its own 2-byte
    slot, and together they fill the tile's bytes."""
    cols = layout.padded_cols(hd)
    off = _offsets(layout, rows, cols)
    assert (off % 2 == 0).all()
    assert sorted(off.ravel().tolist()) == list(range(0, rows * cols * 2, 2))


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_tile_chunks_stay_aligned(layout, hd, rows):
    """Eight bf16 columns 8c .. 8c + 7 of a row sit contiguously in one
    16-byte-aligned chunk; in its 64-column slice, row r is one 128-byte
    row whose chunk j lies at position j XOR (r mod 8): what TMA's
    128-byte swizzle writes and wgmma reads."""
    off = _offsets(layout, rows, layout.padded_cols(hd))
    for r in range(rows):
        for c in range(0, hd, 8):
            chunk = off[r, c:c + 8]
            assert chunk[0] % 16 == 0
            assert (np.diff(chunk) == 2).all()
            s, j = c // 64, (c % 64) // 8
            assert chunk[0] == s * rows * 128 + r * 128 + 16 * (j ^ (r % 8))


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_descriptors_match_hand_values(layout, hd):
    """The descriptors of the kernel's three operands at every k16 step:
    Q (K-major A, a warpgroup's 64 rows of the 128-row tile), K (K-major B
    of S = Q K^T, 128 rows) and V (MN-major B of O += P V, 128 key rows).
    K-major: start = tile + the step's slice (128 rows x 128 bytes) + the
    first row's 128 bytes + 32 bytes per step within the slice, leading
    byte offset 16 (unused), stride byte offset 1024 (8 rows of 128 bytes).
    MN-major: start = tile + 16 key rows per step, leading byte offset
    128 * 128 (the next 64-column slice), stride byte offset 1024.  Base
    offset 0, swizzle mode 1 (128 bytes)."""
    tile = 0x4400                              # a 1024-byte-aligned tile
    for wg in (0, 1):
        for kk in range(hd // 16):
            got = _fields(layout.kmajor_desc(tile, 128, 64 * wg, kk))
            assert got == (tile + (kk // 4) * 128 * 128 + wg * 64 * 128
                           + (kk % 4) * 32, 16, 1024, 0, 1)
    for kk in range(hd // 16):
        assert _fields(layout.kmajor_desc(tile, 128, 0, kk)) == (
            tile + (kk // 4) * 16384 + (kk % 4) * 32, 16, 1024, 0, 1)
    for kk in range(128 // 16):
        assert _fields(layout.mnmajor_desc(tile, 128, kk)) == (
            tile + kk * 16 * 128, 128 * 128, 1024, 0, 1)


def test_descriptor_bit_packing(layout):
    """make_desc packs each field into its bits and nothing else: start
    address >> 4 in bits 0-13, leading byte offset >> 4 in 16-29, stride
    byte offset >> 4 in 32-45, swizzle mode in 62-63."""
    assert layout.make_desc(0x3FFF0, 0, 0, 0) == 0x3FFF
    assert layout.make_desc(0, 0x3FFF0, 0, 0) == 0x3FFF << 16
    assert layout.make_desc(0, 0, 0x3FFF0, 0) == 0x3FFF << 32
    for mode in range(4):
        assert layout.make_desc(0, 0, 0, mode) == mode << 62
    assert layout.make_desc(0x1230, 0x40, 0x100, 3) == (
        0x123 | 0x4 << 16 | 0x10 << 32 | 3 << 62)
