"""AMIL (Aggregated-Metadata-In-Last-column) metadata packing.

The paper stores the metadata of all cachelines in a DRAM row inside the data
portion of the row's *last column* (Fig. 7c).  With 256 B cachelines and a
2 KiB row this is 8 lines x 6 bits = 48 bits in a 256-bit column — one column
access fetches every tag in the row and ECC coverage is preserved.

This module is the *functional* definition of that layout: one byte per line,

    bit [0:2]  tag          (2-bit for a 4x SCM:DRAM capacity ratio)
    bit 2      valid
    bit 3      dirty
    bit [4:6]  DRAM-affinity level (2-bit, N_levels = 4)

packed little-endian into a ``uint8[lines_per_row]`` metadata word per row.
It is the oracle of the ``kernels/amil_probe`` CUDA kernel.
"""

from __future__ import annotations

import torch

TAG_SHIFT = 0
TAG_MASK = 0b11
VALID_SHIFT = 2
DIRTY_SHIFT = 3
AFF_SHIFT = 4
AFF_MASK = 0b11


def pack_line_meta(tag, valid, dirty, affinity):
    """Pack per-line metadata fields into one uint8 each.

    All arguments are integer/bool tensors of identical shape; broadcasting
    is the caller's business.  ``tag`` and ``affinity`` are masked to 2 bits.
    """
    tag = torch.as_tensor(tag).to(torch.uint8) & TAG_MASK
    aff = torch.as_tensor(affinity).to(torch.uint8) & AFF_MASK
    v = torch.as_tensor(valid).to(torch.uint8)
    d = torch.as_tensor(dirty).to(torch.uint8)
    return ((tag << TAG_SHIFT) | (v << VALID_SHIFT) | (d << DIRTY_SHIFT)
            | (aff << AFF_SHIFT)).to(torch.uint8)


def unpack_line_meta(meta):
    """Inverse of :func:`pack_line_meta`; returns (tag, valid, dirty, aff)."""
    meta = torch.as_tensor(meta)
    tag = (meta >> TAG_SHIFT) & TAG_MASK
    valid = ((meta >> VALID_SHIFT) & 1).to(torch.bool)
    dirty = ((meta >> DIRTY_SHIFT) & 1).to(torch.bool)
    aff = (meta >> AFF_SHIFT) & AFF_MASK
    return tag, valid, dirty, aff


def probe_row(row_meta, line_in_row, want_tag):
    """Resolve hit/miss for ``line_in_row`` against an AMIL word.

    Vectorized: ``row_meta`` is ``uint8[..., lines_per_row]``, the other two
    broadcastable integer tensors.  Returns (hit, valid, dirty, affinity).
    """
    idx = torch.as_tensor(line_in_row).to(torch.int64)[..., None]
    meta = torch.gather(row_meta, -1, idx)[..., 0]
    tag, valid, dirty, aff = unpack_line_meta(meta)
    want = torch.as_tensor(want_tag).to(torch.uint8) & TAG_MASK
    hit = valid & (tag == want)
    return hit, valid, dirty, aff
