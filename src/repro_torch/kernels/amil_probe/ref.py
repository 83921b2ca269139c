"""Plain PyTorch version of the AMIL probe kernel (delegates to core/amil's
bit layout)."""

from __future__ import annotations

import torch

from ...core.amil import (AFF_MASK, AFF_SHIFT, DIRTY_SHIFT, TAG_MASK,
                          VALID_SHIFT)


def amil_probe_reference(meta, slots, tags):
    """meta int32[num_slots]; slots/tags int32[N] -> (hit, dirty, aff)."""
    m = meta[slots.long()]
    tag = m & TAG_MASK
    valid = (m >> VALID_SHIFT) & 1
    dirty = (m >> DIRTY_SHIFT) & 1
    aff = (m >> AFF_SHIFT) & AFF_MASK
    hit = ((valid == 1) & (tag == (tags & TAG_MASK))).to(torch.int32)
    return hit, (dirty & hit).to(torch.int32), aff.to(torch.int32)
