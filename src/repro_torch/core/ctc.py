"""Configurable Tag Cache (§III-D), packed-state form.

The CTC repurposes L2 ways to cache DRAM-cache tags.  One 32 B CTC line holds
eight 4 B *sectors*; each sector is the (AMIL-aggregated) tag bundle of one
DRAM row.  A CTC line therefore covers a *row group* of 8 consecutive DRAM
rows, with per-sector valid bits.

State: one int64 word per (set, way),

    word = (tag + 1) << 40 | age << 32 | sector_valid_bitmask

(tag+1 == 0 means an invalid line; ages 0 = MRU).  Ages start as the
permutation 0..ways-1 in every set and stay a permutation under
:func:`probe_fill_touch_packed`, which keeps disabled ways (indices >=
the enabled count) at the high ages the victim choice never picks.

This is the plain version of the CTC half of the ``hms_scan`` CUDA kernel
(``kernels/hms_scan/csrc/hms_step.cuh``), which carries the same words.
Functions take an optional leading batch (lane) dimension.
"""

from __future__ import annotations

import torch


def packed_init(sets: int, ways: int, sectors: int,
                device=None) -> torch.Tensor:
    """``int64[sets, ways]``: every line invalid, ages 0..ways-1."""
    assert ways <= 256, "age field is 8 bits"
    assert sectors <= 32, "sector valid mask is 32 bits"
    row = torch.arange(ways, dtype=torch.int64, device=device) << 32
    return row.repeat(sets, 1)


def probe_fill_touch_packed(state, row_group, sector, enabled_ways,
                            n_sets, update=None):
    """One CTC access: probe, then LRU-touch on a sector hit or sector fill
    on a miss.

    ``state`` is ``int64[..., sets, ways]``; ``row_group``, ``sector``,
    ``update`` (and optionally ``enabled_ways`` / ``n_sets``) carry the
    leading dims.  ``row_group + 1`` must stay below 2**23 (tag field
    width).  Returns ``(new_state, sector_hit)``; ``state`` is not
    modified.
    """
    dev = state.device
    rg = torch.as_tensor(row_group, dtype=torch.int64, device=dev)
    sec = torch.as_tensor(sector, dtype=torch.int64, device=dev)
    set_idx = rg % torch.as_tensor(n_sets, dtype=torch.int64, device=dev)
    ways = state.shape[-1]
    idx = set_idx.reshape(*set_idx.shape, 1, 1).expand(
        *set_idx.shape, 1, ways)
    row = torch.gather(state, -2, idx)                     # (..., 1, ways)
    mask = (torch.arange(ways, device=dev)
            < torch.as_tensor(enabled_ways, device=dev)[..., None, None])
    new_row, hit = touch_row(row, (rg + 1)[..., None, None],
                             (torch.ones_like(sec) << sec)[..., None, None],
                             mask)
    if update is not None:
        upd = torch.as_tensor(update, device=dev)
        new_row = torch.where(upd[..., None, None], new_row, row)
    return state.scatter(-2, idx, new_row), hit[..., 0, 0]


def touch_row(row, want, secbit, mask):
    """The access on gathered set rows: ``row`` int64[..., ways], ``want``
    (row group + 1) and ``secbit`` (1 << sector) broadcastable int64,
    ``mask`` the enabled ways.  Returns ``(new_row, sector_hit)``, the hit
    keeping a trailing dim of 1.

    The victim is the first way of maximal score: sector hit > line hit >
    enabled-way age > disabled (-1), exactly the reference's ``argmax``.
    """
    tagp1 = row >> 40
    age = (row >> 32) & 0xFF
    svmask = row & 0xFFFFFFFF
    line_hit = (tagp1 == want) & mask
    sector_hit = line_hit & ((svmask & secbit) != 0)
    hit = sector_hit.any(-1, keepdim=True)
    line_present = line_hit.any(-1, keepdim=True)

    score = torch.where(mask, age, -1)
    score = torch.where(line_hit, 1 << 20, score)
    score = torch.where(sector_hit, 2 << 20, score)
    way = score.argmax(-1, keepdim=True)                   # first max
    onehot = torch.arange(row.shape[-1], device=row.device) == way

    # LRU touch (hit and miss paths share it; ``way`` is the touched way)
    new_age = (age + (age < age.gather(-1, way))).masked_fill(onehot, 0)

    # fill path (miss only): reuse a present line's sectors, else clear
    fill_sv = torch.where(line_present, svmask, 0) | secbit
    miss_upd = onehot & ~hit
    new_tagp1 = torch.where(miss_upd, want, tagp1)
    new_sv = torch.where(miss_upd, fill_sv, svmask)
    return (new_tagp1 << 40) | (new_age << 32) | new_sv, hit
