"""Plain PyTorch versions of the ``hms_scan`` and ``ema_scan`` kernels.

:func:`hms_scan_reference` walks the steps in a Python loop, each step a
few dozen tensor operations vectorized over the lanes; it is the
reference's scan body (``simulator.py:502-565``) written out in torch, and
the oracle of ``csrc/hms_step.cuh``.  :func:`ema_scan_reference` is the
sequential float64 moving average, rounded after every operation.
"""

from __future__ import annotations

import torch

from ...core import bypass as bp
from ...core import ctc as ctc_mod
from ...core.timing import POLICIES_WITH_CTC


def _lane_column(v, lanes: int, device):
    """A lane parameter (one int, or one a lane) as int64[lanes, 1]."""
    t = torch.as_tensor(v, dtype=torch.int64).reshape(-1)
    return t.expand(lanes).reshape(lanes, 1).to(device)


def _decode(slot, meta, policy: str, n_sets, ways_alloc: int):
    """Unpack every step's request word up front (it is per-request pure)
    into per-step fields shaped for :func:`hms_step_reference`: a list of
    dicts, one per step, of ``(lanes, 1)`` tensors (CTC fields
    ``(lanes, 1, 1)`` / ``(lanes, 1, ways)``).  ``n_sets`` is one int or
    one a lane."""
    lanes, depth = slot.shape
    tag = (meta >> 40).to(torch.int32)
    raff = ((meta >> 8) & 0xFF).to(torch.int32)
    wr_ok = ((meta & 1) == 1) & (policy != "mccache")   # writes dirty lines
    f = {
        "idx": slot.to(torch.int64)[..., None],
        "tag": tag[..., None],
        "live": ((meta >> 16) & 1 == 1)[..., None],
        "wr_ok": wr_ok[..., None],
        "dec_ok": ((meta >> 1) & 1 == 1)[..., None],
        "cand": ((meta >> 2) & 1 == 1)[..., None],
        "raff": raff[..., None],
        # the word a fill writes
        "fill_word": ((tag << 10) | (raff << 2)
                      | (wr_ok.to(torch.int32) << 1) | 1)[..., None],
    }
    if policy in POLICIES_WITH_CTC:
        rg = (meta >> 17) & 0x7FFFFF
        sets = _lane_column(n_sets, lanes, slot.device)
        f["ctc_idx"] = (rg % sets)[..., None, None].expand(
            lanes, depth, 1, ways_alloc)
        f["want"] = (rg + 1)[..., None, None]
        f["secbit"] = (1 << ((meta >> 3) & 0x1F))[..., None, None]
    cols = {k: v.unbind(1) for k, v in f.items()}
    return [{k: v[t] for k, v in cols.items()} for t in range(depth)]


def hms_step_reference(cache, ctc, x, policy: str, way_mask, y_shifts):
    """One scan step on every lane, in place on the state.

    cache int32[lanes, lines]; ctc int64[lanes, sets, ways]; ``x`` one
    step's fields from :func:`_decode`; ``way_mask`` the enabled CTC ways (bool[lanes, 1, ways]);
    ``y_shifts`` = arange(7), the bit of each decision in the output word.
    Returns the int32[lanes, 1] decision words.
    """
    word = cache.gather(1, x["idx"])
    valid = (word & 1) == 1
    hit = valid & ((word >> 10) == x["tag"])
    if policy in POLICIES_WITH_CTC:
        row = ctc.gather(1, x["ctc_idx"])
        new_row, c_hit = ctc_mod.touch_row(row, x["want"], x["secbit"],
                                           way_mask)
        ctc.scatter_(1, x["ctc_idx"],
                     torch.where(x["live"][..., None], new_row, row))
        c_hit = c_hit[..., 0]
    else:
        c_hit = torch.full_like(hit, policy in ("bear", "redcache",
                                                "mccache"))

    fill_c = ~hit & x["cand"]
    # a hit on a write sets the dirty bit
    new_word = word | ((hit & x["wr_ok"]).to(torch.int32) << 1)
    if policy == "hms":
        vaff = (word >> 2) & 0xFF
        accept = ~valid | (x["raff"] > vaff)
        rejected = fill_c & ~accept
        dec = rejected & valid & x["dec_ok"]
        do_fill = fill_c & accept
        nar = fill_c & c_hit & valid
        # a rejected fill decays the victim's affinity level (floor 0)
        new_word = new_word - ((dec & (vaff > 0)).to(torch.int32) << 2)
    else:
        do_fill = fill_c
        rejected = dec = nar = torch.zeros_like(hit)
    new_word = torch.where(do_fill, x["fill_word"], new_word)
    cache.scatter_(1, x["idx"], torch.where(x["live"], new_word, word))
    wb = do_fill & ((word & 3) == 3)                   # dirty victim
    bits = torch.cat([hit, c_hit, do_fill, rejected, dec, wb, nar], 1)
    return (bits.to(torch.int32) << y_shifts).sum(1, keepdim=True,
                                                    dtype=torch.int32)


def initial_state(lanes: int, lines_alloc: int, sets_alloc: int,
                  ways_alloc: int, sectors: int, device):
    """Cold state of every lane: all slots invalid, CTC lines invalid."""
    cache = torch.zeros((lanes, lines_alloc), dtype=torch.int32,
                        device=device)
    ctc = ctc_mod.packed_init(sets_alloc, ways_alloc, sectors, device)
    return cache, ctc.expand(lanes, -1, -1).contiguous()


def hms_scan_reference(slot, meta, *, policy: str, e_ways, n_sets,
                       lines_alloc: int, sets_alloc: int, ways_alloc: int,
                       sectors: int, cache=None, ctc=None):
    """slot int32[lanes, depth], meta int64[lanes, depth] -> (y
    int32[lanes, depth], cache int32[lanes, lines_alloc], ctc
    int64[lanes, sets_alloc, ways_alloc]).  ``e_ways`` and ``n_sets`` are
    one int or one a lane; each lane starts from its row of ``cache`` and
    ``ctc`` (cold where None; not written)."""
    lanes, depth = slot.shape
    cold = initial_state(lanes, lines_alloc, sets_alloc, ways_alloc,
                         sectors, slot.device)
    cache = cold[0] if cache is None else cache.clone()
    ctc = cold[1] if ctc is None else ctc.clone()
    way_mask = (torch.arange(ways_alloc, device=slot.device)
                < _lane_column(e_ways, lanes, slot.device))[:, None, :]
    y_shifts = torch.arange(7, dtype=torch.int32, device=slot.device)
    ys = [hms_step_reference(cache, ctc, x, policy, way_mask, y_shifts)
          for x in _decode(slot, meta, policy, n_sets, ways_alloc)]
    y = torch.cat(ys, dim=1) if ys else torch.zeros_like(slot)
    return y, cache, ctc


def ema_scan_reference(values, weight: float):
    """float64[n] -> float64[n]: avg_i = (1 - w) * avg_{i-1} + w * v_i from
    avg = 0, in order, rounding after every operation."""
    avg = torch.zeros((), dtype=torch.float64, device=values.device)
    out = []
    for v in values.to(torch.float64).unbind(0):
        avg = bp.ema_update(avg, v, weight)
        out.append(avg)
    if not out:
        return torch.zeros(0, dtype=torch.float64, device=values.device)
    return torch.stack(out)
