"""Plain PyTorch version of the ``um_scan`` kernel.

:func:`um_scan_reference` walks the steps in a Python loop, each step a
few tensor operations vectorized over the lanes; a step where some lane
migrates runs the migration body on those lanes only.  It is the
reference's paging step (``src/repro/um/engine.py:226-294``) written out in
torch, padded like the reference to the batch's bucketed chunk, and the
oracle of ``csrc/um_step.cuh``.
"""

from __future__ import annotations

from typing import Sequence

import torch

_HOT_PAD = torch.iinfo(torch.int32).max   # window pad: sorts after every count


def bucket(n: int) -> int:
    """Next power of two: the state's allocation sizes."""
    return 1 << max(0, int(n) - 1).bit_length()


def initial_state(lanes: int, n_pages: int, n_frames_max: int, device):
    """The cold state of ``lanes`` lanes: resident and dirty flags
    bool[lanes, pages_alloc + 1] (the last slot is the dump slot), frames
    int32[lanes, frames_alloc + 1] all -1, the hand int32[lanes] and the
    access counts int32[lanes, pages_alloc]."""
    pa, fa = bucket(n_pages), bucket(n_frames_max)
    return (torch.zeros(lanes, pa + 1, dtype=torch.bool, device=device),
            torch.zeros(lanes, pa + 1, dtype=torch.bool, device=device),
            torch.full((lanes, fa + 1), -1, dtype=torch.int32, device=device),
            torch.zeros(lanes, dtype=torch.int32, device=device),
            torch.zeros(lanes, pa, dtype=torch.int32, device=device))


def um_scan_reference(page, is_write, phase, *, n_phases: int, n_pages: int,
                      n_frames: Sequence[int], chunk: Sequence[int],
                      nvlink: Sequence[bool], hot_thresh: Sequence[int]):
    """Run every lane's paging scan from the cold state.

    page int32[n] (< n_pages), is_write bool[n], phase int32[n] or None;
    one lane per entry of the four parameter sequences.  Returns (counts
    float64[lanes, 4, n_phases] of faults, migrated pages, writeback pages
    and remote accesses per phase; the final state as
    :func:`initial_state` lays it out)."""
    dev = page.device
    lanes = len(n_frames)
    i64 = torch.int64
    state = initial_state(lanes, n_pages, max(n_frames, default=1), dev)
    resident, dirty, frames, ptr, hotness = state
    pa, fa = resident.shape[1] - 1, frames.shape[1] - 1
    res_f, dirty_f, frames_f, hot_f = (resident.view(-1), dirty.view(-1),
                                       frames.view(-1), hotness.view(-1))
    nf = torch.tensor(list(n_frames), dtype=i64, device=dev)
    nv = torch.tensor([bool(v) for v in nvlink], device=dev)
    thr = torch.tensor(list(hot_thresh), dtype=torch.int32, device=dev)
    # fault mode migrates a chunk per fault, nvlink one page at a time
    mch = torch.where(nv, 1, torch.tensor(list(chunk), dtype=i64,
                                          device=dev))
    ca = bucket(max(chunk, default=1))
    cl = torch.arange(ca, dtype=i64, device=dev)
    wl = torch.arange(4 * ca, dtype=i64, device=dev)
    later = torch.ones(ca, ca, dtype=torch.bool, device=dev).triu(1)
    lane_ids = torch.arange(lanes, dtype=i64, device=dev)
    off_p = lane_ids * (pa + 1)
    off_h = lane_ids * pa

    n = page.shape[0]
    fault_log = torch.zeros(n, lanes, dtype=torch.bool, device=dev)
    remote_log = torch.zeros(n, lanes, dtype=torch.bool, device=dev)
    mig_log = torch.zeros(n, lanes, dtype=i64, device=dev)
    wb_log = torch.zeros(n, lanes, dtype=i64, device=dev)
    pages = page.tolist()
    writes = is_write.tolist()
    for t in range(n):
        pp, w = pages[t], writes[t]
        hotness[:, pp] += 1
        is_res = resident[:, pp]
        hot_mig = ~is_res & (hotness[:, pp] >= thr)
        migrate = torch.where(nv, hot_mig, ~is_res)
        fault_log[t] = migrate
        remote_log[t] = nv & ~is_res & ~hot_mig
        rows = migrate.nonzero()[:, 0]
        if rows.numel():
            m = mch[rows][:, None]
            F = nf[rows][:, None]
            op = off_p[rows][:, None]
            of = rows[:, None] * (fa + 1)
            oh = off_h[rows][:, None]
            active = cl < m
            idx = ((pp // m) * m + cl).clamp(0, n_pages - 1)
            newly = active & ~res_f[op + idx]
            mig_n = newly.sum(1)
            # the eviction window from the hand, coldest first (stable)
            cand_idx = (ptr[rows].to(i64)[:, None] + wl) % F
            cand_pages = frames_f[of + cand_idx].to(i64)
            cand_hot = torch.where(cand_pages >= 0,
                                   hot_f[oh + cand_pages.clamp_min(0)], 0)
            cand_hot = torch.where(wl < 4 * m, cand_hot, _HOT_PAD)
            order = torch.argsort(cand_hot, dim=1, stable=True)[:, :ca]
            ev_slot = cand_idx.gather(1, order)
            ev_pages = cand_pages.gather(1, order)
            ev_valid = (ev_pages >= 0) & newly
            wb_n = (ev_valid & dirty_f[op + ev_pages.clamp_min(0)]).sum(1)
            ev_pg = torch.where(ev_valid, ev_pages, pa)
            res_f[op + ev_pg] = False
            dirty_f[op + ev_pg] = False
            res_f[op + torch.where(active, idx, pa)] = True
            # a frame named by two chunk lanes takes the later lane's page
            dup = ((ev_slot[:, :, None] == ev_slot[:, None, :])
                   & active[:, None, :] & later).any(2)
            put = active & ~dup
            frames_f[of + torch.where(put, ev_slot, fa)] = torch.where(
                newly, idx, ev_pages).to(torch.int32)
            ptr[rows] = ((ptr[rows].to(i64) + mig_n) % F[:, 0]).to(
                torch.int32)
            mig_log[t, rows] = mig_n
            wb_log[t, rows] = wb_n
        dirty[:, pp] |= w & resident[:, pp]
    # the dump slots took the gated writes; they hold nothing
    resident[:, pa] = False
    dirty[:, pa] = False
    frames[:, fa] = -1

    logs = torch.stack([fault_log.to(i64), mig_log, wb_log,
                        remote_log.to(i64)], dim=1)        # (n, 4, lanes)
    if phase is None:
        counts = logs.sum(0)[..., None]
    else:
        counts = torch.stack([logs[phase == k].sum(0)
                              for k in range(n_phases)], dim=-1)
    return counts.permute(1, 0, 2).to(torch.float64), state
