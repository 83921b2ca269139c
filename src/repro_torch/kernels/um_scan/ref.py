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


def lane_rows(x, lanes: int):
    """(rows, L) stream (a 1-D stream is one row) -> (lanes, L): lane l
    reads row l % rows."""
    x2 = x.reshape(1, -1) if x.dim() == 1 else x
    return x2[torch.arange(lanes, device=x.device) % x2.shape[0]]


def um_scan_reference(page, is_write, phase, *, n_phases: int, n_pages: int,
                      n_frames: Sequence[int], chunk: Sequence[int],
                      nvlink: Sequence[bool], hot_thresh: Sequence[int],
                      real=None, live=None, state=None):
    """Run every lane's paging scan.

    page int32[n] or int32[T, L] (< n_pages), is_write bool and phase
    int32 (or None) of the same shape; ``real`` and ``live`` bool of that
    shape (None: every step is both) gate a temporal segment's steps: a
    real step counts its events and adds to its page's access count, a
    live one updates the state.  One spec per entry of the four parameter
    sequences; the lanes are specs x rows, lane l = spec l // T on row
    l % T.  Each lane starts from its row of ``state`` (cold where None;
    not written).  Returns (counts float64[lanes, 4, n_phases] of faults,
    migrated pages, writeback pages and remote accesses per phase; the
    final state as :func:`initial_state` lays it out)."""
    dev = page.device
    rows = 1 if page.dim() == 1 else page.shape[0]
    lanes = len(n_frames) * rows
    i64 = torch.int64

    def per_lane(v):
        return torch.tensor(list(v), device=dev).repeat_interleave(rows)

    if state is None:
        state = initial_state(lanes, n_pages, max(n_frames, default=1), dev)
    state = tuple(x.clone() for x in state)
    resident, dirty, frames, ptr, hotness = state
    pa, fa = resident.shape[1] - 1, frames.shape[1] - 1
    res_f, dirty_f, frames_f, hot_f = (resident.view(-1), dirty.view(-1),
                                       frames.view(-1), hotness.view(-1))
    nf = per_lane(n_frames).to(i64)
    nv = per_lane([bool(v) for v in nvlink])
    thr = per_lane(hot_thresh).to(torch.int32)
    # fault mode migrates a chunk per fault, nvlink one page at a time
    mch = torch.where(nv, 1, per_lane(chunk).to(i64))
    ca = bucket(max(chunk, default=1))
    cl = torch.arange(ca, dtype=i64, device=dev)
    wl = torch.arange(4 * ca, dtype=i64, device=dev)
    later = torch.ones(ca, ca, dtype=torch.bool, device=dev).triu(1)
    lane_ids = torch.arange(lanes, dtype=i64, device=dev)
    off_p = lane_ids * (pa + 1)
    off_h = lane_ids * pa

    P = lane_rows(page, lanes).to(i64)
    Wr = lane_rows(is_write, lanes)
    ones = torch.ones_like(Wr)
    RL = lane_rows(real, lanes) if real is not None else ones
    LV = lane_rows(live, lanes) if live is not None else ones
    n = P.shape[1]
    # per step, one column of each lane's flat indices and gates (views of
    # one transposed copy each), made up front
    cols_h = (off_h[:, None] + P).t().contiguous().unbind(0)
    cols_p = (off_p[:, None] + P).t().contiguous().unbind(0)
    cols_rl = RL.t().contiguous().unbind(0)
    cols_rl32 = RL.t().to(torch.int32).contiguous().unbind(0)
    cols_lv = LV.t().contiguous().unbind(0)
    WL = Wr & LV
    cols_wl = WL.t().contiguous().unbind(0)
    any_wl = WL.any(0).tolist()
    # each lane's migration constants, gathered per migrating step
    M, F_l = mch[:, None], nf[:, None]
    ACT = cl < M
    WIN = wl < 4 * M
    cold_log = torch.zeros(n, lanes, dtype=torch.bool, device=dev)
    hm_log = torch.zeros(n, lanes, dtype=torch.bool, device=dev)
    move_log = torch.zeros(n, lanes, dtype=torch.bool, device=dev)
    mig_log = torch.zeros(n, lanes, dtype=i64, device=dev)
    wb_log = torch.zeros(n, lanes, dtype=i64, device=dev)
    for t in range(n):
        ch, cp = cols_h[t], cols_p[t]
        hot_f.index_add_(0, ch, cols_rl32[t])
        cold = ~res_f[cp]
        hot_mig = cold & (hot_f[ch] >= thr)
        migrate = torch.where(nv, hot_mig, cold) & cols_lv[t]
        cold_log[t] = cold
        hm_log[t] = hot_mig
        move_log[t] = migrate
        rows_m = migrate.nonzero()[:, 0]
        if rows_m.numel():
            m = M[rows_m]
            F = F_l[rows_m]
            op = off_p[rows_m][:, None]
            of = rows_m[:, None] * (fa + 1)
            oh = off_h[rows_m][:, None]
            active = ACT[rows_m]
            idx = ((P[rows_m, t][:, None] // m) * m + cl).clamp(0,
                                                                n_pages - 1)
            newly = active & ~res_f[op + idx]
            mig_n = newly.sum(1)
            # the eviction window from the hand, coldest first (stable)
            cand_idx = (ptr[rows_m].to(i64)[:, None] + wl) % F
            cand_pages = frames_f[of + cand_idx].to(i64)
            cand_hot = torch.where(cand_pages >= 0,
                                   hot_f[oh + cand_pages.clamp_min(0)], 0)
            cand_hot = torch.where(WIN[rows_m], cand_hot, _HOT_PAD)
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
            ptr[rows_m] = ((ptr[rows_m].to(i64) + mig_n) % F[:, 0]).to(
                torch.int32)
            real_m = cols_rl[t][rows_m]
            mig_log[t, rows_m] = mig_n * real_m
            wb_log[t, rows_m] = wb_n * real_m
        if any_wl[t]:
            dirty_f[cp] |= cols_wl[t] & res_f[cp]
    RLt = RL.t()
    fault_log = move_log & RLt
    remote_log = nv & cold_log & ~hm_log & RLt
    # the dump slots took the gated writes; they hold nothing
    resident[:, pa] = False
    dirty[:, pa] = False
    frames[:, fa] = -1

    logs = torch.stack([fault_log.to(i64), mig_log, wb_log,
                        remote_log.to(i64)], dim=1)        # (n, 4, lanes)
    if phase is None:
        counts = logs.sum(0)[..., None]
    else:
        PH = lane_rows(phase, lanes).to(i64).t()[:, None, :]  # (n, 1, lanes)
        counts = torch.stack([(logs * (PH == k)).sum(0)
                              for k in range(n_phases)], dim=-1)
    return counts.permute(1, 0, 2).to(torch.float64), state
