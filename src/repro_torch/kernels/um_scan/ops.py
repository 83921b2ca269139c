"""Public wrapper of the UM paging scan kernel.

On CUDA tensors :func:`um_scan` launches the kernel in ``csrc/um_scan.cu``
(one CTA of one warp per lane, the lane's state in device buffers); on
CPU tensors it runs the plain version in ``ref.py``.  Any other placement
raises.  :func:`um_scan_host` runs the kernel's step code on the host, from
the same library, as its oracle at full size.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ... import _build
from .ref import initial_state, um_scan_reference

MAX_CHUNK = 64          # UM_MAX_CHUNK in csrc/um_step.cuh


def kernel_tier(chunk_max: int) -> int:
    """Eviction-window candidates each thread of the kernel's warp holds
    for a migration chunk of ``chunk_max`` pages (a window of 4 x chunk, in
    the smallest of the kernel's tiers of 32, 64, 128 and 256 candidates
    that holds it: ``um_walk`` in ``csrc/um_step.cuh``); raises ValueError
    above the top tier.  (The plain version takes any chunk.)"""
    if chunk_max > MAX_CHUNK:
        raise ValueError(f"um_scan: a migration chunk of {chunk_max} pages "
                         f"exceeds the kernel's tier of {MAX_CHUNK} pages "
                         f"(a window of {4 * MAX_CHUNK} candidates, "
                         f"{4 * MAX_CHUNK // 32} a thread)")
    return 1 << (-(-4 * max(1, chunk_max) // 32) - 1).bit_length()


def _check(page, is_write, phase, n_phases, n_pages, lanes):
    if (page.dtype != torch.int32 or page.dim() != 1
            or is_write.dtype != torch.bool
            or is_write.shape != page.shape):
        raise ValueError("um_scan: want page int32[n] and is_write bool[n], "
                         f"got {page.dtype} {tuple(page.shape)} / "
                         f"{is_write.dtype} {tuple(is_write.shape)}")
    if phase is not None and (phase.dtype != torch.int32
                              or phase.shape != page.shape):
        raise ValueError("um_scan: want phase int32[n] or None, got "
                         f"{phase.dtype} {tuple(phase.shape)}")
    if n_pages < 1 or n_phases < 1:
        raise ValueError(f"um_scan: {n_pages} pages / {n_phases} phases")
    if len({len(v) for v in lanes}) != 1:
        raise ValueError("um_scan: lane parameters of unequal lengths")
    n_frames, chunk, _, hot_thresh = lanes
    if (min(n_frames, default=1) < 1 or min(chunk, default=1) < 1
            or min(hot_thresh, default=0) < 0):
        raise ValueError("um_scan: want n_frames >= 1, chunk >= 1 and "
                         "hot_thresh >= 0 in every lane")
    _build.assert_in_range("um_scan page", page, n_pages)
    if phase is not None:
        _build.assert_in_range("um_scan phase", phase, n_phases)


def _chunk_max(lanes) -> int:
    """The largest migration chunk of any lane (nvlink lanes migrate one
    page at a time)."""
    return max((1 if v else c for c, v in zip(lanes[1], lanes[2])),
               default=1)


def _lane_params(n_frames, chunk, nvlink, hot_thresh):
    """int32[lanes, 4]: (n_frames, chunk, nvlink, hot_thresh) per lane."""
    return torch.tensor([[int(f), int(c), int(bool(v)), int(h)]
                         for f, c, v, h in zip(n_frames, chunk, nvlink,
                                               hot_thresh)],
                        dtype=torch.int32).reshape(-1, 4)


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address: the kernel copies the
    request stream into shared memory in 16-byte pieces."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _run(entry: str, page, is_write, phase, n_phases, n_pages, lanes,
         *launch):
    """Call the library's ``entry`` on a fresh cold state (``launch``: the
    kernel's extra arguments); returns (int64 counts, state)."""
    state = initial_state(len(lanes[0]), n_pages, max(lanes[0], default=1),
                          page.device)
    counts = torch.zeros(len(lanes[0]), 4, n_phases, dtype=torch.int64,
                         device=page.device)
    if not lanes[0]:
        return counts, state
    params = _lane_params(*lanes).to(page.device)
    resident, dirty, frames, ptr, hotness = state
    page, is_write = _aligned(page), _aligned(is_write)
    phase = _aligned(phase) if phase is not None else None
    err = getattr(_build.library(), entry)(
        page.data_ptr(), is_write.data_ptr(),
        phase.data_ptr() if phase is not None else None, page.shape[0],
        n_phases, params.data_ptr(), len(lanes[0]), n_pages,
        resident.data_ptr(), dirty.data_ptr(), resident.shape[1] - 1,
        frames.data_ptr(), frames.shape[1] - 1, hotness.data_ptr(),
        ptr.data_ptr(), counts.data_ptr(), *launch)
    _build.check(err, entry)
    return counts, state


def um_scan(page, is_write, phase=None, *, n_phases: int = 1, n_pages: int,
            n_frames: Sequence[int], chunk: Sequence[int],
            nvlink: Sequence[bool], hot_thresh: Sequence[int]):
    """Run every lane's paging scan from the cold state.

    page int32[n] (each < ``n_pages``), is_write bool[n], phase int32[n]
    (each < ``n_phases``) or None; one lane per entry of ``n_frames``,
    ``chunk``, ``nvlink`` and ``hot_thresh``.  Returns (counts
    float64[lanes, 4, n_phases]: faults, migrated pages, writeback pages
    and remote accesses per phase; the final state (resident, dirty,
    frames, ptr, hotness) as ``ref.initial_state`` lays it out).
    """
    lanes = (list(n_frames), list(chunk), list(nvlink), list(hot_thresh))
    tensors = [page, is_write] + ([phase] if phase is not None else [])
    where = _build.placement("um_scan", *tensors)
    _check(page, is_write, phase, n_phases, n_pages, lanes)
    if where == "cpu":
        return um_scan_reference(
            page, is_write, phase, n_phases=n_phases, n_pages=n_pages,
            n_frames=lanes[0], chunk=lanes[1], nvlink=lanes[2],
            hot_thresh=lanes[3])
    kernel_tier(_chunk_max(lanes))
    with torch.cuda.device(page.device):
        counts, state = _run("um_scan_launch", page, is_write, phase,
                             n_phases, n_pages, lanes,
                             _build.stream_ptr(page))
    if lanes[0]:
        _build.count("um_scan")
    return counts.to(torch.float64), state


def um_scan_host(page, is_write, phase=None, *, n_phases: int = 1,
                 n_pages: int, n_frames: Sequence[int],
                 chunk: Sequence[int], nvlink: Sequence[bool],
                 hot_thresh: Sequence[int]):
    """:func:`um_scan` on CPU tensors through the kernel's own step code,
    built for the host (``um_scan_host`` in ``csrc/um_scan.cu``), one lane
    after another; needs the nvcc-built library.  Not counted as a
    launch."""
    lanes = (list(n_frames), list(chunk), list(nvlink), list(hot_thresh))
    tensors = [page, is_write] + ([phase] if phase is not None else [])
    if _build.placement("um_scan_host", *tensors) != "cpu":
        raise ValueError("um_scan_host: takes CPU tensors")
    _check(page, is_write, phase, n_phases, n_pages, lanes)
    kernel_tier(_chunk_max(lanes))
    counts, state = _run("um_scan_host", page, is_write, phase, n_phases,
                         n_pages, lanes)
    return counts.to(torch.float64), state
