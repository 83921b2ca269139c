"""Public wrapper of the UM paging scan kernel.

On CUDA tensors :func:`um_scan` launches the kernel in ``csrc/um_scan.cu``
(one CTA of one warp per lane, the lane's state in device buffers; a lane
is one spec x temporal segment, starting from the state it is given); on
CPU tensors it runs the plain version in ``ref.py``.  Any other placement
raises.  :func:`um_scan_host` runs the kernel's step code on the host, from
the same library, as its oracle at full size.
"""

from __future__ import annotations

import functools
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


def _check(page, is_write, phase, n_phases, n_pages, lanes, real=None,
           live=None):
    if (page.dtype != torch.int32 or page.dim() not in (1, 2)
            or is_write.dtype != torch.bool
            or is_write.shape != page.shape):
        raise ValueError("um_scan: want page int32[n] or int32[T, L] and "
                         "is_write bool of the same shape, got "
                         f"{page.dtype} {tuple(page.shape)} / "
                         f"{is_write.dtype} {tuple(is_write.shape)}")
    if phase is not None and (phase.dtype != torch.int32
                              or phase.shape != page.shape):
        raise ValueError("um_scan: want phase int32 of the page stream's "
                         f"shape or None, got {phase.dtype} "
                         f"{tuple(phase.shape)}")
    for name, g in (("real", real), ("live", live)):
        if g is not None and (g.dtype != torch.bool or g.shape != page.shape):
            raise ValueError(f"um_scan: want {name} bool of the page "
                             f"stream's shape or None, got {g.dtype} "
                             f"{tuple(g.shape)}")
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


def _lane_params(n_frames, chunk, nvlink, hot_thresh, rows: int = 1):
    """int32[lanes, 4]: (n_frames, chunk, nvlink, hot_thresh) per lane, each
    spec's row repeated for its ``rows`` segments."""
    return torch.tensor([[int(f), int(c), int(bool(v)), int(h)]
                         for f, c, v, h in zip(n_frames, chunk, nvlink,
                                               hot_thresh)],
                        dtype=torch.int32).reshape(-1, 4) \
        .repeat_interleave(rows, dim=0)


@functools.lru_cache(maxsize=64)
def _device_params(lanes, rows: int, device: str):
    """:func:`_lane_params` on ``device``, made once per lane set (the
    rounds of a stitch launch with the same lanes; a host-to-device copy
    would cost each round a host sync)."""
    return _lane_params(*lanes, rows=rows).to(device)


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address: the kernel copies the
    request stream into shared memory in 16-byte pieces."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _flags(is_write, real, live):
    """uint8 flags a step: bit 0 write, 1 real, 2 live (csrc/um_step.cuh)."""
    f = is_write.to(torch.uint8)
    f = f | (real.to(torch.uint8) << 1 if real is not None else 2)
    return f | (live.to(torch.uint8) << 2 if live is not None else 4)


def _rows(x, stride: int):
    """(T, L) -> (T, stride): each row padded to the kernel's 16-step row
    stride (padding steps are neither real nor live)."""
    if x.dim() == 1 or x.shape[1] == stride:
        return x
    return torch.nn.functional.pad(x, (0, stride - x.shape[1]))


def _run(entry: str, page, is_write, phase, n_phases, n_pages, lanes, real,
         live, state, *launch):
    """Call the library's ``entry`` from ``state`` (cold where None; not
    written) (``launch``: the kernel's extra arguments); returns (int64
    counts, final state)."""
    rows = 1 if page.dim() == 1 else page.shape[0]
    n_lanes = len(lanes[0]) * rows
    if state is None:
        state = initial_state(n_lanes, n_pages, max(lanes[0], default=1),
                              page.device)
    else:
        state = tuple(x.clone() for x in state)
    counts = torch.zeros(n_lanes, 4, n_phases, dtype=torch.int64,
                         device=page.device)
    if not n_lanes:
        return counts, state
    params = _device_params(tuple(map(tuple, lanes)), rows, str(page.device))
    resident, dirty, frames, ptr, hotness = state
    length = page.shape[-1]
    stride = -(-length // 16) * 16 if rows > 1 else length
    flags = _aligned(_rows(_flags(is_write, real, live), stride))
    page = _aligned(_rows(page, stride))
    phase = _aligned(_rows(phase, stride)) if phase is not None else None
    err = getattr(_build.library(), entry)(
        page.data_ptr(), flags.data_ptr(),
        phase.data_ptr() if phase is not None else None, length, stride,
        rows, n_phases, params.data_ptr(), n_lanes, n_pages,
        resident.data_ptr(), dirty.data_ptr(), resident.shape[1] - 1,
        frames.data_ptr(), frames.shape[1] - 1, hotness.data_ptr(),
        ptr.data_ptr(), counts.data_ptr(), *launch)
    _build.check(err, entry)
    return counts, state


def _check_state(state, rows: int, lanes, n_pages: int):
    """A starting state must be laid out as :func:`ref.initial_state` lays
    out the call's lanes."""
    if state is None:
        return
    want = initial_state(0, n_pages, max(lanes[0], default=1), "meta")
    n = len(lanes[0]) * rows
    for got, w in zip(state, want):
        if got.dtype != w.dtype or tuple(got.shape) != (n,) + tuple(
                w.shape[1:]):
            raise ValueError("um_scan: want a state laid out as "
                             "ref.initial_state lays out the call's lanes, "
                             f"got {got.dtype} {tuple(got.shape)}")


def um_scan(page, is_write, phase=None, *, n_phases: int = 1, n_pages: int,
            n_frames: Sequence[int], chunk: Sequence[int],
            nvlink: Sequence[bool], hot_thresh: Sequence[int], real=None,
            live=None, state=None):
    """Run every lane's paging scan.

    page int32[n] (each < ``n_pages``), is_write bool[n], phase int32[n]
    (each < ``n_phases``) or None; or, for T temporal segments, each of
    them [T, L] with ``real`` and ``live`` bool[T, L] gating the
    segments' replay and padding steps.  One spec per entry of
    ``n_frames``, ``chunk``, ``nvlink`` and ``hot_thresh``; the lanes are
    specs x rows (lane l: spec l // T on row l % T).  ``state`` is the
    lanes' starting state as ``ref.initial_state`` lays it out (cold
    where None; not written).  Returns (counts float64[lanes, 4,
    n_phases]: faults, migrated pages, writeback pages and remote
    accesses per phase; the final state).
    """
    lanes = (list(n_frames), list(chunk), list(nvlink), list(hot_thresh))
    tensors = [page, is_write] + [t for t in (phase, real, live)
                                  if t is not None]
    if state is not None:
        tensors += list(state)
    where = _build.placement("um_scan", *tensors)
    _check(page, is_write, phase, n_phases, n_pages, lanes, real, live)
    rows = 1 if page.dim() == 1 else page.shape[0]
    _check_state(state, rows, lanes, n_pages)
    if where == "cpu":
        return um_scan_reference(
            page, is_write, phase, n_phases=n_phases, n_pages=n_pages,
            n_frames=lanes[0], chunk=lanes[1], nvlink=lanes[2],
            hot_thresh=lanes[3], real=real, live=live, state=state)
    kernel_tier(_chunk_max(lanes))
    with torch.cuda.device(page.device):
        counts, state = _run("um_scan_launch", page, is_write, phase,
                             n_phases, n_pages, lanes, real, live, state,
                             _build.stream_ptr(page))
    if lanes[0]:
        _build.count("um_scan")
    return counts.to(torch.float64), state


def um_scan_host(page, is_write, phase=None, *, n_phases: int = 1,
                 n_pages: int, n_frames: Sequence[int],
                 chunk: Sequence[int], nvlink: Sequence[bool],
                 hot_thresh: Sequence[int], real=None, live=None,
                 state=None):
    """:func:`um_scan` on CPU tensors through the kernel's own step code,
    built for the host (``um_scan_host`` in ``csrc/um_scan.cu``), one lane
    after another; needs the nvcc-built library.  Not counted as a
    launch."""
    lanes = (list(n_frames), list(chunk), list(nvlink), list(hot_thresh))
    tensors = [page, is_write] + [t for t in (phase, real, live)
                                  if t is not None]
    if state is not None:
        tensors += list(state)
    if _build.placement("um_scan_host", *tensors) != "cpu":
        raise ValueError("um_scan_host: takes CPU tensors")
    _check(page, is_write, phase, n_phases, n_pages, lanes, real, live)
    _check_state(state, 1 if page.dim() == 1 else page.shape[0], lanes,
                 n_pages)
    kernel_tier(_chunk_max(lanes))
    counts, state = _run("um_scan_host", page, is_write, phase, n_phases,
                         n_pages, lanes, real, live, state)
    return counts.to(torch.float64), state
