"""Public wrappers of the HMS scan kernels.

On CUDA tensors :func:`hms_scan` and :func:`ema_scan` launch the kernels
in ``csrc/hms_scan.cu``; on CPU tensors they run the plain versions in
``ref.py``.  Any other placement raises.
"""

from __future__ import annotations

import torch

from ... import _build
from ...core.timing import POLICIES
from .ref import ema_scan_reference, hms_scan_reference, initial_state

POLICY_IDS = {p: i for i, p in enumerate(POLICIES)}   # HmsPolicy in C


def hms_scan(slot, meta, *, policy: str, e_ways: int, n_sets: int,
             lines_alloc: int, sets_alloc: int, ways_alloc: int,
             sectors: int):
    """Run every lane's scan from the cold state.

    slot int32[lanes, depth] (shard-local cache slots, < lines_alloc) and
    meta int64[lanes, depth] (packed request words, see
    ``csrc/hms_step.cuh``).  Returns (y int32[lanes, depth] decision
    words, final cache int32[lanes, lines_alloc], final CTC
    int64[lanes, sets_alloc, ways_alloc]).
    """
    kw = dict(policy=policy, e_ways=e_ways, n_sets=n_sets,
              lines_alloc=lines_alloc, sets_alloc=sets_alloc,
              ways_alloc=ways_alloc, sectors=sectors)
    if _build.placement("hms_scan", slot, meta) == "cpu":
        return hms_scan_reference(slot, meta, **kw)
    if policy not in POLICY_IDS:
        raise ValueError(f"hms_scan: unknown policy {policy!r}")
    if (slot.dtype != torch.int32 or meta.dtype != torch.int64
            or slot.dim() != 2 or slot.shape != meta.shape):
        raise ValueError("hms_scan: want slot int32[lanes, depth] and meta "
                         f"int64 of the same shape, got {slot.dtype} "
                         f"{tuple(slot.shape)} / {meta.dtype} "
                         f"{tuple(meta.shape)}")
    if not (1 <= e_ways <= ways_alloc and 1 <= n_sets <= sets_alloc):
        raise ValueError(f"hms_scan: {e_ways} ways / {n_sets} sets exceed "
                         f"the {ways_alloc} x {sets_alloc} allocation")
    lanes, depth = slot.shape
    slot, meta = slot.contiguous(), meta.contiguous()
    _build.assert_in_range("hms_scan slot", slot, lines_alloc)
    cache, ctc = initial_state(lanes, lines_alloc, sets_alloc, ways_alloc,
                               sectors, slot.device)
    y = torch.empty_like(slot)
    if lanes == 0 or depth == 0:
        return y, cache, ctc
    lib = _build.library()
    with torch.cuda.device(slot.device):
        err = lib.hms_scan_launch(
            POLICY_IDS[policy], slot.data_ptr(), meta.data_ptr(), lanes,
            depth, cache.data_ptr(), lines_alloc, ctc.data_ptr(), sets_alloc,
            ways_alloc, e_ways, n_sets, y.data_ptr(),
            _build.stream_ptr(slot))
    _build.check(err, "hms_scan")
    _build.count("hms_scan")
    return y, cache, ctc


def ema_scan(values, weight: float):
    """float64[n] -> float64[n]: the sequential moving average from 0."""
    if _build.placement("ema_scan", values) == "cpu":
        return ema_scan_reference(values, weight)
    if values.dtype != torch.float64 or values.dim() != 1:
        raise ValueError(f"ema_scan: want float64[n], got {values.dtype} "
                         f"{tuple(values.shape)}")
    values = values.contiguous()
    out = torch.empty_like(values)
    if values.shape[0] == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(values.device):
        err = lib.ema_scan_launch(values.data_ptr(), values.shape[0],
                                  float(weight), out.data_ptr(),
                                  _build.stream_ptr(values))
    _build.check(err, "ema_scan")
    _build.count("ema_scan")
    return out
