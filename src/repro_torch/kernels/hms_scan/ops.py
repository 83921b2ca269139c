"""Public wrappers of the HMS scan kernels.

On CUDA tensors :func:`hms_scan` and :func:`ema_scan` launch the kernels
in ``csrc/hms_scan.cu``; on CPU tensors they run the plain versions in
``ref.py``.  Any other placement raises.

The scan kernel runs one chain per (lane, domain): a domain is a CTC set
under a CTC policy, a row-group residue without one (``csrc/hms_step.cuh``).
:func:`scan_plan` picks the domains and checks, on either device, that they
split each lane's state: every slot belongs to one domain only.
:func:`chain_order` sorts the steps by chain, so that each chain's steps
are one contiguous run of the streams the kernel reads.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import _build
from ...core.timing import POLICIES, POLICIES_WITH_CTC
from .ref import ema_scan_reference, hms_scan_reference, initial_state

POLICY_IDS = {p: i for i, p in enumerate(POLICIES)}   # HmsPolicy in C
# chains the kernel aims for without a CTC (the card has 132 SMs, each
# issuing for 4 warps at once)
TARGET_CHAINS = 128
MAX_WAYS = 64                  # two CTC ways per thread


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    domains: int          # chains per lane
    longest_chain: int    # most steps of one (lane, domain)


def domain_count(policy: str, n_sets: int, lines_alloc: int, spg: int,
                 lanes: int) -> int:
    """Domains per lane: the CTC sets under a CTC policy (each owns one
    row), else enough row-group residues for ~TARGET_CHAINS chains."""
    if policy in POLICIES_WITH_CTC:
        return n_sets
    groups = -(-lines_alloc // spg)
    return max(1, min(groups, -(-TARGET_CHAINS // max(lanes, 1))))


def _plan(slot, meta, *, policy: str, n_sets: int, lines_alloc: int,
          spg: int):
    """(plan, chain, counts): the plan, each step's chain lane * domains +
    row group % domains (int64[lanes, depth]) and the steps of each chain
    (int64[lanes * domains]).  Raises ValueError unless, in every lane,
    each slot is touched by one domain only.  One host sync."""
    lanes, depth = slot.shape
    D = domain_count(policy, n_sets, lines_alloc, spg, lanes)
    i64 = torch.int64
    dom = ((meta >> 17) & 0x7FFFFF) % D
    lane = torch.arange(lanes, dtype=i64, device=slot.device)[:, None]
    chain = lane * D + dom
    # (bincount would sync with the host to size its output)
    counts = torch.zeros(lanes * D, dtype=i64, device=slot.device)
    counts.index_add_(0, chain.reshape(-1),
                      torch.ones(lanes * depth, dtype=i64,
                                 device=slot.device))
    if lanes == 0 or depth == 0:
        return ScanPlan(D, 0), chain, counts
    # the domain each slot collects, lowest and highest
    key = (lane * lines_alloc + slot).reshape(-1)
    lo = torch.full((lanes * lines_alloc,), D, dtype=i64, device=slot.device)
    hi = torch.full((lanes * lines_alloc,), -1, dtype=i64,
                    device=slot.device)
    lo = lo.scatter_reduce(0, key, dom.reshape(-1), "amin")
    hi = hi.scatter_reduce(0, key, dom.reshape(-1), "amax")
    split, longest = torch.stack([((hi >= 0) & (lo != hi)).any().to(i64),
                                  counts.max()]).tolist()
    if split:
        raise ValueError(f"hms_scan: a slot is touched by two domains of "
                         f"{D} (row group % {D}); the stream's row groups "
                         f"do not partition its slots")
    return ScanPlan(D, longest), chain, counts


def scan_plan(slot, meta, *, policy: str, n_sets: int, lines_alloc: int,
              spg: int, **_) -> ScanPlan:
    """How the kernel splits ``slot``/``meta`` (int32/int64[lanes, depth])
    into chains; raises ValueError where the domains would not split the
    lanes' state (see :func:`_plan`)."""
    return _plan(slot, meta, policy=policy, n_sets=n_sets,
                 lines_alloc=lines_alloc, spg=spg)[0]


def chain_order(chain, counts):
    """(order, offsets): the flat step indices sorted stably by chain, and
    where each chain's run starts in that order (int64[chains + 1]), so
    chain c's steps, in stream order, are ``order[offsets[c]:offsets[c +
    1]]`` (hms_lane_by_domain in csrc/hms_step.cuh walks them so)."""
    order = torch.argsort(chain.reshape(-1), stable=True)
    offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                          device=chain.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return order, offsets


def hms_scan(slot, meta, *, policy: str, e_ways: int, n_sets: int,
             lines_alloc: int, sets_alloc: int, ways_alloc: int,
             sectors: int, spg: int):
    """Run every lane's scan from the cold state.

    slot int32[lanes, depth] (shard-local cache slots, < lines_alloc) and
    meta int64[lanes, depth] (packed request words, see
    ``csrc/hms_step.cuh``); ``spg`` cache slots per row group.  Returns
    (y int32[lanes, depth] decision words, final cache
    int32[lanes, lines_alloc], final CTC int64[lanes, sets_alloc,
    ways_alloc]).
    """
    kw = dict(policy=policy, e_ways=e_ways, n_sets=n_sets,
              lines_alloc=lines_alloc, sets_alloc=sets_alloc,
              ways_alloc=ways_alloc, sectors=sectors)
    where = _build.placement("hms_scan", slot, meta)
    if policy not in POLICY_IDS:
        raise ValueError(f"hms_scan: unknown policy {policy!r}")
    if (slot.dtype != torch.int32 or meta.dtype != torch.int64
            or slot.dim() != 2 or slot.shape != meta.shape):
        raise ValueError("hms_scan: want slot int32[lanes, depth] and meta "
                         f"int64 of the same shape, got {slot.dtype} "
                         f"{tuple(slot.shape)} / {meta.dtype} "
                         f"{tuple(meta.shape)}")
    if not (1 <= e_ways <= ways_alloc <= MAX_WAYS
            and 1 <= n_sets <= sets_alloc):
        raise ValueError(f"hms_scan: {e_ways} ways / {n_sets} sets exceed "
                         f"the {ways_alloc} x {sets_alloc} allocation (at "
                         f"most {MAX_WAYS} ways)")
    _build.assert_in_range("hms_scan slot", slot, lines_alloc)
    plan, chain, counts = _plan(slot, meta, policy=policy, n_sets=n_sets,
                                lines_alloc=lines_alloc, spg=spg)
    if where == "cpu":
        return hms_scan_reference(slot, meta, **kw)
    lanes, depth = slot.shape
    cache, ctc = initial_state(lanes, lines_alloc, sets_alloc, ways_alloc,
                               sectors, slot.device)
    y = torch.empty_like(slot)
    n = lanes * depth
    if n == 0:
        return y, cache, ctc
    order, offsets = chain_order(chain, counts)
    # the kernel stages runs by bulk copy from 4-step boundaries: the sorted
    # streams are padded to a multiple of 4 (with entries of no chain)
    pad = order.new_zeros(-n % 4)
    take = torch.cat([order, pad]) if pad.numel() else order
    slot_s = slot.reshape(-1)[take]
    meta_s = meta.reshape(-1)[take]
    y_s = torch.empty_like(slot_s)
    lib = _build.library()
    with torch.cuda.device(slot.device):
        err = lib.hms_scan_launch(
            POLICY_IDS[policy], slot_s.data_ptr(), meta_s.data_ptr(),
            offsets.data_ptr(), lanes, cache.data_ptr(), lines_alloc,
            ctc.data_ptr(), sets_alloc, ways_alloc, e_ways, plan.domains,
            y_s.data_ptr(), _build.stream_ptr(slot))
    _build.check(err, "hms_scan")
    _build.count("hms_scan")
    y.view(-1)[order] = y_s[:n]
    return y, cache, ctc


def ema_scan(values, weight: float):
    """float64[n] -> float64[n]: the sequential moving average from 0."""
    if _build.placement("ema_scan", values) == "cpu":
        return ema_scan_reference(values, weight)
    if values.dtype != torch.float64 or values.dim() != 1:
        raise ValueError(f"ema_scan: want float64[n], got {values.dtype} "
                         f"{tuple(values.shape)}")
    values = values.contiguous()
    if values.data_ptr() % 16:         # bulk copies need 16-byte alignment
        values = values.clone()
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
