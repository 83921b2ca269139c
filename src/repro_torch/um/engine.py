"""Batched Unified-Memory paging engine on PyTorch, with its scan as a
CUDA kernel.

The UM baseline (oversubscribed HBM + page migration over a host link) is
the system the paper's headline speedups are measured against.  As in the
reference (``repro.um.engine``):

  * A :class:`UMSpec` holds one run's runtime parameters: resident frame
    count, migration chunk, link mode and the nvlink migration threshold.
    :func:`um_spec` derives it from an ``HMSConfig`` and normalizes the
    fields a link mode ignores, so equal paging behavior gives equal specs.
  * :func:`simulate_um_many` runs a batch of specs over one trace as the
    lanes of ONE ``um_scan`` call.  Duplicate specs run as one lane; specs
    whose frames cover every page early-out to zero counters with no
    device work; results are memoized per (trace, spec), weakly keyed on
    the trace, and come back in input order.
  * Every counter is an integer count per phase (trace-order ``phase_id``;
    unphased traces are one phase); the whole-trace totals are *defined*
    as ``np.sum`` of the per-phase vector.

Not ported yet (ROADMAP A7-A9): the temporal split (the reference's
T > 1 is bit-identical to the T = 1 scan run here), the degradation
ladder, sweep checkpoints, the cost model and the run ledger.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..core.timing import COLUMN_BYTES, UM_PAGE_BYTES, HMSConfig
from ..core.traces import Trace
from ..kernels.um_scan import ops as um_ops
from ..resilience import validate as _rvalidate


@dataclasses.dataclass(frozen=True)
class UMSpec:
    """Runtime parameters of one UM paging run over a trace.  Two specs
    over the same trace run as lanes of one scan; identical specs share a
    result."""

    n_frames: int           # resident HBM frames (capacity / page size)
    chunk: int              # TBN-style migration chunk, pages (fault mode)
    nvlink: bool = False    # hardware-coherent link: remote access + counter
    hot_thresh: int = 4     # access count that triggers nvlink migration


def um_spec(cfg: HMSConfig, nvlink: bool = False) -> UMSpec:
    """Derive the UM runtime parameters from a memory-system config.

    Mode-irrelevant fields are normalized: nvlink migrates one page at a
    time (chunk pinned to 1), fault mode never consults the access-counter
    threshold (pinned to 0)."""
    nv = bool(nvlink)
    return UMSpec(
        n_frames=max(1, cfg.hbm_capacity // UM_PAGE_BYTES),
        chunk=1 if nv else int(cfg.um_prefetch_pages),
        nvlink=nv,
        hot_thresh=int(cfg.um_hot_threshold) if nv else 0,
    )


@dataclasses.dataclass(frozen=True)
class UMResult:
    """Per-phase UM paging counters (float64, shape ``(n_phases,)``).

    Whole-trace totals are *defined* as ``np.sum`` over the per-phase
    vectors (unphased traces carry one anonymous phase)."""

    spec: UMSpec
    phase_faults: np.ndarray
    phase_migrated: np.ndarray
    phase_writebacks: np.ndarray
    phase_remote_cols: np.ndarray

    @property
    def faults(self) -> float:
        return float(np.sum(self.phase_faults))

    @property
    def migrated(self) -> float:
        return float(np.sum(self.phase_migrated))

    @property
    def writebacks(self) -> float:
        return float(np.sum(self.phase_writebacks))

    @property
    def remote_cols(self) -> float:
        return float(np.sum(self.phase_remote_cols))

    @property
    def link_bytes(self) -> float:
        """Host-link traffic: whole pages for migrations/writebacks plus
        cacheline-granular remote accesses (nvlink mode)."""
        return ((self.migrated + self.writebacks) * UM_PAGE_BYTES
                + self.remote_cols * COLUMN_BYTES)

    def counter_arrays(self) -> Dict[str, object]:
        """UM counters in ``SimResult.counters`` form: per-phase float64
        vectors for phased traces, plain floats for unphased ones."""
        d = {
            "um_faults": self.phase_faults,
            "um_migrated": self.phase_migrated,
            "um_writebacks": self.phase_writebacks,
            "um_remote_cols": self.phase_remote_cols,
        }
        if self.phase_faults.shape[0] == 1:
            return {k: float(v[0]) for k, v in d.items()}
        return d


_RESULT_CACHE: "weakref.WeakKeyDictionary[Trace, dict]" = \
    weakref.WeakKeyDictionary()
_PAGE_CACHE: "weakref.WeakKeyDictionary[Trace, tuple]" = \
    weakref.WeakKeyDictionary()


def _page_stream(trace: Trace):
    """(page int32[n], n_pages) of a trace: its 4 KiB UM pages."""
    if trace not in _PAGE_CACHE:
        page = ((trace.col * COLUMN_BYTES) // UM_PAGE_BYTES).astype(np.int32)
        n_pages = int(page.max(initial=0)) + 1
        _PAGE_CACHE[trace] = (page, n_pages)
    return _PAGE_CACHE[trace]


def scan_args(trace: Trace, specs: Sequence[UMSpec], dev) -> dict:
    """The keyword arguments of the ``um_scan`` call that runs ``specs``
    (one lane each) over ``trace`` on device ``dev``."""
    page, n_pages = _page_stream(trace)
    n_ph = trace.n_phases

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return dict(page=to(page), is_write=to(trace.is_write.astype(bool)),
                phase=to(trace.phase_id) if n_ph > 1 else None,
                n_phases=n_ph, n_pages=n_pages,
                n_frames=[s.n_frames for s in specs],
                chunk=[s.chunk for s in specs],
                nvlink=[s.nvlink for s in specs],
                hot_thresh=[s.hot_thresh for s in specs])


def simulate_um_many(trace: Trace, specs: Sequence[UMSpec], *,
                     device=None) -> List[UMResult]:
    """Run a batch of UM specs over one trace: one ``um_scan`` call for
    every spec not already memoized, duplicate specs deduped to one lane.
    Specs whose frames cover the whole footprint early-out to zero
    counters without touching the device.  ``device=None`` runs on the
    CUDA card (raises if there is none), ``device="cpu"`` runs the
    kernel's plain version.  Results come back in input order; the memo
    is kept per device, so a card run never returns a host result."""
    dev = resolve_device(device, "simulate_um_many")
    specs = list(specs)
    for s in specs:
        _rvalidate.validate_um_spec(s)
    cache = _RESULT_CACHE.setdefault(trace, {})
    _, n_pages = _page_stream(trace)

    run: List[UMSpec] = []
    for s in specs:
        if (dev.type, s) in cache or s in run:
            continue
        if s.n_frames >= n_pages:
            z = np.zeros((trace.n_phases,), np.float64)
            cache[(dev.type, s)] = UMResult(s, z, z.copy(), z.copy(),
                                            z.copy())
            continue
        run.append(s)

    if run:
        counts, _ = um_ops.um_scan(**scan_args(trace, run, dev))
        C = counts.cpu().numpy()
        for j, s in enumerate(run):
            cache[(dev.type, s)] = UMResult(s, *(C[j, k].copy()
                                                 for k in range(4)))
    return [cache[(dev.type, s)] for s in specs]


def simulate_um(trace: Trace, cfg: HMSConfig, nvlink: bool = False, *,
                device=None) -> UMResult:
    """Single-config convenience wrapper: derives the :class:`UMSpec` from
    ``cfg`` and runs it through the batched path (memoized per trace)."""
    return simulate_um_many(trace, [um_spec(cfg, nvlink)], device=device)[0]
