"""Phase IR: composable multi-kernel workload scenarios.

The paper's bypass / CTC designs are motivated by *multi-dimensional* GPU
access behavior — streaming weight reads, growing KV-cache reuse, thrashing
graph frontiers — inside one application.  The single-pattern generators in
``repro_torch.core.traces`` can't express that, so this module adds a small
IR:

  :class:`Phase`     one kernel-like epoch: a pattern primitive over one
                     named address region, with a read/write mix and
                     reuse/locality parameters.
  :class:`Scenario`  a named set of regions (fractions of the footprint,
                     shared or disjoint between phases) plus a sequence of
                     phases.  Consecutive phases tagged with the same
                     ``interleave`` group run concurrently (proportionally
                     merged, like kernels sharing the GPU); otherwise phases
                     run back-to-back.  ``compile`` turns the scenario into
                     an ordinary :class:`~repro_torch.core.traces.Trace`
                     carrying a per-request ``phase_id``, so ``simulate``
                     consumes it unchanged and attributes counters per phase.

``compile(oversub=...)`` scales every region (and therefore the trace
footprint) while the request count stays fixed — the knob behind the
footprint-oversubscription sweeps (Fig. 2 / Fig. 17 style curves): hold the
memory system at the oversub=1.0 capacity and grow the working set past it.

Pattern primitives take ``(rng, total_columns, n, **params)`` and return
``(col, is_write | None)``; a ``None`` write mask defers to the phase's
``write_frac``.  All primitives honor ``n`` exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.timing import COLUMN_BYTES
from repro_torch.core.traces import (MiB, Trace, _powerlaw_nodes,
                                     split_weighted)


# ---------------------------------------------------------------------------
# Pattern primitives.
# ---------------------------------------------------------------------------

def _pat_stream(rng, total, n, stride=1.0, start_frac=0.0):
    """Sequential sweep at ``stride`` columns/request, wrapping the region."""
    start = int(total * start_frac)
    col = (start + (np.arange(n, dtype=np.int64)
                    * max(1, int(stride)))) % total
    return col, None


def _pat_random(rng, total, n):
    """Uniform random over the region — no spatial locality at all."""
    return rng.integers(0, total, size=n).astype(np.int64), None


def _pat_zipf(rng, total, n, hot_frac=1 / 16, hot_prob=0.8):
    """Hot/cold skew: ``hot_prob`` of requests land in the first
    ``hot_frac`` of the region."""
    hot = max(1, int(total * hot_frac))
    is_hot = rng.random(n) < hot_prob
    col = np.where(is_hot,
                   rng.integers(0, hot, size=n),
                   rng.integers(min(hot, total - 1), total, size=n))
    return col.astype(np.int64), None


def _pat_burst(rng, total, n, burst=4, alpha=1.1):
    """Power-law node selection with short sequential bursts — graph
    frontier expansion (adjacency-list fetches)."""
    burst = max(1, int(burst))
    n_nodes = max(1, total // burst)
    nodes = _powerlaw_nodes(rng, n_nodes, -(-n // burst), alpha=alpha)
    col = ((nodes * burst)[:, None]
           + np.arange(burst)[None, :]).reshape(-1) % total
    return col[:n].astype(np.int64), None


def _pat_growing(rng, total, n, lo_frac=0.05):
    """Random reuse over a prefix that grows linearly from ``lo_frac`` of
    the region to all of it across the phase — a KV cache filling up."""
    frac = lo_frac + (1.0 - lo_frac) * (np.arange(n) + 1.0) / max(1, n)
    lim = np.maximum(1, (total * frac).astype(np.int64))
    col = (rng.random(n) * lim).astype(np.int64)
    return np.minimum(col, total - 1), None


def _pat_append(rng, total, n):
    """Sequential writes walking the region — log/KV/activation append."""
    col = np.arange(n, dtype=np.int64) % total
    return col, np.ones(n, dtype=bool)


def _pat_rmw(rng, total, n, span_frac=1.0):
    """Read-modify-write pairs at random addresses (optimizer state,
    rank updates): each address is read then immediately written."""
    span = max(1, int(total * span_frac))
    addr = rng.integers(0, span, size=-(-n // 2)).astype(np.int64)
    col = np.repeat(addr, 2)[:n]
    wr = np.tile([False, True], addr.shape[0])[:n]
    return col, wr


PATTERNS: Dict[str, Callable] = {
    "stream": _pat_stream,
    "random": _pat_random,
    "zipf": _pat_zipf,
    "burst": _pat_burst,
    "growing": _pat_growing,
    "append": _pat_append,
    "rmw": _pat_rmw,
}


# ---------------------------------------------------------------------------
# IR dataclasses.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Phase:
    """One kernel-like epoch of a scenario."""

    name: str
    region: str                 # key into Scenario.regions
    pattern: str                # key into PATTERNS
    weight: float = 1.0         # share of the scenario's request budget
    write_frac: float = 0.0     # used when the pattern has no intrinsic mask
    params: Mapping[str, float] = dataclasses.field(default_factory=dict)
    # Consecutive phases sharing an interleave tag are proportionally merged
    # into one concurrent epoch (None = runs alone, in sequence).
    interleave: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Regions + phase sequence; compiles to a phase-tagged Trace."""

    name: str
    regions: Mapping[str, float]        # region -> fraction of footprint
    phases: Tuple[Phase, ...]
    footprint: int = 32 * MiB
    description: str = ""

    def __post_init__(self):
        # structured validation (field path + fix hint, survives python -O)
        from repro_torch.resilience.validate import validate_scenario
        validate_scenario(self, patterns=PATTERNS)

    @property
    def phase_names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.phases)

    def compile(self, n: int = 240_000, footprint: int | None = None,
                seed: int = 0, oversub: float = 1.0) -> Trace:
        """Generate the request stream: exactly ``n`` requests, regions laid
        out contiguously within ``footprint * oversub`` bytes, per-request
        ``phase_id`` tagging."""
        from repro_torch.resilience.validate import ValidationError
        if n < 1:
            raise ValidationError(
                f"Scenario({self.name}).compile(n)", n,
                "at least one request")
        fp = int((self.footprint if footprint is None else footprint)
                 * oversub)
        total = fp // COLUMN_BYTES
        # region layout: contiguous spans in declaration order
        spans: Dict[str, Tuple[int, int]] = {}
        cursor = 0
        for rname, frac in self.regions.items():
            size = max(16, int(total * frac))
            size = min(size, total - cursor)
            if size <= 0:
                raise ValidationError(
                    f"Scenario({self.name}).footprint", fp,
                    f"enough bytes to lay out region {rname!r}",
                    "grow the footprint/oversub or shrink earlier regions")
            spans[rname] = (cursor, size)
            cursor += size

        ns = split_weighted(n, [p.weight for p in self.phases])
        cols, wrs = [], []
        for i, (phase, n_i) in enumerate(zip(self.phases, ns)):
            rng = np.random.default_rng([seed, i])
            start, size = spans[phase.region]
            col, wr = PATTERNS[phase.pattern](rng, size, int(n_i),
                                             **phase.params)
            if wr is None:
                wr = rng.random(int(n_i)) < phase.write_frac
            cols.append(col + start)
            wrs.append(np.asarray(wr, dtype=bool))

        # Epoch assembly: consecutive phases sharing an interleave tag merge
        # proportionally (position i of a phase of length m sorts at
        # (i+0.5)/m, so streams blend at their natural rates); everything
        # else concatenates in declaration order.
        col_out, wr_out, pid_out = [], [], []

        def flush(group):
            if not group:
                return
            lens = [cols[i].shape[0] for i in group]
            keys = np.concatenate(
                [(np.arange(m) + 0.5) / max(1, m) for m in lens])
            order = np.argsort(keys, kind="stable")
            col_out.append(np.concatenate([cols[i] for i in group])[order])
            wr_out.append(np.concatenate([wrs[i] for i in group])[order])
            pid_out.append(np.concatenate(
                [np.full(m, i, np.int32) for i, m in zip(group, lens)])[order])

        pending: list = []
        for i, phase in enumerate(self.phases):
            if (pending and phase.interleave is not None
                    and self.phases[pending[-1]].interleave
                    == phase.interleave):
                pending.append(i)
                continue
            flush(pending)
            pending = [i]
        flush(pending)

        return Trace(self.name,
                     np.concatenate(col_out),
                     np.concatenate(wr_out),
                     fp,
                     phase_id=np.concatenate(pid_out),
                     phase_names=self.phase_names)

    def as_workload(self) -> Callable[..., Trace]:
        """A generator callable with the (footprint, n, seed) signature the
        ``WORKLOADS`` registry and ``make_trace`` expect."""
        scn = self

        def gen(footprint: int = scn.footprint, n: int = 240_000,
                seed: int = 0, oversub: float = 1.0) -> Trace:
            return scn.compile(n=n, footprint=footprint, seed=seed,
                               oversub=oversub)

        gen.__name__ = f"scenario_{scn.name}"
        gen.__doc__ = scn.description or f"Scenario {scn.name}"
        return gen
