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

Temporal splitting
------------------
The paging scan cannot shard, so its only depth lever is the temporal
split (``repro_torch.core.tsplit``): T segments of the trace run as
extra lanes of the same ``um_scan`` launch (lanes = specs x segments),
each from a guessed boundary carry, relaunched with each guess replaced by
its predecessor segment's final carry until the boundaries reach a fixed
point.  T comes from ``costmodel.plan_um_split``.  As in the reference:

  * the access counts need no speculation — every segment's boundary
    counts are the exact prefix ``bincount`` of the pages before it, and
    only real core steps add to them;
  * the frame ring is compared in gauge-canonical form (rotated so the
    hand is at 0, slack and dump slots blanked), which is also the form a
    segment starts from;
  * only real core steps count events, and only the converged round's
    counts are kept, so all four counters equal the T = 1 scan's at every
    T.

The composition and the fixed-point test run on device tensors, one host
sync a round.  The scan runs under the degradation ladder (T > 1 ->
T = 1; an OOM bisects the batch), and an active sweep checkpoint replays
journaled specs.  The reference's last rung, its frozen sequential scan,
is not ported: it would run on the host, not on the card.

With ``repro_torch.obs`` on, each :func:`simulate_um_many` call emits one
``RunRecord`` with its dedupe accounting (lanes requested, run and
deduped; a fully memoized call too) inside ``um_scan`` / ``stitch`` spans.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import _build, obs
from .._device import resolve_device
from ..core import costmodel, tsplit
from ..core.timing import COLUMN_BYTES, UM_PAGE_BYTES, HMSConfig
from ..core.traces import Trace
from ..kernels.um_scan import ops as um_ops
from ..kernels.um_scan import ref as um_ref
from ..resilience import guard as _guard
from ..resilience import sweepckpt as _sweepckpt
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
# cumulative spec lanes the scan ran (``obs.cache_stats()["um_lanes_run"]``)
_LANES_RUN = 0
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


@dataclasses.dataclass(frozen=True)
class _UMKey:
    n: int                  # trace length
    pages_alloc: int        # bucketed page-array allocation
    frames_alloc: int       # bucketed frame-array allocation (batch max)
    chunk_alloc: int        # bucketed migration-chunk lanes (batch max)
    phases: int             # counter segments (1 for unphased traces)
    t_segments: int = 1     # temporal segments (1 = plain sequential scan)
    replay: int = 0         # replay-prefix steps per segment (T>1 only)


def um_group_key(trace: Trace, specs: Sequence[UMSpec],
                 t_segments: int = 1, replay: int = 0) -> _UMKey:
    """The shape a batch of specs shares: allocations are bucketed
    group-wide maxima, T at most the trace length."""
    _, n_pages = _page_stream(trace)
    t_segments = max(1, min(int(t_segments), trace.n))
    return _UMKey(
        n=trace.n,
        pages_alloc=um_ref.bucket(n_pages),
        frames_alloc=um_ref.bucket(max(s.n_frames for s in specs)),
        chunk_alloc=um_ref.bucket(max(s.chunk for s in specs)),
        phases=trace.n_phases,
        t_segments=t_segments,
        replay=replay if t_segments > 1 else 0,
    )


def _fingerprint(key: _UMKey, width: int) -> str:
    """Sentinel/ledger fingerprint of one paging run, in the reference's
    format: the shape plus the batch width.  The drift check, the sentinel
    and the ledger all use it."""
    return (f"um:n{key.n}:P{key.pages_alloc}:F{key.frames_alloc}"
            f":c{key.chunk_alloc}:p{key.phases}"
            f":T{key.t_segments}r{key.replay}:w{width}")


def _um_split_inputs(trace: Trace, key: _UMKey, dev) -> dict:
    """Gathered ``(T, L)`` segment streams for a split run: core steps
    execute their own trace records in order; replay-prefix steps
    re-gather the window just before each boundary; pads clamp to the last
    record and are neither ``real`` nor live.  ``live_warm`` is the
    warm-up round's live mask (replay steps live too)."""
    page, _ = _page_stream(trace)
    pos = np.arange(trace.n, dtype=np.int32).reshape(1, -1)
    sp = tsplit.split_positions(pos, trace.n, key.t_segments, key.replay)
    spos, gpos = sp["spos"][0], sp["gpos"][0]

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    real = to(spos < trace.n)
    xs = {"page": to(page[gpos]),
          "is_write": to(trace.is_write.astype(bool)[gpos]),
          "phase": to(trace.phase_id[gpos].astype(np.int32))
          if trace.n_phases > 1 else None,
          "real": real, "live_warm": real | to(sp["replay"][0])}
    return xs


def _run_um_split(trace: Trace, key: _UMKey, specs: Sequence[UMSpec], dev):
    """Drive the fixed-point stitch for a split UM run (see the module
    docstring): the access counts at each boundary are exact prefix
    bincounts, the residency/dirty/frame carries are chained in
    gauge-canonical form (frame ring rotated to ptr = 0, slack and dump
    slots blanked), one ``um_scan`` launch and one host sync a round, and
    only the converged round's counts are returned.  Returns ``(counts
    float64[specs, 4, phases], rounds)`` with rounds including the replay
    warm-up, or raises ``tsplit.StitchError`` past the round bound."""
    page, n_pages = _page_stream(trace)
    T = key.t_segments
    W = len(specs)
    xs = _um_split_inputs(trace, key, dev)
    core = -(-trace.n // T)
    # every lane's cold state, laid out as the kernel's wrapper wants it
    resident, dirty, frames, ptr, hot = um_ref.initial_state(
        W * T, n_pages, max(s.n_frames for s in specs), dev)
    pa, fa = resident.shape[1] - 1, frames.shape[1] - 1
    hot_seg = np.zeros((T, pa), np.int32)
    for t in range(1, T):
        hot_seg[t, :n_pages] = np.bincount(page[:t * core],
                                           minlength=n_pages)
    hot = torch.from_numpy(hot_seg).to(dev).repeat(W, 1)
    nf = torch.tensor([s.n_frames for s in specs], dtype=torch.int64,
                      device=dev).repeat_interleave(T)[:, None]
    ring = torch.arange(fa, dtype=torch.int64, device=dev)[None, :]
    args = dict(n_phases=trace.n_phases, n_pages=n_pages,
                n_frames=[s.n_frames for s in specs],
                chunk=[s.chunk for s in specs],
                nvlink=[s.nvlink for s in specs],
                hot_thresh=[s.hot_thresh for s in specs])

    def run(g, live):
        counts, st = um_ops.um_scan(xs["page"], xs["is_write"], xs["phase"],
                                    real=xs["real"], live=live,
                                    state=g + (hot,), **args)
        return st, counts

    def advance(g, out):
        res_o, dir_o, fr_o, ptr_o, _ = out
        res_c = res_o.clone()
        res_c[:, n_pages:] = False
        dir_c = dir_o.clone()
        dir_c[:, n_pages:] = False
        # the ring rotated so the hand is at 0 (frames past a spec's own
        # count blanked)
        idx = (ptr_o.to(torch.int64)[:, None] + ring) % nf
        fr_c = torch.full_like(fr_o, -1)
        fr_c[:, :fa] = torch.where(ring < nf, fr_o.gather(1, idx), -1)

        def shift(x, cold):
            # segment t starts from segment t - 1's canonical end state
            x = x.view(W, T, -1)
            return torch.cat([torch.full_like(x[:, :1], cold), x[:, :-1]],
                             dim=1).view(W * T, -1)
        return (shift(res_c, False), shift(dir_c, False), shift(fr_c, -1),
                torch.zeros_like(ptr))

    def equal(a, b):
        # the hand is canonical and the counts pinned exact; the fixed
        # point lives in (resident, dirty, frames)
        return not bool(torch.stack([(a[i] != b[i]).any()
                                     for i in range(3)]).any())

    g, extra = (resident, dirty, frames, ptr), 0
    if key.replay > 0:
        # warm-up round: replay prefixes live purely to improve the first
        # boundary guesses; its counts are never accepted
        out, _ = run(g, xs["live_warm"])
        g = advance(g, out)
        extra = 1
    counts, rounds = tsplit.stitch(lambda gg, _r: run(gg, xs["real"]), g,
                                   advance, equal, max_rounds=T + 1)
    return counts.view(W, T, 4, -1).sum(1), rounds + extra


# What each guarded paging call did (newest last, at most _RUNS_KEPT):
# segments, stitch rounds, the ladder's rung and its events.  Always on;
# with ``repro_torch.obs`` enabled the same values also make the call's
# ledger record.
_RUNS: List[Dict[str, object]] = []
_RUNS_KEPT = 4096


def _lane_counters(r: UMResult) -> Dict[str, np.ndarray]:
    return {"um_faults": r.phase_faults, "um_migrated": r.phase_migrated,
            "um_writebacks": r.phase_writebacks,
            "um_remote_cols": r.phase_remote_cols}


def simulate_um_many(trace: Trace, specs: Sequence[UMSpec], *,
                     device=None) -> List[UMResult]:
    """Run a batch of UM specs over one trace: one ``um_scan`` launch (a
    stitch round) for every spec not already memoized, duplicate specs
    deduped to one lane, T temporal segments a spec from the cost model.
    Specs whose frames cover the whole footprint early-out to zero
    counters without touching the device.  The scan runs under the
    degradation ladder (T > 1 -> T = 1; an OOM on a batch bisects it), and
    an active sweep checkpoint replays journaled specs.  ``device=None``
    runs on the CUDA card (raises if there is none), ``device="cpu"`` runs
    the kernel's plain version.  Results come back in input order; the
    memo is kept per device, so a card run never returns a host result.
    With ``repro_torch.obs`` enabled every call emits one ledger record,
    a fully memoized one too (engine key ``"um:memoized"``)."""
    t_start = time.perf_counter()
    dev = resolve_device(device, "simulate_um_many")
    with costmodel.planning_on(dev):
        return _simulate_um_many(trace, list(specs), dev, t_start)


def _simulate_um_many(trace: Trace, specs: List[UMSpec], dev,
                      t_start: float) -> List[UMResult]:
    global _LANES_RUN
    for s in specs:
        _rvalidate.validate_um_spec(s)
    cache = _RESULT_CACHE.setdefault(trace, {})
    _, n_pages = _page_stream(trace)
    ck = _sweepckpt.active()
    tfp = _sweepckpt.trace_fingerprint(trace) if ck is not None else None

    run: List[UMSpec] = []
    for s in specs:
        if (dev.type, s) in cache or s in run:
            continue
        if s.n_frames >= n_pages:
            z = np.zeros((trace.n_phases,), np.float64)
            cache[(dev.type, s)] = UMResult(s, z, z.copy(), z.copy(),
                                            z.copy())
            continue
        hit = ck.get_um(tfp, s) if ck is not None else None
        if hit is not None:
            cache[(dev.type, s)] = UMResult(
                s, hit["um_faults"], hit["um_migrated"],
                hit["um_writebacks"], hit["um_remote_cols"])
        else:
            run.append(s)

    used = outcome = plan = rounds = None
    compiled = False
    if run:
        plan = costmodel.plan_um_split(trace.n, len(run))
        replay = tsplit.replay_prefix() if plan.t_segments > 1 else 0
        key = um_group_key(trace, run, plan.t_segments, replay)

        def attempt(k: _UMKey):
            def thunk():
                # the span's exit waits for the stream (sync=dev), so its
                # wall covers the kernel whatever the body ends in
                with obs.span("um_scan", sync=dev, engine="um",
                              lanes=len(run), trace=trace.name):
                    if k.t_segments > 1:
                        with obs.span("stitch", sync=dev, engine="um",
                                      segments=k.t_segments,
                                      replay=k.replay):
                            counts, rounds = _run_um_split(trace, k, run,
                                                           dev)
                    else:
                        counts, _ = um_ops.um_scan(
                            **scan_args(trace, run, dev))
                        rounds = 1
                    return counts.cpu().numpy(), rounds, k
            return thunk

        def bisect():
            # OOM relief: the halves run as their own guarded batches and
            # land in the result cache; restack the lanes from there
            h = len(run) // 2
            simulate_um_many(trace, run[:h], device=dev)
            simulate_um_many(trace, run[h:], device=dev)
            C = np.stack([np.stack([getattr(cache[(dev.type, s)], f)
                                    for f in _FIELDS]) for s in run])
            return C, 0, key

        rungs = [(f"T{key.t_segments}", attempt(key))]
        if key.t_segments > 1:
            rungs.append(("T1", attempt(dataclasses.replace(
                key, t_segments=1, replay=0))))
        epoch = _build.library_epoch()
        t0 = time.perf_counter()
        (C, rounds, used), outcome = _guard.run_ladder(
            "um", rungs, bisect=bisect if len(run) > 1 else None)
        wall = time.perf_counter() - t0
        compiled = (outcome.rung != "bisect"
                    and _build.library_epoch() != epoch)
        fp = _fingerprint(used, len(run))
        # (a bisected batch's halves are runs of their own; its own entry
        # carries the OOM event and no rounds)
        _RUNS.append({"trace": trace.name, "lanes": len(run),
                      "engine_key": fp, "t_segments": used.t_segments,
                      "replay": used.replay, "rounds": rounds,
                      "rung": outcome.rung, "events": outcome.events,
                      "compiled": compiled, "wall_s": wall})
        del _RUNS[:-_RUNS_KEPT]
        if outcome.rung != "bisect":
            obs.engine_run(fp, compiled)
            if used.t_segments == plan.t_segments:
                costmodel.check_plan_drift(fp, plan.predicted_us, wall,
                                           compiled)
        _LANES_RUN += len(run)
        for j, s in enumerate(run):
            cache[(dev.type, s)] = UMResult(s, *(C[j, k].copy()
                                                 for k in range(4)))
            if ck is not None:
                ck.put_um(tfp, s, cache[(dev.type, s)])
    out = [cache[(dev.type, s)] for s in specs]
    if obs.enabled():
        lanes = [_lane_counters(r) for r in out]
        obs.record(obs.RunRecord(
            entry="simulate_um_many", engine="um", trace=trace.name,
            n=trace.n, phases=trace.n_phases,
            engine_key=(_fingerprint(used, len(run)) if used is not None
                        else "um:memoized"),
            compiled=compiled, wall_s=time.perf_counter() - t_start,
            batch=len(run), counter_digest=obs.counter_digest(lanes),
            t_segments=used.t_segments if used is not None else None,
            stitch_rounds=rounds,
            replay_prefix=used.replay if used is not None else None,
            um_lanes_requested=len(specs), um_lanes_run=len(run),
            um_lanes_deduped=len(specs) - len(run),
            trace_fp=_sweepckpt.trace_fingerprint(trace),
            config_digests=[_sweepckpt.um_spec_key(r.spec) for r in out],
            counters=[_sweepckpt.encode_counters(c) for c in lanes],
            ladder_rung=outcome.rung if outcome is not None else None,
            retries=outcome.retries if outcome is not None else None,
            degradations=(outcome.events or None)
            if outcome is not None else None,
            plan_predicted_us=plan.predicted_us
            if plan is not None else None,
            plan_alternatives=list(plan.alternatives) or None
            if plan is not None else None,
            calib_fingerprint=costmodel.active_profile().fingerprint,
            host={**obs.host_metadata(), "device": dev.type},
            **obs.git_info()))
    return out


_FIELDS = ("phase_faults", "phase_migrated", "phase_writebacks",
           "phase_remote_cols")


def simulate_um(trace: Trace, cfg: HMSConfig, nvlink: bool = False, *,
                device=None) -> UMResult:
    """Single-config convenience wrapper: derives the :class:`UMSpec` from
    ``cfg`` and runs it through the batched path (memoized per trace)."""
    return simulate_um_many(trace, [um_spec(cfg, nvlink)], device=device)[0]
