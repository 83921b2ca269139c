"""Retrace sentinel: one facade over the engines' compile accounting (a port
of the reference package's ``repro.obs.sentinel``).

The port has no jit cache.  Its unit of "compile" is the building or
loading of the kernel library (``repro_torch._build.library``): every
guarded engine execution reports here via :func:`engine_run` with a
*fingerprint* — the static engine key plus the batch width, in the
reference's format — and whether the library was built or loaded during
that call.  On the CPU it never is.  The accounting is always on (two dict
operations per engine call), so the sentinel works with the ledger
disabled.

:func:`assert_no_retrace` is the public invariant: inside the block, no
fingerprint that was already warm at entry may build or load the library
again.  Fresh fingerprints pass; a warm engine whose library went missing
(dropped behind the sentinel's back) raises :class:`RetraceError` with the
offending fingerprints.

:func:`reset` is the one blessed way to throw engine state away (it also
forgets the matching run history, so deliberate cold re-timing inside an
``assert_no_retrace`` block does not false-positive).
"""

from __future__ import annotations

from typing import Dict, List, Optional


class RetraceError(AssertionError):
    """A warm engine re-compiled inside an ``assert_no_retrace`` block."""


class _Stat:
    __slots__ = ("runs", "compiles")

    def __init__(self):
        self.runs = 0
        self.compiles = 0


_RUNS: Dict[str, _Stat] = {}
# snapshots of the open assert_no_retrace blocks (reset forgets in them too)
_OPEN: List[Dict[str, int]] = []


def engine_run(fingerprint: str, compiled: bool) -> None:
    """Account one engine execution (called by the engines themselves)."""
    s = _RUNS.get(fingerprint)
    if s is None:
        s = _RUNS[fingerprint] = _Stat()
    s.runs += 1
    if compiled:
        s.compiles += 1


def engine_runs() -> Dict[str, Dict[str, int]]:
    """Per-fingerprint run/compile counts since the last :func:`reset`."""
    return {fp: {"runs": s.runs, "compiles": s.compiles}
            for fp, s in _RUNS.items()}


def _forget(prefix: str) -> None:
    for fp in [fp for fp in _RUNS if fp.startswith(prefix)]:
        del _RUNS[fp]
    # an open block forgets them as well: they are cold again, whatever
    # their compile count was when it opened
    for snap in _OPEN:
        for fp in [fp for fp in snap if fp.startswith(prefix)]:
            del snap[fp]


def cache_stats() -> Dict[str, int]:
    """One view over the engines' caches and the run accounting:

    ``um_results_cached``                      memoized UM results (all traces)
    ``um_lanes_run``                           cumulative engine lanes executed
    ``engine_runs`` / ``engine_compiles``      sentinel totals since reset()
    ``kernel_builds`` / ``kernel_loads``       nvcc builds / loads of the
                                               kernel library (process)
    ``<kernel>_launches``                      launches each wrapper counted
                                               (``_build.launches``)
    """
    from .. import _build
    from ..um import engine as _um

    stats = {
        "um_results_cached": sum(len(d) for d in
                                 _um._RESULT_CACHE.values()),
        "um_lanes_run": _um._LANES_RUN,
        "engine_runs": sum(s.runs for s in _RUNS.values()),
        "engine_compiles": sum(s.compiles for s in _RUNS.values()),
        "kernel_builds": _build.library_counts["builds"],
        "kernel_loads": _build.library_counts["loads"],
    }
    for name, n in sorted(_build.launches.items()):
        stats[f"{name}_launches"] = n
    return stats


def reset(*, hms: bool = True, um: bool = True,
          keep_compiled: bool = False) -> None:
    """Throw engine state away, on purpose.

    ``keep_compiled=True`` drops only memoized results (the UM per-trace
    result cache) and keeps the kernel library.  Otherwise the matching
    sentinel history goes too, and — when both engines are reset, since
    they share it — the loaded kernel library, so the load that follows is
    *expected* and ``assert_no_retrace`` stays quiet.  ``hms=False`` /
    ``um=False`` scope the reset to one engine.
    """
    from .. import _build
    from ..um import engine as _um

    if um:
        _um._RESULT_CACHE.clear()
        if not keep_compiled:
            _forget("um:")
    if hms and not keep_compiled:
        _forget("hms:")
    if hms and um and not keep_compiled:
        _build.unload()


class assert_no_retrace:
    """Context manager asserting no warm engine recompiles inside the block.

    Fingerprints first seen inside the block may compile (a cold run may
    load the library); fingerprints that had already run before entry must
    find it loaded.  Use :func:`reset` for deliberate invalidation — it
    forgets the history this check compares against.
    """

    def __enter__(self) -> "assert_no_retrace":
        self._snap = {fp: s.compiles for fp, s in _RUNS.items()}
        _OPEN.append(self._snap)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _OPEN[:] = [s for s in _OPEN if s is not self._snap]
        if exc_type is not None:
            return False
        bad: List[str] = []
        for fp, compiles in self._snap.items():
            s = _RUNS.get(fp)
            if s is not None and s.compiles > compiles:
                bad.append(f"{fp} (+{s.compiles - compiles})")
        if bad:
            raise RetraceError(
                "engines recompiled while warm: " + "; ".join(sorted(bad)))
        return False

    # convenience: how many compile events (warm or cold) the block saw
    def compiles_during(self) -> Optional[int]:
        total = sum(s.compiles for s in _RUNS.values())
        return total - sum(self._snap.values())
