"""Guarded engine execution: failure classification + degradation ladder
(a port of the reference package's ``repro.resilience.guard``).

:func:`run_ladder` wraps an ordered list of *rungs* — named thunks that
each produce the same bit-exact counters through a different execution
shape (the planned (S, T), then (S, 1), then (1, 1)).  A classified
failure on one rung retries (OOM / deadline, bounded by ``REPRO_RETRY``
with exponential backoff), bisects (batch OOM, when the caller supplies a
``bisect`` thunk), or descends to the next rung; unclassified exceptions
propagate untouched, and :class:`KeyboardInterrupt` always passes through
(only :class:`Exception` is caught).  Every step is recorded as a
structured degradation event on the returned :class:`LadderOutcome`.

Unlike the reference, whose last rung is its frozen seed engine, the
port's ladders stop at (1, 1): every rung is the kernel on the card (or,
with ``device="cpu"``, its plain version), never a hidden fallback, and
an exhausted ladder raises :class:`ResilienceError`.

Because every rung reproduces the sequential scan exactly (the engines'
standing parity guarantee), a degraded run's counters are bit-identical
to the unfaulted run — the fault-injection battery asserts precisely
that, digest-for-digest.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import faults

#: Failure kinds worth retrying on the same rung (transient pressure);
#: stitch divergence and counter corruption are deterministic, so they
#: descend immediately.
RETRYABLE = ("oom", "deadline")

DEFAULT_RETRIES = 1
_BACKOFF_S = 0.05       # base backoff; tests may zero it


class CounterInvalidError(RuntimeError):
    """A non-finite value in post-scan counters."""


class ResilienceError(RuntimeError):
    """Every rung of the degradation ladder failed."""

    def __init__(self, site: str, events: List[Dict[str, Any]]):
        self.site = site
        self.events = events
        steps = "; ".join(f"{e['rung']}:{e['kind']}" for e in events)
        super().__init__(
            f"degradation ladder exhausted at {site} ({steps}) — the "
            "chained exception is the last rung's failure")


@dataclasses.dataclass
class LadderOutcome:
    """How one guarded invocation concluded."""

    rung: str                       # rung name that produced the result
    rung_index: int
    retries: int                    # same-rung retries spent in total
    events: List[Dict[str, Any]]    # structured degradation events


def max_retries() -> int:
    """Per-rung retry budget for retryable kinds (``REPRO_RETRY``)."""
    try:
        return max(0, int(os.environ.get("REPRO_RETRY", DEFAULT_RETRIES)))
    except ValueError:
        return DEFAULT_RETRIES


def classify_failure(exc: BaseException) -> Optional[str]:
    """Map an exception to a failure kind the ladder handles, or ``None``
    (propagate untouched).  Kinds: ``oom``, ``deadline``, ``stitch``,
    ``nan``.  ``torch.cuda.OutOfMemoryError`` and a CUDA "out of memory"
    ``RuntimeError`` are ``oom``; a failed kernel build, a launch error or
    a kernel's ``ValueError`` classify as nothing and are raised."""
    import torch

    from ..core import tsplit
    if isinstance(exc, faults.InjectedFault):
        return exc.kind
    if isinstance(exc, tsplit.StitchError):
        return "stitch"
    if isinstance(exc, (CounterInvalidError, FloatingPointError)):
        return "nan"
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return "oom"
    if isinstance(exc, TimeoutError):
        return "deadline"
    # the caching allocator's message, and the reference's status text
    if isinstance(exc, RuntimeError):
        msg = str(exc).upper()
        if "RESOURCE_EXHAUSTED" in msg or "OUT OF MEMORY" in msg \
                or ("ALLOCAT" in msg and "FAIL" in msg):
            return "oom"
        if "DEADLINE_EXCEEDED" in msg or "DEADLINE EXCEEDED" in msg:
            return "deadline"
    return None


def _find_nonfinite(obj, path: str = "") -> Optional[str]:
    if isinstance(obj, dict):
        for k in obj:
            r = _find_nonfinite(obj[k], f"{path}.{k}" if path else str(k))
            if r is not None:
                return r
    elif isinstance(obj, (tuple, list)):
        for i, el in enumerate(obj):
            r = _find_nonfinite(el, f"{path}[{i}]")
            if r is not None:
                return r
    elif isinstance(obj, (int, float, np.ndarray, np.generic)):
        a = np.asarray(obj)
        if a.dtype.kind == "f" and not np.all(np.isfinite(a)):
            return path or "<value>"
    return None


def check_finite(out, site: str = "engine") -> None:
    """Raise :class:`CounterInvalidError` if any float in ``out`` (dicts /
    tuples of counters walked recursively) is NaN or infinite."""
    bad = _find_nonfinite(out)
    if bad is not None:
        raise CounterInvalidError(
            f"{site}: non-finite value in post-scan counter {bad!r}")


def _event(site: str, kind: str, rung: str, attempt: int, action: str,
           exc: BaseException) -> Dict[str, Any]:
    return {
        "site": site,
        "kind": kind,
        "rung": rung,
        "attempt": attempt,
        "action": action,               # retry | bisect | degrade
        "error": f"{type(exc).__name__}: {exc}"[:200],
    }


def run_ladder(site: str,
               rungs: Sequence[Tuple[str, Callable[[], Any]]],
               bisect: Optional[Callable[[], Any]] = None,
               retries: Optional[int] = None,
               ) -> Tuple[Any, LadderOutcome]:
    """Run ``rungs`` in order until one succeeds.

    Each attempt passes through :func:`faults.on_call` (so injected
    failures classify exactly like real ones), then the post-call hooks:
    :func:`faults.corrupt` and :func:`check_finite`.  OOM on a batch with
    a ``bisect`` thunk hands the whole call to ``bisect()`` (which is
    expected to recurse through guarded halves).  Returns
    ``(result, LadderOutcome)``; raises :class:`ResilienceError` chaining
    the last failure when every rung is exhausted."""
    budget = max_retries() if retries is None else max(0, int(retries))
    events: List[Dict[str, Any]] = []
    total_retries = 0
    last_exc: Optional[BaseException] = None
    for ri, (name, thunk) in enumerate(rungs):
        attempt = 0
        while True:
            try:
                seq = faults.on_call(site)
                out = thunk()
                faults.corrupt(site, seq, out)
                check_finite(out, site=site)
                return out, LadderOutcome(
                    rung=name, rung_index=ri, retries=total_retries,
                    events=events)
            except Exception as exc:
                kind = classify_failure(exc)
                if kind is None:
                    raise
                last_exc = exc
                if kind == "oom" and bisect is not None:
                    events.append(
                        _event(site, kind, name, attempt, "bisect", exc))
                    out = bisect()
                    return out, LadderOutcome(
                        rung="bisect", rung_index=ri,
                        retries=total_retries, events=events)
                if kind in RETRYABLE and attempt < budget:
                    events.append(
                        _event(site, kind, name, attempt, "retry", exc))
                    total_retries += 1
                    attempt += 1
                    if _BACKOFF_S > 0:
                        time.sleep(min(_BACKOFF_S * (2 ** (attempt - 1)),
                                       1.0))
                    continue
                events.append(
                    _event(site, kind, name, attempt, "degrade", exc))
                break
    raise ResilienceError(site, events) from last_exc


def guarded_call(site: str, thunk: Callable[[], Any],
                 bisect: Optional[Callable[[], Any]] = None,
                 retries: Optional[int] = None,
                 ) -> Tuple[Any, LadderOutcome]:
    """Single-rung convenience wrapper over :func:`run_ladder`."""
    return run_ladder(site, [("primary", thunk)], bisect=bisect,
                      retries=retries)
