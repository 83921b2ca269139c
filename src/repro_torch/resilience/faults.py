"""Deterministic fault injection for the degradation ladder (a port of the
reference package's ``repro.resilience.faults``).

Every guarded engine attempt calls :func:`on_call`, which advances a
global ordinal and raises the armed failure class when its ordinal comes
up — so ``REPRO_FAULTS="oom@3,stitch@7"`` makes the 3rd guarded call in
the process OOM and the 7th fail its stitch, bit-reproducibly, with zero
cost when nothing is armed.  Each spec fires exactly once.

Kinds:

========  ==============================================================
``oom``       :class:`InjectedFault` the classifier maps to the
              out-of-memory handling (retry / bisect / degrade)
``deadline``  :class:`InjectedFault` mapping to compile-deadline handling
``stitch``    a real :class:`repro_torch.core.tsplit.StitchError`
``nan``       corrupts one counter of the call's *result* to NaN (the
              post-scan finite check must catch it and degrade)
``kill``      :class:`KeyboardInterrupt` — a deterministic Ctrl-C, used
              by the kill-and-resume CI step (BaseException: it passes
              through the ladder untouched)
========  ==============================================================

Arm via the ``REPRO_FAULTS`` env knob at import, :func:`arm`, or the
:func:`inject` context manager (which zeroes the ordinal counter on entry
so test specs are call-relative and restores everything on exit).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Iterator, List, Optional

import numpy as np

KINDS = ("oom", "deadline", "stitch", "nan", "kill")


class InjectedFault(RuntimeError):
    """An injected engine failure (``kind`` in :data:`KINDS`)."""

    def __init__(self, kind: str, site: str, seq: int):
        self.kind = kind
        self.site = site
        self.seq = seq
        super().__init__(
            f"injected {kind} fault at guarded call #{seq} (site={site})")


@dataclasses.dataclass
class FaultSpec:
    kind: str
    at: int                 # 1-based guarded-call ordinal
    fired: bool = False


_SPECS: List[FaultSpec] = []
_CALLS = 0
_LOCK = threading.Lock()


def parse(text: str) -> List[FaultSpec]:
    """Parse a ``"kind@N,kind@N"`` spec string."""
    out: List[FaultSpec] = []
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        try:
            kind, at = item.split("@")
            spec = FaultSpec(kind=kind.strip(), at=int(at))
        except ValueError:
            raise ValueError(
                f"bad REPRO_FAULTS entry {item!r}: expected kind@N, "
                f"e.g. oom@3") from None
        if spec.kind not in KINDS:
            raise ValueError(
                f"bad REPRO_FAULTS kind {spec.kind!r}: expected one of "
                + ", ".join(KINDS))
        if spec.at < 1:
            raise ValueError(
                f"bad REPRO_FAULTS ordinal {spec.at}: calls count from 1")
        out.append(spec)
    return out


def arm(text: str, reset_calls: bool = True) -> List[FaultSpec]:
    """Arm the spec string process-wide; returns the parsed specs."""
    global _CALLS
    specs = parse(text)
    with _LOCK:
        _SPECS[:] = specs
        if reset_calls:
            _CALLS = 0
    return specs


def clear() -> None:
    """Disarm everything and zero the ordinal counter."""
    global _CALLS
    with _LOCK:
        _SPECS.clear()
        _CALLS = 0


def active() -> bool:
    return bool(_SPECS)


def calls() -> int:
    """Guarded-call ordinal so far (diagnostics / tests)."""
    return _CALLS


def pending() -> List[FaultSpec]:
    """Armed specs that have not fired yet."""
    return [s for s in _SPECS if not s.fired]


@contextlib.contextmanager
def inject(text: str) -> Iterator[List[FaultSpec]]:
    """Arm ``text`` with a fresh (zeroed) call counter; restore the prior
    specs and counter on exit.  ``with faults.inject("stitch@1"): ...``"""
    global _CALLS
    with _LOCK:
        saved_specs = list(_SPECS)
        saved_calls = _CALLS
    specs = arm(text, reset_calls=True)
    try:
        yield specs
    finally:
        with _LOCK:
            _SPECS[:] = saved_specs
            _CALLS = saved_calls


def on_call(site: str) -> int:
    """Advance the guarded-call ordinal; raise any armed failure whose
    ordinal this is.  Returns the ordinal (for :func:`corrupt`)."""
    global _CALLS
    with _LOCK:
        _CALLS += 1
        seq = _CALLS
        due = [s for s in _SPECS if not s.fired and s.at == seq
               and s.kind != "nan"]
        for s in due:
            s.fired = True
    for s in due:
        if s.kind == "kill":
            raise KeyboardInterrupt(
                f"injected kill at guarded call #{seq} (site={site})")
        if s.kind == "stitch":
            from ..core import tsplit
            raise tsplit.StitchError(
                f"injected stitch fault at guarded call #{seq} "
                f"(site={site})")
        raise InjectedFault(s.kind, site, seq)
    return seq


def corrupt(site: str, seq: int, out) -> None:
    """Post-call hook: if a ``nan`` fault is armed for ordinal ``seq``,
    poison one counter of ``out`` (the first key of the first counter
    dict found) so the guard's finite check trips."""
    with _LOCK:
        due = [s for s in _SPECS if not s.fired and s.at == seq
               and s.kind == "nan"]
        for s in due:
            s.fired = True
    if not due:
        return
    d = _find_counter_dict(out)
    if d is not None:
        k = sorted(d)[0]
        d[k] = np.asarray(d[k], np.float64) * np.nan


def _find_counter_dict(obj):
    if isinstance(obj, dict):
        if obj and all(isinstance(k, str) for k in obj):
            return obj
        return None
    if isinstance(obj, (tuple, list)):
        for el in obj:
            d = _find_counter_dict(el)
            if d is not None:
                return d
    return None


_env = os.environ.get("REPRO_FAULTS")
if _env:
    arm(_env)
del _env
