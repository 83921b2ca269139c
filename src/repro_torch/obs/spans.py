"""Span tracer: nested, thread-aware timing spans exportable to the
Chrome/Perfetto trace-event format (a port of the reference package's
``repro.obs.spans``).

``span(name, **args)`` returns a context manager.  When observability is
disabled it returns a shared no-op object (no allocation, no clock reads,
no synchronize), so instrumented hot paths cost one truthiness check.
When enabled, each span records wall-clock begin/duration
(``perf_counter_ns``) plus the thread id; nesting falls out of the
complete-event ("ph": "X") encoding — Perfetto reconstructs the stack from
containment per thread.

Device work: in the reference a span's wall includes the XLA work it
brackets, because the host copy inside it waits for the device.  Kernel
launches return at once, so a span that brackets them and does not end in
a host copy is opened with ``sync=<device>``: on a CUDA device its exit
synchronizes that device's current stream before the clock is read — only
while spans are enabled.

Export with :func:`export_trace`; load the JSON at https://ui.perfetto.dev
or chrome://tracing.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

_ENABLED = False
_EVENTS: List[tuple] = []        # (name, t0_ns, dur_ns, tid, args)
_LOCK = threading.Lock()


class _NullSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "t0", "sync")

    def __init__(self, name: str, args: Dict[str, object], sync):
        self.name = name
        self.args = args
        self.sync = sync

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.sync is not None and self.sync.type == "cuda":
            import torch
            torch.cuda.current_stream(self.sync).synchronize()
        dur = time.perf_counter_ns() - self.t0
        with _LOCK:
            _EVENTS.append((self.name, self.t0, dur,
                            threading.get_ident(), self.args))
        return False


def span(name: str, sync=None, **args):
    """Open a timing span: ``with obs.span("scan", policy="hms"): ...``.
    ``sync`` (a ``torch.device``) makes the exit wait for that device's
    current stream when it is a CUDA device.  No-op (shared singleton)
    while observability is disabled."""
    if not _ENABLED:
        return _NULL
    return _Span(name, args, sync)


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def events() -> List[tuple]:
    with _LOCK:
        return list(_EVENTS)


def clear_events() -> None:
    with _LOCK:
        _EVENTS.clear()


def totals(evs: Optional[List[tuple]] = None) -> Dict[str, Dict[str, float]]:
    """Per-name ``{"count", "total_ms"}`` over collected spans (nested
    spans count in their parents too)."""
    out: Dict[str, Dict[str, float]] = {}
    for name, _, dur, _, _ in (events() if evs is None else evs):
        d = out.setdefault(name, {"count": 0, "total_ms": 0.0})
        d["count"] += 1
        d["total_ms"] += dur / 1e6
    return out


def export_trace(path: str, *, clear: bool = False) -> str:
    """Write collected spans as Chrome trace-event JSON (complete events,
    microsecond timestamps).  Returns the written path.  ``clear`` drops
    the event buffer after a successful write."""
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    pid = os.getpid()
    with _LOCK:
        evs = list(_EVENTS)
    trace_events = [{
        "name": name,
        "ph": "X",
        "ts": t0 / 1e3,             # ns -> us
        "dur": dur / 1e3,
        "pid": pid,
        "tid": tid % 2**31,
        "args": args,
    } for name, t0, dur, tid, args in evs]
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": trace_events,
                   "displayTimeUnit": "ms"}, f)
    if clear:
        clear_events()
    return path
