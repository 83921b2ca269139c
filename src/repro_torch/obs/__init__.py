"""Engine telemetry: run ledger, span tracer and retrace sentinel (a port of
the reference package's ``repro.obs``, with its facade).

* **Run ledger** (:mod:`.ledger`) — every guarded ``simulate`` /
  ``simulate_many`` / ``simulate_um_many`` engine execution emits a
  schema-4 :class:`RunRecord` (engine-key fingerprint, compile-vs-warm
  flag, shard plan, batch width, UM dedupe accounting, wall time, a
  bit-exact counter digest, git SHA, host metadata naming the card and the
  call's device).  Off by default; ``enable(path)`` or the
  ``REPRO_OBS_DIR`` env var streams records to JSONL.  The records are the
  reference's, so either package's ``load_ledger`` and design-space store
  (:mod:`.store`) read the other's ledgers.
* **Span tracer** (:mod:`.spans`) — ``span("preprocess")`` etc. through
  the engines, exportable to Chrome/Perfetto trace-event JSON via
  :func:`export_trace`.  A span that brackets kernel launches ends only
  after that device work is done.
* **Retrace sentinel** (:mod:`.sentinel`) — ``cache_stats()`` /
  ``reset()`` / ``assert_no_retrace()``: a warm engine must never build
  or load the kernel library again.

The package imports nothing from ``repro_torch.core`` / ``repro_torch.um``
at module level (the engines import *us*); sentinel and calibration reach
into them lazily at call time.  It imports no JAX and nothing of the JAX
package.
"""

from __future__ import annotations

import os as _os

from .hostinfo import git_info, host_metadata
from .ledger import (
    RunRecord,
    clear_records,
    compile_split,
    counter_digest,
    disable as _ledger_disable,
    enable as _ledger_enable,
    enabled,
    ledger_path,
    load_ledger,
    obs_dir,
    record,
    records,
)
from .sentinel import (
    RetraceError,
    assert_no_retrace,
    cache_stats,
    engine_run,
    engine_runs,
    reset,
)
from .spans import clear_events, events, export_trace, span, totals
from .spans import set_enabled as _spans_set_enabled


def enable(path=None) -> None:
    """Turn the ledger *and* span collection on (``path``: directory,
    ``*.jsonl`` file, or None for in-memory only)."""
    _ledger_enable(path)
    _spans_set_enabled(True)


def disable() -> None:
    """Stop collecting records and spans (already-collected data stays
    until :func:`clear_records` / :func:`clear_events`)."""
    _ledger_disable()
    _spans_set_enabled(False)


def calibration() -> dict:
    """The cost-model calibration state behind the planner right now:
    mode (``off`` / ``auto`` / ``force``), this host's fingerprint, and
    the active profile's identity + constants (see
    ``repro_torch.core.calibrate``).  Lazy import — the facade stays free
    of module-level ``repro_torch.core`` dependencies."""
    import dataclasses as _dc

    from ..core import calibrate as _calibrate
    from ..core import costmodel as _costmodel

    profile = _costmodel.active_profile()
    return {
        "mode": _costmodel.calib_mode(),
        "host_fingerprint": _calibrate.host_fingerprint(),
        "calib_dir": _calibrate.calib_dir(),
        "profile": _dc.asdict(profile),
    }


# REPRO_OBS_DIR in the environment enables streaming for the whole process.
_env_dir = _os.environ.get("REPRO_OBS_DIR")
if _env_dir:
    enable(_env_dir)
del _env_dir

__all__ = [
    # ledger
    "RunRecord", "enable", "disable", "enabled", "record", "records",
    "clear_records", "load_ledger", "ledger_path", "obs_dir",
    "counter_digest", "compile_split",
    # spans
    "span", "events", "clear_events", "export_trace", "totals",
    # sentinel
    "cache_stats", "reset", "assert_no_retrace", "RetraceError",
    "engine_run", "engine_runs",
    # identity
    "host_metadata", "git_info", "calibration",
]
