"""The port's resilience layer (``repro.resilience`` in the reference):
validated inputs, the guarded-execution degradation ladder, deterministic
fault injection and resumable sweep checkpoints.

``validate``
    Structured :class:`ValidationError` (field path + fix hint) for
    configs, traces, scenarios and UM specs, checked at every engine entry
    before anything reaches the device.
``guard``
    :func:`~repro_torch.resilience.guard.run_ladder` wraps every engine
    invocation, classifies failures (CUDA out of memory,
    :class:`~repro_torch.core.tsplit.StitchError`, non-finite counters)
    and walks the ladder: bisect the config batch on OOM, step (S, T) ->
    (S, 1) -> (1, 1).  The ladder ends there: no rung falls back to the
    CPU or to a plain version on the card.
``faults``
    ``REPRO_FAULTS="oom@3,stitch@7"`` (or the
    :func:`~repro_torch.resilience.faults.inject` context manager) raises
    each failure class at the Nth guarded engine call; counters stay
    bit-exact under every injected fault.
``sweepckpt``
    Completed per-config results journaled to ``REPRO_SWEEP_CKPT`` (JSONL)
    keyed by (trace fingerprint, config digest) — the reference's strings,
    so journals interoperate — so a killed ``simulate_many`` resumes where
    it stopped.

No module here imports ``repro_torch.core`` at module level.
"""

from . import faults, guard, sweepckpt, validate
from .faults import InjectedFault, inject
from .guard import (
    CounterInvalidError,
    LadderOutcome,
    ResilienceError,
    check_finite,
    classify_failure,
    guarded_call,
    run_ladder,
)
from .sweepckpt import SweepCheckpoint, config_digest, trace_fingerprint
from .validate import (
    EngineInvariantError,
    ResilienceWarning,
    ValidationError,
    check_hms_packing,
    unknown_policy_error,
    validate_config,
    validate_scenario,
    validate_trace,
    validate_um_spec,
)

__all__ = [
    "faults", "guard", "sweepckpt", "validate",
    "InjectedFault", "inject",
    "CounterInvalidError", "LadderOutcome", "ResilienceError",
    "check_finite", "classify_failure", "guarded_call", "run_ladder",
    "SweepCheckpoint", "config_digest", "trace_fingerprint",
    "EngineInvariantError", "ResilienceWarning", "ValidationError",
    "check_hms_packing", "unknown_policy_error",
    "validate_config", "validate_scenario", "validate_trace",
    "validate_um_spec",
]
