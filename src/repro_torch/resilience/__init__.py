"""Input validation for the port's simulation engine (a subset of the
reference package's resilience layer: what ``simulate`` reaches)."""

from .validate import (EngineInvariantError, ResilienceWarning,
                       ValidationError, check_hms_packing,
                       unknown_policy_error, validate_config, validate_trace,
                       validate_um_spec)

__all__ = [
    "EngineInvariantError", "ResilienceWarning", "ValidationError",
    "check_hms_packing", "unknown_policy_error", "validate_config",
    "validate_trace", "validate_um_spec",
]
