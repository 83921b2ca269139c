"""Structured input validation for the simulation engine.

Every check raises :class:`ValidationError` — a :class:`ValueError`
carrying the offending *field path*, the value seen, what was expected,
and an actionable fix hint.  Unlike asserts, the checks survive
``python -O``, and they run at engine entry before any kernel is built or
launched.

All ``repro_torch.core`` imports are lazy (function-local): this module
loads from either side of the engine <-> resilience seam in any order.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Optional

import numpy as np


class ValidationError(ValueError):
    """A rejected engine input, with enough context to fix it.

    Attributes: ``field`` (dotted path, e.g. ``"HMSConfig.policy"``),
    ``got`` (the offending value), ``expect`` (what would be accepted)
    and ``hint`` (how to fix it).
    """

    def __init__(self, field: str, got, expect: str, hint: str = ""):
        self.field = field
        self.got = got
        self.expect = expect
        self.hint = hint
        msg = f"{field} = {got!r}: expected {expect}"
        if hint:
            msg += f" (fix: {hint})"
        super().__init__(msg)


class EngineInvariantError(ValidationError):
    """A packed-state-layout invariant the scan kernel relies on (tag /
    affinity-level / CTC row-group bit fields) would overflow for this
    (trace, config) pair."""


class ResilienceWarning(UserWarning):
    """Surfaced (not fatal) input surprises, e.g. heavy silent rounding
    of the CTC set count."""


def _fail(field: str, got, expect: str, hint: str = "") -> None:
    raise ValidationError(field, got, expect, hint)


# ---------------------------------------------------------------------------
# HMSConfig.
# ---------------------------------------------------------------------------

def policy_expectation() -> str:
    """The actionable "valid policies" clause used by every unknown-policy
    error (engine dispatch included)."""
    from repro_torch.core import timing
    return "one of " + ", ".join(repr(p) for p in timing.POLICIES)


def unknown_policy_error(policy) -> ValidationError:
    """The error the engine raises when dispatching an unknown policy."""
    return ValidationError(
        "HMSConfig.policy", policy, policy_expectation(),
        "see the HMSConfig docstring for what each policy models")


@functools.lru_cache(maxsize=4096)
def _validate_config_cached(cfg):
    from repro_torch.core import timing

    def chk(cond: bool, field: str, got, expect: str, hint: str = ""):
        if not cond:
            _fail(f"HMSConfig.{field}", got, expect, hint)

    chk(cfg.organization in timing.ORGANIZATIONS, "organization",
        cfg.organization,
        "one of " + ", ".join(repr(o) for o in timing.ORGANIZATIONS))
    if cfg.policy not in timing.POLICIES:
        raise unknown_policy_error(cfg.policy)
    chk(cfg.tag_layout in timing.TAG_LAYOUTS, "tag_layout", cfg.tag_layout,
        "one of " + ", ".join(repr(t) for t in timing.TAG_LAYOUTS))
    chk(cfg.scm_mode == "auto" or cfg.scm_mode in timing.SCM_MODES,
        "scm_mode", cfg.scm_mode,
        "one of " + ", ".join(repr(m) for m in timing.SCM_MODES) + ", 'auto'")
    chk(cfg.line_bytes in timing.LINE_BYTES_CHOICES, "line_bytes",
        cfg.line_bytes,
        "one of " + ", ".join(str(b) for b in timing.LINE_BYTES_CHOICES))
    chk(timing.ROW_BYTES % cfg.line_bytes == 0, "line_bytes", cfg.line_bytes,
        f"a divisor of the {timing.ROW_BYTES} B DRAM row")

    chk(isinstance(cfg.footprint, (int, np.integer))
        and not isinstance(cfg.footprint, bool) and cfg.footprint > 0,
        "footprint", cfg.footprint, "a positive byte count",
        "pass the workload footprint in bytes, e.g. 64 << 20")
    chk(math.isfinite(cfg.r_hbm) and cfg.r_hbm > 0, "r_hbm", cfg.r_hbm,
        "a positive finite ratio (HBM capacity / footprint)",
        "r_hbm > 1 models under-subscription; 0 would give zero capacity")
    chk(0.0 <= cfg.dram_ratio <= 1.0, "dram_ratio", cfg.dram_ratio,
        "a fraction in [0, 1] of stack dies that stay DRAM")

    chk(cfg.channels >= 1, "channels", cfg.channels, "at least 1 channel")
    chk(cfg.banks_per_channel >= 1, "banks_per_channel",
        cfg.banks_per_channel, "at least 1 bank per channel")
    if cfg.organization == "separate":
        chk(cfg.channels >= 2 and cfg.banks_per_channel >= 2,
            "organization", cfg.organization,
            "channels >= 2 and banks_per_channel >= 2 for the "
            "split-bus organization",
            "Fig. 6b halves the channel/bank pools between DRAM and SCM")

    chk(1 <= cfg.n_levels <= 256, "n_levels", cfg.n_levels,
        "an affinity-level count in [1, 256]",
        "levels pack into an 8-bit field of the engine's per-slot word")
    chk(0.0 < cfg.ema_weight <= 1.0, "ema_weight", cfg.ema_weight,
        "a moving-average weight in (0, 1]")
    chk(0.0 <= cfg.bear_fill_prob <= 1.0, "bear_fill_prob",
        cfg.bear_fill_prob, "a probability in [0, 1]")
    chk(cfg.redcache_threshold >= 0, "redcache_threshold",
        cfg.redcache_threshold, "a non-negative access count")

    chk(math.isfinite(cfg.ctc_fraction) and cfg.ctc_fraction >= 0,
        "ctc_fraction", cfg.ctc_fraction,
        "a non-negative fraction of DRAM-cache tags held by the CTC")
    chk(cfg.ctc_ways >= 1, "ctc_ways", cfg.ctc_ways, "at least 1 way")
    chk(1 <= cfg.ctc_sectors_per_line <= 32, "ctc_sectors_per_line",
        cfg.ctc_sectors_per_line, "a sector count in [1, 32]",
        "the sector index packs into a 5-bit field of the CTC tag word")

    chk(math.isfinite(cfg.link_bw_gbps) and cfg.link_bw_gbps > 0,
        "link_bw_gbps", cfg.link_bw_gbps, "a positive link bandwidth")
    chk(cfg.fault_latency_ns >= 0, "fault_latency_ns", cfg.fault_latency_ns,
        "a non-negative latency")
    chk(cfg.fault_overlap > 0, "fault_overlap", cfg.fault_overlap,
        "a positive concurrency factor",
        "the serialized fault term divides by it")
    chk(cfg.um_prefetch_pages >= 1, "um_prefetch_pages",
        cfg.um_prefetch_pages, "a migration chunk of at least 1 page")
    chk(cfg.um_hot_threshold >= 0, "um_hot_threshold", cfg.um_hot_threshold,
        "a non-negative access count")
    chk(cfg.act_page_bytes >= 1, "act_page_bytes", cfg.act_page_bytes,
        "a positive counter grain")
    chk(cfg.compute_cycles_per_request >= 0, "compute_cycles_per_request",
        cfg.compute_cycles_per_request, "a non-negative compute floor")

    # Silent-rounding surface: hardware indexes CTC sets by bit-masking, so
    # the modeled set count rounds the ctc_fraction sector budget down to a
    # power of two.  The default geometry loses < 1.5x and stays quiet; warn
    # when a config silently drops more of its requested budget than that.
    if cfg.policy in timing.POLICIES_WITH_CTC:
        per_line = cfg.ctc_ways * cfg.ctc_sectors_per_line
        raw = max(1, cfg.ctc_total_sectors // per_line)
        eff = cfg.ctc_sets
        if raw > eff and raw / eff > 1.5:
            warnings.warn(
                f"HMSConfig.ctc_fraction = {cfg.ctc_fraction!r}: the "
                f"requested budget maps to {raw} CTC sets but the engine "
                f"models {eff} (set counts round down to a power of two); "
                f"{100 * (1 - eff / raw):.0f}% of the budget is unused — "
                "size ctc_fraction/ctc_ways so the set count lands on a "
                "power of two", ResilienceWarning, stacklevel=3)
    return cfg


def validate_config(cfg):
    """Validate an :class:`HMSConfig`; returns it (memoized per config)."""
    return _validate_config_cached(cfg)


# ---------------------------------------------------------------------------
# Trace.
# ---------------------------------------------------------------------------

def validate_trace(trace) -> None:
    """Validate a :class:`~repro_torch.core.traces.Trace` (shape/dtype/bounds
    consistency).  Called at trace construction and again at engine entry,
    so in-place mutation of the request arrays is caught before a scan."""
    from repro_torch.core.timing import COLUMN_BYTES

    name = getattr(trace, "name", "<trace>")
    col = np.asarray(trace.col)
    wr = np.asarray(trace.is_write)
    if col.ndim != 1:
        _fail(f"Trace({name}).col", col.shape, "a 1-D request stream")
    if col.shape[0] < 1:
        _fail(f"Trace({name}).col", col.shape, "at least one request",
              "empty traces have no defined counters; generate n >= 1")
    if col.dtype.kind not in "iu":
        _fail(f"Trace({name}).col", col.dtype, "an integer column index")
    if wr.shape != col.shape:
        _fail(f"Trace({name}).is_write", wr.shape,
              f"the same shape as col {col.shape}")
    if not isinstance(trace.footprint, (int, np.integer)) \
            or trace.footprint <= 0:
        _fail(f"Trace({name}).footprint", trace.footprint,
              "a positive byte count")
    limit = trace.footprint // COLUMN_BYTES
    lo = int(col.min(initial=0))
    hi = int(col.max(initial=0))
    if lo < 0:
        _fail(f"Trace({name}).col", lo, "non-negative column indices")
    if hi >= limit:
        _fail(f"Trace({name}).col", hi,
              f"column indices below footprint//{COLUMN_BYTES} = {limit}",
              "grow Trace.footprint or clamp the generator's address span")
    pid = trace.phase_id
    if pid is not None:
        pid = np.asarray(pid)
        if pid.shape != col.shape:
            _fail(f"Trace({name}).phase_id", pid.shape,
                  f"the same shape as col {col.shape}",
                  "tag every request, or pass phase_id=None for an "
                  "unphased trace")
        if not trace.phase_names:
            _fail(f"Trace({name}).phase_names", trace.phase_names,
                  "a non-empty name tuple when phase_id is set")
        pmax = int(pid.max(initial=0))
        if int(pid.min(initial=0)) < 0 or pmax >= len(trace.phase_names):
            _fail(f"Trace({name}).phase_id", pmax,
                  f"phase indices in [0, {len(trace.phase_names)})")


# ---------------------------------------------------------------------------
# Scenario (duck-typed: no repro_torch.workloads import from here).
# ---------------------------------------------------------------------------

def validate_scenario(scenario, patterns=None) -> None:
    """Validate a :class:`~repro_torch.workloads.ir.Scenario` and its
    phases.  ``patterns`` is the caller's pattern registry (passed in so
    this module never imports ``repro_torch.workloads``)."""
    name = getattr(scenario, "name", "<scenario>")
    if scenario.footprint <= 0:
        _fail(f"Scenario({name}).footprint", scenario.footprint,
              "a positive byte count")
    if not scenario.phases:
        _fail(f"Scenario({name}).phases", (), "at least one phase")
    total = 0.0
    for rname, frac in scenario.regions.items():
        if not (0.0 < frac <= 1.0):
            _fail(f"Scenario({name}).regions[{rname!r}]", frac,
                  "a footprint fraction in (0, 1]")
        total += frac
    if total > 1.0 + 1e-9:
        _fail(f"Scenario({name}).regions", total,
              "region fractions summing to at most 1.0",
              "shrink the regions or grow Scenario.footprint")
    seen = set()
    for p in scenario.phases:
        path = f"Scenario({name}).phases[{p.name!r}]"
        if p.name in seen:
            _fail(path + ".name", p.name, "a unique phase name")
        seen.add(p.name)
        if p.region not in scenario.regions:
            _fail(path + ".region", p.region,
                  "one of " + ", ".join(repr(r) for r in scenario.regions))
        if patterns is not None and p.pattern not in patterns:
            _fail(path + ".pattern", p.pattern,
                  "one of " + ", ".join(repr(k) for k in patterns))
        if not (p.weight > 0 and math.isfinite(p.weight)):
            _fail(path + ".weight", p.weight,
                  "a positive request-budget share")
        if not (0.0 <= p.write_frac <= 1.0):
            _fail(path + ".write_frac", p.write_frac,
                  "a write fraction in [0, 1]")


# ---------------------------------------------------------------------------
# Engine packing invariants.
# ---------------------------------------------------------------------------

def check_hms_packing(trace_name: str, *, tag_max: Optional[int] = None,
                      n_levels: Optional[int] = None,
                      rg_max: Optional[int] = None) -> None:
    """Packed-word layout limits of the HMS scan kernel: tag<<10 must
    stay inside int32, affinity levels live in an 8-bit field, and the
    CTC row-group tag (+1) in a 23-bit field.  Raises
    :class:`EngineInvariantError` (not ``assert``, so ``python -O`` keeps
    the guarantee) before any launch."""
    if tag_max is not None and tag_max >= (1 << 21):
        raise EngineInvariantError(
            f"Trace({trace_name}) tag", tag_max,
            f"DRAM-cache tags below 2^21 (got log2 ~ {tag_max.bit_length()})",
            "the SCM/DRAM capacity ratio is too large for the packed "
            "int32 slot word; raise dram_ratio or shrink the footprint")
    if n_levels is not None and not (1 <= n_levels <= 256):
        raise EngineInvariantError(
            "HMSConfig.n_levels", n_levels,
            "an affinity-level count in [1, 256]",
            "levels pack into an 8-bit field of the engine's slot word")
    if rg_max is not None and rg_max >= (1 << 23) - 1:
        raise EngineInvariantError(
            f"Trace({trace_name}) row_group", rg_max,
            "shard-local row groups below 2^23 - 1",
            "the footprint's row-group space overflows the CTC tag "
            "packing; shrink the footprint or raise the shard count")


# ---------------------------------------------------------------------------
# UM paging spec.
# ---------------------------------------------------------------------------

def validate_um_spec(spec) -> None:
    """Validate a :class:`~repro_torch.um.engine.UMSpec` at engine entry."""
    if spec.n_frames < 1:
        _fail("UMSpec.n_frames", spec.n_frames,
              "at least one resident HBM frame",
              "n_frames derives from hbm_capacity // page; raise r_hbm")
    if spec.chunk < 1:
        _fail("UMSpec.chunk", spec.chunk,
              "a migration chunk of at least 1 page")
    if spec.hot_thresh < 0:
        _fail("UMSpec.hot_thresh", spec.hot_thresh,
              "a non-negative access count")
