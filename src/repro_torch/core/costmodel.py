"""Unified scan cost model: spatial shards x temporal segments, both engines.

The reference package's ``repro.core.costmodel`` with its form unchanged;
only the committed constants differ: they were fitted on the H100 by
``repro_torch.core.calibrate`` (the reference's describe a 2-core CPU).
They plan calls on the card; calls on CPU tensors (the kernels' plain
versions) plan under :data:`HOST_PROFILE` (:func:`profile_for`).

One module owns every hand-set execution-shape constant and cap the
engines used to scatter across ``simulator.py`` and ``um/engine.py``:

  * the measured per-step cost constants (``STEP_COST_SOLO`` /
    ``STEP_OVERHEAD`` / ``LANE_COST`` for the HMS scan, the ``UM_*``
    triple for the paging scan),
  * the shard cap (``REPRO_SHARDS``) and the temporal-segment cap
    (``REPRO_TSPLIT``),
  * and the (S, T) chooser both engines call per engine key.

Env knobs (also settable programmatically; see README "Environment
knobs"):

  ================= ======= ===============================================
  variable          default meaning
  ================= ======= ===============================================
  REPRO_SHARDS      64      cap on spatial shards S (1 = sequential scan)
  REPRO_TSPLIT      16      cap on temporal segments T (1 = no splitting)
  REPRO_CALIB       auto    off | auto | force — which calibration profile
                            the planner costs shapes with
  REPRO_CALIB_DIR   (repo)  where per-host calibration profiles live
  REPRO_CALIB_DRIFT 25      wall/prediction ratio before the drift
                            sentinel warns (never fails)
  ================= ======= ===============================================

Cost shape
----------
One scan step costs a fixed dispatch overhead plus per-lane work, with a
separate solo constant for a lone-lane scan.  Spatial sharding divides steps but multiplies lanes;
temporal splitting does the same AND pays the speculative re-run rounds
of the fixed-point stitch (``repro_torch.core.tsplit``), so the modeled cost of
an (S, T) split of a depth-D scan shared by ``batch`` configs is::

    rounds_est(T) * (ceil(D_S / T) + replay) * step_cost(S * T * batch)

where ``D_S`` is the depth the scan walks at S shards (the reference
passes its LPT-binned shard depth; the port passes its kernel's longest
(lane, CTC set) chain, ``simulator.plan_depth``) and ``rounds_est`` is
the expected stitch-round count (1 for T=1; ~2 for small T — round one
speculates, round two confirms the fixed point — creeping up slowly for
deeper splits).  Temporal splitting wins where spatial lanes are
scarce — zipf traces whose hottest CTC set caps the LPT
depth at low S, and the UM paging scan, which cannot shard at all.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os
import warnings
from typing import Callable, Dict, List, Optional, Tuple

# --- measured per-step scan costs, microseconds.  These constants are the
# committed default calibration profile: ``repro_torch.core.calibrate``'s
# quick grid (``python -m repro_torch.core.calibrate --quick``: pathfnd and
# zipf at 10^6 requests, llm_dec's paging lanes, each at S = 1-16 or
# 1-4 lanes, and the stitch rounds at every T up to 16) on one
# "NVIDIA H100 80GB HBM3, 700.00 W" (torch 2.11.0+cu128, CUDA 12.8), each a
# ``simulate`` / ``simulate_um_many`` wall over the depth the planner
# costs, so the host work of a call is in them; every line lies on or
# above the points it was fitted to.  The timed-step profiler can
# re-measure them per host and the choosers below read whichever profile
# is active. -------
STEP_COST_SOLO = 0.25327867409706306    # H100, 700 W: one lane
STEP_OVERHEAD = 0.2766363737528288      # H100, 700 W
LANE_COST = 0.004090737785095462        # H100, 700 W

# The UM paging scan (lanes = specs x segments).
UM_STEP_COST_SOLO = 0.09784694999992057  # H100, 700 W
UM_STEP_OVERHEAD = 0.10088358636347101   # H100, 700 W
UM_LANE_COST = 0.001                     # H100, 700 W: the fit's floor

# rounds_estimate(T) = base + slope * (log2(T) - 1) for T > 1.  On the
# H100 the stitch took T rounds at T = 2, 4, 8 and 16 on both engines (no
# segment's end state forgot its seed); the line on or above them is base
# 2.2, slope 4.6, so no split is modeled cheaper than the whole scan.
ROUNDS_BASE = 2.200000000000002
ROUNDS_SLOPE = 4.6

#: the card and power limit the committed constants were fitted on
DEFAULT_FINGERPRINT = "NVIDIA H100 80GB HBM3, 700.00 W (quick grid)"


# --- calibration profile ----------------------------------------------------

PROFILE_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class CalibProfile:
    """One host's measured cost-model constants (or the committed default).

    The six step-cost constants plus the rounds-estimate line are the full
    parameterization of the (S, T) planner; ``fingerprint`` names the host
    the numbers were measured on (``"default"`` for the committed
    constants) and rides into every ledger record as ``calib_fingerprint``
    so mis-plans are attributable to the profile that planned them.
    """

    step_cost_solo: float = STEP_COST_SOLO
    step_overhead: float = STEP_OVERHEAD
    lane_cost: float = LANE_COST
    um_step_cost_solo: float = UM_STEP_COST_SOLO
    um_step_overhead: float = UM_STEP_OVERHEAD
    um_lane_cost: float = UM_LANE_COST
    rounds_base: float = ROUNDS_BASE
    rounds_slope: float = ROUNDS_SLOPE
    fingerprint: str = "default"
    source: str = "default"        # "default" | "measured"
    created_ts: float = 0.0
    schema: int = PROFILE_SCHEMA_VERSION


DEFAULT_PROFILE = CalibProfile(fingerprint=DEFAULT_FINGERPRINT,
                               source="measured",
                               created_ts=1792278800.5110352)

#: the profile that plans calls on the host (CPU tensors: the kernels'
#: plain versions).  Uncalibrated, as the reference's default is on its
#: host: a plain scan step costs about a millisecond on a CPU
#: (``python -m repro_torch.core.calibrate --quick --device cpu`` gave
#: 0.6-2.4 ms a step at n 2000 and 6000; the UM scan 0.12-0.18 ms), well
#: inside the drift sentinel's band, and a lane is priced as a whole step,
#: so the planner keeps host calls at (1, 1).  The rounds line is the
#: card's: the stitch takes T rounds at T = 2-16 on the host too.
HOST_PROFILE = CalibProfile(step_cost_solo=1000.0, step_overhead=0.0,
                            lane_cost=1000.0, um_step_cost_solo=150.0,
                            um_step_overhead=0.0, um_lane_cost=150.0,
                            fingerprint="host (uncalibrated)",
                            source="default")

_ACTIVE_PROFILE: Optional[CalibProfile] = None
_PROFILE_RESOLVED = False
# a profile pinned by set_profile for calls on every device (None: none)
_PINNED: Optional[CalibProfile] = None
_CALIB_MODE: Optional[str] = None
# the device type of the engine call being planned (None: the card)
_PLAN_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "plan_device", default=None)


def calib_mode() -> str:
    """Active calibration mode: ``off`` (committed defaults), ``auto``
    (load the per-host profile if one exists under ``REPRO_CALIB_DIR``),
    or ``force`` (recalibrate now, on first planner use)."""
    if _CALIB_MODE is not None:
        return _CALIB_MODE
    mode = os.environ.get("REPRO_CALIB", "auto").strip().lower()
    return mode if mode in ("off", "auto", "force") else "auto"


def set_calib_mode(mode: Optional[str]) -> Optional[str]:
    """Pin the calibration mode programmatically (``None`` restores the
    ``REPRO_CALIB`` env default) and drop the resolved profile so the next
    planner call re-resolves; returns the previous pinned value."""
    global _CALIB_MODE, _PROFILE_RESOLVED, _ACTIVE_PROFILE, _PINNED
    old = _CALIB_MODE
    _CALIB_MODE = None if mode is None else str(mode).strip().lower()
    _PROFILE_RESOLVED = False
    _ACTIVE_PROFILE = _PINNED = None
    return old


def set_profile(profile: Optional[CalibProfile]) -> Optional[CalibProfile]:
    """Pin the active calibration profile (tests, the calibrate CLI), for
    calls on every device.  ``None`` drops back to the profile by device
    (:func:`profile_for`).  Returns the previously pinned profile, ``None``
    when none was pinned (never the card's resolution), so ``old =
    set_profile(p) ... set_profile(old)`` leaves the pin as it was."""
    global _PINNED
    old, _PINNED = _PINNED, profile
    return old


@contextlib.contextmanager
def planning_on(device):
    """Within the block, :func:`active_profile` is the profile of calls
    whose tensors lie on ``device`` (the engines' entry points wrap their
    planning, drift check and ledger record in it)."""
    token = _PLAN_DEVICE.set(getattr(device, "type", device))
    try:
        yield
    finally:
        _PLAN_DEVICE.reset(token)


def profile_for(device=None) -> CalibProfile:
    """The profile that plans a call whose tensors lie on ``device`` (a
    ``torch.device`` or its type; None: the card): a pinned profile
    (:func:`set_profile`) on every device; else :data:`HOST_PROFILE` for
    the CPU and the card's resolution (:func:`card_profile`) for CUDA."""
    if _PINNED is not None:
        return _PINNED
    kind = getattr(device, "type", device)
    if kind is not None and str(kind).split(":")[0] == "cpu":
        return HOST_PROFILE
    return card_profile()


def active_profile() -> CalibProfile:
    """The profile the planner is using right now: :func:`profile_for`
    the device of the call being planned (:func:`planning_on`; the card
    outside any call)."""
    return profile_for(_PLAN_DEVICE.get())


def card_profile() -> CalibProfile:
    """The card's profile, resolved once per process: ``off`` ->
    committed defaults, ``auto`` -> per-host profile under
    ``REPRO_CALIB_DIR`` if present else defaults, ``force`` -> run the
    quick timed-step profiler and persist the result."""
    global _ACTIVE_PROFILE, _PROFILE_RESOLVED
    if _PROFILE_RESOLVED:
        return _ACTIVE_PROFILE
    mode = calib_mode()
    # Resolve to the default FIRST: force-mode calibration runs the engines,
    # whose planner calls re-enter here and must see a settled profile.
    _ACTIVE_PROFILE = DEFAULT_PROFILE
    _PROFILE_RESOLVED = True
    if mode == "off":
        return _ACTIVE_PROFILE
    from . import calibrate  # deferred: calibrate imports this module
    if mode == "force":
        _ACTIVE_PROFILE = calibrate.ensure_host_profile(force=True)
    else:
        _ACTIVE_PROFILE = calibrate.load_host_profile() or DEFAULT_PROFILE
    return _ACTIVE_PROFILE


def step_cost(lanes: int) -> float:
    """Modeled per-step cost of the HMS scan at ``lanes`` parallel lanes
    (shards x segments x batched configs)."""
    p = active_profile()
    if lanes == 1:
        return p.step_cost_solo
    return p.step_overhead + p.lane_cost * lanes


def um_step_cost(lanes: int) -> float:
    """Same shape for the UM paging scan (lanes = specs x segments)."""
    p = active_profile()
    if lanes == 1:
        return p.um_step_cost_solo
    return p.um_step_overhead + p.um_lane_cost * lanes


def rounds_estimate(t_segments: int) -> float:
    """Expected fixed-point stitch rounds for a T-way temporal split: one
    round runs everything speculatively, one confirms; deeper splits take a
    little longer to settle (composition propagates at least one exact
    boundary per round, but usually many)."""
    if t_segments <= 1:
        return 1.0
    p = active_profile()
    return max(1.0, p.rounds_base + p.rounds_slope
               * (math.log2(t_segments) - 1.0))


def degradation_ladder(shards: int, t_segments: int) -> list:
    """The guarded engines' deterministic descent over execution shapes
    when a rung fails (see ``repro_torch.resilience.guard``): the planned
    (S, T), then temporal-split off (S, 1), then the fully sequential
    (1, 1).  Every shape reproduces the sequential scan bit-for-bit, so
    descending trades speed for survival, never counters."""
    out = [(int(shards), int(t_segments))]
    if t_segments > 1:
        out.append((int(shards), 1))
    if shards > 1:
        out.append((1, 1))
    return out


# --- caps + overrides ------------------------------------------------------

_MAX_SHARDS = int(os.environ.get("REPRO_SHARDS", "64"))
_MAX_TSPLIT = int(os.environ.get("REPRO_TSPLIT", "16"))
_FORCED_SHARDS: Optional[int] = None
_FORCED_TSPLIT: Optional[int] = None


def max_shards() -> int:
    return _MAX_SHARDS


def set_max_shards(cap: int) -> int:
    """Set the shard-count cap (1 = sequential engine); returns the old cap.
    Benchmarks use this to measure shard speedup against the S=1 scan."""
    global _MAX_SHARDS
    old, _MAX_SHARDS = _MAX_SHARDS, max(1, int(cap))
    return old


def set_forced_shards(n: Optional[int]) -> Optional[int]:
    """Pin the shard count, bypassing the cost model (any count is valid —
    set bins just go empty past the partition-domain size).  Tests use this
    so shard-parallel coverage doesn't depend on host-tuned cost constants.
    ``None`` restores automatic selection; returns the previous value."""
    global _FORCED_SHARDS
    old = _FORCED_SHARDS
    _FORCED_SHARDS = None if n is None else max(1, int(n))
    return old


def max_tsplit() -> int:
    return _MAX_TSPLIT


def set_max_tsplit(cap: int) -> int:
    """Set the temporal-segment cap (1 = no temporal splitting); returns
    the old cap."""
    global _MAX_TSPLIT
    old, _MAX_TSPLIT = _MAX_TSPLIT, max(1, int(cap))
    return old


def set_forced_tsplit(t: Optional[int]) -> Optional[int]:
    """Pin the temporal-segment count for BOTH engines, bypassing the cost
    model (any T >= 1 is valid: the stitch is exact at every split).
    ``None`` restores automatic selection; returns the previous value."""
    global _FORCED_TSPLIT
    old = _FORCED_TSPLIT
    _FORCED_TSPLIT = None if t is None else max(1, int(t))
    return old


def forced_tsplit() -> Optional[int]:
    return _FORCED_TSPLIT


# --- choosers --------------------------------------------------------------

#: rejected candidates kept on a plan (telemetry payload bound)
_MAX_ALTERNATIVES = 4


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """One planner decision with its prediction and the rejected field.

    ``predicted_us`` is the modeled cost of the chosen (S, T) under the
    active profile; ``alternatives`` holds the cheapest rejected shapes
    (each ``{"shards", "t_segments", "predicted_us"}``, ascending cost) so
    the ledger can measure plan regret after the fact.  ``forced`` marks
    shapes pinned by the override setters (no alternatives evaluated).
    """

    shards: int
    t_segments: int
    predicted_us: float
    alternatives: Tuple[Dict[str, float], ...] = ()
    forced: bool = False

    @property
    def best_alternative_us(self) -> Optional[float]:
        return self.alternatives[0]["predicted_us"] \
            if self.alternatives else None


def _t_candidates(depth: int) -> list:
    out = [1]
    t = 2
    while t <= _MAX_TSPLIT and t <= depth:
        out.append(t)
        t *= 2
    return out


def _finish_plan(chosen: Tuple[float, int, int], evaluated: list,
                 forced: bool = False) -> SplitPlan:
    cost, s, t = chosen
    rejected = sorted(((c, cs, ct) for c, cs, ct in evaluated
                       if (cs, ct) != (s, t)))
    alts = tuple({"shards": cs, "t_segments": ct, "predicted_us": c}
                 for c, cs, ct in rejected[:_MAX_ALTERNATIVES])
    return SplitPlan(shards=s, t_segments=t, predicted_us=cost,
                     alternatives=alts, forced=forced)


def plan_hms_split(depth_of: Callable[[int], int], batch: int,
                   replay: int = 0) -> SplitPlan:
    """Pick (shards, t_segments) minimizing modeled HMS scan cost for one
    compiled engine shared by ``batch`` configs, returning the full
    :class:`SplitPlan` (prediction + rejected alternatives).

    ``depth_of(S)`` must return the depth the scan walks at shard count S
    (the port's simulator passes its kernel's longest chain,
    ``simulator.plan_depth``) — zipf traces bin unevenly, so depth is
    measured, not ``n/S``.  Candidates are powers of two under the caps; a bigger
    lane count must beat the incumbent clearly (ties break toward fewer
    lanes, then fewer segments — the sequential-most shape)."""
    forced_s, forced_t = _FORCED_SHARDS, _FORCED_TSPLIT
    if forced_s is not None and forced_t is not None:
        depth = depth_of(forced_s)
        seg = -(-depth // forced_t) + (replay if forced_t > 1 else 0)
        cost = rounds_estimate(forced_t) \
            * seg * step_cost(forced_s * forced_t * batch)
        return SplitPlan(shards=forced_s, t_segments=forced_t,
                         predicted_us=cost, forced=True)

    best = None  # (cost, lanes, t, s)
    evaluated = []
    s = forced_s if forced_s is not None else 1
    s_cap = forced_s if forced_s is not None else _MAX_SHARDS
    while s <= s_cap:
        depth = depth_of(s)
        ts = [forced_t] if forced_t is not None else _t_candidates(depth)
        for t in ts:
            seg = -(-depth // t) + (replay if t > 1 else 0)
            cost = rounds_estimate(t) * seg * step_cost(s * t * batch)
            cand = (cost, s * t, t, s)
            evaluated.append((cost, s, t))
            if best is None or cost < 0.95 * best[0]:
                best = cand
        s *= 2
    return _finish_plan((best[0], best[3], best[2]), evaluated,
                        forced=(forced_s is not None
                                or forced_t is not None))


def choose_hms_split(depth_of: Callable[[int], int], batch: int,
                     replay: int = 0) -> Tuple[int, int]:
    """(S, T) of :func:`plan_hms_split` — the historical tuple interface
    both engines and the tests call."""
    plan = plan_hms_split(depth_of, batch, replay)
    return plan.shards, plan.t_segments


def plan_um_split(n: int, width: int) -> SplitPlan:
    """Temporal segment count for a UM paging batch of ``width`` spec
    lanes over an n-request trace (the UM scan cannot shard, so T is its
    only depth lever), returned as a :class:`SplitPlan` with S = 1."""
    if _FORCED_TSPLIT is not None:
        t = _FORCED_TSPLIT
        cost = rounds_estimate(t) * (-(-n // t)) * um_step_cost(width * t)
        return SplitPlan(shards=1, t_segments=t, predicted_us=cost,
                         forced=True)
    best_t, best_cost = 1, None
    evaluated = []
    for t in _t_candidates(n):
        cost = rounds_estimate(t) * (-(-n // t)) * um_step_cost(width * t)
        evaluated.append((cost, 1, t))
        if best_cost is None or cost < 0.95 * best_cost:
            best_t, best_cost = t, cost
    return _finish_plan((best_cost, 1, best_t), evaluated)


def choose_um_split(n: int, width: int) -> int:
    """T of :func:`plan_um_split` — the historical scalar interface."""
    return plan_um_split(n, width).t_segments


# --- plan-drift sentinel ----------------------------------------------------

class CalibrationDriftWarning(UserWarning):
    """Measured engine wall deviates from the plan's prediction by more
    than the drift factor — the active calibration profile no longer
    describes this host.  Warns, never fails."""


_DRIFT_FACTOR: Optional[float] = None
_DRIFT_WARNED: set = set()


def drift_factor() -> float:
    """Allowed wall/prediction ratio (either direction) before the drift
    sentinel warns; ``REPRO_CALIB_DRIFT`` (default 25) — generous because
    the model predicts scan-step work only, not preprocessing or stitch
    bookkeeping."""
    if _DRIFT_FACTOR is not None:
        return _DRIFT_FACTOR
    try:
        return max(1.0, float(os.environ.get("REPRO_CALIB_DRIFT", "25")))
    except ValueError:
        return 25.0


def set_drift_factor(factor: Optional[float]) -> Optional[float]:
    """Pin the drift factor programmatically (``None`` restores the env
    default); returns the previous pinned value."""
    global _DRIFT_FACTOR
    old = _DRIFT_FACTOR
    _DRIFT_FACTOR = None if factor is None else max(1.0, float(factor))
    return old


def check_plan_drift(fingerprint: str, predicted_us: Optional[float],
                     wall_s: float, compiled: bool = False
                     ) -> Optional[float]:
    """Compare a measured engine wall against its plan's prediction and
    warn (once per engine fingerprint) when the ratio leaves the drift
    band.  Compile calls are excluded — tracing wall swamps the scan.
    Returns the wall/prediction ratio when it warned, else ``None``."""
    if compiled or not predicted_us or predicted_us <= 0.0 or wall_s <= 0.0:
        return None
    ratio = (wall_s * 1e6) / predicted_us
    f = drift_factor()
    if 1.0 / f <= ratio <= f:
        return None
    if fingerprint in _DRIFT_WARNED or len(_DRIFT_WARNED) >= 512:
        return None
    _DRIFT_WARNED.add(fingerprint)
    profile = active_profile()
    warnings.warn(
        f"plan drift on {fingerprint}: measured {wall_s * 1e6:.0f}us vs "
        f"predicted {predicted_us:.0f}us (x{ratio:.1f}, band x{f:.0f}) "
        f"under calibration profile '{profile.fingerprint}' — consider "
        f"`python -m repro_torch.core.calibrate` to re-measure this host",
        CalibrationDriftWarning, stacklevel=3)
    return ratio
