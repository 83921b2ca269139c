"""Timed-step profiler + per-host calibration profiles for the (S, T) planner.

A port of the reference package's ``repro.core.calibrate``.  The cost
model's six step-cost constants and its ``rounds_estimate`` line are
re-measured on the machine underneath, through the port's own entry points
(on the card unless ``device="cpu"``), on the traces the planner serves:
the main path's own workloads at their default sizes (the quick grid:
pathfnd and zipf at 10^6 requests; the full grid: every registered
workload and zipf at 10^6; llm_dec's paging lanes for the UM scan).
Scans at controlled lane counts through both engines (forced (S, T)
shapes; the kernels' build excluded by a warm-up call; median-of-k
timing), each wall over the depth the planner costs, give the ``solo /
overhead / per-lane`` cost shape, and the stitch rounds both engines
report at every T the cap allows give the ``rounds_estimate`` line; each
line is fitted on or above every point it was fitted to, so the planner
never sees a shape as cheaper than it ran.  The result is a
:class:`~repro_torch.core.costmodel.CalibProfile`
persisted as JSON keyed by a host fingerprint that names the GPU (as
``nvidia-smi --query-gpu=name,power.limit`` reports it) and the torch and
CUDA versions:

    <REPRO_CALIB_DIR>/calib_<fingerprint>.json

(``REPRO_CALIB_DIR`` defaults to ``build/calibration`` at the checkout's
root.)  ``REPRO_CALIB`` selects how the planner consumes it — ``off``
(committed defaults), ``auto`` (load if present, the default), ``force``
(recalibrate now).  Profiles change only the *plan*; every shape
reproduces the sequential scan bit for bit, so counters are
profile-independent by construction.

    python -m repro_torch.core.calibrate [--quick] [--device cpu] [--n N]

measures this host, prints the measurements, the profile and the plan it
gives each calibration trace as JSON, and saves the profile.

Import rule: this module imports ``costmodel`` at module level (one
direction); the engines are imported lazily inside the profiler.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import statistics
import subprocess
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

from . import costmodel
from .costmodel import CalibProfile, DEFAULT_PROFILE

#: the main path's traces the quick grid runs on, (workload, n; None = its
#: default size); the full grid runs every registered workload at its
#: default size and zipf at 10^6
_QUICK_TRACES = (("pathfnd", None), ("zipf", 10**6))
_UM_TRACE = ("llm_dec", None)
#: timing reps a shape: (full grid, quick grid)
_REPS = (5, 3)

_HMS_LANE_COUNTS = (1, 2, 4, 8, 16)
_UM_LANE_COUNTS = (1, 2, 4)


def gpu_name_and_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    ``"none"`` where there is no card or no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "none"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "none"


def host_metadata() -> Dict[str, object]:
    """What defines calibration identity: the GPU and its power limit, the
    torch and CUDA versions, and the host CPU."""
    import torch
    return {"gpu": gpu_name_and_limit(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "platform": platform.system(),
            "machine": platform.machine(), "cpu_count": os.cpu_count(),
            "python": platform.python_version()}


def host_fingerprint() -> str:
    """12-hex identity of this host for calibration purposes, derived from
    :func:`host_metadata` (git state deliberately excluded: a commit
    doesn't change the silicon)."""
    payload = json.dumps(host_metadata(), sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


def calib_dir() -> str:
    """``REPRO_CALIB_DIR`` or ``build/calibration`` at the checkout's root
    (a directory the repository ignores)."""
    env = os.environ.get("REPRO_CALIB_DIR")
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    return os.path.join(root, "build", "calibration")


def profile_path(fingerprint: Optional[str] = None,
                 directory: Optional[str] = None) -> str:
    fp = fingerprint or host_fingerprint()
    return os.path.join(directory or calib_dir(), f"calib_{fp}.json")


# --- JSON persistence (bitwise float round-trip) ---------------------------

def profile_to_json(profile: CalibProfile) -> str:
    return json.dumps(dataclasses.asdict(profile), indent=2,
                      sort_keys=True) + "\n"


def profile_from_json(text: str) -> CalibProfile:
    raw = json.loads(text)
    names = {f.name for f in dataclasses.fields(CalibProfile)}
    return CalibProfile(**{k: v for k, v in raw.items() if k in names})


def save_profile(profile: CalibProfile,
                 directory: Optional[str] = None) -> str:
    """Persist ``profile`` under its own fingerprint; returns the path."""
    path = profile_path(profile.fingerprint, directory)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(profile_to_json(profile))
    os.replace(tmp, path)
    return path


def load_profile(path: str) -> Optional[CalibProfile]:
    """Load one profile file; ``None`` if absent or unparseable (a corrupt
    profile must degrade to defaults, never break the planner)."""
    try:
        with open(path) as fh:
            return profile_from_json(fh.read())
    except (OSError, ValueError, TypeError):
        return None


def load_host_profile(directory: Optional[str] = None
                      ) -> Optional[CalibProfile]:
    """The persisted profile for *this* host, or ``None``."""
    return load_profile(profile_path(directory=directory))


def ensure_host_profile(force: bool = False, quick: bool = True,
                        directory: Optional[str] = None) -> CalibProfile:
    """Load this host's profile, calibrating (and persisting) if absent —
    or unconditionally when ``force``.  The ``REPRO_CALIB=force`` path
    (it measures on the card, so it needs one)."""
    if not force:
        existing = load_host_profile(directory)
        if existing is not None:
            return existing
    profile = run_calibration(quick=quick)
    save_profile(profile, directory)
    return profile


# --- the timed-step profiler -----------------------------------------------

def _fit_line(points: Sequence[Tuple[float, float]]) -> Tuple[float, float]:
    """Least-squares (slope, intercept) through ``(x, y)`` points; a single
    point degrades to a horizontal line through it."""
    if len(points) == 1:
        return 0.0, points[0][1]
    xb = sum(x for x, _ in points) / len(points)
    yb = sum(y for _, y in points) / len(points)
    den = sum((x - xb) ** 2 for x, _ in points)
    slope = sum((x - xb) * (y - yb) for x, y in points) / den if den else 0.0
    return slope, yb - slope * xb


def _calib_traces(quick: bool, n: Optional[int] = None):
    """(HMS traces, UM trace): the main path's own workloads, at their
    default sizes unless ``n`` cuts every one to n requests (the CPU)."""
    from .traces import WORKLOADS, make_trace

    names = _QUICK_TRACES if quick else (
        [(w, None) for w in sorted(WORKLOADS)] + [("zipf", 10**6)])
    hms = [make_trace(w, n=n if n is not None else size)
           for w, size in names]
    w, size = _UM_TRACE
    return hms, make_trace(w, n=n if n is not None else size)


class _forced_shape:
    """Pin (S, T) for the duration of a timed probe, restoring on exit."""

    def __init__(self, shards: Optional[int], t_segments: Optional[int]):
        self._s, self._t = shards, t_segments

    def __enter__(self):
        self._old_s = costmodel.set_forced_shards(self._s)
        self._old_t = costmodel.set_forced_tsplit(self._t)
        return self

    def __exit__(self, *exc):
        costmodel.set_forced_shards(self._old_s)
        costmodel.set_forced_tsplit(self._old_t)
        return False


def _median_wall(fn, reps: int, before=None) -> float:
    """Median wall of ``reps`` calls, the kernels' build already excluded
    by the caller's warm-up call.  ``before`` (e.g. a result-memo reset)
    runs outside the timed region."""
    walls = []
    for _ in range(reps):
        if before is not None:
            before()
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def _profile_hms(trace, cfg, reps: int, lane_counts: Sequence[int],
                 device=None) -> Dict[int, float]:
    """Measured per-step cost (us) of the HMS scan by lane count: forced
    (S, 1) shapes, batch 1, so lanes == S exactly; a step is one of the
    depth the planner costs (``simulator.plan_depth``: the kernel's
    longest chain).  A ``simulate`` returns host counters, so its wall
    includes the card's work."""
    from . import simulator

    per_step: Dict[int, float] = {}
    for s in lane_counts:
        with _forced_shape(s, 1):
            simulator.simulate(trace, cfg, device=device)   # warm-up
            wall = _median_wall(
                lambda: simulator.simulate(trace, cfg, device=device), reps)
        per_step[s] = wall * 1e6 / max(1, simulator.plan_depth(
            trace, [cfg])(s))
    return per_step


def _um_specs(trace, width: int):
    """``width`` distinct paging specs of the main path's kind: the
    default HBM config's fault-mode spec, each further lane one frame
    fewer (as fig17's capacities differ)."""
    from ..um import engine as um
    from .timing import HMSConfig

    base = um.um_spec(HMSConfig(footprint=trace.footprint,
                                organization="hbm"))
    return [dataclasses.replace(base, n_frames=base.n_frames - i)
            for i in range(width)]


def _profile_um(trace, reps: int, lane_counts: Sequence[int],
                device=None) -> Dict[int, float]:
    """Measured per-step cost (us) of the UM paging scan by lane count:
    forced T=1, ``width`` distinct specs, so lanes == width exactly.  The
    per-trace result memo is dropped before every timed call, else
    repeats would measure a dict lookup."""
    from ..um import engine as um

    per_step: Dict[int, float] = {}
    for width in lane_counts:
        specs = _um_specs(trace, width)
        with _forced_shape(None, 1):
            um._RESULT_CACHE.pop(trace, None)
            um.simulate_um_many(trace, specs, device=device)   # warm-up
            wall = _median_wall(
                lambda: um.simulate_um_many(trace, specs, device=device),
                reps, before=lambda: um._RESULT_CACHE.pop(trace, None))
        per_step[width] = wall * 1e6 / max(1, trace.n)
    return per_step


def _rounds_tsplits() -> List[int]:
    """Every T > 1 the planner may pick under the current cap."""
    return [t for t in costmodel._t_candidates(1 << 30) if t > 1]


def _measure_stitch_rounds(trace, cfg, tsplits: Sequence[int],
                           device=None) -> List[Tuple[int, float]]:
    """Run forced (1, T) scans and read the stitch rounds each run
    reported — the measured settling behavior the ``rounds_estimate`` line
    is fit against."""
    from . import simulator

    out = []
    for t in tsplits:
        with _forced_shape(1, t):
            simulator.simulate(trace, cfg, device=device)
        run = simulator._RUNS[-1] if simulator._RUNS else None
        if run is not None and run["t_segments"] == t:
            out.append((t, float(run["rounds"])))
    return out


def _measure_um_rounds(trace, tsplits: Sequence[int],
                       device=None) -> List[Tuple[int, float]]:
    """The same for the UM scan: forced T on two paging lanes."""
    from ..um import engine as um

    out = []
    specs = _um_specs(trace, 2)
    for t in tsplits:
        with _forced_shape(None, t):
            um._RESULT_CACHE.pop(trace, None)
            um.simulate_um_many(trace, specs, device=device)
        run = um._RUNS[-1] if um._RUNS else None
        if run is not None and run["t_segments"] == t:
            out.append((t, float(run["rounds"])))
    return out


def _fit_cover(points: Sequence[Tuple[float, float]],
               min_slope: float = 0.0) -> Tuple[float, float]:
    """:func:`_fit_line` (slope at least ``min_slope``), its intercept then
    raised by the largest shortfall, so that the line lies on or above
    every point: the planner compares modeled costs, and a point the line
    undercuts makes that shape look cheaper than it ran."""
    slope, icpt = _fit_line(points)
    slope = max(min_slope, slope)
    icpt += max(0.0, max(y - (icpt + slope * x) for x, y in points))
    return slope, icpt


def _fit_rounds(samples: Sequence[Tuple[int, float]]
                ) -> Tuple[float, float]:
    """Fit ``rounds = base + slope * (log2(T) - 1)`` to measured stitch
    rounds, on or above every sample (:func:`_fit_cover`); falls back to
    the committed line when nothing was measured."""
    import math

    if not samples:
        return DEFAULT_PROFILE.rounds_base, DEFAULT_PROFILE.rounds_slope
    slope, base = _fit_cover([(math.log2(t) - 1.0, r) for t, r in samples])
    return max(1.0, base), slope


def measure(quick: bool = False, n: Optional[int] = None,
            reps: Optional[int] = None, device=None) -> Dict[str, object]:
    """The timed-step grid's raw measurements on the main path's traces:
    per-step microseconds by lane count for both engines (HMS per trace),
    and the stitch rounds at every T the cap allows, both engines."""
    from .timing import HMSConfig

    from .simulator import plan_depth

    grid_reps = reps if reps is not None else _REPS[bool(quick)]
    hms_traces, um_trace = _calib_traces(quick, n)
    tsplits = _rounds_tsplits()
    out = {"n": {}, "reps": grid_reps, "hms": {}, "depth": {},
           "rounds": []}
    with warnings.catch_warnings():
        # probe shapes are deliberately mis-planned; the drift sentinel
        # has nothing to learn from them
        warnings.simplefilter("ignore", costmodel.CalibrationDriftWarning)
        for trace in hms_traces:
            cfg = HMSConfig(footprint=trace.footprint)
            name = f"{trace.name}@{trace.n}"
            out["n"][name] = trace.n
            out["depth"][name] = {s: plan_depth(trace, [cfg])(s)
                                  for s in _HMS_LANE_COUNTS}
            out["hms"][name] = _profile_hms(
                trace, cfg, grid_reps, _HMS_LANE_COUNTS, device)
            out["rounds"] += _measure_stitch_rounds(trace, cfg, tsplits,
                                                    device)
        out["n"][f"um:{um_trace.name}@{um_trace.n}"] = um_trace.n
        out["um"] = _profile_um(um_trace, grid_reps, _UM_LANE_COUNTS,
                                device)
        out["rounds"] += _measure_um_rounds(um_trace, tsplits, device)
    return out


def fit_profile(m: Dict[str, object]) -> CalibProfile:
    """The :class:`CalibProfile` that :func:`measure`'s grid gives: the HMS
    points of every trace pooled into one lane line on or above each of
    them (:func:`_fit_cover`; solo: their mean), the UM line likewise."""
    hms, um = m["hms"], m["um"]
    solo = [c[1] for c in hms.values()]
    lane_cost, overhead = _fit_cover(
        [(s, v) for c in hms.values() for s, v in c.items() if s > 1],
        min_slope=1e-3)
    um_lane_cost, um_overhead = _fit_cover(
        [(w, c) for w, c in um.items() if w > 1], min_slope=1e-3)
    rounds_base, rounds_slope = _fit_rounds(m["rounds"])
    return CalibProfile(
        step_cost_solo=max(1e-3, sum(solo) / len(solo)),
        step_overhead=max(0.0, overhead),
        lane_cost=max(1e-3, lane_cost),
        um_step_cost_solo=max(1e-3, um[1]),
        um_step_overhead=max(0.0, um_overhead),
        um_lane_cost=max(1e-3, um_lane_cost),
        rounds_base=rounds_base,
        rounds_slope=rounds_slope,
        fingerprint=host_fingerprint(),
        source="measured",
        created_ts=time.time(),
    )


def run_calibration(quick: bool = False, n: Optional[int] = None,
                    reps: Optional[int] = None,
                    device=None) -> CalibProfile:
    """Measure this host and return a fresh :class:`CalibProfile`.

    Runs the timed-step grid through both engines (throwaway scans at
    forced shapes; the first call per shape builds and is excluded;
    ``reps`` further calls are medianed), fits the cost shape, and fits
    the rounds line against the measured stitch rounds.  Does NOT activate
    or persist the result — callers compose that
    (:func:`ensure_host_profile`, the CLI below)."""
    return fit_profile(measure(quick, n, reps, device))


def plans(profile: CalibProfile, quick: bool = False,
          n: Optional[int] = None) -> Dict[str, Dict[str, object]]:
    """The shape ``profile`` plans for each calibration trace (one config;
    the UM scan's two link-mode lanes), with its predicted microseconds."""
    from . import tsplit
    from .simulator import plan_depth
    from .timing import HMSConfig

    hms_traces, um_trace = _calib_traces(quick, n)
    old = costmodel.set_profile(profile)
    try:
        out = {}
        for t in hms_traces:
            p = costmodel.plan_hms_split(
                plan_depth(t, [HMSConfig(footprint=t.footprint)]), 1,
                tsplit.replay_prefix())
            out[f"{t.name}@{t.n}"] = {"shards": p.shards,
                                      "t_segments": p.t_segments,
                                      "predicted_us": p.predicted_us}
        p = costmodel.plan_um_split(um_trace.n, 2)
        out[f"um:{um_trace.name}@{um_trace.n}"] = {
            "t_segments": p.t_segments, "predicted_us": p.predicted_us}
        return out
    finally:
        costmodel.set_profile(old)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="measure this host's cost-"
                                 "model profile and save it")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--n", type=int, default=None,
                    help="cut every calibration trace to N requests")
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    m = measure(quick=args.quick, n=args.n, device=args.device)
    profile = fit_profile(m)
    path = save_profile(profile, args.dir)
    print(json.dumps({"host": host_metadata(), "measured": {
        "n": m["n"], "reps": m["reps"], "hms_us_per_step": m["hms"],
        "hms_depth": m["depth"], "um_us_per_step": m["um"],
        "stitch_rounds": m["rounds"]},
        "profile": dataclasses.asdict(profile),
        "plans": plans(profile, args.quick, args.n), "path": path}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
