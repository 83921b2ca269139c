"""Gold layer: materialized design-space views over the silver store (a
port of the reference package's ``repro.obs.store.gold``).

Everything here is a pure function of :class:`~.silver.SilverRow` lists —
no I/O, no engine imports — so the views are as reproducible as the
counters beneath them: two stores with bit-identical rows produce
bit-identical frontiers, tables, and diffs.

* :func:`pareto` — deterministic non-dominated filtering on the three
  bandwidth-effectiveness axes the paper optimizes: runtime cycles,
  total DRAM+SCM bus traffic, and probe (metadata) traffic.
* :func:`frontier_view` — frontiers per ``(workload, policy)`` group.
* :func:`best_configs` — the single best config per workload under a
  chosen primary axis (ties broken by the remaining axes, then key).
* :func:`frontier_diff` — the cross-PR regression view: which configs
  entered/left each frontier between two row sets (typically two git
  SHAs of the same sweep), with per-axis deltas for configs present in
  both.  A store diffed against itself is empty by construction.
* :func:`planner_view` — planner accuracy over the plan-telemetry table:
  predicted-vs-measured ratio distribution, per-group measured regret,
  and the mis-plan table naming engine keys where a rejected (S, T)
  shape measured faster than the shape the cost model preferred.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .silver import PlanRow, SilverRow

# Pareto axes, all minimized.  Bit-derived from model counters (traffic,
# probe) and the deterministic timing model (runtime).
AXES: Tuple[str, ...] = ("runtime_cycles", "traffic_bytes", "probe_bytes")


@dataclasses.dataclass
class FrontierPoint:
    """One frontier candidate: a silver row projected onto the axes."""

    config_key: str
    trace_fp: str
    workload: str
    policy: Optional[str]
    axes: Dict[str, float]               # axis name -> value (minimized)
    config: Optional[Dict[str, object]]  # human-readable knobs, if known
    git_sha: str

    @property
    def ident(self) -> str:
        """Design-point identity: config key *and* trace fingerprint —
        scenario oversub sweeps hold the config fixed and vary the trace,
        so config key alone would collapse distinct points."""
        return f"{self.config_key}@{self.trace_fp}"

    @classmethod
    def from_row(cls, row: SilverRow,
                 axes: Sequence[str] = AXES) -> Optional["FrontierPoint"]:
        """Project a row; None if any axis is missing (ledger rows carry
        raw counters but no runtime until a bench source fills it in)."""
        vals = {}
        for a in axes:
            v = row.metrics.get(a)
            if v is None:
                return None
            vals[a] = float(v)
        return cls(config_key=row.config_key, trace_fp=row.trace_fp,
                   workload=row.workload, policy=row.policy, axes=vals,
                   config=row.config, git_sha=row.git_sha)

    def dominates(self, other: "FrontierPoint") -> bool:
        """<= on every axis and < on at least one (strict Pareto)."""
        le = all(self.axes[a] <= other.axes[a] for a in self.axes)
        lt = any(self.axes[a] < other.axes[a] for a in self.axes)
        return le and lt


def pareto(points: Sequence[FrontierPoint]) -> List[FrontierPoint]:
    """Non-dominated subset, deterministically ordered by (first axis,
    remaining axes, identity).  Duplicate design points (same config key
    and trace) collapse to one first — re-ingestion order can never
    change the result."""
    byk: Dict[str, FrontierPoint] = {}
    for p in points:
        byk.setdefault(p.ident, p)
    uniq = sorted(byk.values(),
                  key=lambda p: (*p.axes.values(), p.ident))
    front = [p for p in uniq
             if not any(q.dominates(p) for q in uniq if q is not p)]
    return front


def _group(rows: Sequence[SilverRow],
           axes: Sequence[str]) -> Dict[Tuple[str, str], List[FrontierPoint]]:
    groups: Dict[Tuple[str, str], List[FrontierPoint]] = {}
    for row in rows:
        p = FrontierPoint.from_row(row, axes)
        if p is None:
            continue
        groups.setdefault((row.workload, row.policy or row.engine),
                          []).append(p)
    return groups


def frontier_view(rows: Sequence[SilverRow],
                  axes: Sequence[str] = AXES,
                  ) -> Dict[Tuple[str, str], List[FrontierPoint]]:
    """Pareto frontier per ``(workload, policy)`` group, groups in
    deterministic key order."""
    groups = _group(rows, axes)
    return {k: pareto(v) for k, v in sorted(groups.items())}


def best_configs(rows: Sequence[SilverRow],
                 primary: str = "runtime_cycles",
                 axes: Sequence[str] = AXES,
                 ) -> Dict[str, FrontierPoint]:
    """Best config per workload: the frontier point minimizing the
    primary axis, ties broken by the remaining axes then config key."""
    best: Dict[str, FrontierPoint] = {}
    for (workload, _), front in frontier_view(rows, axes).items():
        for p in front:
            cur = best.get(workload)
            key = (p.axes[primary],
                   *[p.axes[a] for a in axes if a != primary],
                   p.ident)
            ck = cur and (cur.axes[primary],
                          *[cur.axes[a] for a in axes if a != primary],
                          cur.ident)
            if cur is None or key < ck:
                best[workload] = p
    return best


@dataclasses.dataclass
class FrontierDiff:
    """Cross-PR regression view between two row sets (old -> new)."""

    sha_old: str
    sha_new: str
    # group -> config keys newly on / no longer on the frontier
    entered: Dict[Tuple[str, str], List[str]]
    left: Dict[Tuple[str, str], List[str]]
    # group -> config key -> axis -> (old, new, delta) for configs on
    # either frontier whose axis values moved
    changed: Dict[Tuple[str, str], Dict[str, Dict[str, Tuple[float, float, float]]]]
    # flattened worsened-axis records: the gate input
    regressions: List[Dict[str, object]]

    @property
    def empty(self) -> bool:
        return not (any(self.entered.values()) or any(self.left.values())
                    or any(self.changed.values()))

    def summary(self) -> Dict[str, int]:
        return {
            "groups_entered": sum(len(v) for v in self.entered.values()),
            "groups_left": sum(len(v) for v in self.left.values()),
            "configs_changed": sum(len(v) for v in self.changed.values()),
            "regressions": len(self.regressions),
        }


def _shas(rows: Sequence[SilverRow]) -> str:
    shas = sorted({r.git_sha for r in rows})
    return shas[0] if len(shas) == 1 else "+".join(shas) or "empty"


def frontier_diff(rows_old: Sequence[SilverRow],
                  rows_new: Sequence[SilverRow],
                  axes: Sequence[str] = AXES) -> FrontierDiff:
    """Diff the frontiers of two row sets — typically the same sweep at
    two git SHAs.  Identical row sets produce an empty diff."""
    fv_old = frontier_view(rows_old, axes)
    fv_new = frontier_view(rows_new, axes)
    entered: Dict[Tuple[str, str], List[str]] = {}
    left: Dict[Tuple[str, str], List[str]] = {}
    changed: Dict[Tuple[str, str], Dict[str, Dict[str, Tuple[float, float, float]]]] = {}
    regressions: List[Dict[str, object]] = []

    for group in sorted(set(fv_old) | set(fv_new)):
        old = {p.ident: p for p in fv_old.get(group, [])}
        new = {p.ident: p for p in fv_new.get(group, [])}
        ent = sorted(set(new) - set(old))
        lft = sorted(set(old) - set(new))
        if ent:
            entered[group] = ent
        if lft:
            left[group] = lft
        for key in sorted(set(old) & set(new)):
            deltas = {}
            for a in axes:
                vo, vn = old[key].axes[a], new[key].axes[a]
                if vo != vn:
                    deltas[a] = (vo, vn, vn - vo)
                    if vn > vo:
                        regressions.append({
                            "group": group, "config_key": key, "axis": a,
                            "old": vo, "new": vn, "delta": vn - vo})
            if deltas:
                changed.setdefault(group, {})[key] = deltas
        # a config leaving the frontier while the group still exists on
        # both sides means something newly dominates it — that is the
        # frontier-level regression signal even if its own counters
        # didn't move
        for key in lft:
            if group in fv_new:
                dominators = [p.config_key for p in fv_new[group]
                              if all(p.axes[a] <= old[key].axes[a]
                                     for a in axes)]
                regressions.append({
                    "group": group, "config_key": key, "axis": "frontier",
                    "old": 1.0, "new": 0.0, "delta": -1.0,
                    "dominated_by": dominators})
    return FrontierDiff(sha_old=_shas(rows_old), sha_new=_shas(rows_new),
                        entered=entered, left=left, changed=changed,
                        regressions=regressions)


# ---------------------------------------------------------------------------
# Planner accuracy: predicted-vs-measured over the plan-telemetry table.
# ---------------------------------------------------------------------------

#: a planner-preferred shape must be this much slower than the measured
#: best before the group counts as a mis-plan (timer noise guard)
MISPLAN_SLACK = 1.05


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (deterministic, no
    interpolation surprises across numpy versions)."""
    i = int(round(q * (len(sorted_vals) - 1)))
    return sorted_vals[min(len(sorted_vals) - 1, max(0, i))]


def planner_view(plan_rows: Sequence[PlanRow]) -> Dict[str, object]:
    """Planner accuracy over plan-telemetry rows, as a plain dict.

    * ``ratio`` — distribution of measured-wall / predicted-cost over warm
      (non-compile) invocations: the cost model's absolute scale error.
      A tight band means the profile describes the host; a wide one is
      the drift the calibrate CLI exists to fix.
    * ``regret`` — for every (engine, workload, n, batch, host) group
      observed at two or more (S, T) shapes: the measured wall of the
      shape the cost model *prefers* (min predicted) minus the measured
      best — 0 when the planner picked the fastest shape seen.
    * ``misplans`` — the groups where a rejected shape measured faster
      than the preferred one by more than :data:`MISPLAN_SLACK`, naming
      both engine keys.
    * ``scatter`` — (predicted_us, wall_us) warm points for the
      predicted-vs-measured figure.

    Pure function, deterministic ordering, like every gold view.
    """
    warm = [r for r in plan_rows
            if not r.compiled and r.predicted_us and r.predicted_us > 0
            and r.wall_s and r.wall_s > 0]
    ratios = sorted(r.wall_s * 1e6 / r.predicted_us for r in warm)
    scatter = sorted(
        ({"engine": r.engine, "engine_key": r.engine_key,
          "workload": r.workload, "predicted_us": r.predicted_us,
          "wall_us": r.wall_s * 1e6,
          "calib_fingerprint": r.calib_fingerprint}
         for r in warm),
        key=lambda d: (d["engine"], d["engine_key"], d["predicted_us"],
                       d["wall_us"]))

    # fastest observation per (group, shape); groups seen at >= 2 shapes
    # are the only places measured regret is observable
    groups: Dict[Tuple, Dict[Tuple[int, int], PlanRow]] = {}
    for r in warm:
        shape = (int(r.shards or 1), int(r.t_segments or 1))
        g = groups.setdefault((r.engine, r.workload, r.n, r.batch,
                               r.host_id), {})
        cur = g.get(shape)
        if cur is None or r.wall_s < cur.wall_s:
            g[shape] = r

    regret: List[Dict[str, object]] = []
    misplans: List[Dict[str, object]] = []
    multi_shape_groups = 0
    for gk in sorted(groups):
        shapes = groups[gk]
        if len(shapes) < 2:
            continue
        multi_shape_groups += 1
        pref = min(shapes, key=lambda s: (shapes[s].predicted_us, s))
        best = min(shapes, key=lambda s: (shapes[s].wall_s, s))
        regret_us = (shapes[pref].wall_s - shapes[best].wall_s) * 1e6
        engine, workload, n, batch, hid = gk
        entry = {
            "engine": engine, "workload": workload, "n": n,
            "batch": batch, "host_id": hid,
            "preferred": {"shards": pref[0], "t_segments": pref[1],
                          "engine_key": shapes[pref].engine_key,
                          "predicted_us": shapes[pref].predicted_us,
                          "wall_us": shapes[pref].wall_s * 1e6},
            "best": {"shards": best[0], "t_segments": best[1],
                     "engine_key": shapes[best].engine_key,
                     "predicted_us": shapes[best].predicted_us,
                     "wall_us": shapes[best].wall_s * 1e6},
            "regret_us": regret_us,
            "shapes_seen": len(shapes),
        }
        regret.append(entry)
        if pref != best and shapes[pref].wall_s \
                > shapes[best].wall_s * MISPLAN_SLACK:
            misplans.append(entry)

    view: Dict[str, object] = {
        "records": len(list(plan_rows)),
        "warm": len(warm),
        "profiles": sorted({r.calib_fingerprint or "unknown"
                            for r in plan_rows}),
        "ratio": None,
        "groups": multi_shape_groups,
        "regret": regret,
        "misplans": misplans,
        "scatter": scatter,
    }
    if ratios:
        view["ratio"] = {
            "n": len(ratios),
            "min": ratios[0],
            "p10": _percentile(ratios, 0.10),
            "median": _percentile(ratios, 0.50),
            "p90": _percentile(ratios, 0.90),
            "max": ratios[-1],
        }
    return view
