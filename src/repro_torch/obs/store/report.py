"""Report layer: render the gold views to markdown and figures (a port of
the reference package's ``repro.obs.store.report``).

Everything here takes silver rows / gold views and returns strings or
file paths, so tests can exercise rendering without touching disk layout
decisions.  Figures are matplotlib-import-gated — the markdown report is
the contract, the PNGs are a bonus (the card's machine has no
matplotlib, and there they return nothing).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from .gold import (AXES, FrontierDiff, FrontierPoint, best_configs,
                   frontier_view, planner_view)
from .silver import PlanRow, SilverRow, SilverStore

_AXIS_LABEL = {
    "runtime_cycles": "runtime (cycles)",
    "traffic_bytes": "DRAM+SCM traffic (B)",
    "probe_bytes": "probe traffic (B)",
}


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return f"{int(v):,}"
    return f"{v:.6g}"


def _cfg_str(cfg: Optional[Dict[str, object]]) -> str:
    if not cfg:
        return "—"
    return " ".join(f"{k}={v}" for k, v in sorted(cfg.items())
                    if v is not None) or "—"


def render_markdown(store: SilverStore,
                    diff: Optional[FrontierDiff] = None,
                    axes: Sequence[str] = AXES) -> str:
    """The full design-space report: store summary, per-group Pareto
    frontiers, best-config table, and (optionally) the cross-PR diff."""
    rows = store.rows()
    s = store.summary()
    out: List[str] = ["# Design-space report", ""]
    out += [
        f"- rows: **{s['rows']}** across {len(s['workloads'])} workload(s), "
        f"{len(s['git_shas'])} commit(s), {len(s['hosts'])} host(s)",
        f"- engines: {', '.join(s['engines']) or '—'}",
        f"- sources: {len(s['sources'])} bronze feed(s)",
        "",
    ]

    fv = frontier_view(rows, axes)
    out.append("## Pareto frontiers")
    out.append("")
    if not fv:
        out.append("_No rows carry all frontier axes "
                   f"({', '.join(axes)}) — ingest a benchmark artifact._")
        out.append("")
    for (workload, policy), front in fv.items():
        n_cand = len([r for r in rows
                      if r.workload == workload
                      and (r.policy or r.engine) == policy
                      and FrontierPoint.from_row(r, axes)])
        out.append(f"### {workload} / {policy} — {len(front)} of "
                   f"{n_cand} configs on the frontier")
        out.append("")
        head = ["config", *[_AXIS_LABEL.get(a, a) for a in axes], "key"]
        out.append("| " + " | ".join(head) + " |")
        out.append("|" + "---|" * len(head))
        for p in front:
            out.append("| " + " | ".join(
                [_cfg_str(p.config),
                 *[_fmt(p.axes[a]) for a in axes],
                 f"`{p.config_key}`"]) + " |")
        out.append("")

    best = best_configs(rows, axes=axes)
    if best:
        out.append("## Best config per workload (min runtime on frontier)")
        out.append("")
        out.append("| workload | config | " +
                   " | ".join(_AXIS_LABEL.get(a, a) for a in axes) + " |")
        out.append("|" + "---|" * (2 + len(axes)))
        for workload in sorted(best):
            p = best[workload]
            out.append("| " + " | ".join(
                [workload, _cfg_str(p.config),
                 *[_fmt(p.axes[a]) for a in axes]]) + " |")
        out.append("")

    plans = store.plan_rows()
    if plans:
        out += render_planner_markdown(planner_view(plans))

    if diff is not None:
        out += render_diff_markdown(diff)
    return "\n".join(out)


def render_planner_markdown(view: Dict[str, object]) -> List[str]:
    """The planner-accuracy section (see ``gold.planner_view``) as
    markdown lines: prediction-scale distribution, measured plan regret,
    and the mis-plan table."""
    out = ["## Planner accuracy", ""]
    profiles = ", ".join(f"`{p}`" for p in view["profiles"]) or "—"
    out.append(f"- plan records: **{view['records']}** "
               f"({view['warm']} warm) under profile(s) {profiles}")
    ratio = view["ratio"]
    if ratio:
        out.append(
            f"- measured wall / predicted cost (warm): median "
            f"**{ratio['median']:.2f}x**, p10 {ratio['p10']:.2f}x, "
            f"p90 {ratio['p90']:.2f}x, range "
            f"[{ratio['min']:.2f}x, {ratio['max']:.2f}x] "
            f"over {ratio['n']} runs")
    out.append(f"- groups observed at ≥ 2 (S, T) shapes: "
               f"**{view['groups']}** — mis-planned: "
               f"**{len(view['misplans'])}**")
    out.append("")
    regret = view["regret"]
    if regret:
        zero = sum(1 for e in regret if e["regret_us"] <= 0.0)
        worst = max(e["regret_us"] for e in regret)
        out.append(f"- measured regret: {zero}/{len(regret)} groups picked "
                   f"the fastest shape seen; worst regret "
                   f"{worst / 1e3:.2f} ms")
        out.append("")
    if view["misplans"]:
        out.append("| engine | workload | n | batch | preferred (S,T) | "
                   "faster (S,T) | regret | preferred key | faster key |")
        out.append("|" + "---|" * 9)
        for e in view["misplans"]:
            p, b = e["preferred"], e["best"]
            out.append(
                f"| {e['engine']} | {e['workload']} | {e['n']} "
                f"| {e['batch']} "
                f"| S{p['shards']}T{p['t_segments']} "
                f"({p['wall_us'] / 1e3:.2f} ms) "
                f"| S{b['shards']}T{b['t_segments']} "
                f"({b['wall_us'] / 1e3:.2f} ms) "
                f"| {e['regret_us'] / 1e3:.2f} ms "
                f"| `{p['engine_key']}` | `{b['engine_key']}` |")
        out.append("")
    elif regret:
        out.append("_No mis-plans: every multi-shape group's preferred "
                   "shape measured fastest (within slack)._")
        out.append("")
    return out


def render_diff_markdown(diff: FrontierDiff) -> List[str]:
    """The cross-PR frontier regression section as markdown lines."""
    out = [f"## Cross-PR frontier diff: `{diff.sha_old[:12]}` → "
           f"`{diff.sha_new[:12]}`", ""]
    if diff.empty:
        out += ["**Frontiers identical** — model counters are bit-stable "
                "across the two runs.", ""]
        return out
    s = diff.summary()
    out += [f"- configs entered a frontier: {s['groups_entered']}",
            f"- configs left a frontier: {s['groups_left']}",
            f"- frontier configs with moved axes: {s['configs_changed']}",
            f"- **regressions: {s['regressions']}**", ""]
    for group, keys in sorted(diff.entered.items()):
        out.append(f"- `{group[0]}/{group[1]}` entered: "
                   + ", ".join(f"`{k}`" for k in keys))
    for group, keys in sorted(diff.left.items()):
        out.append(f"- `{group[0]}/{group[1]}` left: "
                   + ", ".join(f"`{k}`" for k in keys))
    if diff.entered or diff.left:
        out.append("")
    if any(diff.changed.values()):
        out.append("| group | config | axis | old | new | delta |")
        out.append("|---|---|---|---|---|---|")
        for group, cfgs in sorted(diff.changed.items()):
            for key, axes_d in sorted(cfgs.items()):
                for a, (vo, vn, dv) in sorted(axes_d.items()):
                    out.append(f"| {group[0]}/{group[1]} | `{key}` | {a} "
                               f"| {_fmt(vo)} | {_fmt(vn)} | {dv:+.6g} |")
        out.append("")
    return out


def render_figures(rows: Sequence[SilverRow], out_dir: str,
                   axes: Sequence[str] = AXES) -> List[str]:
    """One design-space scatter per workload: every candidate config in
    grey, per-policy frontiers traced in the repo palette.  X = total
    traffic, Y = runtime; probe traffic (the third axis) scales marker
    size, so off-trace frontier membership stays visually explicable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return []

    palette = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4",
               "#008300"]
    os.makedirs(out_dir, exist_ok=True)
    fv = frontier_view(rows, axes)
    workloads = sorted({w for (w, _) in fv})
    paths: List[str] = []
    for workload in workloads:
        pts: List[Tuple[str, FrontierPoint, bool]] = []
        for (w, policy), front in fv.items():
            if w != workload:
                continue
            on = {p.config_key for p in front}
            for row in rows:
                if row.workload != w or (row.policy or row.engine) != policy:
                    continue
                p = FrontierPoint.from_row(row, axes)
                if p is not None:
                    pts.append((policy, p, p.config_key in on))
        if not pts:
            continue
        fig, ax = plt.subplots(figsize=(5.2, 3.6), dpi=150)
        ax.grid(True, color="#e5e4df", linewidth=0.8, zorder=0)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
        probes = [p.axes.get("probe_bytes", 0.0) for _, p, _ in pts]
        pmax = max(probes) or 1.0
        policies = sorted({pol for pol, _, _ in pts})
        for i, policy in enumerate(policies):
            color = palette[i % len(palette)]
            dom = [(p, pb) for (pol, p, onf), pb in zip(pts, probes)
                   if pol == policy and not onf]
            fro = [(p, pb) for (pol, p, onf), pb in zip(pts, probes)
                   if pol == policy and onf]
            if dom:
                ax.scatter([p.axes["traffic_bytes"] for p, _ in dom],
                           [p.axes["runtime_cycles"] for p, _ in dom],
                           s=[12 + 40 * pb / pmax for _, pb in dom],
                           color="#b5b4af", alpha=0.6, zorder=2)
            if fro:
                fro.sort(key=lambda t: t[0].axes["traffic_bytes"])
                ax.plot([p.axes["traffic_bytes"] for p, _ in fro],
                        [p.axes["runtime_cycles"] for p, _ in fro],
                        color=color, linewidth=1.2, alpha=0.7, zorder=3)
                ax.scatter([p.axes["traffic_bytes"] for p, _ in fro],
                           [p.axes["runtime_cycles"] for p, _ in fro],
                           s=[18 + 40 * pb / pmax for _, pb in fro],
                           color=color, zorder=4, label=policy)
        ax.set_xlabel("DRAM+SCM traffic (bytes)", color="#3d3d38")
        ax.set_ylabel("runtime (cycles)", color="#3d3d38")
        ax.set_title(f"Design space — {workload} (marker ∝ probe traffic)",
                     fontsize=10, loc="left", color="#1a1a19")
        ax.legend(fontsize=7, frameon=False)
        path = os.path.join(out_dir, f"frontier_{workload}.png")
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
        paths.append(path)
    return paths


def render_planner_figure(plan_rows: Sequence[PlanRow],
                          out_dir: str) -> Optional[str]:
    """Predicted-vs-measured scatter (log-log, one color per engine, the
    y = x perfect-prediction line dashed) from the plan-telemetry table.
    Returns the PNG path, or None without matplotlib / warm points."""
    view = planner_view(plan_rows)
    scatter = view["scatter"]
    if not scatter:
        return None
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None

    palette = {"hms": "#2a78d6", "um": "#eb6834"}
    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(5.2, 3.6), dpi=150)
    ax.grid(True, color="#e5e4df", linewidth=0.8, zorder=0)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for engine in sorted({d["engine"] for d in scatter}):
        pts = [d for d in scatter if d["engine"] == engine]
        ax.scatter([d["predicted_us"] for d in pts],
                   [d["wall_us"] for d in pts],
                   s=14, alpha=0.75, zorder=3,
                   color=palette.get(engine, "#1baf7a"), label=engine)
    lo = min(min(d["predicted_us"] for d in scatter),
             min(d["wall_us"] for d in scatter))
    hi = max(max(d["predicted_us"] for d in scatter),
             max(d["wall_us"] for d in scatter))
    ax.plot([lo, hi], [lo, hi], color="#b5b4af", linewidth=1.0,
            linestyle="--", zorder=2, label="wall = predicted")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("predicted plan cost (us)", color="#3d3d38")
    ax.set_ylabel("measured wall (us)", color="#3d3d38")
    ratio = view["ratio"]
    sub = f" (median {ratio['median']:.2f}x)" if ratio else ""
    ax.set_title(f"Planner accuracy — predicted vs measured{sub}",
                 fontsize=10, loc="left", color="#1a1a19")
    ax.legend(fontsize=7, frameon=False)
    path = os.path.join(out_dir, "planner_accuracy.png")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path
