"""Design-space store: the silver/gold layers over the bronze ledger (a
port of the reference package's ``repro.obs.store``, NumPy only).

The obs subsystem's bronze layer is raw, append-only evidence:
per-invocation run-ledger JSONL, ``BENCH_*.json`` benchmark artifacts,
and resumable-sweep checkpoint journals.  Nothing joins them — every
cross-PR or cross-policy question ("did this config leave the Pareto
frontier?", "which knob setting is best for this workload?") had to be
answered by hand.  This package is that join:

* **Silver** (:mod:`.silver`) — one normalized, deduplicated store over
  every bronze source, keyed by ``(trace fingerprint x config key x git
  SHA x host id)``.  Rows carry the full model counters (scalar totals
  or per-phase vectors), merged across sources with bit-for-bit totals
  checks; re-ingesting a source is a no-op.
* **Gold** (:mod:`.gold`) — materialized views over silver: Pareto
  frontiers on ``(runtime_cycles, dram+scm traffic, probe traffic)`` per
  workload x policy, best-config-per-workload tables, cross-PR
  frontier diffs (which configs entered/left the frontier between two
  git SHAs, per-axis deltas), and the planner-accuracy view over the
  schema-4 plan-telemetry table (predicted-vs-measured ratios, measured
  regret, mis-plan table).
* **Report** (:mod:`.report`) — renders the gold views to markdown and
  figures (figures only where matplotlib is installed).

The port reads every bronze source the reference's store reads — its own
ledgers, the reference's ledgers, the committed ``BENCH_*.json``
artifacts and sweep journals — and keeps a port host apart from a
reference host (``host_id``).

Import note: like the rest of ``repro_torch.obs``, nothing here imports
``repro_torch.core`` / ``repro_torch.um`` at module level — derived-metric
constants are fetched lazily at call time.  The package itself is NOT
imported by ``repro_torch.obs.__init__`` (``from repro_torch.obs import
store`` on demand), so the engines' import stays light.  No JAX.
"""

from __future__ import annotations

from .gold import (
    AXES,
    FrontierDiff,
    FrontierPoint,
    best_configs,
    frontier_diff,
    frontier_view,
    pareto,
    planner_view,
)
from .report import (
    render_diff_markdown,
    render_figures,
    render_markdown,
    render_planner_figure,
    render_planner_markdown,
)
from .silver import (
    SILVER_SCHEMA_VERSION,
    IngestStats,
    PlanRow,
    SilverRow,
    SilverStore,
    counter_totals,
    default_store_dir,
    derive_metrics,
    host_id,
)

__all__ = [
    # silver
    "SILVER_SCHEMA_VERSION", "SilverRow", "PlanRow", "SilverStore",
    "IngestStats", "counter_totals", "derive_metrics", "host_id",
    "default_store_dir",
    # gold
    "AXES", "FrontierPoint", "FrontierDiff", "pareto", "frontier_view",
    "best_configs", "frontier_diff", "planner_view",
    # report
    "render_markdown", "render_diff_markdown", "render_figures",
    "render_planner_markdown", "render_planner_figure",
]
