"""Silver layer: one normalized, deduplicated store over every bronze
source the repo emits (a port of the reference package's
``repro.obs.store.silver``: the same rows, keys and merge rules, so the
port's ledgers, the reference's ledgers and the committed ``BENCH_*.json``
artifacts ingest into one store side by side).

Bronze evidence is heterogeneous: run-ledger JSONL (raw per-lane engine
counters), ``BENCH_*.json`` artifacts (finished model outputs + runtime
cycles per sweep point), and resumable-sweep checkpoint journals (raw
counters keyed by trace/config).  Silver joins them into one row space
keyed by

    (trace fingerprint, config key, git SHA, host id)

with the *full* model counters carried on every row — scalar totals or
per-phase float64 vectors, whichever the richest source provided — plus
derived traffic metrics that are pure functions of those counters.

Normalization rules:

* A row ingested twice (same key, same counters) is a duplicate: no-op.
  Re-ingesting a bronze source against a warm store adds nothing.
* The same point seen through two sources merges: shared counter keys
  must agree on whole-trace totals bit-for-bit (the engines' parity
  guarantee — per-phase vectors are checked via their exact sums), the
  per-phase form wins over the scalar form, and missing fields (config
  knobs, runtime metric) fill in from whichever source has them.
* A totals mismatch on the same key is a *conflict*: the first row is
  kept, the ingest counts it, and a :class:`RuntimeWarning` fires —
  silent overwrites would hide exactly the drift the store exists to
  expose.

Persistence is append-only JSONL (``silver.jsonl`` under the store dir,
default from ``REPRO_STORE_DIR``, else ``build/store`` at the checkout
root); merged rows append a superseding line
and the load path replays lines through the same merge logic, so the
in-memory index converges to the same state in any replay order.

Next to the counter rows, silver keeps a second table of
:class:`PlanRow` — the schema-4 plan-regret telemetry (predicted cost of
the chosen (S, T), the cheapest rejected alternatives, measured wall,
calibration fingerprint) per engine invocation — which the gold layer's
planner-accuracy view is computed over.  Plan rows are host-dependent by
nature, so they dedupe on invocation identity and never merge.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import warnings
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

SILVER_SCHEMA_VERSION = 1

# host identity: the stable subset of obs.host_metadata() that describes
# the machine + toolchain (cost-model constants and env knobs excluded —
# they vary per run, not per host).  The reference's keys always count;
# the port's (its torch, the card, the call's device) count only where a
# block has them, so a reference record keeps the id the reference's
# store gives it and a card run differs from a CPU run.
_HOST_ID_KEYS = ("platform", "machine", "cpu_count", "python", "jax",
                 "jax_backend")
_PORT_HOST_KEYS = ("torch", "torch_cuda", "gpu", "device")


def host_id(host: Optional[Mapping[str, object]]) -> str:
    """Stable 12-hex id of a host-metadata block (ledger record ``host``
    field or a benchmark artifact's ``host`` section)."""
    host = host or {}
    ident = {k: host.get(k) for k in _HOST_ID_KEYS}
    ident.update({k: host[k] for k in _PORT_HOST_KEYS if k in host})
    blob = json.dumps(ident, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def counter_totals(counters: Mapping[str, object]) -> Dict[str, float]:
    """Whole-trace totals of an encoded counter dict: scalars pass
    through, per-phase lists reduce by the same float64 ``np.sum`` the
    engines define totals with — so totals from a per-phase row equal the
    scalar row's values bit-for-bit."""
    out = {}
    for k, v in counters.items():
        a = np.asarray(v, np.float64)
        out[k] = float(np.sum(a)) if a.ndim else float(a)
    return out


def _column_bytes() -> int:
    from ...core.timing import COLUMN_BYTES    # lazy: obs import rule
    return COLUMN_BYTES


def derive_metrics(counters: Mapping[str, object]) -> Dict[str, float]:
    """Pareto-axis metrics that are pure functions of the model counters
    (bit-derived: every term is a float64 sum of counters times the
    32-byte column constant).  HMS/single-tier rows get bus-traffic axes;
    UM rows get fault/migration volumes."""
    t = counter_totals(counters)
    m: Dict[str, float] = {}
    if "demand_dram_rd" in t:
        cb = _column_bytes()
        dram_cols = (t["demand_dram_rd"] + t["demand_dram_wr"]
                     + t.get("probe_cols", 0.0) + t.get("meta_wr_cols", 0.0)
                     + t.get("fill_dram_wr", 0.0) + t.get("wb_dram_rd", 0.0))
        scm_cols = (t["demand_scm_rd"] + t["demand_scm_wr"]
                    + t.get("fill_scm_rd", 0.0) + t.get("wb_scm_wr", 0.0))
        m["dram_bytes"] = dram_cols * cb
        m["scm_bytes"] = scm_cols * cb
        m["traffic_bytes"] = (dram_cols + scm_cols) * cb
        m["probe_bytes"] = (t.get("probe_cols", 0.0)
                            + t.get("meta_wr_cols", 0.0)) * cb
        m["scm_write_cols"] = t["demand_scm_wr"] + t.get("wb_scm_wr", 0.0)
    if "um_faults" in t:
        m["um_faults"] = t["um_faults"]
        m["um_migrated_pages"] = t.get("um_migrated", 0.0)
        m["um_writeback_pages"] = t.get("um_writebacks", 0.0)
    return m


@dataclasses.dataclass
class SilverRow:
    """One (trace, config, commit, host) point with its full counters."""

    trace_fp: str                  # 16-hex trace content fingerprint
    config_key: str                # HMS config digest / UM spec key
    git_sha: str                   # 40-hex, or "unknown"
    host_id: str                   # 12-hex host identity
    engine: str                    # "hms" | "um" | "single_tier"
    workload: str                  # trace / scenario name
    n: int
    phases: int
    policy: Optional[str]
    config: Optional[Dict[str, object]]   # human-readable knobs, if known
    counters: Dict[str, object]    # full model counters (scalars / lists)
    metrics: Dict[str, float]      # derived axes (+ runtime_cycles if known)
    sources: List[str]             # provenance: every feed that contributed
    ts: float = 0.0
    schema: int = SILVER_SCHEMA_VERSION

    @property
    def key(self) -> Tuple[str, str, str, str]:
        return (self.trace_fp, self.config_key, self.git_sha, self.host_id)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "SilverRow":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass
class PlanRow:
    """One engine invocation's plan-regret telemetry (schema-4 ledger
    fields, normalized): what the cost model predicted for the shape it
    chose, what it predicted for the cheapest rejected shapes, and what
    the run actually measured."""

    engine: str                    # "hms" | "um"
    engine_key: str                # fingerprint of the planned shape
    workload: str                  # trace name
    n: int
    batch: int
    shards: Optional[int]
    t_segments: Optional[int]
    predicted_us: float
    alternatives: List[Dict[str, object]]   # ascending predicted cost
    wall_s: float
    compiled: bool
    ladder_rung: Optional[str]
    calib_fingerprint: Optional[str]
    git_sha: str
    host_id: str
    ts: float = 0.0
    schema: int = SILVER_SCHEMA_VERSION

    @property
    def key(self) -> str:
        """Invocation identity: same record ingested twice is one row."""
        blob = json.dumps([self.engine_key, self.git_sha, self.host_id,
                           self.ts, self.wall_s], sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    @property
    def best_alternative_us(self) -> Optional[float]:
        alts = [a.get("predicted_us") for a in self.alternatives
                if a.get("predicted_us") is not None]
        return min(alts) if alts else None

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["table"] = "plan"
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "PlanRow":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def _counters_compatible(a: Mapping[str, object],
                         b: Mapping[str, object]) -> bool:
    """Shared counter keys must agree on whole-trace totals bit-for-bit."""
    ta, tb = counter_totals(a), counter_totals(b)
    return all(ta[k] == tb[k] for k in set(ta) & set(tb))


def _merge_counters(a: Dict[str, object],
                    b: Mapping[str, object]) -> Dict[str, object]:
    """Union of two compatible counter dicts; per-phase lists win over
    scalar totals (they carry strictly more information and sum back to
    the same float64 totals by construction)."""
    out = dict(a)
    for k, v in b.items():
        if k not in out or (isinstance(v, list)
                            and not isinstance(out[k], list)):
            out[k] = v
    return out


@dataclasses.dataclass
class IngestStats:
    """Outcome of one ingest pass.  ``added + merged == 0`` means the
    source was a complete no-op against the store (the dedup contract)."""

    source: str = ""
    added: int = 0
    merged: int = 0
    dups: int = 0
    conflicts: int = 0
    skipped: int = 0      # rows a pre-store source could not provide

    def __str__(self) -> str:
        return (f"{self.source}: +{self.added} added, {self.merged} merged, "
                f"{self.dups} duplicate, {self.conflicts} conflict, "
                f"{self.skipped} skipped")


class SilverStore:
    """Normalized, deduplicated row store with optional JSONL persistence.

    ``path=None`` keeps the store in memory (tests, one-shot gating);
    a directory loads/appends ``silver.jsonl`` inside it.
    """

    def __init__(self, path: Optional[str] = None):
        self.dir = None if path is None else str(path)
        self.path = None
        self._rows: Dict[Tuple[str, str, str, str], SilverRow] = {}
        self._plans: Dict[str, PlanRow] = {}
        self._stream = None
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
            self.path = os.path.join(self.dir, "silver.jsonl")
            if os.path.exists(self.path):
                self._load()
            self._stream = open(self.path, "a")

    def _load(self) -> None:
        bad = 0
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                    if d.get("table") == "plan":
                        self._absorb_plan(PlanRow.from_dict(d),
                                          persist=False)
                        continue
                    row = SilverRow.from_dict(d)
                except (ValueError, TypeError):
                    bad += 1        # torn tail from a killed writer
                    continue
                self._absorb(row, persist=False)
        if bad:
            warnings.warn(
                f"SilverStore({self.path!r}): skipped {bad} torn/corrupt "
                "line(s)", RuntimeWarning, stacklevel=2)

    # -- core --------------------------------------------------------------

    def rows(self) -> List[SilverRow]:
        """Snapshot of all rows, in deterministic key order."""
        return [self._rows[k] for k in sorted(self._rows)]

    def plan_rows(self) -> List[PlanRow]:
        """Snapshot of the plan-telemetry table, in deterministic order."""
        return [self._plans[k] for k in sorted(self._plans)]

    def __len__(self) -> int:
        return len(self._rows)

    def _absorb_plan(self, row: PlanRow, persist: bool = True) -> str:
        """Add one plan row; returns 'added' | 'dup' (plans never merge:
        two invocations are two observations, one record twice is one)."""
        k = row.key
        if k in self._plans:
            return "dup"
        self._plans[k] = row
        if persist and self._stream is not None:
            self._stream.write(json.dumps(row.to_dict(), default=float)
                               + "\n")
            self._stream.flush()
        return "added"

    def _absorb(self, row: SilverRow, persist: bool = True) -> str:
        """Add/merge one row; returns 'added' | 'merged' | 'dup' |
        'conflict'."""
        cur = self._rows.get(row.key)
        if cur is None:
            if not row.ts:
                row.ts = time.time()
            self._rows[row.key] = row
            if persist:
                self._persist(row)
            return "added"
        if not _counters_compatible(cur.counters, row.counters):
            warnings.warn(
                f"silver conflict at {row.key}: counter totals differ "
                "across sources for the same (trace, config, sha, host) — "
                "keeping the first row", RuntimeWarning, stacklevel=3)
            return "conflict"
        merged_counters = _merge_counters(cur.counters, row.counters)
        merged_metrics = {**row.metrics, **cur.metrics}
        merged_sources = cur.sources + [s for s in row.sources
                                        if s not in cur.sources]
        changed = (merged_counters != cur.counters
                   or merged_metrics != cur.metrics
                   or cur.config is None and row.config is not None)
        if not changed and merged_sources == cur.sources:
            return "dup"
        cur.counters = merged_counters
        cur.metrics = {**merged_metrics,
                       **derive_metrics(merged_counters)}
        cur.sources = merged_sources
        if cur.config is None:
            cur.config = row.config
        if cur.policy is None:
            cur.policy = row.policy
        if changed:
            if persist:
                self._persist(cur)
            return "merged"
        return "dup"

    def _persist(self, row: SilverRow) -> None:
        if self._stream is not None:
            self._stream.write(json.dumps(row.to_dict(), default=float)
                               + "\n")
            self._stream.flush()

    def add(self, row: SilverRow) -> str:
        return self._absorb(row)

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    # -- ingest: bronze feeds ----------------------------------------------

    def ingest(self, path: str) -> IngestStats:
        """Auto-detecting ingest: run-ledger JSONL, sweep-checkpoint
        JSONL, or a ``BENCH_*.json`` artifact."""
        base = os.path.basename(path)
        if os.path.isdir(path):
            path = os.path.join(path, "ledger.jsonl")
            base = "ledger.jsonl"
        if base.endswith(".jsonl"):
            if "sweep_ckpt" in base:
                return self.ingest_ckpt(path)
            return self.ingest_ledger(path)
        return self.ingest_bench(path)

    def _tally(self, stats: IngestStats, outcome: str) -> None:
        if outcome == "added":
            stats.added += 1
        elif outcome == "merged":
            stats.merged += 1
        elif outcome == "conflict":
            stats.conflicts += 1
        else:
            stats.dups += 1

    def ingest_ledger(self, path: str) -> IngestStats:
        """One row per vmap lane of every schema-3 run record (older
        records, and records from paths that predate full-counter
        emission, are counted as skipped), plus one :class:`PlanRow` per
        schema-4 record that carried plan-regret telemetry."""
        from ..ledger import load_ledger

        stats = IngestStats(source=f"ledger:{os.path.basename(path)}")
        src = f"ledger:{os.path.abspath(path)}"
        for rec in load_ledger(path):
            if rec.plan_predicted_us is not None:
                self._tally(stats, self._absorb_plan(PlanRow(
                    engine=rec.engine, engine_key=rec.engine_key,
                    workload=rec.trace, n=rec.n, batch=rec.batch,
                    shards=rec.shards, t_segments=rec.t_segments,
                    predicted_us=rec.plan_predicted_us,
                    alternatives=list(rec.plan_alternatives or []),
                    wall_s=rec.wall_s, compiled=rec.compiled,
                    ladder_rung=rec.ladder_rung,
                    calib_fingerprint=rec.calib_fingerprint,
                    git_sha=rec.git_sha or "unknown",
                    host_id=host_id(rec.host), ts=rec.ts)))
            if not (rec.trace_fp and rec.config_digests and rec.counters):
                stats.skipped += 1
                continue
            policy = None
            parts = rec.engine_key.split(":")
            if rec.engine in ("hms", "single_tier") and len(parts) >= 2:
                policy = parts[1]
            for ck, counters in zip(rec.config_digests, rec.counters):
                row = SilverRow(
                    trace_fp=rec.trace_fp, config_key=ck,
                    git_sha=rec.git_sha or "unknown",
                    host_id=host_id(rec.host),
                    engine=rec.engine, workload=rec.trace, n=rec.n,
                    phases=rec.phases, policy=policy, config=None,
                    counters=dict(counters),
                    metrics=derive_metrics(counters),
                    sources=[src], ts=rec.ts)
                self._tally(stats, self._absorb(row))
        return stats

    def ingest_ckpt(self, path: str) -> IngestStats:
        """Sweep-checkpoint journal rows.  The journal stores no identity
        beyond (kind, trace fp, config key) — it is a local crash-recovery
        artifact — so rows are stamped with the ingesting process's git
        SHA and host id."""
        from ... import obs

        stats = IngestStats(source=f"ckpt:{os.path.basename(path)}")
        src = f"ckpt:{os.path.abspath(path)}"
        sha = obs.git_info().get("git_sha") or "unknown"
        hid = host_id(obs.host_metadata())
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    stats.skipped += 1        # torn tail
                    continue
                counters = rec.get("counters") or {}
                phases = max([len(v) for v in counters.values()
                              if isinstance(v, list)] or [1])
                row = SilverRow(
                    trace_fp=rec["trace"], config_key=rec["key"],
                    git_sha=sha, host_id=hid,
                    engine=rec.get("kind", "hms"), workload="unknown",
                    n=0, phases=phases, policy=None, config=None,
                    counters=dict(counters),
                    metrics=derive_metrics(counters),
                    sources=[src])
                self._tally(stats, self._absorb(row))
        return stats

    def ingest_bench(self, path: str) -> IngestStats:
        """A ``BENCH_*.json`` artifact: sweep (per-point counters +
        runtime over a config grid), scenarios (per-oversub points), or
        um (per-spec paging points).  Artifacts written before the store
        landed lack the identity fields and count as skipped."""
        with open(path) as f:
            art = json.load(f)
        stats = IngestStats(source=f"bench:{os.path.basename(path)}")
        src = f"bench:{os.path.abspath(path)}"
        host = art.get("host") or {}
        sha = host.get("git_sha") or "unknown"
        hid = host_id(host)

        def absorb(**kw):
            self._tally(stats, self._absorb(
                SilverRow(git_sha=sha, host_id=hid, sources=[src], **kw)))

        if "scenarios" in art:
            for name, d in (art["scenarios"] or {}).items():
                for p in d.get("sweep", []):
                    if not (p.get("trace_fp") and p.get("config_digest")
                            and p.get("counters")):
                        stats.skipped += 1
                        continue
                    metrics = derive_metrics(p["counters"])
                    if p.get("runtime_cycles") is not None:
                        metrics["runtime_cycles"] = p["runtime_cycles"]
                    absorb(trace_fp=p["trace_fp"],
                           config_key=p["config_digest"],
                           engine="hms", workload=name, n=d.get("n", 0),
                           phases=len(d.get("phase_names", [])) or 1,
                           policy="hms",
                           config={"oversub": p.get("oversub")},
                           counters=dict(p["counters"]), metrics=metrics)
            return stats

        grid = art.get("grid")
        for name, d in (art.get("workloads") or {}).items():
            if "point_counters" in d:             # sweep artifact
                digests = d.get("point_config_digests") or []
                runtimes = d.get("point_runtime_cycles") or []
                tfp = d.get("trace_fp")
                if not (tfp and digests):
                    stats.skipped += len(d["point_counters"])
                    continue
                for i, counters in enumerate(d["point_counters"]):
                    cfg = grid[i] if grid and i < len(grid) else None
                    metrics = derive_metrics(counters)
                    if i < len(runtimes):
                        metrics["runtime_cycles"] = runtimes[i]
                    absorb(trace_fp=tfp, config_key=digests[i],
                           engine="hms", workload=name, n=d.get("n", 0),
                           phases=1,
                           policy=(cfg or {}).get("policy", "hms"),
                           config=cfg, counters=dict(counters),
                           metrics=metrics)
            elif isinstance(d.get("points"), list):   # um artifact
                                                      # (sweep's "points"
                                                      # is an int count)
                tfp = d.get("trace_fp")
                for p in d["points"]:
                    if not (tfp and p.get("spec_key")
                            and p.get("counters")):
                        stats.skipped += 1
                        continue
                    metrics = derive_metrics(p["counters"])
                    metrics["um_link_bytes"] = p.get("link_bytes", 0.0)
                    absorb(trace_fp=tfp, config_key=p["spec_key"],
                           engine="um", workload=name, n=d.get("n", 0),
                           phases=1, policy=None,
                           config={"rel_footprint": p.get("rel_footprint"),
                                   "nvlink": p.get("nvlink")},
                           counters=dict(p["counters"]), metrics=metrics)
            else:
                stats.skipped += 1
        return stats

    # -- summaries ---------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        rows = self.rows()
        return {
            "rows": len(rows),
            "plan_rows": len(self._plans),
            "workloads": sorted({r.workload for r in rows}),
            "engines": sorted({r.engine for r in rows}),
            "git_shas": sorted({r.git_sha for r in rows}),
            "hosts": sorted({r.host_id for r in rows}),
            "sources": sorted({s for r in rows for s in r.sources}),
        }


def default_store_dir() -> str:
    """``REPRO_STORE_DIR`` or ``build/store`` relative to the checkout the
    package runs from."""
    env = os.environ.get("REPRO_STORE_DIR")
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(here))))
    return os.path.join(root, "build", "store")
