"""Run ledger: one structured :class:`RunRecord` per engine invocation (a
port of the reference package's ``repro.obs.ledger``: the same record, the
same schema and the same digest, so either package's ``load_ledger`` and
design-space store read the other's ledgers).

The ledger is the "bronze" layer of the results store: raw, append-only,
per-run records with enough identity (engine-key fingerprint, git SHA,
host metadata, counter digest) to diff any two runs — across shard
counts, hosts, commits, and the two packages.  A port record's ``host``
names the card and the ``device`` ("cuda" or "cpu") the call ran on.

Lifecycle: disabled by default (record emission costs one ``enabled()``
check on the engine paths and nothing else).  ``enable(path)`` — or the
``REPRO_OBS_DIR`` environment variable at import — turns collection on:
records accumulate in an in-process registry and, when a path is given,
stream to a JSONL file one line per record (flushed per line, so a crashed
run keeps its ledger).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import warnings
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

# 2: resilience fields (ladder_rung / retries / degradations); loading a
# schema-1 ledger leaves them None.
# 3: design-space-store fields (trace_fp / config_digests / counters):
# per-lane model counters in full — not just the 16-hex digest — plus the
# (trace fingerprint, per-lane config key) identity the silver store
# (repro_torch.obs.store) joins runs on.  Older ledgers load with them None.
# 4: plan-regret telemetry (plan_predicted_us / plan_alternatives /
# calib_fingerprint): the cost model's prediction for the chosen (S, T)
# shape, the cheapest rejected shapes, and the calibration profile that
# priced them — next to the measured wall, so planner accuracy is a
# query over the ledger.  Older ledgers load with them None.
SCHEMA_VERSION = 4


def counter_digest(counters) -> str:
    """Stable 64-bit hex digest of a counter vector (or an ordered sequence
    of counter dicts, e.g. one per batched config lane).

    Keys are sorted, values are hashed as raw float64 bytes, so the digest
    is exactly as strict as the engines' bit-for-bit parity guarantees: the
    same trace + config produces the same digest regardless of shard count,
    batch width, or host — and any counter drift changes it.
    """
    h = hashlib.sha256()
    if isinstance(counters, Mapping):
        counters = [counters]
    for c in counters:
        for k in sorted(c):
            h.update(k.encode())
            h.update(np.ascontiguousarray(
                np.asarray(c[k], np.float64)).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class RunRecord:
    """One engine invocation, as the ledger sees it.

    ``engine_key`` is the static-structure fingerprint *including the
    batch width* (the reference's compile unit; the port's string is the
    same).  In the port ``compiled`` marks the call during which the
    kernel library was built or loaded (never on the CPU).  ``counter_digest`` hashes the
    engine's raw counter output (see :func:`counter_digest`); equal digests
    across runs mean bit-for-bit equal counters.
    """

    entry: str                      # public API: simulate / simulate_many /
                                    # simulate_um_many
    engine: str                     # "hms" | "um" | "single_tier"
    trace: str                      # trace name
    n: int                          # trace length (requests)
    phases: int                     # counter segments
    engine_key: str                 # static-structure fingerprint + width
    compiled: bool                  # this call compiled the engine (port:
                                    # built or loaded the kernel library)
    wall_s: float                   # wall of the engine call (incl compile)
    batch: int                      # config lanes run in this call
    counter_digest: str
    # HMS shard plan (None for um / single_tier records)
    shards: Optional[int] = None
    depth: Optional[int] = None     # padded per-shard scan length
    load_imbalance: Optional[float] = None  # shards*depth/n; 1.0 = perfect LPT
    # temporal split (None when the engine ran unsplit T=1 semantics
    # without a stitch; see repro_torch.core.tsplit)
    t_segments: Optional[int] = None    # temporal segments T
    stitch_rounds: Optional[int] = None  # fixed-point rounds incl. warm-up
    replay_prefix: Optional[int] = None  # replay steps per segment boundary
    # UM dedupe accounting (None for hms / single_tier records)
    um_lanes_requested: Optional[int] = None
    um_lanes_run: Optional[int] = None
    um_lanes_deduped: Optional[int] = None
    # resilience (see repro_torch.resilience.guard): which degradation-ladder
    # rung produced the counters, same-rung retries spent, and the
    # structured degradation events walked to get there (None = the
    # planned shape succeeded first try with nothing to report)
    ladder_rung: Optional[str] = None
    retries: Optional[int] = None
    degradations: Optional[List[Dict[str, object]]] = None
    # design-space store feed (see repro_torch.obs.store.silver): the trace
    # content fingerprint, one config key per lane (HMS config digest
    # / UM spec key), and the full per-lane model counters (JSON-safe:
    # float64 scalars, or per-phase lists for phased traces).  None on
    # schema-1/2 records and on paths that predate the store.
    trace_fp: Optional[str] = None
    config_digests: Optional[List[str]] = None
    counters: Optional[List[Dict[str, object]]] = None
    # plan-regret telemetry (see repro_torch.core.costmodel): modeled cost (us)
    # of the (S, T) shape this run planned, the cheapest rejected
    # alternatives ({"shards", "t_segments", "predicted_us"}, ascending),
    # and the fingerprint of the calibration profile that priced them.
    # None on pre-schema-4 records and on paths with nothing to plan.
    plan_predicted_us: Optional[float] = None
    plan_alternatives: Optional[List[Dict[str, object]]] = None
    calib_fingerprint: Optional[str] = None
    # run identity
    git_sha: Optional[str] = None
    git_dirty: Optional[bool] = None
    ts: float = 0.0                 # unix time at completion
    host: Dict[str, object] = dataclasses.field(default_factory=dict)
    schema: int = SCHEMA_VERSION

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "RunRecord":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# ---------------------------------------------------------------------------
# Registry + optional JSONL stream.
# ---------------------------------------------------------------------------

_RECORDS: List[RunRecord] = []
_ENABLED = False
_STREAM = None          # open file object, line-flushed
_DIR: Optional[str] = None


def enabled() -> bool:
    return _ENABLED


def obs_dir() -> Optional[str]:
    """The directory artifacts (ledger, trace export) land in, if any."""
    return _DIR


def ledger_path() -> Optional[str]:
    return _STREAM.name if _STREAM is not None else None


def enable(path: Optional[str] = None) -> None:
    """Turn the ledger on.  ``path`` may be a directory (records stream to
    ``<path>/ledger.jsonl``), a ``*.jsonl`` file, or ``None`` for in-memory
    collection only.  Idempotent; re-enabling with a new path re-targets
    the stream."""
    global _ENABLED, _STREAM, _DIR
    if _STREAM is not None:
        _STREAM.close()
        _STREAM = None
    if path is not None:
        path = str(path)
        if path.endswith(".jsonl"):
            parent = os.path.dirname(path) or "."
            os.makedirs(parent, exist_ok=True)
            _DIR = parent
            _STREAM = open(path, "a")
        else:
            os.makedirs(path, exist_ok=True)
            _DIR = path
            _STREAM = open(os.path.join(path, "ledger.jsonl"), "a")
    else:
        _DIR = None
    _ENABLED = True


def disable() -> None:
    """Stop collecting (records already taken are kept; see
    :func:`clear_records`)."""
    global _ENABLED, _STREAM, _DIR
    if _STREAM is not None:
        _STREAM.close()
        _STREAM = None
    _DIR = None
    _ENABLED = False


def record(rec: RunRecord) -> None:
    """Append one record to the registry (and the JSONL stream, if any).
    Callers gate on :func:`enabled` so building the record itself is
    skipped when the ledger is off."""
    if not _ENABLED:
        return
    if not rec.ts:
        rec.ts = time.time()
    _RECORDS.append(rec)
    if _STREAM is not None:
        _STREAM.write(json.dumps(rec.to_dict(), default=str) + "\n")
        _STREAM.flush()


def records() -> List[RunRecord]:
    """Snapshot of the in-process registry (a copy; mutate freely)."""
    return list(_RECORDS)


def clear_records() -> None:
    _RECORDS.clear()


def load_ledger(path: str) -> List[RunRecord]:
    """Read a JSONL ledger back into :class:`RunRecord` objects.

    Torn or corrupt lines — e.g. the half-flushed tail a SIGKILL'd run
    leaves behind — are skipped with a warning carrying the count, the
    same tolerance ``repro_torch.resilience.sweepckpt`` applies to its journal:
    a crashed run's ledger is still evidence, not an exception."""
    if os.path.isdir(path):
        path = os.path.join(path, "ledger.jsonl")
    out = []
    bad = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except ValueError:
                bad += 1
                continue
            if not isinstance(d, dict):
                bad += 1
                continue
            try:
                out.append(RunRecord.from_dict(d))
            except TypeError:       # not a record shape (missing required)
                bad += 1
    if bad:
        warnings.warn(
            f"load_ledger({path!r}): skipped {bad} torn/corrupt line(s)",
            RuntimeWarning, stacklevel=2)
    return out


def compile_split(recs: Optional[Sequence[RunRecord]] = None
                  ) -> Dict[str, float]:
    """Wall-clock attribution over a set of records: total wall, the share
    spent in calls that compiled (port: built or loaded the kernel
    library), and the share served warm —
    the ledger-level equivalent of the benchmarks' cold/warm split."""
    if recs is None:
        recs = _RECORDS
    compile_s = sum(r.wall_s for r in recs if r.compiled)
    warm_s = sum(r.wall_s for r in recs if not r.compiled)
    return {
        "runs": len(recs),
        "compiled_runs": sum(1 for r in recs if r.compiled),
        "wall_s": compile_s + warm_s,
        "compile_wall_s": compile_s,
        "warm_wall_s": warm_s,
    }
