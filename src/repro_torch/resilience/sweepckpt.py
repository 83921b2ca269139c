"""Resumable sweep checkpoints (a port of the reference package's
``repro.resilience.sweepckpt``; its fingerprints, digests and journal
lines are the reference's, so journals interoperate).

A :class:`SweepCheckpoint` journals every completed per-config engine
result — the raw counter dict of an HMS scan, or the per-phase vectors of
a UM paging point — to an append-only JSONL file, keyed by
``(trace fingerprint, config digest)``.  ``simulate_many`` consults the
journal before running a group and journals each config as its counters
land, so a killed or faulted sweep resumed against the same checkpoint
dir replays journaled points from disk and runs only the remainder.

Bit-exactness: counters are float64 and JSON floats round-trip float64
exactly (``repr``-based serialization), so a resumed sweep's model
outputs — and their ledger digests — are bit-identical to an
uninterrupted run.  Entries are line-flushed; a torn tail line from a
mid-write kill is skipped on load.

Enable via the ``REPRO_SWEEP_CKPT`` env knob at import or
:func:`enable`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import weakref
from typing import Dict, Optional

import numpy as np

_TRACE_FP: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def trace_fingerprint(trace) -> str:
    """Content hash of a trace: name, length, footprint, the full request
    stream, and phase structure.  Cached per trace object."""
    fp = _TRACE_FP.get(trace)
    if fp is None:
        h = hashlib.sha256()
        h.update(repr((trace.name, int(trace.n), int(trace.footprint),
                       tuple(trace.phase_names))).encode())
        h.update(np.ascontiguousarray(
            np.asarray(trace.col, np.int64)).tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(trace.is_write, np.uint8)).tobytes())
        if trace.phase_id is not None:
            h.update(np.ascontiguousarray(
                np.asarray(trace.phase_id, np.int32)).tobytes())
        fp = h.hexdigest()[:16]
        _TRACE_FP[trace] = fp
    return fp


def config_digest(cfg, nvlink: bool = False) -> str:
    """Content hash of a config (every field, nested timing/energy params
    included) plus the link mode.  ``repr``-serialized floats keep the key
    exact."""
    d = dataclasses.asdict(cfg)
    blob = json.dumps({"cfg": d, "nvlink": bool(nvlink)},
                      sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def um_spec_key(spec) -> str:
    """Content key of a UM paging spec — the UM engine's analogue of
    :func:`config_digest`; the obs ledger and the silver store key UM
    lanes with it."""
    return (f"F{int(spec.n_frames)}:c{int(spec.chunk)}"
            f":nv{int(bool(spec.nvlink))}:h{int(spec.hot_thresh)}")


_um_spec_key = um_spec_key


def encode_counters(C: Dict[str, object]) -> Dict[str, object]:
    """Counter dict -> JSON-safe dict: float64 scalars as floats,
    per-phase vectors as lists (both round-trip bit-exactly)."""
    out = {}
    for k, v in C.items():
        a = np.asarray(v, np.float64)
        out[k] = [float(x) for x in a] if a.ndim else float(a)
    return out


def decode_counters(d: Dict[str, object]) -> Dict[str, object]:
    """Inverse of :func:`encode_counters` — scalars come back as
    ``np.float64``, vectors as float64 arrays, matching the engines'
    output shapes exactly."""
    return {k: (np.asarray(v, np.float64) if isinstance(v, list)
                else np.float64(v))
            for k, v in d.items()}


class SweepCheckpoint:
    """Append-only JSONL journal of completed per-config engine results."""

    def __init__(self, path: str):
        self.dir = str(path)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "sweep_ckpt.jsonl")
        self._mem: Dict[tuple, dict] = {}
        self.hits = 0
        self.puts = 0
        if os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue        # torn tail line from a kill
                    self._mem[(rec["kind"], rec["trace"], rec["key"])] \
                        = rec["counters"]
        self._stream = open(self.path, "a")

    # -- raw journal ------------------------------------------------------
    def get(self, kind: str, tfp: str, key: str) -> Optional[dict]:
        c = self._mem.get((kind, tfp, key))
        if c is not None:
            self.hits += 1
        return c

    def put(self, kind: str, tfp: str, key: str, counters: dict) -> None:
        k = (kind, tfp, key)
        if k in self._mem:
            return
        self._mem[k] = counters
        self.puts += 1
        self._stream.write(json.dumps(
            {"kind": kind, "trace": tfp, "key": key,
             "counters": counters}) + "\n")
        self._stream.flush()

    # -- typed accessors the engines use ----------------------------------
    def get_hms(self, tfp: str, cfg, nvlink: bool):
        c = self.get("hms", tfp, config_digest(cfg, nvlink))
        return None if c is None else decode_counters(c)

    def put_hms(self, tfp: str, cfg, nvlink: bool, C) -> None:
        self.put("hms", tfp, config_digest(cfg, nvlink), encode_counters(C))

    def get_um(self, tfp: str, spec):
        c = self.get("um", tfp, _um_spec_key(spec))
        return None if c is None else {
            k: np.asarray(v, np.float64) for k, v in c.items()}

    def put_um(self, tfp: str, spec, result) -> None:
        self.put("um", tfp, _um_spec_key(spec), {
            "um_faults": [float(x) for x in result.phase_faults],
            "um_migrated": [float(x) for x in result.phase_migrated],
            "um_writebacks": [float(x) for x in result.phase_writebacks],
            "um_remote_cols": [float(x) for x in result.phase_remote_cols],
        })

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._mem), "hits": self.hits,
                "puts": self.puts}

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None


_ACTIVE: Optional[SweepCheckpoint] = None


def enable(path: str) -> SweepCheckpoint:
    """Activate checkpointing against ``path`` (a directory; created if
    missing).  An existing journal there is loaded — that IS the resume."""
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.close()
    _ACTIVE = SweepCheckpoint(path)
    return _ACTIVE


def disable() -> None:
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.close()
    _ACTIVE = None


def active() -> Optional[SweepCheckpoint]:
    return _ACTIVE


_env = os.environ.get("REPRO_SWEEP_CKPT")
if _env:
    enable(_env)
del _env
