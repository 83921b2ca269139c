"""The port's engine telemetry (``repro_torch.obs``) on the CPU, and its
records against the JAX package's.

The contracts under test, ported from ``tests/test_obs.py``:

  * every guarded engine call emits one :class:`RunRecord` with the shard
    plan, the compile flag and a counter digest; records survive a JSONL
    round trip intact,
  * the counter digest is bit-exact across forced (S, T), replay and batch
    width (the ledger-level face of the engines' parity guarantees),
  * ``assert_no_retrace`` catches a warm engine whose kernel library is
    loaded again and stays quiet after a blessed ``obs.reset``,
  * spans are a shared no-op while disabled (no clock read, no
    synchronize) and export to Perfetto JSON,

and, against the reference: the same ``simulate``, ``simulate_many`` and
``simulate_um_many`` calls under both packages give records with equal
identity fields at a pinned (S, T), UM digests equal bit for bit, HMS
counters within the parity tolerance, and each package's ``load_ledger``
and ``SilverStore`` read the other's ledger.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
from repro import obs as RO
from repro import um as RU
from repro.core import costmodel as Rcm

import repro_torch
import repro_torch.core as T
from repro_torch import _build, obs
from repro_torch.convert import config_from_dict, trace_from_arrays
from repro_torch.core import costmodel, tsplit
from repro_torch.core import simulator as tsim
from repro_torch.obs import spans as ospans
from repro_torch.resilience import sweepckpt
from repro_torch.um import engine as tum

TOL = dict(rtol=1e-9, atol=1e-6)
CPU = "cpu"


@pytest.fixture
def ledger(tmp_path):
    """Observability on, streaming to a tmp dir; restored afterwards."""
    obs.clear_records()
    obs.clear_events()
    obs.enable(str(tmp_path))
    yield tmp_path
    obs.disable()
    obs.clear_records()
    obs.clear_events()


@contextlib.contextmanager
def shape(S, Tt, replay=0):
    old = (costmodel.set_forced_shards(S), costmodel.set_forced_tsplit(Tt),
           tsplit.set_replay_prefix(replay))
    try:
        yield
    finally:
        costmodel.set_forced_shards(old[0])
        costmodel.set_forced_tsplit(old[1])
        tsplit.set_replay_prefix(old[2])


def _ref_trace(n=2000, footprint=4 * 2**20, seed=3, name="obs_golden"):
    rng = np.random.default_rng(seed)
    col = rng.integers(0, footprint // 32, size=n).astype(np.int64)
    wr = rng.random(n) < 0.3
    return R.Trace(name, col, wr, footprint)


def _port_trace(t):
    return trace_from_arrays(t.name, t.col, t.is_write, t.footprint,
                             t.phase_id, t.phase_names)


def _trace(n=2000, seed=3):
    return _port_trace(_ref_trace(n=n, seed=seed))


def _port_cfg(c):
    return config_from_dict(dataclasses.asdict(c))


def _hms(recs):
    return [r for r in recs if r.engine == "hms"]


# ---------------------------------------------------------------------------
# Run ledger.
# ---------------------------------------------------------------------------

def test_ledger_jsonl_roundtrip(ledger):
    t = _trace()
    cfg = T.HMSConfig(footprint=t.footprint)
    T.simulate(t, cfg, device=CPU)
    T.simulate_many(t, [cfg, dataclasses.replace(cfg, scm_mode="slc"),
                        dataclasses.replace(cfg, ema_weight=0.05)],
                    device=CPU)
    recs = obs.records()
    assert len(recs) == 2                   # one a guarded call
    loaded = obs.load_ledger(str(ledger))
    assert len(loaded) == len(recs)
    for a, b in zip(recs, loaded):
        assert a.to_dict() == b.to_dict()
    hms = _hms(loaded)
    assert [r.entry for r in hms] == ["simulate", "simulate_many"]
    for r in hms:
        assert r.engine_key.startswith("hms:")
        assert r.shards >= 1 and r.depth >= 1
        assert r.load_imbalance >= 1.0
        assert len(r.counter_digest) == 16
        assert r.wall_s > 0
        assert r.host["python"] and r.host["device"] == "cpu"
        assert r.schema == 4 and r.calib_fingerprint
    assert hms[1].batch == 3 and hms[1].engine_key.endswith(":w3")


def test_ledger_records_compile_vs_warm(ledger, monkeypatch):
    """On the CPU the kernel library is never built or loaded, so no call
    is ``compiled``; a call during which the library loads is."""
    t = _trace(seed=21)
    cfg = T.HMSConfig(footprint=t.footprint)
    T.simulate(t, cfg, device=CPU)
    T.simulate(t, cfg, device=CPU)
    a, b = _hms(obs.records())[-2:]
    assert a.engine_key == b.engine_key
    assert not a.compiled and not b.compiled
    assert a.counter_digest == b.counter_digest

    real = tsim._scan_attempt
    loads = iter([1, 0])

    def loading(*args):
        _build.library_counts["loads"] += next(loads)
        return real(*args)

    monkeypatch.setattr(tsim, "_scan_attempt", loading)
    monkeypatch.setitem(_build.library_counts, "loads",
                        _build.library_counts["loads"])
    T.simulate(t, cfg, device=CPU)
    T.simulate(t, cfg, device=CPU)
    c, d = _hms(obs.records())[-2:]
    assert c.compiled and not d.compiled
    assert c.counter_digest == d.counter_digest == a.counter_digest
    split = obs.compile_split([c, d])
    assert split["runs"] == 2 and split["compiled_runs"] == 1
    assert split["wall_s"] == pytest.approx(c.wall_s + d.wall_s)
    assert split["compile_wall_s"] == pytest.approx(c.wall_s)


def test_git_identity_in_records(ledger):
    t = _trace()
    T.simulate(t, T.HMSConfig(footprint=t.footprint), device=CPU)
    r = obs.records()[-1]
    info = obs.git_info()
    assert r.git_sha == info["git_sha"]
    if r.git_sha is not None:              # running from a git checkout
        assert len(r.git_sha) == 40
        assert isinstance(r.git_dirty, bool)


def test_host_names_torch_and_no_card_on_cpu(ledger):
    t = _trace()
    T.simulate(t, T.HMSConfig(footprint=t.footprint), device=CPU)
    host = obs.records()[-1].host
    assert host["torch"] == torch.__version__
    assert host["torch_cuda"] == torch.version.cuda
    assert host["device"] == "cpu"
    assert "jax" not in host and "jax_backend" not in host
    assert host["gpu"] is None and host["gpu_power_limit"] is None
    assert host["driver"] is None
    assert obs.host_metadata() is obs.host_metadata()   # process-stable
    assert "device" not in obs.host_metadata()


def test_um_records_carry_dedupe_accounting(ledger):
    t = _trace(seed=5)
    base = T.HMSConfig(footprint=t.footprint, organization="hbm")
    specs = [tum.um_spec(dataclasses.replace(base, r_hbm=r))
             for r in (0.25, 0.5, 0.25)]          # one duplicate
    obs.reset(hms=False)
    lanes0 = obs.cache_stats()["um_lanes_run"]
    tum.simulate_um_many(t, specs, device=CPU)
    tum.simulate_um_many(t, specs, device=CPU)    # fully memoized
    ran, memo = [r for r in obs.records() if r.engine == "um"][-2:]
    assert (ran.um_lanes_requested, ran.um_lanes_run,
            ran.um_lanes_deduped) == (3, 2, 1)
    assert ran.engine_key.startswith("um:") and ran.engine_key.endswith(
        ":w2")
    assert ran.batch == 2 and ran.ladder_rung == "T1"
    assert (memo.um_lanes_run, memo.engine_key, memo.batch) == (
        0, "um:memoized", 0)
    assert memo.um_lanes_deduped == 3 and memo.ladder_rung is None
    assert memo.counter_digest == ran.counter_digest   # same results
    assert obs.cache_stats()["um_lanes_run"] == lanes0 + 2
    assert obs.cache_stats()["um_results_cached"] >= 2


def test_disabled_by_default_emits_nothing():
    assert not obs.enabled()
    before = (len(obs.records()), len(obs.events()))
    t = _trace(seed=8)
    T.simulate(t, T.HMSConfig(footprint=t.footprint, organization="hbm",
                              r_hbm=0.5), device=CPU)
    T.simulate(t, T.HMSConfig(footprint=t.footprint), device=CPU)
    assert (len(obs.records()), len(obs.events())) == before


def test_records_agree_with_runs_list(ledger):
    """The always-on ``_RUNS`` entries and the ledger records are built
    from the same values."""
    t = _trace(seed=9)
    cfg = T.HMSConfig(footprint=t.footprint)
    del tsim._RUNS[:]
    with shape(2, 3, 8):
        T.simulate_many(t, [cfg, dataclasses.replace(cfg, ctc_ways=8)],
                        device=CPU)
    (run,) = tsim._RUNS
    (rec,) = _hms(obs.records())
    assert run["engine_key"] == rec.engine_key
    assert (run["shards"], run["t_segments"], run["replay"],
            run["rounds"], run["rung"], run["batch"], run["compiled"]) == (
        rec.shards, rec.t_segments, rec.replay_prefix, rec.stitch_rounds,
        rec.ladder_rung, rec.batch, rec.compiled)
    assert run["wall_s"] == rec.wall_s
    assert rec.engine_key.startswith("hms:hms:n2000:s2x")
    assert ":T3r8:" in rec.engine_key
    assert rec.plan_predicted_us is not None


def test_drift_check_and_sentinel_use_the_fingerprint(monkeypatch, ledger):
    seen = []
    monkeypatch.setattr(costmodel, "check_plan_drift",
                        lambda fp, pred, wall, compiled=False:
                        seen.append((fp, compiled)))
    t = _trace(seed=10)
    T.simulate(t, T.HMSConfig(footprint=t.footprint), device=CPU)
    tum.simulate_um(t, T.HMSConfig(footprint=t.footprint,
                                   organization="hbm", r_hbm=0.5),
                    device=CPU)
    hms, um = obs.records()[-2:]
    assert seen == [(hms.engine_key, False), (um.engine_key, False)]
    runs = obs.engine_runs()
    assert runs[hms.engine_key]["runs"] >= 1
    assert runs[um.engine_key]["runs"] >= 1


@pytest.mark.parametrize("width", [1, 3])
def test_fingerprints_in_reference_format(width):
    t = _trace(seed=11)
    cfg = T.HMSConfig(footprint=t.footprint)
    key = tsim.group_engine_key(t, [cfg])
    rkey = R.simulator._EngineKey(**dataclasses.asdict(key))
    assert tsim._fingerprint(key, width) == R.simulator._fingerprint(
        rkey, width)
    specs = [tum.um_spec(dataclasses.replace(cfg, organization="hbm",
                                             r_hbm=0.5))]
    ukey = tum.um_group_key(t, specs, 4, 16)
    rukey = RU.engine._UMKey(**dataclasses.asdict(ukey))
    assert tum._fingerprint(ukey, width) == RU.engine._fingerprint(
        rukey, width)


# ---------------------------------------------------------------------------
# Counter digest.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def digest_trace():
    t = _trace(n=1500, seed=12)
    cfg = T.HMSConfig(footprint=t.footprint)
    obs.clear_records()
    obs.enable(None)
    try:
        with shape(1, 1):
            T.simulate(t, cfg, device=CPU)
        (one,) = obs.records()
    finally:
        obs.disable()
        obs.clear_records()
    return t, cfg, one


@pytest.mark.parametrize("S,Tt,replay", [(2, 1, 0), (1, 3, 0), (2, 4, 8)])
def test_counter_digest_stable_across_shard_counts(digest_trace, S, Tt,
                                                   replay, ledger):
    """Forced (S, T) and replay give bit-identical counters, hence equal
    record digests — the cross-shape comparability guarantee."""
    t, cfg, one = digest_trace
    with shape(S, Tt, replay):
        T.simulate(t, cfg, device=CPU)
    (rec,) = obs.records()
    assert (rec.shards, rec.t_segments) == (S, Tt)
    assert rec.engine_key != one.engine_key
    assert rec.counter_digest == one.counter_digest
    assert rec.counters == one.counters


def test_counter_digest_stable_across_execution_shapes(ledger):
    """simulate vs simulate_many digests agree per config, and a lane's
    digest does not depend on the batch width."""
    t = _trace(n=1500, seed=13)
    kws = [{}, {"scm_mode": "slc"}, {"ema_weight": 0.05}]
    cfgs = [T.HMSConfig(footprint=t.footprint, **kw) for kw in kws]
    batched = T.simulate_many(t, cfgs, device=CPU)
    pair = T.simulate_many(t, cfgs[:2], device=CPU)
    for cfg, rb in zip(cfgs, batched):
        assert (obs.counter_digest(T.simulate(t, cfg, device=CPU).counters)
                == obs.counter_digest(rb.counters))
    recs = _hms(obs.records())
    wide, two, singles = recs[0], recs[1], recs[2:]
    assert [r.batch for r in recs] == [3, 2, 1, 1, 1]
    for j, s in enumerate(singles):
        assert obs.counter_digest(wide.counters[j]) == s.counter_digest
    assert obs.counter_digest(wide.counters[:2]) == two.counter_digest
    assert wide.counter_digest == obs.counter_digest(
        [s.counters[0] for s in singles])


def test_counter_digest_sensitivity():
    c = {"a": 1.0, "b": np.array([2.0, 3.0])}
    assert obs.counter_digest(c) == obs.counter_digest(
        {"b": np.array([2.0, 3.0]), "a": 1.0})       # order-insensitive
    assert obs.counter_digest(c) != obs.counter_digest(
        {"a": 1.0, "b": np.array([2.0, 3.0000001])})  # value-sensitive
    assert obs.counter_digest(c) != obs.counter_digest(
        {"a": 1.0, "c": np.array([2.0, 3.0])})        # key-sensitive
    assert obs.counter_digest([c, c]) != obs.counter_digest(c)
    assert obs.counter_digest([c]) == obs.counter_digest(c)
    # the reference's digest, bit for bit
    assert obs.counter_digest([c, c]) == RO.counter_digest([c, c])


# ---------------------------------------------------------------------------
# Retrace sentinel.
# ---------------------------------------------------------------------------

def _library_loads_during(monkeypatch, target, name):
    """Make ``target.name`` load the kernel library (as a launch would on
    the card after the library was dropped)."""
    real = getattr(target, name)

    def loading(*args, **kw):
        _build.library_counts["loads"] += 1
        return real(*args, **kw)

    monkeypatch.setitem(_build.library_counts, "loads",
                        _build.library_counts["loads"])
    monkeypatch.setattr(target, name, loading)


def test_assert_no_retrace_catches_deliberate_retrace(monkeypatch):
    t = _trace(seed=17)
    cfg = T.HMSConfig(footprint=t.footprint)
    T.simulate(t, cfg, device=CPU)         # warm the engine
    with pytest.raises(obs.RetraceError, match="hms:"):
        with obs.assert_no_retrace():
            # the library dropped behind the sentinel's back: the rerun
            # loads it again on a warm fingerprint
            _library_loads_during(monkeypatch, tsim, "_scan_attempt")
            T.simulate(t, cfg, device=CPU)


def test_assert_no_retrace_catches_um_reload(monkeypatch):
    t = _trace(seed=18)
    spec = tum.um_spec(T.HMSConfig(footprint=t.footprint,
                                   organization="hbm", r_hbm=0.5))
    tum.simulate_um_many(t, [spec], device=CPU)
    obs.reset(hms=False, keep_compiled=True)   # results only: stays warm
    with pytest.raises(obs.RetraceError, match="um:"):
        with obs.assert_no_retrace():
            _library_loads_during(monkeypatch, tum.um_ops, "um_scan")
            tum.simulate_um_many(t, [spec], device=CPU)


def test_assert_no_retrace_allows_cold_and_reset(monkeypatch):
    t = _trace(seed=19)
    cfg = T.HMSConfig(footprint=t.footprint, policy="bear")
    obs.reset(um=False)
    with obs.assert_no_retrace() as guard:
        T.simulate(t, cfg, device=CPU)     # fresh fingerprint
        T.simulate(t, cfg, device=CPU)     # warm
    assert guard.compiles_during() == 0    # the CPU loads no library
    T.simulate(t, cfg, device=CPU)
    with obs.assert_no_retrace() as guard:
        obs.reset()                        # blessed invalidation
        _library_loads_during(monkeypatch, tsim, "_scan_attempt")
        T.simulate(t, cfg, device=CPU)     # the reload is expected
    assert guard.compiles_during() == 1


def test_cache_stats_and_reset_scoping(monkeypatch):
    obs.reset()
    t = _trace(seed=23)
    T.simulate(t, T.HMSConfig(footprint=t.footprint), device=CPU)
    tum.simulate_um(t, T.HMSConfig(footprint=t.footprint,
                                   organization="hbm", r_hbm=0.5),
                    device=CPU)
    monkeypatch.setitem(_build.launches, "hms_scan", 7)
    s = obs.cache_stats()
    assert {"um_results_cached", "um_lanes_run", "engine_runs",
            "engine_compiles", "kernel_builds", "kernel_loads"} <= set(s)
    assert s["hms_scan_launches"] == 7
    assert s["um_results_cached"] >= 1
    assert s["engine_runs"] >= 2 and s["engine_compiles"] == 0
    assert s["kernel_builds"] == s["kernel_loads"] == 0   # no card here
    hms_fps = {fp for fp in obs.engine_runs() if fp.startswith("hms:")}
    obs.reset(hms=False)                   # UM-only reset
    s2 = obs.cache_stats()
    assert s2["um_results_cached"] == 0
    assert {fp for fp in obs.engine_runs() if fp.startswith("hms:")} \
        == hms_fps
    assert not any(fp.startswith("um:") for fp in obs.engine_runs())
    assert s2["um_lanes_run"] == s["um_lanes_run"]


def test_library_build_load_and_compile_span(monkeypatch, tmp_path):
    """``_build.library`` counts an nvcc build and each load, times both in
    a ``compile`` span, and ``obs.reset`` drops the library so the next
    launch loads it again."""
    class FakeLib:
        def __getattr__(self, name):
            return type("F", (), {})()

    def fake_compile(so, tag):
        Path(so).write_bytes(b"")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "library_counts",
                        {"builds": 0, "loads": 0})
    obs.clear_events()
    obs.enable(None)
    try:
        lib = _build.library()
        assert _build.library() is lib
        assert _build.library_counts == {"builds": 1, "loads": 1}
        obs.reset()
        _build.library()
        assert _build.library_counts == {"builds": 1, "loads": 2}
        assert _build.library_epoch() == 3
        comp = [e for e in obs.events() if e[0] == "compile"]
        assert [e[4]["build"] for e in comp] == [True, False]
    finally:
        obs.disable()
        obs.clear_events()
    s = obs.cache_stats()
    assert (s["kernel_builds"], s["kernel_loads"]) == (1, 2)


# ---------------------------------------------------------------------------
# Span tracer.
# ---------------------------------------------------------------------------

def test_span_trace_exports_perfetto_json(ledger):
    t = T.make_trace("moe_expert", n=2000)
    T.simulate(t, T.HMSConfig(footprint=t.footprint), device=CPU)
    names = {e[0] for e in obs.events()}
    assert {"preprocess", "shard_plan", "scan", "postprocess"} <= names
    path = obs.export_trace(str(ledger))
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    assert evs and all(e["ph"] == "X" for e in evs)
    assert all(e["dur"] >= 0 and "ts" in e and "pid" in e for e in evs)
    scan = next(e for e in evs if e["name"] == "scan")
    assert scan["args"] == {"engine": "hms", "policy": "hms", "shards": 1,
                            "batch": 1}
    tot = obs.totals()
    assert tot["scan"]["count"] == 1 and tot["scan"]["total_ms"] > 0
    obs.export_trace(str(ledger / "t2.json"), clear=True)
    assert not obs.events()


def test_span_names_and_args_match_reference(ledger):
    """Each reference span has its counterpart with the same arguments:
    the stitch of a split scan, the UM scan, the single-tier model, a
    batch's preprocess and postprocess."""
    t = _trace(n=1500, seed=24)
    cfg = T.HMSConfig(footprint=t.footprint)
    with shape(1, 2):
        T.simulate_many(t, [cfg, dataclasses.replace(cfg, scm_mode="slc"),
                            dataclasses.replace(cfg, organization="hbm",
                                                r_hbm=0.5)], device=CPU)
    ev = {}
    for name, _, _, _, args in obs.events():
        ev.setdefault(name, []).append(args)
    assert ev["preprocess"] == [{"trace": t.name, "batch": 2}]
    assert ev["postprocess"] == [{"trace": t.name, "batch": 2}]
    assert ev["shard_plan"] == [{"policy": "hms", "configs": 2}]
    assert {"engine": "hms", "segments": 2, "replay": 0} in ev["stitch"]
    assert {"engine": "um", "segments": 2, "replay": 0} in ev["stitch"]
    assert ev["um_scan"] == [{"engine": "um", "lanes": 1, "trace": t.name}]
    assert ev["single_tier"] == [{"organization": "hbm", "trace": t.name}]
    assert ev["scan"] == [{"engine": "hms", "policy": "hms", "shards": 1,
                           "batch": 2}]


def test_spans_noop_when_disabled(monkeypatch):
    assert not obs.enabled()
    before = len(obs.events())

    def boom(*a, **k):
        raise AssertionError("disabled span touched the clock or the card")

    monkeypatch.setattr(ospans.time, "perf_counter_ns", boom)
    monkeypatch.setattr(torch.cuda, "current_stream", boom)
    with obs.span("nothing", x=1):
        pass
    with obs.span("scan", sync=torch.device("cuda"), engine="hms"):
        pass
    assert len(obs.events()) == before
    # the disabled path hands back a shared singleton (no allocation)
    assert obs.span("a") is obs.span("b", sync=torch.device("cuda"))


def test_span_sync_waits_for_the_card_only_when_enabled(monkeypatch):
    synced = []

    class Stream:
        def __init__(self, dev):
            self.dev = dev

        def synchronize(self):
            synced.append(self.dev)

    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    obs.clear_events()
    with obs.span("scan", sync=torch.device("cuda")):
        pass
    assert synced == []                    # disabled: no synchronize
    ospans.set_enabled(True)
    try:
        with obs.span("scan", sync=torch.device("cuda")):
            pass
        with obs.span("scan", sync=torch.device("cpu")):
            pass
        with obs.span("preprocess"):
            pass
    finally:
        ospans.set_enabled(False)
    assert synced == [torch.device("cuda")]
    assert [e[0] for e in obs.events()] == ["scan", "scan", "preprocess"]
    assert all("sync" not in e[4] for e in obs.events())
    obs.clear_events()


# ---------------------------------------------------------------------------
# Phase-summary schema pin.
# ---------------------------------------------------------------------------

def test_phase_summary_column_schema():
    base_cols = {"requests", "hit_rate_read", "hit_rate_write",
                 "bypass_rate", "ctc_hit_rate", "fills", "dram_bytes",
                 "scm_bytes", "scm_write_cols"}
    um_cols = {"um_faults", "um_migrated_pages", "um_writeback_pages",
               "um_remote_cols", "um_link_bytes"}
    t = T.make_trace("moe_expert", n=2000)
    s = T.simulate(t, T.HMSConfig(footprint=t.footprint),
                   device=CPU).phase_summary()
    assert s and all(set(row) == base_cols for row in s.values())
    s_um = T.simulate(t, T.HMSConfig(footprint=t.footprint,
                                     organization="hbm", r_hbm=0.5),
                      device=CPU).phase_summary()
    assert all(set(row) == base_cols | um_cols for row in s_um.values())


# ---------------------------------------------------------------------------
# Ledger robustness + design-space-store fields.
# ---------------------------------------------------------------------------

def test_load_ledger_skips_torn_lines(ledger):
    t = _trace()
    T.simulate(t, T.HMSConfig(footprint=t.footprint), device=CPU)
    n_good = len(obs.records())
    path = ledger / "ledger.jsonl"
    with open(path, "a") as f:
        f.write('{"schema": 4, "engine": "hms", "tr')   # torn tail
    with pytest.warns(RuntimeWarning, match="torn/corrupt"):
        loaded = obs.load_ledger(str(ledger))
    assert len(loaded) == n_good
    with open(path, "a") as f:
        f.write('"not a record"\n{"schema": 4}\n')
    with pytest.warns(RuntimeWarning, match="2 torn/corrupt"):
        assert len(obs.load_ledger(str(ledger))) == n_good


def test_ledger_carries_full_counters(ledger):
    t = _trace()
    cfg = T.HMSConfig(footprint=t.footprint)
    cfgs = [cfg, dataclasses.replace(cfg, scm_mode="slc")]
    rs = T.simulate_many(t, cfgs, device=CPU)
    specs = [tum.um_spec(T.HMSConfig(footprint=t.footprint,
                                     organization="hbm", r_hbm=0.5),
                         nvlink=nv) for nv in (False, True)]
    tum.simulate_um_many(t, specs, device=CPU)

    recs = obs.load_ledger(str(ledger))
    hms = _hms(recs)[-1]
    assert hms.trace_fp == sweepckpt.trace_fingerprint(t)
    assert hms.config_digests == [sweepckpt.config_digest(c) for c in cfgs]
    assert len(hms.counters) == len(cfgs)
    for lane, r in zip(hms.counters, rs):
        dec = sweepckpt.decode_counters(lane)
        for k, v in r.counters.items():
            np.testing.assert_array_equal(dec[k], np.asarray(v, np.float64))

    umr = [r for r in recs if r.engine == "um"][-1]
    assert umr.trace_fp == sweepckpt.trace_fingerprint(t)
    assert umr.config_digests == [sweepckpt.um_spec_key(s) for s in specs]
    assert {k for lane in umr.counters for k in lane} \
        == {"um_faults", "um_migrated", "um_writebacks", "um_remote_cols"}


def test_old_schema_ledger_loads_with_none_fields(tmp_path):
    rec = obs.RunRecord(engine="hms", entry="simulate", trace="t", n=10,
                        phases=1, engine_key="hms:x", batch=1, shards=1,
                        depth=10, t_segments=1, stitch_rounds=1,
                        load_imbalance=1.0, compiled=True, wall_s=0.1,
                        counter_digest="0" * 16)
    d = rec.to_dict()
    for k in ("trace_fp", "config_digests", "counters", "plan_predicted_us",
              "plan_alternatives", "calib_fingerprint"):
        d.pop(k)
    d["schema"] = 2
    p = tmp_path / "ledger.jsonl"
    p.write_text(json.dumps(d) + "\n")
    (r,) = obs.load_ledger(str(tmp_path))
    assert r.trace_fp is None and r.config_digests is None \
        and r.counters is None and r.plan_predicted_us is None
    assert r.schema == 2


def test_record_fields_are_the_references():
    assert [f.name for f in dataclasses.fields(obs.RunRecord)] == [
        f.name for f in dataclasses.fields(RO.RunRecord)]
    assert obs.ledger.SCHEMA_VERSION == RO.ledger.SCHEMA_VERSION == 4


def test_calibration_facade():
    c = obs.calibration()
    assert c["mode"] == costmodel.calib_mode()
    assert c["profile"]["fingerprint"] == \
        costmodel.active_profile().fingerprint
    assert c["host_fingerprint"] and c["calib_dir"]


def test_bisected_batch_records_its_halves(ledger):
    from repro_torch.resilience import faults
    t = _trace(n=1500, seed=25)
    cfg = T.HMSConfig(footprint=t.footprint)
    cfgs = [cfg, dataclasses.replace(cfg, scm_mode="slc")]
    with faults.inject("oom@1"):
        T.simulate_many(t, cfgs, device=CPU)
    recs = _hms(obs.records())
    # the halves first (each its own guarded call), then the bisected one
    assert [r.batch for r in recs] == [1, 1, 2]
    assert recs[-1].ladder_rung == "bisect"
    assert recs[-1].degradations and recs[-1].degradations[0]["kind"] \
        == "oom"
    assert recs[-1].counter_digest == obs.counter_digest(
        [recs[0].counters[0], recs[1].counters[0]])


# ---------------------------------------------------------------------------
# Against the reference.
# ---------------------------------------------------------------------------

IDENTITY = ("entry", "engine", "n", "phases", "batch", "engine_key",
            "trace_fp", "config_digests", "um_lanes_requested",
            "um_lanes_run", "um_lanes_deduped", "t_segments", "shards",
            "depth", "replay_prefix", "stitch_rounds")


def _calls(pkg, t, cfgs):
    """The same calls under either package: simulate, simulate_many over
    HMS / hbm / inf_hbm configs, and a UM batch with a duplicate."""
    sim, many, um_many, um_spec = pkg
    sim(t, cfgs[0])
    many(t, cfgs)
    um_many(t, [um_spec(dataclasses.replace(cfgs[0], organization="hbm",
                                            r_hbm=r))
                for r in (0.25, 0.5, 0.25)])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Records of the same calls under both packages at a pinned (S, T)
    of (1, 1), each streamed to its own ledger."""
    rt = _ref_trace(n=2000, seed=3)
    base = R.HMSConfig(footprint=rt.footprint)
    rcfgs = [base, dataclasses.replace(base, scm_mode="slc"),
             dataclasses.replace(base, organization="hbm", r_hbm=0.5),
             dataclasses.replace(base, organization="inf_hbm")]
    d = tmp_path_factory.mktemp("both")
    old = (Rcm.set_forced_shards(1), Rcm.set_forced_tsplit(1))
    RO.clear_records()
    RO.enable(str(d / "ref"))
    try:
        _calls((R.simulate, R.simulate_many, RU.simulate_um_many,
                RU.um_spec), rt, rcfgs)
        ref = RO.records()
    finally:
        RO.disable()
        RO.clear_records()
        Rcm.set_forced_shards(old[0])
        Rcm.set_forced_tsplit(old[1])
    obs.clear_records()
    obs.enable(str(d / "port"))
    try:
        with shape(1, 1):
            _calls((lambda t, c: T.simulate(t, c, device=CPU),
                    lambda t, c: T.simulate_many(t, c, device=CPU),
                    lambda t, s: tum.simulate_um_many(t, s, device=CPU),
                    tum.um_spec),
                   _port_trace(rt), [_port_cfg(c) for c in rcfgs])
        port = obs.records()
    finally:
        obs.disable()
        obs.clear_records()
    return ref, port, d


def test_same_calls_give_the_same_records(both):
    ref, port, _ = both
    assert [(r.entry, r.engine) for r in port] == [
        (r.entry, r.engine) for r in ref]
    assert [r.engine for r in port] == ["hms", "um", "um", "single_tier",
                                        "single_tier", "hms", "um"]


@pytest.mark.parametrize("field", IDENTITY)
def test_record_field_equals_reference(both, field):
    ref, port, _ = both
    assert [getattr(p, field) for p in port] == [
        getattr(r, field) for r in ref]


def test_um_digests_equal_reference_bit_for_bit(both):
    ref, port, _ = both
    pairs = [(r, p) for r, p in zip(ref, port) if r.engine == "um"]
    assert len(pairs) == 3
    for r, p in pairs:
        assert p.counter_digest == r.counter_digest
        assert p.counters == r.counters


def test_hms_counters_within_parity_tolerance(both):
    ref, port, _ = both
    pairs = [(r, p) for r, p in zip(ref, port)
             if r.engine in ("hms", "single_tier")]
    assert len(pairs) == 4
    for r, p in pairs:
        assert len(p.counters) == len(r.counters)
        for lr, lp in zip(r.counters, p.counters):
            assert set(lp) == set(lr)
            for k in lr:
                a, b = np.asarray(lp[k]), np.asarray(lr[k])
                if np.all(b == np.round(b)):
                    np.testing.assert_array_equal(a, b, err_msg=k)
                else:
                    np.testing.assert_allclose(a, b, err_msg=k, **TOL)


def test_reference_load_ledger_reads_a_port_ledger(both):
    _, port, d = both
    loaded = RO.load_ledger(str(d / "port"))
    assert [r.to_dict() for r in loaded] == [r.to_dict() for r in port]


def test_reference_store_reads_a_port_ledger(both):
    from repro.obs.store import SilverStore as RefStore
    _, port, d = both
    s = RefStore()
    st = s.ingest(str(d / "port" / "ledger.jsonl"))
    lanes = sum(len(r.counters) for r in port)
    assert st.conflicts == 0 and st.skipped == 0
    assert st.added + st.dups + st.merged == lanes + sum(
        1 for r in port if r.plan_predicted_us is not None)
    assert {r.engine for r in s.rows()} == {"hms", "um", "single_tier"}
    again = s.ingest(str(d / "port" / "ledger.jsonl"))
    assert again.added == again.merged == 0


def test_obs_imports_without_jax():
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "from repro_torch import obs",
        "from repro_torch.obs import store",
        "from repro_torch.obs.store import SilverStore, render_markdown",
        "import repro_torch.core as T",
        "t = T.make_trace('zipf', n=300)",
        "obs.enable(None)",
        "T.simulate(t, T.HMSConfig(footprint=t.footprint), device='cpu')",
        "(r,) = obs.records()",
        "assert r.host['device'] == 'cpu', r.host",
        "bad = [m for m in sys.modules if m == 'repro' or",
        "       m.startswith(('repro.', 'jax.', 'jaxlib'))]",
        "assert not bad and sys.modules['jax'] is None, bad",
        "print('ok', r.engine_key)",
    ])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.pop("REPRO_OBS_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok hms:hms:n300:")


def test_obs_dir_env_enables_collection(tmp_path):
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "import repro_torch.core as T",
        "from repro_torch import obs",
        "assert obs.enabled()",
        "t = T.make_trace('zipf', n=300)",
        "T.simulate(t, T.HMSConfig(footprint=t.footprint), device='cpu')",
        "print(obs.ledger_path())",
    ])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["REPRO_OBS_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path / "ledger.jsonl")
    (r,) = obs.load_ledger(str(tmp_path))
    assert r.entry == "simulate" and r.engine == "hms"
