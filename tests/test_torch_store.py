"""The port's design-space store (``repro_torch.obs.store``) on the CPU.

Ported from ``tests/test_store.py``: the gold invariants (frontier points
mutually non-dominated, every excluded candidate dominated, frontiers
invariant under row order and re-ingestion, a store diffed against itself
empty) by hypothesis and by a fixed seed battery; the silver merge rules
(per-phase vectors win over scalar totals, totals agree bit for bit,
conflicts warn and keep the first row), JSONL persistence with a torn
tail, the three bench-artifact shapes, a ledger joined to its bench
artifact, sweep journals and the markdown report.

Beside them: the committed ``benchmarks/baselines/BENCH_*.json`` ingest,
and re-ingest adds nothing; the port's store reads the reference's
ledgers next to its own, and keeps a port host apart from a reference
host while a reference record keeps the id the reference's store gives
it.
"""

import dataclasses
import json
import random
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.obs.store import (AXES, FrontierPoint, SilverRow,
                                   SilverStore, best_configs,
                                   counter_totals, derive_metrics,
                                   frontier_diff, frontier_view, host_id,
                                   pareto, planner_view, render_figures,
                                   render_markdown)

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

ROOT = Path(__file__).resolve().parents[1]
BASELINES = ROOT / "benchmarks" / "baselines"
SEEDS = list(range(8))


# ---------------------------------------------------------------------------
# Generators: random-but-reproducible silver populations.
# ---------------------------------------------------------------------------

def _counters(rng, phased=False):
    """A plausible HMS counter dict; per-phase 2-vectors when phased."""
    def val():
        v = float(rng.integers(0, 1000))
        if phased:
            a = float(rng.integers(0, int(v) + 1))
            return [a, v - a]
        return v
    return {k: val() for k in
            ("demand_dram_rd", "demand_dram_wr", "demand_scm_rd",
             "demand_scm_wr", "probe_cols", "meta_wr_cols",
             "fill_dram_wr", "wb_dram_rd", "fill_scm_rd", "wb_scm_wr")}


def _row(rng, trace_fp, config_key, workload="wl", policy="hms",
         sha="a" * 8, host="h" * 12, phased=False, runtime=None):
    counters = _counters(rng, phased=phased)
    metrics = derive_metrics(counters)
    metrics["runtime_cycles"] = (float(rng.integers(1, 10**6))
                                 if runtime is None else runtime)
    return SilverRow(trace_fp=trace_fp, config_key=config_key,
                     git_sha=sha, host_id=host, engine="hms",
                     workload=workload, n=1000,
                     phases=2 if phased else 1, policy=policy,
                     config={"knob": config_key}, counters=counters,
                     metrics=metrics, sources=["gen"])


def _population(seed, n_rows=14):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_rows):
        rows.append(_row(
            rng,
            trace_fp=f"t{rng.integers(0, 3):015d}x",
            config_key=f"c{i:03d}",
            workload=f"wl{rng.integers(0, 2)}",
            policy=("hms", "bear")[int(rng.integers(0, 2))],
            phased=bool(rng.integers(0, 2))))
    return rows


# ---------------------------------------------------------------------------
# Gold invariants (property battery).
# ---------------------------------------------------------------------------

def _check_frontier_nondominated(seed):
    rows = _population(seed)
    for (wl, pol), front in frontier_view(rows).items():
        for p in front:
            assert not any(q.dominates(p) for q in front if q is not p), \
                f"seed {seed}: dominated point on frontier {wl}/{pol}"
        cands = {}
        for r in rows:
            if r.workload != wl or (r.policy or r.engine) != pol:
                continue
            p = FrontierPoint.from_row(r)
            if p is not None:
                cands.setdefault(p.ident, p)
        on = {p.ident for p in front}
        for ident, p in cands.items():
            if ident not in on:
                assert any(q.dominates(p) for q in front), \
                    f"seed {seed}: non-dominated point excluded {ident}"


def _check_frontier_order_invariance(seed):
    rows = _population(seed)
    fv1 = frontier_view(rows)
    shuffled = list(rows)
    random.Random(seed).shuffle(shuffled)
    # duplicate a prefix: dedup must make re-ingestion invisible
    fv2 = frontier_view(shuffled + shuffled[:5])
    assert {g: [p.ident for p in f] for g, f in fv1.items()} \
        == {g: [p.ident for p in f] for g, f in fv2.items()}


def _check_self_diff_empty(seed):
    rows = _population(seed)
    diff = frontier_diff(rows, rows)
    assert diff.empty and not diff.regressions
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        s = SilverStore(d)
        for r in rows:
            s.add(r)
        s.close()
        s2 = SilverStore(d)
        diff2 = frontier_diff(rows, s2.rows())
        s2.close()
    assert diff2.empty, f"seed {seed}: store round trip moved the frontier"


if HAVE_HYPOTHESIS:
    @settings(max_examples=20, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(st.integers(min_value=0, max_value=2**20))
    def test_frontier_nondominated_property(seed):
        _check_frontier_nondominated(seed)

    @settings(max_examples=20, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(st.integers(min_value=0, max_value=2**20))
    def test_frontier_order_invariance_property(seed):
        _check_frontier_order_invariance(seed)

    @settings(max_examples=10, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(st.integers(min_value=0, max_value=2**20))
    def test_self_diff_empty_property(seed):
        _check_self_diff_empty(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_frontier_nondominated_seeded(seed):
    _check_frontier_nondominated(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_frontier_order_invariance_seeded(seed):
    _check_frontier_order_invariance(seed)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_self_diff_empty_seeded(seed):
    _check_self_diff_empty(seed)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_gold_views_equal_the_references(seed):
    """The port's gold views are the reference's, point for point."""
    from repro.obs import store as RS
    rows = _population(seed)
    ref_rows = [RS.SilverRow.from_dict(r.to_dict()) for r in rows]
    mine = {g: [(p.ident, p.axes) for p in f]
            for g, f in frontier_view(rows).items()}
    ref = {g: [(p.ident, p.axes) for p in f]
           for g, f in RS.frontier_view(ref_rows).items()}
    assert mine == ref
    assert {w: p.ident for w, p in best_configs(rows).items()} == {
        w: p.ident for w, p in RS.best_configs(ref_rows).items()}


def test_pareto_known_answer():
    """Hand-checkable 2-config case: domination and survival."""
    rng = np.random.default_rng(0)
    a = _row(rng, "t" * 16, "ca", runtime=100.0)
    b = _row(rng, "t" * 16, "cb", runtime=200.0)
    for ax in AXES:
        b.metrics[ax] = a.metrics[ax] + 1.0
    front = frontier_view([a, b])[("wl", "hms")]
    assert [p.config_key for p in front] == ["ca"]
    best = best_configs([a, b])
    assert best["wl"].config_key == "ca"
    # duplicate design points collapse before filtering
    pa = FrontierPoint.from_row(a)
    assert [p.ident for p in pareto([pa, pa])] == [pa.ident]


def test_frontier_diff_detects_regression():
    rng = np.random.default_rng(1)
    old = [_row(rng, "t" * 16, "ca", runtime=100.0),
           _row(rng, "t" * 16, "cb", runtime=90.0)]
    old[0].metrics["traffic_bytes"] = 50.0
    old[1].metrics["traffic_bytes"] = 60.0
    old[0].metrics["probe_bytes"] = old[1].metrics["probe_bytes"] = 5.0
    new = [SilverRow.from_dict(r.to_dict()) for r in old]
    new[0].metrics = dict(new[0].metrics)
    new[0].metrics["runtime_cycles"] = 150.0     # ca regresses, stays on
    diff = frontier_diff(old, new)
    assert not diff.empty
    assert any(r["axis"] == "runtime_cycles" and r["delta"] == 50.0
               for r in diff.regressions)
    assert diff.left == {}
    assert diff.summary()["regressions"] == len(diff.regressions)


def test_frontier_diff_entered_left():
    rng = np.random.default_rng(2)
    a = _row(rng, "t" * 16, "ca", runtime=100.0)
    b = _row(rng, "u" * 16, "cb", runtime=50.0)
    for ax in AXES:                    # b dominates a outright
        b.metrics[ax] = a.metrics[ax] - 1.0
    b.metrics["runtime_cycles"] = 50.0
    diff = frontier_diff([a], [a, b])
    assert any("cb" in k for ks in diff.entered.values() for k in ks)
    assert any("ca" in k for ks in diff.left.values() for k in ks)
    fr = [r for r in diff.regressions if r["axis"] == "frontier"]
    assert fr and any("cb" in d for d in fr[0]["dominated_by"])


# ---------------------------------------------------------------------------
# Silver semantics.
# ---------------------------------------------------------------------------

def test_counter_totals_bit_equality():
    c_vec = {"x": [1.25, 2.5, 0.125], "y": 7.0}
    c_tot = {"x": float(np.sum(np.asarray([1.25, 2.5, 0.125]))), "y": 7.0}
    assert counter_totals(c_vec) == counter_totals(c_tot)


def test_merge_vector_wins_and_dedup(tmp_path):
    rng = np.random.default_rng(3)
    scalar = _row(rng, "t" * 16, "ca")
    phased = SilverRow.from_dict(scalar.to_dict())
    phased.sources = ["other"]
    phased.counters = {k: [v / 2, v / 2] if not isinstance(v, list) else v
                       for k, v in scalar.counters.items()}
    s = SilverStore(str(tmp_path))
    assert s.add(scalar) == "added"
    assert s.add(SilverRow.from_dict(scalar.to_dict())) == "dup"
    assert s.add(phased) == "merged"
    row = s.rows()[0]
    assert isinstance(row.counters["demand_dram_rd"], list)
    assert set(row.sources) == {"gen", "other"}
    assert counter_totals(row.counters) == counter_totals(scalar.counters)
    s.close()
    s2 = SilverStore(str(tmp_path))
    assert len(s2) == 1
    assert s2.rows()[0].counters == row.counters
    s2.close()


def test_conflict_warns_and_keeps_first():
    rng = np.random.default_rng(4)
    a = _row(rng, "t" * 16, "ca")
    b = SilverRow.from_dict(a.to_dict())
    b.counters = dict(b.counters)
    b.counters["demand_dram_rd"] = 1e9        # totals disagree
    s = SilverStore()
    assert s.add(a) == "added"
    with pytest.warns(RuntimeWarning, match="silver conflict"):
        assert s.add(b) == "conflict"
    assert s.rows()[0].counters["demand_dram_rd"] \
        == a.counters["demand_dram_rd"]


def test_store_skips_torn_tail(tmp_path):
    rng = np.random.default_rng(5)
    s = SilverStore(str(tmp_path))
    s.add(_row(rng, "t" * 16, "ca"))
    s.close()
    with open(tmp_path / "silver.jsonl", "a") as f:
        f.write('{"trace_fp": "torn mid-wri')
    with pytest.warns(RuntimeWarning, match="torn/corrupt"):
        s2 = SilverStore(str(tmp_path))
    assert len(s2) == 1
    s2.close()


def test_host_id_stable_and_sensitive():
    h = {"platform": "linux", "machine": "x86_64", "cpu_count": 8,
         "python": "3.10", "jax": "0.4", "jax_backend": "cpu",
         "wall_s": 1.23}
    assert host_id(h) == host_id({**h, "wall_s": 9.9})   # run-varying: out
    assert host_id(h) != host_id({**h, "machine": "arm64"})
    assert len(host_id(None)) == 12


def test_host_id_of_a_reference_host_is_the_references():
    from repro.obs.store import host_id as ref_host_id
    art = json.loads((BASELINES / "BENCH_sweep.json").read_text())
    assert host_id(art["host"]) == ref_host_id(art["host"])
    h = {"platform": "linux", "machine": "x86_64", "cpu_count": 8,
         "python": "3.12"}
    assert host_id(h) == ref_host_id(h)


def test_host_id_tells_port_hosts_apart():
    port = {"platform": "linux", "machine": "x86_64", "cpu_count": 8,
            "python": "3.12", "torch": "2.11", "torch_cuda": "12.8",
            "gpu": "NVIDIA H100 80GB HBM3", "gpu_power_limit": "700.00 W",
            "driver": "570", "git_sha": "a" * 40}
    card = {**port, "device": "cuda"}
    cpu = {**port, "device": "cpu"}
    assert host_id(card) != host_id(cpu)
    assert host_id(card) != host_id({**card, "gpu": None})
    assert host_id(card) != host_id({**card, "torch": "2.13"})
    # run-varying fields (the power limit, the driver, the commit) do not
    # name the host
    assert host_id(card) == host_id({**card, "gpu_power_limit": "500 W",
                                     "driver": "580", "git_sha": None})
    bare = {k: v for k, v in port.items()
            if k not in ("torch", "torch_cuda", "gpu")}
    assert host_id(port) != host_id(bare)


def test_derive_metrics_matches_bus_accounting():
    from repro_torch.core.timing import COLUMN_BYTES
    c = {"demand_dram_rd": 10.0, "demand_dram_wr": 4.0,
         "demand_scm_rd": 6.0, "demand_scm_wr": 2.0,
         "probe_cols": 3.0, "meta_wr_cols": 1.0, "fill_dram_wr": 5.0,
         "wb_dram_rd": 2.0, "fill_scm_rd": 5.0, "wb_scm_wr": 2.0}
    m = derive_metrics(c)
    assert m["dram_bytes"] == 25.0 * COLUMN_BYTES
    assert m["scm_bytes"] == 15.0 * COLUMN_BYTES
    assert m["traffic_bytes"] == m["dram_bytes"] + m["scm_bytes"]
    assert m["probe_bytes"] == 4.0 * COLUMN_BYTES
    assert m["scm_write_cols"] == 4.0
    um = derive_metrics({"um_faults": [3.0, 1.0], "um_migrated": 2.0,
                         "um_writebacks": 1.0})
    assert um == {"um_faults": 4.0, "um_migrated_pages": 2.0,
                  "um_writeback_pages": 1.0}


# ---------------------------------------------------------------------------
# Bronze ingestion: the three artifact shapes + the engine ledger.
# ---------------------------------------------------------------------------

def _sweep_artifact():
    rng = np.random.default_rng(6)
    return {
        "n": 1000, "grid_points": 2,
        "grid": [{"tag_layout": "amil"}, {"tag_layout": "tad"}],
        "host": {"platform": "linux", "git_sha": "a" * 40},
        "workloads": {"bfs_tu": {
            "n": 1000, "points": 2,
            "trace_fp": "f" * 16,
            "point_config_digests": ["d0" * 8, "d1" * 8],
            "point_counters": [_counters(rng), _counters(rng)],
            "point_runtime_cycles": [100.0, 200.0],
            "wall_s": 0.5,
        }},
    }


def _um_artifact():
    return {
        "n": 1000,
        "host": {"platform": "linux", "git_sha": "b" * 40},
        "workloads": {"bfs_tu": {
            "n": 1000, "trace_fp": "f" * 16,
            "points": [{
                "rel_footprint": 2.0, "nvlink": False,
                "spec_key": "F8:c16:nv0:h4",
                "counters": {"um_faults": [3.0, 1.0],
                             "um_migrated": [2.0, 0.0],
                             "um_writebacks": [1.0, 0.0],
                             "um_remote_cols": [0.0, 0.0]},
                "faults": 4.0, "link_bytes": 64.0,
            }],
        }},
    }


def test_ingest_artifact_shapes_and_reingest_noop(tmp_path):
    sweep = tmp_path / "BENCH_sweep.json"
    sweep.write_text(json.dumps(_sweep_artifact()))
    um = tmp_path / "BENCH_um.json"
    um.write_text(json.dumps(_um_artifact()))
    s = SilverStore()
    st1 = s.ingest(str(sweep))
    st2 = s.ingest(str(um))
    assert (st1.added, st1.skipped) == (2, 0)
    assert (st2.added, st2.skipped) == (1, 0)
    row = [r for r in s.rows() if r.engine == "um"][0]
    assert row.config_key == "F8:c16:nv0:h4"
    assert row.metrics["um_faults"] == 4.0
    assert row.metrics["um_link_bytes"] == 64.0
    st3 = s.ingest(str(sweep))
    st4 = s.ingest(str(um))
    assert st3.added == st3.merged == 0 and st3.dups == 2
    assert st4.added == st4.merged == 0 and st4.dups == 1
    swrow = [r for r in s.rows() if r.config_key == "d0" * 8][0]
    assert swrow.config == {"tag_layout": "amil"}
    assert swrow.metrics["runtime_cycles"] == 100.0


def test_ingest_pre_store_artifact_skips(tmp_path):
    art = _sweep_artifact()
    del art["workloads"]["bfs_tu"]["trace_fp"]
    p = tmp_path / "BENCH_sweep.json"
    p.write_text(json.dumps(art))
    s = SilverStore()
    stats = s.ingest(str(p))
    assert stats.added == 0 and stats.skipped == 2


@pytest.mark.parametrize("name,rows", [("sweep", 36), ("um", 16),
                                       ("scenarios", 20)])
def test_committed_baselines_ingest_and_reingest_noop(tmp_path, name, rows):
    path = str(BASELINES / f"BENCH_{name}.json")
    s = SilverStore(str(tmp_path))
    st = s.ingest(path)
    assert (st.added, st.skipped, st.conflicts) == (rows, 0, 0)
    again = s.ingest(path)
    assert again.added == again.merged == 0 and again.dups == rows
    s.close()
    s2 = SilverStore(str(tmp_path))          # the journal replays
    assert len(s2) == rows
    st2 = s2.ingest(path)
    assert st2.added == st2.merged == 0
    s2.close()
    # the reference's store reads the same artifact into the same rows
    from repro.obs.store import SilverStore as RefStore
    ref = RefStore()
    ref.ingest(path)
    assert [r.key for r in ref.rows()] == [r.key for r in s2.rows()]
    assert [r.metrics for r in ref.rows()] == [r.metrics for r in s2.rows()]


def test_all_baselines_render_markdown(tmp_path):
    s = SilverStore(str(tmp_path))
    for name in ("sweep", "um", "scenarios"):
        s.ingest(str(BASELINES / f"BENCH_{name}.json"))
    md = render_markdown(s)
    assert "# Design-space report" in md
    assert "rows: **72**" in md
    assert "### bfs_tu / hms" in md
    assert "## Best config per workload" in md
    s.close()


def _port_ledger(tmp_path, n=1500):
    """A port ledger of one simulate and one UM batch, with the trace,
    config and results behind it."""
    import repro_torch.core as T
    from repro_torch import obs
    from repro_torch.convert import trace_from_arrays
    from repro_torch.um import engine as tum

    rng = np.random.default_rng(7)
    fp = 2 * 2**20
    t = trace_from_arrays("store_join",
                          rng.integers(0, fp // 32, n).astype(np.int64),
                          rng.random(n) < 0.3, fp)
    cfg = T.HMSConfig(footprint=fp)
    obs.clear_records()
    obs.enable(str(tmp_path / "obs"))
    try:
        r = T.simulate(t, cfg, device="cpu")
        tum.simulate_um_many(t, [tum.um_spec(dataclasses.replace(
            cfg, organization="hbm", r_hbm=0.5))], device="cpu")
    finally:
        obs.disable()
        obs.clear_records()
    return t, cfg, r, tmp_path / "obs" / "ledger.jsonl"


def test_ingest_ledger_joins_bench(tmp_path):
    """An engine ledger lane and a bench point that share (trace_fp,
    config digest, sha, host) merge into one row with the ledger's
    counters AND the bench-side runtime metric."""
    from repro_torch import obs
    from repro_torch.resilience import sweepckpt

    t, cfg, r, ledger = _port_ledger(tmp_path)
    host = {**obs.host_metadata(), "device": "cpu"}
    art = {
        "host": host,
        "workloads": {"store_join": {
            "n": t.n, "points": 1,
            "trace_fp": sweepckpt.trace_fingerprint(t),
            "point_config_digests": [sweepckpt.config_digest(cfg)],
            "point_counters": [sweepckpt.encode_counters(r.counters)],
            "point_runtime_cycles": [r.runtime_cycles],
        }},
    }
    p = tmp_path / "BENCH_sweep.json"
    p.write_text(json.dumps(art))

    s = SilverStore()
    st_l = s.ingest(str(ledger))
    st_b = s.ingest(str(p))
    # the HMS record lands one silver row and one plan row, the UM record
    # one silver row and one plan row
    assert st_l.added == 4 and len(s.plan_rows()) == 2
    assert st_b.merged == 1 and st_b.added == 0 and st_b.conflicts == 0
    row = [x for x in s.rows() if x.engine == "hms"][0]
    assert len(row.sources) == 2
    assert row.metrics["runtime_cycles"] == r.runtime_cycles
    assert row.policy == "hms"
    assert FrontierPoint.from_row(row) is not None
    view = planner_view(s.plan_rows())
    assert view["records"] == 2 and view["warm"] == 2


def test_ingest_ckpt_journal(tmp_path):
    from repro_torch.resilience import sweepckpt
    ck = sweepckpt.SweepCheckpoint(str(tmp_path))
    ck.put("hms", "f" * 16, "d0" * 8,
           sweepckpt.encode_counters({"demand_dram_rd": 5.0,
                                      "demand_dram_wr": 1.0,
                                      "demand_scm_rd": 2.0,
                                      "demand_scm_wr": 0.0}))
    ck.close()
    s = SilverStore()
    stats = s.ingest(str(tmp_path / "sweep_ckpt.jsonl"))
    assert stats.added == 1
    assert s.rows()[0].metrics["traffic_bytes"] > 0


def test_ingest_port_sweep_journal(tmp_path):
    """A sweep the port journaled (``simulate_many`` under an active
    checkpoint) ingests one row a config, keyed like its ledger lanes."""
    import repro_torch.core as T
    from repro_torch.resilience import sweepckpt

    t = T.make_trace("zipf", n=800)
    cfgs = [T.HMSConfig(footprint=t.footprint),
            T.HMSConfig(footprint=t.footprint, scm_mode="slc")]
    sweepckpt.enable(str(tmp_path))
    try:
        T.simulate_many(t, cfgs, device="cpu")
    finally:
        sweepckpt.disable()
    s = SilverStore()
    st = s.ingest(str(tmp_path / "sweep_ckpt.jsonl"))
    assert st.added == 2
    assert {r.config_key for r in s.rows()} == {
        sweepckpt.config_digest(c) for c in cfgs}
    assert {r.trace_fp for r in s.rows()} == {sweepckpt.trace_fingerprint(t)}


@pytest.fixture(scope="module")
def ref_ledger(tmp_path_factory):
    """A reference ledger of the same calls as ``_port_ledger``."""
    from repro import obs as RO
    from repro import um as RU
    from repro.core import HMSConfig, Trace, simulate

    d = tmp_path_factory.mktemp("ref")
    rng = np.random.default_rng(7)
    n, fp = 1500, 2 * 2**20
    t = Trace("store_join", rng.integers(0, fp // 32, n).astype(np.int64),
              rng.random(n) < 0.3, fp)
    cfg = HMSConfig(footprint=fp)
    RO.clear_records()
    RO.enable(str(d / "obs"))
    try:
        simulate(t, cfg)
        RU.simulate_um_many(t, [RU.um_spec(dataclasses.replace(
            cfg, organization="hbm", r_hbm=0.5))])
    finally:
        RO.disable()
        RO.clear_records()
    return d / "obs" / "ledger.jsonl"


def test_port_store_reads_a_reference_ledger(ref_ledger):
    from repro.obs.store import SilverStore as RefStore
    s = SilverStore()
    st = s.ingest(str(ref_ledger))
    assert (st.added, st.skipped, st.conflicts) == (4, 0, 0)
    ref = RefStore()
    ref.ingest(str(ref_ledger))
    assert [r.key for r in s.rows()] == [r.key for r in ref.rows()]
    assert [r.counters for r in s.rows()] == [r.counters for r in ref.rows()]
    again = s.ingest(str(ref_ledger))
    assert again.added == again.merged == 0 and again.dups == 4


def test_port_and_reference_ledgers_side_by_side(tmp_path, ref_ledger):
    """Both packages' ledgers of the same calls in one store: the same
    (trace, config) points, on two hosts; each re-ingest adds nothing,
    and the UM lanes agree bit for bit."""
    _, _, _, port_ledger = _port_ledger(tmp_path)
    s = SilverStore(str(tmp_path / "store"))
    sp = s.ingest(str(port_ledger))
    sr = s.ingest(str(ref_ledger))
    assert sp.added == sr.added == 4
    assert len(s) == 4 and len(s.summary()["hosts"]) == 2
    by = {}
    for r in s.rows():
        by.setdefault((r.trace_fp, r.config_key), []).append(r)
    assert len(by) == 2 and all(len(v) == 2 for v in by.values())
    um = next(v for v in by.values() if v[0].engine == "um")
    assert um[0].counters == um[1].counters
    assert s.ingest(str(port_ledger)).added == 0
    assert s.ingest(str(ref_ledger)).added == 0
    md = render_markdown(s)
    assert "## Planner accuracy" in md
    s.close()


# ---------------------------------------------------------------------------
# Report rendering.
# ---------------------------------------------------------------------------

def test_render_markdown_sections():
    s = SilverStore()
    for r in _population(9):
        s.add(r)
    diff = frontier_diff(s.rows(), s.rows())
    md = render_markdown(s, diff=diff)
    assert "# Design-space report" in md
    assert "## Pareto frontiers" in md
    assert "## Best config per workload" in md
    assert "Frontiers identical" in md


def test_render_diff_markdown_lists_regressions():
    rng = np.random.default_rng(10)
    old = [_row(rng, "t" * 16, "ca", runtime=100.0)]
    new = [SilverRow.from_dict(old[0].to_dict())]
    new[0].metrics = {**new[0].metrics, "runtime_cycles": 120.0}
    s = SilverStore()
    s.add(new[0])
    md = render_markdown(s, diff=frontier_diff(old, new))
    assert "**regressions: 1**" in md and "runtime_cycles" in md


def test_render_figures_gated_on_matplotlib(tmp_path, monkeypatch):
    rows = _population(11)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert render_figures(rows, str(tmp_path / "none")) == []
    monkeypatch.undo()
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        have = False
    else:
        have = True
    paths = render_figures(rows, str(tmp_path / "figs"))
    assert bool(paths) == have
    assert all(Path(p).exists() for p in paths)
