"""The port's resilience layer against the JAX package's, on the CPU.

Failure classification (a CUDA out-of-memory is ``oom``; a build failure,
a launch error or a kernel's ``ValueError`` is nothing and is raised);
fault specs parse and fire as the reference's do; the degradation ladder
on ``simulate_many`` (an injected ``oom`` bisects the batch, a ``stitch``
fault drops to T = 1, a ``nan`` result descends to the next rung, an
unclassified error raises, an exhausted ladder raises ``ResilienceError``)
with counters equal to the unfaulted run bit for bit; the sweep journal
(a killed sweep resumes bit-identical, UM points included); and trace
fingerprints and config digests equal the reference's and the committed
baselines' strings."""

import contextlib
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
from repro.resilience import faults as RF
from repro.resilience import guard as RG
from repro.resilience import sweepckpt as RS

import repro_torch.core as T
import repro_torch.resilience as PR
from repro_torch.convert import config_from_dict, trace_from_arrays
from repro_torch.core import costmodel, tsplit
from repro_torch.core import simulator as tsim
from repro_torch.resilience import faults as PF
from repro_torch.resilience import guard as PG
from repro_torch.resilience import sweepckpt as PS
from repro_torch.um import engine as um_engine

ROOT = Path(__file__).resolve().parent.parent
BASELINES = ROOT / "benchmarks" / "baselines"


@contextlib.contextmanager
def shape(S, Tt):
    old = (costmodel.set_forced_shards(S), costmodel.set_forced_tsplit(Tt))
    try:
        yield
    finally:
        costmodel.set_forced_shards(old[0])
        costmodel.set_forced_tsplit(old[1])


@pytest.fixture(autouse=True)
def no_backoff(monkeypatch):
    monkeypatch.setattr(PG, "_BACKOFF_S", 0.0)


def _bits(rs):
    return [{k: np.float64(v).tobytes() for k, v in r.counters.items()}
            for r in rs]


@pytest.fixture(scope="module")
def sweep():
    t = T.make_trace("bfs_tu", n=1500)
    cfgs = [T.HMSConfig(footprint=t.footprint, ctc_fraction=f, tag_layout=l)
            for l in ("amil", "tad") for f in (0.25, 0.0625)]
    with shape(2, 2):
        clean = T.simulate_many(t, cfgs, device="cpu")
    return t, cfgs, _bits(clean)


# ---------------------------------------------------------------------------
# Classification and fault specs.
# ---------------------------------------------------------------------------

def test_classify_failure_maps_cuda_oom_and_raises_the_rest():
    assert PG.classify_failure(torch.cuda.OutOfMemoryError("CUDA out of "
                                                           "memory")) == "oom"
    assert PG.classify_failure(RuntimeError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == "oom"
    assert PG.classify_failure(tsplit.StitchError("x")) == "stitch"
    assert PG.classify_failure(PG.CounterInvalidError("x")) == "nan"
    assert PG.classify_failure(PF.InjectedFault("deadline", "s", 1)) \
        == "deadline"
    for exc in (ValueError("hms_scan: a slot is touched by two domains"),
                RuntimeError("nvcc failed on hms_scan.cu"),
                RuntimeError("hms_scan: CUDA error 700 at launch"),
                KeyError("x")):
        assert PG.classify_failure(exc) is None
    # the shared kinds classify as the reference's do
    for msg in ("RESOURCE_EXHAUSTED: x", "DEADLINE_EXCEEDED", "other"):
        assert PG.classify_failure(RuntimeError(msg)) \
            == RG.classify_failure(RuntimeError(msg))


def test_fault_specs_parse_and_fire_as_the_reference():
    for text in ("oom@3,stitch@7", " nan@1 , kill@2 ", ""):
        assert [(s.kind, s.at) for s in PF.parse(text)] \
            == [(s.kind, s.at) for s in RF.parse(text)]
    for bad in ("oom", "boom@1", "oom@0"):
        with pytest.raises(ValueError):
            PF.parse(bad)
        with pytest.raises(ValueError):
            RF.parse(bad)
    with PF.inject("stitch@2,oom@3"):
        assert PF.on_call("x") == 1
        with pytest.raises(tsplit.StitchError):
            PF.on_call("x")
        with pytest.raises(PF.InjectedFault, match="injected oom"):
            PF.on_call("x")
        assert not PF.pending()
    assert not PF.active()


def test_check_finite_and_guarded_call():
    PG.check_finite({"a": np.float64(1.0), "b": [np.ones(3)]})
    with pytest.raises(PG.CounterInvalidError, match="b"):
        PG.check_finite({"a": 1.0, "b": np.array([1.0, np.nan])})
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("CUDA out of memory")
        return {"x": 1.0}

    out, outcome = PG.guarded_call("t", flaky, retries=1)
    assert out == {"x": 1.0} and outcome.retries == 1
    assert [e["action"] for e in outcome.events] == ["retry"]


# ---------------------------------------------------------------------------
# The ladder on simulate_many.
# ---------------------------------------------------------------------------

def test_injected_oom_bisects_the_batch(sweep):
    t, cfgs, clean = sweep
    del tsim._RUNS[:]
    with shape(2, 2), PF.inject("oom@1"):
        got = T.simulate_many(t, cfgs, device="cpu")
    assert _bits(got) == clean
    top = [r for r in tsim._RUNS if r["rung"] == "bisect"]
    assert len(top) == 1 and top[0]["batch"] == 4
    assert [e["action"] for e in top[0]["events"]] == ["bisect"]
    assert sorted(r["batch"] for r in tsim._RUNS
                  if r["rung"] != "bisect") == [2, 2]


def test_real_oom_bisects_down_to_single_configs(sweep, monkeypatch):
    """A batch wider than one config runs out of memory; the halves
    bisect until each fits."""
    t, cfgs, clean = sweep
    real = tsim._scan_attempt

    def tight(trace, group, key, dev):
        if len(group) > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(trace, group, key, dev)

    monkeypatch.setattr(tsim, "_scan_attempt", tight)
    monkeypatch.setenv("REPRO_RETRY", "0")
    del tsim._RUNS[:]
    with shape(2, 2):
        got = T.simulate_many(t, cfgs, device="cpu")
    assert _bits(got) == clean
    assert sorted(r["batch"] for r in tsim._RUNS
                  if r["rung"] != "bisect") == [1, 1, 1, 1]


def test_stitch_fault_drops_to_t1(sweep):
    t, cfgs, clean = sweep
    del tsim._RUNS[:]
    with shape(2, 2), PF.inject("stitch@1"):
        got = T.simulate_many(t, cfgs, device="cpu")
    assert _bits(got) == clean
    (run,) = tsim._RUNS
    assert (run["rung"], run["shards"], run["t_segments"]) == ("S2T1", 2, 1)
    assert [(e["kind"], e["action"]) for e in run["events"]] \
        == [("stitch", "degrade")]


def test_nan_result_descends_to_the_next_rung(sweep):
    t, cfgs, clean = sweep
    del tsim._RUNS[:]
    with shape(2, 2), PF.inject("nan@1"):
        got = T.simulate_many(t, cfgs, device="cpu")
    assert _bits(got) == clean
    (run,) = tsim._RUNS
    assert run["rung"] == "S2T1"
    assert [(e["kind"], e["action"]) for e in run["events"]] \
        == [("nan", "degrade")]


def test_unclassified_error_raises(sweep, monkeypatch):
    t, cfgs, _ = sweep

    def broken(*a, **k):
        raise ValueError("hms_scan: a slot is touched by two domains")

    monkeypatch.setattr(tsim, "_scan_attempt", broken)
    with shape(2, 2), pytest.raises(ValueError, match="two domains"):
        T.simulate_many(t, cfgs, device="cpu")


def test_exhausted_ladder_raises_without_a_fallback(sweep):
    """(1, 1) is the last rung: the port keeps no frozen-reference rung."""
    t, cfgs, _ = sweep
    with shape(1, 1), PF.inject("stitch@1"):
        with pytest.raises(PG.ResilienceError) as e:
            T.simulate(t, cfgs[0], device="cpu")
    assert [ev["rung"] for ev in e.value.events] == ["S1T1"]


def test_um_ladder_drops_to_t1_and_bisects():
    t = T.make_trace("gpt_train", n=2000)
    specs = [um_engine.UMSpec(n_frames=24, chunk=4),
             um_engine.UMSpec(n_frames=30, chunk=1, nvlink=True,
                              hot_thresh=3)]
    with shape(None, 1):
        um_engine._RESULT_CACHE.pop(t, None)
        want = um_engine.simulate_um_many(t, specs, device="cpu")
    for spec, rung in (("stitch@1", "T1"), ("oom@1", "bisect")):
        um_engine._RESULT_CACHE.pop(t, None)
        with shape(None, 4), PF.inject(spec):
            got = um_engine.simulate_um_many(t, specs, device="cpu")
        assert um_engine._RUNS[-1]["rung"] == rung
        for g, w in zip(got, want):
            for f in um_engine._FIELDS:
                assert np.array_equal(getattr(g, f), getattr(w, f))


# ---------------------------------------------------------------------------
# The sweep journal.
# ---------------------------------------------------------------------------

def test_killed_sweep_resumes_bit_identical(tmp_path):
    t = T.make_trace("kcore", n=1500)
    cfgs = ([T.HMSConfig(footprint=t.footprint, ctc_fraction=f)
             for f in (0.25, 0.0625)]
            + [T.HMSConfig(footprint=t.footprint, policy="bear")]
            + [T.HMSConfig(footprint=t.footprint, organization="hbm",
                           r_hbm=0.25)])
    with shape(1, 2):
        clean = T.simulate_many(t, cfgs, device="cpu")
        um_engine._RESULT_CACHE.pop(t, None)
        PS.enable(str(tmp_path))
        try:
            # the UM point is call 1, the first HMS group call 2: the kill
            # lands on the second group
            with PF.inject("kill@3"), pytest.raises(KeyboardInterrupt):
                T.simulate_many(t, cfgs, device="cpu")
            assert PS.active().stats()["puts"] == 3
            um_engine._RESULT_CACHE.pop(t, None)
            ck = PS.enable(str(tmp_path))        # the resume
            resumed = T.simulate_many(t, cfgs, device="cpu")
            assert ck.stats()["hits"] == 3
        finally:
            PS.disable()
    assert _bits(resumed) == _bits(clean)
    assert [r.runtime_cycles for r in resumed] \
        == [r.runtime_cycles for r in clean]
    lines = (tmp_path / "sweep_ckpt.jsonl").read_text().splitlines()
    assert sorted(json.loads(x)["kind"] for x in lines) \
        == ["hms", "hms", "hms", "um"]


def test_counter_codec_and_um_keys_match_reference():
    C = {"a": np.float64(0.1 + 0.2), "v": np.array([1.5, 1 / 3])}
    assert PS.encode_counters(C) == RS.encode_counters(C)
    back = PS.decode_counters(json.loads(json.dumps(PS.encode_counters(C))))
    assert back["a"] == C["a"] and np.array_equal(back["v"], C["v"])
    from repro.um import UMSpec as RUMSpec
    for kw in ({"n_frames": 7, "chunk": 8}, {"n_frames": 40, "chunk": 1,
                                            "nvlink": True, "hot_thresh": 2}):
        assert PS.um_spec_key(um_engine.UMSpec(**kw)) \
            == RS.um_spec_key(RUMSpec(**kw))
    assert set(PR.__all__) >= {"faults", "guard", "sweepckpt", "validate",
                               "InjectedFault", "inject", "run_ladder",
                               "SweepCheckpoint", "config_digest",
                               "trace_fingerprint", "ResilienceError"}


def test_fingerprints_and_digests_equal_the_baselines():
    from repro_torch.workloads import SCENARIOS
    base = json.loads((BASELINES / "BENCH_scenarios.json").read_text())
    for name, entry in base["scenarios"].items():
        for p in entry["sweep"][:2]:
            n = base["n"]
            t = SCENARIOS[name].compile(n=n) if p["oversub"] == 1.0 else \
                SCENARIOS[name].compile(n=n, oversub=p["oversub"])
            assert PS.trace_fingerprint(t) == p["trace_fp"], (name, p)
            cfg = T.HMSConfig(footprint=entry["footprint_bytes"])
            assert PS.config_digest(cfg) == p["config_digest"]
    sweep = json.loads((BASELINES / "BENCH_sweep.json").read_text())
    name, entry = next(iter(sweep["workloads"].items()))
    t = T.make_trace(name, n=sweep["n"])
    assert PS.trace_fingerprint(t) == entry["trace_fp"]
    # the same strings as the reference's functions on the same inputs
    rt = R.make_trace(name, n=sweep["n"])
    assert PS.trace_fingerprint(t) == RS.trace_fingerprint(rt)
    rc = R.HMSConfig(footprint=rt.footprint, scm_mode="tlc")
    pc = config_from_dict(dataclasses.asdict(rc))
    for nv in (False, True):
        assert PS.config_digest(pc, nv) == RS.config_digest(rc, nv)
