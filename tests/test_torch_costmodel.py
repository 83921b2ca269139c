"""The port's cost model (``repro_torch.core.costmodel``) and calibration
(``repro_torch.core.calibrate``) against the JAX package's, on the CPU.

Under the same profile every planner function gives the reference's plan
over a grid of depths, batch widths, caps and forced values; the
degradation ladder, step costs and rounds line agree; profiles round-trip
through the port's JSON codec bit for bit; the committed default profile
names the card it was fitted on; and ``simulator.set_forced_shards``
forwards to the cost model."""

import dataclasses
import math

import pytest

from repro.core import costmodel as R

from repro_torch.core import calibrate as PC
from repro_torch.core import costmodel as P
from repro_torch.core import simulator as tsim

PROFILES = {
    "cpu": dict(step_cost_solo=19.0, step_overhead=3.0, lane_cost=1.0,
                um_step_cost_solo=30.0, um_step_overhead=6.0,
                um_lane_cost=3.0, rounds_base=2.0, rounds_slope=0.25),
    "flat": dict(step_cost_solo=0.9, step_overhead=0.7, lane_cost=0.001,
                 um_step_cost_solo=2.0, um_step_overhead=1.5,
                 um_lane_cost=0.002, rounds_base=2.5, rounds_slope=0.5),
    "steep": dict(step_cost_solo=5.0, step_overhead=0.1, lane_cost=4.0,
                  um_step_cost_solo=5.0, um_step_overhead=0.1,
                  um_lane_cost=9.0, rounds_base=3.0, rounds_slope=0.0),
}


@pytest.fixture
def both(request):
    """Pin the same profile, caps and forced values in both modules, and
    restore them after the test."""
    saved = (P.set_profile(None), R.set_profile(None),
             P.set_max_shards(64), R.set_max_shards(64),
             P.set_max_tsplit(16), R.set_max_tsplit(16),
             P.set_forced_shards(None), R.set_forced_shards(None),
             P.set_forced_tsplit(None), R.set_forced_tsplit(None))

    def pin(name, caps=(64, 16), forced=(None, None)):
        kw = PROFILES[name]
        P.set_profile(P.CalibProfile(**kw, fingerprint=name))
        R.set_profile(R.CalibProfile(**kw, fingerprint=name))
        for mod in (P, R):
            mod.set_max_shards(caps[0])
            mod.set_max_tsplit(caps[1])
            mod.set_forced_shards(forced[0])
            mod.set_forced_tsplit(forced[1])

    yield pin
    P.set_profile(saved[0])
    R.set_profile(saved[1])
    P.set_max_shards(saved[2])
    R.set_max_shards(saved[3])
    P.set_max_tsplit(saved[4])
    R.set_max_tsplit(saved[5])
    P.set_forced_shards(saved[6])
    R.set_forced_shards(saved[7])
    P.set_forced_tsplit(saved[8])
    R.set_forced_tsplit(saved[9])


def _depth_of(depth, skew):
    # LPT-binned depths: the hottest set bounds the depth at high S
    return lambda s: max(-(-depth // s), int(depth * skew))


def _same(a, b):
    assert (a.shards, a.t_segments, a.forced) == (b.shards, b.t_segments,
                                                 b.forced)
    assert a.predicted_us == b.predicted_us
    assert a.alternatives == b.alternatives
    assert a.best_alternative_us == b.best_alternative_us


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("caps,forced", [
    ((64, 16), (None, None)), ((8, 4), (None, None)), ((1, 1), (None, None)),
    ((64, 16), (4, None)), ((64, 16), (None, 8)), ((64, 16), (2, 3))])
def test_planners_give_the_reference_plan(both, name, caps, forced):
    both(name, caps, forced)
    for depth in (1, 7, 600, 20_000, 250_000, 1_000_000):
        for skew in (0.0, 0.05, 0.3):
            for batch in (1, 2, 6, 12):
                for replay in (0, 64):
                    d = _depth_of(depth, skew)
                    _same(P.plan_hms_split(d, batch, replay),
                          R.plan_hms_split(d, batch, replay))
                    assert P.choose_hms_split(d, batch, replay) \
                        == R.choose_hms_split(d, batch, replay)
            for width in (1, 2, 8, 16):
                _same(P.plan_um_split(depth, width),
                      R.plan_um_split(depth, width))
                assert P.choose_um_split(depth, width) \
                    == R.choose_um_split(depth, width)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_costs_rounds_and_ladder_match_reference(both, name):
    both(name)
    for lanes in (1, 2, 3, 64, 1024):
        assert P.step_cost(lanes) == R.step_cost(lanes)
        assert P.um_step_cost(lanes) == R.um_step_cost(lanes)
    for t in (1, 2, 3, 4, 16, 64):
        assert P.rounds_estimate(t) == R.rounds_estimate(t)
    for s in (1, 2, 64):
        for t in (1, 4, 16):
            assert P.degradation_ladder(s, t) == R.degradation_ladder(s, t)


def test_calib_mode_and_drift_factor_follow_the_reference(monkeypatch):
    for env in ("off", "auto", "force", "bogus", " OFF "):
        monkeypatch.setenv("REPRO_CALIB", env)
        assert P.calib_mode() == R.calib_mode()
    for env in ("25", "3", "0.5", "x"):
        monkeypatch.setenv("REPRO_CALIB_DRIFT", env)
        assert P.drift_factor() == R.drift_factor()
    old = P.set_drift_factor(2.0)
    try:
        with pytest.warns(P.CalibrationDriftWarning):
            assert P.check_plan_drift("test:fp", 100.0, 1e-3) == 10.0
        assert P.check_plan_drift("test:fp", 100.0, 1e-3) is None
        assert P.check_plan_drift("test:fp2", 100.0, 1e-4) is None
    finally:
        P.set_drift_factor(old)


def test_default_profile_is_the_h100_fit():
    """The committed constants were fitted on the card and say so."""
    prof = P.DEFAULT_PROFILE
    assert "H100" in prof.fingerprint and "W" in prof.fingerprint
    assert prof.source == "measured"
    fields = {f.name for f in dataclasses.fields(R.CalibProfile)}
    assert {f.name for f in dataclasses.fields(P.CalibProfile)} == fields
    for k in ("step_cost_solo", "lane_cost", "um_step_cost_solo",
              "um_lane_cost", "rounds_base"):
        assert math.isfinite(getattr(prof, k)) and getattr(prof, k) > 0


def test_profile_json_round_trips_bit_for_bit(tmp_path):
    prof = P.CalibProfile(step_cost_solo=0.1 + 0.2, lane_cost=1 / 3,
                          rounds_slope=math.pi, fingerprint="x",
                          source="measured", created_ts=1.5)
    path = PC.save_profile(prof, str(tmp_path))
    assert PC.load_profile(path) == prof
    assert PC.profile_from_json(PC.profile_to_json(prof)) == prof
    assert PC.load_profile(str(tmp_path / "missing.json")) is None


def test_fit_line_matches_reference():
    from repro.core import calibrate as RC
    pts = [(2, 3.5), (4, 3.9), (8, 5.0)]
    assert PC._fit_line(pts) == RC._fit_line(pts)
    assert PC._fit_line([(1, 2.0)]) == RC._fit_line([(1, 2.0)])
    assert PC._fit_rounds([(2, 2.0), (8, 3.0)]) \
        == RC._fit_rounds([(2, 2.0), (8, 3.0)])


def test_fit_rounds_counts_no_measured_t_short():
    """Where the stitch takes T rounds (no segment forgets its seed), the
    fitted line counts no measured T short, so a split never looks
    cheaper than it runs; a line the samples sit on is the reference's."""
    samples = [(2, 2.0), (4, 4.0), (8, 8.0), (16, 16.0), (16, 14.0)]
    base, slope = PC._fit_rounds(samples)
    assert all(base + slope * (math.log2(t) - 1) >= r - 1e-12
               for t, r in samples)
    P.set_profile(P.CalibProfile(rounds_base=base, rounds_slope=slope))
    try:
        assert all(P.rounds_estimate(t) >= t for t in (2, 4, 8, 16))
    finally:
        P.set_profile(None)
    assert PC._fit_rounds([]) == (P.DEFAULT_PROFILE.rounds_base,
                                  P.DEFAULT_PROFILE.rounds_slope)


def test_calibration_runs_on_the_main_path_traces():
    """The grid runs the main path's own workloads (cut to a few hundred
    requests here) and measures the stitch rounds of both engines at every
    T the cap allows; the fitted line covers every one of them."""
    import warnings
    old = P.set_max_tsplit(4)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m = PC.measure(quick=True, n=300, reps=1, device="cpu")
        prof = PC.fit_profile(m)
        plans = PC.plans(prof, quick=True, n=300)
    finally:
        P.set_max_tsplit(old)
    assert m["n"] == {"pathfnd@300": 300, "zipf@300": 300,
                      "um:llm_dec@300": 300}
    assert set(m["hms"]["pathfnd@300"]) == {1, 2, 4, 8, 16}
    assert m["depth"]["zipf@300"][1] == m["depth"]["zipf@300"][16]
    assert set(m["um"]) == {1, 2, 4}
    assert sorted(t for t, _ in m["rounds"]) == [2, 2, 2, 4, 4, 4]
    assert all(prof.rounds_base + prof.rounds_slope * (math.log2(t) - 1)
               >= r for t, r in m["rounds"])
    assert set(plans) == {"pathfnd@300", "zipf@300", "um:llm_dec@300"}
    assert all(p["predicted_us"] > 0 for p in plans.values())


def test_host_fingerprint_names_the_gpu():
    meta = PC.host_metadata()
    assert {"gpu", "torch", "cuda"} <= set(meta)
    assert len(PC.host_fingerprint()) == 12


def test_set_forced_shards_forwards_to_the_cost_model():
    old = tsim.set_forced_shards(4)
    try:
        assert P._FORCED_SHARDS == 4
        assert P.choose_hms_split(lambda s: 100, 1) [0] == 4
    finally:
        tsim.set_forced_shards(old)
    assert P._FORCED_SHARDS == old
    with pytest.raises(ValueError):
        tsim.set_forced_shards(0)


# ---------------------------------------------------------------------------
# the profile follows the device of the call
# ---------------------------------------------------------------------------

def test_profile_for_picks_the_profile_by_device():
    """CUDA tensors plan under the card's profile (the committed H100 fit
    with ``REPRO_CALIB=off``), CPU tensors under the uncalibrated host
    profile; a pinned profile holds on both; outside a call the card's."""
    import torch
    old = P.set_calib_mode("off")
    try:
        assert P.profile_for("cuda") is P.DEFAULT_PROFILE
        assert P.profile_for(torch.device("cuda", 0)) is P.DEFAULT_PROFILE
        assert P.profile_for(torch.device("cpu")) is P.HOST_PROFILE
        assert P.profile_for("cpu") is P.HOST_PROFILE
        assert "H100" not in P.HOST_PROFILE.fingerprint
        assert P.active_profile() is P.DEFAULT_PROFILE
        with P.planning_on(torch.device("cpu")):
            assert P.active_profile() is P.HOST_PROFILE
            with P.planning_on(torch.device("cuda")):
                assert P.active_profile() is P.DEFAULT_PROFILE
            assert P.active_profile() is P.HOST_PROFILE
        assert P.active_profile() is P.DEFAULT_PROFILE
        pin = P.CalibProfile(fingerprint="pinned")
        P.set_profile(pin)
        try:
            assert P.profile_for("cpu") is pin and P.profile_for("cuda") is pin
        finally:
            P.set_profile(None)
        assert P.profile_for("cpu") is P.HOST_PROFILE
    finally:
        P.set_calib_mode(old)


def test_profile_save_restore_leaves_cpu_calls_on_the_host_profile():
    """``old = set_profile(p) ... set_profile(old)`` after the card's
    profile was resolved pins nothing: CPU calls go back to the host
    profile, CUDA calls to the card's."""
    old_mode = P.set_calib_mode("off")
    try:
        assert P.profile_for("cuda") is P.DEFAULT_PROFILE     # resolved
        for pin in (P.DEFAULT_PROFILE, P.CalibProfile(fingerprint="x")):
            old = P.set_profile(pin)
            assert old is None and P.profile_for("cpu") is pin
            P.set_profile(old)
            assert P.profile_for("cpu") is P.HOST_PROFILE
            assert P.profile_for("cuda") is P.DEFAULT_PROFILE
        outer = P.CalibProfile(fingerprint="outer")
        P.set_profile(outer)
        old = P.set_profile(P.HOST_PROFILE)
        P.set_profile(old)
        assert P.profile_for("cuda") is outer
        P.set_profile(None)
        assert P.profile_for("cpu") is P.HOST_PROFILE
    finally:
        P.set_calib_mode(old_mode)


def test_host_profile_keeps_the_host_plans_sequential():
    """A lane priced as a whole step and the stitch's T rounds: no (S, T)
    beats (1, 1) for either engine on the host."""
    old = P.set_profile(P.HOST_PROFILE)
    try:
        for depth in (7, 2000, 250_000):
            for skew in (0.0, 0.3):
                for batch in (1, 4, 12):
                    plan = P.plan_hms_split(_depth_of(depth, skew), batch)
                    assert (plan.shards, plan.t_segments) == (1, 1)
            for width in (1, 2, 16):
                assert P.plan_um_split(depth, width).t_segments == 1
    finally:
        P.set_profile(old)


def _drift(caught):
    return [w for w in caught
            if issubclass(w.category, P.CalibrationDriftWarning)]


def test_cpu_calls_plan_under_the_host_profile(tmp_path):
    """A CPU ``simulate`` (HMS scan) and an oversubscribed ``hbm`` one (the
    UM scan)
    record the host profile as their calib_fingerprint with its
    prediction, and raise no CalibrationDriftWarning where the reference
    raises none; the card's profile on the same calls warns (the plain
    versions run some thousand times slower than the card)."""
    import warnings

    from repro import core as RC

    from repro_torch import core as T
    from repro_torch import obs
    from repro_torch.convert import trace_from_arrays

    def traces(n):
        rt = RC.make_trace("gpt_train", n=n)
        return rt, trace_from_arrays(rt.name, rt.col, rt.is_write,
                                     rt.footprint)

    rt, t = traces(2345)                    # an engine key of its own
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter("always")
        for org in ("hms", "hbm"):
            RC.simulate(rt, RC.HMSConfig(footprint=rt.footprint, r_hbm=0.3,
                                         organization=org))
    obs.clear_records()
    obs.enable(str(tmp_path))
    try:
        with warnings.catch_warnings(record=True) as port_w:
            warnings.simplefilter("always")
            for org in ("hms", "hbm"):
                T.simulate(t, T.HMSConfig(footprint=t.footprint, r_hbm=0.3,
                                          organization=org), device="cpu")
        recs = {r.engine: r for r in obs.records()
                if r.engine_key != "um:memoized"}
    finally:
        obs.disable()
        obs.clear_records()
    if not _drift(ref_w):
        assert not _drift(port_w), [str(w.message) for w in port_w]
    host = P.HOST_PROFILE
    assert recs["hms"].calib_fingerprint == host.fingerprint
    assert (recs["hms"].shards, recs["hms"].t_segments) == (1, 1)
    depth = tsim.plan_depth(t, [T.HMSConfig(footprint=t.footprint,
                                            r_hbm=0.3).validate()])(1)
    assert recs["hms"].plan_predicted_us == depth * host.step_cost_solo
    assert recs["um"].calib_fingerprint == host.fingerprint
    assert recs["um"].plan_predicted_us == t.n * host.um_step_cost_solo

    _, t = traces(2346)
    old = P.set_profile(P.DEFAULT_PROFILE)
    try:
        with warnings.catch_warnings(record=True) as card_w:
            warnings.simplefilter("always")
            T.simulate(t, T.HMSConfig(footprint=t.footprint), device="cpu")
    finally:
        P.set_profile(old)
    assert _drift(card_w) and "H100" in str(_drift(card_w)[0].message)
