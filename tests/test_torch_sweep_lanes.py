"""The sweep engine's lanes in the port against the JAX package, on the CPU.

``repro_torch.core.simulate_many`` groups HMS configs by (policy, CTC
sectors) and runs each group's configs x shards x temporal segments as the
lanes of one ``hms_scan`` call a stitch round; its counters must equal
``repro.core.simulate_many``'s at forced (S, T) in {(1, 1), (2, 1),
(1, 3), (2, 4)}, at batch widths 1, 2 and all, with replay 0 and > 0:
integer counters exactly, fractional ones within rtol 1e-9 / atol 1e-6
(``tests/test_engine_parity.py``).  Within the port they are bit for bit
the same at every shape.  The UM engine at T in {1, 2, 4} (wrapped
windows and nvlink included, and a phased trace) equals the reference
exactly.  The ``hms_scan`` plain version with per-lane CTC ways and sets,
seeded state and dead (replay) steps equals separate single-lane calls.
"""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
from repro import um as RU
from repro.workloads import SCENARIOS

import repro_torch.core as T
from repro_torch.convert import config_from_dict, trace_from_arrays
from repro_torch.core import costmodel, tsplit
from repro_torch.core import simulator as tsim
from repro_torch.kernels.hms_scan import ops as scan_ops
from repro_torch.kernels.hms_scan import ref as scan_ref
from repro_torch.um import engine as um_engine

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_simulate import _assert_counters  # noqa: E402
from test_um_engine import _um_trace  # noqa: E402

TOL = dict(rtol=1e-9, atol=1e-6)
# two static groups: CTC configs whose set counts differ per lane (fig18's
# fractions, AMIL and TAD), and a policy without a CTC
GRID = ([{"tag_layout": tl, "ctc_fraction": f}
         for tl in ("amil", "tad") for f in (0.25, 0.0625)]
        + [{"policy": "bear"}, {"policy": "bear", "scm_mode": "slc"}])
UM_FIELDS = ("phase_faults", "phase_migrated", "phase_writebacks",
             "phase_remote_cols")


def _port(t):
    return trace_from_arrays(t.name, t.col, t.is_write, t.footprint,
                             t.phase_id, t.phase_names)


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


@pytest.fixture(scope="module")
def sweep():
    t = R.make_trace("zipf", n=2500)
    cfgs = [R.HMSConfig(footprint=t.footprint, **kw) for kw in GRID]
    ref = R.simulate_many(t, cfgs)
    import dataclasses
    return (_port(t), [config_from_dict(dataclasses.asdict(c))
                       for c in cfgs], ref)


def _bits(r):
    out = {k: np.float64(v).tobytes() for k, v in r.counters.items()}
    out["runtime"] = np.float64(r.runtime_cycles).tobytes()
    return out


def _check(got, ref):
    for g, r in zip(got, ref):
        _assert_counters(g.counters, r.counters)
        np.testing.assert_allclose(g.runtime_cycles, r.runtime_cycles, **TOL)


@pytest.mark.parametrize("S,Tt", [(1, 1), (2, 1), (1, 3), (2, 4)])
@pytest.mark.parametrize("replay", [0, 8])
def test_batched_lanes_match_reference(sweep, S, Tt, replay):
    t, cfgs, ref = sweep
    del tsim._RUNS[:]
    with shape(S, Tt, replay):
        got = T.simulate_many(t, cfgs, device="cpu")
    _check(got, ref)
    # one guarded run a group, at the forced shape, all configs as lanes
    runs = sorted((r["batch"], r["shards"], r["t_segments"], r["replay"])
                  for r in tsim._RUNS)
    assert runs == [(2, S, Tt, replay if Tt > 1 else 0),
                    (4, S, Tt, replay if Tt > 1 else 0)]
    assert all(r["rounds"] >= 1 and r["rounds"] <= Tt + 1 + (replay > 0)
               for r in tsim._RUNS)
    if (S, Tt, replay) != (1, 1, 0):
        with shape(1, 1):
            one = T.simulate_many(t, cfgs, device="cpu")
        assert [_bits(a) for a in got] == [_bits(b) for b in one]


@pytest.mark.parametrize("width", [1, 2])
def test_batch_widths_match_reference(sweep, width):
    t, cfgs, ref = sweep
    with shape(2, 4, 8):
        got = T.simulate_many(t, cfgs[:width], device="cpu")
        alone = T.simulate(t, cfgs[0], device="cpu")
    _check(got, ref[:width])
    assert _bits(alone) == _bits(got[0])


def test_group_engine_key_takes_group_maxima(sweep):
    t, cfgs, _ = sweep
    with shape(2, 4, 8):
        key = tsim.group_engine_key(t, cfgs[:4])
        keys = [tsim._engine_key(t, c) for c in cfgs[:4]]
    assert (key.shards, key.t_segments, key.replay) == (2, 4, 8)
    assert key.ctc_sets_alloc == max(k.ctc_sets_alloc for k in keys)
    assert key.depth == max(k.depth for k in keys)
    with pytest.raises(ValueError, match="one static-structure group"):
        tsim.group_engine_key(t, cfgs[3:5])


def _um_specs():
    return [RU.UMSpec(n_frames=64, chunk=4),
            RU.UMSpec(n_frames=7, chunk=8),            # window wraps
            RU.UMSpec(n_frames=40, chunk=1, nvlink=True, hot_thresh=4),
            RU.UMSpec(n_frames=9, chunk=1, nvlink=True, hot_thresh=2)]


@pytest.fixture(scope="module")
def um_ref():
    plain = _um_trace(n=2500)
    phased = SCENARIOS["llm_serve"].compile(n=1500)
    out = {}
    for t in (plain, phased):
        out[t.name] = (_port(t), RU.simulate_um_many(t, _um_specs()))
    return out


@pytest.mark.parametrize("Tt,replay", [(1, 0), (2, 0), (4, 0), (4, 16)])
@pytest.mark.parametrize("name", ["um_golden", "llm_serve"])
def test_um_segments_match_reference(um_ref, name, Tt, replay):
    t, ref = um_ref[name]
    specs = [um_engine.UMSpec(**s.__dict__) for s in _um_specs()]
    um_engine._RESULT_CACHE.pop(t, None)
    with shape(None, Tt, replay):
        got = um_engine.simulate_um_many(t, specs, device="cpu")
    run = um_engine._RUNS[-1]
    assert (run["t_segments"], run["lanes"]) == (Tt, len(specs))
    for g, r in zip(got, ref):
        for f in UM_FIELDS:
            assert np.array_equal(getattr(g, f), getattr(r, f)), (f, g.spec)


# ---------------------------------------------------------------------------
# The plain scan's lanes: per-lane CTC geometry, seeded state, dead steps.
# ---------------------------------------------------------------------------

def _lane_streams():
    """Three configs of one static group (CTC fractions 1, 0.25, 0.0625:
    different set counts, 24 of 32 ways enabled in one) as single-lane
    streams on one allocation."""
    t = R.make_trace("bfs_tu", n=1200)
    pt = _port(t)
    lanes = []
    for kw in ({"ctc_fraction": 1.0, "ctc_ways": 24}, {"ctc_fraction": 0.25},
               {"ctc_fraction": 0.0625}):
        cfg = T.HMSConfig(footprint=pt.footprint, **kw).validate()
        lanes.append(tsim.scan_inputs(pt, cfg, torch.device("cpu")))
    alloc = dict(policy="hms", lines_alloc=max(s["scan"]["lines_alloc"]
                                               for s in lanes),
                 sets_alloc=max(s["scan"]["sets_alloc"] for s in lanes),
                 ways_alloc=max(s["scan"]["ways_alloc"] for s in lanes),
                 sectors=lanes[0]["scan"]["sectors"])
    return lanes, alloc


def test_plain_scan_lanes_equal_single_lane_calls():
    lanes, alloc = _lane_streams()
    ways = [s["scan"]["e_ways"] for s in lanes]
    sets = [s["scan"]["n_sets"] for s in lanes]
    assert len(set(sets)) == 3 and len(set(ways)) == 2
    half = lanes[0]["slot"].shape[1] // 2
    slot = torch.cat([s["slot"] for s in lanes])
    meta = torch.cat([s["meta"] for s in lanes])
    # each lane alone, whole; then its first half, and its second half
    # seeded from the first half's final state
    whole = [scan_ops.hms_scan(s["slot"], s["meta"], e_ways=w, n_sets=n,
                               spg=s["scan"]["spg"], **alloc)
             for s, w, n in zip(lanes, ways, sets)]
    first = [scan_ops.hms_scan(s["slot"][:, :half], s["meta"][:, :half],
                               e_ways=w, n_sets=n, spg=s["scan"]["spg"],
                               **alloc)
             for s, w, n in zip(lanes, ways, sets)]
    spg = [s["scan"]["spg"] for s in lanes]
    # all three as the lanes of one call, each with its own geometry,
    # seeded with its first half's state; dead steps (the live bit
    # cleared: a replay prefix after the warm-up round) prepended
    dead = meta[:, :50] & ~(1 << 16)
    y, cache, ctc = scan_ops.hms_scan(
        torch.cat([slot[:, :50], slot[:, half:]], 1),
        torch.cat([dead, meta[:, half:]], 1), e_ways=ways, n_sets=sets,
        spg=spg, cache=torch.cat([f[1] for f in first]),
        ctc=torch.cat([f[2] for f in first]), **alloc)
    for j, w in enumerate(whole):
        assert torch.equal(y[j, 50:], w[0][0, half:])
        assert torch.equal(cache[j], w[1][0])
        assert torch.equal(ctc[j], w[2][0])
    # the seeds were not written
    assert torch.equal(first[0][1][0], scan_ops.hms_scan(
        lanes[0]["slot"][:, :half], lanes[0]["meta"][:, :half],
        e_ways=ways[0], n_sets=sets[0], spg=spg[0], **alloc)[1][0])


def test_plain_scan_refuses_mismatched_lane_parameters():
    lanes, alloc = _lane_streams()
    s = lanes[0]
    slot = torch.cat([s["slot"], s["slot"]])
    meta = torch.cat([s["meta"], s["meta"]])
    with pytest.raises(ValueError, match="values of e_ways"):
        scan_ops.hms_scan(slot, meta, e_ways=[8, 8, 8], n_sets=1,
                          spg=s["scan"]["spg"], **alloc)
    with pytest.raises(ValueError, match="cache int32"):
        scan_ops.hms_scan(slot, meta, e_ways=8, n_sets=1,
                          spg=s["scan"]["spg"],
                          cache=torch.zeros(1, alloc["lines_alloc"],
                                            dtype=torch.int32), **alloc)
