"""The port's UM paging engine against the JAX package's, on the CPU.

The same traces and specs go through ``repro.um`` (its XLA scan on the
CPU, and the frozen ``run_um_reference``) and ``repro_torch.um`` with
``device="cpu"`` (the ``um_scan`` kernel's plain version).  All four UM
counters are integers and must match exactly, per phase; ``simulate`` and
``simulate_many`` on the ``hbm`` organization and on HMS footprint
overflows match the reference's counters (integer-valued ones exactly,
fractional ones to rtol 1e-9 / atol 1e-6) and runtime.  The port's
counters also equal the 16 points of ``benchmarks/baselines/BENCH_um.json``
without JAX.  Then g++ builds the kernel's step header
(``kernels/um_scan/csrc/um_step.cuh``) for the host, whose lane walk must
equal the plain version, state and counters, on every quirk the reference
has: windows that wrap the frame ring, chunks clipped at the last page,
both link modes, chunks of 1 to 64 and phased streams.
"""

import ctypes
import dataclasses
import gc
import json
import shutil
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
from repro import um as RU
from repro.core.timing import UM_PAGE_BYTES
from repro.um._reference import run_um_reference
from repro.workloads import SCENARIOS

import repro_torch.core as T
from repro_torch import um as TU
from repro_torch.convert import config_from_dict, trace_from_arrays
from repro_torch.kernels.um_scan import ops as um_ops
from repro_torch.kernels.um_scan import ref as um_ref
from repro_torch.um import engine as um_engine

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_simulate import _assert_counters, _assert_result  # noqa: E402
from test_um_engine import _um_trace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH_UM = ROOT / "benchmarks" / "baselines" / "BENCH_um.json"
CSRC = Path(um_ref.__file__).parent / "csrc"
FIELDS = ("phase_faults", "phase_migrated", "phase_writebacks",
          "phase_remote_cols")


def _port_trace(t):
    return trace_from_arrays(t.name, t.col, t.is_write, t.footprint,
                             t.phase_id, t.phase_names)


def _port_spec(s):
    return TU.UMSpec(s.n_frames, s.chunk, s.nvlink, s.hot_thresh)


def _assert_um_equal(got, ref):
    for f in FIELDS:
        g, r = getattr(got, f), getattr(ref, f)
        assert g.dtype == r.dtype == np.float64, f
        assert np.array_equal(g, r), (f, g, r)


def _port_vs_jax(trace, specs):
    """Each spec through both engines; returns the port's results."""
    got = TU.simulate_um_many(_port_trace(trace),
                              [_port_spec(s) for s in specs], device="cpu")
    for g, r in zip(got, RU.simulate_um_many(trace, specs)):
        _assert_um_equal(g, r)
    return got


def _page_trace(name, pages, writes, n_pages):
    """A trace touching the given 4 KiB pages, one column each."""
    per_page = UM_PAGE_BYTES // R.COLUMN_BYTES
    col = np.asarray(pages, np.int64) * per_page
    return R.Trace(name, col, np.asarray(writes, bool),
                   n_pages * UM_PAGE_BYTES)


def _reference_cfg(n_frames, chunk):
    """An HMSConfig whose UM frames and chunk are these (as the reference's
    own reference rung builds them)."""
    return R.HMSConfig(footprint=n_frames * UM_PAGE_BYTES, r_hbm=1.0,
                       organization="hbm", um_prefetch_pages=chunk)


# ---------------------------------------------------------------------------
# Spec lanes against the JAX engine.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r_hbm,chunk", [(0.3, 4), (0.6, 1), (0.85, 8)],
                         ids=["deep_oversub", "unchunked", "shallow_chunk8"])
def test_fault_mode_matches_reference(r_hbm, chunk):
    t = _um_trace()
    cfg = R.HMSConfig(footprint=t.footprint, r_hbm=r_hbm,
                      um_prefetch_pages=chunk, organization="hbm")
    got, = _port_vs_jax(t, [RU.um_spec(cfg, nvlink=False)])
    assert got.faults > 0 and got.migrated > 0      # the case paged
    assert (got.faults, got.migrated, got.writebacks, got.remote_cols) == \
        tuple(float(x) for x in run_um_reference(t, cfg, nvlink=False))


@pytest.mark.parametrize("r_hbm", [0.3, 0.7], ids=["deep", "shallow"])
@pytest.mark.parametrize("hot", [4, 2])
def test_nvlink_mode_matches_reference(r_hbm, hot):
    t = _um_trace()
    cfg = R.HMSConfig(footprint=t.footprint, r_hbm=r_hbm,
                      um_hot_threshold=hot, organization="hbm")
    got, = _port_vs_jax(t, [RU.um_spec(cfg, nvlink=True)])
    assert got.remote_cols > 0 and got.migrated > 0
    if hot == 4:                 # the frozen reference pins the threshold
        assert (got.faults, got.migrated, got.writebacks,
                got.remote_cols) == tuple(
            float(x) for x in run_um_reference(t, cfg, nvlink=True))


def test_mixed_lanes_in_one_call_match_reference():
    """Fault and nvlink lanes of several chunks and frame counts in one
    call: the batch's padding does not leak between lanes."""
    t = _um_trace(n=3000)
    specs = [RU.UMSpec(200, 8), RU.UMSpec(900, 1), RU.UMSpec(50, 4),
             RU.UMSpec(300, 1, True, 3), RU.UMSpec(30, 1, True, 0)]
    _port_vs_jax(t, specs)


# ---------------------------------------------------------------------------
# Known answers: the reference's quirks.
# ---------------------------------------------------------------------------

def test_tail_clip_known_answer():
    """7 pages, chunk 4: a fault in the last chunk (pages 4-7) clips to page
    6, which then comes in once per duplicate."""
    t = _page_trace("tail7", [6, 0, 1, 2, 3, 4, 5, 6, 0, 6, 5, 1],
                    [1, 0, 1, 0, 0, 1, 0, 1, 0, 0, 1, 0], 7)
    spec = RU.UMSpec(n_frames=3, chunk=4)
    got, = _port_vs_jax(t, [spec])
    want = (3.0, 9.0, 1.0, 0.0)
    assert (got.faults, got.migrated, got.writebacks, got.remote_cols) == want
    assert tuple(float(x) for x in run_um_reference(
        t, _reference_cfg(3, 4))) == want


_WRAP_CASES = [(5, 4, False), (3, 8, False), (2, 1, True), (6, 2, False)]


def _wrap_trace(n_frames):
    rng = np.random.default_rng(11 + n_frames)
    pages = rng.integers(0, 42, 600)
    pages[::7] = 41                               # the clipped tail chunk
    writes = rng.random(600) < 0.4
    return _page_trace("wrap", pages, writes, 42)


@pytest.mark.parametrize("n_frames,chunk,nvlink", _WRAP_CASES)
def test_window_wrap_matches_reference(n_frames, chunk, nvlink):
    """Fewer frames than the 4 x chunk window: candidate frames repeat, the
    same frame may be chosen twice (the later chunk lane's page wins) and a
    twice-evicted dirty page writes back twice.  42 pages also clip the
    last chunk."""
    got, = _port_vs_jax(_wrap_trace(n_frames), [RU.UMSpec(
        n_frames, 1 if nvlink else chunk, nvlink, 2 if nvlink else 0)])
    assert got.migrated > 0 and got.writebacks > 0


def test_frozen_reference_on_wrapped_windows():
    """The frozen scan agrees with the engine on wrapped windows except
    where a victim page repeats among the chunk lanes, evicted by one lane
    and not by another: its ``resident.at[ev_pages].set(where(ev_valid,
    False, resident[ev_pages]))`` then keeps whichever lane comes last,
    where the engine routes the lanes that evict nothing to a dump slot.
    The port follows the engine (the test above); this pins both."""
    for n_frames, chunk in ((3, 8), (6, 2)):
        t = _wrap_trace(n_frames)
        got, = TU.simulate_um_many(_port_trace(t),
                                   [TU.UMSpec(n_frames, chunk)],
                                   device="cpu")
        assert (got.faults, got.migrated, got.writebacks,
                got.remote_cols) == tuple(float(x) for x in run_um_reference(
                    t, _reference_cfg(n_frames, chunk)))
    t = _wrap_trace(5)
    got, = TU.simulate_um_many(_port_trace(t), [TU.UMSpec(5, 4)],
                               device="cpu")
    ref = run_um_reference(t, _reference_cfg(5, 4))
    assert (got.faults, got.migrated, got.writebacks) == (133.0, 205.0, 49.0)
    assert tuple(int(x) for x in ref[:3]) == (133, 205, 50)


def test_repeated_frame_takes_the_later_lane():
    """One frame, chunk 2: both chunk lanes name frame 0.  The later lane's
    page (1) wins, so the next fault evicts page 1 and page 0 stays
    resident (2 faults); had the first lane won, page 0 would be evicted
    and fault again (3)."""
    t = _page_trace("repeat", [0, 2, 0], [0, 0, 0], 4)
    got, = _port_vs_jax(t, [RU.UMSpec(n_frames=1, chunk=2)])
    assert (got.faults, got.migrated, got.writebacks) == (2.0, 4.0, 0.0)
    page = torch.tensor([0, 2, 0], dtype=torch.int32)
    _, (resident, _, frames, _, _) = um_ops.um_scan(
        page, torch.zeros(3, dtype=torch.bool), n_pages=4, n_frames=[1],
        chunk=[2], nvlink=[False], hot_thresh=[0])
    assert frames[0, 0] == 3
    assert resident[0, :4].tolist() == [True, False, True, True]


# ---------------------------------------------------------------------------
# Early-out, dedupe and memo, phases.
# ---------------------------------------------------------------------------

class _Spy:
    """Stands in for ``ops.um_scan`` in the engine, recording each call's
    lane count."""

    def __init__(self, fn=um_ops.um_scan):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        self.calls.append(len(kw["n_frames"]))
        return self.fn(*args, **kw)


def test_early_out_runs_no_scan(monkeypatch):
    spy = _Spy(fn=None)
    monkeypatch.setattr(um_engine.um_ops, "um_scan", spy)
    t = T.make_trace("zipf", n=2000)
    n_pages = t.footprint // UM_PAGE_BYTES
    r = TU.simulate_um_many(t, [TU.UMSpec(n_pages, 4),
                                TU.UMSpec(2 * n_pages, 1, True)],
                            device="cpu")
    assert spy.calls == []
    for x in r:
        assert (x.faults, x.migrated, x.writebacks, x.remote_cols) == (0,) * 4
        assert x.phase_faults.shape == (1,)


def test_duplicate_specs_run_as_one_lane(monkeypatch):
    spy = _Spy()
    monkeypatch.setattr(um_engine.um_ops, "um_scan", spy)
    t = T.make_trace("bfs_tu", n=2000)
    a, b = TU.UMSpec(300, 4), TU.UMSpec(300, 1, True, 4)
    r = TU.simulate_um_many(t, [a, b, a, b, a], device="cpu")
    # one call a stitch round (one round unless the planner splits T)
    rounds = um_engine._RUNS[-1]["rounds"]
    assert spy.calls == [2] * rounds
    assert r[0] is r[2] is r[4] and r[1] is r[3]
    assert [x.spec for x in r] == [a, b, a, b, a]
    again = TU.simulate_um_many(t, [b, a], device="cpu")   # memoized
    assert spy.calls == [2] * rounds and again == [r[1], r[0]]
    # the memo holds the trace weakly
    ref = weakref.ref(t)
    del t, r, again
    gc.collect()
    assert ref() is None


@pytest.mark.parametrize("scenario", ["moe_expert", "llm_serve"])
def test_phased_counters_match_reference(scenario):
    """Per-phase vectors equal the JAX engine's, and the totals are their
    sums."""
    t = R.make_trace(scenario, n=4000)
    cfg = R.HMSConfig(footprint=t.footprint, organization="hbm", r_hbm=0.5)
    specs = [RU.um_spec(cfg, False), RU.um_spec(cfg, True)]
    results = _port_vs_jax(t, specs)
    for got in results:
        assert got.phase_faults.shape == (t.n_phases,)
        assert got.faults == float(np.sum(got.phase_faults))
        assert got.counter_arrays()["um_faults"] is got.phase_faults
    assert results[0].faults > 0 and results[1].remote_cols > 0


def test_default_device_without_cuda_raises(monkeypatch):
    """The UM entry points run on the card by default and never fall back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = T.make_trace("zipf", n=500)
    with pytest.raises(RuntimeError, match="CUDA"):
        TU.simulate_um_many(t, [TU.UMSpec(8, 4)])
    with pytest.raises(RuntimeError, match="CUDA"):
        T.simulate_many(t, [T.HMSConfig(footprint=t.footprint,
                                        organization="hbm")])


def test_invalid_spec_raises():
    t = T.make_trace("zipf", n=500)
    with pytest.raises(ValueError, match="UMSpec.n_frames"):
        TU.simulate_um_many(t, [TU.UMSpec(0, 4)], device="cpu")
    with pytest.raises(ValueError, match="UMSpec.chunk"):
        TU.simulate_um_many(t, [TU.UMSpec(8, 0)], device="cpu")
    with pytest.raises(ValueError, match="UMSpec.hot_thresh"):
        TU.simulate_um_many(t, [TU.UMSpec(8, 1, True, -1)], device="cpu")


# ---------------------------------------------------------------------------
# simulate and simulate_many.
# ---------------------------------------------------------------------------

def _sim_port(t, cfg, **kw):
    return T.simulate(_port_trace(t), config_from_dict(
        dataclasses.asdict(cfg)), device="cpu", **kw)


@pytest.mark.parametrize("nvlink", [False, True], ids=["fault", "nvlink"])
def test_simulate_hbm_matches_reference(nvlink):
    t = _um_trace(n=4000)
    cfg = R.HMSConfig(footprint=t.footprint, organization="hbm", r_hbm=0.5)
    ref = R.simulate(t, cfg, nvlink=nvlink)
    got = _sim_port(t, cfg, nvlink=nvlink)
    _assert_result(got, ref)
    assert got.counters["um_faults"] > 0
    assert (got.terms["fault"] == 0.0) == nvlink


@pytest.mark.parametrize("nvlink", [False, True], ids=["fault", "nvlink"])
def test_simulate_hms_overflow_matches_reference(nvlink):
    t = _um_trace(n=4000)
    cfg = R.HMSConfig(footprint=t.footprint, r_hbm=0.1)
    assert t.footprint > cfg.scm_capacity + cfg.dram_cache_capacity
    ref = R.simulate(t, cfg, nvlink=nvlink)
    got = _sim_port(t, cfg, nvlink=nvlink)
    _assert_result(got, ref)
    assert got.counters["um_faults"] > 0 and ref.terms["link"] > 0


def test_simulate_phased_overflow_matches_reference():
    """A scenario at 4x oversubscription over a pinned nominal capacity:
    the HMS scan and the UM overflow, both attributed per phase."""
    t = SCENARIOS["llm_serve"].compile(n=4000, oversub=4.0)
    cfg = R.HMSConfig(footprint=t.footprint // 4)
    ref = R.simulate(t, cfg)
    got = _sim_port(t, cfg)
    _assert_result(got, ref)
    _assert_counters(got.phase_counters, ref.phase_counters, "per-phase")
    got_s, ref_s = got.phase_summary(), ref.phase_summary()
    assert list(got_s) == list(ref_s)
    for name in ref_s:
        assert got_s[name] == pytest.approx(ref_s[name], rel=1e-9, abs=1e-6)
        assert got_s[name]["um_faults"] == ref_s[name]["um_faults"]
    for k, v in got.phase_counters.items():
        assert got.counters[k] == float(np.sum(v)), k


def test_simulate_many_mixed_batch_matches_reference(monkeypatch):
    t = _um_trace(n=3000)
    cfgs = [R.HMSConfig(footprint=t.footprint, organization="hbm",
                        r_hbm=0.5),
            R.HMSConfig(footprint=t.footprint),
            R.HMSConfig(footprint=t.footprint, r_hbm=0.1),
            R.HMSConfig(footprint=t.footprint, organization="inf_hbm"),
            R.HMSConfig(footprint=t.footprint, organization="hbm",
                        r_hbm=0.5)]
    spy = _Spy()
    monkeypatch.setattr(um_engine.um_ops, "um_scan", spy)
    pt = _port_trace(t)
    got = T.simulate_many(pt, [config_from_dict(
        dataclasses.asdict(c)) for c in cfgs], device="cpu")
    # one launch a stitch round: hbm and the overflow
    rounds = um_engine._RUNS[-1]["rounds"]
    assert spy.calls == [2] * rounds
    ref = R.simulate_many(t, cfgs)
    assert len(got) == len(ref) == len(cfgs)
    for g, r, c in zip(got, ref, cfgs):
        assert g.config.organization == c.organization
        _assert_result(g, r)
    # and simulate, config by config, on the same trace
    for g, c in zip(got, cfgs):
        one = T.simulate(pt, config_from_dict(
            dataclasses.asdict(c)), device="cpu")
        assert one.counters == g.counters
        assert one.runtime_cycles == g.runtime_cycles
    assert spy.calls == [2] * rounds


# ---------------------------------------------------------------------------
# The committed UM baseline, without JAX.
# ---------------------------------------------------------------------------

_BENCH = json.loads(BENCH_UM.read_text())
_POINTS = [(w, i) for w, e in _BENCH["workloads"].items()
           for i in range(len(e["points"]))]


def _trace_fp(trace):
    """The baseline's trace fingerprint (the reference's sweep checkpoint
    hash: name, length, footprint, phases, the request stream)."""
    import hashlib
    h = hashlib.sha256()
    h.update(repr((trace.name, int(trace.n), int(trace.footprint),
                   tuple(trace.phase_names))).encode())
    h.update(np.ascontiguousarray(np.asarray(trace.col, np.int64)).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(trace.is_write, np.uint8)).tobytes())
    if trace.phase_id is not None:
        h.update(np.ascontiguousarray(
            np.asarray(trace.phase_id, np.int32)).tobytes())
    return h.hexdigest()[:16]


@pytest.fixture(scope="module")
def bench_um_results():
    """The port's results on every baseline point, one batch a workload,
    as the um suite batches them."""
    out = {}
    for w, entry in _BENCH["workloads"].items():
        t = T.make_trace(w, n=_BENCH["n"])
        assert _trace_fp(t) == entry["trace_fp"], w
        specs = [TU.um_spec(T.HMSConfig(footprint=t.footprint,
                                        organization="hbm",
                                        r_hbm=1.0 / p["rel_footprint"]),
                            p["nvlink"]) for p in entry["points"]]
        out[w] = TU.simulate_um_many(t, specs, device="cpu")
    return out


@pytest.mark.parametrize("w,i", _POINTS,
                         ids=[f"{w}-{i}" for w, i in _POINTS])
def test_bench_um_point_matches_baseline(bench_um_results, w, i):
    p = _BENCH["workloads"][w]["points"][i]
    r = bench_um_results[w][i]
    from repro_torch.resilience.validate import validate_um_spec
    validate_um_spec(r.spec)
    key = (f"F{r.spec.n_frames}:c{r.spec.chunk}:nv{int(r.spec.nvlink)}"
           f":h{r.spec.hot_thresh}")
    assert key == p["spec_key"]
    for k, f in zip(("um_faults", "um_migrated", "um_writebacks",
                     "um_remote_cols"), FIELDS):
        assert getattr(r, f).tolist() == p["counters"][k], k
    assert r.link_bytes == p["link_bytes"]


# ---------------------------------------------------------------------------
# The kernel's step header, built for the host by g++.
# ---------------------------------------------------------------------------

_HOST_SRC = r"""
#include "um_step.cuh"

// Every lane over the stream, one after another (the kernel runs one warp
// per lane; here nlanes = 1).  params: int32[lanes, 4].
extern "C" void walk(const int32_t* page, const uint8_t* is_write,
                     const int32_t* phase, int64_t n, int n_phases,
                     const int32_t* params, int lanes, int32_t n_pages,
                     uint8_t* resident, uint8_t* dirty, int64_t pa,
                     int32_t* frames, int64_t fa, int32_t* hotness,
                     int32_t* ptr, int64_t* counts) {
  UmWork wk;
  for (int l = 0; l < lanes; ++l) {
    UmLane L;
    L.resident = resident + l * (pa + 1);
    L.dirty = dirty + l * (pa + 1);
    L.frames = frames + l * (fa + 1);
    L.hotness = hotness + l * pa;
    L.ptr = 0;
    L.n_pages = n_pages;
    L.n_frames = params[4 * l];
    L.chunk = params[4 * l + 1];
    L.nvlink = params[4 * l + 2] != 0;
    L.hot_thresh = params[4 * l + 3];
    UmStream src{page, is_write, phase};
    um_walk<1>(src, n, n_phases, L, wk, counts + (int64_t)l * 4 * n_phases,
               0);
    ptr[l] = L.ptr;
  }
}

extern "C" void ranks(const int32_t* hot, int w, int32_t* out) {
  int32_t h[UM_MAX_WINDOW] = {0};
  int r[UM_MAX_WINDOW];
  UmWork wk;
  for (int c = 0; c < w; ++c) h[c] = hot[c];
  um_window_ranks<1, UM_MAX_WINDOW>(wk, h, w, 0, r);
  for (int c = 0; c < w; ++c) out[c] = r[c];
}

extern "C" int max_chunk() { return UM_MAX_CHUNK; }
"""


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    """um_step.cuh built for the host by g++ (skips without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of um_step.cuh needs it")
    d = tmp_path_factory.mktemp("um_step")
    (d / "um_host.cpp").write_text(_HOST_SRC)
    so = d / "libum_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "um_host.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.walk.argtypes = [P, P, P, L, I, P, I, I, P, P, L, P, L, P, P, P]
    lib.walk.restype = None
    lib.ranks.argtypes = [P, I, P]
    lib.ranks.restype = None
    lib.max_chunk.restype = I
    return lib


def _host_walk(lib, page, is_write, phase, n_phases, n_pages, lanes):
    """The kernel's lane walk on the host: (counts, state) as um_scan
    returns them."""
    n_frames, chunk, nvlink, hot = lanes
    state = um_ref.initial_state(len(n_frames), n_pages, max(n_frames),
                                 "cpu")
    resident, dirty, frames, ptr, hotness = state
    counts = torch.zeros(len(n_frames), 4, n_phases, dtype=torch.int64)
    params = um_ops._lane_params(*lanes)
    lib.walk(page.data_ptr(), is_write.data_ptr(),
             phase.data_ptr() if phase is not None else None, page.shape[0],
             n_phases, params.data_ptr(), len(n_frames), n_pages,
             resident.data_ptr(), dirty.data_ptr(), resident.shape[1] - 1,
             frames.data_ptr(), frames.shape[1] - 1, hotness.data_ptr(),
             ptr.data_ptr(), counts.data_ptr())
    return counts.to(torch.float64), state


def _random_stream(seed, n, n_pages, n_phases=1, local=0.7):
    """Pages with locality (runs near the last page) and a uniform tail,
    30% writes, and a phase id in runs that revisit earlier phases."""
    rng = np.random.default_rng(seed)
    jump = rng.integers(0, n_pages, n)
    step = rng.integers(-3, 4, n)
    page = np.empty(n, np.int64)
    cur = 0
    for i in range(n):
        cur = (cur + step[i]) % n_pages if rng.random() < local else jump[i]
        page[i] = cur
    page[-1] = n_pages - 1                      # the page count is exact
    writes = rng.random(n) < 0.3
    phase = None
    if n_phases > 1:
        phase = torch.from_numpy(
            (np.arange(n) // max(1, n // (2 * n_phases)) % n_phases)
            .astype(np.int32))
    return (torch.from_numpy(page.astype(np.int32)), torch.from_numpy(writes),
            phase)


_DESIGN_CASES = {
    # name: (n, n_pages, n_phases, lanes as (n_frames, chunk, nvlink, hot))
    "chunk1": (1500, 300, 1, ([40, 250], [1, 1], [False, False], [0, 0])),
    "chunk4_clip": (1500, 301, 1, ([60, 7], [4, 4], [False, False], [0, 0])),
    "chunk8_wrap": (1200, 203, 1, ([20, 9], [8, 8], [False, False], [0, 0])),
    "chunk64": (800, 517, 1, ([300, 100, 70], [64, 64, 64],
                              [False, False, False], [0, 0, 0])),
    "nvlink": (1500, 300, 1, ([50, 3, 120], [1, 1, 1], [True, True, True],
                              [4, 0, 2])),
    "mixed_phased": (1500, 257, 3, ([64, 5, 40, 100], [8, 2, 1, 1],
                                    [False, False, True, True],
                                    [0, 0, 4, 1])),
}


@pytest.mark.parametrize("case", sorted(_DESIGN_CASES))
def test_host_walk_matches_plain(step_lib, case):
    n, n_pages, n_phases, lanes = _DESIGN_CASES[case]
    seed = sorted(_DESIGN_CASES).index(case)    # fixed: reproducible
    page, wr, phase = _random_stream(seed, n, n_pages, n_phases)
    got = _host_walk(step_lib, page, wr, phase, n_phases, n_pages, lanes)
    want = um_ops.um_scan(page, wr, phase, n_phases=n_phases,
                          n_pages=n_pages, n_frames=lanes[0],
                          chunk=lanes[1], nvlink=lanes[2],
                          hot_thresh=lanes[3])
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)
    assert bool((got[0][:, 1] > 0).all())       # every lane migrated
    # the stream ends on page n_pages - 1, so in fault mode its chunk faults
    # once at least: clipped where n_pages is no multiple of the chunk; a
    # lane that faults with 4 x chunk > n_frames wraps its window
    faults = got[0][:, 0].sum(dim=1)
    lane_params = list(zip(*lanes[:3]))
    if "clip" in case:
        assert any(not v and n_pages % c for _, c, v in lane_params)
    if "wrap" in case:
        assert any(4 * (1 if v else c) > f and faults[j] > 0
                   for j, (f, c, v) in enumerate(lane_params))


def test_host_walk_clip_and_wrap_known_answer(step_lib):
    page = torch.tensor([6, 0, 1, 2, 3, 4, 5, 6, 0, 6, 5, 1],
                        dtype=torch.int32)
    wr = torch.tensor([1, 0, 1, 0, 0, 1, 0, 1, 0, 0, 1, 0], dtype=torch.bool)
    counts, _ = _host_walk(step_lib, page, wr, None, 1, 7,
                           ([3], [4], [False], [0]))
    assert counts[0, :, 0].tolist() == [3.0, 9.0, 1.0, 0.0]


def test_stable_rank_is_stable_argsort(step_lib):
    rng = np.random.default_rng(4)
    assert step_lib.max_chunk() == um_ops.MAX_CHUNK
    for w in (1, 4, 16, 32, 100, 256):
        for hi in (1, 3, 50):                    # many ties, some, few
            hot = torch.from_numpy(rng.integers(0, hi, w).astype(np.int32))
            out = torch.empty(w, dtype=torch.int32)
            step_lib.ranks(hot.data_ptr(), w, out.data_ptr())
            order = torch.argsort(hot, stable=True)
            assert torch.equal(order[out.long()], torch.arange(w))


def test_kernel_tier():
    assert um_ops.kernel_tier(1) == 1
    assert um_ops.kernel_tier(8) == 1
    assert um_ops.kernel_tier(16) == 2
    assert um_ops.kernel_tier(64) == 8
    with pytest.raises(ValueError, match="tier of 64 pages"):
        um_ops.kernel_tier(65)
    # the plain version takes any chunk
    page, wr, _ = _random_stream(3, 300, 400)
    counts, _ = um_ops.um_scan(page, wr, n_pages=400, n_frames=[100],
                               chunk=[128], nvlink=[False], hot_thresh=[0])
    assert counts[0, 1, 0] > 0


def test_um_scan_rejects_bad_inputs():
    page = torch.zeros(4, dtype=torch.int32)
    wr = torch.zeros(4, dtype=torch.bool)
    kw = dict(n_pages=2, n_frames=[1], chunk=[1], nvlink=[False],
              hot_thresh=[0])
    with pytest.raises(ValueError, match="int32"):
        um_ops.um_scan(page.long(), wr, **kw)
    with pytest.raises(ValueError, match="n_frames >= 1"):
        um_ops.um_scan(page, wr, **{**kw, "n_frames": [0]})
    with pytest.raises(ValueError, match="unequal"):
        um_ops.um_scan(page, wr, **{**kw, "chunk": [1, 2]})
    with pytest.raises(RuntimeError, match="out of"):
        um_ops.um_scan(page + 5, wr, **kw)
