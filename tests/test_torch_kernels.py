"""The port's kernels against the JAX package, on the CPU.

Each CUDA kernel of ``repro_torch`` has a plain PyTorch version that its
wrapper runs on CPU tensors; these tests hold the plain versions against
the JAX functions exactly, and build the scan kernel's step header with the
host C++ compiler to hold the kernel's own step logic against the plain
step.  The kernels themselves run only on the card (``chip_smoke.py``).
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import amil as ramil
from repro.core import ctc as rctc
from repro.kernels.amil_probe.ops import probe as ref_probe
from repro.kernels.amil_probe.ref import amil_probe_reference

import repro_torch.core as T
from repro_torch.core import amil as tamil
from repro_torch.core import ctc as tctc
from repro_torch.core import simulator as tsim
from repro_torch.core.timing import POLICIES
from repro_torch.kernels.amil_probe import ops as probe_ops
from repro_torch.kernels.hms_scan import ops as scan_ops
from repro_torch.kernels.hms_scan import ref as scan_ref

sys.path.insert(0, str(Path(__file__).parent))
from test_engine_parity import GOLDEN_CONFIGS, _golden_trace  # noqa: E402

CSRC = Path(scan_ref.__file__).parent / "csrc"


# ---------------------------------------------------------------------------
# AMIL probe.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_req,n_slots_16,seed", [
    (1, 16, 0), (255, 16, 1), (256, 64, 2), (257, 256, 3),
    (500, 256, 4), (500, 17, 5), (3, 200, 6), (499, 100, 7),
])
def test_amil_probe_plain_matches_pallas(n_req, n_slots_16, seed):
    rng = np.random.default_rng(seed)
    n_slots = n_slots_16 * 8
    meta = rng.integers(0, 64, (n_slots,)).astype(np.int32)
    slots = rng.integers(0, n_slots, (n_req,)).astype(np.int32)
    tags = rng.integers(0, 4, (n_req,)).astype(np.int32)
    got = probe_ops.probe(torch.from_numpy(meta), torch.from_numpy(slots),
                          torch.from_numpy(tags))
    kernel = ref_probe(jnp.asarray(meta), jnp.asarray(slots),
                       jnp.asarray(tags))
    oracle = amil_probe_reference(jnp.asarray(meta), jnp.asarray(slots),
                                  jnp.asarray(tags))
    for g, k, o in zip(got, kernel, oracle):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(k))
        assert np.array_equal(g.numpy(), np.asarray(o))


def test_amil_pack_and_probe_row_match():
    rng = np.random.default_rng(3)
    fields = [rng.integers(0, 4, (6, 8)), rng.integers(0, 2, (6, 8)),
              rng.integers(0, 2, (6, 8)), rng.integers(0, 4, (6, 8))]
    ref_row = ramil.pack_line_meta(*[jnp.asarray(f) for f in fields])
    got_row = tamil.pack_line_meta(*[torch.from_numpy(f) for f in fields])
    assert np.array_equal(got_row.numpy(), np.asarray(ref_row))
    for g, r in zip(tamil.unpack_line_meta(got_row),
                    ramil.unpack_line_meta(ref_row)):
        assert np.array_equal(g.numpy(), np.asarray(r))
    line = rng.integers(0, 8, (6,))
    want = rng.integers(0, 4, (6,))
    for g, r in zip(tamil.probe_row(got_row, torch.from_numpy(line),
                                    torch.from_numpy(want)),
                    ramil.probe_row(ref_row, jnp.asarray(line),
                                    jnp.asarray(want))):
        assert np.array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# Packed CTC access.
# ---------------------------------------------------------------------------

_ref_pft = jax.jit(rctc.probe_fill_touch_packed)


@pytest.mark.parametrize("sets,ways,enabled,seed", [
    (1, 16, 16, 0), (4, 16, 12, 1), (8, 8, 3, 2), (2, 4, 1, 3),
    (16, 16, 16, 4), (1, 32, 7, 5),
])
def test_ctc_step_matches_reference(sets, ways, enabled, seed):
    """Seeded 500-step sequences, with disabled ways and update=False steps:
    state and hit agree after every step."""
    rng = np.random.default_rng(seed)
    rgs = rng.integers(0, 3 * sets, 500)
    secs = rng.integers(0, 8, 500)
    upd = rng.random(500) < 0.85
    ref = rctc.packed_init(sets, ways, 8)
    got = tctc.packed_init(sets, ways, 8)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    for rg, sec, u in zip(rgs, secs, upd):
        ref, rh = _ref_pft(ref, jnp.int64(rg), jnp.int64(sec),
                           jnp.int32(enabled), jnp.int32(sets),
                           update=jnp.bool_(u))
        got, gh = tctc.probe_fill_touch_packed(
            got, int(rg), int(sec), enabled, sets, update=bool(u))
        assert bool(gh) == bool(rh)
        assert np.array_equal(got.numpy(), np.asarray(ref))


def test_ctc_step_batched_equals_per_lane():
    rng = np.random.default_rng(9)
    lanes, sets, ways = 5, 4, 8
    state = tctc.packed_init(sets, ways, 8).expand(lanes, -1, -1).clone()
    single = [s.clone() for s in state]
    for _ in range(200):
        rg = torch.from_numpy(rng.integers(0, 12, lanes))
        sec = torch.from_numpy(rng.integers(0, 8, lanes))
        upd = torch.from_numpy(rng.random(lanes) < 0.9)
        state, hit = tctc.probe_fill_touch_packed(state, rg, sec, 6, sets,
                                                  update=upd)
        for i in range(lanes):
            single[i], h = tctc.probe_fill_touch_packed(
                single[i], rg[i], sec[i], 6, sets, update=upd[i])
            assert bool(h) == bool(hit[i])
    assert torch.equal(state, torch.stack(single))


# ---------------------------------------------------------------------------
# Scan streams of the golden trace, and the host build of the step header.
# ---------------------------------------------------------------------------

def _golden_streams(kw):
    """The scan kernel's inputs for one golden config, built by the port's
    own engine on the CPU."""
    t = _golden_trace()
    trace = T.Trace(t.name, t.col, t.is_write, t.footprint)
    cfg = T.HMSConfig(footprint=t.footprint, **kw).validate()
    s = tsim.scan_inputs(trace, cfg, torch.device("cpu"))
    return s["slot"], s["meta"], s["scan"]


_HOST_SRC = r"""
#include "hms_step.cuh"

template <int P>
static void run(const int32_t* slot, const int64_t* meta, int lanes,
                int64_t depth, int32_t* cache, int64_t lines, int64_t* ctc,
                int ctc_words, int ways, int e_ways, int n_sets, int32_t* y) {
  for (int l = 0; l < lanes; ++l)
    hms_lane<P>(slot + l * depth, meta + l * depth, depth, cache + l * lines,
                ctc + (int64_t)l * ctc_words, ways, e_ways, n_sets,
                y + l * depth);
}

extern "C" int hms_scan_host(int policy, const int32_t* slot,
                             const int64_t* meta, int lanes, int64_t depth,
                             int32_t* cache, int64_t lines, int64_t* ctc,
                             int ctc_words, int ways, int e_ways, int n_sets,
                             int32_t* y) {
  switch (policy) {
    case 0: run<0>(slot, meta, lanes, depth, cache, lines, ctc, ctc_words, ways, e_ways, n_sets, y); return 0;
    case 1: run<1>(slot, meta, lanes, depth, cache, lines, ctc, ctc_words, ways, e_ways, n_sets, y); return 0;
    case 2: run<2>(slot, meta, lanes, depth, cache, lines, ctc, ctc_words, ways, e_ways, n_sets, y); return 0;
    case 3: run<3>(slot, meta, lanes, depth, cache, lines, ctc, ctc_words, ways, e_ways, n_sets, y); return 0;
    case 4: run<4>(slot, meta, lanes, depth, cache, lines, ctc, ctc_words, ways, e_ways, n_sets, y); return 0;
    case 5: run<5>(slot, meta, lanes, depth, cache, lines, ctc, ctc_words, ways, e_ways, n_sets, y); return 0;
    case 6: run<6>(slot, meta, lanes, depth, cache, lines, ctc, ctc_words, ways, e_ways, n_sets, y); return 0;
    case 7: run<7>(slot, meta, lanes, depth, cache, lines, ctc, ctc_words, ways, e_ways, n_sets, y); return 0;
  }
  return 1;
}
"""


@pytest.fixture(scope="module")
def host_step(tmp_path_factory):
    """``hms_step.cuh`` built for the host by g++ (skips without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of hms_step.cuh needs it")
    d = tmp_path_factory.mktemp("hms_host")
    (d / "host.cpp").write_text(_HOST_SRC)
    so = d / "libhms_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-ffp-contract=off", f"-I{CSRC}", "-o", str(so),
                    str(d / "host.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.hms_scan_host.argtypes = [I, P, P, I, L, P, L, P, I, I, I, I, P]
    lib.hms_scan_host.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("kw", GOLDEN_CONFIGS, ids=[
    "hms", "tad", "no_bypass", "no_2nd", "bear", "mccache", "redcache",
    "no_ctc"])
def test_host_built_step_matches_plain(host_step, kw):
    """The kernel's step header, compiled for the host, gives the plain
    step's decision words and final state on the golden trace."""
    slot, meta, args = _golden_streams(kw)
    y_ref, cache_ref, ctc_ref = scan_ops.hms_scan(slot, meta, **args)
    lanes, depth = slot.shape
    cache, ctc = scan_ref.initial_state(
        lanes, args["lines_alloc"], args["sets_alloc"], args["ways_alloc"],
        args["sectors"], "cpu")
    y = torch.empty_like(slot)
    rc = host_step.hms_scan_host(
        POLICIES.index(args["policy"]), slot.data_ptr(), meta.data_ptr(),
        lanes, depth, cache.data_ptr(), args["lines_alloc"], ctc.data_ptr(),
        args["sets_alloc"] * args["ways_alloc"], args["ways_alloc"],
        args["e_ways"], args["n_sets"], y.data_ptr())
    assert rc == 0
    assert torch.equal(y, y_ref)
    assert torch.equal(cache, cache_ref)
    assert torch.equal(ctc, ctc_ref)
    assert int((y_ref & 1).sum()) > 0              # the trace does hit


def test_scan_lanes_are_independent():
    """Lanes of the plain scan do not interact: two lanes equal two runs."""
    slot, meta, args = _golden_streams({})
    slot, meta = slot[:, :2000], meta[:, :2000]
    half = slot.shape[1] // 2
    two = scan_ops.hms_scan(slot.reshape(2, half), meta.reshape(2, half),
                            **args)
    for lane in range(2):
        one = scan_ops.hms_scan(slot[:, lane * half:(lane + 1) * half],
                                meta[:, lane * half:(lane + 1) * half],
                                **args)
        for a, b in zip(two, one):
            assert torch.equal(a[lane], b[0])


# ---------------------------------------------------------------------------
# EMA scan.
# ---------------------------------------------------------------------------

def test_ema_plain_is_the_rounded_recurrence():
    rng = np.random.default_rng(5)
    v = rng.random(3000) * 300
    got = scan_ops.ema_scan(torch.from_numpy(v), 0.01).numpy()
    avg, want = 0.0, []
    for x in v:                       # Python floats: IEEE, no contraction
        avg = (1.0 - 0.01) * avg + 0.01 * x
        want.append(avg)
    assert np.array_equal(got, np.asarray(want))


def test_ema_plain_matches_jax_scan():
    """The reference's unrolled XLA scan contracts some steps into FMAs, so
    the averages agree to rounding, not bit for bit (the discretized levels
    the engine uses from them agree; see test_torch_simulate)."""
    from repro.core import bypass as rbp
    rng = np.random.default_rng(6)
    v = rng.random(3000) * 300

    def step(a, x):
        nxt = rbp.ema_update(a, x, jnp.float64(0.01))
        return nxt, nxt
    _, ref = jax.lax.scan(step, jnp.zeros((), jnp.float64), jnp.asarray(v),
                          unroll=32)
    got = scan_ops.ema_scan(torch.from_numpy(v), 0.01).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-14, atol=0)


def test_wrappers_refuse_mixed_devices():
    slot = torch.zeros((1, 4), dtype=torch.int32)
    meta = torch.zeros((1, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        scan_ops.hms_scan(slot, meta, policy="hms", e_ways=1, n_sets=1,
                          lines_alloc=8, sets_alloc=1, ways_alloc=1,
                          sectors=8, spg=8)
    with pytest.raises(ValueError):
        probe_ops.amil_probe(torch.zeros(8, dtype=torch.int32),
                             torch.zeros(4, dtype=torch.int32),
                             torch.zeros(4, dtype=torch.int32, device="meta"))
