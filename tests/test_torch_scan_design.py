"""The design of the scan kernels, checked on the CPU.

``hms_scan`` runs one chain per (lane, domain) and ``ema_scan`` walks its
input in staged tiles (``src/repro_torch/kernels/hms_scan/csrc``).  The
pieces of that design are ``__host__ __device__`` functions in
``hms_step.cuh`` and ``ema_tile.cuh``; here g++ builds them for the host and
they are held against the plain versions in ``ref.py``: the domain walk
``hms_lane_by_domain`` (what the kernel computes, on the wrapper's chain
order) on the golden policies, on four shard lanes and on pathfnd with a
padded tail; the packed CTC key's maximum; the chain order; the EMA's tile
walk.  The kernels
themselves run only on the card (``chip_smoke.py``).
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import simulator as tsim
from repro_torch.core.timing import POLICIES, POLICIES_WITH_CTC
from repro_torch.kernels.hms_scan import ops as scan_ops
from repro_torch.kernels.hms_scan import ref as scan_ref

sys.path.insert(0, str(Path(__file__).parent))
from test_engine_parity import GOLDEN_CONFIGS, _golden_trace  # noqa: E402

CSRC = Path(scan_ref.__file__).parent / "csrc"
GOLDEN_IDS = ["hms", "tad", "no_bypass", "no_2nd", "bear", "mccache",
              "redcache", "no_ctc"]

_HOST_SRC = r"""
#include "ema_tile.cuh"
#include "hms_step.cuh"

template <int P>
static void walk(const int32_t* slot, const int64_t* meta,
                 const int64_t* offsets, int lanes, int32_t* cache,
                 int64_t lines, int64_t* ctc, int ctc_words, int ways,
                 int e_ways, int n_domains, int32_t* y) {
  for (int l = 0; l < lanes; ++l)
    hms_lane_by_domain<P>(slot, meta, offsets, l, n_domains,
                          cache + l * lines, ctc + (int64_t)l * ctc_words,
                          ways, e_ways, y);
}

extern "C" int by_domain(int policy, const int32_t* slot,
                         const int64_t* meta, const int64_t* offsets,
                         int lanes, int32_t* cache, int64_t lines,
                         int64_t* ctc, int ctc_words, int ways, int e_ways,
                         int n_domains, int32_t* y) {
#define WALK(p) case p: walk<p>(slot, meta, offsets, lanes, cache, lines, \
    ctc, ctc_words, ways, e_ways, n_domains, y); return 0;
  switch (policy) { WALK(0) WALK(1) WALK(2) WALK(3) WALK(4) WALK(5) WALK(6)
                    WALK(7) }
  return 1;
}

// The row's maximum packed key: the chosen way, its age, sector and line hit.
extern "C" void probe_key(const int64_t* row, int ways, int64_t want,
                          int64_t sector, int e_ways, int64_t* out) {
  uint32_t best = 0;
  for (int w = 0; w < ways; ++w) {
    const uint32_t k = ctc_way_key(row[w], w, want, sector, w < e_ways);
    best = k > best ? k : best;
  }
  out[0] = ctc_key_way(best);
  out[1] = best & 0xFF;
  out[2] = ctc_key_sector_hit(best);
  out[3] = ctc_key_line_hit(best);
}

extern "C" int64_t ema_tile_size() { return EMA_TILE; }

extern "C" void ema(const double* v, int64_t n, double weight, double* out) {
  ema_walk(v, n, weight, out);
}
"""


@pytest.fixture(scope="module")
def design(tmp_path_factory):
    """The step and EMA headers built for the host by g++ (skips without
    g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the scan headers "
                    "needs it")
    d = tmp_path_factory.mktemp("scan_design")
    (d / "design.cpp").write_text(_HOST_SRC)
    so = d / "libscan_design.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-ffp-contract=off", f"-I{CSRC}", "-o", str(so),
                    str(d / "design.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.by_domain.argtypes = [I, P, P, P, I, P, L, P, I, I, I, I, P]
    lib.by_domain.restype = I
    lib.probe_key.argtypes = [P, I, L, L, I, P]
    lib.probe_key.restype = None
    lib.ema_tile_size.argtypes = []
    lib.ema_tile_size.restype = L
    lib.ema.argtypes = [P, L, ctypes.c_double, P]
    lib.ema.restype = None
    return lib


def _streams(trace, kw):
    cfg = T.HMSConfig(footprint=trace.footprint, **kw).validate()
    s = tsim.scan_inputs(trace, cfg, torch.device("cpu"))
    return s["slot"], s["meta"], s["scan"]


def _golden(kw):
    t = _golden_trace()
    return _streams(T.Trace(t.name, t.col, t.is_write, t.footprint), kw)


def _walk_by_domain(lib, slot, meta, args):
    """The kernel's computation, run on the host on the wrapper's chain
    order: (y, cache, ctc)."""
    lanes, depth = slot.shape
    plan, chain, counts = scan_ops._plan(
        slot, meta, policy=args["policy"], n_sets=args["n_sets"],
        lines_alloc=args["lines_alloc"], spg=args["spg"])
    order, offsets = scan_ops.chain_order(chain, counts)
    cache, ctc = scan_ref.initial_state(
        lanes, args["lines_alloc"], args["sets_alloc"], args["ways_alloc"],
        args["sectors"], "cpu")
    slot_s = slot.reshape(-1)[order].contiguous()
    meta_s = meta.reshape(-1)[order].contiguous()
    y_s = torch.full_like(slot_s, -1)
    rc = lib.by_domain(
        POLICIES.index(args["policy"]), slot_s.data_ptr(), meta_s.data_ptr(),
        offsets.data_ptr(), lanes, cache.data_ptr(), args["lines_alloc"],
        ctc.data_ptr(), args["sets_alloc"] * args["ways_alloc"],
        args["ways_alloc"], args["e_ways"], plan.domains, y_s.data_ptr())
    assert rc == 0
    y = torch.full_like(slot, -1)
    y.view(-1)[order] = y_s
    return (y, cache, ctc), plan.domains


def _assert_walk_is_plain(lib, slot, meta, args):
    got, n_domains = _walk_by_domain(lib, slot, meta, args)
    want = scan_ops.hms_scan(slot, meta, **args)     # CPU: the plain scan
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got, n_domains


# ---------------------------------------------------------------------------
# The domain walk against the plain scan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", GOLDEN_CONFIGS, ids=GOLDEN_IDS)
def test_domain_walk_matches_plain(design, kw):
    slot, meta, args = _golden(kw)
    (y, _, _), n_domains = _assert_walk_is_plain(design, slot, meta, args)
    # the golden trace's CTC has one set; without a CTC the lane is split
    if args["policy"] in POLICIES_WITH_CTC:
        assert n_domains == args["n_sets"] == 1
    else:
        assert n_domains > 1
    assert int((y & 1).sum()) > 0


def test_domain_walk_matches_plain_on_48_of_64_ways(design):
    """Two CTC sets of 64 ways with 48 enabled: the kernel holds two ways a
    thread there, and the disabled ways still age."""
    slot, meta, args = _golden({"ctc_ways": 48, "ctc_fraction": 1.0})
    assert (args["e_ways"], args["ways_alloc"], args["n_sets"]) == (48, 64, 2)
    (y, _, ctc), n_domains = _assert_walk_is_plain(design, slot, meta, args)
    assert n_domains == 2
    assert int((y & 2).sum()) > 0                   # the CTC does hit


@pytest.mark.parametrize("kw", GOLDEN_CONFIGS, ids=GOLDEN_IDS)
def test_domain_walk_matches_plain_on_four_lanes(design, kw):
    old = tsim.set_forced_shards(4)
    try:
        slot, meta, args = _golden(kw)
    finally:
        tsim.set_forced_shards(old)
    assert slot.shape[0] == 4
    assert bool(((meta >> 16) & 1 == 0).any())   # padded tails
    _assert_walk_is_plain(design, slot, meta, args)


@pytest.mark.parametrize("policy", ["hms", "no_second_level", "bear",
                                    "no_bypass_no_ctc"])
def test_domain_walk_on_pathfnd_with_padded_tail(design, policy):
    """pathfnd's first 20k steps (4 CTC sets: 4 chains under a CTC policy),
    then 13 padded steps (live 0, repeating the last request, as the shard
    plan pads): each padded step's domain is its own row group's, so its
    decision word is computed against that domain's final state, as in the
    sequential walk."""
    slot, meta, args = _streams(T.make_trace("pathfnd"), {"policy": policy})
    n = 20_000
    pad = 13
    live_bit = torch.tensor(1 << 16, dtype=torch.int64)
    slot = torch.cat([slot[:, :n], slot[:, n - 1:n].expand(1, pad)], 1)
    meta = torch.cat([meta[:, :n],
                      (meta[:, n - 1:n] & ~live_bit).expand(1, pad)], 1)
    (y, _, _), n_domains = _assert_walk_is_plain(design, slot, meta, args)
    assert n_domains == 4 if policy in POLICIES_WITH_CTC else n_domains > 4
    rg = (meta >> 17) & 0x7FFFFF
    tail_domain = int(rg[0, -1] % n_domains)
    assert (rg[0, :n] % n_domains == tail_domain).sum() > 0
    # a padded step after the real one repeats its probe: same slot, so
    # after the fill it hits where the last real step missed and filled
    if int(y[0, n - 1]) & 4:
        assert int(y[0, -1]) & 1


# ---------------------------------------------------------------------------
# The packed CTC key.
# ---------------------------------------------------------------------------

def _first_argmax_probe(row, want, sector, e_ways):
    """The reference's probe (ctc.py:219-222): score per way, the first
    maximum, the sector and line hit, the chosen way's age."""
    tagp1, age, sv = row >> 40, (row >> 32) & 0xFF, row & 0xFFFFFFFF
    enabled = np.arange(row.shape[0]) < e_ways
    line = (tagp1 == want) & enabled
    sec = line & (((sv >> sector) & 1) == 1)
    score = np.where(sec, 2 << 20, np.where(line, 1 << 20,
                                             np.where(enabled, age, -1)))
    way = int(np.argmax(score))
    return way, int(age[way]), bool(sec.any()), bool(line.any())


@pytest.mark.parametrize("ways,seed", [(1, 0), (4, 1), (16, 2), (16, 3),
                                       (32, 4), (64, 5)])
def test_packed_key_picks_the_first_maximum(design, ways, seed):
    """Random ages with ties (few distinct ages), lines present with and
    without the sector, disabled ways and e_ways < ways_alloc."""
    rng = np.random.default_rng(seed)
    out = np.zeros(4, np.int64)
    for trial in range(400):
        e_ways = int(rng.integers(1, ways + 1))
        ages = rng.integers(0, int(rng.choice([2, 4, 256])), ways)
        tagp1 = rng.integers(0, 4, ways)
        sv = rng.integers(0, 1 << 8, ways)
        row = (tagp1 << 40) | (ages << 32) | sv
        want, sector = int(rng.integers(1, 4)), int(rng.integers(0, 8))
        design.probe_key(row.ctypes.data, ways, want, sector, e_ways,
                         out.ctypes.data)
        assert tuple(int(v) for v in out) == tuple(
            int(v) for v in _first_argmax_probe(row, want, sector, e_ways)
        ), (trial, row, want, sector, e_ways)


# ---------------------------------------------------------------------------
# The chain order.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes,n_domains,depth", [
    (1, 4, 20_000), (1, 8, 4096), (4, 1, 1000), (4, 32, 777), (3, 7, 5),
    (2, 128, 1)])
def test_chain_order_gives_each_chain_a_run_in_stream_order(
        lanes, n_domains, depth):
    """Every step lies in its chain's run, the runs follow the chains (empty
    ones too), and a run keeps its chain's steps in stream order."""
    rng = np.random.default_rng(lanes * 1000 + n_domains)
    lines, spg = 64 * n_domains * 4, 64
    slot = torch.from_numpy(
        rng.integers(0, lines, (lanes, depth)).astype(np.int32))
    meta = (slot.long() // spg) << 17
    plan, chain, counts = scan_ops._plan(
        slot, meta, policy="hms", n_sets=n_domains, lines_alloc=lines,
        spg=spg)
    assert plan.domains == n_domains
    order, offsets = scan_ops.chain_order(chain, counts)
    assert offsets.shape == (lanes * n_domains + 1,)
    assert int(offsets[0]) == 0 and int(offsets[-1]) == lanes * depth
    assert torch.equal(torch.sort(order).values,
                       torch.arange(lanes * depth))
    flat = chain.reshape(-1)
    for c in range(lanes * n_domains):
        run = order[offsets[c]:offsets[c + 1]]
        assert (flat[run] == c).all()
        assert (run[1:] > run[:-1]).all()
        lane, d = divmod(c, n_domains)
        assert (run // depth == lane).all()
        assert (((slot.reshape(-1)[run].long() // spg) % n_domains)
                == d).all()
    assert plan.longest_chain == int(counts.max())


# ---------------------------------------------------------------------------
# The wrapper's validation.
# ---------------------------------------------------------------------------

def test_hms_scan_refuses_a_slot_in_two_domains():
    slot, meta, args = _golden({"policy": "bear"})
    plan = scan_ops.scan_plan(slot, meta, **args)
    assert plan.domains > 1
    # move one step of a slot touched twice to the next row group: the slot
    # then lies in two domains
    counts = torch.bincount(slot[0].long())
    t = int(torch.nonzero(counts[slot[0].long()] > 1)[0])
    bad = meta.clone()
    bad[0, t] += 1 << 17
    with pytest.raises(ValueError, match="two domains"):
        scan_ops.hms_scan(slot, bad, **args)
    with pytest.raises(ValueError, match="two domains"):
        scan_ops.scan_plan(slot, bad, **args)


def test_scan_plan_counts_chains():
    for kw in ({}, {"policy": "bear"}):
        slot, meta, args = _golden(kw)
        plan = scan_ops.scan_plan(slot, meta, **args)
        rg = (meta >> 17) & 0x7FFFFF
        counts = torch.bincount((rg % plan.domains).reshape(-1))
        assert plan.longest_chain == int(counts.max())


# ---------------------------------------------------------------------------
# The EMA's tile walk.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["0", "1", "tile-1", "tile", "tile+1",
                                   "160k"])
def test_ema_tile_walk_is_the_plain_ema(design, which):
    tile = design.ema_tile_size()
    n = {"0": 0, "1": 1, "tile-1": tile - 1, "tile": tile,
         "tile+1": tile + 1, "160k": 160_000}[which]
    rng = np.random.default_rng(n)
    v = rng.random(n) * 300
    out = np.full(n, np.nan)
    design.ema(v.ctypes.data, n, 0.01, out.ctypes.data)
    want = scan_ops.ema_scan(torch.from_numpy(v), 0.01).numpy()
    assert np.array_equal(out, want)
