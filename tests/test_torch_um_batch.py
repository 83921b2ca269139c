"""The ``um_scan`` kernel's passes at their edges, on the CPU.

The kernel (``kernels/um_scan/csrc/um_step.cuh``) takes a lane's requests
32 at a time: a pass runs its hit steps together and stops at its first
migrating step and at the stream's end, each step's events counted in its
own phase.  g++ builds the same header with one thread (the collectives
become loops over the 32 requests of a pass held by that thread), so the
host walk cuts exactly the kernel's passes.  Each stream below puts a pass edge where a mistake would
show: an nvlink page that crosses the threshold at its 2nd, 3rd or 4th
step of one pass, threshold 0, a migration at a pass's first and last
request, writes to a page before and after a migration among the same 32
requests, phase changes inside a pass, streams shorter than a pass or no
multiple of it, windows that wrap the frame ring at chunks 8 and 64, and a
window of equal access counts.  Counters and the final state (resident,
dirty, frames, hand, counts) must equal the plain ``um_scan_reference``
exactly; a few streams also go through the JAX engine.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import um as RU

from repro_torch.kernels.um_scan import ops as um_ops

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_um import (  # noqa: E402,F401  (step_lib is a fixture)
    _host_walk, _page_trace, _port_vs_jax, step_lib)


def _walk_equals_plain(lib, pages, writes, lanes, phase=None, n_phases=1):
    """The host walk and the plain version on one stream: counters and
    final state exactly.  Returns the counts [lanes, 4, phases]."""
    page = torch.tensor(pages, dtype=torch.int32)
    wr = torch.tensor(writes, dtype=torch.bool)
    ph = None if phase is None else torch.tensor(phase, dtype=torch.int32)
    n_pages = int(page.max()) + 1
    got = _host_walk(lib, page, wr, ph, n_phases, n_pages, lanes)
    want = um_ops.um_scan(page, wr, ph, n_phases=n_phases, n_pages=n_pages,
                          n_frames=lanes[0], chunk=lanes[1], nvlink=lanes[2],
                          hot_thresh=lanes[3])
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)
    return got[0]


def _jax_agrees(pages, writes, lanes, counts):
    """The JAX engine's counters on the same stream equal ``counts``."""
    t = _page_trace("batch", pages, writes, int(max(pages)) + 1)
    specs = [RU.UMSpec(*s) for s in zip(*lanes)]
    for j, r in enumerate(_port_vs_jax(t, specs)):
        have = np.stack([r.phase_faults, r.phase_migrated,
                         r.phase_writebacks, r.phase_remote_cols])
        assert np.array_equal(have, counts[j].numpy())


def _tail(seed, n, n_pages, pages):
    """``pages`` then n random requests (runs and jumps) over n_pages, and
    30% writes: the pass edges above, then everything after them."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.integers(-3, 4, n)) % n_pages
    rest = np.where(rng.random(n) < 0.7, walk, rng.integers(0, n_pages, n))
    out = list(pages) + rest.tolist() + [n_pages - 1]
    return out, (rng.random(len(out)) < 0.3).tolist()


@pytest.mark.parametrize("k", [2, 3, 4])
def test_nvlink_threshold_crossed_inside_a_pass(step_lib, k):
    """Page 7 comes 5 times in the first pass among pages seen once: with
    threshold k it migrates at its k-th step there, and its earlier steps
    are remote; page 9 comes again after that migration, in the next
    pass, and crosses there."""
    first = list(range(20, 52))
    for i in (2, 6, 11, 19, 27):
        first[i] = 7
    first[3] = first[29] = 9
    pages, writes = _tail(k, 300, 64, first)
    lanes = ([8, 3], [1, 1], [True, True], [k, k])
    counts = _walk_equals_plain(step_lib, pages, writes, lanes)
    # the first pass: 32 - 5 - 2 + 2 cold pages, page 7's first k - 1
    # steps and page 9's first step are remote before page 7 migrates
    assert (counts[:, 1] > 0).all() and (counts[:, 3] > 0).all()
    if k == 3:
        _jax_agrees(pages, writes, lanes, counts)


def test_threshold_zero_migrates_every_cold_step(step_lib):
    pages, writes = _tail(5, 400, 80, [])
    lanes = ([8, 3, 40], [1, 1, 1], [True, True, True], [0, 0, 0])
    counts = _walk_equals_plain(step_lib, pages, writes, lanes)
    assert (counts[:, 3] == 0).all()            # nothing is served remote
    assert (counts[:, 0] > 0).all()


@pytest.mark.parametrize("chunk", [1, 4])
def test_migration_at_first_and_last_request_of_a_pass(step_lib, chunk):
    """Request 0 faults (the first pass stops at its position 0); the
    next pass starts at request 1 and hits page 100 31 times, then faults
    on page 150 at its position 31; the pass after starts with a fault on
    page 200 at its position 0."""
    first = [100] + [100] * 31 + [150, 200, 100, 150, 200]
    pages, writes = _tail(11 + chunk, 200, 256, first)
    lanes = ([64, 9], [chunk, chunk], [False, False], [0, 0])
    counts = _walk_equals_plain(step_lib, pages, writes, lanes)
    assert (counts[:, 0] >= 3).all()
    if chunk == 4:
        _jax_agrees(pages, writes, lanes, counts)


@pytest.mark.parametrize("nvlink", [False, True], ids=["fault", "nvlink"])
def test_writes_before_and_after_a_migration(step_lib, nvlink):
    """4 frames, chunk 1: pages 1-4 fill them, then one pass writes pages 1
    and 2, reads 3 and 4 twice (page 1 is the coldest), faults on page 5
    (evicting dirty page 1: a writeback) and, among the same 32 requests,
    writes pages 1 (which faults back) and 2 (still resident) again."""
    first = [1, 2, 3, 4, 1, 2, 3, 3, 4, 4, 2, 5, 1, 2, 6, 1, 2]
    writes_first = [0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 1]
    pages, writes = _tail(21, 150, 12, first)
    writes = [bool(w) for w in writes_first] + writes[len(first):]
    # threshold 0 migrates on every cold step, as fault mode does
    lanes = ([4, 5], [1, 1], [nvlink, nvlink], [0, 2] if nvlink else [0, 0])
    counts = _walk_equals_plain(step_lib, pages, writes, lanes)
    assert counts[0, 2] > 0                     # dirty victims wrote back
    if not nvlink:
        _jax_agrees(pages, writes, lanes, counts)


def test_phase_changes_inside_passes(step_lib):
    """Phase runs of 1 to 40 requests over 3 phases that come back, so most
    passes span several runs: each step's events land in its own phase."""
    rng = np.random.default_rng(31)
    pages, writes = _tail(31, 700, 150, [])
    runs = []
    while len(runs) < len(pages):
        runs += [int(rng.integers(0, 3))] * int(rng.integers(1, 41))
    phase = runs[:len(pages)]
    phase[5] = (phase[4] + 1) % 3                # a one-request run
    lanes = ([40, 7, 40, 9], [4, 2, 1, 1], [False, False, True, True],
             [0, 0, 3, 0])
    counts = _walk_equals_plain(step_lib, pages, writes, lanes, phase, 3)
    assert (counts[:, 0] > 0).all()
    assert (counts.sum(dim=(0, 1)) > 0).all()   # every phase counted


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 95, 161])
def test_stream_lengths_around_a_pass(step_lib, n):
    rng = np.random.default_rng(n)
    pages = rng.integers(0, 40, n).tolist()
    pages[-1] = 39
    writes = (rng.random(n) < 0.3).tolist()
    lanes = ([8, 3, 8, 5], [4, 1, 1, 8], [False, False, True, False],
             [0, 0, 2, 0])
    counts = _walk_equals_plain(step_lib, pages, writes, lanes)
    assert (counts[[0, 1, 3], 0] > 0).all()     # fault lanes fault at once
    if n == 33:
        _jax_agrees(pages, writes, lanes, counts)


@pytest.mark.parametrize("chunk,frames", [(8, [9, 20, 31]),
                                          (16, [30, 63, 64]),
                                          (32, [50, 100, 127]),
                                          (64, [70, 100, 255])])
def test_wrapped_windows(step_lib, chunk, frames):
    """Fewer frames than the 4 x chunk window: the hand's window repeats
    frames, and a frame named twice takes the later chunk lane's page; at
    each of the kernel's window tiers (up to 32, 64, 128, 256), and one
    lane that fills its tier without wrapping."""
    pages, writes = _tail(chunk, 700, 8 * chunk + 5, [])
    lanes = (frames, [chunk] * 3, [False] * 3, [0] * 3)
    counts = _walk_equals_plain(step_lib, pages, writes, lanes)
    assert (counts[:, 1] > 0).all() and (counts[:, 2] > 0).any()


@pytest.mark.parametrize("chunk,frames", [(1, 4), (4, 16), (16, 64),
                                          (64, 256)])
def test_equal_counts_across_the_window(step_lib, chunk, frames):
    """A sweep that touches each page once: once the frames are full every
    candidate of the window has the same count, and the victims are the
    window's first pages in order (the stable rank's ties)."""
    n = 6 * frames + 40
    pages = list(range(n))
    writes = [bool(i % 3 == 0) for i in range(n)]
    lanes = ([frames, frames + 1], [chunk, chunk], [False, False], [0, 0])
    counts = _walk_equals_plain(step_lib, pages, writes, lanes)
    assert (counts[:, 2] > 0).all()
    if chunk == 1:
        _jax_agrees(pages, writes, lanes, counts)
