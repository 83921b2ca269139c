"""The AMIL probe kernel's lane code, built for the host and checked on the
CPU.

``csrc/amil_probe.cu`` probes requests four at a time with 16-byte
transfers and the rest one by one (every request, where a stream is not
16-byte aligned), and refuses an out-of-range slot before it reads the
table.  Those pieces are ``__host__ __device__``
functions in ``csrc/amil_lane.cuh`` (``amil_slot_ok``, ``amil_lane``,
``amil_one``, ``amil_quad``, ``amil_span``); here g++ builds them for the
host, and a walk that splits the requests as the kernel does (quads, then
the rest one by one) is held bit for bit against ``amil_probe_reference`` and the JAX
``amil_probe`` (Pallas, interpret mode) at N of 1, 3, 4 and 4097, on views
at offsets 0 and 1, with tables of 8 to 8192 lanes.  The kernel itself runs
only on the card (``chip_smoke.py``).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.amil_probe.ops import probe as pallas_probe
from repro_torch.kernels.amil_probe import ops as probe_ops
from repro_torch.kernels.amil_probe.ref import amil_probe_reference

CSRC = Path(probe_ops.__file__).parent / "csrc"

_HOST_SRC = r"""
#include "amil_lane.cuh"

extern "C" void span(const void* slots, const void* tags, const void* hit,
                     const void* dirty, const void* aff, int64_t n,
                     int64_t* out) {
  const AmilSpan s = amil_span(slots, tags, hit, dirty, aff, n);
  out[0] = s.quads;
  out[1] = s.tail;
}

// The requests in the kernel's split: the quads four at a time, then the
// rest one by one.  Returns the first request whose slot
// was refused, or -1.
extern "C" int64_t walk(const int32_t* table, int32_t n_slots,
                        const int32_t* slots, const int32_t* tags, int64_t n,
                        int32_t* hit, int32_t* dirty, int32_t* aff) {
  const AmilSpan sp = amil_span(slots, tags, hit, dirty, aff, n);
  int64_t bad = -1;
  auto one = [&](int64_t i) {
    if (!amil_one(table, n_slots, slots[i], tags[i], hit[i], dirty[i],
                  aff[i]) && bad < 0)
      bad = i;
  };
  for (int64_t q = 0; q < sp.quads; ++q) {
    const int64_t i = 4 * q;
    const int32_t s[4] = {slots[i], slots[i + 1], slots[i + 2], slots[i + 3]};
    const int32_t t[4] = {tags[i], tags[i + 1], tags[i + 2], tags[i + 3]};
    int32_t h[4], d[4], a[4];
    if (!amil_quad(table, n_slots, s, t, h, d, a)) {
      if (bad < 0) bad = i;
      continue;
    }
    for (int u = 0; u < 4; ++u) {
      hit[i + u] = h[u];
      dirty[i + u] = d[u];
      aff[i + u] = a[u];
    }
  }
  for (int64_t i = 4 * sp.quads; i < n; ++i) one(i);
  return bad;
}
"""

UNSET = -7                # what an output holds until the walk writes it


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """amil_lane.cuh built for the host by g++ (skips without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the probe's lane "
                    "code needs it")
    d = tmp_path_factory.mktemp("amil_design")
    (d / "lane.cpp").write_text(_HOST_SRC)
    so = d / "libamil_lane.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "lane.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, L = ctypes.c_void_p, ctypes.c_int64
    lib.span.argtypes = [P, P, P, P, P, L, P]
    lib.span.restype = None
    lib.walk.argtypes = [P, ctypes.c_int32, P, P, L, P, P, P]
    lib.walk.restype = L
    return lib


def _at(n, shift, fill=0):
    """int32[n] starting ``shift`` lanes past a 16-byte boundary."""
    buf = np.full(n + 8, fill, np.int32)
    base = (-buf.ctypes.data) % 16 // 4
    return buf[base + shift:base + shift + n]


def _walk(lib, table, slots, tags, out_shift):
    """The host walk with outputs starting ``out_shift`` lanes past a
    16-byte boundary; returns (outputs, span, first refused request)."""
    n = slots.shape[0]
    outs = [_at(n, out_shift, UNSET) for _ in range(3)]
    sp = np.zeros(2, np.int64)
    ptrs = [a.ctypes.data for a in (slots, tags, *outs)]
    lib.span(*ptrs, n, sp.ctypes.data)
    bad = lib.walk(table.ctypes.data, table.shape[0], slots.ctypes.data,
                   tags.ctypes.data, n, *[o.ctypes.data for o in outs])
    return outs, tuple(int(v) for v in sp), bad


def _inputs(seed, n, n_slots, shift):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 64, n_slots).astype(np.int32)
    slots, tags = _at(n, shift), _at(n, shift)
    slots[:] = rng.integers(0, n_slots, n)
    tags[:] = rng.integers(0, 4, n)
    return table, slots, tags


@pytest.mark.parametrize("shift", [0, 1], ids=["aligned", "offset_1"])
@pytest.mark.parametrize("n_slots", [8, 256, 8192])
@pytest.mark.parametrize("n", [1, 3, 4, 4097])
def test_lane_walk_matches_plain_and_pallas(lane, n, n_slots, shift):
    """Bit for bit against the plain version and the Pallas kernel, with
    the outputs 16-byte aligned (the wrapper's fresh outputs: quads where
    the slots are aligned too) and one lane off (every request scalar)."""
    table, slots, tags = _inputs(n * 7 + n_slots + shift, n, n_slots, shift)
    want = amil_probe_reference(torch.from_numpy(table),
                                torch.from_numpy(slots.copy()),
                                torch.from_numpy(tags.copy()))
    pallas = pallas_probe(jnp.asarray(table), jnp.asarray(slots),
                          jnp.asarray(tags))
    for out_shift in (0, 1):
        outs, sp, bad = _walk(lane, table, slots, tags, out_shift)
        assert bad == -1
        assert 4 * sp[0] + sp[1] == n
        if shift or out_shift:
            assert sp == (0, n)
        for o, w, k in zip(outs, want, pallas):
            assert np.array_equal(o, w.numpy())
            assert np.array_equal(o, np.asarray(k))


@pytest.mark.parametrize("n,shift,want", [
    (1, 0, (0, 1)),
    (3, 0, (0, 3)),
    (4, 0, (1, 0)),
    (4097, 0, (1024, 1)),
    (1, 1, (0, 1)),
    (3, 1, (0, 3)),
    (4, 1, (0, 4)),
    (4097, 1, (0, 4097)),
    (4097, 2, (0, 4097)),
    (4097, 3, (0, 4097)),
])
def test_span_splits_quads_and_tail(lane, n, shift, want):
    """Aligned streams go in whole quads from the first request, then the
    rest one by one; a view off a 16-byte boundary goes one by one."""
    _, slots, tags = _inputs(0, n, 8, shift)
    _, sp, _ = _walk(lane, np.zeros(8, np.int32), slots, tags, shift)
    assert sp == want


@pytest.mark.parametrize("off", range(5),
                         ids=["slots", "tags", "hit", "dirty", "aff"])
def test_span_is_scalar_when_one_stream_is_unaligned(lane, off):
    """Any one of the five streams off a 16-byte boundary makes every
    request scalar."""
    lanes = [_at(64, 2 if k == off else 0) for k in range(5)]
    sp = np.zeros(2, np.int64)
    lane.span(*[a.ctypes.data for a in lanes], 64, sp.ctypes.data)
    assert tuple(sp) == (0, 64)


@pytest.mark.parametrize("bad_slot", [8192, -1, 2**31 - 1, -2**31])
@pytest.mark.parametrize("where", ["first_quad", "quad", "tail", "unaligned"])
def test_out_of_range_slot_is_flagged_and_never_read(lane, bad_slot, where):
    """A slot outside [0, n_slots) is refused before the table is read:
    the walk reports it and writes nothing for it (the kernel fails the
    stream there).  The table sits in a larger buffer whose lanes past it
    would probe as hits, so a read would show."""
    n, n_slots = 4097, 8192
    shift = 1 if where == "unaligned" else 0
    table, slots, tags = _inputs(3, n, n_slots, shift)
    guarded = np.full(3 * n_slots, 0b000111, np.int32)   # valid, tag 3
    guarded[n_slots:2 * n_slots] = table
    tags[:] = 3
    i = {"first_quad": 1, "quad": 2001, "tail": n - 1, "unaligned": 2001}[where]
    slots[i] = bad_slot
    outs, sp, bad = _walk(lane, guarded[n_slots:2 * n_slots], slots, tags,
                          shift)
    assert sp == ((0, n) if shift else (1024, 1))
    in_quad = where in ("first_quad", "quad")
    q0 = i // 4 * 4 if in_quad else i
    assert bad == q0
    skipped = range(q0, q0 + 4) if in_quad else [i]
    for o in outs:
        assert all(o[k] == UNSET for k in skipped)
    ok = np.ones(n, bool)
    ok[list(skipped)] = False
    want = amil_probe_reference(torch.from_numpy(table),
                                torch.from_numpy(np.where(ok, slots, 0)),
                                torch.from_numpy(tags.copy()))
    for o, w in zip(outs, want):
        assert np.array_equal(o[ok], w.numpy()[ok])


def test_probe_on_a_view_runs_the_plain_version_on_the_cpu():
    table, slots, tags = _inputs(5, 4097, 256, 0)
    s, t = torch.from_numpy(slots), torch.from_numpy(tags)
    got = probe_ops.probe(torch.from_numpy(table), s[1:], t[1:])
    want = amil_probe_reference(torch.from_numpy(table), s[1:], t[1:])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
