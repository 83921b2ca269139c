"""The design of the ``ssd_scan`` backward kernels, checked on the CPU.

``csrc/ssd_scan_bwd.cu`` computes the SSD scan's gradient on the tensor
cores (``mma.sync`` m16n8k16, float32 accumulators), in up to three
launches:

* the walks (only with more than one chunk, or an initial state): one CTA
  per (head, batch row) and direction.  Forward, the entering state of
  every chunk, ``S <- e^E S + (x o dt o e^{E - cum})^T B``; in reverse, the
  state gradient leaving every chunk, ``dS <- e^E dS + (dy o e^{cum})^T C``
  (after chunk 0: ``dinit``);
* the chunk kernel: one CTA per (chunk, head, batch row), all P columns of
  the head.  Its warps take the causal 16 x 16 tile pairs twice: key-major
  (a warp owns 16 rows j, recomputes ``G^T = B C^T`` and ``W^T = x dy^T dt``
  tile by tile over i >= j, forms ``M^T`` and ``Wd^T`` in registers and
  accumulates ``du += M^T dy``, ``dB += Wd^T C`` and the sums of
  ``Q = M o W``), then query-major (a warp owns rows i, recomputes ``W``,
  and accumulates ``dC += Wd B``).  The state terms start the accumulators:
  ``e^{E - cum} dS B`` of du, ``e^{E - cum} dt dS^T x`` of dB,
  ``e^{cum} S0^T dy`` of dC, each skipped when its state is zero (no
  dstate on the last chunk, no initial state on the first);
* the sums: dB and dC over the heads of a group (a float32 partial a
  head, head order), dA over (chunk, batch row).

:func:`ssd_bwd_mma_model` does the kernels' arithmetic in plain PyTorch:
every product summed k16 step by k16 step on one float32 accumulator
(``repro_torch.kernels.pieces.prod``), the accumulators started where the
kernel starts them; bf16 (design ``mma``): x, dy, B and C exact as stored,
the float32 factors ``M`` and ``Wd`` rounded to one bf16 piece, the float32
states and the walks' scaled operands split hi + lo; float32 (``mma3``):
every operand in three bf16 pieces, six products a step, smallest first.
The partials are summed in the kernel's order.  Held, on
``tests/test_torch_ssd_backward.py``'s nine cases in both types, to

* ``jax.grad`` of the JAX ``ssd_reference`` (float32 at 1e-4 of each
  gradient's largest magnitude, bf16 at 2e-2);
* the plain backward (``ref.ssd_plain_backward``) at the card's
  ``BWD_TOL`` (chip_smoke);
* a float64 gradient: the float32 model within 4x the plain float32
  version's distance.  Two pieces and three products, or the float32
  factors rounded to one bf16 piece, miss it.

The kernels' tile schedule and summing order (``csrc/ssd_bwd_sched.cuh``)
are built with g++ and checked.  The CUDA kernels themselves run only on
the card (``chip_smoke.py``).
"""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssd_scan.ref import ssd_reference as jax_ssd

from repro_torch.kernels import pieces
from repro_torch.kernels.ssd_scan import ops, ref

from test_torch_ssd_backward import CASES, _inputs, _oracle64

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "ssd_scan" / "csrc")
CHUNK = 128
STEP = 16                  # the depth of an m16n8k16 product
TILES = CHUNK // 16        # 16-row tiles of a chunk
TOL = {"float32": 1e-4, "bfloat16": 2e-2}        # against JAX's gradients
CARD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # chip_smoke.BWD_TOL
ORACLE_RATIO = 4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _one(t):
    """A value rounded to one bf16 piece (exact for a bf16 operand)."""
    return [pieces.bf(t)]


def _tr(t):
    return t.transpose(-1, -2)


def _splits(dtype):
    """(operand, factor, state) splits of a design: how x/dy/B/C, the
    float32 factors M and Wd, and the float32 states (and the walks'
    scaled operands) become bf16 pieces."""
    if dtype == torch.bfloat16:
        return _one, _one, pieces.split
    return pieces.split3, pieces.split3, pieces.split3


def ssd_bwd_mma_model(x, dt, A, B, C, init, dy, dstate, splits=None):
    """What ``ssd_scan_bwd.cu`` computes, in plain PyTorch: x, dy
    (b, l, h, p) and B, C (b, l, g, n) in their type, dt, A, init and
    dstate float32 (init and dstate may be None) -> (dx, ddt, dA, dB, dC,
    dinit) as the wrapper returns them.  ``splits``: (operand, factor,
    state) piece functions (default: the design of x's type)."""
    f32 = torch.float32
    operand, factor, state = splits or _splits(x.dtype)
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg, cs = h // g, CHUNK
    nc = -(-l // cs)
    L = nc * cs

    def mm(a, bb, acc=None):
        return pieces.prod(a, bb, acc, step=STEP)

    def heads(v):                   # (b, l, ., w) -> (b, h, nc, cs, w)
        v = v.to(f32)
        if v.shape[2] != h:
            v = v.repeat_interleave(h // v.shape[2], dim=2)
        v = F.pad(v, (0, 0, 0, 0, 0, L - l))
        return v.view(b, nc, cs, h, v.shape[-1]).permute(0, 3, 1, 2, 4)

    xc, dyc, Bc, Cc = map(heads, (x, dy, B, C))
    dtc = F.pad(dt.to(f32), (0, 0, 0, L - l)).view(b, nc, cs, h) \
        .permute(0, 3, 1, 2)                               # (b, h, nc, cs)
    cum = torch.cumsum(dtc * A.to(f32)[:, None, None], -1)
    E = cum[..., -1]
    ecum, edec, eE = torch.exp(cum), torch.exp(E[..., None] - cum), \
        torch.exp(E)

    # the walks: the entering states S0[c], the leaving gradients dS1[c]
    S0, dS1 = [None] * nc, [None] * nc
    s = None if init is None else init.to(f32)
    S0[0] = s
    for c in range(nc - 1):
        wx = xc[:, :, c] * (dtc[:, :, c] * edec[:, :, c])[..., None]
        acc = None if s is None else eE[:, :, c, None, None] * s
        s = mm(state(_tr(wx)), operand(Bc[:, :, c]), acc)
        S0[c + 1] = s
    d = None if dstate is None else dstate.to(f32)
    for c in reversed(range(nc)):
        dS1[c] = d
        if c == 0 and init is None:
            break
        wy = dyc[:, :, c] * ecum[:, :, c][..., None]
        acc = None if d is None else eE[:, :, c, None, None] * d
        d = mm(state(_tr(wy)), operand(Cc[:, :, c]), acc)
    dinit = None if init is None else d

    # the chunk kernel
    idx = torch.arange(cs)
    lower = idx[:, None] >= idx[None, :]                   # [i, j]: i >= j
    dx = torch.zeros(b, h, nc, cs, p)
    ddt = torch.zeros(b, h, nc, cs)
    part_b = torch.zeros(b, h, nc, cs, n)
    part_c = torch.zeros_like(part_b)
    part_a = torch.zeros(nc, b, h)
    for c in range(nc):
        xs, dys, Bs, Cs = xc[:, :, c], dyc[:, :, c], Bc[:, :, c], Cc[:, :, c]
        d_, cm, ec, ed = dtc[:, :, c], cum[:, :, c], ecum[:, :, c], \
            edec[:, :, c]
        decay = torch.exp((cm[..., :, None] - cm[..., None, :])
                          .masked_fill(~lower, 0.0)) * lower   # [i, j]
        # key-major: G^T, W^T (rows j), M^T, Wd^T, du, dB, the sums of Q
        Gt = mm(operand(Bs), operand(_tr(Cs)))
        Wt = mm(operand(xs), operand(_tr(dys))) * d_[..., :, None]
        Mt, Wdt = Gt * _tr(decay), Wt * _tr(decay)
        Qt = Mt * Wt
        qcol = Qt.sum(-1)                                  # sum_i Q_ij
        # sum_j Q_ij: a partial per key tile, added in tile order
        qpart = Qt.reshape(b, h, TILES, 16, cs).sum(-2)
        qrow = qpart[:, :, 0]
        for t in range(1, TILES):
            qrow = qrow + qpart[:, :, t]
        du = dBc = None
        T = torch.zeros(b, h, cs)
        if dS1[c] is not None:
            du = mm(operand(Bs), state(_tr(dS1[c]))) * ed[..., None]
            T = d_ * (xs * du).sum(-1)
            dBc = mm(operand(xs), state(dS1[c])) * (ed * d_)[..., None]
        du = mm(factor(Mt), operand(dys), du)
        dBc = mm(factor(Wdt), operand(Cs), dBc)
        # query-major: W (rows i), Wd, dC; R from S0
        dCc = None
        R = torch.zeros(b, h, cs)
        if S0[c] is not None:
            V = mm(operand(dys), state(S0[c]))
            R = ec * (Cs * V).sum(-1)
            dCc = V * ec[..., None]
        W = mm(operand(dys), operand(_tr(xs))) * d_[..., None, :]
        dCc = mm(factor(W * decay), operand(Bs), dCc)
        dcum = qrow - qcol + R
        if dS1[c] is not None and S0[c] is not None:
            dcum[..., -1] += eE[:, :, c] * (dS1[c] * S0[c]).sum((-1, -2))
        da = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1]) \
            + torch.cumsum(T, -1) - T
        ddt[:, :, c] = A.to(f32)[:, None] * da + (du * xs).sum(-1)
        dx[:, :, c] = du * d_[..., None]
        part_a[c] = (d_ * da).sum(-1)
        part_b[:, :, c], part_c[:, :, c] = dBc, dCc

    def head_sum(part):             # the group's heads in head order
        part = part.view(b, g, hpg, nc, cs, n)
        acc = part[:, :, 0]
        for hl in range(1, hpg):
            acc = acc + part[:, :, hl]
        return acc.reshape(b, g, L, n).transpose(1, 2)[:, :l]

    dA = part_a[0, 0]
    for c in range(nc):
        for bi in range(b):
            if c or bi:
                dA = dA + part_a[c, bi]
    seq = lambda t: t.reshape(b, h, L, *t.shape[4:]).transpose(1, 2)[:, :l]
    return (seq(dx).to(x.dtype), seq(ddt).contiguous(), dA,
            head_sum(part_b).to(x.dtype).contiguous(),
            head_sum(part_c).to(x.dtype).contiguous(), dinit)


def _typed(case, dtype):
    """The case's inputs as tensors, x, dy, B and C in ``dtype`` (rounded
    once: both packages see the same values)."""
    x, dt, A, B, C, init, dy, dstate = (
        None if a is None else torch.from_numpy(a) for a in _inputs(case))
    tdt = DT[dtype][1]
    return (x.to(tdt), dt, A, B.to(tdt), C.to(tdt), init, dy.to(tdt),
            dstate)


@functools.lru_cache(maxsize=None)
def _grads(case, dtype, variant=None):
    """(model, plain) gradients of a case as float32 (None kept); once per
    (case, dtype, variant)."""
    args = _typed(case, dtype)
    splits = {None: None,
              "two_pieces": (pieces.split,) * 3,
              "factors_one_piece": (pieces.split3, _one, pieces.split3),
              }[variant]
    got = ssd_bwd_mma_model(*args, splits=splits)
    x, dt, A, B, C, init, dy, dstate = args
    plain = ref.ssd_plain_backward(x, dt, A, B, C, CHUNK, init, dy, dstate)
    f = lambda gs: tuple(None if v is None else v.float() for v in gs)
    return f(got), f(plain)


@functools.lru_cache(maxsize=None)
def _jax_grads(case, dtype):
    """jax.grad of sum(y dy) + sum(state dstate) through the JAX
    ssd_reference in ``dtype`` (the length zero-padded to the chunk as the
    JAX model pads it), jitted, as float32 numpy (None kept)."""
    jdt = DT[dtype][0]
    x, dt, A, B, C, init, dy, dstate = (
        None if a is None else a.float().numpy()
        for a in _typed(case, dtype))
    l = x.shape[1]
    pad = (-l) % CHUNK

    def loss(x, dt, A, B, C, init):
        if pad:
            x, B, C = (jnp.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
                       for v in (x, B, C))
            dt = jnp.pad(dt, ((0, 0), (0, pad), (0, 0)))
        y, st = jax_ssd(x, dt, A, B, C, CHUNK, initial_state=init)
        out = jnp.sum(y[:, :l].astype(jnp.float32) * dy)
        if dstate is not None:
            out = out + jnp.sum(st * dstate)
        return out

    args = [jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B, jdt), jnp.asarray(C, jdt)]
    if init is None:
        g = jax.jit(jax.grad(lambda *a: loss(*a, None),
                             argnums=(0, 1, 2, 3, 4)))(*args)
        g = tuple(g) + (None,)
    else:
        g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5)))(
            *args, jnp.asarray(init))
    return tuple(None if v is None else np.asarray(v.astype(jnp.float32))
                 for v in g)


def _scaled(got, want):
    """Each gradient's max |got - want| over its own largest |want|."""
    out = {}
    for name, a, w in zip(NAMES, got, want):
        assert (a is None) == (w is None), name
        if w is None:
            continue
        a = np.asarray(a, np.float64)
        w = np.asarray(w, np.float64)
        assert a.shape == w.shape, (name, a.shape, w.shape)
        assert np.isfinite(a).all(), name
        out[name] = float(np.abs(a - w).max()) / max(float(np.abs(w).max()),
                                                     1e-30)
    return out


def _oracle_dists(case, variant=None):
    """(model, plain): each float32 gradient's scaled distance from the
    float64 gradient, for the model (``variant``: fewer pieces) and for the
    plain float32 version."""
    got, plain = _grads(case, "float32", variant)
    exact = [None if v is None else v.numpy() for v in _oracle64(case)]
    return _scaled(got, exact), _scaled(plain, exact)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case, dtype):
    """The model's gradients against ``jax.grad`` of the JAX reference,
    within TOL of each gradient's largest magnitude."""
    got, _ = _grads(case, dtype)
    errs = _scaled(got, _jax_grads(case, dtype))
    assert all(e <= TOL[dtype] for e in errs.values()), errs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_plain(case, dtype):
    """The model against the plain backward at the card's tolerance
    (chip_smoke's BWD_TOL, of each gradient's largest magnitude)."""
    got, plain = _grads(case, dtype)
    errs = _scaled(got, plain)
    assert all(e <= CARD_TOL[dtype] for e in errs.values()), errs


@pytest.mark.parametrize("case", list(CASES))
def test_float32_model_is_as_close_to_float64_as_the_plain_version(case):
    """Three pieces and six products keep float32's accuracy: every
    gradient of the float32 model but dA lies within 4x the plain float32
    version's distance from the float64 gradient.  dA, a scalar a head
    summed over (chunk, b, l) from terms that largely cancel, lands 3e-7 to
    2e-5 of its scale from float64 in either, by summing order: it is held
    within 4x the plain version's largest distance over the gradients."""
    mine, plain = _oracle_dists(case)
    for k in mine:
        bound = max(plain.values()) if k == "dA" else plain[k]
        assert mine[k] <= ORACLE_RATIO * bound, (k, mine, plain)


@pytest.mark.parametrize("variant", ["two_pieces", "factors_one_piece"])
@pytest.mark.parametrize("case", list(CASES))
def test_fewer_pieces_miss_float32(case, variant):
    """Why ``mma3`` takes three pieces: with hi + lo pieces and their three
    products for every operand, or with the float32 factors M and Wd
    rounded to one bf16 piece, some gradient other than dA lies beyond 4x
    the plain float32 version's distance from float64 (two pieces 4.8-40x,
    one-piece factors over 1000x on these cases)."""
    mine, plain = _oracle_dists(case, variant)
    ratios = {k: mine[k] / plain[k] for k in mine if k != "dA"}
    assert max(ratios.values()) > ORACLE_RATIO, ratios


def test_backward_designs_by_type():
    """The wrapper names one backward design per type, bf16 ``mma`` and
    float32 ``mma3``, at every (head dim, state, chunk) the kernels are
    built for; any other shape is refused before the card."""
    assert ops.BWD_DESIGNS == {torch.bfloat16: "mma", torch.float32: "mma3"}
    for p, n, chunk in ops.KERNEL_SHAPES:
        for dt in ops.BWD_DESIGNS:
            ops.check_kernel_shape(p, n, chunk, dt)
    with pytest.raises(ValueError, match="head dim 32"):
        ops.bwd_blocks_per_sm(32, 128, 128, torch.bfloat16)


# ---------------------------------------------------------------------------
# The tile schedule and the summing orders, built for the host
# ---------------------------------------------------------------------------

_HOST_SRC = r"""
#include <stdint.h>
#include "ssd_bwd_sched.cuh"

using namespace ssd_bwd;

extern "C" {
int chunk_rows() { return CS; }
int tile_rows() { return TILE; }
int pass_warps() { return PASS_WARPS; }
int valid_tiles_of(int c, int l) { return valid_tiles(c, l); }
int warp_tile_of(int w, int k) { return warp_tile(w, k); }
float ordered_sum_of(const float* part, int64_t e, int64_t stride,
                     int count) {
  return ordered_sum(part, e, stride, count,
                     [](float a, float b) { return a + b; });
}
}
"""


@pytest.fixture(scope="module")
def sched():
    """``ssd_bwd_sched.cuh`` built for the host by g++ (skips without
    g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of ssd_bwd_sched.cuh "
                    "needs it")
    import tempfile
    d = Path(tempfile.mkdtemp(prefix="ssd_bwd_sched_"))
    (d / "sched.cpp").write_text(_HOST_SRC)
    so = d / "libsched.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "sched.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    I, L, P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    for f in (lib.valid_tiles_of, lib.warp_tile_of):
        f.argtypes = [I, I]
        f.restype = I
    lib.ordered_sum_of.argtypes = [P, L, L, I]
    lib.ordered_sum_of.restype = ctypes.c_float
    yield lib
    shutil.rmtree(d, ignore_errors=True)


def test_schedule_constants_are_the_models(sched):
    assert (sched.chunk_rows(), sched.tile_rows()) == (CHUNK, 16)
    assert sched.pass_warps() * 2 == TILES


@pytest.mark.parametrize("l", [1, 15, 16, 17, 100, 127, 128, 129, 200, 300,
                               1024])
def test_valid_tiles_hold_every_row_below_l(sched, l):
    """Chunk c's valid tiles are the 16-row tiles holding a position below
    l: every such row lies in one, and a tile past them holds none."""
    nc = -(-l // CHUNK)
    for c in range(nc + 1):
        mt = sched.valid_tiles_of(c, l)
        rows = max(0, min(CHUNK, l - c * CHUNK))
        assert mt == -(-rows // 16)
        assert 16 * mt >= rows and 16 * (mt - 1) < max(rows, 1)


@pytest.mark.parametrize("mt", range(1, TILES + 1))
def test_both_passes_cover_every_causal_pair_once(sched, mt):
    """With mt valid tiles, the key-major warps (j-tile w, then TILES-1-w,
    i-tiles from j up) and the query-major warps (i-tile w, then
    TILES-1-w, j-tiles up to i) each visit every pair i >= j among the
    valid tiles exactly once, and no other; on a full chunk each warp
    visits TILES + 1 pairs in each pass."""
    want = sorted((i, j) for i in range(mt) for j in range(i + 1))
    key, query = [], []
    per_warp = []
    for w in range(sched.pass_warps()):
        n_key = n_query = 0
        for k in (0, 1):
            t = sched.warp_tile_of(w, k)
            if t >= mt:
                continue
            key += [(i, t) for i in range(t, mt)]
            query += [(t, j) for j in range(t + 1)]
            n_key += mt - t
            n_query += t + 1
        per_warp.append((n_key, n_query))
    assert sorted(key) == want and sorted(query) == want
    if mt == TILES:
        assert per_warp == [(TILES + 1, TILES + 1)] * sched.pass_warps()


def test_sums_run_in_index_order(sched):
    """ordered_sum adds partial 0, 1, ... left to right: on values where
    float32 addition does not associate, its result is the left-to-right
    sum's bit for bit and not the other orders' (the heads' dB/dC
    partials, the chunks' dA partials)."""
    count, n = 4, 3
    part = np.zeros((count, n), np.float32)
    part[:, 1] = [1.0, 2.0 ** -24, 2.0 ** -24, -1.0]
    part[:, 2] = [2.0 ** 24, 1.0, 1.0, 1.0]
    for e in range(n):
        got = sched.ordered_sum_of(part.ctypes.data, e, n, count)
        want = np.float32(0)
        acc = part[0, e]
        for t in range(1, count):
            acc = np.float32(acc + part[t, e])
        want = acc
        assert np.float32(got).tobytes() == want.tobytes()
    rev = np.float32(np.float32(np.float32(part[3, 1] + part[2, 1])
                                + part[1, 1]) + part[0, 1])
    assert rev != np.float32(sched.ordered_sum_of(part.ctypes.data, 1, n,
                                                  count))
