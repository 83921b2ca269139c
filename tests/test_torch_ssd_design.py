"""The design of the ``ssd_scan`` kernels, checked on the CPU.

``csrc/ssd_scan.cu`` runs the SSD chunk products on the tensor cores
(``mma.sync`` m16n8k16: bf16 operands, float32 accumulators) in both types.

bf16 (``ssd_mma_kernel``): B, C and x are exact bf16 operands; every
float32 factor is either applied in float32 to an accumulator
(``exp(cum_i)`` on the rows of C S_prevᵀ, ``exp(cum_end)`` on the carried
state) or split into a bf16 hi + lo pair whose two products are summed
(S_prev against C, the masked scores ``(C Bᵀ) ∘ L ∘ dt_j`` against x, the
decay-weighted ``x ∘ dt ∘ exp(cum_end - cum)`` against B).

float32 (``ssd_mma3_kernel``): every operand, x, B and C too, is split into
three bf16 pieces hi + mid + lo (exact in float32's normal range), and each
product sums the six piece products that reach float32's rounding (hi hi,
hi mid, mid hi, hi lo, lo hi, mid mid).

In both the head dim is split over CTAs of ``PT`` columns each, and a ragged
last chunk computes only the 16-row tiles that hold rows below ``l``.

:func:`mma_model` does that in plain PyTorch: bf16-exact pieces multiplied
in float32, the splits, the head-dim split and the trimmed tiles.  The bf16
model is held to ``ref.ssd_plain`` at ``chip_smoke.py``'s tolerances (bf16
y within 2e-2, the final state within atol = rtol = 3e-4); the float32
model to the same 3e-4, to the JAX ``ssd_scan`` (Pallas, interpret mode)
and ``ssd_reference``, and to a float64 recurrence, from which it must lie
no farther than 4x the plain float32 version does.  Both run at the
per-head widths of every SSM config (mamba2-1.3b: p 64, n 128; zamba2-2.7b:
p 64, n 64; both smoke configs: p 16, n 16), ragged lengths, a nonzero
initial state and two groups, with few heads and short sequences.  The
kernels themselves run only on the card (``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.ssd_scan.ops import ssd as pallas_ssd
from repro.kernels.ssd_scan.ref import ssd_reference as jax_ssd_reference
from repro_torch.configs import ARCH_IDS, PAPER_CASES, get_config
from repro_torch.kernels.pieces import (bf as _bf, prod as _prod,
                                       split as _split, split3 as _split3)
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref

CHUNK = 128
TILE = 16                 # rows of an m16n8k16 tile
Y_TOL = 2e-2              # chip_smoke.ssd_checks, bf16 y
STATE_TOL = 3e-4          # chip_smoke.ssd_checks, the final state
# the float32 model against JAX's float32 kernel and reference: sums of up
# to 256 float32 terms in another order (the largest gap seen is 5e-6)
JAX_TOL = 2e-5
# how much farther from a float64 recurrence than the plain float32 version
# the float32 model may lie
ORACLE_RATIO = 4


def _once(v):
    """A float32 operand rounded to bf16 once (no lo part)."""
    return _bf(v), torch.zeros_like(v)


def _exact(v):
    """A bf16 operand: one piece, exact."""
    return (v,)


def _t(pieces):
    return [v.transpose(-1, -2) for v in pieces]


def mma_model(x, dt, A, B, C, chunk, initial_state=None, pt=32,
              split=None):
    """What ``ssd_mma_kernel`` (bf16 x, B, C) and ``ssd_mma3_kernel``
    (float32 x, B, C) compute, in plain PyTorch: float32 matmuls of
    bf16-exact pieces.  bf16: x, B and C are exact operands and every
    float32 factor is split by ``split`` (default hi + lo).  float32: x, B,
    C and every factor are split by ``split`` (default hi + mid + lo).
    Returns (y in x's type, final state)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    pt = min(pt, p)
    f32 = torch.float32
    three = x.dtype == f32
    split = split or (_split3 if three else _split)
    operand = split if three else _exact
    Bh = ref._to_heads(B, h).to(f32).transpose(1, 2)       # (b, h, l, n)
    Ch = ref._to_heads(C, h).to(f32).transpose(1, 2)
    xh = x.to(f32).transpose(1, 2)                         # (b, h, l, p)
    dth = dt.to(f32).transpose(1, 2)                       # (b, h, l)
    a = A.to(f32)[None, :, None]
    y = torch.zeros(b, h, l, p, dtype=f32)
    state = torch.zeros(b, h, p, n, dtype=f32) if initial_state is None \
        else initial_state.to(f32).clone()
    for p0 in range(0, p, pt):                 # the CTAs along the head dim
        S = state[..., p0:p0 + pt, :].clone()  # float32 accumulators
        for t0 in range(0, l, chunk):
            nv = min(chunk, l - t0)
            rows = TILE * math.ceil(nv / TILE)  # the tiles computed
            sl = slice(t0, t0 + nv)

            def tile(v):                       # zero-filled past l
                out = v.new_zeros(*v.shape[:2], rows, *v.shape[3:])
                out[:, :, :nv] = v[:, :, sl]
                return out
            Cc, Bc = tile(Ch), tile(Bh)
            xc = tile(xh[..., p0:p0 + pt])
            dc = tile(dth)
            Cp, Bp, xp = operand(Cc), operand(Bc), operand(xc)
            # the chunk's cumsum runs over all CHUNK positions, dt = 0 past
            # the valid rows: cum_end is the last valid row's
            cum = torch.cumsum(dc * a, dim=-1)
            tot = cum[..., -1]
            # y = exp(cum) o (C S_prev^T), S_prev split
            yc = _prod(Cp, _t(split(S))) * torch.exp(cum)[..., None]
            # y += ((C B^T) o L o dt_j) x, the masked scores split
            sc = _prod(Cp, _t(Bp))
            mask = torch.ones(rows, rows, dtype=torch.bool).tril()
            diff = torch.where(mask, cum[..., :, None] - cum[..., None, :],
                               torch.tensor(float("-inf")))
            P = sc * torch.exp(diff) * dc[..., None, :]
            yc = yc + _prod(split(P), xp)
            y[:, :, sl, p0:p0 + pt] = yc[:, :, :nv]
            # S = exp(cum_end) S + (x o dt o exp(cum_end - cum))^T B
            W = xc * (dc * torch.exp(tot[..., None] - cum))[..., None]
            S = S * torch.exp(tot)[..., None, None] + _prod(_t(split(W)), Bp)
        state[..., p0:p0 + pt, :] = S
    return y.transpose(1, 2).to(x.dtype), state


def _inputs(seed, b, l, h, g, n, p, init, dtype=torch.bfloat16):
    """chip_smoke.ssd_checks's input scales, drawn with numpy; B and C as
    column slices of one (b, l, 2gn) projection."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, l, h, p)) * 0.5).float()
    dt = torch.from_numpy(rng.random((b, l, h)) * 0.5 + 0.1).float()
    A = -torch.from_numpy(rng.random(h) * 0.5 + 0.5).float()
    bc = torch.from_numpy(rng.standard_normal((b, l, 2 * g * n)) * 0.3).float()
    s0 = torch.from_numpy(rng.standard_normal((b, h, p, n)) * 0.5).float() \
        if init else None
    bc = bc.to(dtype)
    return (x.to(dtype), dt, A, bc[..., :g * n].reshape(b, l, g, n),
            bc[..., g * n:].reshape(b, l, g, n), s0)


# (b, l, h, g, n, p, initial state): the per-head widths of every SSM
# config, ragged lengths, an initial state and two groups
CASES = {
    "mamba2": (2, 384, 3, 1, 128, 64, False),
    "zamba2": (2, 384, 3, 1, 64, 64, False),
    "smoke": (2, 384, 8, 1, 16, 16, False),
    "ragged_11": (2, 11, 4, 1, 128, 64, False),
    "ragged_130": (2, 130, 4, 1, 64, 64, False),
    "initial_state": (2, 300, 3, 1, 128, 64, True),
    "smoke_initial_state": (2, 200, 8, 1, 16, 16, True),
    "groups_2": (2, 256, 4, 2, 128, 64, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mma_model_meets_the_card_tolerances(case):
    b, l, h, g, n, p, init = CASES[case]
    x, dt, A, B, C, s0 = _inputs(16, b, l, h, g, n, p, init)
    y, st = mma_model(x, dt, A, B, C, CHUNK, initial_state=s0)
    yw, sw = ref.ssd_plain(x, dt, A, B, C, CHUNK, initial_state=s0)
    assert y.dtype == yw.dtype == torch.bfloat16
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y.float(), yw.float(), atol=Y_TOL, rtol=Y_TOL)
    torch.testing.assert_close(st, sw, atol=STATE_TOL, rtol=STATE_TOL)


@pytest.mark.parametrize("case", ["mamba2", "zamba2", "smoke"])
def test_splitting_the_head_dim_changes_nothing_beyond_rounding(case):
    """One CTA per (b, h) and PT-column CTAs compute each column alike."""
    b, l, h, g, n, p, init = CASES[case]
    x, dt, A, B, C, s0 = _inputs(17, b, l, h, g, n, p, init)
    y1, s1 = mma_model(x, dt, A, B, C, CHUNK, pt=p)
    y2, s2 = mma_model(x, dt, A, B, C, CHUNK, pt=16)
    torch.testing.assert_close(y1.float(), y2.float(), atol=Y_TOL, rtol=0)
    torch.testing.assert_close(s1, s2, atol=1e-6, rtol=1e-6)


def test_trimmed_tiles_leave_the_final_state_of_the_padded_reference():
    """A ragged last chunk computes 16 rows (l = 11), the reference 128
    zero-padded ones: the final states agree."""
    x, dt, A, B, C, _ = _inputs(18, 2, 139, 3, 1, 128, 64, False)
    y, st = mma_model(x, dt, A, B, C, CHUNK)
    yw, sw = ref.ssd_plain(x, dt, A, B, C, CHUNK)
    assert y.shape == yw.shape == (2, 139, 3, 64)
    torch.testing.assert_close(st, sw, atol=STATE_TOL, rtol=STATE_TOL)


@pytest.mark.parametrize("case", ["mamba2", "initial_state"])
def test_rounding_the_factors_once_misses_the_state_tolerance(case):
    """Why the float32 operands are split: rounded to bf16 once, the final
    state lands beyond 3e-4 of the plain version."""
    b, l, h, g, n, p, init = CASES[case]
    x, dt, A, B, C, s0 = _inputs(16, b, l, h, g, n, p, init)
    _, st = mma_model(x, dt, A, B, C, CHUNK, initial_state=s0, split=_once)
    _, sw = ref.ssd_plain(x, dt, A, B, C, CHUNK, initial_state=s0)
    assert not torch.allclose(st, sw, atol=STATE_TOL, rtol=STATE_TOL)


# ---------------------------------------------------------------------------
# float32: three bf16 pieces, six products
# ---------------------------------------------------------------------------

def oracle64(x, dt, A, B, C, initial_state=None):
    """The SSM recurrence position by position in float64, on the same
    (float32) inputs: (y, final state)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    f64 = torch.float64
    Bh, Ch = (ref._to_heads(v, h).to(f64) for v in (B, C))
    x, dt, A = x.to(f64), dt.to(f64), A.to(f64)
    s = torch.zeros(b, h, p, n, dtype=f64) if initial_state is None \
        else initial_state.to(f64).clone()
    ys = []
    for t in range(l):
        s = s * torch.exp(dt[:, t] * A)[..., None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", s, Ch[:, t]))
    return torch.stack(ys, 1), s


def _dist(a, oracle):
    return float((a.to(torch.float64) - oracle).abs().max())


# (b, l, h, g, n, p, initial state)
CASES_F32 = {
    "mamba2": (2, 256, 2, 1, 128, 64, False),
    "zamba2": (2, 256, 2, 1, 64, 64, False),
    "smoke": (2, 256, 4, 1, 16, 16, False),
    "ragged_130": (2, 130, 2, 1, 128, 64, False),
    "ragged_11_initial_state": (2, 11, 2, 1, 64, 64, True),
    "initial_state": (2, 300, 2, 1, 128, 64, True),
    "smoke_ragged_initial_state": (2, 200, 4, 1, 16, 16, True),
    "groups_2": (2, 256, 4, 2, 128, 64, False),
}


def _f32_case(case, seed=16):
    b, l, h, g, n, p, init = CASES_F32[case]
    return _inputs(seed, b, l, h, g, n, p, init, dtype=torch.float32)


def test_three_piece_split_is_exact():
    """hi + mid + lo == v bit for bit on seeded float32 values from 2^-100
    to 2^100, each piece a bf16 value, each smaller than the last by at
    least 2^8."""
    rng = np.random.default_rng(20)
    mant = rng.uniform(1.0, 2.0, 200_000) * rng.choice([-1.0, 1.0], 200_000)
    v = torch.from_numpy(np.ldexp(mant, rng.integers(-100, 101, 200_000))
                         .astype(np.float32))
    hi, mid, lo = _split3(v)
    assert v.dtype == hi.dtype == torch.float32
    assert torch.equal((hi + mid) + lo, v)
    for piece in (hi, mid, lo):
        assert torch.equal(_bf(piece), piece)
    assert bool((mid.abs() <= hi.abs() * 2.0**-8).all())
    assert bool((lo.abs() <= mid.abs() * 2.0**-8).all())


@pytest.mark.parametrize("case", list(CASES_F32))
def test_mma3_model_is_as_close_to_float64_as_the_plain_version(case):
    """The six products keep float32's accuracy: y and the final state lie
    within 4x the plain version's distance from a float64 recurrence, and
    within the card's 3e-4 of the plain version."""
    x, dt, A, B, C, s0 = _f32_case(case)
    y, st = mma_model(x, dt, A, B, C, CHUNK, initial_state=s0)
    yw, sw = ref.ssd_plain(x, dt, A, B, C, CHUNK, initial_state=s0)
    yo, so = oracle64(x, dt, A, B, C, s0)
    assert y.dtype == torch.float32 and y.shape == x.shape
    torch.testing.assert_close(y, yw, atol=STATE_TOL, rtol=STATE_TOL)
    torch.testing.assert_close(st, sw, atol=STATE_TOL, rtol=STATE_TOL)
    assert _dist(y, yo) <= ORACLE_RATIO * _dist(yw, yo)
    assert _dist(st, so) <= ORACLE_RATIO * _dist(sw, so)


@pytest.mark.parametrize("case", list(CASES_F32))
def test_mma3_model_matches_jax(case):
    """y against the JAX ``ssd_scan`` Pallas kernel in interpret mode (it
    takes no initial state), y and the final state against the JAX
    ``ssd_reference`` (zero-padded to whole chunks, as the JAX model pads
    a ragged length)."""
    x, dt, A, B, C, s0 = _f32_case(case)
    y, st = mma_model(x, dt, A, B, C, CHUNK, initial_state=s0)
    l = x.shape[1]
    whole = -(-l // CHUNK) * CHUNK

    def j(t, pad=False):
        if pad:
            t = torch.nn.functional.pad(
                t, [0, 0] * (t.dim() - 2) + [0, whole - l])
        return jnp.asarray(t.numpy())
    yj, sj = jax_ssd_reference(
        j(x, True), j(dt, True), j(A), j(B, True), j(C, True), CHUNK,
        initial_state=None if s0 is None else j(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj)[:, :l],
                               atol=JAX_TOL, rtol=JAX_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=JAX_TOL,
                               rtol=JAX_TOL)
    if s0 is None:
        yk = pallas_ssd(j(x), j(dt), j(A), j(B), j(C), chunk=CHUNK)
        np.testing.assert_allclose(y.numpy(), np.asarray(yk), atol=JAX_TOL,
                                   rtol=JAX_TOL)


@pytest.mark.parametrize("case", list(CASES_F32))
def test_two_pieces_and_three_products_miss_float32(case):
    """Why three pieces and six products: hi + lo pieces and their three
    products (hi hi, hi lo, lo hi) put y beyond 4x the plain version's
    distance from the float64 recurrence."""
    x, dt, A, B, C, s0 = _f32_case(case)
    y, _ = mma_model(x, dt, A, B, C, CHUNK, initial_state=s0, split=_split)
    yw, _ = ref.ssd_plain(x, dt, A, B, C, CHUNK, initial_state=s0)
    yo, _ = oracle64(x, dt, A, B, C, s0)
    assert _dist(y, yo) > ORACLE_RATIO * _dist(yw, yo)


# ---------------------------------------------------------------------------
# the shapes the card's kernels take
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", list(ARCH_IDS) + list(PAPER_CASES))
def test_config_ssm_shapes_have_kernels(arch, smoke):
    """Every registered config with Mamba2 layers has a (head dim, state,
    chunk) that ssd_scan is built for, at its dtype (the tensor-core
    kernel in bf16) and in float32 (the three-piece tensor-core kernel,
    the type of the card-vs-CPU cuts).  A kernel that drops an instance
    fails here, not on the card."""
    cfg = get_config(arch, smoke=smoke)
    if cfg.family not in ("ssm", "hybrid"):
        assert cfg.ssm_heads == 0 or cfg.family not in ("ssm", "hybrid")
        return
    want = {torch.bfloat16: "mma", torch.float32: "mma3"}
    for dt in {cfg.torch_dtype, torch.float32}:
        assert ssd_ops.check_kernel_shape(
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, dt) == want[dt]


@pytest.mark.parametrize("p,n,chunk,dtype,match", [
    (32, 128, 128, torch.bfloat16, "head dim 32"),
    (64, 32, 128, torch.float32, "state 32"),
    (64, 128, 64, torch.bfloat16, "chunk 64"),
    (64, 128, 128, torch.float16, "float16"),
])
def test_kernel_shape_check_refuses_the_rest(p, n, chunk, dtype, match):
    with pytest.raises(ValueError, match=match):
        ssd_ops.check_kernel_shape(p, n, chunk, dtype)


def test_cpu_tensors_run_the_plain_version_at_any_shape():
    """The refusal is the card's: on the CPU the wrapper runs ssd_plain at
    a shape no kernel is built for."""
    x, dt, A, B, C, _ = _inputs(19, 1, 40, 2, 1, 24, 8, False,
                                dtype=torch.float32)
    y, st = ssd_ops.ssd(x, dt, A, B, C, 32)
    yw, sw = ref.ssd_plain(x, dt, A, B, C, 32)
    assert torch.equal(y, yw) and torch.equal(st, sw)
