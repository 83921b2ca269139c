"""The design of the bf16 ``ssd_scan`` kernel, checked on the CPU.

``csrc/ssd_scan.cu`` runs the SSD chunk products of bf16 inputs on the
tensor cores (``mma.sync`` m16n8k16: bf16 operands, float32 accumulators).
Its precision scheme: B, C and x are exact bf16 operands; every float32
factor is either applied in float32 to an accumulator (``exp(cum_i)`` on the
rows of C S_prevᵀ, ``exp(cum_end)`` on the carried state) or split into a
bf16 hi + lo pair whose two products are summed (S_prev against C, the
masked scores ``(C Bᵀ) ∘ L ∘ dt_j`` against x, the decay-weighted
``x ∘ dt ∘ exp(cum_end - cum)`` against B).  The head dim is split over
CTAs of ``PT`` columns each, and a ragged last chunk computes only the
16-row tiles that hold rows below ``l``.

:func:`mma_model` does that in plain PyTorch: bf16-exact operands
multiplied in float32, the splits, the head-dim split and the trimmed
tiles.  It is held to ``ref.ssd_plain`` at ``chip_smoke.py``'s tolerances
(bf16 y within 2e-2, the final state within atol = rtol = 3e-4) at the
per-head widths of every SSM config (mamba2-1.3b: p 64, n 128; zamba2-2.7b:
p 64, n 64; both smoke configs: p 16, n 16), ragged lengths, a nonzero
initial state and two groups, with few heads and short sequences.  The
kernel itself runs only on the card (``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, PAPER_CASES, get_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref

CHUNK = 128
TILE = 16                 # rows of an m16n8k16 tile
Y_TOL = 2e-2              # chip_smoke.ssd_checks, bf16 y
STATE_TOL = 3e-4          # chip_smoke.ssd_checks, the final state


def _bf(t):
    """t rounded to bf16 and back: what a bf16 operand holds."""
    return t.to(torch.bfloat16).to(torch.float32)


def _split(v):
    """The kernel's hi + lo pair of a float32 operand."""
    hi = _bf(v)
    return hi, _bf(v - hi)


def _once(v):
    """A float32 operand rounded to bf16 once (no lo part)."""
    return _bf(v), torch.zeros_like(v)


def mma_model(x, dt, A, B, C, chunk, initial_state=None, pt=32,
              split=_split):
    """What ``ssd_mma_kernel`` computes, in plain PyTorch (float32 matmuls
    of bf16-exact operands).  Returns (y in x's type, final state)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    pt = min(pt, p)
    f32 = torch.float32
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
            # the chunk's cumsum runs over all CHUNK positions, dt = 0 past
            # the valid rows: cum_end is the last valid row's
            cum = torch.cumsum(dc * a, dim=-1)
            tot = cum[..., -1]
            # y = exp(cum) o (C S_prev^T), S_prev as hi + lo
            Sh, Sl = split(S)
            yc = (Cc @ Sh.transpose(-1, -2) + Cc @ Sl.transpose(-1, -2)) \
                * torch.exp(cum)[..., None]
            # y += ((C B^T) o L o dt_j) x, the masked scores as hi + lo
            sc = Cc @ Bc.transpose(-1, -2)
            mask = torch.ones(rows, rows, dtype=torch.bool).tril()
            diff = torch.where(mask, cum[..., :, None] - cum[..., None, :],
                               torch.tensor(float("-inf")))
            P = sc * torch.exp(diff) * dc[..., None, :]
            Ph, Pl = split(P)
            yc = yc + (Ph @ xc + Pl @ xc)
            y[:, :, sl, p0:p0 + pt] = yc[:, :, :nv]
            # S = exp(cum_end) S + (x o dt o exp(cum_end - cum))^T B
            W = xc * (dc * torch.exp(tot[..., None] - cum))[..., None]
            Wh, Wl = split(W)
            S = S * torch.exp(tot)[..., None, None] \
                + (Wh.transpose(-1, -2) @ Bc + Wl.transpose(-1, -2) @ Bc)
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
# the shapes the card's kernels take
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", list(ARCH_IDS) + list(PAPER_CASES))
def test_config_ssm_shapes_have_kernels(arch, smoke):
    """Every registered config with Mamba2 layers has a (head dim, state,
    chunk) that ssd_scan is built for, at its dtype (the tensor-core
    kernel in bf16) and in float32 (the FMA kernel, the type of the
    card-vs-CPU cuts).  A kernel that drops an instance fails here, not on
    the card."""
    cfg = get_config(arch, smoke=smoke)
    if cfg.family not in ("ssm", "hybrid"):
        assert cfg.ssm_heads == 0 or cfg.family not in ("ssm", "hybrid")
        return
    want = {torch.bfloat16: "mma", torch.float32: "fma"}
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
