"""The design of the flash attention backward kernels, checked on the CPU.

``csrc/flash_attention_bwd.cu`` runs the backward on the tensor cores
(``mma.sync`` m16n8k16, float32 accumulators): a dK/dV kernel per (64-key
tile, query head) over the query tiles that see its keys, a dQ kernel per
(64-query tile, head) over the key tiles up to its diagonal, and, where a
KV head serves G > 1 query heads, a last launch that sums the heads'
float32 partials of dK and dV in head order.

:func:`flash_bwd_model` does the kernels' arithmetic in plain PyTorch:
every product summed k16 step by k16 step on one float32 accumulator; in
bf16 the operands as stored and P and dS rounded to bf16 before the
products that take them; in float32 every operand (P and dS too) split
into three bf16 pieces and six piece products a step, smallest first
(``repro_torch.kernels.pieces``, the order of ``mma3.cuh``); the GQA
partials summed in head order.  It is held, on the nine shapes the
earlier host build of the FMA kernels ran, in both types, to

* the JAX package's gradients of ``_sdpa`` and ``_blocked_sdpa``
  (``jax.grad``, as ``tests/test_torch_flash_backward.py`` computes them)
  at that file's ``TOL``;
* the plain ``flash_attention_backward_reference`` at the card's
  ``BWD_TOL`` (chip_smoke);
* a float64 backward: the float32 model within 4x the plain float32
  version's distance (two pieces and three products miss it).

The kernels' tile schedule and head order (``csrc/flash_bwd_sched.cuh``)
are built with g++ and checked: every (tile, head, batch) exactly once,
heaviest tile first; the streamed rows cover every live (query, key) pair
and no tile without one; the GQA sum in head order, bit for bit.  The CUDA
kernels themselves run only on the card (``chip_smoke.py``).
"""

import ctypes
import functools
import math
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL

from repro_torch.kernels import pieces
from repro_torch.kernels.flash_attention import ops, ref

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "flash_attention" / "csrc")
STEP = 16                 # the depth of an m16n8k16 product
FIXED, STREAM = 64, 32    # flash_bwd_sched.cuh's tile rows
TOL = {"float32": 1e-4, "bfloat16": 2e-2}       # against JAX's gradients
CARD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # chip_smoke.BWD_TOL
ORACLE_RATIO = 4
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# (B, S, T, H, KV, hd, causal, softcap): qwen2.5-3b's head dim over a KV
# group, ragged and right-aligned rows, the masks, every other head dim,
# whisper's cross shape and a group of 8
CASES = {
    "slice_hd128": (2, 64, 64, 4, 2, 128, True, 0.0),
    "ragged_130_200": (1, 130, 200, 2, 1, 32, True, 0.0),
    "non_causal": (2, 40, 40, 4, 2, 64, False, 0.0),
    "softcap_30": (2, 48, 48, 4, 2, 64, True, 30.0),
    "s512_under_t_like": (1, 24, 72, 2, 2, 32, True, 0.0),
    "hd16": (2, 33, 33, 2, 1, 16, True, 0.0),
    "hd80": (1, 40, 40, 4, 4, 80, True, 0.0),
    "cross_11_over_75": (2, 11, 75, 6, 6, 64, False, 0.0),
    "gqa_8": (1, 32, 32, 8, 1, 32, True, 0.0),
}


def _inputs(case, dtype, seed=11):
    """q, k, v, dO from numpy (rounded to bf16 once in bf16, so that both
    packages see the same values), float32 numpy arrays."""
    B, S, T, H, KV, hd, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd),
                          (B, S, H, hd))]
    if dtype == "bfloat16":
        arrs = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrs]
    return arrs


def _t(ps):
    return [p.transpose(-1, -2) for p in ps]


def flash_bwd_model(q, k, v, out, lse, dout, causal=True, softcap=0.0,
                    split=None):
    """What the backward kernels compute, in plain PyTorch: q, out, dout
    (B, S, H, hd), k, v (B, T, KV, hd) in their type, lse float32 (B, H, S)
    -> (dq, dk, dv) in the inputs' type.  ``split`` cuts an operand into
    the bf16 pieces the kernel multiplies (default: bf16 as is, float32
    ``pieces.split3``)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    if split is None:
        split = (lambda t: [pieces.bf(t)]) if q.dtype == torch.bfloat16 \
            else pieces.split3
    scale = 1.0 / math.sqrt(hd)
    qh = q.float().transpose(1, 2)                             # (B, H, S, hd)
    kh = k.float().repeat_interleave(G, 2).transpose(1, 2)     # (B, H, T, hd)
    vh = v.float().repeat_interleave(G, 2).transpose(1, 2)
    doh = dout.float().transpose(1, 2)
    dsum = (doh * out.float().transpose(1, 2)).sum(-1)         # (B, H, S)
    qp, kp, vp, dop = (split(t) for t in (qh, kh, vh, doh))
    live = torch.ones(S, T, dtype=torch.bool)
    if causal:
        live = torch.arange(T)[None, :] <= torch.arange(S)[:, None] + (T - S)

    def p_ds(s, dp):
        """P and dS of scores s and dP (B, H, S, T)."""
        u = s * scale
        dcap = torch.ones_like(u)
        if softcap > 0.0:
            t = torch.tanh(u / softcap)
            u, dcap = softcap * t, 1.0 - t * t
        p = torch.where(live, torch.exp(u - lse[..., None]),
                        torch.zeros_like(u))
        return p, p * (dp - dsum[..., None]) * dcap * scale

    # the dK/dV kernel: S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and
    # dK += dS^T Q over the queries, k16 step by k16 step
    st = pieces.prod(kp, _t(qp), step=STEP)                    # (B, H, T, S)
    dpt = pieces.prod(vp, _t(dop), step=STEP)
    pt, dst = (x.transpose(-1, -2) for x in p_ds(st.transpose(-1, -2),
                                                 dpt.transpose(-1, -2)))
    dv_h = pieces.prod(split(pt), dop, step=STEP)              # (B, H, T, hd)
    dk_h = pieces.prod(split(dst), qp, step=STEP)

    def head_sum(x):                    # the G partials in head order
        x = x.view(B, KV, G, T, hd)
        acc = x[:, :, 0]
        for g in range(1, G):
            acc = acc + x[:, :, g]
        return acc

    # the dQ kernel: S and dP recomputed, dQ += dS K over the keys
    s = pieces.prod(qp, _t(kp), step=STEP)                     # (B, H, S, T)
    dp = pieces.prod(dop, _t(vp), step=STEP)
    _, ds = p_ds(s, dp)
    dq = pieces.prod(split(ds), kp, step=STEP)
    return (dq.transpose(1, 2).to(q.dtype).contiguous(),
            head_sum(dk_h).transpose(1, 2).to(k.dtype).contiguous(),
            head_sum(dv_h).transpose(1, 2).to(v.dtype).contiguous())


@functools.lru_cache(maxsize=None)
def _model_grads(case, dtype, split=None):
    """The model's (dq, dk, dv) on the case's inputs, from the plain
    forward's output and log-sum-exp, as float32 tensors; and the plain
    backward's on the same.  Computed once per (case, dtype, split) for
    the module (the tests only read them)."""
    _, _, _, _, _, _, causal, cap = CASES[case]
    tdt = DT[dtype][1]
    q, k, v, g = (torch.from_numpy(a).to(tdt) for a in _inputs(case, dtype))
    out, lse = ref.flash_attention_reference(q, k, v, causal=causal,
                                             softcap=cap, return_lse=True)
    got = flash_bwd_model(q, k, v, out, lse, g, causal, cap, split)
    plain = ref.flash_attention_backward_reference(
        q, k, v, out, lse, g, causal=causal, softcap=cap)
    return (tuple(t.float() for t in got),
            tuple(t.float() for t in plain))


@functools.lru_cache(maxsize=None)
def _jax_grads(case, dtype, blocked):
    """jax.grad of sum(out * dO) through the reference's ``_sdpa`` or
    ``_blocked_sdpa`` (K and V repeated over the group), jitted, float32
    numpy; once per (case, dtype, blocked)."""
    B, S, T, H, KV, hd, causal, cap = CASES[case]
    G = H // KV
    jdt = DT[dtype][0]
    q, k, v, g = _inputs(case, dtype)

    def loss(q, k, v):
        if blocked:
            ke = jnp.repeat(k, G, axis=2) if G > 1 else k
            ve = jnp.repeat(v, G, axis=2) if G > 1 else v
            out = JL._blocked_sdpa(q, ke, ve, causal=causal, softcap=cap,
                                   q_chunk=S, kv_chunk=T, unroll=False)
        else:
            mask = JL._causal_mask(B, S, T) if causal else None
            out = JL._sdpa(q, k, v, mask, cap)
        return jnp.sum(out.astype(jnp.float32)
                       * jnp.asarray(g, jdt).reshape(B, S, H * hd)
                       .astype(jnp.float32))

    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    # jitted, as the reference trains: op by op the same gradient took 4x
    # as long (float32 equal to 2.5e-7 of the scale, bf16 to 8.9e-4)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return tuple(np.asarray(x.astype(jnp.float32)) for x in grads)


def _scaled_dist(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@functools.lru_cache(maxsize=None)
def _oracle64(case):
    """The gradients in float64 on the float32 inputs: autograd through a
    float64 attention; once per case."""
    _, _, _, _, KV, _, causal, cap = CASES[case]
    q, k, v, g = (torch.from_numpy(a).double() for a in
                  _inputs(case, "float32"))
    B, S, H, hd = q.shape
    T = k.shape[1]
    G = H // KV
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    kh = ka.repeat_interleave(G, 2).transpose(1, 2)
    vh = va.repeat_interleave(G, 2).transpose(1, 2)
    s = (qa.transpose(1, 2) @ kh.transpose(-1, -2)) / math.sqrt(hd)
    if cap > 0.0:
        s = cap * torch.tanh(s / cap)
    if causal:
        hide = torch.arange(T)[None, :] > torch.arange(S)[:, None] + (T - S)
        s = s.masked_fill(hide, -math.inf)
    out = (torch.softmax(s, -1) @ vh).transpose(1, 2)
    out.backward(g)
    return tuple(t.grad for t in (qa, ka, va))


@pytest.mark.parametrize("blocked", [False, True],
                         ids=["sdpa", "blocked_sdpa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case, dtype, blocked):
    """The model's gradients against ``jax.grad`` through the reference's
    training attention, within TOL of each gradient's largest
    magnitude."""
    got, _ = _model_grads(case, dtype)
    want = _jax_grads(case, dtype, blocked)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), f"{case} {dtype} {name}"
        d = _scaled_dist(a.numpy(), b)
        assert d <= TOL[dtype], f"{case} {dtype} {name}: {d} > {TOL[dtype]}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_plain(case, dtype):
    """The model against the plain backward at the card's tolerance
    (chip_smoke's BWD_TOL, of each gradient's largest magnitude)."""
    got, plain = _model_grads(case, dtype)
    for name, a, b in zip(("dq", "dk", "dv"), got, plain):
        d = _scaled_dist(a.numpy(), b.numpy())
        assert d <= CARD_TOL[dtype], f"{case} {dtype} {name}: {d}"


@pytest.mark.parametrize("case", list(CASES))
def test_float32_model_is_as_close_to_float64_as_the_plain_version(case):
    """Three pieces and six products keep float32's accuracy: each
    gradient of the float32 model lies within 4x the plain float32
    version's distance from the float64 gradient."""
    got, plain = _model_grads(case, "float32")
    exact = _oracle64(case)
    for name, a, p, x in zip(("dq", "dk", "dv"), got, plain, exact):
        da = float((a.double() - x).abs().max())
        dp = float((p.double() - x).abs().max())
        assert da <= ORACLE_RATIO * dp, f"{case} {name}: {da} vs plain {dp}"


@pytest.mark.parametrize("case", list(CASES))
def test_two_pieces_and_three_products_miss_float32(case):
    """Why three pieces: hi + lo pieces and their three products (lo hi,
    hi lo, hi hi) put some gradient beyond 4x the plain float32 version's
    distance from float64 (11-47x on these cases)."""
    got, plain = _model_grads(case, "float32", split=pieces.split)
    exact = _oracle64(case)
    ratios = [float((a.double() - x).abs().max())
              / float((p.double() - x).abs().max())
              for a, p, x in zip(got, plain, exact)]
    assert max(ratios) > ORACLE_RATIO, f"{case}: {ratios}"


def test_backward_designs_by_type():
    """The wrapper names one backward design per type: bf16 ``mma``,
    float32 ``mma3`` (this model's three pieces), at every head dim the
    kernels are built for; the occupancy query refuses any other head dim
    before it reaches the card."""
    assert ops.BWD_DESIGNS == {torch.bfloat16: "mma", torch.float32: "mma3"}
    for dt in ops.BWD_DESIGNS:
        for hd in ops.HEAD_DIMS:
            ops.check_kernel_shape(hd, dt)
    with pytest.raises(ValueError, match="head_dim 96"):
        ops.bwd_blocks_per_sm(96, torch.bfloat16)


# ---------------------------------------------------------------------------
# The tile schedule and the head order, built for the host
# ---------------------------------------------------------------------------

_HOST_SRC = r"""
#include <stdint.h>
#include "flash_bwd_sched.cuh"

using namespace flash_bwd;

extern "C" {
int fixed_rows() { return FIXED; }
int stream_rows() { return STREAM; }
void tiles(int64_t n_blocks, int n_tiles, int H, int B, int rev, int* out) {
  for (int64_t i = 0; i < n_blocks; ++i) {
    const Tile t = tile_of(i, n_tiles, H, B, rev != 0);
    out[3 * i] = t.tile;
    out[3 * i + 1] = t.head;
    out[3 * i + 2] = t.batch;
  }
}
int first_query_of(int key0, int S, int T, int causal) {
  return first_query(key0, S, T, causal != 0);
}
int key_end_of(int q0, int S, int T, int causal) {
  return key_end(q0, S, T, causal != 0);
}
int is_live(int q, int k, int S, int T, int causal) {
  return live(q, k, S, T, causal != 0);
}
float head_sum_of(const float* part, int64_t e, int64_t n, int G) {
  return head_sum(part, e, n, G, [](float a, float b) { return a + b; });
}
}
"""


@pytest.fixture(scope="module")
def sched():
    """``flash_bwd_sched.cuh`` built for the host by g++ (skips without
    g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of flash_bwd_sched.cuh "
                    "needs it")
    import tempfile
    d = Path(tempfile.mkdtemp(prefix="flash_bwd_sched_"))
    (d / "sched.cpp").write_text(_HOST_SRC)
    so = d / "libsched.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "sched.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    I, L, P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.tiles.argtypes = [L, I, I, I, I, P]
    for f in (lib.first_query_of, lib.key_end_of):
        f.argtypes = [I] * 4
        f.restype = I
    lib.is_live.argtypes = [I] * 5
    lib.is_live.restype = I
    lib.head_sum_of.argtypes = [P, L, L, I]
    lib.head_sum_of.restype = ctypes.c_float
    yield lib
    shutil.rmtree(d, ignore_errors=True)


def test_tile_rows_are_the_models(sched):
    assert (sched.fixed_rows(), sched.stream_rows()) == (FIXED, STREAM)


# (B, S, T, H, causal): chip_smoke's BWD_CASES shapes and the cases above
SCHED_SHAPES = [(8, 128, 128, 16, True), (4, 1024, 1024, 16, True),
                (4, 1024, 1024, 16, False), (4, 512, 1024, 16, True),
                (2, 130, 200, 16, True), (4, 11, 1500, 6, False),
                (1, 24, 72, 2, True), (2, 33, 33, 2, True),
                (1, 1, 1, 1, True), (3, 100, 164, 3, True)]


@pytest.mark.parametrize("shape", SCHED_SHAPES,
                         ids=[f"B{b}_S{s}_T{t}_H{h}_{'c' if c else 'nc'}"
                              for b, s, t, h, c in SCHED_SHAPES])
def test_schedule_covers_every_tile_and_live_pair(sched, shape):
    """Both grids give every (tile, head, batch) one CTA, the heaviest
    tiles first; the streamed rows of each CTA hold every live (query,
    key) pair of its kept rows, and every STREAM tile it skips holds
    none."""
    B, S, T, H, causal = shape
    for kept, rev in ((T, False), (S, causal)):        # dK/dV, then dQ
        n_tiles = -(-kept // FIXED)
        n = n_tiles * H * B
        out = np.empty((n, 3), np.int32)
        sched.tiles(n, n_tiles, H, B, int(rev), out.ctypes.data)
        assert sorted(map(tuple, out)) == [
            (t, h, b) for t in range(n_tiles) for h in range(H)
            for b in range(B)]
        order = out[:, 0] if not rev else n_tiles - 1 - out[:, 0]
        assert (np.diff(order) >= 0).all()       # tile index slowest
    live = np.array([[sched.is_live(q, k, S, T, int(causal))
                      for k in range(T)] for q in range(S)], bool)
    want = np.arange(T)[None, :] <= np.arange(S)[:, None] + (T - S) \
        if causal else np.ones((S, T), bool)
    assert (live == want).all()
    for key0 in range(0, T, FIXED):       # dK/dV: queries [first, S)
        first = sched.first_query_of(key0, S, T, int(causal))
        assert first % STREAM == 0
        tile_live = live[:, key0:key0 + FIXED].any(axis=1)
        assert not tile_live[:first].any()
        assert tile_live[first:first + STREAM].any()
    for q0 in range(0, S, FIXED):         # dQ: keys [0, end)
        end = sched.key_end_of(q0, S, T, int(causal))
        rows_live = live[q0:q0 + FIXED].any(axis=0)
        assert not rows_live[end:].any() and rows_live[end - 1]


def test_gqa_sum_runs_in_head_order(sched):
    """head_sum adds partial g = 0, 1, ... left to right: on values where
    float32 addition does not associate, its result is the left-to-right
    sum's bit for bit and not the other orders'."""
    G, n = 4, 3
    part = np.zeros((G, n), np.float32)
    part[:, 1] = [1.0, 2.0 ** -24, 2.0 ** -24, -1.0]   # element 1
    part[:, 2] = [2.0 ** 24, 1.0, 1.0, 1.0]            # element 2
    got = [sched.head_sum_of(part.ctypes.data, e, n, G) for e in range(n)]
    for e in range(n):
        want = np.float32(0.0)
        for g in range(G):
            want = np.float32(part[0, e]) if g == 0 else want + part[g, e]
        assert np.float32(got[e]).tobytes() == want.tobytes()
    rev = np.float32(part[3, 2]) + part[2, 2] + part[1, 2] + part[0, 2]
    assert np.float32(got[2]) != rev      # the order shows


if __name__ == "__main__":
    # the distances behind the oracle test, case by case:
    # PYTHONPATH=src python tests/test_torch_flash_bwd_design.py
    for name in CASES:
        exact = _oracle64(name)
        got, plain = _model_grads(name, "float32")
        two, _ = _model_grads(name, "float32", split=pieces.split)
        for gname, a, p, t, x in zip(("dq", "dk", "dv"), got, plain, two,
                                     exact):
            dp = float((p.double() - x).abs().max())
            print(f"{name} {gname}: plain {dp:.3e}, three pieces "
                  f"{float((a.double() - x).abs().max()) / dp:.2f}x, two "
                  f"pieces {float((t.double() - x).abs().max()) / dp:.2f}x")
