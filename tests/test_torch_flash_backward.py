"""The port's flash attention backward against the JAX package, on the CPU.

* The autograd Function of ``kernels/flash_attention/ops.py`` (its plain
  versions on CPU tensors) gives the same dq, dk and dv as ``jax.grad``
  through the reference's training attention, ``repro.models.layers``'
  ``_sdpa`` and ``_blocked_sdpa`` (causal, non-causal, GQA, softcap, S < T):
  float32 within 1e-4 of each gradient's largest magnitude, bf16 within
  2e-2.
* ``flash_attention_backward_reference`` equals ``torch.autograd`` through
  ``flash_attention_reference``.
* The backward kernels' CTA programs (``csrc/flash_bwd_tile.cuh``) built
  for the host by g++ and run thread by thread, phase by phase, in the
  kernels' own order (the D pre-pass with its warp butterfly, dK/dV per key
  tile over the group's heads, dQ per query tile): their float32 dq, dk
  and dv against the plain version, at every head dim the kernels take,
  ragged S and T, S < T, softcap and GQA; the same call twice gives the
  same bits (no atomics).  The CUDA kernels themselves run only on the
  card (``chip_smoke.py``).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL

from repro_torch.kernels.flash_attention import ops, ref

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "flash_attention" / "csrc")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, S, T, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, T, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, T, KV, hd), dtype=np.float32)
    g = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    return q, k, v, g


def _near(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _port_grads(q, k, v, g, dtype, causal, softcap):
    tdt = DT[dtype][1]
    qt, kt, vt = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    out = ops.flash_attention_trainable(qt, kt, vt, causal=causal,
                                        softcap=softcap)
    out.backward(torch.from_numpy(g).to(tdt))
    return [t.grad.float().numpy() for t in (qt, kt, vt)]


def _jax_grads(q, k, v, g, dtype, causal, softcap, blocked):
    jdt = DT[dtype][0]
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV

    def loss(q, k, v):
        if blocked:
            ke = jnp.repeat(k, G, axis=2) if G > 1 else k
            ve = jnp.repeat(v, G, axis=2) if G > 1 else v
            out = JL._blocked_sdpa(q, ke, ve, causal=causal, softcap=softcap,
                                   q_chunk=S, kv_chunk=T, unroll=False)
        else:
            mask = JL._causal_mask(B, S, T) if causal else None
            out = JL._sdpa(q, k, v, mask, softcap)
        return jnp.sum(out.astype(jnp.float32)
                       * jnp.asarray(g, jdt).reshape(B, S, H * hd)
                       .astype(jnp.float32))

    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


CASES = {                      # B, S, T, H, KV, hd, causal, softcap
    "causal": (2, 32, 32, 4, 4, 32, True, 0.0),
    "non_causal": (2, 32, 32, 4, 4, 32, False, 0.0),
    "gqa": (2, 32, 32, 8, 2, 32, True, 0.0),
    "softcap": (2, 32, 32, 4, 2, 32, True, 30.0),
    "s_under_t": (2, 16, 48, 4, 2, 32, True, 0.0),
}


@pytest.mark.parametrize("blocked", [False, True],
                         ids=["sdpa", "blocked_sdpa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_jax(case, dtype, blocked):
    B, S, T, H, KV, hd, causal, cap = CASES[case]
    q, k, v, g = _inputs(len(case), B, S, T, H, KV, hd)
    if dtype == "bfloat16":   # round the inputs once: both packages see them
        q, k, v, g = (torch.from_numpy(a).bfloat16().float().numpy()
                      for a in (q, k, v, g))
    got = _port_grads(q, k, v, g, dtype, causal, cap)
    want = _jax_grads(q, k, v, g, dtype, causal, cap, blocked)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _near(a, b, TOL[dtype], f"{case} {dtype} {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_reference_is_autograd(case):
    B, S, T, H, KV, hd, causal, cap = CASES[case]
    q, k, v, g = (torch.from_numpy(a) for a in
                  _inputs(7, B, S, T, H, KV, hd))
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = ref.flash_attention_reference(qa, ka, va, causal=causal,
                                        softcap=cap)
    out.backward(g)
    o2, lse = ref.flash_attention_reference(q, k, v, causal=causal,
                                            softcap=cap, return_lse=True)
    assert torch.equal(out.detach(), o2)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    got = ref.flash_attention_backward_reference(q, k, v, o2, lse, g,
                                                 causal=causal, softcap=cap)
    for name, a, t in zip(("dq", "dk", "dv"), got, (qa, ka, va)):
        _near(a.numpy(), t.grad.numpy(), 1e-5, f"{case} {name}")


def test_lse_is_logsumexp_of_scores():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(3, 1, 8, 12, 2, 1, 16))
    _, lse = ref.flash_attention_reference(q, k, v, causal=True,
                                           return_lse=True)
    s = torch.einsum("bshd,bthd->bhst", q, k.expand(-1, -1, 2, -1)) / 4.0
    live = torch.arange(12)[None, :] <= torch.arange(8)[:, None] + 4
    s = s.masked_fill(~live, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1))


def test_backward_wrapper_refuses_mismatches():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 1, 4, 4, 2, 1, 16))
    out, lse = ops.flash_attention_forward(q, k, v, with_lse=True)
    with pytest.raises(ValueError):
        ops.flash_attention_backward(q, k, v, out, lse[:, :, :2], g)
    with pytest.raises(ValueError):
        ops.flash_attention_backward(q, k, v, out[:, :2], lse, g)
    with pytest.raises(ValueError):
        ops.flash_attention_backward(q, k[:, :2], v[:, :2], out, lse, g)


def test_no_grad_forward_is_unchanged():
    """Serving's call (no lse) and the trainable forward give the same
    output; without grad the Function is not on the path."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(5, 2, 8, 8, 4, 2, 16))
    with torch.no_grad():
        a = ops.flash_attention(q, k, v)
    b = ops.flash_attention_trainable(q, k, v)
    assert torch.equal(a, b) and b.grad_fn is None
    qg = q.clone().requires_grad_()
    c = ops.flash_attention_trainable(qg, k, v)
    assert torch.equal(a, c.detach()) and c.grad_fn is not None


# ---------------------------------------------------------------------------
# The CTA programs of the backward kernels, built for the host
# ---------------------------------------------------------------------------

_HOST_SRC = r"""
#include <stdint.h>
#include <vector>
#include "flash_bwd_tile.cuh"

using namespace flash_bwd;

template <int N>
struct HostCta {
  std::vector<float> acc;
  HostCta() : acc(THREADS * N, 0.f) {}
  template <class F>
  void each(F&& f) {
    for (int t = 0; t < THREADS; ++t) f(t, &acc[t * N]);
  }
};

template <int HD>
void run(const Tensors<float>& t, const Shape& s) {
  const int64_t rows = (int64_t)s.B * s.S * s.H;
  for (int64_t row = 0; row < rows; ++row) {      // the D pre-pass
    float a[32], b[32];
    for (int l = 0; l < 32; ++l)
      a[l] = dsum_part<HD>(t.o + row * HD, t.dout + row * HD, l);
    for (int off = 16; off > 0; off /= 2) {        // __shfl_xor_sync
      for (int l = 0; l < 32; ++l) b[l] = a[l] + a[l ^ off];
      for (int l = 0; l < 32; ++l) a[l] = b[l];
    }
    const int64_t h = row % s.H, bs = row / s.H;
    t.dsum[((bs / s.S) * s.H + h) * s.S + bs % s.S] = a[0];
  }
  std::vector<float> sm(Tile<HD>::floats);
  for (int b = 0; b < s.B; ++b)
    for (int kvh = 0; kvh < s.KV; ++kvh)
      for (int jt = 0; jt * C < s.T; ++jt) {
        HostCta<HD / 4> cta;
        dkdv_block<HD>(cta, sm.data(), t, s, jt, kvh, b);
      }
  for (int b = 0; b < s.B; ++b)
    for (int h = 0; h < s.H; ++h)
      for (int it = 0; it * R < s.S; ++it) {
        HostCta<HD / 8> cta;
        dq_block<HD>(cta, sm.data(), t, s, it, h, b);
      }
}

extern "C" int bwd_host(const float* q, const float* k, const float* v,
                        const float* o, const float* dout, const float* lse,
                        float* dsum, float* dq, float* dk, float* dv, int B,
                        int S, int T, int H, int KV, int hd, int causal,
                        float softcap, float scale) {
  const Tensors<float> t{q, k, v, o, dout, lse, dsum, dq, dk, dv};
  const Shape s{B, S, T, H, KV, causal, softcap, scale};
  switch (hd) {
    case 16: run<16>(t, s); return 0;
    case 32: run<32>(t, s); return 0;
    case 64: run<64>(t, s); return 0;
    case 80: run<80>(t, s); return 0;
    case 128: run<128>(t, s); return 0;
    default: return 1;
  }
}
"""


@pytest.fixture(scope="module")
def host_bwd(tmp_path_factory):
    """``flash_bwd_tile.cuh`` built for the host by g++ (skips without
    g++): ``bwd_host`` runs the three launches' CTA programs on float32
    host arrays."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of flash_bwd_tile.cuh "
                    "needs it")
    d = tmp_path_factory.mktemp("flash_bwd")
    (d / "host.cpp").write_text(_HOST_SRC)
    so = d / "libflash_bwd.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "host.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bwd_host.argtypes = [P] * 10 + [I] * 7 + [F, F]
    lib.bwd_host.restype = I

    def run(q, k, v, out, lse, dout, causal, softcap):
        B, S, H, hd = q.shape
        T, KV = k.shape[1], k.shape[2]
        dsum = torch.empty(B, H, S)
        dq, dk, dv = (torch.full_like(t, float("nan")) for t in (q, k, v))
        rc = lib.bwd_host(*(t.data_ptr() for t in (q, k, v, out, dout, lse,
                                                   dsum, dq, dk, dv)),
                          B, S, T, H, KV, hd, int(causal), softcap,
                          hd ** -0.5)
        assert rc == 0
        return dq, dk, dv
    return run


HOST_CASES = {                 # B, S, T, H, KV, hd, causal, softcap
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


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_build_matches_plain(host_bwd, case):
    B, S, T, H, KV, hd, causal, cap = HOST_CASES[case]
    q, k, v, g = (torch.from_numpy(a) for a in
                  _inputs(11, B, S, T, H, KV, hd))
    out, lse = ref.flash_attention_reference(q, k, v, causal=causal,
                                             softcap=cap, return_lse=True)
    got = host_bwd(q, k, v, out, lse, g, causal, cap)
    want = ref.flash_attention_backward_reference(q, k, v, out, lse, g,
                                                  causal=causal, softcap=cap)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), f"{case} {name}: unwritten output"
        _near(a.numpy(), b.numpy(), TOL["float32"], f"{case} {name}")
    again = host_bwd(q, k, v, out, lse, g, causal, cap)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
