"""The port's flash attention backward against the JAX package, on the CPU.

* The autograd Function of ``kernels/flash_attention/ops.py`` (its plain
  versions on CPU tensors) gives the same dq, dk and dv as ``jax.grad``
  through the reference's training attention, ``repro.models.layers``'
  ``_sdpa`` and ``_blocked_sdpa`` (causal, non-causal, GQA, softcap, S < T):
  float32 within 1e-4 of each gradient's largest magnitude, bf16 within
  2e-2.
* ``flash_attention_backward_reference`` equals ``torch.autograd`` through
  ``flash_attention_reference``.

The backward kernels' design (their arithmetic in plain PyTorch, their
tile schedule and GQA sum built with g++) is checked in
``tests/test_torch_flash_bwd_design.py``; the CUDA kernels themselves run
only on the card (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL

from repro_torch.kernels.flash_attention import ops, ref

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
