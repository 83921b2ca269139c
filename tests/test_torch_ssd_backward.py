"""The SSD scan's gradient in the port, on the CPU.

The JAX package trains the Mamba2 layer through ``jax.grad`` of
``ssd_reference``; the port through ``ops.SSD``, whose backward is the
kernel in ``csrc/ssd_scan_bwd.cu`` on the card and the plain
``ref.ssd_plain_backward`` (autograd through ``ssd_plain``) on the CPU.

* The plain backward against ``jax.grad`` of the JAX ``ssd_reference``
  (ragged lengths zero-padded as the JAX model pads them), each of dx, ddt,
  dA, dB, dC and dinit within 1e-4 of its own largest magnitude: the smoke
  shape, mamba2's (P 64, N 128) and zamba2's (64, 64), ragged L, G = 2, a
  nonzero initial state and a nonzero dstate.
* The cases and the gradients of the scan's float64 quadratic form
  (``_oracle64``) serve ``tests/test_torch_ssd_bwd_design.py`` too, whose
  model of the kernels' arithmetic is held to them.
* ``ops.SSD`` on CPU tensors gives the plain backward's gradients, with a
  None gradient for the final state and through strided B/C views; the
  wrapper refuses tensors that are not all on one device.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_reference as jax_ssd

from repro_torch.kernels.ssd_scan import ops, ref

CHUNK = 128
TOL = 1e-4                 # of each gradient's largest magnitude
ORACLE_RATIO = 4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")

# (b, l, h, p, g, n, initial state, dstate)
CASES = {
    "smoke": (2, 128, 8, 16, 1, 16, False, False),
    "mamba2": (1, 128, 2, 64, 1, 128, False, False),
    "zamba2": (1, 128, 2, 64, 1, 64, False, False),
    "ragged_200": (2, 200, 2, 16, 1, 16, False, False),
    "groups_2": (1, 128, 4, 16, 2, 16, False, False),
    "initial_state": (1, 256, 2, 16, 1, 16, True, False),
    "dstate": (1, 256, 2, 16, 1, 16, False, True),
    "ragged_300_all": (1, 300, 4, 32, 2, 16, True, True),
    "odd_heads_3": (1, 128, 3, 16, 1, 16, False, False),
}


@functools.lru_cache(maxsize=None)
def _inputs(case):
    """float32 numpy inputs of a case (chip_smoke's scales): x, dt, A, B,
    C, init (or None), dy, dstate (or None)."""
    b, l, h, p, g, n, init, dstate = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    f = np.float32
    return (
        (rng.standard_normal((b, l, h, p)) * 0.5).astype(f),
        (rng.random((b, l, h)) * 0.5 + 0.1).astype(f),
        -(rng.random(h) * 0.5 + 0.5).astype(f),
        (rng.standard_normal((b, l, g, n)) * 0.3).astype(f),
        (rng.standard_normal((b, l, g, n)) * 0.3).astype(f),
        (rng.standard_normal((b, h, p, n)) * 0.5).astype(f) if init
        else None,
        rng.standard_normal((b, l, h, p)).astype(f),
        (rng.standard_normal((b, h, p, n)) * 0.5).astype(f) if dstate
        else None)


def _torch(case):
    return [None if a is None else torch.from_numpy(a)
            for a in _inputs(case)]


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    """jax.grad of sum(y dy) + sum(state dstate) through the JAX
    ssd_reference, the length zero-padded to the chunk as the JAX model
    pads it: (dx, ddt, dA, dB, dC, dinit or None) as numpy."""
    x, dt, A, B, C, init, dy, dstate = _inputs(case)
    l = x.shape[1]
    pad = (-l) % CHUNK

    def loss(x, dt, A, B, C, init):
        if pad:
            x, B, C = (jnp.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
                       for v in (x, B, C))
            dt = jnp.pad(dt, ((0, 0), (0, pad), (0, 0)))
        y, state = jax_ssd(x, dt, A, B, C, CHUNK, initial_state=init)
        out = jnp.sum(y[:, :l] * dy)
        if dstate is not None:
            out = out + jnp.sum(state * dstate)
        return out

    args = [jnp.asarray(v) for v in (x, dt, A, B, C)]
    if init is None:
        g = jax.jit(jax.grad(lambda *a: loss(*a, None),
                             argnums=(0, 1, 2, 3, 4)))(
            *args)
        return tuple(np.asarray(v) for v in g) + (None,)
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5)))(
        *args, jnp.asarray(init))
    return tuple(np.asarray(v) for v in g)


def _quadratic64(x, dt, A, B, C, init):
    """The scan in its quadratic form over the whole sequence, in float64
    (no chunks): y_i = sum_{j<=i} (C_i . B_j) e^{cum_i - cum_j} u_j +
    e^{cum_i} S0 C_i and the final state e^{cum_l} S0 + sum_j
    e^{cum_l - cum_j} u_j B_j^T, cum the running sum of dt A."""
    h, l = x.shape[2], x.shape[1]
    Bh, Ch = (ref._to_heads(v, h) for v in (B, C))
    cum = torch.cumsum(dt * A, dim=1)                   # (b, l, h)
    diff = cum[:, :, None] - cum[:, None, :]            # (b, i, j, h)
    causal = torch.ones(l, l, dtype=torch.bool).tril()[None, :, :, None]
    decay = torch.exp(diff.masked_fill(~causal, 0.0)) * causal
    u = x * dt[..., None]
    y = torch.einsum("bihn,bjhn,bijh,bjhp->bihp", Ch, Bh, decay, u)
    end = torch.exp(cum[:, -1:] - cum)                  # (b, l, h)
    state = torch.einsum("bjh,bjhp,bjhn->bhpn", end, u, Bh)
    if init is not None:
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bhpn,bihn->bihp", init, Ch)
        state = state + torch.exp(cum[:, -1])[..., None, None] * init
    return y, state


@functools.lru_cache(maxsize=None)
def _oracle64(case):
    """The gradients of the float64 quadratic form (autograd)."""
    x, dt, A, B, C, init, dy, dstate = _torch(case)
    ins = [v.double().requires_grad_() for v in (x, dt, A, B, C)]
    i64 = None if init is None else init.double().requires_grad_()
    y, s = _quadratic64(*ins, i64)
    out = (y * dy.double()).sum()
    if dstate is not None:
        out = out + (s * dstate.double()).sum()
    wrt = ins + ([] if i64 is None else [i64])
    g = torch.autograd.grad(out, wrt)
    return tuple(g) + ((None,) if i64 is None else ())


@functools.lru_cache(maxsize=None)
def _plain(case):
    x, dt, A, B, C, init, dy, dstate = _torch(case)
    return ref.ssd_plain_backward(x, dt, A, B, C, CHUNK, init, dy, dstate)


def _scaled_errs(got, want):
    """Each gradient's max |got - want| over its own largest |want|."""
    out = {}
    for name, a, w in zip(NAMES, got, want):
        assert (a is None) == (w is None), name
        if w is None:
            continue
        a = np.asarray(a, np.float64)
        w = np.asarray(w, np.float64)
        assert a.shape == w.shape, (name, a.shape, w.shape)
        out[name] = float(np.abs(a - w).max()) / max(float(np.abs(w).max()),
                                                     1e-30)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax(case):
    errs = _scaled_errs(_plain(case), _jax_grads(case))
    assert set(errs) == set(NAMES) - (
        set() if CASES[case][6] else {"dinit"})
    assert all(e <= TOL for e in errs.values()), errs


def test_function_gives_the_plain_gradients():
    """ops.SSD on CPU tensors: B and C as strided views of one projection
    (their gradient lands in it), the final state used and unused, an
    initial state's gradient returned."""
    x, dt, A, B, C, init, dy, dstate = _torch("ragged_300_all")
    gn = B.shape[2] * B.shape[3]
    bc = torch.cat([v.reshape(B.shape[:2] + (gn,)) for v in (B, C)], -1)
    for use_state in (True, False):
        leaves = [v.clone().requires_grad_() for v in (x, dt, A, bc, init)]
        xl, dtl, Al, bcl, il = leaves
        Bv = bcl[..., :gn].reshape(B.shape)
        Cv = bcl[..., gn:].reshape(C.shape)
        y, state = ops.SSD.apply(xl, dtl, Al, Bv, Cv, il, CHUNK)
        loss = (y * dy).sum() + ((state * dstate).sum() if use_state else 0)
        loss.backward()
        want = ref.ssd_plain_backward(x, dt, A, B, C, CHUNK, init, dy,
                                      dstate if use_state else None)
        for got, w in ((xl.grad, want[0]), (dtl.grad, want[1]),
                       (Al.grad, want[2]), (il.grad, want[5])):
            assert torch.equal(got, w)
        assert torch.equal(bcl.grad, torch.cat(
            [want[3].reshape(bc.shape[:2] + (gn,)),
             want[4].reshape(bc.shape[:2] + (gn,))], dim=-1))


def test_function_without_initial_state_or_grad(monkeypatch):
    """No initial state: no dinit.  The unused final state's gradient
    reaches the backward as None (no zero-filled dstate).  Under no_grad
    the Function is the forward."""
    x, dt, A, B, C, _, dy, _ = _torch("smoke")
    seen = []

    def spy(*args):
        seen.append(args[-1])
        return ref.ssd_plain_backward(*args)
    monkeypatch.setattr(ops, "ssd_plain_backward", spy)
    xl = x.clone().requires_grad_()
    y, _ = ops.SSD.apply(xl, dt, A, B, C, None, CHUNK)
    (y * dy).sum().backward()
    assert seen == [None]
    want = ref.ssd_plain_backward(x, dt, A, B, C, CHUNK, None, dy)
    assert want[5] is None and torch.equal(xl.grad, want[0])
    with torch.no_grad():
        y2, s2 = ops.SSD.apply(x, dt, A, B, C, None, CHUNK)
    y3, s3 = ops.ssd(x, dt, A, B, C, CHUNK)
    assert torch.equal(y2, y3) and torch.equal(s2, s3)


def test_backward_refuses_mixed_placement():
    x, dt, A, B, C, _, dy, _ = _torch("smoke")
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.ssd_backward(x, dt, A, B, C, CHUNK, None, dy.to("meta"))
    with pytest.raises(ValueError, match="dy"):
        ops.ssd_backward(x, dt, A, B, C, CHUNK, None, dy[:, :5])


def test_every_c_entry_is_bound_with_its_arity():
    """Every ``extern "C"`` entry of the kernels' sources has a ctypes
    signature in ``_build`` with as many arguments (an unbound entry would
    take its pointers as 32-bit ints)."""
    import re

    from repro_torch import _build
    entries = {}
    for src in _build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            entries[m.group(1)] = len([a for a in m.group(2).split(",")
                                       if a.strip()])
    assert "ssd_scan_bwd_launch" in entries
    assert set(entries) == set(_build._SIGNATURES)
    for name, n in entries.items():
        assert len(_build._SIGNATURES[name]) == n, name
