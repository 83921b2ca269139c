"""Plain PyTorch version of the Mamba2 SSD (state-space dual) chunked scan.

The port of the JAX package's ``kernels/ssd_scan/ref.py``, in its layout:
    x  : (b, l, h, p)    inputs per head (p = head dim)
    dt : (b, l, h)       post-softplus step sizes
    A  : (h,)            negative scalars per head
    B  : (b, l, g, n)    input projections  (g groups, n = state dim)
    C  : (b, l, g, n)    output projections
Quadratic attention-like products inside a chunk of ``chunk`` positions, a
linear recurrence carrying (b, h, p, n) float32 states across chunks.  The
tests hold it to the JAX oracle, the model runs it on the CPU, and
``chip_smoke.py`` holds the CUDA kernel (``ops.ssd``) to :func:`ssd_plain`
on the card; likewise the backward kernel (``ops.ssd_backward``) to
:func:`ssd_plain_backward`, autograd through :func:`ssd_plain`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def segsum(x):
    """x: (..., T) -> (..., T, T) with out[i, j] = sum_{l=j+1..i} x_l (i>=j),
    -inf above the diagonal (so exp() gives the causal decay matrix)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def _to_heads(bc, h: int):
    """(b, l, g, n) -> (b, l, h, n) by repeating groups."""
    return bc.repeat_interleave(h // bc.shape[2], dim=2)


def ssd_reference(x, dt, A, B, C, chunk: int,
                  initial_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (b, l, h, p) in x's dtype, final_state: (b, h, p, n)
    float32).  ``l`` must be a multiple of ``chunk``."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"ssd_reference: length {l} is not a multiple of "
                         f"the chunk {chunk}")
    nc, cs = l // chunk, chunk
    f32 = torch.float32
    Bh = _to_heads(B, h).to(f32)
    Ch = _to_heads(C, h).to(f32)
    dt = dt.to(f32)
    xdt = x.to(f32) * dt[..., None]

    xc = xdt.reshape(b, nc, cs, h, p)
    dtA = (dt * A.to(f32)).reshape(b, nc, cs, h)
    Bc = Bh.reshape(b, nc, cs, h, n)
    Cc = Ch.reshape(b, nc, cs, h, n)

    # intra-chunk (diagonal block) output
    L = torch.exp(segsum(dtA.movedim(-1, -2)))             # (b, nc, h, cs, cs)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores * L, xc)

    # per-chunk terminal states
    cum = torch.cumsum(dtA, dim=2)                         # (b, nc, cs, h)
    total = cum[:, :, -1:, :]
    decay_to_end = torch.exp(total - cum)
    states = torch.einsum("bckhn,bckh,bckhp->bchpn", Bc, decay_to_end, xc)

    # inter-chunk recurrence
    chunk_decay = torch.exp(total[:, :, 0, :])             # (b, nc, h)
    s = torch.zeros(b, h, p, n, dtype=f32, device=x.device) \
        if initial_state is None else initial_state.to(f32)
    entering = []
    for c in range(nc):
        entering.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)                # (b, nc, h, p, n)

    # inter-chunk (off-diagonal) contribution
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cc, entering,
                         torch.exp(cum))
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y.to(x.dtype), s


def ssd_plain(x, dt, A, B, C, chunk: int,
              initial_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``ops.ssd`` computes, for any length: positions past ``l`` up to
    the next chunk boundary are zero (``dt = 0``, ``x = 0``), as the JAX
    model pads them, so they neither decay nor feed the state."""
    l = x.shape[1]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    y, state = ssd_reference(x, dt, A, B, C, chunk,
                             initial_state=initial_state)
    return y[:, :l], state


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """Single-token recurrence.

    state: (b, h, p, n); x_t: (b, h, p); dt_t: (b, h); B_t/C_t: (b, g, n).
    Returns (y_t: (b, h, p) in x_t's dtype, new_state float32).
    """
    h = state.shape[1]
    f32 = torch.float32
    Bh = _to_heads(B_t[:, None], h)[:, 0].to(f32)          # (b, h, n)
    Ch = _to_heads(C_t[:, None], h)[:, 0].to(f32)
    dt_t = dt_t.to(f32)
    dA = torch.exp(dt_t * A.to(f32))                       # (b, h)
    upd = (dt_t[..., None] * x_t.to(f32))[..., None] * Bh[:, :, None, :]
    state = state.to(f32) * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(x_t.dtype), state


def ssd_plain_backward(x, dt, A, B, C, chunk: int,
                       initial_state: Optional[torch.Tensor], dy,
                       dstate: Optional[torch.Tensor] = None):
    """The gradients of :func:`ssd_plain` at (x, dt, A, B, C,
    initial_state) for the output gradients ``dy`` (of y) and ``dstate``
    (of the final state; None: zero), by autograd through it: (dx, ddt,
    dA, dB, dC, dinit), each in its input's type (``dinit`` None without
    an initial state)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, A, B, C)]
        init = None if initial_state is None else \
            initial_state.detach().requires_grad_()
        y, state = ssd_plain(*ins, chunk, initial_state=init)
        outs, grads = [y], [dy]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate)
        wrt = ins + ([] if init is None else [init])
        got = torch.autograd.grad(outs, wrt, grads, allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g for t, g in zip(wrt, got)]
    return (*got[:5], got[5] if init is not None else None)
