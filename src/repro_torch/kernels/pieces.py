"""bf16 pieces of float32 operands: the arithmetic of the port's float32
tensor-core kernels, in plain PyTorch.

The float32 ``ssd_scan`` and ``flash_attention`` kernels keep float32's
accuracy on bf16 tensor cores: each float32 operand is split into bf16
pieces (``split3``: hi + mid + lo, exact in float32's normal range), and a
product sums the piece products that reach float32's rounding, on one
float32 accumulator, smallest first (:data:`ORDER`, the order of
``mma3.cuh``'s ``mma_k``).  The design tests model the kernels with these
functions (float32 matmuls of bf16-exact pieces); nothing on the port's
serving or simulator path calls them.
"""

from __future__ import annotations

import torch


def bf(t):
    """t rounded to bf16 and back: what a bf16 operand holds."""
    return t.to(torch.bfloat16).to(torch.float32)


def split(v):
    """Two bf16 pieces hi + lo of a float32 operand (v to ~2^-17)."""
    hi = bf(v)
    return hi, bf(v - hi)


def split3(v):
    """Three bf16 pieces hi + mid + lo of a float32 operand: each residual
    is exact in float32, so hi + mid + lo == v in float32's normal
    range."""
    hi = bf(v)
    r = v - hi
    mid = bf(r)
    return hi, mid, bf(r - mid)


def order(na: int, nb: int):
    """The piece pairs (i, j) of an ``na``-piece operand against an
    ``nb``-piece one that a product sums: i + j below the longer split's
    length (three against three: hi hi, hi mid, mid hi, hi lo, lo hi,
    mid mid; lo mid, mid lo and lo lo lie below float32's rounding),
    smallest first, as ``mma_k`` issues them: lo hi, hi lo, mid mid,
    mid hi, hi mid, hi hi."""
    k = max(na, nb) - 1
    return sorted(((i, j) for i in range(na) for j in range(nb)
                   if i + j <= k), key=lambda ij: (-sum(ij), ij[0] == ij[1],
                                                   -ij[0]))


def prod(a, b, acc=None, step=None):
    """The kernel's product of split operands ``a`` (pieces of (..., m, k))
    and ``b`` (pieces of (..., k, n)): ``a[i] @ b[j]`` over :func:`order`'s
    pairs added one by one to ``acc`` (zeros when None).  ``step``: the
    contraction is taken ``step`` columns at a time, every pair of one
    step before the next step's (an ``mma`` of depth ``step`` on one
    accumulator); None takes it whole, one matmul a pair."""
    pairs = order(len(a), len(b))
    k = a[0].shape[-1]
    step = step or k
    out = acc
    for k0 in range(0, k, step):
        cols = slice(k0, k0 + step)
        for i, j in pairs:
            term = a[i][..., cols] @ b[j][..., cols, :]
            out = term if out is None else out + term
    return out
