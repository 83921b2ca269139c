"""The design of the float32 ``flash_attention`` kernel, checked on the CPU.

``csrc/flash_attention_mma3.cu`` (``flash_mma3_kernel``) runs float32
attention on the bf16 tensor cores (``mma.sync`` m16n8k16, float32
accumulators) and keeps float32's accuracy: Q, K, V and the probabilities
P are split into three bf16 pieces hi + mid + lo
(``repro_torch.kernels.pieces``), and each product sums the six piece
products that reach float32's rounding, smallest first, one k16 step
after another on one accumulator.

:func:`flash_mma3_model` does what the kernel does, in its order, in plain
PyTorch: 64-key blocks; the scores as the sum of piece products of split Q
and K, k16 step by k16 step; the scale after the product, then softcap,
then the mask to -1e30 (as the Pallas ``_flash_kernel``); the float32
online max and sum per block; P split and P·V summed onto the rescaled
accumulator; ``acc / max(l, 1e-30)``.  It is held to the JAX
``flash_attention_bhsd`` (Pallas, interpret mode, as
``tests/test_torch_attention.py`` runs it) at that file's float32
tolerance, to the plain version at the card's ``ATTN_TOL`` (1e-4), and to
a float64 attention on the same inputs, from which it must lie no farther
than 4x the plain float32 version does.  Two pieces and three products
miss that ratio, so the kernel takes three pieces and six.  The kernel
itself runs only on the card (``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels import pieces
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref

BLOCK_K = 64              # keys a block (the kernel's K/V tile)
STEP = 16                 # the depth of an m16n8k16 product
JAX_TOL = 3e-5            # tests/test_torch_attention.py, float32
CARD_TOL = 1e-4           # chip_smoke.ATTN_TOL["float32"]
# how much farther from a float64 attention than the plain float32 version
# the model may lie
ORACLE_RATIO = 4


def _t(ps):
    return [p.transpose(-1, -2) for p in ps]


def flash_mma3_model(q, k, v, causal=True, softcap=0.0, block_k=BLOCK_K,
                     split=pieces.split3):
    """What ``flash_mma3_kernel`` computes, in plain PyTorch: q (B, S, H,
    hd), k/v (B, T, KV, hd) float32 -> (B, S, H, hd) float32.  Query head
    h reads KV head h // (H // KV); queries sit at the end of the key
    timeline (offset T - S).  ``split`` cuts every operand of both
    products into bf16 pieces (the kernel's: hi + mid + lo)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qh = q.float().transpose(1, 2)                        # (B, H, S, hd)
    kh = k.float().repeat_interleave(G, 2).transpose(1, 2)
    vh = v.float().repeat_interleave(G, 2).transpose(1, 2)
    qp = split(qh)                                        # once, as the CTA
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, hd)
    qpos = torch.arange(S)[:, None] + (T - S)
    for k0 in range(0, T, block_k):
        # the tile: keys past T zero-filled, as the copies fill them
        n = min(block_k, T - k0)
        kb = kh.new_zeros(B, H, block_k, hd)
        vb = kh.new_zeros(B, H, block_k, hd)
        kb[:, :, :n], vb[:, :, :n] = kh[:, :, k0:k0 + n], vh[:, :, k0:k0 + n]
        s = pieces.prod(qp, _t(split(kb)), step=STEP) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        kpos = torch.arange(k0, k0 + block_k)[None, :]
        live = kpos < T
        if causal:
            live = live & (kpos <= qpos)
        s = torch.where(live, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = pieces.prod(split(p), split(vb), acc=acc * corr, step=STEP)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).transpose(1, 2).contiguous()


def oracle64(q, k, v, causal=True, softcap=0.0):
    """Attention in float64 on the same (float32) inputs."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qh = q.double().transpose(1, 2)
    kh = k.double().repeat_interleave(G, 2).transpose(1, 2)
    vh = v.double().repeat_interleave(G, 2).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        hide = torch.arange(T)[None, :] > torch.arange(S)[:, None] + (T - S)
        s = s.masked_fill(hide, -math.inf)
    return (torch.softmax(s, -1) @ vh).transpose(1, 2)


def _dist(a, oracle):
    return float((a.double() - oracle).abs().max())


# (B, S, T, H, KV, hd, causal, softcap): qwen2.5-3b's head dim with a
# KV group of 8 (its float32 cut has 16 over 2), zamba2-2.7b's hd 80 at
# 1:1, the other head dims the kernel takes, and chip_smoke's flash cases
# at sizes the CPU takes
CASES = {
    "hd128_gqa_8": (1, 192, 192, 8, 1, 128, True, 0.0),
    "hd80": (2, 130, 130, 2, 2, 80, True, 0.0),
    "hd16": (2, 128, 128, 4, 2, 16, True, 0.0),
    "hd32": (2, 128, 128, 4, 2, 32, True, 0.0),
    "hd64": (2, 128, 128, 4, 2, 64, True, 0.0),
    "ragged_130_200": (2, 130, 200, 2, 1, 64, True, 0.0),
    "non_causal": (1, 192, 192, 4, 2, 128, False, 0.0),
    "softcap_30": (1, 192, 192, 4, 2, 128, True, 30.0),
    "right_aligned_512_1024": (1, 512, 1024, 2, 1, 32, True, 0.0),
    "s11": (2, 11, 11, 4, 2, 128, True, 0.0),
}


def _inputs(case, seed=20):
    """chip_smoke.flash_checks's inputs (standard normal), from numpy."""
    B, S, T, H, KV, hd, causal, cap = CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, n, h, hd))
                                .astype(np.float32))
               for n, h in ((S, H), (T, KV), (T, KV)))
    return q, k, v, causal, cap


@pytest.mark.parametrize("case", list(CASES))
def test_mma3_model_matches_jax(case):
    """The model against the JAX ``flash_attention`` (Pallas, interpret
    mode, 64-query and 64-key blocks) at the CPU tests' float32
    tolerance."""
    q, k, v, causal, cap = _inputs(case)
    got = flash_mma3_model(q, k, v, causal, cap)
    want = jax_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                     causal=causal, softcap=cap, block_q=64, block_k=64)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAX_TOL,
                               rtol=JAX_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_mma3_model_is_as_close_to_float64_as_the_plain_version(case):
    """Six products keep float32's accuracy: the model lies within the
    card's 1e-4 of the plain version and within 4x the plain version's
    distance from a float64 attention."""
    q, k, v, causal, cap = _inputs(case)
    got = flash_mma3_model(q, k, v, causal, cap)
    plain = ref.flash_attention_reference(q, k, v, causal=causal,
                                          softcap=cap)
    exact = oracle64(q, k, v, causal, cap)
    torch.testing.assert_close(got, plain, atol=CARD_TOL, rtol=CARD_TOL)
    assert _dist(got, exact) <= ORACLE_RATIO * _dist(plain, exact)


@pytest.mark.parametrize("case", list(CASES))
def test_two_pieces_and_three_products_miss_float32(case):
    """Why three pieces and six products: hi + lo pieces and their three
    products (lo hi, hi lo, hi hi) put the output beyond 4x the plain
    version's distance from float64."""
    q, k, v, causal, cap = _inputs(case)
    got = flash_mma3_model(q, k, v, causal, cap, split=pieces.split)
    plain = ref.flash_attention_reference(q, k, v, causal=causal,
                                          softcap=cap)
    exact = oracle64(q, k, v, causal, cap)
    assert _dist(got, exact) > ORACLE_RATIO * _dist(plain, exact)


def test_product_order_is_the_kernels():
    """``mma_k``'s order in ``mma3.cuh``: lo hi, hi lo, mid mid, mid hi,
    hi mid, hi hi (pieces 0 hi, 1 mid, 2 lo)."""
    assert pieces.order(3, 3) == [(2, 0), (0, 2), (1, 1), (1, 0), (0, 1),
                                  (0, 0)]
    assert pieces.order(2, 2) == [(1, 0), (0, 1), (0, 0)]


def test_stepped_product_sums_every_piece_pair():
    """``prod`` in k16 steps sums the same terms as one matmul a pair: on
    bf16-exact integers (every partial sum exact) the two agree bit for
    bit, and equal the float64 product of the pieces' sums."""
    rng = np.random.default_rng(21)
    a = [torch.from_numpy(rng.integers(-8, 9, (3, 48)).astype(np.float32))
         for _ in range(3)]
    b = [torch.from_numpy(rng.integers(-8, 9, (48, 5)).astype(np.float32))
         for _ in range(3)]
    whole = pieces.prod(a, b)
    assert torch.equal(pieces.prod(a, b, step=STEP), whole)
    want = sum(a[i].double() @ b[j].double() for i, j in pieces.order(3, 3))
    assert torch.equal(whole.double(), want)


def test_float32_runs_the_mma3_design():
    """The wrapper names one design per type; float32 is this model's, at
    every head dim the kernel is built for, and its occupancy query
    refuses any other before it reaches the card."""
    assert ops.DESIGNS[torch.float32] == "mma3"
    for hd in ops.HEAD_DIMS:
        assert ops.check_kernel_shape(hd, torch.float32) == "mma3"
    with pytest.raises(ValueError, match="head_dim 96"):
        ops.blocks_per_sm(96)


if __name__ == "__main__":
    # the distances behind the ratio tests, case by case:
    # PYTHONPATH=src python tests/test_torch_flash_design.py
    for name in CASES:
        q, k, v, causal, cap = _inputs(name)
        exact = oracle64(q, k, v, causal, cap)
        plain = _dist(ref.flash_attention_reference(
            q, k, v, causal=causal, softcap=cap), exact)
        three = _dist(flash_mma3_model(q, k, v, causal, cap), exact)
        two = _dist(flash_mma3_model(q, k, v, causal, cap,
                                     split=pieces.split), exact)
        print(f"{name}: plain {plain:.3e}, three pieces {three:.3e} "
              f"({three / plain:.2f}x), two pieces {two:.3e} "
              f"({two / plain:.2f}x)")
