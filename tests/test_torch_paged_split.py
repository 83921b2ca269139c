"""The split mode of the port's paged decode attention, on the CPU: a
cache split over the model axis by head dim, each rank holding a d-value
slice of every head.  ``paged_decode_scores`` of every slice summed (the
ranks' all-reduce), then ``paged_decode_apply`` of each slice, the slices
concatenated, against the whole-head plain version
(``paged_attention_reference``, float32 atol = rtol = 1e-5, bf16 2e-2)
and the JAX package's oracle of its paged attention kernel
(``repro.kernels.paged_attention.ref``, which ``tests/test_kernels.py``
holds the Pallas kernel to; float32 3e-5, bf16 2e-2), at slices of 4-64
values (hd 64 and 128 over 2-16 ranks), GQA, softcap, random tables and
ragged lengths.  The wrappers run their plain versions on CPU
tensors; the kernels run only on the card (``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ref import \
    paged_attention_reference as jax_paged

from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_reference

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, H, KV, hd, page, n_pages, dtype):
    rng = np.random.default_rng(seed)
    pool = B * n_pages + 5

    def both(shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return jnp.asarray(a, DTYPES[dtype][0]), \
            torch.from_numpy(a).to(DTYPES[dtype][1])

    q, k, v = both((B, 1, H, hd)), both((pool, page, KV, hd)), \
        both((pool, page, KV, hd))
    table = rng.integers(0, pool, (B, n_pages)).astype(np.int32)
    lengths = rng.integers(1, n_pages * page + 1, (B,)).astype(np.int32)
    return q, k, v, table, lengths


def _split(q, k, v, table, lengths, ranks, softcap):
    """The ranks' two launches around the sum of their scores."""
    hd = q.shape[-1]
    d = hd // ranks
    parts = [slice(r * d, (r + 1) * d) for r in range(ranks)]
    scores = sum(ops.paged_decode_scores(
        q[..., s].contiguous(), k[..., s].contiguous(), table, lengths)
        for s in parts)
    outs = [ops.paged_decode_apply(scores, v[..., s].contiguous(), table,
                                   lengths, scale=1.0 / math.sqrt(hd),
                                   softcap=softcap) for s in parts]
    return torch.cat(outs, dim=-1)


CASES = [  # B, H, KV, hd, ranks (slice hd / ranks)
    (2, 16, 2, 128, 16),      # qwen2.5-3b on the production mesh: 8
    (3, 8, 2, 128, 32),       # 4
    (2, 4, 4, 64, 16),        # whisper-tiny's heads over 16: 4
    (2, 32, 8, 128, 8),       # granite-8b over 8: 16
    (1, 12, 4, 128, 4),       # G = 3: 32
    (2, 4, 1, 128, 2),        # MQA: 64
]


@pytest.mark.parametrize("B,H,KV,hd,ranks", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_split_mode_matches_whole_heads(B, H, KV, hd, ranks, dtype, softcap):
    (qj, qt), (kj, kt), (vj, vt), table, lengths = _inputs(
        B * 1000 + H + hd + ranks, B, H, KV, hd, 16, 6, dtype)
    bt, ln = torch.from_numpy(table), torch.from_numpy(lengths)
    got = _split(qt, kt, vt, bt, ln, ranks, softcap)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    whole = paged_attention_reference(
        qt.reshape(B, KV, H // KV, hd), kt, vt, bt, ln,
        softcap=softcap).reshape(qt.shape)
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), whole.float().numpy(),
                               **tol)
    want = jax_paged(qj.reshape(B, KV, H // KV, hd), kj, vj,
                     jnp.asarray(table), jnp.asarray(lengths),
                     softcap=softcap).reshape(B, 1, H, hd)
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **tol)


def test_scores_are_zero_past_each_length():
    (_, q), (_, k), _, table, lengths = _inputs(7, 2, 4, 2, 64, 16, 4,
                                               "float32")
    lengths[:] = (5, 33)
    s = ops.paged_decode_scores(q[..., :8].contiguous(),
                                k[..., :8].contiguous(),
                                torch.from_numpy(table),
                                torch.from_numpy(lengths))
    assert s.shape == (2, 4, 64) and s.dtype == torch.float32
    assert not s[0, :, 5:].any() and not s[1, :, 33:].any()
    assert s[0, :, :5].abs().min() > 0


def test_apply_never_reads_scores_past_each_length():
    """The kernel leaves the scores past a length unwritten, so the apply
    must not depend on them: NaN and infinities there change nothing."""
    (_, q), (_, k), (_, v), table, lengths = _inputs(
        11, 2, 4, 2, 64, 16, 4, "float32")
    lengths[:] = (5, 33)
    bt, ln = torch.from_numpy(table), torch.from_numpy(lengths)
    s = ops.paged_decode_scores(q, k, bt, ln)
    dirty = s.clone()
    dirty[0, :, 5:] = float("nan")
    dirty[1, :, 33::2] = float("inf")
    dirty[1, :, 34::2] = -float("inf")
    for softcap in (0.0, 30.0):
        want, got = (ops.paged_decode_apply(x, v, bt, ln, scale=0.125,
                                            softcap=softcap)
                     for x in (s, dirty))
        assert torch.isfinite(got).all()
        assert torch.equal(got, want)


def test_split_wrappers_reject_bad_inputs():
    (_, q), (_, k), _, table, lengths = _inputs(3, 2, 4, 2, 64, 16, 4,
                                               "float32")
    bt, ln = torch.from_numpy(table), torch.from_numpy(lengths)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_decode_scores(q, k, bt.long(), ln)
    with pytest.raises(ValueError, match="does not match"):
        ops.paged_decode_scores(q[..., :8], k, bt, ln)
    s = ops.paged_decode_scores(q, k, bt, ln)
    with pytest.raises(ValueError, match="float32"):
        ops.paged_decode_apply(s.double(), k, bt, ln, scale=1.0)
    with pytest.raises(ValueError, match="tokens"):
        ops.paged_decode_apply(s[..., :10], k, bt, ln, scale=1.0)
