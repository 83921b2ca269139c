"""The port's attention kernels and model layers against the JAX package,
on the CPU.

The wrappers of the two CUDA attention kernels run their plain PyTorch
versions on CPU tensors; these tests hold them against the Pallas kernels
in interpret mode (``repro.kernels.*.ops``, as ``tests/test_kernels.py``
runs them) at that file's tolerances: float32 atol = rtol = 3e-5, bf16
2e-2.  The layers are held against ``repro.models.layers`` in float32 at
atol 1e-5.  Inputs come from seeded numpy and are handed to both packages.
The kernels themselves run only on the card (``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.paged_attention.ops import \
    paged_decode_attention as jax_paged
from repro.models import layers as JL

from repro_torch.configs import ARCH_IDS, PAPER_CASES, get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.models import layers as TL

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

@pytest.fixture(autouse=True)
def _forward_only():
    """These tests compare forward values: they run without recording
    gradients (the port's parameters take gradients)."""
    with torch.no_grad():
        yield


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=3e-5, rtol=3e-5)


def _pair(a, name):
    """The same float32 numpy values as a JAX array and a torch tensor of
    dtype ``name`` (bf16 rounds identically in both)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,T,H,KV,hd", [
    (128, 128, 4, 4, 64),
    (256, 256, 4, 2, 64),     # GQA
    (128, 384, 2, 2, 128),    # cross-length (decode-window style)
    (130, 200, 2, 1, 64),     # ragged, MQA
    (130, 130, 4, 4, 80),     # zamba2-2.7b's head size
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas(S, T, H, KV, hd, dtype, causal):
    rng = np.random.default_rng(S * 7 + T + H + hd)
    B = 2
    qj, qt = _pair(rng.standard_normal((B, S, H, hd), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, T, KV, hd), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, T, KV, hd), np.float32), dtype)
    want = jax_flash(qj, kj, vj, causal=causal, block_q=64, block_k=64)
    got = flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_flash_softcap_matches_pallas():
    rng = np.random.default_rng(30)
    B, S, H, hd = 1, 128, 2, 64
    qj, qt = _pair(rng.standard_normal((B, S, H, hd), np.float32), "float32")
    kj, kt = _pair(rng.standard_normal((B, S, H, hd), np.float32), "float32")
    vj, vt = _pair(rng.standard_normal((B, S, H, hd), np.float32), "float32")
    want = jax_flash(qj, kj, vj, causal=True, softcap=30.0)
    got = flash_attention(qt, kt, vt, causal=True, softcap=30.0)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))


def test_flash_gqa_maps_head_to_group():
    """Query head h reads KV head h // G: with KV heads of distinct
    constant values, each output head is its group's value."""
    B, S, H, KV, hd = 1, 4, 8, 2, 16
    q = torch.zeros(B, S, H, hd)
    k = torch.zeros(B, S, KV, hd)
    v = torch.arange(KV, dtype=torch.float32).view(1, 1, KV, 1).expand(
        B, S, KV, hd).contiguous()
    out = flash_attention(q, k, v, causal=True)
    assert torch.equal(out[0, 0, :, 0], torch.tensor([0.] * 4 + [1.] * 4))


def test_flash_rejects_bad_shapes():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="S 8 > T 4"):
        flash_attention(q, torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,hd,ps,npg", [
    (2, 4, 4, 64, 16, 4),
    (3, 8, 2, 64, 32, 8),     # GQA
    (1, 4, 1, 128, 16, 16),   # MQA long
    (2, 4, 4, 80, 16, 6),     # zamba2-2.7b's head size
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_matches_pallas(B, H, KV, hd, ps, npg, dtype, softcap):
    rng = np.random.default_rng(B * 100 + H + hd + npg)
    pool = npg * B + 7
    qj, qt = _pair(rng.standard_normal((B, 1, H, hd), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((pool, ps, KV, hd), np.float32),
                   dtype)
    vj, vt = _pair(rng.standard_normal((pool, ps, KV, hd), np.float32),
                   dtype)
    bt = rng.integers(0, pool, (B, npg)).astype(np.int32)
    ln = rng.integers(1, npg * ps + 1, (B,)).astype(np.int32)
    want = jax_paged(qj, kj, vj, jnp.asarray(bt), jnp.asarray(ln),
                     softcap=softcap)
    got = paged_decode_attention(qt, kt, vt, torch.from_numpy(bt),
                                 torch.from_numpy(ln), softcap=softcap)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_paged_ignores_out_of_length_pages():
    """Pages past `length` do not affect the output, whatever the table
    holds there."""
    rng = np.random.default_rng(5)
    B, H, KV, hd, ps, pool = 1, 2, 2, 64, 16, 16
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd), np.float32))
    kp = torch.from_numpy(rng.standard_normal((pool, ps, KV, hd), np.float32))
    vp = torch.from_numpy(rng.standard_normal((pool, ps, KV, hd), np.float32))
    lengths = torch.tensor([2 * ps], dtype=torch.int32)
    o1 = paged_decode_attention(q, kp, vp, torch.tensor([[0, 1, 2, 3]],
                                                        dtype=torch.int32),
                                lengths)
    o2 = paged_decode_attention(q, kp, vp, torch.tensor([[0, 1, 9, 9]],
                                                        dtype=torch.int32),
                                lengths)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-6)
    want = jax_paged(jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()),
                     jnp.asarray(vp.numpy()), jnp.asarray([[0, 1, 9, 9]],
                                                          jnp.int32),
                     jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(o2.numpy(), np.asarray(want),
                               **_tol("float32"))


@pytest.mark.parametrize("pos", [0, 15, 16, 40, 63])
def test_paged_identity_table_is_dense_decode(pos):
    """The dense (B, max_len, KV, hd) cache viewed as a page pool, with
    ``decode_pages``' identity table and lengths pos + 1, computes the JAX
    decode attention: ``layers._sdpa`` with the mask kpos <= pos."""
    rng = np.random.default_rng(pos)
    B, max_len, H, KV, hd = 3, 64, 4, 2, 16
    q = rng.standard_normal((B, 1, H, hd), np.float32)
    kc = rng.standard_normal((B, max_len, KV, hd), np.float32)
    vc = rng.standard_normal((B, max_len, KV, hd), np.float32)
    mask = (jnp.arange(max_len)[None, :] <= pos)[:, None, None, None, :]
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), mask,
                    0.0)
    table, lengths = TL.decode_pages(B, max_len, pos, "cpu")
    pool = (B * max_len // TL.DECODE_PAGE, TL.DECODE_PAGE, KV, hd)
    got = paged_decode_attention(torch.from_numpy(q),
                                 torch.from_numpy(kc).view(pool),
                                 torch.from_numpy(vc).view(pool), table,
                                 lengths)
    np.testing.assert_allclose(got.reshape(B, 1, H * hd).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)


def test_paged_rejects_bad_inputs():
    q = torch.zeros(2, 1, 4, 16)
    pool = torch.zeros(8, 16, 2, 16)
    table = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, pool, pool, table.long(),
                               torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="do not match batch"):
        paged_decode_attention(q, pool, pool, table,
                               torch.ones(3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# head dims the card's kernels take
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", list(ARCH_IDS) + list(PAPER_CASES))
def test_config_head_dims_have_kernels(arch, smoke):
    """Every registered config with attention heads has a head dim, at its
    dtype (and in float32, the type of the card-vs-CPU cuts), that both
    attention kernels are built for: flash_attention by the design
    ``ops.DESIGNS`` names for the type (bf16 the wgmma kernel, float32 the
    three-piece mma kernel), paged_attention in either.  A kernel that
    drops an instantiation fails here, not on the card."""
    cfg = get_config(arch, smoke=smoke)
    if cfg.n_heads == 0:
        assert cfg.family == "ssm"          # no attention layer at all
        return
    for dt in {cfg.torch_dtype, torch.float32}:
        assert flash_ops.check_kernel_shape(cfg.hd, dt) == \
            flash_ops.DESIGNS[dt]
        paged_ops.check_kernel_shape(cfg.hd, dt)


def test_kernel_shape_checks_refuse_the_rest():
    with pytest.raises(ValueError, match="head_dim 96"):
        flash_ops.check_kernel_shape(96, torch.bfloat16)
    with pytest.raises(ValueError, match="float16"):
        flash_ops.check_kernel_shape(128, torch.float16)
    with pytest.raises(ValueError, match="head_dim 256"):
        paged_ops.check_kernel_shape(256, torch.float32)
    with pytest.raises(ValueError, match="float16"):
        paged_ops.check_kernel_shape(64, torch.float16)


# ---------------------------------------------------------------------------
# layers, float32, against repro.models.layers
# ---------------------------------------------------------------------------

CFG32 = dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                            dtype="float32")
JCFG32 = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True),
                             dtype="float32")


def _load(module, tree):
    module.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                            for k, v in tree.items()})
    return module


def test_rms_norm_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64), np.float32)
    scale = rng.standard_normal((64,), np.float32)
    want = JL.rms_norm(jnp.asarray(x), {"scale": jnp.asarray(scale)}, 1e-5)
    p = _load(TL.RMSNorm(64), {"scale": scale})
    got = TL.rms_norm(torch.from_numpy(x), p, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("positions", ["prefill", "decode"])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches(positions, theta):
    rng = np.random.default_rng(2)
    if positions == "prefill":
        pos = np.broadcast_to(np.arange(33, dtype=np.int32), (2, 33))
    else:
        pos = np.array([[7], [200]], np.int32)
    x = rng.standard_normal(pos.shape + (4, 32), np.float32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                        theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches(kind):
    cfg = dataclasses.replace(CFG32, mlp=kind)
    jcfg = dataclasses.replace(JCFG32, mlp=kind)
    p = JL.init_mlp(jax.random.PRNGKey(3), jcfg)
    if kind == "gelu":              # nonzero biases, so they are checked
        p = {k: v + 0.1 if k.startswith("b_") else v for k, v in p.items()}
    x = np.random.default_rng(3).standard_normal((2, 5, 64), np.float32)
    want = JL.mlp(p, jnp.asarray(x), jcfg)
    mod = _load(TL.MLP(cfg, torch.Generator().manual_seed(0)), p)
    got = TL.mlp(mod, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _attn_pair(seed=4):
    p = JL.init_attention(jax.random.PRNGKey(seed), JCFG32)
    p = {k: v + 0.05 if k.startswith("b") else v for k, v in p.items()}
    mod = _load(TL.Attention(CFG32, torch.Generator().manual_seed(0)), p)
    return p, mod


@pytest.mark.parametrize("S", [6, 16])
def test_attention_prefill_matches(S):
    p, mod = _attn_pair()
    x = np.random.default_rng(S).standard_normal((2, S, 64), np.float32)
    want, wcache = JL.attention(p, jnp.asarray(x), JCFG32, kv_cache={})
    got, gcache = TL.attention(mod, torch.from_numpy(x), CFG32, kv_cache={})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for key in ("k", "v"):
        np.testing.assert_allclose(gcache[key].numpy(),
                                   np.asarray(wcache[key]), atol=1e-5)


def test_attention_decode_matches():
    p, mod = _attn_pair(5)
    rng = np.random.default_rng(6)
    B, max_len, pos = 2, 32, 9
    kc = rng.standard_normal((B, max_len, 2, 16), np.float32)
    vc = rng.standard_normal((B, max_len, 2, 16), np.float32)
    x = rng.standard_normal((B, 1, 64), np.float32)
    positions = np.full((B, 1), pos, np.int32)
    want, wcache = JL.attention(
        p, jnp.asarray(x), JCFG32, positions=jnp.asarray(positions),
        kv_cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        pos=jnp.int32(pos))
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    got, gcache = TL.attention(mod, torch.from_numpy(x), CFG32,
                               positions=torch.from_numpy(positions),
                               kv_cache=cache, pos=pos)
    assert gcache is cache                      # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for key in ("k", "v"):
        np.testing.assert_allclose(gcache[key].numpy(),
                                   np.asarray(wcache[key]), atol=1e-5)


def test_embed_unembed_match():
    jcfg = dataclasses.replace(JCFG32, tie_embeddings=False)
    cfg = dataclasses.replace(CFG32, tie_embeddings=False)
    p = JL.init_embed(jax.random.PRNGKey(7), jcfg)
    mod = _load(TL.Embed(cfg, torch.Generator().manual_seed(0)), p)
    toks = np.array([[3, 0, 255], [17, 17, 1]], np.int32)
    x = JL.embed(p, jnp.asarray(toks))
    got = TL.embed(mod, torch.from_numpy(toks).long())
    assert np.array_equal(got.numpy(), np.asarray(x))
    np.testing.assert_allclose(TL.unembed(mod, got).numpy(),
                               np.asarray(JL.unembed(p, x)), atol=1e-5)
