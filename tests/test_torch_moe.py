"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe``, on the CPU.

The smoke grok-1-314b and phi3.5-moe-42b configs (4 experts, top-2), the
JAX weights carried across, seeded numpy inputs of unit scale (what the
block's RMS norm hands the MoE): ``moe_ffn``'s y and aux in float32 at
rtol = 1e-4 and atol = 1e-4 of y's scale, and in bf16 at atol = rtol =
2e-2 (the serving tests' tolerances), at capacity factor 1.25 and at 0.25,
where pairs are dropped.  The float32 atol follows y's scale because the
experts' weights are drawn at 1 / sqrt(E) (``_dense_init`` takes the
leading axis as the fan-in), so y reaches ~180 and both packages' float32
sums stray ~1e-4 from a float64 evaluation of the same routing; a second
test holds the port to within 2x the reference's own distance from it.
Then ``_capacity`` over a range of token counts; a token row of zeros,
whose uniform router probabilities tie, picking the lower experts as
``jax.lax.top_k`` does; and repeat runs bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as JM

from repro_torch.configs import get_config
from repro_torch.models import moe as TM

ARCHS = ["grok-1-314b", "phi3.5-moe-42b"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}

@pytest.fixture(autouse=True)
def _forward_only():
    """These tests compare forward values: they run without recording
    gradients (the port's parameters take gradients)."""
    with torch.no_grad():
        yield


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _setup(arch, dtype, cf=1.25, seed=0):
    """(jax cfg, port cfg, jax params, the port's MoE holding them)."""
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype,
                               capacity_factor=cf)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                              capacity_factor=cf)
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    mod = TM.MoE(cfg, torch.Generator().manual_seed(0), device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k == "wg" else cfg.torch_dtype)
        for k, v in jp.items()})
    return jcfg, cfg, jp, mod


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def _both(jcfg, cfg, jp, mod, x):
    jy, jaux = JM.moe_ffn(jp, jnp.asarray(x, jcfg.jdtype), jcfg)
    ty, taux = TM.moe_ffn(mod, torch.from_numpy(x).to(cfg.torch_dtype), cfg)
    return (jy, jaux), (ty, taux)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    tol = TOL[dtype]
    if dtype == "float32":
        tol = dict(rtol=1e-4,
                   atol=1e-4 * max(1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(got, want, **tol)


def _dropped(mod, cfg, x):
    """Pairs past their expert's capacity, as the port routes them."""
    xf = torch.from_numpy(x.reshape(-1, cfg.d_model)).to(cfg.torch_dtype)
    probs = torch.softmax(xf.float() @ mod.wg, dim=-1)
    _, e = TM._top_k(probs, cfg.top_k)
    counts = torch.bincount(e.reshape(-1), minlength=cfg.n_experts)
    C = TM._capacity(xf.shape[0], cfg)
    return int(torch.clamp(counts - C, min=0).sum())


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, dtype, cf):
    jcfg, cfg, jp, mod = _setup(arch, dtype, cf)
    x = _x(cfg, (2, 12), seed=len(arch) + int(cf * 4))
    (jy, jaux), (ty, taux) = _both(jcfg, cfg, jp, mod, x)
    assert ty.dtype == cfg.torch_dtype and ty.shape == x.shape
    assert taux.dtype == torch.float32 and taux.shape == ()
    _close(ty, jy, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL["float32"])
    assert cf > 1 or _dropped(mod, cfg, x) > 0


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_float32_error_against_float64(arch, cf):
    """Both packages' float32 y against the port's code run in float64 on
    the same routing (the router stays float32): the port within 2x the
    reference's distance."""
    jcfg, cfg, jp, mod = _setup(arch, "float32", cf)
    x = _x(cfg, (2, 12), seed=len(arch) + int(cf * 4))
    (jy, _), (ty, _) = _both(jcfg, cfg, jp, mod, x)

    class Wide:
        wg = mod.wg
        w_gate, w_up, w_down = (w.double() for w in (
            mod.w_gate, mod.w_up, mod.w_down))
    y64, _ = TM._dispatch_ffn(torch.from_numpy(x).reshape(-1, cfg.d_model)
                              .double(), Wide, cfg)
    y64 = y64.numpy().reshape(x.shape)
    port, ref = (float(np.abs(_np(y) - y64).max()) for y in (ty, jy))
    assert port <= 2 * ref + 1e-6, (port, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch):
    for cf in (0.25, 1.0, 1.25, 2.0):
        jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                                   capacity_factor=cf)
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  capacity_factor=cf)
        for T in list(range(1, 70)) + [255, 256, 1000, 4096, 32768]:
            assert TM._capacity(T, cfg) == JM._capacity(T, jcfg), (cf, T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_row_ties_pick_lower_experts(dtype):
    """A row of zeros has equal router logits: every expert ties, and the
    reference's top-k takes experts 0 and 1; so must the port, and y and
    aux must follow."""
    jcfg, cfg, jp, mod = _setup("phi3.5-moe-42b", dtype)
    x = _x(cfg, (1, 6), seed=3)
    x[0, 2] = 0.0
    x[0, 4] = 0.0
    (jy, jaux), (ty, taux) = _both(jcfg, cfg, jp, mod, x)
    _close(ty, jy, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL["float32"])
    probs = torch.full((2, cfg.n_experts), 1.0 / cfg.n_experts)
    _, e = TM._top_k(probs, cfg.top_k)
    assert e.tolist() == [[0, 1], [0, 1]]
    _, je = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.top_k)
    assert np.asarray(je).tolist() == e.tolist()
    # partial ties: the lower index of each tied pair first
    p = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.4, 0.1, 0.4, 0.1]])
    _, e = TM._top_k(p, 2)
    _, je = jax.lax.top_k(jnp.asarray(p.numpy()), 2)
    assert e.tolist() == np.asarray(je).tolist() == [[1, 2], [0, 2]]


def test_moe_ffn_repeats_bit_for_bit():
    _, cfg, _, mod = _setup("grok-1-314b", "bfloat16", 0.25)
    x = torch.from_numpy(_x(cfg, (3, 10), seed=9)).to(torch.bfloat16)
    y0, a0 = TM.moe_ffn(mod, x, cfg)
    for _ in range(3):
        y, a = TM.moe_ffn(mod, x, cfg)
        assert torch.equal(y, y0) and torch.equal(a, a0)
