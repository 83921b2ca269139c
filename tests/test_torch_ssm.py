"""The port's SSD scan and Mamba2/zamba2 serving path against the JAX
package, on the CPU.

``ops.ssd`` runs its plain version on CPU tensors; it is held to the Pallas
kernel in interpret mode on the grid of ``tests/test_kernels.py`` at that
file's tolerance (atol = rtol = 3e-4), and to ``ssd_reference`` for y and
the final state (ragged lengths, a nonzero initial state, g = 2, bf16).
The models carry the JAX parameters across with
``convert.model_params_from_jax``; prefill and three decode steps are
compared in float32 at atol = rtol = 1e-4 against the jitted reference
(what the JAX engine runs) and in bf16 at 2e-2 against the reference run
op by op (``jax.disable_jit``): under jit XLA keeps the bf16 intermediates
of fused elementwise chains in float32, so the jitted reference rounds
where the code does not say it does, and the difference grows with depth.
Then the engine's tokens and KV stats, the parameter round trip, the cache
layout and the import guard.  The CUDA kernel itself runs only on the card
(``chip_smoke.py``).
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.ssd_scan.ops import ssd as jax_ssd_kernel
from repro.kernels.ssd_scan.ref import segsum as jax_segsum
from repro.kernels.ssd_scan.ref import ssd_decode_step as jax_decode_ssd
from repro.kernels.ssd_scan.ref import ssd_reference as jax_ssd
from repro.models import decode_step as jax_decode
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models import mamba2 as JM
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig

import repro_torch
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import (segsum, ssd_decode_step,
                                              ssd_reference)
from repro_torch.models import (Transformer, decode_step, init_cache,
                                prefill)
from repro_torch.models import mamba2 as TM
from repro_torch.serving import Engine, Request, ServeConfig

ARCHS = ["mamba2-1.3b", "zamba2-2.7b"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

@pytest.fixture(autouse=True)
def _forward_only():
    """These tests compare forward values: they run without recording
    gradients (the port's parameters take gradients)."""
    with torch.no_grad():
        yield


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _ssd_inputs(seed, b, l, h, p, g, n, A_scale=0.5):
    """The distributions of tests/test_kernels.py's SSD tests."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, l, h, p)) * 0.5).astype(np.float32),
            (rng.random((b, l, h)) * 0.5 + 0.1).astype(np.float32),
            -(rng.random((h,)) * A_scale + 0.5).astype(np.float32),
            (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32))


def _both(arrays, dtype="float32"):
    """(jax arrays, torch tensors); x, B and C in ``dtype``, dt and A in
    float32, as the model hands them over."""
    jdt, tdt = DTYPES[dtype]
    x, dt, A, B, C = arrays
    return ((jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
             jnp.asarray(B, jdt), jnp.asarray(C, jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
             torch.from_numpy(A), torch.from_numpy(B).to(tdt),
             torch.from_numpy(C).to(tdt)))


def _pad(a, to):
    return np.concatenate(
        [a, np.zeros((a.shape[0], to - a.shape[1]) + a.shape[2:], a.dtype)],
        axis=1)


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l,h,p,g,n,chunk", [
    (64, 2, 16, 1, 16, 16),
    (128, 4, 32, 2, 32, 32),
    (256, 4, 64, 1, 64, 64),
])
def test_ssd_plain_matches_pallas(l, h, p, g, n, chunk):
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        _ssd_inputs(l + h + g, 2, l, h, p, g, n))
    want = jax_ssd_kernel(jx, jdt, jA, jB, jC, chunk=chunk)
    got, state = ssd(tx, tdt, tA, tB, tC, chunk)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert state.dtype == torch.float32 and state.shape == (2, h, p, n)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("case", ["ragged", "initial_state", "groups",
                                  "bf16", "one_token"])
def test_ssd_plain_matches_reference(case):
    """y and the final state against ssd_reference, with ragged lengths
    zero-padded on the JAX side as the JAX model pads them."""
    b, l, h, p, g, n, chunk = 2, 130, 4, 16, 1, 16, 64
    dtype = "bfloat16" if case == "bf16" else "float32"
    if case == "groups":
        h, g = 6, 2
    if case == "one_token":
        l = 1
    arrays = _ssd_inputs(7, b, l, h, p, g, n)
    init = None
    if case == "initial_state":
        init = (np.random.default_rng(8).standard_normal((b, h, p, n))
                * 0.5).astype(np.float32)
    L = -(-l // chunk) * chunk
    (jx, jdt, jA, jB, jC), _ = _both(
        [a if a.ndim < 3 else _pad(a, L) for a in arrays], dtype)
    _, (tx, tdt, tA, tB, tC) = _both(arrays, dtype)
    y_want, s_want = jax_ssd(jx, jdt, jA, jB, jC, chunk,
                             initial_state=None if init is None
                             else jnp.asarray(init))
    y, s = ssd(tx, tdt, tA, tB, tC, chunk,
               initial_state=None if init is None else torch.from_numpy(init))
    assert y.dtype == tx.dtype and y.shape == (b, l, h, p)
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(_np(y), _np(y_want)[:, :l], **tol)
    np.testing.assert_allclose(_np(s), _np(s_want), atol=3e-4, rtol=3e-4)


def test_ssd_reference_matches_jax_on_whole_chunks():
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        _ssd_inputs(11, 2, 128, 4, 16, 2, 16))
    yj, sj = jax_ssd(jx, jdt, jA, jB, jC, 32)
    yt, st = ssd_reference(tx, tdt, tA, tB, tC, 32)
    np.testing.assert_allclose(_np(yt), _np(yj), atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(_np(st), _np(sj), atol=3e-4, rtol=3e-4)
    x = np.random.default_rng(12).standard_normal((3, 9)).astype(np.float32)
    np.testing.assert_allclose(segsum(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_segsum(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_reference(tx[:, :100], tdt[:, :100], tA, tB[:, :100],
                      tC[:, :100], 32)


def test_ssd_chunk_invariance():
    """The chunked algorithm is exact: the chunk cannot change y."""
    _, (x, dt, A, B, C) = _both(_ssd_inputs(13, 1, 128, 2, 16, 1, 16, 1.0))
    y32, s32 = ssd(x, dt, A, B, C, 32)
    y64, s64 = ssd(x, dt, A, B, C, 64)
    np.testing.assert_allclose(y32.numpy(), y64.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(s32.numpy(), s64.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_ssd_decode_matches_prefill_and_jax():
    """Token-by-token decode reproduces the chunked prefill, and each step
    equals the JAX step."""
    arrays = _ssd_inputs(14, 1, 32, 2, 8, 1, 8, 1.0)
    (jx, jdt, jA, jB, jC), (x, dt, A, B, C) = _both(arrays)
    y_ref, s_ref = ssd(x, dt, A, B, C, 16)
    state, jstate = torch.zeros(1, 2, 8, 8), jnp.zeros((1, 2, 8, 8))
    ys = []
    for t in range(32):
        y_t, state = ssd_decode_step(state, x[:, t], dt[:, t], A, B[:, t],
                                     C[:, t])
        jy, jstate = jax_decode_ssd(jstate, jx[:, t], jdt[:, t], jA,
                                    jB[:, t], jC[:, t])
        np.testing.assert_allclose(y_t.numpy(), _np(jy), atol=1e-6,
                                   rtol=1e-5)
        ys.append(y_t)
    np.testing.assert_allclose(state.numpy(), _np(jstate), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_ref.numpy(),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(state.numpy(), s_ref.numpy(), atol=2e-4,
                               rtol=2e-4)


def test_ssd_wrapper_reads_strided_rows_and_rejects_bad_shapes():
    """B and C as column slices of one projection (the model's layout)
    give what contiguous copies give; mismatched shapes raise."""
    _, (x, dt, A, B, C) = _both(_ssd_inputs(15, 2, 40, 4, 16, 2, 16))
    bc = torch.cat([B.reshape(2, 40, 32), C.reshape(2, 40, 32)], dim=-1)
    Bv, Cv = bc[..., :32].reshape(2, 40, 2, 16), \
        bc[..., 32:].reshape(2, 40, 2, 16)
    assert not Bv.is_contiguous()
    y1, s1 = ssd(x, dt, A, Bv, Cv, 32)
    y2, s2 = ssd(x, dt, A, B, C, 32)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    with pytest.raises(ValueError, match="multiple of g"):
        ssd(x[:, :, :3], dt[:, :, :3], A[:3], B, C, 32)
    with pytest.raises(ValueError, match="initial_state"):
        ssd(x, dt, A, B, C, 32, initial_state=torch.zeros(2, 4, 16, 8))


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


def _carry(jparams, cfg):
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(model_params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams), cfg))
    return model


@functools.lru_cache(maxsize=None)
def _params(arch, dtype="float32"):
    """The JAX parameters (seed 0) of the smoke config and the port's model
    holding them, made once per module: neither is changed by a test."""
    jcfg, cfg = _configs(arch, dtype)
    jparams = jax.jit(jax_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jcfg)
    return jparams, _carry(jparams, cfg)


def test_mamba_block_prefill_and_decode_match_jax():
    jcfg, cfg = _configs("mamba2-1.3b")
    jparams, model = _params("mamba2-1.3b")
    pj = jax.tree.map(lambda a: a[1], jparams["blocks"])["mamba"]
    pt = model.blocks[1].mamba
    jblock = jax.jit(lambda p, x, cache, decode: JM.mamba_block(
        p, x, jcfg, cache=cache, pos=0 if decode else None),
        static_argnums=3)
    x = np.random.default_rng(3).standard_normal((2, 9, cfg.d_model)) \
        .astype(np.float32)
    # prefill without a cache (training), then with one
    yj, _ = jblock(pj, jnp.asarray(x), None, False)
    yt, none = TM.mamba_block(pt, torch.from_numpy(x), cfg)
    assert none is None
    np.testing.assert_allclose(yt.numpy(), _np(yj), **TOL["float32"])
    tc = TM.init_mamba_cache(cfg, 2)
    yj, jc = jblock(pj, jnp.asarray(x), JM.init_mamba_cache(jcfg, 2), False)
    yt, tc2 = TM.mamba_block(pt, torch.from_numpy(x), cfg, cache=tc)
    assert tc2 is tc                              # updated in place
    np.testing.assert_allclose(yt.numpy(), _np(yj), **TOL["float32"])
    for step in range(3):
        xt = np.random.default_rng(20 + step).standard_normal(
            (2, 1, cfg.d_model)).astype(np.float32)
        yj, jc = jblock(pj, jnp.asarray(xt), jc, True)
        yt, tc = TM.mamba_block(pt, torch.from_numpy(xt), cfg, cache=tc,
                                pos=9 + step)
        np.testing.assert_allclose(yt.numpy(), _np(yj), **TOL["float32"])
        for k in ("state", "conv_x", "conv_bc"):
            np.testing.assert_allclose(tc[k].numpy(), _np(jc[k]),
                                       **TOL["float32"])


def test_silu_rounds_like_jax_in_bf16():
    """jax.nn.silu in bf16 expands the sigmoid to 1 / (1 + exp(-x)) and
    rounds every step; the port's silu does the same, bit for bit."""
    from repro_torch.models.layers import silu
    x = (np.random.default_rng(4).standard_normal(20000) * 3).astype(
        np.float32)
    want = _np(jax.nn.silu(jnp.asarray(x, jnp.bfloat16)))
    got = silu(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(got), want)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _mamba_leaves(cache, arch):
    """{name: (layers..., B, ...)} of the Mamba caches."""
    return cache if arch.startswith("mamba2") else cache[0]


def _check_caches(got, want, arch, dtype):
    """float32: every element at 1e-4.  bf16: Mamba layers before the first
    shared attention block (every mamba2 layer, zamba2's first
    super-block) hold their conv windows exactly and their float32 states
    at 1e-4 (the same bf16 values, another summation order); later layers,
    and the shared block's K/V, within 2e-2 in norm, since the attention
    kernels round the softmax at another point than the JAX model does
    (tests/test_torch_serving.py holds the dense caches the same way)."""
    mg, mw = _mamba_leaves(got, arch), _mamba_leaves(want, arch)
    pairs = [(k, _np(mg[k]), _np(mw[k])) for k in ("state", "conv_x",
                                                   "conv_bc")]
    if not arch.startswith("mamba2"):
        pairs += [(k, _np(got[1]["kv"][k]), _np(want[1]["kv"][k]))
                  for k in ("k", "v")]
    for name, g, w in pairs:
        assert g.shape == w.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(g, w, err_msg=name, **TOL[dtype])
            continue
        for i in range(g.shape[0]):
            before_attn = arch.startswith("mamba2") or (
                i == 0 and name not in ("k", "v"))
            if before_attn and name == "state":
                np.testing.assert_allclose(g[i], w[i], atol=1e-4, rtol=1e-4,
                                           err_msg=name)
            elif before_attn:
                assert np.array_equal(g[i], w[i]), (name, i)
            else:
                rel = np.linalg.norm(g[i] - w[i]) / np.linalg.norm(w[i])
                assert rel < 2e-2, (name, i, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    jcfg, cfg = _configs(arch, dtype)
    jparams, model = _params(arch, dtype)
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (2, 7)) \
        .astype(np.int32)
    eager = lambda: jax.disable_jit(dtype == "bfloat16")   # noqa: E731
    with eager():
        jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                             max_len=32)
    tl, tc = prefill(model, {"tokens": torch.from_numpy(toks)}, cfg,
                     max_len=32)
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])
    _check_caches(tc, jc, arch, dtype)
    tok = np.argmax(_np(jl), -1)[:, None].astype(np.int32)
    for pos in range(7, 10):
        with eager():
            jl, jc = jax_decode(jparams, jnp.asarray(tok), jc,
                                jnp.int32(pos), jcfg)
        tl, tc = decode_step(model, torch.from_numpy(tok), tc, pos, cfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])
        _check_caches(tc, jc, arch, dtype)
        tok = np.argmax(_np(jl), -1)[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout_matches_jax(arch):
    jcfg, cfg = _configs(arch, "bfloat16")
    want = jax_init_cache(jcfg, 3, 32)
    got = init_cache(cfg, 3, 32, device="cpu")
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree_util.tree_leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in wl] == \
        [jax.tree_util.keystr(p) for p, _ in gl]
    for (_, w), (_, g) in zip(wl, gl):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_model_params_round_trip_exactly(arch):
    """Every leaf of the JAX tree reaches the port unchanged (bf16 handed
    over as float32 and back); A_log, D, dt_bias and the norm scales stay
    float32; every port parameter has a leaf."""
    jcfg, cfg = _configs(arch, "bfloat16")
    jparams, model = _params(arch, "bfloat16")    # strict: names match
    port = dict(model.named_parameters())
    n_super = cfg.n_layers // cfg.attn_every
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        keys = [p.key for p in path]
        leaf = np.asarray(leaf, np.float32)
        if keys[0] != "blocks":
            items = [(".".join(keys), leaf)]
        elif cfg.family == "ssm":
            items = [(".".join(["blocks", str(i)] + keys[1:]), leaf[i])
                     for i in range(cfg.n_layers)]
        else:
            items = [(".".join(["blocks", str(s), str(j)] + keys[1:]),
                      leaf[s, j]) for s in range(n_super)
                     for j in range(cfg.attn_every)]
        for name, want in items:
            got = port.pop(name)
            f32 = keys[-1] in ("scale", "A_log", "D", "dt_bias")
            assert got.dtype == (torch.float32 if f32 else torch.bfloat16), \
                name
            assert np.array_equal(got.detach().float().numpy(), want), name
            n += 1
    assert not port, sorted(port)
    assert n == sum(1 for _ in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(jparams))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid, rng.integers(1, vocab, size=int(rng.integers(4, 9)))
                .astype(np.int32), max_new=4) for rid in range(4)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(arch):
    """Ragged prompts, two batches, float32: the same generated tokens and
    KV stats as the JAX engine (whose manager is sized from the config as
    for any family)."""
    jcfg, cfg = _configs(arch)
    jparams, model = _params(arch)
    jeng = JEngine(jcfg, jparams, JServeConfig(max_batch=2, max_len=64))
    teng = Engine(cfg, model,
                  ServeConfig(max_batch=2, max_len=64), device="cpu")
    for jr, tr in zip(_requests(JRequest, cfg.vocab),
                      _requests(Request, cfg.vocab)):
        jeng.submit(jr)
        teng.submit(tr)
    want, got = jeng.run(), teng.run()
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        assert np.array_equal(got[rid], want[rid]), (rid, got[rid],
                                                     want[rid])
    assert teng.kv_stats == jeng.kv_stats
    assert teng.kv_stats["appends"] > 0
    cfg_mgr = teng.kv_mgr.cfg
    assert (cfg_mgr.n_layers, cfg_mgr.n_kv_heads, cfg_mgr.head_dim) == (
        cfg.n_layers, max(1, cfg.n_kv_heads), cfg.hd)


def test_serve_launcher_serves_ssm_archs_on_cpu(capsys):
    from repro_torch.launch import serve as serve_cli
    for arch in ARCHS:
        serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "2", "--max-new", "3"])
        out = capsys.readouterr().out.splitlines()
        assert [ln.split(":")[0] for ln in out[:2]] == ["req 0", "req 1"]
        assert out[2].startswith("kv stats:")


def test_ssm_serving_imports_and_runs_without_jax():
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "import numpy as np",
        "import repro_torch.models, repro_torch.serving",
        "from repro_torch.configs import get_config",
        "from repro_torch.serving import Engine, Request, ServeConfig",
        "for arch in ('mamba2-1.3b', 'zamba2-2.7b'):",
        "    cfg = get_config(arch, smoke=True)",
        "    model = repro_torch.models.init_params(0, cfg, device='cpu')",
        "    eng = Engine(cfg, model, ServeConfig(), device='cpu')",
        "    for rid in range(2):",
        "        eng.submit(Request(rid, np.arange(1, 6, dtype=np.int32),",
        "                           max_new=3))",
        "    outs = eng.run()",
        "    assert [len(v) for v in outs.values()] == [3, 3], outs",
        "bad = [m for m in sys.modules if m == 'repro' or",
        "       m.startswith(('repro.', 'jax.', 'jaxlib'))]",
        "assert not bad, bad",
        "print('ok', eng.kv_stats)",
    ])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_plain_kernels_reaches_the_mamba2_layer(arch,
                                                          monkeypatch):
    """``chip_smoke.plain_kernels`` (the card's runs of the plain versions)
    swaps names the models call: a prefill inside it runs the SSD scan's
    plain version through the Mamba2 layer, and every name is put back."""
    import chip_smoke

    from repro_torch.kernels.ssd_scan import ops, ref
    from repro_torch.models import layers
    calls, plain = [], ref.ssd_plain

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)
    monkeypatch.setattr(ref, "ssd_plain", spy)
    _, cfg = _configs(arch)
    _, model = _params(arch)
    names = (ops.ssd, layers.flash_attention, layers.paged_decode_attention)
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (2, 7))
    with chip_smoke.plain_kernels(torch), torch.no_grad():
        prefill(model, {"tokens": torch.from_numpy(toks)}, cfg, max_len=32)
    assert len(calls) == cfg.n_layers
    assert (ops.ssd, layers.flash_attention,
            layers.paged_decode_attention) == names
