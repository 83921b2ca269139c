"""The port's moe, encdec and vlm serving paths against the JAX package, on
the CPU.

The smoke grok-1-314b and phi3.5-moe-42b (moe), whisper-tiny (encdec:
encoder over 16 frames, cross-attention) and pixtral-12b (vlm: vision
tower over 8 patches, projector), with the JAX parameters carried across
by ``convert.model_params_from_jax``: ``prefill`` logits and cache (the
encdec's ``cross`` leaves included) and three ``decode_step``s on seeded
random tokens, frames and patches, in float32 at atol = rtol = 1e-4 and in
bf16 at 2e-2 (the tolerances of ``tests/test_torch_serving.py``, whose
``_check_cache`` rule the caches follow: float32 elementwise, bf16 each
layer within 2e-2 in norm); ``train_logits`` and its aux; the
``init_cache`` layouts; the exact parameter round trip; ``Engine.run``'s
tokens and KV stats against the JAX engine in float32 (zero frames and
patches, as both engines pass them); the launcher on the CPU; and serving
with JAX blocked from import.  The attention kernels' plain versions run
here; the kernels themselves run on the card (``chip_smoke.py --only
families``).
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
from repro.models import decode_step as jax_decode
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models import train_logits as jax_train_logits
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig

import repro_torch
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.models import (Transformer, decode_step, init_cache,
                                prefill, train_logits)
from repro_torch.serving import Engine, Request, ServeConfig

ARCHS = ["grok-1-314b", "phi3.5-moe-42b", "whisper-tiny", "pixtral-12b"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
STACKS = ("blocks", "enc_blocks", "vision_blocks")

@pytest.fixture(autouse=True)
def _forward_only():
    """These tests compare forward values: they run without recording
    gradients (the port's parameters take gradients)."""
    with torch.no_grad():
        yield


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype="float32"):
    """The JAX parameters (seed 0) of the smoke config and the port's model
    holding them, made once per module: neither is changed by a test."""
    jcfg, cfg = _configs(arch, dtype)
    jparams = jax.jit(jax_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jcfg)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(model_params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams), cfg))
    return jparams, model


def _batch(cfg, toks, seed):
    """Tokens and, per family, seeded random frames or patches: (jax
    batch, port batch)."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": toks}
    B = toks.shape[0]
    if cfg.family == "encdec":
        arrays["enc_frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.frontend_dim or cfg.d_model)).astype(
                np.float32)
    if cfg.family == "vlm":
        arrays["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.vision_d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _check_cache(got, want, dtype):
    """float32: every element at 1e-4.  bf16: every layer of every leaf
    within 2e-2 in norm (as tests/test_torch_serving.py holds the dense
    caches: elementwise, a deeper bf16 layer has a few elements past
    2e-2)."""
    assert sorted(got) == sorted(want)
    for part in got:
        for key in ("k", "v"):
            g, w = _np(got[part][key]), _np(want[part][key])
            assert g.shape == w.shape, (part, key)
            if dtype == "float32":
                np.testing.assert_allclose(g, w, err_msg=f"{part}.{key}",
                                           **TOL[dtype])
                continue
            for layer in range(g.shape[0]):
                norm = np.linalg.norm(w[layer])
                rel = np.linalg.norm(g[layer] - w[layer]) / norm \
                    if norm else np.linalg.norm(g[layer])
                assert rel < 2e-2, (part, key, layer, rel)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    jcfg, cfg = _configs(arch, dtype)
    jparams, model = _params(arch, dtype)
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (2, 7)) \
        .astype(np.int32)
    jb, tb = _batch(cfg, toks, seed=1)
    jl, jc = jax_prefill(jparams, jb, jcfg, max_len=32)
    tl, tc = prefill(model, tb, cfg, max_len=32)
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])
    _check_cache(tc, jc, dtype)
    if cfg.family == "encdec":
        assert tc["cross"]["k"].shape == (cfg.n_layers, 2, cfg.enc_seq,
                                          cfg.n_kv_heads, cfg.hd)
    # feed the reference's greedy tokens to both, step by step; the vlm's
    # text follows its image positions
    start = 7 + (cfg.n_patches if cfg.family == "vlm" else 0)
    tok = np.argmax(_np(jl), -1)[:, None].astype(np.int32)
    for pos in range(start, start + 3):
        jl, jc = jax_decode(jparams, jnp.asarray(tok), jc, jnp.int32(pos),
                            jcfg)
        tl, tc = decode_step(model, torch.from_numpy(tok), tc, pos, cfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])
        _check_cache(tc, jc, dtype)
        tok = np.argmax(_np(jl), -1)[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_and_aux_match_jax(arch):
    jcfg, cfg = _configs(arch)
    jparams, model = _params(arch)
    toks = np.random.default_rng(2).integers(1, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    jb, tb = _batch(cfg, toks, seed=3)
    jl, jaux = jax_train_logits(jparams, jb, jcfg)
    tl, aux = train_logits(model, tb, cfg)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL["float32"])
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(jaux), **TOL["float32"])
    # a positive load-balance term per MoE layer; 0 for the others
    assert (float(aux) > 0) == (cfg.family == "moe")


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
    over as float32 and back); the norm scales and the MoE router ``wg``
    stay float32; each stack (``blocks``, ``enc_blocks``,
    ``vision_blocks``) splits along its layer axis; every port parameter
    has a leaf."""
    jcfg, cfg = _configs(arch, "bfloat16")
    jparams, model = _params(arch, "bfloat16")    # strict: names match
    port = dict(model.named_parameters())
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        keys = [p.key for p in path]
        leaf = np.asarray(leaf, np.float32)
        items = [(".".join(keys), leaf)] if keys[0] not in STACKS else \
            [(".".join([keys[0], str(i)] + keys[1:]), leaf[i])
             for i in range(leaf.shape[0])]
        for name, want in items:
            got = port.pop(name)
            f32 = keys[-1] in ("scale", "wg")
            assert got.dtype == (torch.float32 if f32 else torch.bfloat16), \
                name
            assert np.array_equal(got.detach().float().numpy(), want), name
            n += 1
    assert not port, sorted(port)
    assert n == sum(1 for _ in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(jparams))


def test_init_params_draws_every_family_on_its_device():
    """Seeded draws, the families' modules and the dtypes of their
    leaves."""
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        a = repro_torch.models.init_params(0, cfg, device="cpu")
        b = repro_torch.models.init_params(torch.Generator().manual_seed(0),
                                           cfg, device="cpu")
        for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                      b.named_parameters()):
            assert na == nb and torch.equal(pa, pb)
        blk = a.blocks[0]
        if cfg.family == "moe":
            assert blk.moe.wg.dtype == torch.float32
            assert blk.moe.w_gate.shape == (cfg.n_experts, cfg.d_model,
                                            cfg.d_ff)
            assert not hasattr(blk, "mlp")
        if cfg.family == "encdec":
            assert blk.cross.wq.shape == (cfg.d_model, cfg.d_model)
            assert len(a.enc_blocks) == cfg.n_enc_layers
        if cfg.family == "vlm":
            v = a.vision_blocks[0]
            assert v.attn.wq.shape == (cfg.vision_d_model,
                                       cfg.vision_d_model)
            assert v.attn.bq is None
            assert a.projector.shape == (cfg.vision_d_model, cfg.d_model)


# ---------------------------------------------------------------------------
# the engine and the launcher
# ---------------------------------------------------------------------------

def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid, rng.integers(1, vocab, size=int(rng.integers(4, 9)))
                .astype(np.int32), max_new=4) for rid in range(4)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(arch):
    """Ragged prompts, two batches, float32: the same generated tokens and
    KV stats as the JAX engine (the vlm's slots also count the image
    positions)."""
    jcfg, cfg = _configs(arch)
    jparams, model = _params(arch)
    jeng = JEngine(jcfg, jparams, JServeConfig(max_batch=2, max_len=64))
    teng = Engine(cfg, model, ServeConfig(max_batch=2, max_len=64),
                  device="cpu")
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
    prompts = sum(len(r.prompt) for r in _requests(Request, cfg.vocab))
    assert teng.kv_stats["appends"] >= prompts + (
        4 * cfg.n_patches if cfg.family == "vlm" else 0)


def test_serve_launcher_serves_every_new_family_on_cpu(capsys):
    for arch in ARCHS:
        serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "2", "--max-new", "3"])
        out = capsys.readouterr().out.splitlines()
        assert [ln.split(":")[0] for ln in out[:2]] == ["req 0", "req 1"]
        assert all(len(ln.split("[")[1].split(",")) == 3 for ln in out[:2])
        assert out[2].startswith("kv stats:")


def test_families_serve_without_jax():
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "import numpy as np",
        "import repro_torch.models, repro_torch.serving",
        "from repro_torch.configs import get_config",
        "from repro_torch.serving import Engine, Request, ServeConfig",
        "for arch in ('phi3.5-moe-42b', 'whisper-tiny', 'pixtral-12b'):",
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
def test_chip_smoke_path_launches_count_the_attention_calls(arch,
                                                           monkeypatch):
    """``chip_smoke.path_launches`` (what the card's launch counts are held
    to) equals the attention calls one prefill and one decode step make:
    the encoders' and the cross-attention's flash calls included."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.models import layers
    calls = {"flash_attention": 0, "paged_attention": 0}

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run
    monkeypatch.setattr(layers, "flash_attention",
                        counted("flash_attention", layers.flash_attention))
    monkeypatch.setattr(layers, "paged_decode_attention",
                        counted("paged_attention",
                                layers.paged_decode_attention))
    cfg = get_config(arch, smoke=True)
    _, model = _params(arch, "bfloat16")
    per_prefill, per_decode = chip_smoke.path_launches(cfg)
    toks = torch.randint(1, cfg.vocab, (2, 5), dtype=torch.int32)
    inputs = chip_smoke.stub_inputs(torch, cfg, 2, seed=1)
    logits, cache = prefill(model, {"tokens": toks, **inputs}, cfg,
                            max_len=32)
    assert calls == {k: per_prefill.get(k, 0) for k in calls}
    calls.update(dict.fromkeys(calls, 0))
    decode_step(model, logits.argmax(-1, keepdim=True).to(torch.int32),
                cache, 5 + chip_smoke.image_positions(cfg), cfg)
    assert calls == {k: per_decode.get(k, 0) for k in calls}
