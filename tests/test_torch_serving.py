"""The port's dense serving path against the JAX package, on the CPU.

The smoke qwen2.5-3b (2 layers, d 64, 4 heads over 2 KV heads) with the
JAX parameters carried across by ``convert.model_params_from_jax``:
``prefill`` logits and cache and three ``decode_step``s, in float32 at
atol = rtol = 1e-4 and in bf16 at atol = rtol = 2e-2 (the tolerance of
``tests/test_models_smoke.py``; JAX's decode softmax casts the normalized
weights to bf16, the kernels the unnormalized p).  Then the engine's
tokens and KV stats, the paged KV manager's state, the launcher, the
config registry and the import guard.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, PAPER_CASES
from repro.configs import get_config as jax_config
from repro.memtier import PagedKVConfig as JPagedKVConfig
from repro.memtier import PagedKVManager as JPagedKVManager
from repro.models import decode_step as jax_decode
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig

import repro_torch
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.memtier import PagedKVConfig, PagedKVManager
from repro_torch.models import (Transformer, decode_step, init_cache,
                                init_params, prefill, train_logits)
from repro_torch.serving import Engine, Request, ServeConfig

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}

@pytest.fixture(autouse=True)
def _forward_only():
    """These tests compare forward values: they run without recording
    gradients (the port's parameters take gradients)."""
    with torch.no_grad():
        yield


def _configs(dtype):
    return (dataclasses.replace(jax_config("qwen2.5-3b", smoke=True),
                                dtype=dtype),
            dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                                dtype=dtype))


def _carry(jparams, cfg):
    """The port's model holding the JAX parameters."""
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(model_params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams), cfg))
    return model


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _check_cache(got, want, dtype):
    """float32: every element at 1e-4.  bf16: layer 0, whose K/V come from
    the embeddings through ops that round alike in both packages, exactly;
    every layer within 2e-2 in norm.  Elementwise, a deeper bf16 layer has
    a few elements in 4096 past 2e-2: the two packages' exp and sigmoid
    differ in the last float32 bit, an occasional bf16 rounding flips, and
    the flip carries through the next layer's cancellations."""
    for key in ("k", "v"):
        g, w = _f32(got["kv"][key]), _f32(want["kv"][key])
        assert g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **TOL[dtype])
            continue
        assert np.array_equal(g[0], w[0]), key
        for layer in range(g.shape[0]):
            rel = np.linalg.norm(g[layer] - w[layer]) / np.linalg.norm(
                w[layer])
            assert rel < 2e-2, (key, layer, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    jcfg, cfg = _configs(dtype)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    model = _carry(jparams, cfg)
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (2, 7)) \
        .astype(np.int32)
    jl, jc = jax_prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                         max_len=32)
    tl, tc = prefill(model, {"tokens": torch.from_numpy(toks)}, cfg,
                     max_len=32)
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[dtype])
    _check_cache(tc, jc, dtype)
    # feed the reference's greedy tokens to both, step by step
    tok = np.argmax(_f32(jl), -1)[:, None].astype(np.int32)
    for pos in range(7, 10):
        jl, jc = jax_decode(jparams, jnp.asarray(tok), jc, jnp.int32(pos),
                            jcfg)
        tl, tc = decode_step(model, torch.from_numpy(tok), tc, pos, cfg)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[dtype])
        _check_cache(tc, jc, dtype)
        tok = np.argmax(_f32(jl), -1)[:, None].astype(np.int32)


def test_train_logits_match_jax():
    from repro.models import train_logits as jax_train_logits
    jcfg, cfg = _configs("float32")
    jparams = jax_init(jax.random.PRNGKey(1), jcfg)
    model = _carry(jparams, cfg)
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    jl, _ = jax_train_logits(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, aux = train_logits(model, {"tokens": torch.from_numpy(toks)}, cfg)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["float32"])
    assert float(aux) == 0.0


def test_model_params_round_trip_exactly():
    """Every leaf of the JAX tree reaches the port unchanged (bf16 handed
    over as float32 and back), and every port parameter has a leaf."""
    jcfg, cfg = _configs("bfloat16")
    jparams = jax_init(jax.random.PRNGKey(2), jcfg)
    sd = model_params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams), cfg)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(sd)                   # strict: names match
    port = dict(model.named_parameters())
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        keys = [p.key for p in path]
        leaf = np.asarray(leaf, np.float32)
        names = [".".join(keys)] if keys[0] != "blocks" else \
            [".".join(["blocks", str(i)] + keys[1:])
             for i in range(cfg.n_layers)]
        for i, name in enumerate(names):
            want = leaf if keys[0] != "blocks" else leaf[i]
            got = port.pop(name)
            assert got.dtype == (torch.float32 if name.endswith("scale")
                                 else torch.bfloat16), name
            assert np.array_equal(got.detach().float().numpy(), want), name
            n += 1
    assert not port, sorted(port)
    assert n == sum(p.numel() > 0 for p in model.parameters())


def test_init_params_is_seeded_and_sized():
    cfg = get_config("qwen2.5-3b", smoke=True)
    a = init_params(0, cfg, device="cpu")
    b = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    n = sum(p.numel() for p in a.parameters())
    jparams = jax_init(jax.random.PRNGKey(0), jax_config("qwen2.5-3b",
                                                         smoke=True))
    assert n == sum(x.size for x in jax.tree.leaves(jparams))
    assert a.blocks[0].attn.wq.dtype == torch.bfloat16
    assert a.blocks[0].norm1.scale.dtype == torch.float32
    cache = init_cache(cfg, 3, 32, device="cpu")
    assert cache["kv"]["k"].shape == (cfg.n_layers, 3, 32, cfg.n_kv_heads,
                                      cfg.hd)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCH_IDS) + list(PAPER_CASES))
@pytest.mark.parametrize("smoke", [True, False])
def test_config_registry_matches(arch, smoke):
    j, t = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.hd, j.d_inner, j.ssm_heads) == (t.hd, t.d_inner, t.ssm_heads)
    assert j.param_count() == t.param_count()
    assert j.active_param_count() == t.active_param_count()
    assert t.torch_dtype == {"bfloat16": torch.bfloat16,
                             "float32": torch.float32}[t.dtype]


# ---------------------------------------------------------------------------
# paged KV manager
# ---------------------------------------------------------------------------

def _drive_manager(cfg_cls, mgr_cls):
    cfg = cfg_cls(n_layers=2, n_kv_heads=2, head_dim=16, page_size=4,
                  fast_pages=6, max_pages_per_seq=8)
    mgr = mgr_cls(cfg, max_seqs=2)
    ops = []
    for seq in (0, 1):
        for _ in range(20):       # 5 pages each > 6 total fast pages
            ops.append(mgr.append_token(seq))
    plans = [mgr.plan_step([0, 1])]
    for _ in range(5):
        ops.append(mgr.append_token(1))
    plans.append(mgr.plan_step([1, 0]))
    return mgr, ops, plans


def test_paged_kv_manager_matches():
    jm, jops, jplans = _drive_manager(JPagedKVConfig, JPagedKVManager)
    tm, tops, tplans = _drive_manager(PagedKVConfig, PagedKVManager)
    assert tops == jops
    for name in ("page_table", "lengths", "slot_owner", "hotness"):
        assert np.array_equal(getattr(tm, name), getattr(jm, name)), name
    assert tm.stats == jm.stats and tm.stats["spills"] > 0
    assert tm.slow_pages == jm.slow_pages
    for (tbt, tln, tf), (jbt, jln, jf) in zip(tplans, jplans):
        assert np.array_equal(tbt, jbt) and np.array_equal(tln, jln)
        assert tf == jf and len(tf) > 0


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid, rng.integers(1, vocab, size=6).astype(np.int32),
                max_new=4) for rid in range(4)]


def test_engine_matches_jax():
    """The mix of tests/test_train_system.py's engine test, in float32:
    the same generated tokens and KV stats as the JAX engine."""
    jcfg, cfg = _configs("float32")
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    jeng = JEngine(jcfg, jparams, JServeConfig(max_batch=2, max_len=64))
    teng = Engine(cfg, _carry(jparams, cfg), ServeConfig(max_batch=2,
                                                         max_len=64),
                  device="cpu")
    for jr, tr in zip(_requests(JRequest, cfg.vocab),
                      _requests(Request, cfg.vocab)):
        jeng.submit(jr)
        teng.submit(tr)
    want, got = jeng.run(), teng.run()
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        if not np.array_equal(got[rid], want[rid]):
            # report how close the reference's own choice was
            toks = _requests(Request, cfg.vocab)[rid].prompt[None]
            jl, _ = jax_prefill(jparams, {"tokens": jnp.asarray(toks)},
                                jcfg, max_len=64)
            top = np.sort(np.asarray(jl)[0])[-2:]
            pytest.fail(f"request {rid}: port {got[rid].tolist()} vs JAX "
                        f"{want[rid].tolist()}; JAX prefill top-2 logit gap "
                        f"{top[1] - top[0]:.3e}")
    assert teng.kv_stats == jeng.kv_stats
    assert teng.kv_stats["appends"] > 0


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2.5-3b", smoke=True)
    model = init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, model, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--smoke", "--requests", "1"])


def test_serve_launcher_runs_on_cpu(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3"])
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out[:3]] == ["req 0", "req 1",
                                                    "req 2"]
    assert all(len(ln.split("[")[1].split(",")) == 8 for ln in out[:3])
    assert out[3].startswith("kv stats:")


def test_serving_imports_and_runs_without_jax():
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "import numpy as np",
        "import repro_torch.models, repro_torch.serving",
        "import repro_torch.launch.serve",
        "from repro_torch.configs import get_config",
        "from repro_torch.serving import Engine, Request, ServeConfig",
        "cfg = get_config('qwen2.5-3b', smoke=True)",
        "model = repro_torch.models.init_params(0, cfg, device='cpu')",
        "eng = Engine(cfg, model, ServeConfig(), device='cpu')",
        "for rid in range(2):",
        "    eng.submit(Request(rid, np.arange(1, 6, dtype=np.int32),",
        "                       max_new=3))",
        "outs = eng.run()",
        "assert [len(v) for v in outs.values()] == [3, 3], outs",
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
