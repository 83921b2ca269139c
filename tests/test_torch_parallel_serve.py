"""Serving on a device mesh: the port's ``make_prefill_step`` /
``make_serve_step`` (beside ``prefill`` / ``decode_step`` for the logits)
and ``Engine(ctx=...)`` on gloo worlds of 4 CPU processes, against the
JAX package's steps on the same mesh of forced host devices, jitted with
``shardings_for``'s shardings (``jax_mesh_oracle.py``, one subprocess,
run while the port's world serves).

* qwen2.5-3b, phi3.5-moe-42b (the MoE's "tp" placement) and mamba2-1.3b
  smoke (float32, the same JAX-initialized weights in both packages) on
  (2, 2) and (4, 1), and qwen2.5-3b on (2, 2) with its caches split by
  head dim and replicated: a prefill of 4 prompts of 8 tokens, then 4
  decode steps.  Greedy tokens equal, logits within rtol 1e-4, each
  rank's cache shard equal to the reference's cache sliced by
  ``kv_cache_pspecs`` within 1e-5, the engine's tokens the steps';
* qwen2.5-3b on (1, 4), where its 2 KV heads do not divide the model
  axis: prefill on each rank's query heads against the K/V heads they
  read, and decode over the cache split by head dim (4 values a rank)
  through ``paged_attention``'s split mode (partial scores summed over
  the ranks);
* sequence parallelism (the job's "sp" / "sp_prenorm"): qwen2.5-3b,
  phi3.5-moe-42b and mamba2-1.3b on (2, 2) and qwen2.5-3b on (1, 4), with
  the prefill's residual stream split over the model axis, against the
  reference's steps with ``sequence_parallel`` on;
* whisper-tiny on (1, 4) with its caches split by head dim (4 of the
  smoke model's 16 values a rank; the cross-attention's encoder K/V read
  through the split mode too), with and without sequence parallelism in
  its prefill, on random audio frames: the same checks against the
  reference (the engine's audio frontend is a stub of zero frames, so
  its tokens are checked for the decoder-only models);
* at a gloo (1, 1) mesh the engine's tokens and the steps' caches
  bit-equal to the meshless ones.
"""

import dataclasses
import datetime
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init

from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import Transformer
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as rules
from repro_torch.parallel.mesh_ctx import make_ctx
from repro_torch.serving import Engine, Request, ServeConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_workers as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2.5-3b", "phi3.5-moe-42b", "mamba2-1.3b"]
JOBS = [(a, s, "auto") for a in ARCHS for s in [(2, 2), (4, 1)]] + [
    ("qwen2.5-3b", (2, 2), m) for m in ("head_dim", "replicate")] + [
    ("qwen2.5-3b", (1, 4), "auto")] + [
    (a, (2, 2), "auto", "sp") for a in ARCHS] + [
    ("qwen2.5-3b", (1, 4), "auto", f) for f in ("sp", "sp_prenorm")]
WHISPER = {"split": ("whisper-tiny", (1, 4), "head_dim"),
           "sp": ("whisper-tiny", (1, 4), "head_dim", "sp")}
JOBS += list(WHISPER.values())
B, L, MAX_LEN, STEPS = 4, 8, 32, 4


def _params(arch):
    """The JAX package's float32 smoke weights (seed 0) as numpy."""
    cfg = dataclasses.replace(jax_config(arch, smoke=True), dtype="float32")
    return jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jax_init(jax.random.PRNGKey(0), cfg))


def _tokens(vocab):
    return np.random.default_rng(0).integers(
        1, vocab, size=(B, L)).astype(np.int32)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the port's results from a gloo world of 4, the reference's)."""
    d = tmp_path_factory.mktemp("mesh_serve")
    params = {a: _params(a) for a in ARCHS + ["whisper-tiny"]}
    toks = _tokens(get_config(ARCHS[0], smoke=True).vocab)
    wcfg = get_config("whisper-tiny", smoke=True)
    assert wcfg.vocab == get_config(ARCHS[0], smoke=True).vocab
    frames = np.random.default_rng(1).standard_normal(
        (B, wcfg.enc_seq, wcfg.frontend_dim or wcfg.d_model)).astype(
        np.float32)
    args = (JOBS, params, toks, MAX_LEN, STEPS, frames)
    with open(d / "req.pkl", "wb") as f:
        pickle.dump({"serve": args}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    oracle = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_mesh_oracle.py"),
         str(d / "req.pkl"), str(d / "ans.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        port = W.run_world(4, W.serve_jobs, *args, root=str(d))
    finally:
        log, _ = oracle.communicate(timeout=300)
    assert oracle.returncode == 0, log.decode()[-3000:]
    with open(d / "ans.pkl", "rb") as f:
        ref = pickle.load(f)["serve"]
    return port, ref


def _slice(leaf, spec, sizes, coords):
    """A rank's shard of a whole numpy leaf under ``spec``."""
    for d, entry in enumerate(spec):
        axes = rules.spec_axes(entry)
        n = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if n == 1:
            continue
        i = 0
        for a in axes:
            i = i * sizes[a] + coords[a]
        size = leaf.shape[d] // n
        leaf = np.take(leaf, range(i * size, (i + 1) * size), axis=d)
    return leaf


@pytest.mark.parametrize("job", JOBS, ids=lambda j: "-".join(
    [j[0], f"{j[1][0]}x{j[1][1]}", *j[2:]]))
def test_meshed_serving_matches_reference(served, job):
    port, ref = served
    got, want = port[job], ref[job]
    assert got["step_cache_equal"]
    for a, b in zip(got["tokens"], want["tokens"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())
    eng = np.concatenate(got["tokens"], axis=1)
    if job[0] != "whisper-tiny":
        assert got["engine"] == {i: eng[i].tolist() for i in range(B)}
    # each rank's cache shard is the reference's cache sliced by the rules
    arch, shape, kv_mode = job[:3]
    cfg = get_config(arch, smoke=True)
    sizes = {"data": shape[0], "model": shape[1]}
    specs = rules.kv_cache_pspecs(
        want["cache"], cfg, rules.make_parallel_cfg(sizes, kv_mode=kv_mode),
        shape[1])
    for coords, shard in got["caches"]:
        rules.map_leaves(lambda w, s, g: np.testing.assert_allclose(
            g, _slice(w, s, sizes, coords), rtol=1e-5, atol=1e-5),
            want["cache"], specs, shard)


@pytest.mark.parametrize("mode", ["split", "sp"])
def test_whisper_cross_decode_split_by_head_dim(served, mode):
    """Every rank holds 4 of the smoke model's 16 head-dim values of both
    caches (so decode reads them through the split mode), and its slice
    is the reference's (test_meshed_serving_matches_reference holds the
    values and the logits)."""
    port, ref = served
    job = WHISPER[mode]
    got, want = port[job], ref[job]
    for _, shard in got["caches"]:
        assert {k: tuple(v["k"].shape) for k, v in shard.items()} == {
            "kv": (2, B, MAX_LEN, 4, 4), "cross": (2, B, 16, 4, 4)}
        for k in ("kv", "cross"):
            assert want["cache"][k]["k"].shape[-1] == 16


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_serves_bit_equal_to_meshless(tmp_path, arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    toks = _tokens(cfg.vocab)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = []
        for mesh in (None, make_mesh_for(1, 1, "cpu")):
            ctx = make_ctx(mesh)
            model = Transformer(cfg, device="cpu")
            model.load_state_dict(model_params_from_jax(_params(arch), cfg))
            coll.place_model(model, cfg, ctx)
            tok, cache = S.make_prefill_step(cfg, ctx, MAX_LEN)(
                model, {"tokens": torch.from_numpy(toks)})
            serve = S.make_serve_step(cfg, ctx)
            for i in range(STEPS):
                tok, cache = serve(model, tok, cache, L + i)
            eng = Engine(cfg, model, ServeConfig(max_batch=B,
                                                 max_len=MAX_LEN),
                         device="cpu", ctx=ctx)
            for rid, row in enumerate(toks):
                eng.submit(Request(rid, row, max_new=STEPS + 1))
            out.append((tok, W._leaves(cache), eng.run()))
    finally:
        dist.destroy_process_group()
    (t0, c0, e0), (t1, c1, e1) = out
    assert torch.equal(t0, t1)
    assert all(torch.equal(a, b) for a, b in zip(c0, c1))
    assert {k: v.tolist() for k, v in e0.items()} == \
        {k: v.tolist() for k, v in e1.items()}
