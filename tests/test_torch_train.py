"""The port's training path against the JAX package, on the CPU.

* Data: ``repro_torch.data.synthetic`` batches bit-equal to
  ``repro.data.synthetic`` (steps 0-5, two shards, the encdec's frames and
  the vlm's patches).
* AdamW: one ``update`` on the same numpy gradients and state equals
  ``repro.optim.adamw.update`` (rtol 1e-6), clipping active and inactive,
  with and without a schedule; the three schedules match.
* The train step, float32 smoke configs carrying the same JAX weights, on
  the same batches as the reference's ``make_train_step``: 3 steps' losses,
  aux and grad norms at rtol 1e-4 (qwen2.5-3b, microbatches 1 and 2, and
  the moe, encdec, vlm, ssm and hybrid families), the first step's
  gradients leaf by leaf, remat equal to no remat (the ssm and hybrid
  families' too), and a bf16 run at 2e-2.
* The reference's system tests on the port's ``Trainer``: the loss falls
  over 25 steps at lr 1e-3, a checkpoint restart is bit-exact, an injected
  fault recovers, the async checkpointer round-trips, a partial step
  directory is ignored, ``remesh(None)`` and a remesh onto a gloo (1, 1)
  mesh keep the state.
* Across packages: a checkpoint the JAX ``Trainer`` writes at step 4
  (float32 smoke) restores in the port's ``Trainer``, whose steps 5-6 match
  the reference's 6-step run at rtol 1e-4; the reference's
  ``ckpt.restore`` reads the port's checkpoint.
* ``python -m repro_torch.launch.train --smoke --device cpu`` runs (and
  with ``--arch mamba2-1.3b``, and with ``--model-parallel 2`` in one
  process, without a mesh); the training modules import without JAX;
  the ssm and hybrid families train on the port's ``Trainer`` with a
  falling loss; ``chip_smoke.train_launches`` counts a step's attention
  and SSD scan calls.

The JAX side is jitted: the reference's weights come from one compiled
``init_params`` per config (``_jax_init``, fed each test's key), its train
steps and first-step gradients from compiled functions.
"""

import dataclasses
import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jax_ckpt
from repro.configs import get_config as jax_config
from repro.data import synthetic as jax_data
from repro.launch import steps as jax_steps
from repro.models import init_params as jax_init
from repro.optim import adamw as jax_adamw
from repro.optim import schedule as jax_schedule
from repro.parallel.mesh_ctx import MeshCtx
from repro.train import Trainer as JaxTrainer
from repro.train import TrainConfig as JaxTrainConfig

from repro_torch.checkpoint import ckpt
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.convert import (adamw_state_from_jax, jax_leaf_order,
                                 model_params_from_jax)
from repro_torch.data import synthetic as data
from repro_torch.launch import steps
from repro_torch.models import Transformer, train_logits
from repro_torch.optim import adamw, schedule
from repro_torch.train import InjectedFault, TrainConfig, Trainer

SEQ, BATCH = 32, 4
SHAPE = ShapeSpec("test", seq_len=SEQ, global_batch=BATCH, kind="train")
LR = 1e-3


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


def _host(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _init_fn(arch, dtype):
    jcfg, _ = _configs(arch, dtype)
    return jax.jit(lambda key: jax_init(key, jcfg))


def _jax_init(seed, arch, dtype="float32"):
    """The reference's ``init_params`` for the smoke config at ``seed``,
    compiled once per (arch, dtype)."""
    return _init_fn(arch, dtype)(jax.random.PRNGKey(seed))


def _carry(jparams, cfg):
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(model_params_from_jax(_host(jparams), cfg))
    return model


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _near(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-tiny",
                                  "pixtral-12b"])
def test_batches_bit_equal(arch, shard):
    jcfg, cfg = _configs(arch)
    want = jax_data.for_model(jcfg, SEQ, 8, seed=3, shard=shard,
                              num_shards=2)
    got = data.for_model(cfg, SEQ, 8, seed=3, shard=shard, num_shards=2)
    for step in range(6):
        a, b = got.batch_at(step), want.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    it = iter(got)
    next(it)
    assert got.state_dict() == {"step": 1, "shard": shard, "num_shards": 2}


# ---------------------------------------------------------------------------
# AdamW and schedules
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def opt_case():
    """A float32 smoke model's parameters, one AdamW step in, and seeded
    gradients of two sizes (clipping inactive and active)."""
    jcfg, cfg = _configs("qwen2.5-3b")
    jparams = _host(_jax_init(4, "qwen2.5-3b"))
    rng = np.random.default_rng(4)
    grads = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), jparams)
    jstate = jax_adamw.init(jax.tree.map(jnp.asarray, jparams))
    _, jstate, _ = jax.jit(jax_adamw.update, static_argnums=3)(
        grads, jstate, jparams, jax_adamw.AdamWConfig(clip_norm=0.0))
    return jcfg, cfg, jparams, grads, _host(jstate)


@pytest.mark.parametrize("sched", [None, "warmup_cosine"])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0],
                         ids=["clip_inactive", "clip_active"])
def test_adamw_update_matches(opt_case, grad_scale, sched):
    jcfg, cfg, jparams, grads, jstate = opt_case
    grads = jax.tree.map(lambda g: g * grad_scale, grads)
    jfn = tfn = None
    if sched:
        jfn = jax_schedule.warmup_cosine(1e-3, 3, 10)
        tfn = schedule.warmup_cosine(1e-3, 3, 10)
    want_p, want_s, want_m = jax.jit(jax_adamw.update, static_argnums=3)(
        grads, jstate, jparams, jax_adamw.AdamWConfig(schedule=jfn))
    params = model_params_from_jax(jparams, cfg)
    state = adamw_state_from_jax(jstate, cfg)
    got_p, got_s, got_m = adamw.update(model_params_from_jax(grads, cfg),
                                       state, params,
                                       adamw.AdamWConfig(schedule=tfn),
                                       decay=steps.decay_mask(params, cfg))
    assert int(got_s["step"]) == int(want_s["step"]) == 2
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]),
                               rtol=1e-6)
    clipped = float(want_m["grad_norm"]) > 1.0
    assert clipped == (grad_scale > 1)
    want = {"params": model_params_from_jax(_host(want_p), cfg),
            **{k: model_params_from_jax(_host(want_s[k]), cfg)
               for k in ("master", "m", "v")}}
    got = {"params": got_p, **{k: got_s[k] for k in ("master", "m", "v")}}
    for part in want:
        for name, w in want[part].items():
            # atol: an element that the update nearly cancels keeps the
            # float32 rounding of its operands, 1e-6 of the leaf's scale
            w = w.numpy()
            np.testing.assert_allclose(got[part][name].numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{part} {name}")


def test_decay_mask_counts_the_layer_axis():
    """The reference decays its stacked per-layer vectors (ndim 2 with the
    layer axis) and no top-level vector."""
    _, cfg = _configs("qwen2.5-3b")
    params = dict(Transformer(cfg, device="cpu").named_parameters())
    mask = steps.decay_mask(params, cfg)
    assert mask["blocks.0.attn.bk"] and mask["blocks.1.norm1.scale"]
    assert mask["blocks.0.attn.wq"] and mask["embed.tok"]
    assert not mask["final_norm.scale"]


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (3e-4, 10, 100)), ("warmup_cosine", (1e-3, 0, 5)),
    ("warmup_linear", (3e-4, 10, 100)), ("constant", (3e-4,))])
def test_schedules_match(name, args):
    jfn = getattr(jax_schedule, name)(*args)
    tfn = getattr(schedule, name)(*args)
    for s in (0, 1, 5, 10, 11, 50, 100, 120):
        want = float(jfn(jnp.asarray(s, jnp.int32)))
        got = tfn(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------

def _runs(arch, dtype="float32", microbatches=1, n_steps=3):
    """The reference's and the port's train step from the same weights on
    the same batches: (reference metrics, port metrics) per step."""
    jcfg, cfg = _configs(arch, dtype)
    jparams = _jax_init(0, arch, dtype)
    model = _carry(jparams, cfg)
    jstep = jax.jit(jax_steps.make_train_step(
        jcfg, MeshCtx(), jax_adamw.AdamWConfig(lr=LR),
        microbatches=microbatches))
    tstep = steps.make_train_step(cfg, adamw.AdamWConfig(lr=LR),
                                  microbatches=microbatches)
    jopt = jax_adamw.init(jparams)
    topt = adamw.init(dict(model.named_parameters()))
    stream = jax_data.for_model(jcfg, SEQ, BATCH)
    want, got = [], []
    for s in range(n_steps):
        b = stream.batch_at(s)
        jparams, jopt, jm = jstep(jparams, jopt, _jbatch(b))
        model, topt, tm = tstep(model, topt, _tbatch(b))
        want.append({k: float(v) for k, v in jm.items()})
        got.append({k: float(v) for k, v in tm.items()})
    return want, got


TRAIN_CASES = {
    "qwen2.5-3b": ("qwen2.5-3b", 1),
    "qwen2.5-3b-microbatches-2": ("qwen2.5-3b", 2),
    "phi3.5-moe-42b": ("phi3.5-moe-42b", 1),
    "whisper-tiny": ("whisper-tiny", 1),
    "pixtral-12b": ("pixtral-12b", 1),
    "mamba2-1.3b": ("mamba2-1.3b", 1),
    "zamba2-2.7b": ("zamba2-2.7b", 1),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_steps_match_jax(case):
    arch, mb = TRAIN_CASES[case]
    want, got = _runs(arch, microbatches=mb)
    for s, (w, g) in enumerate(zip(want, got)):
        for k in ("loss", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {s} {k}")
    assert (got[0]["aux"] > 0) == (arch == "phi3.5-moe-42b")


def test_train_steps_bf16_match_jax():
    want, got = _runs("qwen2.5-3b", dtype="bfloat16")
    for s, (w, g) in enumerate(zip(want, got)):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-2,
                                       err_msg=f"step {s} {k}")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "phi3.5-moe-42b",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_first_step_grads_match_jax(arch):
    jcfg, cfg = _configs(arch)
    jparams = _jax_init(1, arch)
    model = _carry(jparams, cfg)
    b = jax_data.for_model(jcfg, SEQ, BATCH).batch_at(0)
    jgrads = jax.jit(jax.grad(lambda p, b: jax_steps.loss_fn(
        p, b, jcfg, MeshCtx())[0]))(jparams, _jbatch(b))
    want = model_params_from_jax(_host(jgrads), cfg)
    got, _, _ = steps.grads_of(model, _tbatch(b), cfg, remat=False)
    assert sorted(got) == sorted(want)
    top = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        # a leaf whose gradient is zero in exact arithmetic (the key bias:
        # softmax ignores a per-query constant) holds rounding noise only
        scale = max(float(w.abs().max()), 1e-3 * top)
        err = float((got[name].float() - w).abs().max())
        assert err <= 1e-4 * scale, f"{name}: {err} > 1e-4 x {scale}"


def test_remat_equals_no_remat():
    _, cfg = _configs("whisper-tiny")
    model = _carry(_jax_init(2, "whisper-tiny"), cfg)
    b = _tbatch(data.for_model(cfg, SEQ, BATCH).batch_at(0))
    g0, l0, a0 = steps.grads_of(model, b, cfg, remat=False)
    g0 = {k: v.clone() for k, v in g0.items()}
    g1, l1, a1 = steps.grads_of(model, b, cfg, remat=True)
    assert float(l0) == float(l1) and float(a0) == float(a1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_remat_equals_no_remat_ssm(arch):
    """Remat of each Mamba2 block (ssm) or super-block (hybrid: its Mamba2
    layers and the shared attention block) changes no gradient."""
    _, cfg = _configs(arch)
    model = _carry(_jax_init(2, arch), cfg)
    b = _tbatch(data.for_model(cfg, SEQ, BATCH).batch_at(0))
    g0, l0, _ = steps.grads_of(model, b, cfg, remat=False)
    g0 = {k: v.clone() for k, v in g0.items()}
    g1, l1, _ = steps.grads_of(model, b, cfg, remat=True)
    assert float(l0) == float(l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssm_families_train(arch):
    """The port's Trainer takes 3 steps of the ssm and hybrid families on
    the CPU: finite losses, the last below the first; train_logits under
    no_grad gives the same logits."""
    tr = _trainer(None, arch, steps_=3, lr=3e-3)
    tr.run()
    losses = [m["loss"] for m in tr.metrics_log]
    assert len(losses) == 3 and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    cfg = tr.cfg
    b = _tbatch(data.for_model(cfg, 8, 2).batch_at(0))
    logits, _ = train_logits(tr.model, b, cfg)
    with torch.no_grad():
        again, _ = train_logits(tr.model, b, cfg)
    assert logits.requires_grad and logits.shape == (2, 8, cfg.vocab)
    assert torch.equal(logits.detach(), again)


# ---------------------------------------------------------------------------
# the reference's system tests, on the port's Trainer
# ---------------------------------------------------------------------------

def _trainer(tmp, arch="qwen2.5-3b", steps_=6, dtype=None, **kw):
    cfg = get_config(arch, smoke=True)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    stream = data.for_model(cfg, SHAPE.seq_len, SHAPE.global_batch)
    tcfg = TrainConfig(total_steps=steps_, ckpt_every=2,
                       ckpt_dir=str(tmp) if tmp else None, **kw)
    return Trainer(cfg, SHAPE, stream, tcfg, device="cpu")


def test_loss_decreases():
    tr = _trainer(None, steps_=25, lr=1e-3)
    tr.run()
    first = np.mean([m["loss"] for m in tr.metrics_log[:3]])
    last = np.mean([m["loss"] for m in tr.metrics_log[-5:]])
    assert last < first, (first, last)
    assert all(m["step_time_s"] > 0 for m in tr.metrics_log)


def test_checkpoint_restart_bitexact(tmp_path):
    tr1 = _trainer(tmp_path / "a")
    tr1.run()
    tr2 = _trainer(tmp_path / "b", steps_=4)
    tr2.run()
    tr3 = _trainer(tmp_path / "b")
    tr3.run()
    assert tr3.step == 6 and len(tr3.metrics_log) == 2
    assert [m["loss"] for m in tr3.metrics_log] == \
        [m["loss"] for m in tr1.metrics_log[4:]]
    for a, b in zip(tr1.state_leaves(), tr3.state_leaves()):
        assert torch.equal(a, b)


def test_fault_injection_recovers(tmp_path):
    fail_at = {3}

    def hook(step):
        if step in fail_at:
            fail_at.clear()
            raise InjectedFault(f"node lost at step {step}")

    cfg = get_config("qwen2.5-3b", smoke=True)
    stream = data.for_model(cfg, SHAPE.seq_len, SHAPE.global_batch)
    tr = Trainer(cfg, SHAPE, stream,
                 TrainConfig(total_steps=6, ckpt_every=2,
                             ckpt_dir=str(tmp_path)),
                 fault_hook=hook, device="cpu")
    out = tr.run()
    assert out["steps"] == 6 and out["recoveries"] >= 1


def test_unrecoverable_error_is_not_retried(tmp_path):
    def hook(step):
        raise RuntimeError("flash_attention_bwd: CUDA error 98 at launch")

    tr = _trainer(tmp_path, steps_=2)
    tr.fault_hook = hook
    with pytest.raises(RuntimeError, match="at launch"):
        tr.run()
    assert tr.recoveries == 0


def test_async_checkpointer_roundtrip(tmp_path):
    leaves = [torch.arange(10, dtype=torch.float32),
              torch.ones(3, 4, dtype=torch.bfloat16) / 3,
              torch.tensor(7, dtype=torch.int32)]
    ck = ckpt.AsyncCheckpointer(str(tmp_path))
    ck.save(5, leaves, extra={"note": "x"})
    ck.wait()
    back, step, extra = ckpt.restore(str(tmp_path), leaves)
    assert step == 5 and extra["note"] == "x"
    for a, b in zip(leaves, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for s in (6, 7, 8):
        ck.save(s, leaves)
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}" for s in (6, 7, 8)]


def test_checkpoint_atomicity(tmp_path):
    """A partially-written step directory is ignored by latest_step, and a
    shape mismatch refuses to restore."""
    ckpt.save(str(tmp_path), 1, [torch.arange(4)])
    os.makedirs(tmp_path / "step_00000009")
    assert ckpt.latest_step(str(tmp_path)) == 1
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), [torch.zeros(5)])


def test_elastic_remesh_single_device(tmp_path):
    """``remesh(None)`` and onto a gloo (1, 1) mesh keep every leaf, and
    the trainer steps on after it."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for
    tr = _trainer(None, steps_=2)
    tr.run()
    before = [t.detach().clone() for t in tr.state_leaves()]
    tr.remesh(None)
    assert all(torch.equal(a, b) for a, b in zip(before, tr.state_leaves()))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        tr.remesh(make_mesh_for(1, 1, "cpu"))
        assert tr.mesh is not None
        assert all(torch.equal(a, b)
                   for a, b in zip(before, tr.state_leaves()))
        tr.tcfg.total_steps = 3
        tr.run()
        assert tr.step == 3 and np.isfinite(tr.metrics_log[-1]["loss"])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def test_jax_checkpoint_resumes_in_port(tmp_path):
    """The JAX Trainer's step-4 checkpoint (float32 smoke), resumed by the
    port's Trainer to step 6, gives the reference's steps 5-6."""
    jcfg, cfg = _configs("qwen2.5-3b")
    jt = JaxTrainer(jcfg, SHAPE, jax_data.for_model(jcfg, SEQ, BATCH),
                    JaxTrainConfig(total_steps=6, ckpt_every=2,
                                   ckpt_dir=str(tmp_path / "jax")))
    jt.run()
    shutil.copytree(tmp_path / "jax" / "step_00000004",
                    tmp_path / "port" / "step_00000004")
    tr = Trainer(cfg, SHAPE, data.for_model(cfg, SEQ, BATCH),
                 TrainConfig(total_steps=6, ckpt_dir=str(tmp_path / "port")),
                 seed=9, device="cpu")
    tr.run()
    assert tr.step == 6 and len(tr.metrics_log) == 2
    for g, w in zip(tr.metrics_log, jt.metrics_log[4:]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jcfg, cfg = _configs("qwen2.5-3b")
    tr = _trainer(tmp_path, steps_=2, dtype="float32")
    tr.run()
    like_params = _jax_init(0, "qwen2.5-3b")
    like = {"params": like_params, "opt": jax_adamw.init(like_params)}
    tree, step, extra = jax_ckpt.restore(str(tmp_path), like)
    assert step == 2 and extra == {"data": tr.data.state_dict(), "step": 2}
    assert int(tree["opt"]["step"]) == 2
    got = model_params_from_jax(_host(tree["params"]), cfg)
    for name, p in tr.params.items():
        assert torch.equal(got[name], p.detach()), name
    state = adamw_state_from_jax(_host(tree["opt"]), cfg)
    for k in ("master", "m", "v"):
        for name, t in tr.opt_state[k].items():
            assert torch.equal(state[k][name], t), (k, name)


def test_leaf_order_is_jax_flatten_order():
    for arch in ("qwen2.5-3b", "phi3.5-moe-42b", "whisper-tiny",
                 "pixtral-12b", "mamba2-1.3b", "zamba2-2.7b"):
        jcfg, cfg = _configs(arch)
        jparams = jax.eval_shape(lambda k: jax_init(k, jcfg),
                                 jax.random.PRNGKey(0))
        paths = [tuple(p.key for p in path) for path, _ in
                 jax.tree_util.tree_leaves_with_path(jparams)]
        model = Transformer(cfg, device="cpu")
        order = jax_leaf_order(dict(model.named_parameters()), cfg)
        assert [p for p, _ in order] == paths, arch
        leaves = ckpt._tree_leaves(dict(model.named_parameters()), cfg)
        assert [tuple(t.shape) for t in leaves] == \
            [tuple(x.shape) for x in jax.tree.leaves(jparams)], arch


@pytest.mark.parametrize("remat", [False, True])
def test_chip_smoke_train_launches_count_the_attention_calls(remat,
                                                            monkeypatch):
    """``chip_smoke.train_launches`` (what the card's launch counts are
    held to) equals the attention calls one Trainer step makes: a forward
    with log-sum-exp per layer (twice under remat) and one backward."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels.flash_attention import ops
    calls = {"forward": 0, "lse": 0, "backward": 0}
    fwd, bwd = ops.flash_attention_forward, ops.flash_attention_backward

    def forward(*args, **kw):
        calls["forward"] += 1
        calls["lse"] += bool(kw.get("with_lse"))
        return fwd(*args, **kw)

    def backward(*args, **kw):
        calls["backward"] += 1
        return bwd(*args, **kw)
    monkeypatch.setattr(ops, "flash_attention_forward", forward)
    monkeypatch.setattr(ops, "flash_attention_backward", backward)
    tr = _trainer(None, steps_=1, remat=remat)
    tr.run()
    want = chip_smoke.train_launches(tr.cfg, 1, remat=remat)
    assert calls == {"forward": want["flash_attention"],
                     "lse": want["flash_attention.lse"],
                     "backward": want["flash_attention_bwd"]}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_chip_smoke_train_launches_count_the_ssd_calls(arch, remat,
                                                       monkeypatch):
    """``chip_smoke.train_launches`` for the ssm and hybrid families equals
    the calls one Trainer step makes: an ssd_scan forward per Mamba2 layer
    (twice under remat) and one backward; the hybrid's shared attention
    block once a super-block."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    calls = {"ssd": 0, "ssd_bwd": 0, "flash": 0, "flash_bwd": 0}

    def counted(mod, name, key):
        fn = getattr(mod, name)

        def run(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, name, run)
    counted(sops, "ssd", "ssd")
    counted(sops, "ssd_backward", "ssd_bwd")
    counted(fops, "flash_attention_forward", "flash")
    counted(fops, "flash_attention_backward", "flash_bwd")
    tr = _trainer(None, arch, steps_=1, remat=remat)
    tr.run()
    want = chip_smoke.train_launches(tr.cfg, 1, remat=remat)
    assert calls == {"ssd": want["ssd_scan"],
                     "ssd_bwd": want["ssd_scan_bwd"],
                     "flash": want.get("flash_attention", 0),
                     "flash_bwd": want.get("flash_attention_bwd", 0)}
    assert (calls["flash"] > 0) == (arch == "zamba2-2.7b")


# ---------------------------------------------------------------------------
# the launcher, and the training modules without JAX
# ---------------------------------------------------------------------------

def test_launcher_trains_without_jax():
    src = str(Path(__file__).resolve().parents[1] / "src")
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "import repro_torch.train, repro_torch.optim, repro_torch.data",
        "import repro_torch.checkpoint, repro_torch.launch.steps",
        "from repro_torch.launch import train",
        "train.main(['--arch', 'qwen2.5-3b', '--smoke', '--device', 'cpu',",
        "            '--steps', '3', '--seq', '16', '--batch', '2'])",
        "train.main(['--arch', 'mamba2-1.3b', '--smoke', '--device', 'cpu',",
        "            '--steps', '3', '--seq', '16', '--batch', '2'])",
        "train.main(['--smoke', '--device', 'cpu', '--model-parallel', '2',",
        "            '--steps', '3', '--seq', '16', '--batch', '2'])",
        "bad = [m for m in sys.modules if m == 'repro' or",
        "       m.startswith(('repro.', 'jax.', 'jaxlib'))]",
        "assert not bad, bad",
    ])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    # one process: --model-parallel 2 trains without a mesh, as the
    # reference does on one device
    assert len(lines) == 3
    for line in lines:
        assert line.startswith("final loss ") and \
            line.endswith("after 3 steps (stragglers=0, recoveries=0)")
