"""Training on a device mesh: the port's ``Trainer(mesh=...)`` on gloo
worlds of CPU processes against the JAX package's ``Trainer`` on the same
mesh of forced host devices (``jax_mesh_oracle.py``, one subprocess per
module, run while the port's world of 4 trains).

* qwen2.5-3b, phi3.5-moe (the MoE's "tp" placement) and mamba2-1.3b smoke
  (float32), from the same step-0 checkpoint (the port's seeded weights,
  which both packages restore), 3 steps on (2, 2) and on (4, 1), and
  qwen2.5-3b on (2, 2) with 2 microbatches and remat: losses, grad norms
  and aux within rtol 1e-4 of the reference's;
* qwen2.5-3b on (1, 4), where its 2 KV heads do not divide the model
  axis: the attention on each rank's query heads, ``wk``/``wv`` gathered
  whole with their gradients summed over the model axis;
* sequence parallelism (``TrainConfig.sequence_parallel``): qwen2.5-3b,
  phi3.5-moe and mamba2-1.3b on (2, 2), qwen2.5-3b on (1, 4), with and
  without ``sp_prenorm``, and whisper-tiny (cross-attention, GELU MLP
  with its output bias) on (1, 4), against the reference's Trainer with
  the same ``MeshCtx`` fields;
* at a gloo (1, 1) mesh every loss, grad norm and final leaf bit-equal to
  the port's meshless ``Trainer``;
* ``remesh`` (2, 2) -> (4, 1) -> None keeps every leaf bit-equal, and the
  backward of the (2, 2) runs gathered their FSDP weights again instead
  of keeping them;
* the (2, 2) run's final checkpoint restores bit-equal on (4, 1), without
  a mesh and in the JAX package;
* ``torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu
  --smoke --model-parallel 2`` prints one final line.

``python tests/test_torch_parallel_train.py`` prints each run's largest
relative distance from the reference's losses and grad norms.
"""

import dataclasses
import datetime
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint import ckpt as jax_ckpt

from repro_torch.checkpoint import ckpt
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data.synthetic import for_model
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.train import TrainConfig, Trainer

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_workers as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2.5-3b", "phi3.5-moe-42b", "mamba2-1.3b"]
CKPT_ARCHS = ARCHS + ["whisper-tiny"]
SHAPES = [(2, 2), (4, 1)]
SEQ, BATCH, LR = 32, 4, 1e-3
# (arch, mesh, TrainConfig options) of every run on the world of 4
SP = (("sequence_parallel", True),)
RUNS = [(a, s, ()) for a in ARCHS for s in SHAPES] + [
    ("qwen2.5-3b", (2, 2), (("microbatches", 2), ("remat", True))),
    ("qwen2.5-3b", (1, 4), ())] + [(a, (2, 2), SP) for a in ARCHS] + [
    ("qwen2.5-3b", (1, 4), SP),
    ("qwen2.5-3b", (1, 4), SP + (("sp_prenorm", True),)),
    ("whisper-tiny", (1, 4), SP)]


def _cfg(arch):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def _trainer(arch, steps, mesh=None, ckpt_dir=None):
    cfg = _cfg(arch)
    return Trainer(cfg, ShapeSpec("mesh", SEQ, BATCH, "train"),
                   for_model(cfg, SEQ, BATCH),
                   TrainConfig(total_steps=steps, ckpt_dir=ckpt_dir, lr=LR),
                   mesh=mesh, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's results from a gloo world of 4, the reference's)."""
    return _run_all(tmp_path_factory.mktemp("mesh_train"))


def _run_all(d: Path):
    for arch in CKPT_ARCHS:
        tr = _trainer(arch, 0)
        ckpt.save(str(d / arch), 0, tr.state_leaves(),
                  extra={"data": tr.data.state_dict(), "step": 0})
    jobs = [(arch, shape, str(d / arch), dict(kw))
            for arch, shape, kw in RUNS]
    with open(d / "req.pkl", "wb") as f:
        pickle.dump({"train": (jobs, SEQ, BATCH, LR)}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    oracle = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_mesh_oracle.py"),
         str(d / "req.pkl"), str(d / "ans.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        port = W.run_world(4, W.train_jobs, jobs, SEQ, BATCH, root=str(d))
    finally:
        log, _ = oracle.communicate(timeout=300)
    assert oracle.returncode == 0, log.decode()[-3000:]
    with open(d / "ans.pkl", "rb") as f:
        ref = pickle.load(f)["train"]
    return port, ref


@pytest.mark.parametrize("run", RUNS, ids=lambda r: "-".join(
    [r[0], f"{r[1][0]}x{r[1][1]}"] + [k for k, _ in r[2]]))
def test_meshed_trainer_matches_reference(runs, run):
    port, ref = runs
    got, want = port[run], ref[run]
    for k in ("loss", "grad_norm", "aux"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert all(np.isfinite(got["loss"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_is_bit_equal_to_meshless(tmp_path, arch):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = []
        for mesh in (None, make_mesh_for(1, 1, "cpu")):
            tr = _trainer(arch, 3, mesh)
            tr.run()
            out.append(([(m["loss"], m["grad_norm"], m["aux"])
                         for m in tr.metrics_log],
                        [t.detach().clone() for t in tr.state_leaves()]))
    finally:
        dist.destroy_process_group()
    (m0, l0), (m1, l1) = out
    assert m0 == m1
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))


def test_remesh_keeps_every_leaf(runs):
    port, _ = runs
    assert port["remesh"] == [True, True]
    assert port["regathered"] > 0


def test_checkpoint_restores_across_meshes(runs):
    """Saved on (2, 2): on (4, 1) (in the world), without a mesh and in
    the JAX package, every leaf bit-equal."""
    port, _ = runs
    assert port["restore"]
    want = port["leaves"]
    tr = _trainer(ARCHS[0], 3, ckpt_dir=port["ckpt"])
    assert tr.restore() and tr.step == 3
    got = [t.detach().numpy() for t in tr.state_leaves()]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    leaves, step, _ = jax_ckpt.restore(port["ckpt"], [
        np.zeros(w.shape, w.dtype) for w in want])
    assert step == 3
    for a, b in zip(leaves, want):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_launcher_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--device", "cpu", "--smoke", "--model-parallel", "2",
           "--steps", "2", "--seq", "16", "--batch", "2"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=240, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("final loss ")]
    assert len(lines) == 1, out.stdout
    assert lines[0].endswith("after 2 steps (stragglers=0, recoveries=0)")


if __name__ == "__main__":
    # the largest relative distance of each run's losses and grad norms
    # from the reference's: python tests/test_torch_parallel_train.py
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        port, ref = _run_all(Path(tmp))
    for run in RUNS:
        got, want = port[run], ref[run]
        print(run, {k: float(np.max(np.abs(np.subtract(got[k], want[k]))
                                    / np.abs(want[k])))
                    for k in ("loss", "grad_norm")})
