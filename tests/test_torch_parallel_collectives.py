"""The port's collectives on gloo worlds of CPU processes against the JAX
package on 4 forced host devices (run once per module in a subprocess,
``jax_mesh_oracle.py``; this process has started JAX with one device).

* ``quantize`` / ``dequantize`` bit-equal to the reference's (per tensor,
  per row, zeros, bf16 input);
* ``quantized_allreduce`` on a gloo world of 4, each rank on its own
  gradients, bit-equal to the reference's ``_ar_body`` with each device on
  its own (the public reference call replicates its input: on rank 0's
  gradients everywhere it is four times those, quantized), and
  ``ErrorFeedback`` over 3 rounds bit-equal;
* ``moe_ffn`` of the phi3.5-moe smoke layer (E 4, float32) with the "tp"
  placement on (2, 2), the "ep" placement on (4, 1) and
  ``use_shard_map_moe`` off on (2, 2), against the reference's on the same
  mesh: y, aux and the gradients of ``sum(y * r) + 0.37 aux`` (every
  parameter's whole gradient and the batch's) within the MoE test's
  float32 tolerance (rtol 1e-4, atol 1e-4 of each tensor's scale);
* each collective pair (gather with a summed or a sliced gradient,
  copy_to / reduce_from, split / reduce_shared, all_to_all) inside a small
  computation, against autograd of the same computation on whole tensors;
* ``make_mesh_for``'s refusal, ``MeshCtx`` without a mesh.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compress as jq

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models.moe import MoE
from repro_torch.parallel import MeshCtx, make_ctx
from repro_torch.parallel import compress as q

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_workers as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MOE_RUNS = [((2, 2), "tp"), ((4, 1), "ep"), ((2, 2), "global")]
COEF = 0.37
ROUNDS = 3


def _moe_inputs():
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b", smoke=True),
                              dtype="float32")
    p = MoE(cfg, torch.Generator().manual_seed(3), device="cpu")
    params = {k: v.detach().numpy().copy() for k, v in p.named_parameters()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 12, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    return params, x, r


def _grads_by_rank():
    rng = np.random.default_rng(11)
    shapes = {"a": (37, 5), "b": (129,), "c": (4, 4, 3)}
    return [{k: (rng.standard_normal(s) * (1 + i)).astype(np.float32)
             for k, s in shapes.items()} for i in range(4)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the port's answers from one gloo world of 4, the reference's)."""
    d = tmp_path_factory.mktemp("collectives")
    params, x, r = _moe_inputs()
    grads = _grads_by_rank()
    req = {"moe": (params, x, r, COEF, MOE_RUNS),
           "compress": (grads, ROUNDS)}
    with open(d / "req.pkl", "wb") as f:
        pickle.dump(req, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    oracle = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_mesh_oracle.py"),
         str(d / "req.pkl"), str(d / "ans.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        jobs = [("compress_job", (grads, ROUNDS)), ("pairs_job", (7,)),
                ("compress_job", ([grads[0]] * 4, 0))] + [
            ("moe_job", (params, x, r, shape, impl, COEF))
            for shape, impl in MOE_RUNS]
        port = W.run_world(4, W.many, jobs, root=str(d))
    finally:
        log, _ = oracle.communicate(timeout=300)
    assert oracle.returncode == 0, log.decode()[-3000:]
    with open(d / "ans.pkl", "rb") as f:
        ref = pickle.load(f)
    return port, ref


@pytest.mark.parametrize("case", ["tensor", "rows", "zeros", "bf16"])
def test_quantize_bit_equal_to_reference(case):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((33, 17)) * 3).astype(np.float32)
    axis = None
    if case == "rows":
        axis = 1
    elif case == "zeros":
        x[:] = 0
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if case == "bf16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    qt, st = q.quantize(xt, axis)
    qj, sj = jq.quantize(xj, axis)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(q.dequantize(qt, st).numpy(),
                                  np.asarray(jq.dequantize(qj, sj)))


def test_quantized_allreduce_matches_reference(results):
    port, ref = results
    got, want = port[0]["summed"], ref["compress"]["summed"]
    assert ref["compress"]["ranks_agree"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the sum is within the int8 steps of the exact one
    grads = _grads_by_rank()
    for k in want:
        exact = sum(g[k] for g in grads)
        step = (np.abs(exact).max() + sum(np.abs(g[k]).max()
                                          for g in grads)) / 127
        assert np.abs(got[k] - exact).max() <= step


def test_error_feedback_matches_reference(results):
    port, ref = results
    for got, want in zip(port[0]["fed"], ref["compress"]["fed"]):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_quantized_allreduce_of_replicated_grads(results):
    """The reference's public call replicates its input: every device on
    rank 0's gradients.  The port's world of 4 with every rank on them."""
    port, ref = results
    for k, want in ref["compress"]["public"].items():
        np.testing.assert_array_equal(port[2]["summed"][k], want)


def test_quantized_allreduce_on_one_rank(tmp_path):
    """A gloo world of one against the reference's call on a (1, 1)
    mesh."""
    import datetime
    import torch.distributed as dist
    g0 = _grads_by_rank()[0]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        got = q.quantized_allreduce({k: torch.from_numpy(v)
                                     for k, v in g0.items()},
                                    make_mesh_for(1, 1, "cpu"), "data")
    finally:
        dist.destroy_process_group()
    want = jq.quantized_allreduce({k: jnp.asarray(v) for k, v in g0.items()},
                                  jax_one_device_mesh(), "data")
    for k in g0:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def jax_one_device_mesh():
    import jax
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("run", [f"{i}-{s[0]}x{s[1]}" for s, i in MOE_RUNS])
def test_moe_placement_matches_reference(results, run):
    port, ref = results
    i = [f"{im}-{s[0]}x{s[1]}" for s, im in MOE_RUNS].index(run)
    shape, impl = MOE_RUNS[i]
    got, want = port[3 + i], ref["moe"][(shape, impl)]

    def close(a, b, what):
        tol = 1e-4 * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=tol, err_msg=what)

    close(got["y"], want["y"], "y")
    close(np.float32(got["aux"]), np.float32(want["aux"]), "aux")
    close(got["x"], want["x"], "dx")
    for k in want["grads"]:
        close(got["grads"][k], want["grads"][k], k)


@pytest.mark.parametrize("pair", ["all_to_all", "copy_reduce", "gather_sum",
                                  "split_shared"])
def test_collective_pair_gradients(results, pair):
    port, _ = results
    assert port[1][pair] <= 1e-5


def test_mesh_refusals_and_no_mesh():
    with pytest.raises(ValueError):
        make_mesh_for(3, 2, "cpu")
    ctx = make_ctx(None)
    assert ctx == MeshCtx(None) and not ctx.active
    assert ctx.dp_size == 1 and ctx.tp_size == 1 and ctx.group("data") is None
    x = torch.ones(2)
    assert ctx.wsc(x, "data") is x
