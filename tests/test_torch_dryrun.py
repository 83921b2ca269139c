"""The port's dry run (``repro_torch.launch.dryrun``) and production
meshes (``launch.mesh.make_production_mesh``) over a fake process group
of 256 or 512 ranks, on the CPU.

* the two production meshes: dims, names, and the groups of ``data``,
  ``model`` and ``("pod", "data")`` (16, 16 and 32 ranks, the last made
  under ``FakeTensorMode``, in the order of its flattened index);
* a train step's backward on fake tensors gathers every weight again
  from its own parameter (with and without remat);
* the collective counter on hand-made all-gather / all-reduce /
  reduce-scatter / all-to-all calls: result bytes by kind, exactly;
* every cell of ``configs.all_cells()`` on both meshes: the port's
  per-rank bytes of each input (``steps.local_inputs``, meta tensors, no
  step run) equal the sums of the reference's ``NamedSharding(
  AbstractMesh(...), spec).shard_shape`` under its shardings;
* whisper-tiny x decode_32k through the port's CLI, with ``--probe``;
  mamba2-1.3b x decode_32k's probe; ``--multi-pod``; a skipped and a
  failing cell.  The CLI runs in a process where JAX cannot be imported;
* the tensor-parallel attention where the KV heads do not divide the
  model axis, at reduced depth: qwen2.5-3b's prefill on 16 x 16 does a
  rank's share of the work (within 1.5x of the same cell's flops on a
  256 x 1 mesh, where nothing is tensor-parallel), and its decode and
  whisper-tiny's all-reduce each layer's partial scores instead of
  gathering the cache (the reference's bytes, PERF.md);
* sequence parallelism: on for train and prefill, off for decode; a
  train step's per-layer remat savepoint 16x smaller with it on; the
  sp_prenorm, pure_fsdp and no-op knobs recorded.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.launch import steps as jsteps
from repro.parallel import sharding as jrules

import repro_torch
from repro_torch.configs import SHAPES, all_cells, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel.mesh_ctx import make_ctx

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1pod": ((16, 16), ("data", "model")),
          "2pod": ((2, 16, 16), ("pod", "data", "model"))}
# whisper-tiny x decode_32k on 16 x 16, rank 0: the shard bytes of its
# parameters (5,167,968), cache (105,271,296), tokens (32) and pos (4)
WHISPER_ARGUMENTS = 110_439_300
WHISPER_CACHE = 105_271_296


@pytest.fixture(autouse=True)
def _no_group_left():
    """Each test leaves no default process group behind."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("pods", ["1pod", "2pod"])
def test_production_mesh(pods):
    shape, names = MESHES[pods]
    dryrun._fake_world(math.prod(shape), 0)
    mesh = make_production_mesh(multi_pod=pods == "2pod", device_type="cpu")
    assert tuple(mesh.shape) == shape
    assert tuple(mesh.mesh_dim_names) == names
    ctx = make_ctx(mesh)
    assert dist.get_world_size(ctx.group("data")) == 16
    assert dist.get_world_size(ctx.group("model")) == 16
    assert ctx.dp == names[:-1]
    if pods == "2pod":
        # made lazily, as a step makes it: inside the dry run's fake mode
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            group = ctx.group(("pod", "data"))
        assert dist.get_world_size(group) == 32 == ctx.dp_size
        # rank 0's group: model coordinate 0, pod-major
        assert dist.get_process_group_ranks(group) == [
            p * 256 + d * 16 for p in range(2) for d in range(16)]
    with pytest.raises(ValueError):
        make_production_mesh(multi_pod=pods == "1pod", device_type="cpu")


def test_collective_counter_counts_result_bytes():
    """Each kind's result bytes and count, exactly, on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dryrun._fake_world(256, 0)
    mesh = make_production_mesh(device_type="cpu")
    g = make_ctx(mesh).group("data")
    cost = dryrun.CostMode()
    with FakeTensorMode(), cost:
        x = torch.empty(8, 4, dtype=torch.bfloat16)
        out = torch.empty(16 * 8, 4, dtype=torch.bfloat16)
        dist.all_gather_into_tensor(out, x, group=g)
        dist.all_reduce(torch.empty(3, 5), group=g)
        dist.all_reduce(torch.empty(7, dtype=torch.float64), group=g)
        rs = torch.empty(2, 4)
        dist.reduce_scatter_tensor(rs, torch.empty(32, 4), group=g)
        a2a = torch.empty(16, 6, dtype=torch.int32)
        dist.all_to_all_single(a2a, torch.empty_like(a2a), group=g)
    assert cost.collective_bytes == {
        "all-gather": 16 * 8 * 4 * 2, "all-reduce": 3 * 5 * 4 + 7 * 8,
        "reduce-scatter": 2 * 4 * 4, "all-to-all": 16 * 6 * 4,
        "collective-permute": 0}
    assert cost.collective_counts == {
        "all-gather": 1, "all-reduce": 2, "reduce-scatter": 1,
        "all-to-all": 1, "collective-permute": 0}


def _ref_input_bytes(arch, shape_name, mesh):
    """The reference's per-rank bytes of each input of the cell: the
    ``shard_shape`` of every leaf under its in-sharding.  The prefill's
    inputs (params, batch) take their specs from the rules directly:
    ``shardings_for``'s prefill branch traces the whole prefill for its
    output cache's shardings, which are not inputs."""
    cfg, shape = jax_config(arch), JSHAPES[shape_name]
    pcfg = jrules.make_parallel_cfg(mesh)
    specs = jsteps.input_specs(cfg, shape)
    if shape.kind == "prefill":
        named = lambda t: jrules.to_named(t, mesh)
        in_sh = (named(jrules.param_pspecs(specs["params"], pcfg)),
                 named(jrules.batch_pspecs(specs["batch"], pcfg)))
    else:
        in_sh, _ = jsteps.shardings_for(cfg, shape, mesh, pcfg)
    out = {}
    for name, sh in zip(specs, in_sh):
        leaves = jax.tree.leaves(specs[name])
        shs = jax.tree.leaves(sh, is_leaf=lambda s: isinstance(
            s, NamedSharding))
        assert len(leaves) == len(shs)
        out[name] = sum(math.prod(s.shard_shape(t.shape)) * t.dtype.itemsize
                        for t, s in zip(leaves, shs))
    return out


@pytest.mark.parametrize("pods", ["1pod", "2pod"])
@pytest.mark.parametrize("arch", sorted({a for a, _ in all_cells()}))
def test_local_input_bytes_match_reference(pods, arch):
    shape, names = MESHES[pods]
    jmesh = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    for a, shape_name in all_cells():
        if a != arch:
            continue
        local = steps.local_inputs(get_config(arch), SHAPES[shape_name],
                                   sizes)
        got = {k: steps.tree_bytes(v) for k, v in local.items()}
        assert got == _ref_input_bytes(arch, shape_name, jmesh), shape_name


@pytest.fixture(scope="module")
def whisper_cli(tmp_path_factory):
    """``main`` of the port's dry run on whisper-tiny x decode_32k with
    ``--probe``, in a process where JAX cannot be imported: (exit code,
    stdout, the JSON results)."""
    out = tmp_path_factory.mktemp("dryrun") / "out.json"
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "from repro_torch.launch import dryrun",
        "rc = dryrun.main(['--arch', 'whisper-tiny', '--shape',",
        f"                 'decode_32k', '--probe', '--json', {str(out)!r}])",
        "bad = [m for m in sys.modules if m == 'repro' or",
        "       m.startswith(('repro.', 'jax.', 'jaxlib'))]",
        "print('modules of the reference:', bad)",
        "sys.exit(rc)",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    return run.returncode, run.stdout + run.stderr, \
        json.loads(out.read_text()) if out.exists() else None


def _probe_equals_deploy(r):
    for k in ("flops", "bytes", "attn_score_bytes", "collective_bytes",
              "collective_counts"):
        assert r["probe"][k] == r["deploy"][k], k


def test_cli_whisper_decode(whisper_cli):
    """whisper-tiny x decode_32k on 256 fake ranks.  ``aliased`` is the
    cache's shard, 105,271,296 bytes, as in the reference's XLA memory
    analysis; ``arguments`` is every input's shard, 110,439,300 bytes.
    The reference's XLA figure, 110,338,692, is 100,608 bytes lower:
    ``jax.jit`` drops the arguments a program never reads, here
    parameters the decode step does not use, while the port counts every
    input it is given."""
    rc, log, res = whisper_cli
    assert rc == 0, log
    (r,) = res
    assert r["n_devices"] == 256 and r["mesh"] == {"data": 16, "model": 16}
    assert r["sequence_parallel"] is False
    mem = r["deploy"]["per_device_bytes"]
    assert mem["total_live"] > 0
    assert mem["aliased"] == WHISPER_CACHE == r["deploy"]["input_bytes"][
        "cache"]
    assert mem["arguments"] == WHISPER_ARGUMENTS
    assert mem["total_live"] == (mem["arguments"] + mem["outputs"]
                                 + mem["temps"] - mem["aliased"])
    assert r["deploy"]["flops"] > 0
    assert r["deploy"]["collective_counts"]["all-gather"] > 0
    _probe_equals_deploy(r)


def test_dryrun_runs_without_jax(whisper_cli):
    rc, log, _ = whisper_cli
    assert "modules of the reference: []" in log.splitlines()
    assert "dry-run: 1 cells, 0 failures" in log.splitlines()


def test_probe_equals_deploy_mamba2_decode():
    r = dryrun.lower_cell("mamba2-1.3b", "decode_32k", False, probe=True,
                          verbose=False)
    _probe_equals_deploy(r)
    assert r["deploy"]["per_device_bytes"]["aliased"] == \
        r["deploy"]["input_bytes"]["cache"] > 0


def test_multi_pod_has_512_devices():
    r = dryrun.lower_cell("whisper-tiny", "decode_32k", True, verbose=False)
    assert r["n_devices"] == 512
    assert r["mesh"] == {"pod": 2, "data": 16, "model": 16}
    # the batch splits over pod x data: half the single pod's rows
    assert r["deploy"]["input_bytes"]["cache"] == WHISPER_CACHE // 2


def test_skipped_and_failing_cells(tmp_path, capsys):
    out = tmp_path / "o.json"
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "long_500k",
                        "--json", str(out)]) == 0
    (r,) = json.loads(out.read_text())
    assert "skipped" in r and "error" not in r
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                        "--json", str(out)]) == 1
    (r,) = json.loads(out.read_text())
    assert "error" in r
    assert capsys.readouterr().out.splitlines()[-1] == \
        "dry-run: 1 cells, 1 failures"


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_fake_backward_regathers_each_weight_from_its_parameter(
        monkeypatch, remat):
    """A train step's backward on fake tensors (a fake (2, 2) mesh, the
    float32 qwen2.5-3b smoke model) gathers every weight again from its
    own parameter.  Without remat, each gathered weight autograd saves is
    kept as its parameter (``regather_saved``): fake tensors have no data
    pointers to tell the weights apart (every layer's ``wq`` has the same
    shape), so the pairing goes by identity.  With remat the checkpoint
    recomputes each layer, and its weights' gathers with it: the same
    parameters, as many times, as the layers' forward gathered."""
    import collections
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as rules
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                              dtype="float32")
    dryrun._fake_world(4, 0)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    ctx = make_ctx(mesh)
    sizes = {"data": 2, "model": 2}
    made, pairs = {}, []
    gathers = {"forward": [], "backward": []}
    weight, pack = coll.weight, coll._Regather.pack

    def recording_weight(mctx, t, *a, **kw):
        out = weight(mctx, t, *a, **kw)
        if out is not t:
            made[id(out)] = (out, t)        # kept alive: ids stay unique
            gathers["forward" if mctx.state["regather"] is not None
                    else "backward"].append(id(t))
        return out

    def recording_pack(self, x):
        packed = pack(self, x)
        if packed is not x:
            pairs.append((made[id(x)][1], packed[0]))
        return packed

    monkeypatch.setattr(coll, "weight", recording_weight)
    monkeypatch.setattr(coll._Regather, "pack", recording_pack)
    with FakeTensorMode(allow_non_fake_inputs=True):
        named = dict(steps.Transformer(cfg, device="meta")
                     .named_parameters())
        specs = rules.param_pspecs(named, rules.make_parallel_cfg(sizes),
                                   cfg)
        model = dryrun._fake_model(cfg, specs, sizes, train=True)
        batch = {k: torch.zeros((2, 8), dtype=torch.int32)
                 for k in ("tokens", "labels")}
        steps.grads_of(model, batch, cfg, remat, ctx)
    if not remat:
        assert pairs and all(a is b for a, b in pairs)
        assert ctx.state["regathered"] == len(pairs)
        return
    blocks = {id(p) for n, p in model.named_parameters()
              if n.startswith("blocks.")}
    layer_gathers = [i for i in gathers["forward"] if i in blocks]
    assert layer_gathers
    assert collections.Counter(gathers["backward"]) == \
        collections.Counter(layer_gathers)


def _qwen(layers):
    import dataclasses
    return dataclasses.replace(get_config("qwen2.5-3b"), n_layers=layers)


def test_query_heads_split_where_kv_heads_do_not_divide():
    """qwen2.5-3b (16 query heads, 2 KV heads) at 2 layers, a 4k prefill
    of 256 rows: on 16 x 16 each model rank runs its one query head, so a
    rank's flops are within 1.5x of a 256 x 1 rank's (all of one row's
    work, nothing tensor-parallel); every head on every rank was ~10x."""
    from repro_torch.configs import ShapeSpec
    shape = ShapeSpec("prefill_4k", 4096, 256, "prefill")
    tp = dryrun.lower_cell(_qwen(2), shape, False, verbose=False)
    dp = dryrun.lower_cell(_qwen(2), shape, False, verbose=False,
                           mesh_shape=(256, 1))
    ratio = tp["deploy"]["flops"] / dp["deploy"]["flops"]
    assert 0.9 < ratio < 1.5, ratio
    assert tp["sequence_parallel"] and not dp["sequence_parallel"]


def test_decode_sums_partial_scores():
    """qwen2.5-3b x decode_32k at 2 layers on 16 x 16: the cache split by
    head dim (8 values a rank) is read where it lies; each layer
    all-reduces the float32 scores of 8 rows x 16 heads x 32,768
    positions, and nothing gathers a layer's cache: what is all-gathered
    (the FSDP weights, the query heads, the output slices) stays under a
    quarter of the 16 x the cache shard that gathering the caches moved."""
    r = dryrun.lower_cell(_qwen(2), "decode_32k", False, verbose=False)
    d = r["deploy"]
    scores = 2 * 8 * 16 * 32768 * 4
    assert scores <= d["collective_bytes"]["all-reduce"] < 1.1 * scores
    assert d["collective_bytes"]["all-gather"] < \
        16 * d["input_bytes"]["cache"] / 4
    assert r["sequence_parallel"] is False


def test_whisper_decode_collectives_near_the_reference(whisper_cli):
    """The reference all-reduces 0.027 GB a rank a step (PERF.md); the
    port gathered 1.772 GB of caches before the split mode."""
    _, _, res = whisper_cli
    c = res[0]["deploy"]["collective_bytes"]
    assert c["all-gather"] <= 0.4e9
    assert 0.5 * 0.027e9 <= c["all-reduce"] <= 1.5 * 0.027e9


@pytest.mark.parametrize("knobs", [{}, {"sp_prenorm": True}],
                         ids=["sp", "sp_prenorm"])
def test_sequence_parallel_savepoints_shrink(knobs):
    """qwen2.5-3b x train_4k at 2 layers on 16 x 16 (remat): each layer's
    savepoint is a rank's 16 rows x 4096 positions x 2048 x 2 bytes
    without SP, and 1/16 of it with SP on."""
    on = dryrun.lower_cell(_qwen(2), "train_4k", False, verbose=False,
                           **knobs)
    off = dryrun.lower_cell(_qwen(2), "train_4k", False, verbose=False,
                            sequence_parallel=False)
    assert on["sequence_parallel"] and not off["sequence_parallel"]
    whole = 16 * 4096 * 2048 * 2
    assert off["deploy"]["savepoints"] == {"count": 2, "per_layer": whole,
                                           "total": 2 * whole}
    assert on["deploy"]["savepoints"]["per_layer"] * 16 == whole
    assert on["knobs"]["sp_prenorm"] == bool(knobs)
    assert on["deploy"]["collective_bytes"]["reduce-scatter"] > \
        off["deploy"]["collective_bytes"]["reduce-scatter"]


def test_pure_fsdp_and_noop_knobs(monkeypatch):
    seen = []
    monkeypatch.setattr(dryrun, "lower_cell",
                        lambda *a, **kw: seen.append(kw) or {"arch": a[0]})
    assert dryrun.main(["--arch", "whisper-tiny", "--shape", "train_4k",
                        "--pure-fsdp", "--sp-prenorm", "--no-sp"]) == 0
    assert seen[0]["pure_fsdp"] and seen[0]["sp_prenorm"]
    assert seen[0]["sequence_parallel"] is False
    monkeypatch.undo()
    with pytest.raises(TypeError, match="unknown knobs"):
        dryrun.lower_cell("whisper-tiny", "train_4k", False, sp_barier=True)
    r = dryrun.lower_cell("whisper-tiny", "train_4k", False, verbose=False,
                          pure_fsdp=True, sp_barrier=True, grad_barrier=True,
                          grad_shard=False)
    assert r["sequence_parallel"] is False
    assert r["knobs"] == {"sp_prenorm": False, "pure_fsdp": True}
    assert r["ignored"] == ["grad_barrier", "sp_barrier"]
    # every rank its own rows of the 256: whisper's tokens over 256 ranks
    assert r["deploy"]["input_bytes"]["batch"] * 256 == \
        steps.tree_bytes(steps.batch_specs(get_config("whisper-tiny"),
                                           SHAPES["train_4k"], True))
