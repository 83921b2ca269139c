"""The port's sharding rules (``repro_torch.parallel.sharding``) and cell
shardings (``repro_torch.launch.steps.shardings_for``) against the JAX
package's, entry for entry.

Every registered config x every ``SHAPES`` entry, at the reference tests'
``ParallelConfig(dp 16, fsdp 16, tp 16)`` and at a (2, 2) mesh (JAX on an
``AbstractMesh``, the port on ``{axis: size}``): ``param_pspecs`` on the
reference's tree layout (plain and ``pure_fsdp``) and on the port's named
parameters (the layer axes split: each name's spec is its JAX leaf's with
those axes dropped), ``kv_cache_pspecs`` in every mode (auto, heads,
head_dim, replicate), ``batch_pspecs`` and ``shardings_for``'s in and out
trees for the train, prefill and decode kinds.  The shapes themselves
(the port's meta-tensor input specs) equal the reference's
``eval_shape`` ones.  Plus ``placements`` on a mesh.
"""

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.launch import steps as jsteps
from repro.parallel import sharding as jrules

from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import jax_leaf_order, stack_shape
from repro_torch.launch import steps
from repro_torch.models import Transformer
from repro_torch.parallel import sharding as rules

ARCHS = sorted(ARCH_IDS)
MESHES = {"16x16": (16, 16), "2x2": (2, 2)}


def _pcfgs(module, mesh):
    """The reference tests' config and the mesh's (plain, pure_fsdp)."""
    big = module.ParallelConfig(dp_axes=("data",), dp_size=16,
                                fsdp_size=16, tp_size=16)
    return [big, module.make_parallel_cfg(mesh),
            module.make_parallel_cfg(mesh, pure_fsdp=True)]


def _jax_mesh(shape):
    return AbstractMesh(shape, ("data", "model"))


def _port_mesh(shape):
    return {"data": shape[0], "model": shape[1]}


def _entries(spec):
    """A spec's entries, a one-axis tuple as its axis (``PartitionSpec``
    stores ``("data",)`` as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _jtree(tree):
    """A JAX spec tree as nested dicts / tuples of entry tuples."""
    return jax.tree.map(_entries, tree, is_leaf=lambda s: isinstance(
        s, jax.sharding.PartitionSpec))


def _ptree(tree):
    return rules._map(tree, lambda _, s: _entries(s))


def _shapes(tree):
    return jax.tree.map(lambda s: tuple(s.shape), tree)


@pytest.fixture(scope="module")
def jax_params():
    return {a: jsteps.param_specs(jax_config(a)) for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, jax_params):
    """The port's meta-tensor specs have the reference's tree and shapes:
    params, optimizer state, the batch and the decode cache."""
    cfg = get_config(arch)
    assert _shapes(steps.param_specs(cfg)) == _shapes(jax_params[arch])
    assert _shapes(steps.opt_specs(cfg)) == _shapes(
        jsteps.opt_specs(jax_config(arch)))
    for name, shape in SHAPES.items():
        if shape.kind == "prefill" and get_config(arch).family == "vlm" \
                and shape.seq_len <= cfg.n_patches:
            continue
        want = jsteps.input_specs(jax_config(arch), JSHAPES[name])
        got = steps.input_specs(cfg, shape)
        for k in ("batch", "tokens", "cache"):
            if k in want:
                assert _shapes(got[k]) == _shapes(want[k]), (name, k)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, mesh, jax_params):
    """The tree layout, plain and pure_fsdp, and the optimizer state."""
    cfg = get_config(arch)
    ps = steps.param_specs(cfg)
    ops = steps.opt_specs(cfg)
    jops = jsteps.opt_specs(jax_config(arch))
    for jp, pp in zip(_pcfgs(jrules, _jax_mesh(MESHES[mesh])),
                      _pcfgs(rules, _port_mesh(MESHES[mesh]))):
        assert _ptree(rules.param_pspecs(ps, pp)) == _jtree(
            jrules.param_pspecs(jax_params[arch], jp))
        assert _ptree(rules.param_pspecs(ops, pp)) == _jtree(
            jrules.param_pspecs(jops, jp))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_named_param_pspecs_match_reference(arch, mesh, jax_params):
    """The port's layer-split names: each spec is its JAX leaf's with the
    stacked layer axes dropped."""
    cfg = get_config(arch)
    named = dict(Transformer(cfg, device="meta").named_parameters())
    for jp, pp in zip(_pcfgs(jrules, _jax_mesh(MESHES[mesh])),
                      _pcfgs(rules, _port_mesh(MESHES[mesh]))):
        want = jrules.param_pspecs(jax_params[arch], jp)
        got = rules.param_pspecs(named, pp, cfg)
        assert set(got) == set(named)
        for path, names in jax_leaf_order(named, cfg):
            node = want
            for key in path:
                node = node[key]
            lead = len(stack_shape(path, cfg))
            for n in names:
                assert isinstance(got[n], rules.P)
                assert _entries(got[n]) == _entries(node)[lead:], (n, node)


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_cache_pspecs_match_reference(arch):
    """Every decode shape's cache in every kv mode, at tp 16 and 2."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, shape in SHAPES.items():
        if shape.kind != "decode":
            continue
        cache = steps.cache_specs(cfg, shape)
        jcache = jsteps.cache_specs(jcfg, JSHAPES[name])
        for mesh, (dp, tp) in MESHES.items():
            for mode in ("auto", "heads", "head_dim", "replicate"):
                jp = jrules.ParallelConfig(dp_axes=("data",), dp_size=dp,
                                           fsdp_size=dp, tp_size=tp,
                                           kv_mode=mode)
                pp = rules.ParallelConfig(dp_axes=("data",), dp_size=dp,
                                          fsdp_size=dp, tp_size=tp,
                                          kv_mode=mode)
                assert _ptree(rules.kv_cache_pspecs(cache, cfg, pp, tp)) \
                    == _jtree(jrules.kv_cache_pspecs(jcache, jcfg, jp, tp)), \
                    (name, mesh, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_pspecs_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, shape in SHAPES.items():
        if shape.kind == "decode" or (cfg.family == "vlm"
                                      and shape.seq_len <= cfg.n_patches):
            continue
        b = steps.batch_specs(cfg, shape, True)
        jb = jsteps.batch_specs(jcfg, JSHAPES[name], True)
        for mesh in MESHES.values():
            for jp, pp in zip(_pcfgs(jrules, _jax_mesh(mesh)),
                              _pcfgs(rules, _port_mesh(mesh))):
                assert _ptree(rules.batch_pspecs(b, pp)) == _jtree(
                    jrules.batch_pspecs(jb, jp))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_for_match_reference(arch, shape, mesh):
    """The (in, out) trees of the cell's step: every spec, and each
    ``Named``'s mesh."""
    cfg = get_config(arch)
    if cfg.family == "vlm" and SHAPES[shape].seq_len <= cfg.n_patches:
        pytest.skip("seq_len must exceed n_patches")
    want = jsteps.shardings_for(jax_config(arch), JSHAPES[shape],
                                _jax_mesh(MESHES[mesh]))
    pm = _port_mesh(MESHES[mesh])
    got = steps.shardings_for(cfg, SHAPES[shape], pm)
    assert rules._map(got, lambda _, s: _entries(s.spec)) == jax.tree.map(
        lambda s: _entries(s.spec), want,
        is_leaf=lambda s: hasattr(s, "spec"))
    assert all(n.mesh == pm for n in jax.tree.leaves(
        rules._map(got, lambda _, s: [s]), is_leaf=lambda s: isinstance(
            s, rules.Named)))


def test_guard_and_axis_sizes():
    """``_guard`` replicates a dim its axis does not divide (whisper's
    vocab 51865 over 16); ``axis_size`` of the dp tuple and of ``pod``."""
    pcfg = rules.ParallelConfig(dp_axes=("data",), dp_size=16, fsdp_size=16,
                                tp_size=16)
    ps = rules.param_pspecs(steps.param_specs(get_config("whisper-tiny")),
                            pcfg)
    assert ps["embed"]["tok"] == rules.P(None, "data")
    assert pcfg.axis_size(("data",)) == 16 and pcfg.axis_size("pod") == 1
    assert rules._guard([("data",), "model", None], (32, 24, 5), pcfg) == [
        ("data",), None, None]
    assert rules.make_parallel_cfg(None) == rules.ParallelConfig(
        fsdp=False, dp_axes=())


def test_placements():
    """A spec on a mesh: ``Shard(dim)`` on the mesh dims that split it,
    ``Replicate()`` on the others, a tuple entry on each of its axes."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"data": 2, "model": 2}
    assert rules.placements(rules.P("data", "model"), mesh) == (
        Shard(0), Shard(1))
    assert rules.placements(rules.P(None, "data"), mesh) == (
        Shard(1), Replicate())
    assert rules.placements(rules.P(("data", "model"), None), mesh) == (
        Shard(0), Shard(0))
    assert rules.placements(rules.P(None), mesh) == (Replicate(),
                                                     Replicate())
    named = rules.Named(mesh, rules.P("model", None))
    assert named.placements == (Replicate(), Shard(0))
    assert repr(rules.P(None, ("data",))) == "P(None, ('data',))"
    assert rules.P("a") == ("a",)
