"""The step builders and the sharding of a cell (the port of the JAX
package's ``launch/steps.py``): the loss, ``make_train_step``,
``make_prefill_step`` and ``make_serve_step``, the input specs (meta
tensors in the reference's tree layout), ``shardings_for`` and each
rank's shard of the inputs (``local_inputs``).

On a mesh (``ctx``, a ``parallel.MeshCtx``) the train step takes the
global batch, keeps this rank's rows (split over the data axes where they
divide it, else whole on every rank), and each rank's objective is its
mean loss over the data ranks plus the aux term; the gradients of leaves
replicated over the data axes are summed over them (those split over
``data`` were summed by their gathers' reduce-scatter), the global norm
counts each replicated leaf once, AdamW updates the local shards, and the
metrics are the same on every rank.  The serving steps take this rank's
shards (the batch's rows, the tokens, the cache: ``local_inputs``'
shapes) and return this rank's argmax tokens and cache.  At a mesh of one
rank every collective is skipped and each step is the meshless one bit
for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..configs import ShapeSpec
from ..convert import jax_leaf_order, stack_shape
from ..models import (Transformer, decode_step, init_cache, prefill,
                      train_logits)
from ..models.config import ModelConfig
from ..optim import adamw
from ..parallel import collectives as coll
from ..parallel import sharding as shard_rules

AUX_COEF = 0.01


# ---------------------------------------------------------------------------
# Input specs: meta tensors (shapes and types, no storage) in the
# reference's tree layout.
# ---------------------------------------------------------------------------

def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, with_labels: bool
                ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        s_text = S - cfg.n_patches
        if s_text <= 0:
            raise ValueError("seq_len must exceed n_patches")
        out["tokens"] = _meta((B, s_text), i32)
        out["patches"] = _meta((B, cfg.n_patches, cfg.vision_d_model))
        if with_labels:
            out["labels"] = _meta((B, s_text), i32)
        return out
    out["tokens"] = _meta((B, S), i32)
    if cfg.family == "encdec":
        out["enc_frames"] = _meta(
            (B, cfg.enc_seq, cfg.frontend_dim or cfg.d_model))
    if with_labels:
        out["labels"] = _meta((B, S), i32)
    return out


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree as the reference nests it, stacked layer axes
    included, of meta tensors."""
    named = dict(Transformer(cfg, device="meta").named_parameters())
    tree: Dict[str, Any] = {}
    for path, names in jax_leaf_order(named, cfg):
        t = named[names[0]]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _meta(stack_shape(path, cfg) + tuple(t.shape),
                               t.dtype)
    return tree


def opt_specs(cfg: ModelConfig) -> Dict[str, Any]:
    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else _meta(v.shape)
                for k, v in tree.items()}
    ps = param_specs(cfg)
    return {"master": f32(ps), "m": f32(ps), "v": f32(ps),
            "step": _meta((), torch.int32)}


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> Any:
    return init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Everything the step function takes, as meta tensors."""
    if shape.kind == "train":
        return {"params": param_specs(cfg), "opt_state": opt_specs(cfg),
                "batch": batch_specs(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"params": param_specs(cfg),
                "batch": batch_specs(cfg, shape, with_labels=False)}
    if shape.kind == "decode":
        return {"params": param_specs(cfg),
                "tokens": _meta((shape.global_batch, 1), torch.int32),
                "cache": cache_specs(cfg, shape),
                "pos": _meta((), torch.int32)}
    raise ValueError(shape.kind)


def shardings_for(cfg: ModelConfig, shape: ShapeSpec, mesh,
                  pcfg: Optional[shard_rules.ParallelConfig] = None):
    """(in_shardings, out_shardings) trees of ``sharding.Named`` (a spec on
    ``mesh``: ``.spec``, ``.placements``) for the cell's step, as the
    reference assembles them: params and optimizer state by
    ``param_pspecs``, the batch by ``batch_pspecs``, the caches by
    ``kv_cache_pspecs``.  ``mesh``: a ``DeviceMesh`` or ``{axis: size}``."""
    pcfg = pcfg or shard_rules.make_parallel_cfg(mesh)
    named = lambda tree: shard_rules.to_named(tree, mesh)
    P = shard_rules.P
    specs = input_specs(cfg, shape)
    p_sh = named(shard_rules.param_pspecs(specs["params"], pcfg))
    dp_or_none = (pcfg.dp_axes
                  if shape.global_batch % max(1, pcfg.dp_size) == 0 else None)
    tp_size = shard_rules.axis_sizes(mesh).get(pcfg.tp_axis, 1)

    if shape.kind == "train":
        o_sh = named(shard_rules.param_pspecs(specs["opt_state"], pcfg))
        b_sh = named(shard_rules.batch_pspecs(specs["batch"], pcfg))
        metrics_sh = shard_rules.Named(mesh, P())
        return (p_sh, o_sh, b_sh), (
            p_sh, o_sh, {k: metrics_sh
                         for k in ("loss", "aux", "grad_norm", "lr")})
    if shape.kind == "prefill":
        b_sh = named(shard_rules.batch_pspecs(specs["batch"], pcfg))
        kv_sh = named(shard_rules.kv_cache_pspecs(
            cache_specs(cfg, shape), cfg, pcfg, tp_size))
        tok_sh = shard_rules.Named(mesh, P(dp_or_none, None))
        return (p_sh, b_sh), (tok_sh, kv_sh)
    if shape.kind == "decode":
        c_sh = named(shard_rules.kv_cache_pspecs(
            specs["cache"], cfg, pcfg, tp_size))
        tok_sh = shard_rules.Named(mesh, P(dp_or_none, None))
        pos_sh = shard_rules.Named(mesh, P())
        return (p_sh, tok_sh, c_sh, pos_sh), (tok_sh, c_sh)
    raise ValueError(shape.kind)


def local_inputs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                 pcfg: Optional[shard_rules.ParallelConfig] = None
                 ) -> Dict[str, Any]:
    """Each rank's shard of every input of the cell's step, as meta
    tensors in ``input_specs``' trees: each leaf's shape divided as its
    spec in ``shardings_for`` splits it (the same on every rank).
    ``mesh``: a ``DeviceMesh`` or ``{axis: size}``."""
    specs = input_specs(cfg, shape)
    in_sh, _ = shardings_for(cfg, shape, mesh, pcfg)
    sizes = shard_rules.axis_sizes(mesh)
    return {name: shard_rules.map_leaves(
        lambda t, named: _meta(shard_rules.shard_shape(
            t.shape, named.spec, sizes), t.dtype), specs[name], sh)
        for name, sh in zip(specs, in_sh)}


def tree_bytes(tree) -> int:
    """The bytes of every tensor of a tree (meta tensors included)."""
    out = []
    shard_rules.map_leaves(
        lambda t: out.append(t.numel() * t.element_size()), tree)
    return sum(out)


# ---------------------------------------------------------------------------
# Loss and steps.
# ---------------------------------------------------------------------------

def loss_fn(model, batch, cfg: ModelConfig, *, remat: bool = False,
            ctx=None):
    """(loss + AUX_COEF * aux, (loss, aux)): the mean next-token negative
    log-likelihood of ``batch["labels"]`` under float32 log-softmax (the
    vlm's image positions dropped) and the MoE load-balance term.  On a
    mesh ``batch`` is this rank's shard and ``loss`` its share of the
    global mean: the local mean over the data ranks (equal shards)."""
    logits, aux = train_logits(model, batch, cfg, remat=remat, ctx=ctx)
    labels = batch["labels"]
    if cfg.family == "vlm":
        logits = logits[:, cfg.n_patches:]
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    loss = -ll.mean()
    if ctx is not None and ctx.active:
        loss = loss / ctx.dp_size
    return loss + AUX_COEF * aux, (loss, aux)


def decay_mask(params: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> Dict[str, bool]:
    """Which parameters AdamW decays.  The reference decays the leaves of
    its parameter tree with ``ndim >= 2``, and a stacked leaf carries its
    layer axes: so it decays every per-layer vector (norm scales, biases)
    and no top-level one (the final norm's scale).  ``params``: the port
    model's parameters by name."""
    out = {}
    for path, names in jax_leaf_order(params, cfg):
        lead = len(stack_shape(path, cfg))
        for n in names:
            out[n] = params[n].dim() + lead >= 2
    return out


def grads_of(model, batch, cfg: ModelConfig, remat: bool, ctx=None):
    """(grads, loss, aux): every parameter's gradient by name (zeros where
    the loss does not reach it), in the parameter's type."""
    model.zero_grad(set_to_none=True)
    with coll.regather_saved(ctx):
        total, (loss, aux) = loss_fn(model, batch, cfg, remat=remat, ctx=ctx)
    total.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    return grads, loss.detach(), aux.detach()


def _split(batch: Dict[str, torch.Tensor], n: int, i: int):
    return {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
            for k, v in batch.items()}


def local_batch(batch: Dict[str, torch.Tensor], ctx):
    """This rank's rows of the global batch: split over the data axes where
    their size divides it (``batch_pspecs``' guard), else every row."""
    n = ctx.dp_size
    if n == 1:
        return batch
    group = ctx.group(ctx.dp)
    i = coll.group_rank(group)
    return {k: _split({k: v}, n, i)[k] if v.shape[0] % n == 0 else v
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    microbatches: int = 1, remat: bool = False, ctx=None,
                    specs: Optional[Dict[str, shard_rules.P]] = None):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: gradients of the loss (with ``microbatches`` > 1, each
    microbatch's summed in float32 in order and divided by their number,
    as the reference's ``lax.scan`` does), then one AdamW update of the
    model's parameters and ``opt_state`` in place.  ``metrics``: loss, aux,
    grad_norm and lr as 0-d tensors.  On a mesh (``ctx``) the model holds
    this rank's shards, whose specs ``specs`` gives by name; each
    microbatch of the global batch is split over the data axes, as the
    reference shards each microbatch of its scan."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    meshed = ctx is not None and ctx.active

    def shard(b):
        return local_batch(b, ctx) if meshed else b

    def train_step(model, opt_state, batch):
        if microbatches > 1:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in model.named_parameters()}
            dev = next(iter(grads.values())).device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                g, l, a = grads_of(model,
                                    shard(_split(batch, microbatches, i)),
                                    cfg, remat, ctx)
                for n, t in g.items():
                    grads[n].add_(t)
                loss, aux = loss + l, aux + a
            model.zero_grad(set_to_none=True)
            for t in grads.values():
                t.div_(microbatches)
            loss, aux = loss / microbatches, aux / microbatches
        else:
            grads, loss, aux = grads_of(model, shard(batch), cfg, remat, ctx)
        params = dict(model.named_parameters())
        norm = {}
        if meshed:
            coll.reduce_replicated_grads(ctx, grads, specs)
            if ctx.dp_size > 1:
                dist.all_reduce(loss, group=ctx.group(ctx.dp))
            if ctx.axis_size(ctx.mesh.mesh_dim_names) > 1:
                norm = {"counted": {n: coll.counted(ctx, specs[n])
                                    for n in params},
                        "group": ctx.group(tuple(ctx.mesh.mesh_dim_names))}
        _, opt_state, om = adamw.update(grads, opt_state, params, opt_cfg,
                                        decay=decay_mask(params, cfg),
                                        **norm)
        del grads
        model.zero_grad(set_to_none=True)
        return model, opt_state, {"loss": loss, "aux": aux, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, ctx=None,
                      max_len: Optional[int] = None):
    """``prefill_step(model, batch) -> (tokens (B, 1) int32, cache)``: the
    argmax of the last position's logits and the cache padded to
    ``max_len``; on a mesh (``ctx``) ``batch`` is this rank's rows and the
    tokens and cache this rank's shards."""
    def prefill_step(model, batch):
        logits, cache = prefill(model, batch, cfg, max_len=max_len, ctx=ctx)
        return logits.argmax(dim=-1, keepdim=True).to(torch.int32), cache
    return prefill_step


def make_serve_step(cfg: ModelConfig, ctx=None):
    """``serve_step(model, tokens, cache, pos) -> (tokens, cache)``: one
    decode step at write position ``pos`` and the argmax of its logits;
    on a mesh ``tokens`` and ``cache`` are this rank's shards."""
    def serve_step(model, tokens, cache, pos):
        logits, cache = decode_step(model, tokens, cache, pos, cfg, ctx=ctx)
        return logits.argmax(dim=-1, keepdim=True).to(torch.int32), cache
    return serve_step
