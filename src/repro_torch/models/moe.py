"""Mixture-of-Experts FFN with capacity dispatch (the port of the JAX
package's ``models/moe.py``, its single-device placement).

Each token's router picks its top-k experts; each (token, choice) pair
takes the next free slot of its expert's buffer of ``C`` slots, in token
order and then choice order, and a pair past the capacity is dropped.  The
experts run as batched products over their (E, C, D) buffers, and each
token sums its kept experts' outputs, weighted by its renormalized router
probabilities.

On a mesh (``ctx``, a ``parallel.MeshCtx`` with ``use_shard_map_moe``)
the reference's two ``shard_map`` placements, each routing a data shard's
tokens with the capacity of its own token count:
  * "tp": every rank holds the ``F / tp`` columns of each expert (the
    FSDP dim gathered); the tokens and the combine weights enter the
    experts through ``copy_to`` and ``y`` is summed over ``model`` after
    the combine; ``aux`` is averaged over the data axes;
  * "ep": E x split half-experts, one a data rank (``split = dp / E``),
    ``all_to_all`` routing to the half-expert's rank and back, the TP sum
    inside it.
With a mesh and ``use_shard_map_moe`` off the layer computes the
meshless function on the whole batch (each data rank the dispatch of
every token, keeping its own rows).

Bit-level choices, so that the port rounds where the reference does:
  * the router runs in float32 (``x.float() @ wg``; TF32 stays off, the
    PyTorch default for matmuls);
  * top-k breaks ties to the lower expert index, as ``jax.lax.top_k`` does
    (a stable descending sort; ``torch.topk`` promises no order);
  * the buffer and the combine are plain assignments and sums, no
    ``index_add_`` (unrepeatable on the card): each kept (expert, slot) has
    exactly one contributor, and the reference's dropped pairs only add
    zeros at slot 0;
  * a token's k weighted rows are summed in choice order from zero in the
    activation type, as the reference's scatter-add adds them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import collectives as coll
from .config import ModelConfig
from .layers import _dense_init, silu


class MoE(nn.Module):
    """The router ``wg`` (D, E) in float32 and the experts' SwiGLU weights
    ``w_gate``/``w_up`` (E, D, F) and ``w_down`` (E, F, D), drawn as
    ``init_moe`` draws them (``_dense_init``: fan-in the leading axis)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, *,
                 device=None):
        super().__init__()
        E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
        dt = cfg.torch_dtype
        self.wg = _dense_init(gen, (D, E), torch.float32, device, scale=0.02)
        self.w_gate = _dense_init(gen, (E, D, Fd), dt, device)
        self.w_up = _dense_init(gen, (E, D, Fd), dt, device)
        self.w_down = _dense_init(gen, (E, Fd, D), dt, device)


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``ceil(T k cf / E)`` rounded up to a multiple of
    8, at least 8."""
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, int(math.ceil(c / 8) * 8))


def _top_k(probs, k: int):
    """(weights, experts) of the k largest probabilities per row, ties to
    the lower expert index (``jax.lax.top_k``'s order)."""
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[:, :k], e[:, :k]


def _dispatch_ffn(x_flat, p: MoE, cfg: ModelConfig, tp_group=None,
                  experts=None, reduce: bool = True):
    """Route T tokens (T, D) through the E experts with capacity dropping;
    returns (y (T, D), aux) with the Switch-style load-balance aux
    ``E * sum_e frac_e * mean_p_e`` over each token's first choice.
    ``experts``: the (w_gate, w_up, w_down) to compute with (default the
    module's); ``tp_group``: the group over which they hold slices of the
    FFN hidden dim, whose partial outputs are summed after the combine
    (left partial with ``reduce`` off)."""
    T, D = x_flat.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    dev = x_flat.device

    probs = torch.softmax(x_flat.float() @ p.wg, dim=-1)        # (T, E)
    top_w, top_e = _top_k(probs, k)                             # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)                                  # (T*k,)
    flat_w = top_w.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)

    # each pair's slot in its expert's buffer: the exclusive cumsum of the
    # one-hot over the flat (token, choice) order
    onehot = F.one_hot(flat_e, E)
    slot = (onehot.cumsum(dim=0) - onehot).gather(1, flat_e[:, None])[:, 0]
    keep = slot < C
    slot = torch.where(keep, slot, torch.zeros_like(slot))

    # the (E, C, D) buffer as the first E * C rows of a flat one; dropped
    # pairs write row E * C, which nothing reads
    rows = torch.where(keep, flat_e * C + slot,
                       torch.full_like(slot, E * C))
    buf = x_flat.new_zeros(E * C + 1, D)
    buf[rows] = coll.copy_to(x_flat, tp_group)[flat_t]
    buf = buf[:E * C].view(E, C, D)

    w_gate, w_up, w_down = experts or (p.w_gate, p.w_up, p.w_down)
    h = torch.bmm(buf, w_gate)                                  # (E, C, F)
    u = torch.bmm(buf, w_up)
    out = torch.bmm(silu(h) * u, w_down)                        # (E, C, D)

    # the weight is cast to the activation type before the product, as the
    # reference casts it
    flat_w = coll.copy_to(flat_w, tp_group)
    gathered = out[flat_e, slot] * (flat_w * keep)[:, None].to(out.dtype)
    y = _combine(gathered, T, k, x_flat)
    if reduce:
        y = coll.reduce_from(y, tp_group)

    return y, _aux(top_e, probs, E)


def _combine(gathered, T: int, n: int, x_flat):
    """Each token's ``n`` weighted rows (grouped by token) summed in order
    from zero in the activation type, as the reference's scatter-add adds
    them."""
    gathered = gathered.view(T, n, -1)
    y = x_flat.new_zeros(T, x_flat.shape[1])
    for j in range(n):
        y = y + gathered[:, j]
    return y


def _aux(top_e, probs, E: int):
    frac = F.one_hot(top_e[:, 0], E).float().mean(dim=0)
    return E * (frac * probs.mean(dim=0)).sum()


def _pmean(aux, ctx):
    """The mean over the data axes (``lax.pmean``)."""
    return coll.reduce_from(aux, ctx.group(ctx.dp)) / ctx.dp_size


def moe_ffn(p: MoE, x, cfg: ModelConfig, ctx=None,
            sp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux float32 scalar).  Placement by
    ``ctx.moe_impl`` on a mesh ("tp" or "ep", see the module docstring);
    without one the reference's single-device branch.  ``sp`` (a
    ``collectives.SeqShard``): ``x`` is this rank's rows of the sequence,
    gathered at entry, and so is ``y``; the "tp" placement reduce-scatters
    its partial ``y`` over the sequence, the others keep their rows."""
    if ctx is None or not ctx.active:
        B, S, D = x.shape
        y, aux = _dispatch_ffn(x.reshape(-1, D), p, cfg)
        return y.reshape(B, S, D), aux
    if ctx.pure_dp and ctx.use_shard_map_moe:
        # ZeRO-3: no tensor parallelism; each rank its own rows with the
        # experts gathered whole
        B, S, D = x.shape
        experts = tuple(coll.weight(ctx, t)
                        for t in (p.w_gate, p.w_up, p.w_down))
        y, aux = _dispatch_ffn(x.reshape(-1, D), p, cfg, None, experts)
        return y.reshape(B, S, D), _pmean(aux, ctx)
    tp = ctx.use_shard_map_moe and ctx.moe_impl != "ep"
    if sp is not None:
        x = sp.enter(x, tp, mixed=True)
    if not tp:
        y, aux = (_moe_global if not ctx.use_shard_map_moe
                  else _moe_ffn_ep)(p, x, cfg, ctx)
        return (y if sp is None else sp.exit(y, False)), aux
    B, S, D = x.shape
    group = ctx.group(ctx.tp)
    if cfg.d_ff % ctx.tp_size:
        raise ValueError(f"d_ff {cfg.d_ff} does not split over "
                         f"{ctx.tp_size} model ranks")

    def cols(t, dim):
        if coll.on_tp(ctx, t, dim):
            return coll.weight(ctx, t, dim)
        return coll.split(coll.weight(ctx, t), dim, group)

    experts = (cols(p.w_gate, 2), cols(p.w_up, 2), cols(p.w_down, 1))
    y, aux = _dispatch_ffn(x.reshape(-1, D), p, cfg, group, experts,
                           reduce=sp is None)
    y = y.reshape(B, S, D)
    return (y if sp is None else sp.exit(y, True)), _pmean(aux, ctx)


def _moe_global(p: MoE, x, cfg: ModelConfig, ctx):
    """The meshless function of the whole batch on a mesh: every data rank
    dispatches all tokens with whole weights and keeps its rows; the aux
    term enters each rank's objective divided by the data ranks, so the
    sum of their gradients is the aux's."""
    B, S, D = x.shape
    dgroup = ctx.group(ctx.dp)
    x_all = coll.gather(x, 0, dgroup, grad="sum")
    experts = tuple(coll.weight(ctx, t)
                    for t in (p.w_gate, p.w_up, p.w_down))
    y, aux = _dispatch_ffn(x_all.reshape(-1, D), p, cfg, None, experts)
    y = y.view(x_all.shape).narrow(0, coll.group_rank(dgroup) * B, B)
    return y, coll.reduce_from(aux / ctx.dp_size, dgroup)


# ---------------------------------------------------------------------------
# Expert-parallel variant (all_to_all token routing, resident weights).
# ---------------------------------------------------------------------------

def _moe_ffn_ep(p: MoE, x, cfg: ModelConfig, ctx):
    """EP over the data axis (the reference's ``_moe_ffn_ep``).  E experts
    become ``E * split`` half-experts (``split = dp / E``, splitting the FFN
    hidden dim) so each data rank owns exactly one; the model axis stays TP
    within the half-expert.  Tokens choosing expert e go by all-to-all to
    ranks ``e * split .. e * split + split - 1`` with capacity
    ``max(8, ceil(T k split cf / dp / 8) * 8)`` a destination, and the
    results come back the same way."""
    B, S, D = x.shape
    E, k, Fd = cfg.n_experts, cfg.top_k, cfg.d_ff
    dp_n = ctx.axis_size("data")
    if dp_n % E:
        raise ValueError(f"the EP variant needs E | data ranks: {E}, {dp_n}")
    split = dp_n // E
    Fh = Fd // split
    dgroup, tgroup = ctx.group("data"), ctx.group(ctx.tp)
    row, tp_n = ctx.coord("data"), ctx.tp_size
    Ft = Fh // tp_n
    lo = ctx.coord(ctx.tp) * Ft

    # stored (E, D, F) -> (E * split, D, F / split) half-experts; this
    # rank's half, its model slice
    def half_in(t):
        t = coll.weight(ctx, t, summed=True).reshape(E, D, split, Fh)
        return t.permute(0, 2, 1, 3).reshape(E * split, D, Fh)[row] \
            .narrow(1, lo, Ft)

    w1, w2 = half_in(p.w_gate), half_in(p.w_up)
    w3 = coll.weight(ctx, p.w_down, summed=True).reshape(
        E * split, Fh, D)[row].narrow(0, lo, Ft)

    xf = x.reshape(-1, D)
    T = xf.shape[0]
    dev = xf.device
    cap = max(8, int(math.ceil(T * k * split * cfg.capacity_factor
                               / dp_n / 8) * 8))
    probs = torch.softmax(xf.float() @ p.wg, dim=-1)
    top_w, top_e = _top_k(probs, k)
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)

    # destinations: each selection fans out to `split` rows
    flat_e = top_e.reshape(-1).repeat_interleave(split)
    fan = torch.arange(split, device=dev).repeat(T * k)
    dest = flat_e * split + fan
    flat_t = torch.arange(T, device=dev).repeat_interleave(k * split)
    flat_w = top_w.reshape(-1).repeat_interleave(split)

    onehot = F.one_hot(dest, dp_n)
    slot = (onehot.cumsum(dim=0) - onehot).gather(1, dest[:, None])[:, 0]
    keep = slot < cap
    slot = torch.where(keep, slot, torch.zeros_like(slot))
    rows = torch.where(keep, dest * cap + slot,
                       torch.full_like(slot, dp_n * cap))
    buf = xf.new_zeros(dp_n * cap + 1, D)
    buf[rows] = xf[flat_t]
    buf = buf[:dp_n * cap].view(dp_n, cap, D)

    # route tokens to their expert's rank
    recv = coll.all_to_all(buf, dgroup).reshape(dp_n * cap, D)
    rf = coll.copy_to(recv, tgroup)
    out = (silu(rf @ w1) * (rf @ w2)) @ w3
    out = coll.reduce_from(out, tgroup).view(dp_n, cap, D)
    # and the results back to the owning tokens' rank
    back = coll.all_to_all(out, dgroup)
    gathered = back[dest, slot] * (flat_w * keep)[:, None].to(back.dtype)
    y = _combine(gathered, T, k * split, xf)
    return y.reshape(B, S, D), _pmean(_aux(top_e, probs, E), ctx)
