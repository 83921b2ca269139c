"""Host-offload weight streaming for oversubscribed training (the port of
the JAX package's ``memtier/weight_stream.py``).

When a model (or its optimizer state) exceeds the fast-tier budget, leaves
are placed by DRAM-affinity score:

  * optimizer moments + master weights: read-modify-WRITTEN every step ->
    maximal write intensity -> pinned in the fast tier first (the paper's
    write filtering: slow-tier writes are the expensive operation);
  * bf16 weights: read-only, streamed sequentially with perfect spatial
    locality -> lowest penalty-per-access -> bypass candidates (kept on the
    host, staged in per step).

Leaves are the reference's: the JAX parameter tree's leaves, where one
stacked leaf carries every layer (``convert.jax_leaf_order``), named by
their key paths (``opt['m']['blocks']['attn']['bk']``,
``params['embed']``), the AdamW state's (``m``, ``master``, ``step``,
``v``) first.  Pinning or streaming a leaf places every per-layer tensor
of its group.

On the card the two tiers are real: the slow tier is one page-locked host
buffer (registered with CUDA, exactly the streamed bytes), the fast tier
device memory.  :meth:`WeightStreamer.stage_in` copies the streamed leaves
in and binds them to the model's parameters (``param.data``) and the
optimizer's state dict, so autograd and AdamW's in-place updates act on
them; :meth:`WeightStreamer.flush_out` copies them back into their host
buffers and rebinds the host copies, which releases their device memory:
between steps only the pinned leaves stay on the card.  Every copy is
issued on the current stream, so it is ordered after the work that wrote
its source and before the work that reads its destination; ``flush_out``
waits for that stream before it returns, so the host buffers then hold
the step's values.  On CPU tensors the slow tier is a separate host copy,
and staging clones it.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Mapping, Tuple

import torch

from ..convert import jax_leaf_order
from ..core import bypass as bp
from .block_table import TierConfig

_OPT_KEYS = ("m", "master", "step", "v")   # the reference's sorted keys
_ALIGN = 256                                # bytes, each host view's start


@dataclasses.dataclass
class Placement:
    pinned: List[str]
    streamed: List[str]
    fast_bytes: int
    slow_bytes: int


def _keystr(path) -> str:
    return "".join(f"['{k}']" for k in path)


def _leaves(model, opt_state) -> List[Tuple[str, List[tuple]]]:
    """(leaf name, its slots) in the reference's entry order: the optimizer
    state's leaves, then the parameters', each in ``jax.tree`` flatten
    order.  A slot is ("param", name), ("opt", key, name) or ("step",)."""
    params = dict(model.named_parameters())
    order = jax_leaf_order(params, model.cfg)
    out = []
    for key in _OPT_KEYS:
        if key == "step":
            out.append(("opt['step']", [("step",)]))
            continue
        for path, names in order:
            out.append((f"opt['{key}']{_keystr(path)}",
                        [("opt", key, n) for n in names]))
    for path, names in order:
        out.append((f"params{_keystr(path)}", [("param", n) for n in names]))
    return out


def _get(params, opt_state, slot) -> torch.Tensor:
    if slot[0] == "param":
        return params[slot[1]]
    if slot[0] == "opt":
        return opt_state[slot[1]][slot[2]]
    return opt_state["step"]


def _bind(params, opt_state, slot, t: torch.Tensor) -> None:
    if slot[0] == "param":
        params[slot[1]].data = t
    elif slot[0] == "opt":
        opt_state[slot[1]][slot[2]] = t
    else:
        opt_state["step"] = t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def plan_placement(model, opt_state: Mapping, fast_budget_bytes: int,
                   tier: TierConfig = TierConfig()) -> Placement:
    """Score every leaf with the DRAM-affinity machinery and pin greedily.
    ``model``: the port's model (its ``cfg`` gives the leaf order);
    ``opt_state``: its AdamW state (``optim.adamw.init``)."""
    fast, slow = tier.timing_fast, tier.timing_slow
    params = dict(model.named_parameters())
    entries = []
    for name, slots in _leaves(model, opt_state):
        writes_per_step, reads_per_step = ((1.0, 1.0) if name[:3] == "opt"
                                           else (0.0, 3.0))
        nbytes = sum(_nbytes(_get(params, opt_state, s)) for s in slots)
        run = max(1.0, nbytes / tier.block_bytes)   # sequential blocks
        pen = float(bp.scm_penalty_score(run, writes_per_step > 0, fast,
                                         slow))
        hot = reads_per_step + 3.0 * writes_per_step
        entries.append((name, nbytes, pen * hot))

    entries.sort(key=lambda e: -e[2])               # stable: ties keep order
    pinned, streamed = [], []
    used = 0
    for name, nbytes, _ in entries:
        if used + nbytes <= fast_budget_bytes:
            pinned.append(name)
            used += nbytes
        else:
            streamed.append(name)
    keep = set(streamed)
    slow_bytes = sum(n for name, n, _ in entries if name in keep)
    return Placement(pinned=pinned, streamed=streamed, fast_bytes=used,
                     slow_bytes=slow_bytes)


def _pin(buf: torch.Tensor) -> None:
    """Page-lock ``buf`` (a host tensor) with CUDA; raises on failure."""
    nbytes = _nbytes(buf)
    cudart = torch.cuda.cudart()
    err = cudart.cudaHostRegister(buf.data_ptr(), nbytes, 0)
    if int(err) != 0:
        raise RuntimeError(
            f"WeightStreamer: pinning {nbytes} bytes of host memory for the "
            f"slow tier failed (cudaHostRegister error {int(err)})")
    weakref.finalize(buf, cudart.cudaHostUnregister, buf.data_ptr())


class WeightStreamer:
    """Executes a Placement: pinned leaves live on the model's device,
    streamed leaves live in host memory and are staged in for each step."""

    def __init__(self, model, opt_state: Dict, fast_budget_bytes: int,
                 tier: TierConfig = TierConfig()):
        self.placement = plan_placement(model, opt_state, fast_budget_bytes,
                                        tier)
        self.device = next(model.parameters()).device
        self.bytes_streamed_in = 0
        self.bytes_streamed_out = 0
        params = dict(model.named_parameters())
        streamed = set(self.placement.streamed)
        leaves = [(n, s) for n, s in _leaves(model, opt_state)
                  if n in streamed]
        offsets, total = [], 0
        for _, slots in leaves:
            for s in slots:
                offsets.append(total)
                total += -(-_nbytes(_get(params, opt_state, s)) // _ALIGN) \
                    * _ALIGN
        self.host_buffer = torch.empty(total, dtype=torch.uint8)
        if self.device.type == "cuda" and total:
            _pin(self.host_buffer)
        # leaf name -> [(slot, host view)], in the placement's order
        self._host: Dict[str, List[tuple]] = {}
        self._leaf_bytes: Dict[str, int] = {}
        at = iter(offsets)
        for name, slots in leaves:
            views = []
            for s in slots:
                t = _get(params, opt_state, s)
                off = next(at)
                view = self.host_buffer[off:off + _nbytes(t)].view(
                    t.dtype).view(t.shape)
                view.copy_(t.detach())
                views.append((s, view))
            self._host[name] = views
            self._leaf_bytes[name] = sum(_nbytes(v) for _, v in views)
        for views in self._host.values():
            for s, view in views:
                _bind(params, opt_state, s, view)

    def host_views(self, name: str) -> List[torch.Tensor]:
        """The host copies of streamed leaf ``name``, one per tensor."""
        return [v for _, v in self._host[name]]

    def stage_in(self, model, opt_state: Dict):
        """Bind every streamed leaf's device copy into ``model`` and
        ``opt_state`` for one step; returns (model, opt_state)."""
        params = dict(model.named_parameters())
        cuda = self.device.type == "cuda"
        for name, views in self._host.items():
            for s, view in views:
                t = (view.to(self.device, non_blocking=True) if cuda
                     else view.clone())
                _bind(params, opt_state, s, t)
            self.bytes_streamed_in += self._leaf_bytes[name]
        return model, opt_state

    def flush_out(self, model, opt_state: Dict) -> None:
        """Write the step's streamed leaves back to their host copies and
        rebind those, releasing the device copies."""
        params = dict(model.named_parameters())
        cuda = self.device.type == "cuda"
        for name, views in self._host.items():
            for s, view in views:
                view.copy_(_get(params, opt_state, s).detach(),
                           non_blocking=cuda)
                _bind(params, opt_state, s, view)
            self.bytes_streamed_out += self._leaf_bytes[name]
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
