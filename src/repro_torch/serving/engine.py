"""Batched serving engine with a two-tier paged KV cache (the port of the
JAX package's ``serving/engine.py``).

Continuous-batching-lite: a fixed pool of sequence slots; each batch of
queued requests is prefilled together (left-padded with token 0, the pad
tokens attended like any other, as in the reference) and decoded greedily
in lockstep.  Every family serves: dense, moe, ssm, hybrid, encdec and
vlm.  Prefill attention runs the ``flash_attention`` kernel and decode
self-attention the ``paged_attention`` kernel over the per-slot cache
(decode cross-attention, the encdec's, ``flash_attention`` over the cached
encoder K/V); Mamba2 prefill runs the ``ssd_scan`` kernel.  As in the
reference, the encdec's audio frames and the vlm's image patches are
zeros of their stub shapes, and a vlm sequence holds ``n_patches`` image
positions ahead of its prompt.  The memtier
``PagedKVManager`` keeps the two-tier page plan beside it, so the paper's
write-filtering and bypass behaviour shows in the engine stats.  It is
sized from the config as the reference sizes it, for every family (an
attention-free model gets one KV head of ``d_model`` values, so its stats
count pages that no attention reads, as the reference's do).

On a device mesh (``ctx``, a ``parallel.MeshCtx``) every rank runs the
engine on the same requests: the model holds this rank's shards
(``parallel.collectives.place_model``), each batch's rows are split over
the data axes where their number divides them (else every rank takes
every row), the caches are this rank's shards (``ctx.kv_mode``), and each
step's tokens are all-gathered over the data axes, so every rank returns
every request's tokens.  At a mesh of one rank every collective is
skipped and the engine is the meshless one bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..launch.steps import local_batch
from ..memtier.paged_kv import PagedKVConfig, PagedKVManager
from ..models import decode_step, prefill
from ..parallel import collectives as coll
from ..models.config import ModelConfig
from ..models.transformer import Transformer


def stub_inputs(cfg: ModelConfig, batch: int,
                device) -> Dict[str, torch.Tensor]:
    """The encdec's audio frames (B, ``enc_seq``, ``frontend_dim or
    d_model``) and the vlm's image patches (B, ``n_patches``,
    ``vision_d_model``) for a batch, as float32 zeros: the frontends are
    stubs, and the reference engine passes zeros too.  Empty for the other
    families."""
    shapes = {}
    if cfg.family == "encdec":
        shapes["enc_frames"] = (batch, cfg.enc_seq,
                                cfg.frontend_dim or cfg.d_model)
    if cfg.family == "vlm":
        shapes["patches"] = (batch, cfg.n_patches, cfg.vision_d_model)
    return {k: torch.zeros(v, dtype=torch.float32, device=device)
            for k, v in shapes.items()}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int = 16
    out: Optional[np.ndarray] = None


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 4
    max_len: int = 256
    page_size: int = 16
    fast_pages: int = 48


class Engine:
    """The engine: per-slot caches (KV, SSM state or both), with the
    paged pool's bookkeeping kept in parallel by the memtier manager; on a
    mesh (``ctx``) this rank's part of it (the module docstring).

    ``device=None`` serves on the CUDA card and raises if there is none;
    the model must already lie on the engine's device.  As in the
    reference, the manager's slots are the batch indices and are never
    released, so a slot's length grows across batches until it reaches
    ``max_len`` (the manager then asserts "sequence too long"): for the
    vlm, ``max_len`` must hold ``n_patches`` + prompt + new tokens of every
    batch."""

    def __init__(self, cfg: ModelConfig, model: Transformer,
                 scfg: ServeConfig, *, device=None, ctx=None):
        cfg = cfg.validate()
        self.ctx = ctx if ctx is not None and ctx.active else None
        self.device = resolve_device(device, "Engine")
        wdev = model.embed.tok.device
        if (wdev.type, wdev.index or 0) != (self.device.type,
                                            self.device.index or 0):
            raise ValueError(f"Engine on {self.device}: the model's weights "
                             f"lie on {wdev}")
        self.cfg = cfg
        self.model = model
        self.scfg = scfg
        self.kv_mgr = PagedKVManager(
            PagedKVConfig(
                n_layers=cfg.n_layers, n_kv_heads=max(1, cfg.n_kv_heads),
                head_dim=cfg.hd, page_size=scfg.page_size,
                fast_pages=scfg.fast_pages,
                max_pages_per_seq=scfg.max_len // scfg.page_size),
            max_seqs=scfg.max_batch)
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _prefill_batch(self, reqs: List[Request]):
        cfg = self.cfg
        S = max(r.prompt.shape[0] for r in reqs)
        B = len(reqs)
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - r.prompt.shape[0]:] = r.prompt   # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 **stub_inputs(cfg, B, self.device)}
        if self.ctx is not None:
            batch = local_batch(batch, self.ctx)
        logits, cache = prefill(self.model, batch, cfg,
                                max_len=self.scfg.max_len, ctx=self.ctx)
        for i in range(B):
            for _ in range(S + self.n_image):
                self.kv_mgr.append_token(i)
        return logits, cache, S

    def _tokens(self, logits, B: int):
        """This rank's argmax tokens (its rows, (b, 1)) and all B rows' as
        a list (gathered over the data axes where the rows are split)."""
        tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
        rows = tok
        if self.ctx is not None and self.ctx.dp_size > 1 \
                and B % self.ctx.dp_size == 0:
            rows = coll.gathered(tok, 0, self.ctx.group(self.ctx.dp))
        return tok, rows[:, 0].tolist()

    @property
    def n_image(self) -> int:
        """Image positions ahead of each prompt (the vlm's patches)."""
        return self.cfg.n_patches if self.cfg.family == "vlm" else 0

    @torch.no_grad()
    def run(self) -> Dict[int, np.ndarray]:
        """Drain the queue; returns rid -> generated tokens (no gradients
        are recorded)."""
        while self.queue:
            reqs = [self.queue.pop(0)
                    for _ in range(min(self.scfg.max_batch,
                                       len(self.queue)))]
            logits, cache, S = self._prefill_batch(reqs)
            tok, first = self._tokens(logits, len(reqs))
            outs = [[t] for t in first]
            pos = S + self.n_image
            max_new = max(r.max_new for r in reqs)
            for stepi in range(max_new - 1):
                # two-tier page plan for this step: resolves residency,
                # stages slow-tier pages into streaming slots, counts
                # fast hits / slow fetches (the paper's probe path)
                self.kv_mgr.plan_step(list(range(len(reqs))))
                lg, cache = decode_step(self.model, tok, cache, pos,
                                        self.cfg, ctx=self.ctx)
                tok, step = self._tokens(lg, len(reqs))
                for i in range(len(reqs)):
                    if stepi < reqs[i].max_new - 1:
                        outs[i].append(step[i])
                    self.kv_mgr.append_token(i)
                pos += 1
            for i, r in enumerate(reqs):
                r.out = np.asarray(outs[i][:r.max_new], np.int32)
                self.done[r.rid] = r
        return {rid: r.out for rid, r in self.done.items()}

    @property
    def kv_stats(self) -> Dict[str, int]:
        return dict(self.kv_mgr.stats)
