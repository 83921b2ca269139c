"""The training loop (the port of the JAX package's ``train/loop.py``):
checkpointing, fault recovery, straggler accounting.

  * data by step: ``batch_at(step)`` is a pure function of (seed, step,
    shard), so a restart replays the same stream bit for bit;
  * atomic async checkpoints every ``ckpt_every`` steps, in the
    reference's layout (``repro_torch.checkpoint``);
  * crash recovery: ``run()`` resumes from the latest checkpoint and
    retries a failed step up to ``max_step_retries`` times from the last
    checkpoint (re-seeded weights when there is none), re-raising after the
    last; only an ``InjectedFault`` and the card's runtime and
    out-of-memory errors count as recoverable, so a kernel that fails to
    build or launch raises at once and is never retried into another
    implementation;
  * stragglers: a step longer than ``straggler_factor`` x the rolling
    median is counted;
  * a mesh (``mesh``: a ``torch.distributed`` ``DeviceMesh`` with dims
    ``data`` and ``model``, ``launch.mesh.make_mesh_for``): every rank
    builds the whole seeded weights, as the meshless path does, and keeps
    its shards (``parallel.sharding.param_pspecs``; at one rank the
    tensors themselves, no copy); the step gathers, reduces and clips over
    the mesh (``launch.steps``);
  * elastic re-mesh: ``remesh(mesh)`` gathers the whole state to host
    memory and re-slices it for the new mesh (or keeps it whole for
    ``None``); ``save`` gathers the whole leaves and writes them in the
    reference's layout from rank 0, ``restore`` re-slices them for the
    current mesh, so a checkpoint restores on any mesh and in either
    package.

The model and its optimizer state live on ``device`` (the card unless the
caller asks for the CPU; on a NCCL mesh each rank's card); ``step_time_s``
ends in ``torch.cuda.synchronize()`` on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..checkpoint import ckpt as ckpt_lib
from ..configs import ShapeSpec
from ..data.synthetic import SyntheticTokens
from ..launch import steps as steps_lib
from ..models import init_params
from ..models.config import ModelConfig
from ..optim import adamw
from ..parallel import collectives as coll
from ..parallel import sharding as shard_rules
from ..parallel.mesh_ctx import make_ctx


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    max_step_retries: int = 2
    straggler_factor: float = 3.0
    microbatches: int = 1
    log_every: int = 10
    remat: bool = False
    lr: float = 3e-4
    # on a mesh: the residual stream between the blocks split over model
    # along the sequence, norms on the shard or (sp_prenorm) on the
    # gathered sequence (``parallel.mesh_ctx``)
    sequence_parallel: bool = False
    sp_prenorm: bool = False


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 data: SyntheticTokens, tcfg: TrainConfig,
                 mesh=None, seed: int = 0,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 device=None):
        self.cfg = cfg
        self.shape = shape
        self.data = data
        self.tcfg = tcfg
        self.mesh = mesh
        self.seed = seed
        self.fault_hook = fault_hook
        self.device = resolve_device(device, "Trainer")
        self.step = 0
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_events = 0
        self.recoveries = 0
        self._durations: List[float] = []

        self._init_state()
        self.ckpt = (ckpt_lib.AsyncCheckpointer(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)

    # -- construction ---------------------------------------------------------
    def _init_state(self):
        """Seeded whole weights, kept as this rank's shards, and AdamW's
        state of the shards."""
        self.model = init_params(self.seed, self.cfg, device=self.device)
        self._build()
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.data = self._place(name, p.data)
        self.opt_state = adamw.init(self.params)

    def _build(self):
        """The mesh context, each parameter's spec and the step function
        for ``self.mesh``."""
        self.ctx = make_ctx(self.mesh,
                            sequence_parallel=self.tcfg.sequence_parallel,
                            sp_prenorm=self.tcfg.sp_prenorm)
        self.specs = None
        named = dict(self.model.named_parameters())
        if self.mesh is not None:
            whole = {n: getattr(p, "_whole", p) for n, p in named.items()}
            self.specs = shard_rules.param_pspecs(
                whole, shard_rules.make_parallel_cfg(self.mesh), self.cfg)
        for name, p in named.items():
            if not hasattr(p, "_whole"):
                p._whole = torch.empty(p.shape, dtype=p.dtype,
                                       device="meta")
            p._spec = None if self.specs is None else self.specs[name]
        opt_cfg = adamw.AdamWConfig(lr=self.tcfg.lr)
        self._step_fn = steps_lib.make_train_step(
            self.cfg, opt_cfg, microbatches=self.tcfg.microbatches,
            remat=self.tcfg.remat, ctx=self.ctx, specs=self.specs)

    def _place(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole tensor ``whole`` of parameter
        ``name`` (or of its optimizer state), on the trainer's device:
        ``whole`` itself where nothing is split over more than one rank."""
        spec = None if self.specs is None else self.specs[name]
        part = coll.local_slice(whole, spec, self.ctx)
        if part is not whole:
            part = part.contiguous().clone()
        return part.to(self.device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def _whole(self, named: Dict[str, torch.Tensor]):
        if self.specs is None:
            return named
        return {n: coll.gather_whole(t, self.specs[n], self.ctx)
                for n, t in named.items()}

    def state_leaves(self) -> List[torch.Tensor]:
        """The whole training state as the reference's flattened leaves (on
        a mesh every rank takes part in the gathers)."""
        opt = {k: self._whole(self.opt_state[k])
               for k in ("master", "m", "v")}
        opt["step"] = self.opt_state["step"]
        return ckpt_lib.state_leaves(self._whole(self.params), opt, self.cfg)

    def _like(self) -> List[torch.Tensor]:
        """Meta tensors shaped and typed as :meth:`state_leaves`."""
        whole = {n: p._whole for n, p in self.model.named_parameters()}
        f32 = {n: t.to(torch.float32) for n, t in whole.items()}
        opt = {"master": f32, "m": f32, "v": f32,
               "step": self.opt_state["step"].to("meta")}
        return ckpt_lib.state_leaves(whole, opt, self.cfg)

    def _load(self, leaves: List[torch.Tensor]) -> None:
        """Whole leaves (in :meth:`state_leaves`' order) into this rank's
        shards, in place; a tensor whose shard shape the mesh changed is
        re-made first, one at a time."""
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                spec = None if self.specs is None else self.specs[name]
                shape = coll.local_slice(p._whole, spec, self.ctx).shape
                if p.shape != shape:
                    p.data = torch.empty(shape, dtype=p.dtype,
                                         device=self.device)
                for key in ("master", "m", "v"):
                    if self.opt_state[key][name].shape != shape:
                        self.opt_state[key][name] = torch.empty(
                            shape, dtype=torch.float32, device=self.device)
        ckpt_lib.load_state_leaves(leaves, self.params, self.opt_state,
                                   self.cfg, place=self._place)

    def _rank0(self) -> bool:
        return self.mesh is None or torch.distributed.get_rank() == 0

    def _barrier(self):
        if self.mesh is not None:
            torch.distributed.barrier()

    # -- checkpoint/restore ---------------------------------------------------
    def save(self):
        if self.ckpt is None:
            return
        leaves = self.state_leaves()
        if self._rank0():
            self.ckpt.save(self.step, leaves,
                           extra={"data": self.data.state_dict(),
                                  "step": self.step})
        if self.mesh is not None:
            # every rank restores what rank 0 wrote
            self.ckpt.wait()
            self._barrier()

    def restore(self) -> bool:
        if self.tcfg.ckpt_dir is None:
            return False
        if ckpt_lib.latest_step(self.tcfg.ckpt_dir) is None:
            return False
        leaves, _, extra = ckpt_lib.restore(self.tcfg.ckpt_dir, self._like())
        self._load(leaves)
        self.step = int(extra["step"])
        self.data.load_state_dict(extra["data"])
        return True

    def remesh(self, mesh) -> None:
        """Elastic scaling: the whole state to host memory, re-sliced for
        ``mesh`` (kept whole for ``None``)."""
        host = [t.detach().to("cpu", copy=True) for t in self.state_leaves()]
        self.mesh = mesh
        self._build()
        self._load(host)

    # -- the loop ---------------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _one_step(self, batch):
        t0 = time.perf_counter()
        self.model, self.opt_state, metrics = self._step_fn(
            self.model, self.opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        self._sync()
        dt = time.perf_counter() - t0
        self._durations.append(dt)
        med = float(np.median(self._durations[-20:]))
        if len(self._durations) > 5 and dt > self.tcfg.straggler_factor * med:
            self.straggler_events += 1
            metrics["straggler"] = 1.0
        metrics["step_time_s"] = dt
        return metrics

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The data stream's batch ``step`` on the trainer's device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch_at(step).items()}

    def run(self) -> Dict[str, Any]:
        self.restore()
        while self.step < self.tcfg.total_steps:
            batch = self.batch(self.step)
            tries = 0
            while True:
                try:
                    if self.fault_hook is not None:
                        self.fault_hook(self.step)
                    metrics = self._one_step(batch)
                    break
                except _RECOVERABLE:  # noqa: PERF203
                    tries += 1
                    self.recoveries += 1
                    if tries > self.tcfg.max_step_retries:
                        raise
                    # restart from the last checkpoint (the state may have
                    # been half updated when the step failed)
                    self.model.zero_grad(set_to_none=True)
                    if not self.restore():
                        self._init_state()
            self.step += 1
            self.data.step = self.step
            metrics["step"] = self.step
            self.metrics_log.append(metrics)
            if self.step % self.tcfg.ckpt_every == 0:
                self.save()
        if self.ckpt is not None:
            self.save()
            self.ckpt.wait()
        return {
            "final_loss": self.metrics_log[-1]["loss"],
            "steps": self.step,
            "stragglers": self.straggler_events,
            "recoveries": self.recoveries,
        }


class InjectedFault(RuntimeError):
    """Raised by test fault hooks to emulate a lost worker."""


# the card's errors: out of memory, and (where torch names them) runtime
# errors of the device; a failed build or launch of a kernel of this port
# raises a plain RuntimeError and is not retried
_RECOVERABLE = (InjectedFault, torch.cuda.OutOfMemoryError) + tuple(
    e for e in (getattr(torch, "AcceleratorError", None),) if e is not None)
