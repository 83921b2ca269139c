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
  * ``remesh(None)``: the single-device round trip of the whole state to
    host memory and back.  A mesh waits for ``parallel/`` (ROADMAP A10).

The model and its optimizer state live on ``device`` (the card unless the
caller asks for the CPU); ``step_time_s`` ends in
``torch.cuda.synchronize()`` on the card.
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

NO_MESH = ("a device mesh needs parallel/, which is not ported yet "
           "(ROADMAP A10)")


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


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 data: SyntheticTokens, tcfg: TrainConfig,
                 mesh=None, seed: int = 0,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(NO_MESH)
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
        self._build()
        self.ckpt = (ckpt_lib.AsyncCheckpointer(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)

    # -- construction ---------------------------------------------------------
    def _init_state(self):
        self.model = init_params(self.seed, self.cfg, device=self.device)
        self.opt_state = adamw.init(self.params)

    def _build(self):
        opt_cfg = adamw.AdamWConfig(lr=self.tcfg.lr)
        self._step_fn = steps_lib.make_train_step(
            self.cfg, opt_cfg, microbatches=self.tcfg.microbatches,
            remat=self.tcfg.remat)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def state_leaves(self) -> List[torch.Tensor]:
        """The whole training state as the reference's flattened leaves."""
        return ckpt_lib.state_leaves(self.params, self.opt_state, self.cfg)

    # -- checkpoint/restore ---------------------------------------------------
    def save(self):
        if self.ckpt is None:
            return
        self.ckpt.save(self.step, self.state_leaves(),
                       extra={"data": self.data.state_dict(),
                              "step": self.step})

    def restore(self) -> bool:
        if self.tcfg.ckpt_dir is None:
            return False
        if ckpt_lib.latest_step(self.tcfg.ckpt_dir) is None:
            return False
        leaves, _, extra = ckpt_lib.restore(self.tcfg.ckpt_dir,
                                            self.state_leaves())
        ckpt_lib.load_state_leaves(leaves, self.params, self.opt_state,
                                   self.cfg)
        self.step = int(extra["step"])
        self.data.load_state_dict(extra["data"])
        return True

    def remesh(self, mesh) -> None:
        """Elastic scaling: the state to host memory and back onto the
        (single) device."""
        if mesh is not None:
            raise NotImplementedError(NO_MESH)
        host = [t.detach().to("cpu", copy=True) for t in self.state_leaves()]
        self.mesh = mesh
        self._build()
        ckpt_lib.load_state_leaves(host, self.params, self.opt_state,
                                   self.cfg)

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
