"""LR schedules as pure step -> lr functions (the port of the JAX
package's ``optim/schedule.py``): each takes the optimizer's int32 step
tensor and returns a float32 0-d tensor on its device."""

from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor_frac: float = 0.1):
    def fn(step):
        step = step.float()
        warm = peak_lr * step / max(1, warmup)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac)
                         * 0.5 * (1.0 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return fn


def warmup_linear(peak_lr: float, warmup: int, total: int):
    def fn(step):
        step = step.float()
        warm = peak_lr * step / max(1, warmup)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        return torch.where(step < warmup, warm, peak_lr * (1.0 - t))
    return fn


def constant(lr: float):
    def fn(step):
        return torch.full((), lr, dtype=torch.float32, device=step.device)
    return fn
