"""Unified-Memory paging subsystem: the oversubscribed-HBM baseline as a
batched engine whose scan is the ``um_scan`` CUDA kernel.

``repro_torch.core.simulator`` routes every UM path through this package:
the ``organization="hbm"`` baseline and the HMS overflow model (Fig. 17's
rel-footprint > capacity points).  A capacity sweep over one trace is one
kernel launch with one lane per distinct spec.
"""

from .engine import UMResult, UMSpec, simulate_um, simulate_um_many, um_spec

__all__ = ["UMResult", "UMSpec", "um_spec", "simulate_um", "simulate_um_many"]
